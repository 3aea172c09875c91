"""Preprocessing: StandardScaler and PCA as torch ops — the port of
``traffic_classifier_sdn_tpu/analysis/preprocess.py`` (the reference's
analysis-only pipeline, 1_log_Kmeans.ipynb cells 70-98: StandardScaler →
PCA(2) → PCA-space LogisticRegression).

Both are parameter NamedTuples and static functions on the device and
dtype of their input (float64 for the analysis numbers). PCA comes from
the covariance eigendecomposition (12 features: the 12×12
``torch.linalg.eigh``, a library call as ``jnp.linalg.eigh`` is in the JAX
package) with sklearn's sign convention (the largest-|loading| entry of
each component positive), so components compare directly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ScalerParams(NamedTuple):
    mean: torch.Tensor  # (d,)
    scale: torch.Tensor  # (d,) std with ddof=0; zeros replaced by 1


class StandardScaler:
    """fit/transform with sklearn semantics (ddof=0, zero-variance → 1)."""

    @staticmethod
    def fit(X: torch.Tensor) -> ScalerParams:
        mean = X.mean(0)
        var = X.var(0, correction=0)
        scale = torch.where(var == 0.0, torch.ones_like(var), var.sqrt())
        return ScalerParams(mean=mean, scale=scale)

    @staticmethod
    def transform(p: ScalerParams, X: torch.Tensor) -> torch.Tensor:
        return (X - p.mean) / p.scale

    @staticmethod
    def inverse_transform(p: ScalerParams, Z: torch.Tensor) -> torch.Tensor:
        return Z * p.scale + p.mean


class PCAParams(NamedTuple):
    mean: torch.Tensor  # (d,)
    components: torch.Tensor  # (k, d) rows = principal axes
    explained_variance: torch.Tensor  # (k,)
    explained_variance_ratio: torch.Tensor  # (k,)


class PCA:
    """Principal components via covariance eigh (exact for small d)."""

    @staticmethod
    def fit(X: torch.Tensor, n_components: int) -> PCAParams:
        n = X.shape[0]
        mean = X.mean(0)
        Xc = X - mean
        # sample covariance with ddof=1, matching sklearn's PCA
        cov = (Xc.T @ Xc) / (n - 1)
        eigvals, eigvecs = torch.linalg.eigh(cov)  # ascending
        order = torch.argsort(-eigvals, stable=True)
        eigvals = eigvals[order][:n_components]
        comps = eigvecs[:, order][:, :n_components].T  # (k, d)
        # sklearn sign convention: largest-|loading| entry positive
        idx = torch.argmax(comps.abs(), dim=1)
        signs = torch.sign(comps[torch.arange(comps.shape[0]), idx])
        comps = comps * signs[:, None]
        total_var = X.var(0, correction=1).sum()
        return PCAParams(
            mean=mean,
            components=comps,
            explained_variance=eigvals,
            explained_variance_ratio=eigvals / total_var,
        )

    @staticmethod
    def transform(p: PCAParams, X: torch.Tensor) -> torch.Tensor:
        return (X - p.mean) @ p.components.T

    @staticmethod
    def inverse_transform(p: PCAParams, Z: torch.Tensor) -> torch.Tensor:
        return Z @ p.components + p.mean

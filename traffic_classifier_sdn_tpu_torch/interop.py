"""Carry model weights from the JAX package into the port.

The port never imports the JAX package; the caller hands over numpy
arrays (or objects whose attributes convert with ``np.asarray``, such as
the JAX ``Params`` dataclasses), and this module builds the port's
module from them. Tests use it to run the same weights through both
packages; together with ``io/checkpoint.save_model`` it converts a JAX
checkpoint into the port's format.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .device import resolve_device
from .models.forest import PARAM_FIELDS, ForestModel
from .models.gnb import GnbModel
from .models.kmeans import KmeansModel
from .models.knn import KnnModel
from .models.logreg import LogregModel
from .models.svc import SvcModel

KNN_FIELDS = ("fit_X", "fit_X_lo", "fit_y", "half_sq_norms")
SVC_FIELDS = ("sv_hi", "sv_lo", "pair_coef", "intercept", "vote_i",
              "vote_j", "gamma")


def _getter(d):
    return (lambda k: d[k]) if isinstance(d, Mapping) else (
        lambda k: getattr(d, k))


def _has(d, k) -> bool:
    return k in d if isinstance(d, Mapping) else hasattr(d, k)


def _tensors(get, fields, device) -> dict:
    """The named arrays as tensors of their own dtype (a copy each)."""
    return {k: torch.from_numpy(np.array(get(k))).to(device) for k in fields}


def forest_params_from_numpy(d, device=None) -> ForestModel:
    """The JAX forest parameters — its ``Params`` fields or importer dict —
    as the port's ``ForestModel`` on ``device`` (default CUDA).
    Thresholds pass through ``f32_safe_thresholds``, as in the JAX
    ``forest.from_numpy``."""
    get = _getter(d)
    fields = {k: np.asarray(get(k)) for k in PARAM_FIELDS}
    fields["max_depth"] = int(get("max_depth"))
    return ForestModel.from_numpy(fields, device=device)


def knn_params_from_numpy(d, device=None) -> KnnModel:
    """The JAX KNN parameters as the port's ``KnnModel`` on ``device``
    (default CUDA). Given the JAX ``Params`` fields (``fit_X``,
    ``fit_X_lo``, ``fit_y``, ``half_sq_norms``, ``n_neighbors``,
    ``n_classes``), every array is carried over as it is — in particular
    ``half_sq_norms``: a 12-term f32 sum taken in another order can
    differ in its last bit, and that flips exact ties. Given an importer
    dict (``fit_X``, ``y``, ``n_neighbors``, ``classes``), the port's own
    ``KnnModel.from_numpy`` builds it."""
    if not _has(d, "half_sq_norms"):
        return KnnModel.from_numpy(d, device=device)
    device = resolve_device(device)
    get = _getter(d)
    return KnnModel(
        **_tensors(get, KNN_FIELDS, device),
        n_neighbors=int(get("n_neighbors")), n_classes=int(get("n_classes")),
    )


def svc_params_from_numpy(d, device=None) -> SvcModel:
    """The JAX SVC parameters as the port's ``SvcModel`` on ``device``
    (default CUDA). Given the JAX ``Params`` fields (``sv_hi``, ``sv_lo``,
    ``pair_coef``, ``intercept``, ``vote_i``, ``vote_j``, ``gamma``,
    ``n_classes``, ``has_lo``), every array is carried over as it is;
    given an importer dict (``support_vectors``, ``dual_coef``,
    ``n_support``, ``intercept``, ``gamma``), the port's own
    ``SvcModel.from_numpy`` builds it."""
    if not _has(d, "sv_hi"):
        return SvcModel.from_numpy(d, device=device)
    device = resolve_device(device)
    get = _getter(d)
    return SvcModel(
        **_tensors(get, SVC_FIELDS, device),
        n_classes=int(get("n_classes")), has_lo=bool(get("has_lo")),
    )


def logreg_params_from_numpy(d, device=None) -> LogregModel:
    """The JAX logistic-regression parameters — its ``Params`` fields or
    the importer dict, both ``coef`` (C, F) and ``intercept`` (C,) — as
    the port's ``LogregModel`` on ``device`` (default CUDA)."""
    get = _getter(d)
    return LogregModel.from_numpy(
        {k: np.asarray(get(k)) for k in ("coef", "intercept")},
        device=device,
    )


def gnb_params_from_numpy(d, device=None) -> GnbModel:
    """The JAX Gaussian naive Bayes parameters as the port's ``GnbModel``
    on ``device`` (default CUDA). Given the JAX ``Params`` fields
    (``theta``, ``inv_var``, ``log_const``, already folded), every array
    is carried over as it is; given an importer dict (``theta``, ``var``,
    ``class_prior``), the port's own ``GnbModel.from_numpy`` folds it."""
    if not _has(d, "inv_var"):
        return GnbModel.from_numpy(d, device=device)
    device = resolve_device(device)
    return GnbModel(**_tensors(_getter(d), ("theta", "inv_var", "log_const"),
                               device))


def kmeans_params_from_numpy(d, device=None) -> KmeansModel:
    """The JAX k-means parameters — its ``Params`` (``centers``) or the
    importer dict (``cluster_centers``) — as the port's ``KmeansModel`` on
    ``device`` (default CUDA)."""
    get = _getter(d)
    key = "centers" if _has(d, "centers") else "cluster_centers"
    return KmeansModel.from_numpy({"cluster_centers": np.asarray(get(key))},
                                  device=device)

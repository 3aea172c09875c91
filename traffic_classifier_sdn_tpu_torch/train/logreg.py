"""Logistic-regression training — the torch port of ``fit`` in
``traffic_classifier_sdn_tpu/train/logreg.py``.

The objective sklearn minimizes, ``Σ softmax-CE + (1/C)·½‖W‖²`` with the
intercept unpenalized, on raw features (no scaler: the JAX docstring
measures that raw-feature L-BFGS reproduces sklearn's accuracy while
standardize-then-fold-back lands on a worse regularized optimum), by
full-batch L-BFGS for ``max_iter`` iterations. The JAX package runs
optax's L-BFGS; this runs ``torch.optim.LBFGS`` with a strong-Wolfe line
search and optax's memory of 10, in float64 on the given device. The two
optimizers differ, so the parameters do too: the contract is accuracy,
not bits (ROADMAP's rule for trainers). ``fit_sgd`` and the train-state
checkpoints are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.logreg import LogregModel


def ce_loss(coef: torch.Tensor, intercept: torch.Tensor, X: torch.Tensor,
            y: torch.Tensor, l2_inv_C: float) -> torch.Tensor:
    """``Σ softmax-CE + ½·l2_inv_C·‖coef‖²`` (JAX ``_ce_loss``)."""
    logits = X @ coef.t() + intercept
    ce = torch.nn.functional.cross_entropy(logits, y, reduction="sum")
    return ce + 0.5 * l2_inv_C * (coef * coef).sum()


def fit(X, y, n_classes: int, *, C: float = 1.0, max_iter: int = 200,
        device=None) -> LogregModel:
    """Fit on ``device`` (default CUDA, see device.py); returns the port's
    ``LogregModel`` (float32)."""
    device = resolve_device(device)
    X = torch.tensor(np.asarray(X, np.float64), device=device)
    y = torch.tensor(np.asarray(y, np.int64), device=device)
    F = X.shape[1]
    w = torch.zeros(n_classes * F + n_classes, dtype=torch.float64,
                    device=device, requires_grad=True)
    opt = torch.optim.LBFGS([w], lr=1.0, max_iter=max_iter,
                            history_size=10, line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        loss = ce_loss(w[: n_classes * F].reshape(n_classes, F),
                       w[n_classes * F:], X, y, 1.0 / C)
        loss.backward()
        return loss

    opt.step(closure)
    w = w.detach()
    return LogregModel(
        coef=w[: n_classes * F].reshape(n_classes, F).to(torch.float32),
        intercept=w[n_classes * F:].to(torch.float32).contiguous(),
    )

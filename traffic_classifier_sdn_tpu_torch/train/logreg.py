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
not bits (ROADMAP's rule for trainers).

``fit_sgd`` is the minibatch Adam trainer with resumable train state
(``make_sgd``, ``SGDState``; checkpoints through
io/checkpoint.save_train_state). ``make_sgd(mesh=...)`` is the
data-parallel train step of the JAX package's dryrun, where XLA averages
the gradients over the mesh's data axis because the batch is sharded:
the port names the mesh, splits the batch over its data axis, and adds
the shards' partial sums in shard order (``mesh.shard_sum``, across
processes too). Adam is written out in optax's order —
first moment, second moment, bias correction, ``-lr·m̂/(√v̂+eps)`` —
rather than ``torch.optim.Adam``, which rounds in another order; the
state is optax's ``(count, mu, nu)``, and ``SGDState.leaves`` lists it in
the JAX ``SGDState``'s tree-flatten order, so a JAX train state carries
across by position (interop.sgd_state_from_numpy).
"""

from __future__ import annotations

from typing import NamedTuple

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


# optax.adam's defaults
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


class AdamState(NamedTuple):
    """optax ``ScaleByAdamState``: ``count`` is the step counter, a ()
    int32 tensor on the host (the bias corrections are computed from it
    there); ``mu`` and ``nu`` are the (coef, intercept) moments, float32
    on the parameters' device."""

    count: torch.Tensor
    mu: tuple
    nu: tuple


class SGDState(NamedTuple):
    """``params`` = (coef (C, F), intercept (C,)) float32; ``opt_state``
    the Adam state."""

    params: tuple
    opt_state: AdamState

    def leaves(self) -> list:
        """The state's tensors in the JAX ``SGDState``'s tree-flatten
        order: coef, intercept; count; mu coef, mu intercept; nu coef, nu
        intercept."""
        o = self.opt_state
        return [*self.params, o.count, *o.mu, *o.nu]

    @classmethod
    def from_leaves(cls, leaves, device=None) -> "SGDState":
        """The state of seven leaves in ``leaves()``'s order (tensors or
        numpy arrays, copied): the arrays on ``device`` (default CUDA, see
        device.py), the count on the host."""
        from ..device import resolve_device

        device = resolve_device(device)
        if len(leaves) != 7:
            raise ValueError(f"an SGDState has 7 leaves, got {len(leaves)}")

        def t(a):
            a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
            return torch.tensor(np.asarray(a, np.float32), device=device)

        coef, intercept, count, mc, mi, nc, ni = leaves
        count = count.cpu() if isinstance(count, torch.Tensor) else count
        return cls(
            params=(t(coef), t(intercept)),
            opt_state=AdamState(
                count=torch.tensor(np.asarray(count, np.int32)),
                mu=(t(mc), t(mi)), nu=(t(nc), t(ni))),
        )


def make_sgd(learning_rate: float = 1e-3, device=None, mesh=None):
    """``(init, train_step)`` of the minibatch logistic-regression trainer
    on ``device`` (default CUDA, see device.py): ``init(n_classes,
    n_features)`` is a zero ``SGDState``; ``train_step(state, X, y)`` takes
    one Adam step on the mean softmax cross-entropy of the batch and
    returns ``(state, loss)``. The JAX package's ``make_sgd`` (optax.adam)
    in optax's rounding order.

    With a ``mesh`` (parallel/mesh.py) the step is data parallel: the
    batch is split over the mesh's data axis (``batch_sharded``), each
    shard this process owns computes the partial sums of the loss and of
    both gradients on its rows (the softmax term scaled by the global
    ``1/B``), ``shard_sum`` adds them in shard order (through
    ``gather_tensors`` on a mesh spanning processes), and every process
    applies the same Adam update to the replicated state, which lives on
    its first data shard's device (``device`` is then that one). So the
    step on a mesh spanning processes is bitwise the one-process mesh's
    with the same shard count, and a one-shard mesh's gradients are
    bitwise the step's without a mesh."""
    from ..device import resolve_device

    if mesh is not None:
        from ..parallel.mesh import DATA_AXIS

        local = mesh.local_shards(DATA_AXIS)
        if not local:
            raise ValueError("this process owns no data shard of the mesh")
        device = mesh.axis_devices(DATA_AXIS)[local[0]]
    device = resolve_device(device)
    f32 = np.float32
    # the float32 constants of optax's expressions, rounded as JAX rounds
    # its weakly typed Python scalars against float32 operands
    c1, b1 = float(f32(1 - ADAM_B1)), float(f32(ADAM_B1))
    c2, b2 = float(f32(1 - ADAM_B2)), float(f32(ADAM_B2))
    eps, step = float(f32(ADAM_EPS)), float(f32(-learning_rate))

    def init(n_classes: int, n_features: int) -> SGDState:
        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=device)

        return SGDState(
            params=(z(n_classes, n_features), z(n_classes)),
            opt_state=AdamState(
                count=torch.zeros((), dtype=torch.int32),
                mu=(z(n_classes, n_features), z(n_classes)),
                nu=(z(n_classes, n_features), z(n_classes))),
        )

    def ce_grads(coef, intercept, X, y, inv_b: float):
        """Each row's softmax cross-entropy, and the gradients of their
        sum times ``inv_b`` (of their mean when ``inv_b`` is 1/B):
        ∂/∂ logits = (softmax − onehot) · inv_b."""
        logits = X @ coef.t() + intercept
        lse = torch.logsumexp(logits, dim=1)
        ce = lse - logits.gather(1, y[:, None])[:, 0]
        g = torch.exp(logits - lse[:, None])
        g[torch.arange(y.shape[0], device=y.device), y] -= 1.0
        g = g * inv_b
        return ce, (g.t() @ X, g.sum(0))

    def adam(state: SGDState, grads: tuple) -> SGDState:
        o = state.opt_state
        count = o.count + 1
        n = int(count)
        # bias corrections in float64 on the host, rounded once to float32
        bc1 = float(f32(1.0 - ADAM_B1 ** n))
        bc2 = float(f32(1.0 - ADAM_B2 ** n))
        mu = tuple(gr * c1 + m * b1 for gr, m in zip(grads, o.mu))
        nu = tuple((gr * gr) * c2 + v * b2 for gr, v in zip(grads, o.nu))
        params = tuple(
            p + (m / bc1) / (torch.sqrt(v / bc2) + eps) * step
            for p, m, v in zip(state.params, mu, nu))
        return SGDState(params, AdamState(count, mu, nu))

    def train_step(state: SGDState, X: torch.Tensor, y: torch.Tensor):
        ce, grads = ce_grads(*state.params, X, y, float(f32(1.0 / y.shape[0])))
        return adam(state, grads), ce.mean()

    if mesh is None:
        return init, train_step

    from ..parallel.mesh import batch_sharded, replicated, shard_sum

    def sharded_step(state: SGDState, X: torch.Tensor, y: torch.Tensor):
        B = y.shape[0]
        inv_b = float(f32(1.0 / B))
        xs, ys = batch_sharded(mesh, X), batch_sharded(mesh, y)
        params = replicated(mesh, state.params)
        parts: list = [None] * len(xs)
        for s in mesh.local_shards(DATA_AXIS):
            ce, (g_coef, g_int) = ce_grads(*params[s], xs[s], ys[s], inv_b)
            # one flat vector a shard, so the shards add in one exchange
            parts[s] = torch.cat([g_coef.reshape(-1), g_int, ce.sum()[None]])
        total = shard_sum(parts, mesh).to(device)
        C, F = state.params[0].shape
        grads = (total[: C * F].reshape(C, F), total[C * F: C * F + C])
        return adam(state, grads), total[-1] / B

    return init, sharded_step


def fit_sgd(X, y, n_classes: int, *, learning_rate: float = 1e-2,
            batch_size: int = 256, n_steps: int = 2000, seed: int = 0,
            checkpoint_dir: str | None = None, checkpoint_every: int = 0,
            stop_at_step: int | None = None, device=None) -> LogregModel:
    """Minibatch Adam trainer with periodic train-state checkpoints and
    crash resume, on ``device`` (default CUDA, see device.py) — the JAX
    package's ``fit_sgd``.

    The minibatch of absolute step s is ``RandomState((seed·1000003 + s)
    & 0x7FFFFFFF).randint(0, N, batch_size)``, so a run that dies and
    resumes from its last checkpoint replays exactly the remaining
    schedule: its params are bitwise an uninterrupted run's. X stays on
    the device, indexed by each step's indices (all of a run's indices
    cross to the device at once). ``checkpoint_every`` (config
    ``train.checkpoint_every``; 0 = off) saves into ``checkpoint_dir``
    every that many steps and at the last; a ``checkpoint_dir`` holding a
    train state resumes from it. ``stop_at_step`` ends the run before
    that step, with no save beyond the last periodic one (a kill)."""
    import os

    from ..device import resolve_device
    from ..io import checkpoint as ckpt

    device = resolve_device(device)
    X_dev = torch.tensor(np.asarray(X, np.float32), device=device)
    y_dev = torch.tensor(np.asarray(y, np.int64), device=device)
    n = X_dev.shape[0]
    init, train_step = make_sgd(learning_rate, device=device)
    state = init(n_classes=n_classes, n_features=X_dev.shape[1])
    start = 0
    if checkpoint_dir is not None and os.path.exists(
            os.path.join(checkpoint_dir, "manifest.json")):
        state, start = ckpt.restore_train_state(checkpoint_dir, state)
    end = n_steps if stop_at_step is None else max(start, min(
        n_steps, stop_at_step))
    idx = torch.tensor(np.array([
        np.random.RandomState((seed * 1_000_003 + s) & 0x7FFFFFFF).randint(
            0, n, batch_size)
        for s in range(start, end)
    ], np.int64).reshape(end - start, batch_size), device=device)
    for i, s in enumerate(range(start, end)):
        state, _ = train_step(state, X_dev[idx[i]], y_dev[idx[i]])
        done = s + 1
        if (checkpoint_dir is not None and checkpoint_every > 0
                and (done % checkpoint_every == 0 or done == n_steps)):
            ckpt.save_train_state(checkpoint_dir, state, done)
    coef, intercept = state.params
    return LogregModel(coef=coef.clone(), intercept=intercept.clone())

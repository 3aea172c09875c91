"""Open-set rejection: calibrated unknown-class detection on the serving
path — the port of ``traffic_classifier_sdn_tpu/serving/openset.py``.

The reference's world is six closed classes, but live traffic carries
classes the model never saw, and a closed argmax serves each such flow a
confident wrong label. An ``OpenSetGate`` wraps the final predict
composition (ladder- and drift-gate-wrapped) and relabels rows whose
features sit too far from EVERY known class as an explicit ``unknown``
(index ``n_classes``).

Score and threshold. For per-class per-feature reference statistics
(mean ``μ_cf``, std ``σ_cf``),

    d(x, c) = sqrt( mean_f ((x_f − μ_cf) / max(σ_cf, floor_f))² )
    score(x) = min_c d(x, c)

a diagonal Mahalanobis distance to the nearest known class: feature-space,
so it works the same on every serving rung and family. ``floor_f`` is 5%
of the feature's global calibration std, so counter jitter on
near-constant features cannot manufacture rejections. The gate stays
byte-transparent while it accumulates ``calibration_rows`` active labeled
rows from the live stream, then freezes the stats and sets ``threshold =
margin × max(calibration scores)``, so traffic from the calibration
distribution is not rejected by construction. A drift promotion re-bases
the gate onto the retrain window's KNOWN-labeled rows (``rebase``).

The float64 numpy functions (``class_reference``, ``floored_std``,
``reference_matrices``, ``openset_scores``) are copies of JAX's. The gate
scores host labels (a ``host_native`` predict, the degrade ladder) with
``openset_scores`` and device labels with float32 torch ops on the
features' device, term for term (``_apply_device``): labels can differ
between the two only for a score within float32 epsilon of the
threshold. The float32 stats are cached per calibration epoch, so no tick
uploads them. The device path's rejection count is a device scalar read
at the next call, when it has long since been computed.

Composition: the gate is the OUTERMOST predict wrapper (cli.py);
promotions hot-swap inside it, and the incremental label cache watches
``label_epoch`` (a freeze or a rebase bumps the gate's own epoch). The
drift controller consumes the gate's capture (``take_capture``), so the
monitor sees ``unknown`` as a (C+1)th class.

Fault sites, both ABSORBED: ``openset.score`` (the tick serves the inner
labels fresh) and ``openset.calibrate`` (the sample is dropped; a failed
rebase keeps the previous stats). Threading: predicts come from one
thread at a time; ``status()`` may be read from the exposition thread.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..utils import faults

CALIBRATING = "CALIBRATING"
ARMED = "ARMED"

# the openset_state gauge encoding
STATE_GAUGE = {CALIBRATING: 0, ARMED: 1}

_STD_FLOOR_FRAC = 0.05  # per-class std floor, as a fraction of global std
_EPS = 1e-9


def host_array(a) -> np.ndarray:
    """A host numpy view of a tensor (copied off the card) or array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def class_reference(X, y, n_classes: int, eps: float = _EPS) -> dict:
    """Per-class per-feature reference statistics from a labeled window:
    ``{"class_mean": (C, F), "class_std": (C, F), "class_count": (C,)}``
    (float64). Rows labeled outside ``[0, n_classes)`` — the ``unknown``
    index included — are EXCLUDED. Classes with no rows get zero mean and
    ``eps`` std."""
    X = np.asarray(X, np.float64)
    y = np.asarray(y).astype(np.int64).ravel()[: X.shape[0]]
    mean = np.zeros((n_classes, X.shape[1]), np.float64)
    std = np.full((n_classes, X.shape[1]), eps, np.float64)
    count = np.zeros(n_classes, np.float64)
    for c in range(n_classes):
        rows = X[y == c]
        count[c] = rows.shape[0]
        if rows.shape[0]:
            mean[c] = rows.mean(axis=0)
            std[c] = rows.std(axis=0)
    return {"class_mean": mean, "class_std": std, "class_count": count}


def floored_std(class_std: np.ndarray, global_std: np.ndarray,
                eps: float = _EPS) -> np.ndarray:
    """The score denominator: per-class std floored at ``_STD_FLOOR_FRAC``
    of the global per-feature std (and ``eps`` absolutely)."""
    return np.maximum(
        np.maximum(class_std, _STD_FLOOR_FRAC * global_std[None, :]),
        eps,
    )


def reference_matrices(
    ref: dict, global_std: np.ndarray,
) -> tuple[np.ndarray, np.ndarray] | None:
    """``(mean, inv_std)`` scoring matrices from a ``class_reference``
    dict, EMPTY classes dropped (an unseen class would otherwise be a
    phantom acceptance basin at the origin). None when no class has
    rows."""
    present = ref["class_count"] > 0
    if not present.any():
        return None
    mean = ref["class_mean"][present]
    inv_std = 1.0 / floored_std(ref["class_std"][present], global_std)
    return mean, inv_std


def openset_scores(X, mean, inv_std) -> np.ndarray:
    """(N,) min-over-classes diagonal Mahalanobis RMS distance, float64 —
    the one home of the score expression (``OpenSetGate._apply_device``
    mirrors it term for term in float32)."""
    X = np.asarray(X, np.float64)
    best = None
    for c in range(mean.shape[0]):
        z = (X - mean[c][None, :]) * inv_std[c][None, :]
        d = np.mean(z * z, axis=-1)
        best = d if best is None else np.minimum(best, d)
    return np.sqrt(best)


def openset_scores_f32(X: torch.Tensor, mean32: torch.Tensor,
                       inv32: torch.Tensor) -> torch.Tensor:
    """``openset_scores`` in float32 torch ops on ``X``'s device."""
    Xf = X.to(torch.float32)
    best = None
    for c in range(mean32.shape[0]):
        z = (Xf - mean32[c][None, :]) * inv32[c][None, :]
        d = torch.mean(z * z, dim=-1)
        best = d if best is None else torch.minimum(best, d)
    return torch.sqrt(best)


class OpenSetGate:
    """The outermost predict wrapper: closed-world labels in, open-set
    labels out (``unknown_index == n_classes`` for rejected rows).

    Byte-transparent until calibration completes, and on every fault path
    after it. ``host_native`` mirrors the wrapped predict so the serve
    loop's routing is unchanged."""

    def __init__(self, predict, n_classes: int, *, margin: float = 3.0,
                 calibration_rows: int = 4096,
                 metrics=None, recorder=None, reference: dict | None = None):
        if n_classes < 1:
            raise ValueError("n_classes must be >= 1")
        if margin <= 0:
            raise ValueError("margin must be > 0")
        self.host_native = bool(getattr(predict, "host_native", False))
        self.n_classes = int(n_classes)
        self.unknown_index = int(n_classes)
        self.margin = float(margin)
        self.calibration_rows = max(1, int(calibration_rows))
        self._inner = predict
        self._metrics = metrics
        self._recorder = recorder
        self._lock = threading.Lock()
        self._state = CALIBRATING
        self._epoch = 0
        # calibration accumulators and the one-tick-deferred (X, labels)
        # pair awaiting materialization
        self._cal_X: list[np.ndarray] = []
        self._cal_y: list[np.ndarray] = []
        self._cal_rows = 0
        self._pending_cal: tuple | None = None
        # armed stats (present classes only)
        self._mean: np.ndarray | None = None  # (P, F) f64
        self._inv_std: np.ndarray | None = None  # (P, F) f64
        self._threshold = float("inf")
        self._calibrated_at_rows = 0
        # float32 device copies of the armed stats, cached per epoch and
        # device: (device, mean32, inv32, thr32)
        self._device_stats: tuple | None = None
        self._device_stats_epoch: int | None = None
        self._rejections = 0
        self._last_rejected = 0
        self._score_faults = 0
        self._calibrate_faults = 0
        self._capture = None
        self._capture_enabled = False
        self._pending_count = None  # device path's lazy rejection count
        if metrics is not None:
            metrics.set("openset_state", STATE_GAUGE[CALIBRATING])
        if reference is not None:
            # a restored serving checkpoint: boot ARMED on the stats and
            # threshold it served with, never re-calibrating on the
            # (possibly novel) traffic of the restart
            self._seed_reference(reference)

    def _seed_reference(self, reference: dict) -> None:
        mean = np.asarray(reference["openset_mean"], np.float64)
        inv_std = np.asarray(reference["openset_inv_std"], np.float64)
        threshold = float(np.asarray(reference["openset_threshold"]))
        rows = int(np.asarray(reference.get("openset_calibrated_rows", 0)))
        if (mean.ndim != 2 or mean.shape != inv_std.shape
                or not mean.shape[0]):
            raise ValueError(
                f"openset reference shapes {mean.shape} / "
                f"{inv_std.shape} are not a (present_classes, "
                f"features) pair — the persisted reference belongs to "
                f"a different layout"
            )
        with self._lock:
            self._mean = mean
            self._inv_std = inv_std
            self._threshold = threshold
            self._calibrated_at_rows = rows
            self._state = ARMED
            self._epoch += 1
        if self._metrics is not None:
            self._metrics.set("openset_state", STATE_GAUGE[ARMED])

    def reference_arrays(self) -> dict | None:
        """The armed scoring reference as a flat name→array dict — the
        serving checkpoint's ``feature_reference`` block carries it. None
        while calibrating."""
        with self._lock:
            if self._state != ARMED:
                return None
            return {
                "openset_mean": np.array(self._mean),
                "openset_inv_std": np.array(self._inv_std),
                "openset_threshold": np.float64(self._threshold),
                "openset_calibrated_rows": np.float64(
                    self._calibrated_at_rows
                ),
            }

    # -- predict surface ---------------------------------------------------
    def __call__(self, params, X):
        labels = self._inner(params, X)
        self._drain_pending_count()
        with self._lock:
            armed = self._state == ARMED
            # the previous tick's calibration pair: its labels have long
            # since materialized, so folding it costs no fresh sync
            pending, self._pending_cal = self._pending_cal, None
        if not armed:
            if pending is not None:
                self._calibrate_tick(*pending)
            with self._lock:
                # folding the pending pair may just have armed the gate
                if self._state != ARMED:
                    self._pending_cal = (X, labels)
            out = labels
        else:
            out = self._apply(X, labels)
        with self._lock:
            if self._capture_enabled:
                self._capture = (X, out)
        return out

    def enable_capture(self) -> None:
        """Opt in to per-tick ``(X, labels)`` capture (the drift
        controller's ``set_openset`` wiring)."""
        with self._lock:
            self._capture_enabled = True

    def take_capture(self):
        """The newest ``(X, labels)`` pair — labels INCLUDING any
        ``unknown`` relabels — consumed (None when no predict ran since
        the last take)."""
        with self._lock:
            cap = self._capture
            self._capture = None
            return cap

    @property
    def label_epoch(self) -> tuple:
        """Composed label-source epoch for the incremental cache: the
        gate's own epoch (bumped at calibration freeze and every rebase)
        plus the inner composition's."""
        with self._lock:
            own = self._epoch
        return (own, getattr(self._inner, "label_epoch", 0))

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def threshold(self) -> float:
        with self._lock:
            return self._threshold

    def status(self) -> dict:
        """The /healthz self-report (obs.HealthState.set_openset)."""
        with self._lock:
            return {
                "state": self._state,
                "gauge": STATE_GAUGE[self._state],
                "threshold": (
                    None if self._threshold == float("inf")
                    else round(self._threshold, 6)
                ),
                "margin": self.margin,
                "rejections": self._rejections,
                "last_rejected": self._last_rejected,
                "calibration_rows": (
                    self._calibrated_at_rows or self._cal_rows
                ),
                "score_faults": self._score_faults,
                "calibrate_faults": self._calibrate_faults,
            }

    # -- calibration -------------------------------------------------------
    def _calibrate_tick(self, X, labels) -> None:
        """Fold one pre-arming tick's ACTIVE labeled rows into the
        calibration window; freeze once enough rows accumulated.
        Absorbing: a failure drops this tick's sample."""
        try:
            faults.fault_point("openset.calibrate")
            Xh = host_array(X).astype(np.float64)
            yh = host_array(labels).astype(np.int64).ravel()
            yh = yh[: Xh.shape[0]]
            mask = Xh.any(axis=1)
            with self._lock:
                if int(mask.sum()):
                    self._cal_X.append(Xh[mask].astype(np.float32))
                    self._cal_y.append(yh[mask].astype(np.int32))
                    self._cal_rows += int(mask.sum())
                due = self._cal_rows >= self.calibration_rows
            if due:
                self._freeze()
        except Exception as e:  # noqa: BLE001 — calibration must not fail the serve
            self._absorb("openset.calibrate", e)

    def _freeze(self) -> None:
        with self._lock:
            cal_X, self._cal_X = self._cal_X, []
            cal_y, self._cal_y = self._cal_y, []
            # reset so a failed install re-accumulates a fresh window
            self._cal_rows = 0
        X = np.concatenate(cal_X, axis=0)
        y = np.concatenate(cal_y, axis=0)
        self._install_reference(X, y, reason="calibrated")

    def _install_reference(self, X, y, reason: str) -> None:
        """Per-class stats and the margin-calibrated threshold from a
        labeled window; arm (or re-arm) the gate."""
        X = np.asarray(X, np.float64)
        ref = class_reference(X, y, self.n_classes)
        matrices = reference_matrices(ref, X.std(axis=0))
        if matrices is None:
            raise ValueError(
                "calibration window has no class-labeled rows"
            )
        mean, inv_std = matrices
        scores = openset_scores(X, mean, inv_std)
        threshold = self.margin * float(scores.max()) if scores.size \
            else float("inf")
        with self._lock:
            self._mean = mean
            self._inv_std = inv_std
            self._threshold = threshold
            self._calibrated_at_rows = int(X.shape[0])
            self._state = ARMED
            self._epoch += 1
            # the cached float32 copies are stale: the next device tick
            # uploads once
            self._device_stats = None
            self._device_stats_epoch = None
        if self._metrics is not None:
            self._metrics.set("openset_state", STATE_GAUGE[ARMED])
        if self._recorder is not None:
            self._recorder.record(
                "openset.calibrated", reason=reason,
                rows=int(X.shape[0]), threshold=threshold,
            )

    def rebase(self, X, y) -> bool:
        """Re-reference onto a promotion's retrain window (its KNOWN-
        labeled rows). Absorbing: a failure keeps the previous stats."""
        try:
            faults.fault_point("openset.calibrate")
            X = np.asarray(X, np.float64)
            y = np.asarray(y)
            known = y.astype(np.int64) < self.n_classes
            if not int(known.sum()):
                return False
            self._install_reference(X[known], y[known], reason="rebase")
            return True
        except Exception as e:  # noqa: BLE001 — a promotion must not die of its rebase
            self._absorb("openset.calibrate", e)
            return False

    # -- armed scoring -----------------------------------------------------
    def _apply(self, X, labels):
        """Relabel over-threshold active rows ``unknown``; absorbing — any
        scoring failure serves the inner labels fresh."""
        try:
            faults.fault_point("openset.score")
            if self.host_native or not isinstance(labels, torch.Tensor):
                return self._apply_host(X, labels)
            return self._apply_device(X, labels)
        except Exception as e:  # noqa: BLE001 — scoring must not fail the serve
            self._absorb("openset.score", e)
            return labels

    def _apply_host(self, X, labels):
        with self._lock:
            mean, inv_std, thr = self._mean, self._inv_std, self._threshold
        Xh = host_array(X).astype(np.float64)
        yh = np.asarray(labels)
        scores = openset_scores(Xh, mean, inv_std)
        active = Xh.any(axis=1)
        rej = active & (scores > thr)
        n = int(rej.sum())
        out = np.where(
            rej[: yh.shape[0]], np.int32(self.unknown_index), yh
        ).astype(yh.dtype, copy=False)
        self._note_rejections(n)
        return out

    def device_stats(self, device) -> tuple:
        """``(mean32, inv32, thr32)`` on ``device``: the armed stats in
        float32, uploaded once per calibration epoch."""
        with self._lock:
            mean, inv_std = self._mean, self._inv_std
            thr = self._threshold
            epoch = self._epoch
            cached = self._device_stats
            cached_epoch = self._device_stats_epoch
        if (cached is not None and cached_epoch == epoch
                and cached[0] == device):
            return cached[1:]
        stats = (
            torch.tensor(mean, dtype=torch.float32, device=device),
            torch.tensor(inv_std, dtype=torch.float32, device=device),
            torch.tensor(thr, dtype=torch.float32, device=device),
        )
        with self._lock:
            if self._epoch == epoch:
                self._device_stats = (device, *stats)
                self._device_stats_epoch = epoch
        return stats

    def _apply_device(self, X, labels):
        """The device path: ``openset_scores`` in float32 torch ops on the
        features' device, all launches; the rejection count stays a
        device scalar until the next call reads it."""
        mean32, inv32, thr32 = self.device_stats(X.device)
        score = openset_scores_f32(X, mean32, inv32)
        active = torch.any(X != 0, dim=-1)
        rej = active & (score > thr32)
        out = torch.where(rej[: labels.shape[0]], self.unknown_index, labels)
        with self._lock:
            self._pending_count = rej.sum(dtype=torch.int32)
        return out.to(labels.dtype)

    def _drain_pending_count(self) -> None:
        """Fold the previous device tick's rejection count into the
        counters (it has long since been computed)."""
        with self._lock:
            count, self._pending_count = self._pending_count, None
        if count is None:
            return
        try:
            self._note_rejections(int(count))
        except Exception:  # noqa: BLE001 — a lost scalar drops the sample
            pass

    def _note_rejections(self, n: int) -> None:
        with self._lock:
            self._last_rejected = n
            self._rejections += n
        if self._metrics is not None:
            self._metrics.set("openset_rejected_rows", n)
            if n:
                self._metrics.inc("openset_rejections", n)
        if n and self._recorder is not None:
            self._recorder.record("openset.reject", rows=n)

    # -- fault absorption --------------------------------------------------
    def _absorb(self, site: str, e: Exception) -> None:
        with self._lock:
            if site == "openset.score":
                self._score_faults += 1
            else:
                self._calibrate_faults += 1
        if self._metrics is not None:
            self._metrics.inc("openset_faults")
        if self._recorder is not None:
            self._recorder.record(
                "openset.fault_absorbed", site=site,
                error=type(e).__name__, detail=str(e),
            )

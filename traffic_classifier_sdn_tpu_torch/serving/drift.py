"""Close the loop: online drift detection, background retrain, and
parity-gated hot checkpoint promotion — the port of
``traffic_classifier_sdn_tpu/serving/drift.py``.

The reference freezes its model at pickle time, so traffic whose
distribution shifts under the server degrades accuracy with no signal and
no recourse. This module is where train and serve meet in one process: a
drift monitor over the live feature stream, a background retrainer, and
hot promotion of the fresh checkpoint through the same parity-gated
probing the degradation ladder uses for device recovery — wrong-but-fresh
never promotes, and a bad promotion rolls back via
``serving/retrain.resolve_latest`` with the old model still serving every
tick.

::

    STEADY ──window over threshold──► DRIFTING ──K consecutive──► RETRAINING
       ▲                                 │(score recovers)            │
       │◄────────────────────────────────┘      (fit done, staged)    │
       │                                                              ▼
       │◄──resume── ROLLED_BACK ◄──swap failed── CANDIDATE ◄──────────┘
       │                                   │(N consecutive clean
       │◄──resume── PROMOTED ◄──hot swap───┘  parity probes)

- **STEADY / DRIFTING** — ``DriftMonitor`` maintains streaming
  per-feature and per-class population statistics over the live feature
  matrix: each render tick's active rows fold into the current window's
  sums, windows fold into an EWMA of per-feature means, and a bounded
  reservoir keeps the most recent rows with the labels the live model
  assigned (the "recent labeled window" the retrainer consumes). Every
  ``window`` observations the window closes and scores against a
  **reference distribution** — calibrated from the first windows of the
  serve, persisted into the serving checkpoint (``feature_reference``
  block, io/serving_checkpoint.py FORMAT_VERSION 3) so a restored serve
  resumes against the same reference instead of re-calibrating on
  already-drifted traffic, and re-based onto the retrain window on every
  promotion. The score is the max of the per-feature EWMA z-shift
  (|mean − ref_mean| / ref_std) and the class-mix shift; a window over
  ``threshold`` enters DRIFTING, and ``trips`` CONSECUTIVE over-threshold
  windows trip the retrain (one noisy window never does).
- **RETRAINING** — the trip snapshots the reservoir and submits a fit to
  a ``retrain.BackgroundRetrainer`` worker: ``retrain.fit_family`` (the
  port's trainers, train/, on the controller's device; on a card the fit
  runs on a CUDA stream of its own, synchronized before anything is
  published) then a candidate checkpoint written through the atomic
  staged-commit path (io/checkpoint.save_model) into the drift
  directory's ``model-<seq>`` rotation. The serve keeps ticking on the old model throughout; a fit
  that outlives ``retrain_deadline`` (injectable clock) is ABANDONED —
  the watchdog discipline, minus the blocking wait.
- **CANDIDATE** — the staged candidate serves shadow batches off the hot
  path: each window boundary, its labels on the latest observed rows are
  compared against the labels the LIVE model assigned those rows (exact
  parity by default, ``parity_min``). ``probe_successes`` CONSECUTIVE
  clean probes promote; any miss resets the chain, and a candidate that
  keeps failing is rejected outright — wrong-but-fresh never promotes.
- **PROMOTED / ROLLED_BACK** — promotion hot-swaps the candidate's
  serving pair into the ``DriftGate`` (the predict wrapper both serve
  loops already route through) and re-bases the monitor's reference onto
  the retrain window. A failed swap rolls back: the candidate is
  discarded from the rotation and the newest checkpoint that still LOADS
  (``retrain.resolve_latest`` — the boot seed at minimum, saved at
  drift-enable time) is re-installed; if even the rollback reload fails,
  the gate simply keeps the pair it already holds. Either way the old
  model serves every tick. Both are momentary states: the next window
  resumes STEADY.

**No-fault guarantee**: with ``--drift auto`` and no drift, serve output
is byte-identical to ``--drift off`` (serial and pipelined —
tests/test_drift.py pins it). The gate forwards the caller's params
untouched until the first promotion and returns the inner predict's
labels unmodified; all monitor work happens AFTER the tick's labels are
produced, on the device-stage worker in pipelined mode (its idle time
between renders) or the serve thread in serial mode, and only touches
host copies (the captured tensors are copied off the card there).

Chaos: ``drift.window`` (window observation fails → dropped, counted),
``retrain.fit`` (refit dies → old model keeps serving, a still-drifting
stream re-trips), ``promote.swap`` (hot swap fails → rollback via
``resolve_latest``) and ``promote.rollback`` (the rollback reload itself
fails → the gate keeps its current pair) are registered fault sites —
ALL absorbed: the serve never crashes and never misses a tick
(tests/test_torch_chaos.py). Every transition lands in the flight
recorder (``drift.transition``), /metrics (``drift_state``/``drift_score``
gauges; ``retrain_runs``/``promotions``/``rollbacks`` counters) and
/healthz (``drift`` block + ``model_age_s``).
"""

from __future__ import annotations

import collections
import contextlib
import os
import sys
import threading
import time

import numpy as np
import torch

from ..utils import faults
from . import retrain
from .openset import host_array

STEADY = "STEADY"
DRIFTING = "DRIFTING"
RETRAINING = "RETRAINING"
CANDIDATE = "CANDIDATE"
PROMOTED = "PROMOTED"
ROLLED_BACK = "ROLLED_BACK"

# seconds ``DriftController.close`` waits for a fit still running
CLOSE_JOIN_S = 60.0

# the drift_state gauge encoding
STATE_GAUGE = {
    STEADY: 0, DRIFTING: 1, RETRAINING: 2, CANDIDATE: 3, PROMOTED: 4,
    ROLLED_BACK: 5,
}


class DriftMonitor:
    """Streaming per-feature/per-class population statistics with a
    windowed trip rule and a bounded labeled reservoir.

    Single-threaded by contract: ``observe`` is called from exactly one
    thread at a time (the serve loop's render path — the device-stage
    worker when pipelined). The controller mirrors the fields other
    threads need under its own lock.

    ``reference`` seeds a previously persisted reference (the serving
    checkpoint's ``feature_reference`` block: ``mean``, ``std``,
    ``class_freq``, ``count`` arrays, and — since the open-set tier —
    optional ``class_mean``/``class_std``/``class_count`` per-class
    per-feature statistics); without one, the first
    ``calibration_windows`` non-empty windows calibrate it from the
    live stream.

    Open-world labels: observed labels may carry the ``unknown`` index
    ``n_classes`` (serving/openset.OpenSetGate rejections). The class
    mix tracks ``n_classes + 1`` slots — a surge in the unknown
    fraction IS a class-mix drift signal, attributed as the ``unknown``
    class — while the per-class feature statistics and the reference
    freeze EXCLUDE unknown rows (a rejected row has no trustworthy
    class to teach).

    Attribution: every scored window's report carries an
    ``attribution`` block — the top-k per-feature z-shift contributors
    and the top per-class frequency deltas, plus the score
    decomposition — so a trip names WHAT moved, not just that
    something did.
    """

    ATTRIBUTION_TOP_K = 3

    def __init__(self, n_features: int = 12, n_classes: int = 2, *,
                 window: int = 8, threshold: float = 4.0, trips: int = 3,
                 calibration_windows: int = 2, ewma_alpha: float = 0.5,
                 class_tolerance: float = 0.2,
                 reservoir_rows: int = 4096,
                 reference: dict | None = None, eps: float = 1e-9):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.n_features = int(n_features)
        self.n_classes = int(n_classes)
        self.window = int(window)
        self.threshold = float(threshold)
        self.trips = max(1, int(trips))
        self.calibration_windows = max(1, int(calibration_windows))
        self.ewma_alpha = float(ewma_alpha)
        self.class_tolerance = float(class_tolerance)
        self.reservoir_rows = int(reservoir_rows)
        self.eps = float(eps)
        self.windows = 0  # completed windows (the test-visible index)
        self.score = 0.0
        self.over_streak = 0
        self._obs = 0
        # class-mix slots: n_classes known classes + one ``unknown``
        # slot (index n_classes) for open-set rejections
        self._n_mix = self.n_classes + 1
        self._wsum = np.zeros(self.n_features, np.float64)
        self._wsumsq = np.zeros(self.n_features, np.float64)
        self._wclass = np.zeros(self._n_mix, np.float64)
        self._wrows = 0
        self._ewma: np.ndarray | None = None
        self._cal_sum = np.zeros(self.n_features, np.float64)
        self._cal_sumsq = np.zeros(self.n_features, np.float64)
        self._cal_class = np.zeros(self._n_mix, np.float64)
        # per-class per-feature calibration moments (unknown excluded)
        self._cal_class_sum = np.zeros(
            (self.n_classes, self.n_features), np.float64
        )
        self._cal_class_sumsq = np.zeros(
            (self.n_classes, self.n_features), np.float64
        )
        self._cal_class_rows = np.zeros(self.n_classes, np.float64)
        self._cal_rows = 0
        self._cal_windows = 0
        self._res: collections.deque = collections.deque()
        self._res_rows = 0
        self._ref = self._validate_reference(reference)

    def _validate_reference(self, reference) -> dict | None:
        if not reference:
            return None
        ref = {
            k: np.asarray(reference[k], np.float64)
            for k in ("mean", "std", "class_freq")
        }
        ref["count"] = np.asarray(
            reference.get("count", 0.0), np.float64
        )
        # pre-open-set references carry n_classes mix slots; pad the
        # unknown slot with 0 (no rejections were possible then)
        if ref["class_freq"].shape == (self.n_classes,):
            ref["class_freq"] = np.concatenate(
                [ref["class_freq"], np.zeros(1, np.float64)]
            )
        # every shape checked HERE, at construction: a reference
        # persisted by a serve with a different feature/class layout
        # must fail loudly at startup, never as a broadcast error in
        # the middle of a window close
        for key, want in (("mean", (self.n_features,)),
                          ("std", (self.n_features,)),
                          ("class_freq", (self._n_mix,))):
            if ref[key].shape != want:
                raise ValueError(
                    f"feature_reference {key} shape {ref[key].shape} "
                    f"!= {want} — the persisted reference belongs to a "
                    f"different model layout"
                )
        # optional per-class per-feature stats (the open-set tier's
        # reference; absent in older checkpoints)
        for key, want in (
            ("class_mean", (self.n_classes, self.n_features)),
            ("class_std", (self.n_classes, self.n_features)),
            ("class_count", (self.n_classes,)),
        ):
            if key in reference:
                arr = np.asarray(reference[key], np.float64)
                if arr.shape != want:
                    raise ValueError(
                        f"feature_reference {key} shape {arr.shape} "
                        f"!= {want} — the persisted reference belongs "
                        f"to a different model layout"
                    )
                ref[key] = arr
        return ref

    @property
    def calibrated(self) -> bool:
        return self._ref is not None

    def reference_arrays(self) -> dict | None:
        """The reference as a flat name→array dict — the serving
        checkpoint's ``feature_reference`` block. None before
        calibration completes."""
        ref = self._ref
        if ref is None:
            return None
        return {k: np.array(v) for k, v in ref.items()}

    def observe(self, X, y) -> dict | None:
        """Fold one batch of ACTIVE rows (and the labels the live model
        assigned them) into the current window. Returns None mid-window
        and a window report dict at each window boundary."""
        X = np.asarray(X, np.float64)
        y = np.asarray(y)
        if X.shape[0]:
            self._wsum += X.sum(axis=0)
            self._wsumsq += np.square(X).sum(axis=0)
            # labels may carry the unknown index n_classes (open-set
            # rejections) — it gets its own mix slot
            labels = np.clip(
                y.astype(np.int64), 0, self.n_classes
            )
            self._wclass += np.bincount(
                labels, minlength=self._n_mix
            )[: self._n_mix]
            if self._ref is None:
                # per-class calibration moments — KNOWN rows only (a
                # rejected row has no trustworthy class to teach)
                known = labels < self.n_classes
                if known.any():
                    np.add.at(
                        self._cal_class_sum, labels[known], X[known]
                    )
                    np.add.at(
                        self._cal_class_sumsq, labels[known],
                        np.square(X[known]),
                    )
                    np.add.at(
                        self._cal_class_rows, labels[known], 1.0
                    )
            self._wrows += int(X.shape[0])
            self._res.append(
                (X.astype(np.float32), y.astype(np.int32))
            )
            self._res_rows += int(X.shape[0])
            while self._res_rows > self.reservoir_rows and len(
                self._res
            ) > 1:
                old_X, _old_y = self._res.popleft()
                self._res_rows -= int(old_X.shape[0])
        self._obs += 1
        if self._obs < self.window:
            return None
        return self._close_window()

    def _close_window(self) -> dict:
        rows = self._wrows
        mean = freq = sumsq = None
        if rows:
            mean = self._wsum / rows
            freq = self._wclass / rows
            sumsq = self._wsumsq.copy()
        self._wsum[:] = 0.0
        self._wsumsq[:] = 0.0
        self._wclass[:] = 0.0
        self._wrows = 0
        self._obs = 0
        self.windows += 1
        report = {
            "window": self.windows, "rows": rows, "score": self.score,
            "over": False, "tripped": False, "calibrating": False,
            "empty": rows == 0,
        }
        if rows == 0:
            return report  # nothing observed: the streak is untouched
        if self._ref is None:
            self._cal_sum += mean * rows
            self._cal_sumsq += sumsq
            self._cal_class += freq * rows
            self._cal_rows += rows
            self._cal_windows += 1
            report["calibrating"] = True
            if self._cal_windows >= self.calibration_windows:
                self._freeze_reference()
            return report
        a = self.ewma_alpha
        self._ewma = (
            mean if self._ewma is None
            else a * self._ewma + (1.0 - a) * mean
        )
        ref_std = np.maximum(self._ref["std"], self.eps)
        zs = np.abs(self._ewma - self._ref["mean"]) / ref_std
        z = float(np.max(zs))
        # class-mix shift scaled so it CAN trip the default threshold:
        # the max frequency delta is 1.0, so the score ceiling is
        # 1/class_tolerance — the default 0.2 puts a full label-mix
        # inversion at 5.0, above the default threshold 4.0 (a
        # tolerance of threshold⁻¹ or larger would make this signal
        # mathematically inert)
        class_deltas = freq - self._ref["class_freq"]
        c = float(np.max(np.abs(class_deltas))) / self.class_tolerance
        self.score = max(z, c)
        report["score"] = self.score
        # attribution: WHAT moved, not just that something did — the
        # top-k per-feature z contributors and per-class frequency
        # deltas, plus the score decomposition. Index n_classes in the
        # class list is the open-set ``unknown`` slot.
        k = self.ATTRIBUTION_TOP_K
        feat_order = np.argsort(zs)[::-1][:k]
        class_order = np.argsort(np.abs(class_deltas))[::-1][:k]
        report["attribution"] = {
            "z_score": z,
            "class_score": c,
            "dominant": "feature" if z >= c else "class",
            "features": [
                (int(i), float(zs[i])) for i in feat_order
            ],
            "classes": [
                (int(i), float(class_deltas[i])) for i in class_order
            ],
            # the FULL per-slot vector: gauge publication must refresh
            # every class every window — a class that left the top-k
            # must not keep its stale high gauge forever
            "all_class_deltas": [float(d) for d in class_deltas],
        }
        if self.score > self.threshold:
            self.over_streak += 1
            report["over"] = True
            if self.over_streak >= self.trips:
                report["tripped"] = True
        else:
            self.over_streak = 0
        return report

    def _freeze_reference(self) -> None:
        rows = self._cal_rows
        mean = self._cal_sum / rows
        var = np.maximum(self._cal_sumsq / rows - mean * mean, 0.0)
        # per-class stats from the same calibration windows (unknown
        # rows excluded at accumulation); empty classes are inert —
        # zero mean, eps std
        crows = np.maximum(self._cal_class_rows, 1.0)[:, None]
        cmean = self._cal_class_sum / crows
        cvar = np.maximum(
            self._cal_class_sumsq / crows - cmean * cmean, 0.0
        )
        self._ref = {
            "mean": mean,
            "std": np.sqrt(var),
            "class_freq": self._cal_class / rows,
            "count": np.float64(rows),
            "class_mean": cmean,
            "class_std": np.sqrt(cvar),
            "class_count": self._cal_class_rows.copy(),
        }

    def reset_streak(self) -> None:
        self.over_streak = 0

    def reservoir_window(self) -> tuple[np.ndarray, np.ndarray] | None:
        """The recent labeled window as ``(X, y)`` — the retrainer's
        training set (labels may include the unknown index; the
        controller filters before fitting). None when nothing has been
        observed."""
        if not self._res:
            return None
        X = np.concatenate([x for x, _ in self._res], axis=0)
        y = np.concatenate([y_ for _, y_ in self._res], axis=0)
        return X, y

    def known_reservoir_window(
        self,
    ) -> tuple[np.ndarray, np.ndarray] | None:
        """``reservoir_window`` restricted to rows with a KNOWN class
        label — what the retrainer fits on and what the per-class
        reference/open-set rebase learns from. A rejected (unknown)
        row has no trustworthy label: teaching it to any class would
        fold the novel traffic into the known world, which is exactly
        how a promoted model would FORGET to reject it."""
        window = self.reservoir_window()
        if window is None:
            return None
        X, y = window
        known = y.astype(np.int64) < self.n_classes
        if not int(known.sum()):
            return None
        return X[known], y[known]

    def rebase_from_reservoir(self) -> bool:
        """Re-reference onto the retrain window's own statistics after a
        promotion: the new model's 'training-time' distribution IS that
        window, so drift detection continues relative to it. Global
        feature stats and the class mix fold in EVERY reservoir row
        (the unknown fraction becomes the new baseline — sustained
        novel traffic stops re-tripping); the per-class stats fold in
        KNOWN rows only, so rejection survives the rebase. Resets the
        EWMA, streak, and score."""
        window = self.reservoir_window()
        if window is None:
            return False
        X, y = window
        Xf = np.asarray(X, np.float64)
        mean = Xf.mean(axis=0)
        labels = np.clip(y.astype(np.int64), 0, self.n_classes)
        freq = (
            np.bincount(labels, minlength=self._n_mix)[
                : self._n_mix
            ].astype(np.float64) / max(1, Xf.shape[0])
        )
        self._ref = {
            "mean": mean,
            "std": Xf.std(axis=0),
            "class_freq": freq,
            "count": np.float64(Xf.shape[0]),
        }
        # per-class moments through the ONE batch-window home
        # (serving/openset.class_reference — it excludes unknown rows
        # by the same rule); the streaming accumulators in observe/
        # _freeze_reference genuinely need their own incremental code,
        # this full-window path does not
        from .openset import class_reference

        cref = class_reference(Xf, labels, self.n_classes)
        self._ref["class_mean"] = cref["class_mean"]
        self._ref["class_std"] = cref["class_std"]
        self._ref["class_count"] = cref["class_count"]
        self._ewma = None
        self.over_streak = 0
        self.score = 0.0
        return True


class DriftGate:
    """The predict wrapper both serve loops route through: a transparent
    passthrough until the first promotion, an atomic hot-swap point
    after it.

    Pre-swap the caller's ``params`` are forwarded untouched and the
    inner predict's return value (device array or host array) comes back
    unmodified — which is what keeps ``--drift auto`` byte-identical to
    ``--drift off`` on the no-promotion path. ``install`` swaps in a
    ``(predict_fn, params)`` pair; from then on the gate's own pair
    serves and the caller's stale params operand is ignored.

    Each call also captures ``(X, labels)`` BY REFERENCE (host
    microseconds): the controller's ``poll`` materializes them off the
    hot path. ``host_native`` mirrors the wrapped predict so the serve
    loop's routing (pipelined read-side branch, warmup) is unchanged.
    """

    def __init__(self, predict):
        self.host_native = bool(getattr(predict, "host_native", False))
        self._lock = threading.Lock()
        self._fn = predict
        self._params = None
        self._swapped = False
        self._swap_count = 0
        self._capture = None

    def __call__(self, params, X):
        with self._lock:
            fn = self._fn
            p = self._params if self._swapped else params
        labels = fn(p, X)
        with self._lock:
            self._capture = (X, labels)
        return labels

    def take_capture(self):
        """The newest ``(X, labels)`` pair, consumed (None when no
        predict ran since the last take)."""
        with self._lock:
            cap = self._capture
            self._capture = None
            return cap

    def install(self, fn, params):
        """Atomically swap the serving pair (promotion / rollback);
        returns the REPLACED predict callable so the caller can retire
        it (a ladder-wrapped predict owns a watchdog thread)."""
        with self._lock:
            prev = self._fn
            self._fn = fn
            self._params = params
            self._swapped = True
            self._swap_count += 1
            return prev

    @property
    def inner(self):
        """The currently installed predict callable — consumers that
        must follow promotions (GateLadderView) read through this."""
        with self._lock:
            return self._fn

    @property
    def swapped(self) -> bool:
        with self._lock:
            return self._swapped

    @property
    def label_epoch(self) -> tuple:
        """Label-source epoch for the incremental predict path
        (serving/incremental.py): any promotion or rollback
        (``install``) bumps the swap count, and a wrapped ladder's own
        rung epoch rides along — comparing the pair detects BOTH swap
        kinds, so a model hot-swap always invalidates the whole label
        cache (wrong-but-cached must never survive a promotion)."""
        with self._lock:
            fn = self._fn
            count = self._swap_count
        return (count, getattr(fn, "label_epoch", 0))


class GateLadderView:
    """Degradation-ladder adapter for serves running BOTH ``--degrade``
    and ``--drift``: a promotion rebuilds the ladder around the promoted
    kernel (the CLI's ``build_serving``), so consumers of the ladder's
    ``render_stale``/``status`` surface — the render paths' STALE column
    and /healthz — must follow the gate's CURRENT inner callable, not
    the boot ladder object the serve started with."""

    def __init__(self, gate: DriftGate, boot_ladder):
        self._gate = gate
        self._boot = boot_ladder

    def _live(self):
        inner = self._gate.inner
        return inner if hasattr(inner, "render_stale") else self._boot

    @property
    def render_stale(self) -> bool:
        return bool(self._live().render_stale)

    def status(self) -> dict:
        live = self._live()
        status = getattr(live, "status", None)
        return status() if status is not None else self._boot.status()

    def close(self) -> None:
        """Retire BOTH the live ladder and the boot one (idempotent —
        a promoted serve's boot ladder was already closed at swap)."""
        for obj in (self._gate.inner, self._boot):
            close = getattr(obj, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 — teardown is best-effort
                    pass


class ShardedDriftGate:
    """``DriftGate``-shaped adapter for the SHARDED spine. The
    single-device gate wraps the predict callable the serve loop invokes;
    the sharded engine instead runs its predict INSIDE the per-shard read
    steps (parallel/table_sharded.make_tick_outputs*), so there is no call
    site to wrap. This adapter gives the ``DriftController`` the same
    surface — ``take_capture``/``install``/``swapped``/``inner`` — with
    ``install`` routed through ``ShardedFlowEngine.install_predict``
    (rebuilds the read steps, places the params on every shard's device,
    resets the per-shard label caches all-dirty) and captures FED by the
    serve loop, which samples the rendered rows' features
    (``engine.feature_sample``) and labels after each render and hands the
    pair to ``feed_capture``."""

    host_native = False

    def __init__(self, engine):
        self._engine = engine
        self._lock = threading.Lock()
        self._capture = None
        self._swapped = False

    def feed_capture(self, X, labels) -> None:
        """Per-render observation hand-off — the sharded stand-in for
        ``DriftGate.__call__``'s by-reference capture."""
        with self._lock:
            self._capture = (X, labels)

    def take_capture(self):
        with self._lock:
            cap, self._capture = self._capture, None
            return cap

    def install(self, fn, params):
        prev_fn, _prev_params = self._engine.install_predict(fn, params)
        with self._lock:
            self._swapped = True
        return prev_fn

    @property
    def inner(self):
        return self._engine._predict_fn

    @property
    def swapped(self) -> bool:
        with self._lock:
            return self._swapped


def default_build_serving(family: str, classes):
    """``params -> (predict_fn, serve_params)`` through the resolution the
    CLI boot path uses (``LoadedModel.serving_path``: the serving menus,
    and on a card the kernel's operands and build), so a promoted
    checkpoint serves on exactly the kernel the boot model did."""
    from ..models import make_loaded_model
    from ..models.base import ClassList

    def build(params):
        loaded = make_loaded_model(
            family, params, ClassList(tuple(classes))
        )
        return loaded.serving_path()

    return build


class DriftController:
    """The drift→retrain→promote state machine (module docstring).

    ``poll()`` is called once per render tick after the tick's labels
    are produced, from ONE thread at a time (the pipelined device-stage
    worker or the serial serve thread); ``status()``/
    ``reference_arrays()`` may be called concurrently from the
    exposition/snapshot threads and read only mirrored state under the
    controller lock. ``clock`` (monotonic seconds) is injectable so the
    retrain deadline and status ages are exact in tests. ``device`` is
    where fits run, candidates load and probes predict (default CUDA, see
    device.py); ``boot_params`` is the boot model's module.
    """

    def __init__(self, gate: DriftGate, *, family: str, classes,
                 directory: str, n_features: int = 12, window: int = 8,
                 threshold: float = 4.0, trips: int = 3,
                 calibration_windows: int = 2, ewma_alpha: float = 0.5,
                 class_tolerance: float = 0.2,
                 probe_successes: int = 3, parity_min: float = 1.0,
                 parity_mode: str = "exact",
                 candidate_max_failures: int = 6,
                 retrain_deadline: float = 300.0,
                 min_retrain_rows: int = 32,
                 reservoir_rows: int = 4096, keep: int = 3,
                 reference: dict | None = None, build_serving=None,
                 fit_kwargs: dict | None = None, metrics=None,
                 recorder=None, health=None, clock=time.monotonic,
                 boot_params=None, feature_names=None,
                 follow_rotation: bool = False, device=None):
        from ..device import resolve_device

        self._gate = gate
        self._device = resolve_device(device)
        self._family = family
        self._classes = tuple(classes)
        self._directory = directory
        # open-set composition — wired POST-construction via
        # set_openset (the OpenSetGate wraps the DriftGate, so it
        # cannot exist before the controller): the gate to re-base at
        # each promotion, and its capture as the observation source so
        # the monitor sees the ``unknown`` relabels as the (C+1)th
        # mix slot. One wiring point keeps the pair consistent.
        self._openset = None
        self._capture_source = None
        # display names for attribution: known classes + the open-set
        # unknown slot; feature names fall back to column indices
        self._mix_names = self._classes + ("unknown",)
        if feature_names is None and int(n_features) == 12:
            from ..core.features import FEATURE_COLUMNS_12

            feature_names = FEATURE_COLUMNS_12
        self._feature_names = (
            tuple(feature_names) if feature_names is not None
            else tuple(str(i) for i in range(int(n_features)))
        )
        self._attribution: dict | None = None
        self.probe_successes = max(1, int(probe_successes))
        self.parity_min = float(parity_min)
        if parity_mode not in ("exact", "mode-matched"):
            raise ValueError(
                f"parity_mode {parity_mode!r} not in "
                f"('exact', 'mode-matched')"
            )
        self.parity_mode = parity_mode
        self.candidate_max_failures = max(
            1, int(candidate_max_failures)
        )
        self.retrain_deadline = float(retrain_deadline)
        self.min_retrain_rows = int(min_retrain_rows)
        self.keep = int(keep)
        self._fit_kwargs = dict(fit_kwargs or {})
        self._metrics = metrics
        self._recorder = recorder
        self._health = health
        self._clock = clock
        self._build = (
            build_serving if build_serving is not None
            else default_build_serving(family, self._classes)
        )
        self._monitor = DriftMonitor(
            n_features=n_features, n_classes=len(self._classes),
            window=window, threshold=threshold, trips=trips,
            calibration_windows=calibration_windows,
            ewma_alpha=ewma_alpha, class_tolerance=class_tolerance,
            reservoir_rows=reservoir_rows,
            reference=reference,
        )
        self._retrainer = retrain.BackgroundRetrainer()
        # the fit's own CUDA stream: it neither queues behind nor races
        # the serve's streams
        self._fit_stream = (torch.cuda.Stream(self._device)
                            if self._device.type == "cuda" else None)
        self._lock = threading.Lock()
        self._state = STEADY
        self._candidate = None  # (fn, params, path, seq)
        # fleet follower mode: scan the shared rotation for members a
        # PEER serve staged and adopt them as candidates — promotion
        # then rides the same parity-gated probe ladder, so fleet-wide
        # propagation never bypasses the wrong-but-fresh gate
        self.follow_rotation = bool(follow_rotation)
        self._candidate_adopted = False
        # highest ADOPTED seq already judged (either way): a rejected
        # adoption must not be re-adopted every poll — but the member
        # stays in the rotation (it is the PEER's, maybe its promoted
        # model; a follower never discards shared members)
        self._follow_seen = 0
        # the latest FULL-shape capture (X f32, y, active mask) — probes
        # run the exact serving shape the candidate will serve
        self._last_shadow: tuple | None = None
        self._probe_ok = 0
        self._probe_failures = 0
        self._retrain_started_at = 0.0
        # the highest seq known to be a legitimate restore target;
        # rollback discards every rotation member ABOVE it — an
        # abandoned fit's late-committed candidate must never be what
        # resolve_latest hands back. Initialized below from the
        # rotation itself: a RESTARTED serve must treat prior runs'
        # promoted checkpoints as legitimate, not as strays
        self._promoted_seq = 0
        self._counts = {
            "windows": 0, "window_errors": 0, "retrain_runs": 0,
            "retrain_failures": 0, "promotions": 0, "rollbacks": 0,
            "probe_failures": 0,
        }
        self._score = 0.0
        os.makedirs(directory, exist_ok=True)
        # Seed the rotation with the BOOT model (staged-commit save) so
        # "roll back via resolve_latest" is well-defined before any
        # promotion has ever happened. Idempotent across restarts: an
        # existing loadable member is kept. A follow_rotation member
        # NEVER seeds: the shared rotation belongs to the fleet and two
        # members racing to write seq 0 would collide on one member
        # path — the leader owns the boot seed, followers adopt.
        # a loadability check: the host copy is enough
        latest = retrain.resolve_latest(directory, device="cpu")
        if (boot_params is not None and latest is None
                and not self.follow_rotation):
            latest = retrain.save_candidate(
                directory, 0, family, boot_params, self._classes
            )
        # never-reused candidate sequence numbers: an abandoned fit may
        # still be writing model-<seq> when the next trip launches — a
        # fresh seq per launch means the two can never collide on one
        # checkpoint directory
        self._next_candidate_seq = retrain.next_seq(directory)
        if latest is not None:
            for member_seq, member_path in retrain.list_candidates(
                directory
            ):
                if member_path == latest:
                    self._promoted_seq = member_seq
                    break
        if metrics is not None:
            metrics.set("drift_state", STATE_GAUGE[STEADY])
            metrics.set("drift_score", 0.0)

    # -- public surface ----------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def set_health(self, health) -> None:
        with self._lock:
            self._health = health

    def set_openset(self, gate) -> None:
        """Wire the outermost OpenSetGate (cli.py constructs it AFTER
        the controller — the gate wraps the DriftGate, so it cannot
        exist first): promotions re-base the gate's reference onto the
        retrain window, and observation consumes the gate's capture so
        the monitor sees the ``unknown`` relabels. The ONE wiring
        point — rebase target, capture source, and the gate's capture
        opt-in always move together."""
        gate.enable_capture()
        with self._lock:
            self._openset = gate
            self._capture_source = gate.take_capture

    def status(self) -> dict:
        """The /healthz self-report (obs.HealthState.set_drift)."""
        with self._lock:
            return {
                "state": self._state,
                "gauge": STATE_GAUGE[self._state],
                "score": self._score,
                # why the score is what it is: top z-shift features,
                # top class-mix deltas (unknown slot included), and
                # the score decomposition — an operator reads WHY the
                # monitor tripped without tailing the ring
                "attribution": self._attribution,
                "windows": self._counts["windows"],
                "window_errors": self._counts["window_errors"],
                "retrain_runs": self._counts["retrain_runs"],
                "retrain_failures": self._counts["retrain_failures"],
                "promotions": self._counts["promotions"],
                "rollbacks": self._counts["rollbacks"],
                "probe_successes": self._probe_ok,
                "calibrated": self._monitor.calibrated,
                "swapped": self._gate.swapped,
            }

    def reference_arrays(self) -> dict | None:
        """The monitor's reference for serving-checkpoint persistence
        (io/serving_checkpoint.save ``feature_reference=``)."""
        return self._monitor.reference_arrays()

    def close(self) -> None:
        self._retrainer.abandon()
        # an abandoned fit publishes nothing, but it may still be inside
        # torch: wait for it (bounded), as exiting under it aborts the
        # process
        self._retrainer.join(CLOSE_JOIN_S)
        with self._lock:
            candidate, self._candidate = self._candidate, None
            self._last_shadow = None
        if candidate is not None:
            # a still-staged candidate owns its own predict (a rebuilt
            # ladder's watchdog thread included) — retire it with the
            # controller
            self._retire(candidate[0])

    # -- the per-render-tick poll ------------------------------------------
    def poll(self) -> None:
        """Advance the loop one step. Called after the tick's labels are
        produced — off the hot path. NEVER raises: every failure mode is
        absorbed and counted (the serve loop must not die of its own
        self-updating machinery)."""
        gate_cap = self._gate.take_capture()
        if self._capture_source is not None:
            # the openset gate is the outermost wrapper: observe ITS
            # labels (unknown relabels included); the drift gate's own
            # capture is drained above so it never pins a stale tick
            cap = self._capture_source()
        else:
            cap = gate_cap
        report = self._observe(cap) if cap is not None else None
        if self.state == RETRAINING:
            self._check_retrain()
        if self.follow_rotation and self.state in (STEADY, DRIFTING):
            # fleet follower: a peer's freshly staged rotation member
            # becomes a candidate HERE too — probed below like any
            # locally retrained one (the scan is one listdir; a member
            # already judged or predating the promoted seq is skipped)
            self._check_rotation()
        if report is None:
            return
        state = self.state
        if state in (PROMOTED, ROLLED_BACK):
            self._transition(STEADY, "resume")
            state = STEADY
        if state == CANDIDATE:
            self._probe_candidate()
            return
        if state not in (STEADY, DRIFTING):
            return
        if report["calibrating"] or report["empty"]:
            return
        if report["tripped"]:
            self._start_retrain(report)
        elif report["over"]:
            if state == STEADY:
                self._transition(
                    DRIFTING, f"score={report['score']:.3g}"
                )
        elif state == DRIFTING:
            self._transition(STEADY, "score-recovered")

    # -- observation -------------------------------------------------------
    def _observe(self, cap) -> dict | None:
        X, labels = cap
        try:
            faults.fault_point("drift.window")
            Xh = host_array(X).astype(np.float64)
            yh = host_array(labels)
            yh = yh[: Xh.shape[0]]
            mask = Xh.any(axis=1)
            # the stats update sits INSIDE the absorbing try: poll()'s
            # never-raises contract covers the monitor math too — an
            # exotic batch must drop the sample, never the serve
            report = self._monitor.observe(Xh[mask], yh[mask])
        except Exception as e:  # noqa: BLE001 — observation must not kill the serve
            # absorbed: a failed observation — the injected
            # drift.window fire or a stats-update failure — drops the
            # sample, never the serve
            self._count("window_errors", metric="drift_window_errors")
            if self._recorder is not None:
                self._recorder.record(
                    "drift.window_error", error=type(e).__name__,
                    detail=str(e),
                )
            return None
        with self._lock:
            # full serving-shape shadow, kept only while a candidate is
            # (about to be) probing — O(capacity) host memory is paid
            # exactly when the parity gate needs it
            if self._state in (RETRAINING, CANDIDATE) and int(
                mask.sum()
            ):
                self._last_shadow = (
                    Xh.astype(np.float32), yh, mask
                )
            if report is not None:
                self._counts["windows"] += 1
                self._score = report["score"]
                if report.get("attribution") is not None:
                    self._attribution = self._name_attribution(
                        report["attribution"]
                    )
        if report is not None:
            if self._metrics is not None:
                self._metrics.set("drift_score", report["score"])
                self._metrics.inc("drift_windows")
                attribution = report.get("attribution")
                if attribution is not None:
                    # per-class attribution gauges: the live |Δfreq|
                    # per mix slot (unknown included), scaled like the
                    # class score so the gauge is threshold-comparable.
                    # EVERY slot refreshes every scored window — a
                    # class that recovered must read ~0, not its last
                    # top-k value
                    for ci, delta in enumerate(
                        attribution["all_class_deltas"]
                    ):
                        name = self._mix_names[ci] if ci < len(
                            self._mix_names
                        ) else str(ci)
                        self._metrics.set(
                            f"drift_attribution_{name}",
                            abs(delta) / self._monitor.class_tolerance,
                        )
            if report["over"] and self._recorder is not None:
                self._recorder.record(
                    "drift.window", window=report["window"],
                    score=report["score"],
                    streak=self._monitor.over_streak,
                    attribution=self._name_attribution(
                        report.get("attribution")
                    ),
                )
        return report

    def _name_attribution(self, attribution) -> dict | None:
        """The monitor's index-based attribution with class/feature
        names resolved — what /healthz, the ring, and the transition
        log carry (an operator reads ``voice``/``Delta Forward
        Bytes``, not slot numbers)."""
        if attribution is None:
            return None
        def fname(i: int) -> str:
            return (
                self._feature_names[i]
                if i < len(self._feature_names) else str(i)
            )
        def cname(i: int) -> str:
            return (
                self._mix_names[i] if i < len(self._mix_names)
                else str(i)
            )
        return {
            "z_score": round(attribution["z_score"], 6),
            "class_score": round(attribution["class_score"], 6),
            "dominant": attribution["dominant"],
            "top_class": cname(attribution["classes"][0][0])
            if attribution["classes"] else None,
            "top_feature": fname(attribution["features"][0][0])
            if attribution["features"] else None,
            "features": [
                {"feature": fname(i), "z": round(z, 6)}
                for i, z in attribution["features"]
            ],
            "classes": [
                {"class": cname(i), "delta": round(d, 6)}
                for i, d in attribution["classes"]
            ],
        }

    # -- retrain -----------------------------------------------------------
    def _start_retrain(self, report: dict) -> None:
        # KNOWN-labeled rows only: an open-set rejection must never
        # become training signal (teaching the novel class to a known
        # label is exactly how the promoted model would stop rejecting
        # it)
        window = self._monitor.known_reservoir_window()
        n_classes = len(self._classes)
        if window is None or window[0].shape[0] < self.min_retrain_rows \
                or np.unique(window[1]).size < min(2, n_classes):
            # not enough labeled signal to refit: stay DRIFTING — the
            # streak persists, so a still-drifting stream retries at
            # the next window with a fuller reservoir
            if self._recorder is not None:
                self._recorder.record(
                    "drift.retrain_skipped", reason="window-insufficient"
                )
            if self.state == STEADY:
                self._transition(
                    DRIFTING, f"score={report['score']:.3g}"
                )
            return
        X, y = window
        self._monitor.reset_streak()
        family, classes = self._family, self._classes
        directory, fit_kwargs = self._directory, self._fit_kwargs
        device, stream = self._device, self._fit_stream
        with self._lock:
            seq = self._next_candidate_seq
            self._next_candidate_seq += 1
            self._retrain_started_at = self._clock()
            self._last_shadow = None  # probes must postdate the trip

        def job(is_current):
            on_stream = (torch.cuda.stream(stream) if stream is not None
                         else contextlib.nullcontext())
            with on_stream:
                params = retrain.fit_family(
                    family, X, y, n_classes, device=device, **fit_kwargs
                )
            if stream is not None:
                # the fit's kernels are done before anything reads them
                stream.synchronize()
            if not is_current():
                # abandoned at the deadline while fitting: publish
                # NOTHING into the rotation — a never-probed stray must
                # not become resolve_latest's rollback target
                return None
            path = retrain.save_candidate(
                directory, seq, family, params, classes
            )
            return params, path, seq

        self._count("retrain_runs", metric="retrain_runs")
        self._retrainer.submit(job)
        self._transition(
            RETRAINING, f"tripped(score={report['score']:.3g})"
        )

    def _check_retrain(self) -> None:
        state = self._retrainer.poll()
        if state == retrain.RUNNING:
            with self._lock:
                started = self._retrain_started_at
            if self._clock() - started > self.retrain_deadline:
                # the watchdog abandon discipline: the worker's late
                # result is discarded; the loop resumes watching
                self._retrainer.abandon()
                self._count(
                    "retrain_failures", metric="retrain_failures"
                )
                with self._lock:
                    self._last_shadow = None
                self._transition(STEADY, "retrain-deadline")
            return
        if state == retrain.IDLE:
            return
        _state, result, error = self._retrainer.take()
        if _state == retrain.FAILED or result is None:
            self._count("retrain_failures", metric="retrain_failures")
            with self._lock:
                self._last_shadow = None  # episode over: release it
            self._transition(
                STEADY,
                "retrain-failed:" + (
                    type(error).__name__ if error is not None
                    else "abandoned"
                ),
            )
            return
        params, path, seq = result
        try:
            fn, p = self._build(params)
        except Exception as e:  # noqa: BLE001 — a garbage fit must not kill the serve
            retrain.discard_candidate(path)
            self._count("retrain_failures", metric="retrain_failures")
            self._transition(
                STEADY, f"candidate-build-failed:{type(e).__name__}"
            )
            return
        with self._lock:
            self._candidate = (fn, p, path, seq)
            self._candidate_adopted = False
            self._probe_ok = 0
            self._probe_failures = 0
        self._transition(
            CANDIDATE, f"staged:{os.path.basename(path)}"
        )

    def _check_rotation(self) -> None:
        """Adopt a NEWER rotation member staged by a peer serve sharing
        this checkpoint directory (fleet mode): load it, build the
        serving pair, and stage it as this serve's candidate — the
        parity probes then judge it against THIS serve's own live
        labels before it can install. NEVER raises (poll's contract):
        a peer's torn write or a garbage member is counted and skipped,
        and its seq is remembered so it is not re-tried every tick."""
        try:
            members = retrain.list_candidates(self._directory)
        except Exception:  # noqa: BLE001 — a scan failure must not kill the serve
            return
        if not members:
            return
        seq, path = members[0]
        with self._lock:
            if seq <= max(self._promoted_seq, self._follow_seen):
                return
            self._follow_seen = seq
        try:
            loaded = retrain.load_candidate(path, device=self._device)
            fn, p = self._build(loaded.params)
        except Exception as e:  # noqa: BLE001 — a peer's torn member must not kill this serve
            self._count("retrain_failures", metric="retrain_failures")
            if self._recorder is not None:
                self._recorder.record(
                    "drift.follow_error", member=path,
                    error=type(e).__name__, detail=str(e),
                )
            return
        with self._lock:
            self._candidate = (fn, p, path, seq)
            self._candidate_adopted = True
            self._probe_ok = 0
            self._probe_failures = 0
        self._transition(
            CANDIDATE, f"adopted:{os.path.basename(path)}"
        )

    # -- probing / promotion -----------------------------------------------
    def _probe_candidate(self) -> None:
        with self._lock:
            candidate = self._candidate
            # CONSUME the shadow: each probe must judge a FRESH
            # observation — N consecutive clean probes means N
            # independent batches, never one stale batch re-counted
            # across empty windows
            shadow, self._last_shadow = self._last_shadow, None
        if candidate is None:
            self._transition(STEADY, "candidate-lost")
            return
        fn, params, path, seq = candidate
        if shadow is None:
            return  # no fresh observation to probe against this window
        Xs, ys, mask = shadow
        if not int(mask.sum()):
            return
        try:
            # the FULL captured matrix — the exact serving shape the
            # promoted model will serve, on the serve's device
            got = host_array(fn(params, torch.from_numpy(Xs).to(
                self._device)))
        except Exception as e:  # noqa: BLE001 — a crashing candidate is a failed probe
            ok, agree, detail = False, 0.0, f"error:{type(e).__name__}"
        else:
            if got.shape[:1] != ys.shape[:1]:
                ok, agree, detail = False, 0.0, "shape-mismatch"
            else:
                ysm = np.asarray(ys)[mask]
                gotm = got[mask]
                # open-world shadows: rows the openset gate rejected
                # carry the unknown index — a closed-world candidate
                # can never reproduce it, so parity judges KNOWN rows
                # only (an all-unknown shadow judges nothing)
                known = ysm.astype(np.int64) < len(self._classes)
                if not int(known.sum()):
                    return
                agree = self._agreement(gotm[known], ysm[known])
                ok = agree >= self.parity_min
                detail = f"agree={agree:.4f}"
        if self._recorder is not None:
            self._recorder.record(
                "drift.probe", ok=ok, detail=detail,
                successes=self._probe_ok + (1 if ok else 0),
            )
        if ok:
            with self._lock:
                self._probe_ok += 1
                promote = self._probe_ok >= self.probe_successes
            if promote:
                self._promote(candidate)
            return
        self._count("probe_failures", metric="drift_probe_failures")
        with self._lock:
            self._probe_ok = 0
            self._probe_failures += 1
            rejected = (
                self._probe_failures >= self.candidate_max_failures
            )
            adopted = self._candidate_adopted
            if rejected:
                self._candidate = None
                self._candidate_adopted = False
        if rejected:
            # wrong-but-fresh: the candidate disagrees with the live
            # model on the very window it was trained against — it
            # never promotes, and the rotation forgets it; its predict
            # (a rebuilt ladder's watchdog included) is retired too.
            # An ADOPTED member stays: it belongs to the peer that
            # staged it (possibly that peer's promoted model) — the
            # remembered _follow_seen keeps it from being re-adopted
            if not adopted:
                retrain.discard_candidate(path)
            self._retire(fn)
            self._transition(STEADY, f"candidate-rejected:{detail}")

    def _agreement(self, got: np.ndarray, want: np.ndarray) -> float:
        """Probe agreement between candidate and live labels.

        ``exact`` is elementwise equality. ``mode-matched`` (the kmeans
        family's mode: a refit clustering orders its centroids
        arbitrarily, so raw cluster ids are a PERMUTATION of the live
        model's) maps each candidate label to the live majority label
        of its rows first — the mode-matching of the JAX package's
        ``analysis.eval.clustering_accuracy`` — so a perfectly
        consistent relabeling scores 1.0 and an inconsistent one is
        still rejected."""
        if not got.shape[0]:
            return 0.0
        if self.parity_mode == "exact":
            return float(np.mean(got == want))
        matched = 0
        for label in np.unique(got):
            sel = got == label
            _vals, counts = np.unique(want[sel], return_counts=True)
            matched += int(counts.max())
        return matched / got.shape[0]

    def _promote(self, candidate) -> None:
        fn, params, path, seq = candidate
        installed = False
        try:
            faults.fault_point("promote.swap")
            prev = self._gate.install(fn, params)
            installed = True
        except Exception as e:  # noqa: BLE001 — a failed swap must roll back, not crash
            self._rollback(
                path, fn, f"swap-failed:{type(e).__name__}",
                installed=installed,
            )
            return
        with self._lock:
            self._candidate = None
            self._candidate_adopted = False
            self._probe_ok = 0
            self._promoted_seq = seq
            self._last_shadow = None  # O(capacity) host memory: only
            # held while the parity gate needs it
            health = self._health
        self._retire(prev)
        self._count("promotions", metric="promotions")
        if health is not None:
            health.model_promoted()
        # the rebase pair: the monitor re-references onto the retrain
        # window, and the open-set gate re-bases its per-class stats +
        # threshold onto the SAME window's known-labeled rows — the
        # promoted model keeps rejecting what it was never taught
        # (rejected rows are in neither the fit nor the stats). Both
        # are absorbing: a promotion that landed never un-lands.
        self._monitor.rebase_from_reservoir()
        if self._openset is not None:
            known = self._monitor.known_reservoir_window()
            if known is not None:
                self._openset.rebase(known[0], known[1])
        retrain.prune_candidates(self._directory, keep=self.keep)
        self._transition(
            PROMOTED, f"promoted:{os.path.basename(path)}"
        )

    def _retire(self, prev) -> None:
        """Close a replaced predict (a ladder-wrapped one owns a
        watchdog thread). Best-effort: retiring must never fail a
        promotion that already landed."""
        close = getattr(prev, "close", None)
        if close is None:
            return
        try:
            close()
        except Exception:  # noqa: BLE001 — teardown is best-effort
            pass

    def _rollback(self, bad_path: str, bad_fn, why: str,
                  installed: bool = False) -> None:
        """A bad promotion: discard the candidate (and any never-probed
        stray an abandoned fit left above the last promoted seq), then
        resolve the newest checkpoint that still loads
        (``retrain.resolve_latest`` — the boot seed at minimum). The
        resolved checkpoint is re-installed only when the failed swap
        actually LANDED in the gate (``installed`` — with the gate's
        atomic install this cannot happen today, so the branch is
        defensive); otherwise the gate already holds the old model's
        warm pair and keeps it — no cold reload, no compile spike. If
        even the rollback path fails, the gate keeps the pair it
        already holds; every branch ends with the old model serving
        every tick."""
        with self._lock:
            self._candidate = None
            self._probe_ok = 0
            self._last_shadow = None
            promoted_seq = self._promoted_seq
        self._retire(bad_fn)  # the never-installed candidate's threads
        self._count("rollbacks", metric="rollbacks")
        try:
            faults.fault_point("promote.rollback")
            retrain.discard_candidate(bad_path)
            for seq, stray in retrain.list_candidates(self._directory):
                if seq > promoted_seq:
                    retrain.discard_candidate(stray)
            good, loaded = retrain._resolve_and_load(
                self._directory, device=self._device
            )
            if good is None:
                detail = f"{why};no-restorable-checkpoint"
            elif installed:
                fn, p = self._build(loaded.params)
                prev = self._gate.install(fn, p)
                self._retire(prev)
                detail = f"{why};restored:{os.path.basename(good)}"
            else:
                # the swap never landed: the live pair IS the old
                # model, already warm — resolve_latest names the
                # restore target for the audit trail only
                detail = (
                    f"{why};kept-live-pair"
                    f"(latest:{os.path.basename(good)})"
                )
        except Exception as e:  # noqa: BLE001 — rollback failure keeps the live pair
            detail = f"{why};rollback-failed:{type(e).__name__}"
            if self._recorder is not None:
                self._recorder.record(
                    "drift.rollback_error", error=type(e).__name__,
                    detail=str(e),
                )
        self._transition(ROLLED_BACK, detail)

    # -- bookkeeping -------------------------------------------------------
    def _count(self, key: str, metric: str | None = None) -> None:
        with self._lock:
            if key in self._counts:
                self._counts[key] += 1
        if metric is not None and self._metrics is not None:
            self._metrics.inc(metric)

    def _transition(self, to: str, reason: str) -> None:
        with self._lock:
            frm = self._state
            if frm == to:
                return
            self._state = to
            # divergence transitions carry WHY: the responsible
            # class/feature rides the event, so a ring tail (or the
            # post-mortem dump) names the mover without correlation
            attribution = (
                self._attribution if to in (DRIFTING, RETRAINING)
                else None
            )
        if self._metrics is not None:
            self._metrics.inc("drift_transitions")
            self._metrics.set("drift_state", STATE_GAUGE[to])
        if self._recorder is not None:
            if attribution is not None:
                self._recorder.record(
                    "drift.transition", frm=frm, to=to, reason=reason,
                    attribution=attribution,
                )
            else:
                self._recorder.record(
                    "drift.transition", frm=frm, to=to, reason=reason
                )
        print(
            f"DRIFT: {frm} -> {to} ({reason})", file=sys.stderr,
            flush=True,
        )

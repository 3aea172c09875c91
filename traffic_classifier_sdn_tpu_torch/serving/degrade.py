"""Serve through device failure: watchdog, degradation ladder and
self-healing kernel promotion — the port of
``traffic_classifier_sdn_tpu/serving/degrade.py``.

A wedged kernel must not take the serve down with it: the predict path
has rungs, and a tick is always produced on the best rung still working::

    HEALTHY ──deadline/error──► DEGRADED ──fallback error──► BROKEN
       ▲                            │                           │
       │                            └────────── probe due ──────┘
       └──── N consecutive clean probes ──── PROBING ◄──────────┘
                                            (probe failed: back to the
                                             prior rung, backoff grows)

- **HEALTHY** — the card's kernel predict, run through a ``DeviceWatchdog``
  (a worker thread and a wall-clock deadline, ``--device-deadline``). A
  torch launch returns before the kernel ends, so the device call is the
  predict AND the copy of its labels to the host: the copy waits for the
  kernel, and it waits inside the deadline, so a wedged kernel trips it.
  A dispatch past its deadline is abandoned (its thread stays parked, its
  late result is dropped) and the ladder demotes. The first device call
  gets a grace deadline (``max(60 s, 10 × deadline)``).
- **DEGRADED** — the family's host fallback from
  ``models.resolve_fallback``: the native C++ forest/KNN evaluators, or
  the plain torch version on the CPU (SVC, and forest/KNN without g++).
- **BROKEN** — the fallback failed too (or none resolves): the last good
  labels are served and the render carries ``Label State = STALE``. The
  fallback is re-tried every tick.
- **PROBING** — once a probe is due, the device path re-runs on the same
  batch after the tick's fallback labels, and its labels must equal the
  fallback's (from BROKEN a clean in-deadline probe counts alone).
  ``probe_successes`` consecutive clean probes re-promote; a failed probe
  resets the chain and backs off exponentially with full jitter
  (``uniform(0, min(cap, probe_every · 2^level))``).

The ladder is the serving predict callable, marked ``host_native``: it
returns host (numpy) labels, so the serve loops route it through their
host-label read paths (serving/incremental.py host mode,
serving/pipeline.py) and its waiting lands on the pipeline's device-stage
worker. On the no-fault path it returns exactly the kernel's labels.

Every transition and probe goes where the JAX ladder sends it: the
``degrade_transitions`` and ``probe_failures`` counters and the
``degrade_state`` gauge of ``metrics``, the ``degrade.transition`` and
``degrade.probe`` events of ``recorder`` (obs/flight_recorder.py), and a
stderr line per transition. The object keeps its own counters and edge
list too (``status()``, ``transitions``). Fault sites
``degrade.dispatch_stall``, ``degrade.dispatch_error`` and
``degrade.probe`` (utils/faults.py) drive the stall, error and failed
probe edges; the first two are absorbed by the ladder.

**A fault of the card is not absorbed.** On a CUDA tensor only a missed
deadline or an injected fault (``faults.FaultInjected``) moves the ladder:
any other exception from the device predict, a probe or the feature fetch
(a CUDA launch or runtime error, a bug in a kernel wrapper) re-raises and
ends the serve, so a kernel that fails on the card is never hidden behind
host labels. On the CPU (``--device cpu``) the ladder absorbs any device
error, as the JAX ladder does; ``raise_device_errors`` overrides either.
"""

from __future__ import annotations

import contextlib
import random
import sys
import threading
import time

import numpy as np
import torch

from ..utils import faults

HEALTHY = "HEALTHY"
DEGRADED = "DEGRADED"
BROKEN = "BROKEN"
PROBING = "PROBING"

# the degrade_state gauge encoding of the JAX package
STATE_GAUGE = {HEALTHY: 0, DEGRADED: 1, BROKEN: 2, PROBING: 3}


class DeadlineExceeded(RuntimeError):
    """A device-stage dispatch ran past its watchdog deadline."""


def host_array(x) -> np.ndarray:
    """``x`` as a host numpy array: a tensor is copied to the host (for a
    CUDA tensor the copy waits for the work that produces it)."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()  # graftlint: disable=implicit-sync -- watchdog-guarded: every hot caller fetches inside the ladder's deadline-bounded call (or its deadline-0 opt-out, or on the host fallback's labels)
    return np.asarray(x)  # graftlint: disable=implicit-sync -- watchdog-guarded: the same seam for a host value, a no-op conversion


class DeviceWatchdog:
    """Deadline-guarded executor for device-stage dispatches.

    One worker thread runs submitted calls; ``call(fn, deadline)`` waits at
    most ``deadline`` seconds for the result. On expiry the call — and its
    worker, which may be wedged in a dispatch that never returns — is
    abandoned: the next ``call`` starts a fresh worker, and the abandoned
    thread drops its late result. ``call`` is invoked from one thread at a
    time (the serve loop's predict path)."""

    def __init__(self):
        self._lock = threading.Condition()
        self._worker: threading.Thread | None = None
        self._job: tuple[int, object] | None = None
        self._results: dict[int, tuple[str, object]] = {}
        self._seq = 0
        self._abandoned = 0
        self._closed = False

    def call(self, fn, deadline: float | None = None):
        """Run ``fn()`` on the worker; raise ``DeadlineExceeded`` if no
        result lands within ``deadline`` seconds (None = wait forever).
        ``fn``'s own exception re-raises here unchanged."""
        with self._lock:
            if self._closed:
                raise RuntimeError("watchdog is closed")
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._run, name="tcsdn-device-watchdog",
                    daemon=True,
                )
                self._worker.start()
            self._seq += 1
            seq = self._seq
            self._job = (seq, fn)
            self._lock.notify_all()
            t_end = None if deadline is None else time.monotonic() + deadline
            while seq not in self._results:
                left = None if t_end is None else t_end - time.monotonic()
                if left is not None and left <= 0:
                    break
                self._lock.wait(left)
            if seq not in self._results:
                # expired: abandon the (possibly wedged) worker; a job never
                # picked up is retracted
                self._abandoned += 1
                self._worker = None
                if self._job is not None and self._job[0] == seq:
                    self._job = None
                self._lock.notify_all()
                raise DeadlineExceeded(
                    f"device dispatch exceeded its {deadline:.3f}s "
                    f"watchdog deadline"
                )
            kind, value = self._results.pop(seq)
        if kind == "err":
            raise value  # type: ignore[misc]
        return value

    @property
    def abandoned(self) -> int:
        """Dispatches abandoned at their deadline (lifetime)."""
        with self._lock:
            return self._abandoned

    def close(self, timeout: float = 2.0) -> None:
        """Stop the current worker (abandoned ones end on their own)."""
        with self._lock:
            self._closed = True
            worker = self._worker
            self._worker = None
            self._lock.notify_all()
        if worker is not None and worker.is_alive():
            worker.join(timeout)

    def _run(self) -> None:
        me = threading.current_thread()
        while True:
            with self._lock:
                while (self._worker is me and self._job is None
                       and not self._closed):
                    self._lock.wait()
                if self._worker is not me or self._closed:
                    return
                seq, fn = self._job
                self._job = None
            try:
                result = ("ok", fn())  # type: ignore[operator]
            except BaseException as e:  # noqa: BLE001 — re-raised in call()
                result = ("err", e)
            with self._lock:
                if self._worker is not me:
                    return  # abandoned mid-call: drop the late result
                self._results[seq] = result
                self._lock.notify_all()


class DegradeLadder:
    """The health-state machine around the serving predict path: callable
    as ``(params, X) -> labels`` (host numpy labels) and marked
    ``host_native``.

    ``clock`` (monotonic seconds) and ``rng`` (a ``random.Random``) are
    injectable, so tests pin the jittered backoff schedule without
    sleeping; the watchdog deadline itself is real wall-clock time.

    ``raise_device_errors``: None (the default) re-raises a device error
    that is neither injected nor a missed deadline when the predict's
    features lie on a CUDA device, and absorbs it otherwise; True or False
    fixes the choice."""

    host_native = True  # returns host labels: the serve's host read paths

    def __init__(self, device_predict, fallback=None, *,
                 deadline: float = 2.0,
                 first_deadline: float | None = None,
                 probe_every: float = 5.0,
                 probe_successes: int = 3,
                 backoff_cap: float = 300.0,
                 metrics=None, recorder=None,
                 clock=time.monotonic,
                 rng: random.Random | None = None,
                 raise_device_errors: bool | None = None):
        self._device_predict = device_predict
        self.raise_device_errors = raise_device_errors
        self._fallback = fallback
        self.deadline = float(deadline)
        if first_deadline is None:
            # the first device call may carry a kernel build or a first
            # launch: tripping on it would demote every cold start
            first_deadline = (
                max(60.0, 10.0 * self.deadline) if self.deadline > 0 else 0.0
            )
        self.first_deadline = float(first_deadline)
        self.probe_every = float(probe_every)
        self.probe_successes = int(probe_successes)
        self.backoff_cap = float(backoff_cap)
        self._metrics = metrics
        self._recorder = recorder
        self._clock = clock
        self._rng = rng if rng is not None else random.Random()
        self._watchdog = DeviceWatchdog()
        self._lock = threading.Lock()
        self._rung = HEALTHY
        self._label_epoch = 0
        self._probing = False
        self._device_tried = False  # the first attempt's grace is used
        self._fetch_wedged = False  # the last host feature fetch timed out
        self._probe_ok = 0  # consecutive clean probes
        self._backoff_level = 0
        self._next_probe_at = 0.0
        self._last_labels: np.ndarray | None = None
        self._last_stale = False
        # the object's own counts, beside the metrics plane's
        self._probe_failures = 0
        self._device_calls = 0
        self._fallback_calls = 0
        self.transitions: list[tuple[str, str, str]] = []  # (from, to, why)
        if metrics is not None:
            metrics.set("degrade_state", STATE_GAUGE[HEALTHY])

    # -- public surface ----------------------------------------------------
    @property
    def state(self) -> str:
        """PROBING while a promotion chain is in progress (a probe ran
        clean and more are scheduled); between chain probes the serve runs
        on the prior rung."""
        with self._lock:
            return PROBING if self._probing else self._rung

    @property
    def render_stale(self) -> bool:
        """True when the labels last served are last-known-good (BROKEN):
        the render adds the STALE column."""
        with self._lock:
            return self._last_stale

    @property
    def label_epoch(self) -> int:
        """Counter of rung changes: a move means later labels come from
        another evaluator, so the incremental label cache invalidates."""
        with self._lock:
            return self._label_epoch

    def status(self) -> dict:
        """The ladder's self-report: the JAX ``status()`` keys, plus the
        ladder's own counts of what it also writes into ``metrics``."""
        with self._lock:
            state = PROBING if self._probing else self._rung
            return {
                "state": state,
                "rung": self._rung,
                "gauge": STATE_GAUGE[state],
                "probe_successes": self._probe_ok,
                "backoff_level": self._backoff_level,
                "fallback": (
                    self._fallback.kind if self._fallback is not None
                    else None
                ),
                "watchdog_abandoned": self._watchdog.abandoned,
                "probe_failures": self._probe_failures,
                "degrade_transitions": len(self.transitions),
                "device_calls": self._device_calls,
                "fallback_calls": self._fallback_calls,
            }

    def warm_fallback(self, X) -> bool:
        """Prime the fallback rung off the hot path (serving/warmup.py):
        build and page in its evaluator, so the first demoted tick pays
        none of that. True when a rung was primed."""
        fb = self._fallback
        if fb is None:
            return False
        fb.predict(X)
        if fb.scores is not None:
            fb.scores(X)
        return True

    def close(self) -> None:
        self._watchdog.close()

    def _absorbs(self, e: Exception, X) -> bool:
        """Whether device error ``e`` (not a missed deadline) moves the
        ladder rather than ending the serve: an injected fault always; any
        other error only off the card (see the module docstring)."""
        if isinstance(e, faults.FaultInjected):
            return True
        raise_it = self.raise_device_errors
        if raise_it is None:
            raise_it = isinstance(X, torch.Tensor) and X.is_cuda
        return not raise_it

    def __call__(self, params, X):
        if self.state == HEALTHY:
            try:
                labels = self._device_call(params, X)
            except DeadlineExceeded:
                self._trip("deadline")
            except Exception as e:  # noqa: BLE001 — absorbed or re-raised
                if not self._absorbs(e, X):
                    raise
                self._trip(f"error:{type(e).__name__}")
            else:
                self._remember(labels, stale=False)
                return labels
        # The lower rungs work on HOST features, and copying X off the card
        # can itself queue behind a wedged kernel: the fetch runs under the
        # watchdog too. A wedged fetch goes BROKEN (stale labels need no X)
        # and is retried on the probe schedule, not every tick.
        now = self._clock()
        with self._lock:
            skip_fetch = self._fetch_wedged and now < self._next_probe_at
        X_host = None if skip_fetch else self._fetch_host(X)
        if X_host is None:
            if not skip_fetch:
                with self._lock:
                    self._fetch_wedged = True
                    if self._rung != BROKEN:
                        self._set_locked(rung=BROKEN,
                                         reason="feature-fetch-failed")
                    else:
                        self._probe_failed_locked("feature-fetch-failed")
            return self._stale_labels(int(X.shape[0]))
        with self._lock:
            self._fetch_wedged = False
        labels, stale = self._fallback_labels(X_host)
        self._maybe_probe(params, X, None if stale else labels)
        return labels

    def _fetch_host(self, X) -> np.ndarray | None:
        """X as a host array, deadline-guarded; None on a wedge or error."""
        if isinstance(X, np.ndarray):
            return X
        if self.deadline > 0:
            try:
                return self._watchdog.call(lambda: host_array(X),
                                           self.deadline)
            except DeadlineExceeded:
                return None
            except Exception as e:  # noqa: BLE001 — absorbed or re-raised
                if not self._absorbs(e, X):
                    raise
                return None
        try:
            return host_array(X)  # deadline 0: no bound, same seam
        except Exception as e:  # noqa: BLE001
            if not self._absorbs(e, X):
                raise
            return None

    # -- device path -------------------------------------------------------
    def _device_call(self, params, X) -> np.ndarray:
        try:
            faults.fault_point("degrade.dispatch_stall")
        except faults.FaultInjected as e:
            # a test cannot wedge a thread on demand: the site turns into
            # what the watchdog reports at the deadline, minus the wait
            raise DeadlineExceeded(
                "injected dispatch stall (degrade.dispatch_stall)"
            ) from e
        # the watchdog's thread launches on the caller's stream (the
        # pipeline's device stage orders that stream after the dispatch)
        stream = (
            torch.cuda.current_stream(X.device)
            if isinstance(X, torch.Tensor) and X.is_cuda else None
        )

        def run():
            faults.fault_point("degrade.dispatch_error")
            ctx = (torch.cuda.stream(stream) if stream is not None
                   else contextlib.nullcontext())
            with ctx:
                # the labels' copy to the host waits for the kernel: the
                # deadline covers the kernel, not just its launch
                return host_array(self._device_predict(params, X))

        # the grace deadline covers the first ATTEMPT only; a device wedged
        # from boot must not re-pay it on every probe
        with self._lock:
            first = not self._device_tried
            self._device_tried = True
            self._device_calls += 1
        deadline = self.first_deadline if first else self.deadline
        if deadline > 0:
            return self._watchdog.call(run, deadline)
        return run()  # deadline 0: errors only, no watchdog

    def _trip(self, reason: str) -> None:
        with self._lock:
            self._set_locked(rung=DEGRADED, reason=reason)

    # -- fallback / stale rungs --------------------------------------------
    def _fallback_labels(self, X) -> tuple[np.ndarray, bool]:
        """(labels, stale): the fallback's labels, or last-known-good. The
        fallback is re-tried even from BROKEN, so a transient fallback
        failure heals back to DEGRADED."""
        fb = self._fallback
        if fb is not None:
            with self._lock:
                self._fallback_calls += 1
            try:
                labels = host_array(fb.predict(X))
            except Exception as e:  # noqa: BLE001 — any rung may break
                with self._lock:
                    if self._rung != BROKEN:
                        self._set_locked(
                            rung=BROKEN,
                            reason=f"fallback-error:{type(e).__name__}",
                        )
            else:
                with self._lock:
                    if self._rung == BROKEN:
                        self._set_locked(rung=DEGRADED,
                                         reason="fallback-recovered")
                self._remember(labels, stale=False)
                return labels, False
        else:
            with self._lock:
                if self._rung != BROKEN:
                    self._set_locked(rung=BROKEN, reason="no-fallback")
        return self._stale_labels(int(X.shape[0])), True

    def _stale_labels(self, n: int) -> np.ndarray:
        """Last-known-good labels sized to ``n`` rows (zeros before the
        first good predict); marks the render STALE."""
        with self._lock:
            cached = self._last_labels
            self._last_stale = True
        if cached is None:
            return np.zeros(n, np.int32)
        if cached.shape[0] >= n:
            return cached[:n]
        out = np.zeros(n, np.int32)
        out[: cached.shape[0]] = cached
        return out

    def _remember(self, labels, stale: bool) -> None:
        arr = np.asarray(labels)
        with self._lock:
            self._last_labels = arr
            self._last_stale = stale

    # -- probing / promotion -----------------------------------------------
    def _maybe_probe(self, params, X, parity_labels) -> None:
        now = self._clock()
        with self._lock:
            if self._rung == HEALTHY or now < self._next_probe_at:
                return
            self._set_locked(probing=True, reason="probe-due")
        ok, detail = self._run_probe(params, X, parity_labels)
        with self._lock:
            now = self._clock()
            if ok:
                self._probe_ok += 1
                if self._probe_ok >= self.probe_successes:
                    self._backoff_level = 0
                    self._probe_ok = 0
                    self._set_locked(rung=HEALTHY, probing=False,
                                     reason="promoted")
                    delay = None
                else:
                    # clean but the chain is incomplete: the base cadence,
                    # no jitter (nothing failed)
                    delay = self.probe_every
                    self._next_probe_at = now + delay
            else:
                delay = self._probe_failed_locked(detail)
                self._set_locked(probing=False,
                                 reason=f"probe-failed:{detail}")
            successes = self._probe_ok
        if self._recorder is not None:
            self._recorder.record(
                "degrade.probe", ok=ok, detail=detail,
                successes=successes, next_delay_s=delay,
            )

    def _probe_failed_locked(self, detail: str) -> float:
        """Failed-probe bookkeeping (callers hold ``self._lock``): reset the
        chain, count the failure, and return the full-jitter exponential
        delay applied to ``_next_probe_at``."""
        self._probe_failures += 1
        if self._metrics is not None:
            self._metrics.inc("probe_failures")
        self._probe_ok = 0
        self._backoff_level += 1
        window = min(self.backoff_cap,
                     self.probe_every * (2.0 ** self._backoff_level))
        delay = self._rng.uniform(0.0, window)
        self._next_probe_at = self._clock() + delay
        return delay

    def _run_probe(self, params, X, parity_labels) -> tuple[bool, str]:
        """One device probe on the tick's whole batch, the serving shape
        (the JAX ladder's default ``probe_rows=0``); (clean, detail)."""
        try:
            faults.fault_point("degrade.probe")
            got = self._device_call(params, X)
        except faults.FaultInjected:
            return False, "injected"
        except DeadlineExceeded:
            return False, "deadline"
        except Exception as e:  # noqa: BLE001 — absorbed or re-raised
            if not self._absorbs(e, X):
                raise
            return False, f"error:{type(e).__name__}"
        if parity_labels is not None:
            want = np.asarray(parity_labels)[: got.shape[0]]
            if got.shape[0] != want.shape[0] or not np.array_equal(got, want):
                # in time but disagreeing with the live fallback: promoting
                # would swap correct labels for wrong ones
                return False, "parity-mismatch"
        return True, "clean"

    # -- bookkeeping (callers hold self._lock) ------------------------------
    def _set_locked(self, rung: str | None = None,
                    probing: bool | None = None, reason: str = "") -> None:
        old = PROBING if self._probing else self._rung
        old_rung = self._rung
        if rung is not None:
            self._rung = rung
            if rung != old_rung:
                # the label source moved: incremental caches invalidate
                self._label_epoch += 1
            if rung != HEALTHY and old == HEALTHY:
                # entering the ladder: first probe one base interval out
                self._probe_ok = 0
                self._backoff_level = 0
                self._next_probe_at = self._clock() + self.probe_every
        if probing is not None:
            self._probing = probing
        new = PROBING if self._probing else self._rung
        if new == old:
            # a rung change under an active chain (public state stays
            # PROBING) is still an edge: a fallback breaking mid-chain
            # flips the serve to STALE labels
            if self._rung == old_rung:
                return
            old, new = old_rung, self._rung
        self.transitions.append((old, new, reason))
        if self._metrics is not None:
            self._metrics.inc("degrade_transitions")
            self._metrics.set(
                "degrade_state",
                STATE_GAUGE[PROBING if self._probing else self._rung],
            )
        if self._recorder is not None:
            self._recorder.record(
                "degrade.transition", frm=old, to=new, reason=reason
            )
        print(f"DEGRADE: {old} -> {new} ({reason})", file=sys.stderr,
              flush=True)

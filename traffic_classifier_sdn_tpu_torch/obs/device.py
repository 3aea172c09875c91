"""Device-runtime telemetry: device memory gauges, the last-dispatch
age, the donation ledger, and on-demand profiler capture — the port's
counterpart of ``traffic_classifier_sdn_tpu/obs/device.py``.

The rest of the obs plane watches the HOST side of the serve (metrics,
flight recorder, latency provenance). This module is the device half:

- **Memory accounting.** ``sample()`` reads ``torch.cuda.memory_stats``
  of the serve's card each tick into the ``device_memory_bytes`` /
  ``device_memory_peak_bytes`` gauges and a watermark.
  ``device_memory_bytes`` is ``allocated_bytes.all.current``, the bytes
  the caching allocator has handed to live tensors (the counterpart of
  XLA's ``bytes_in_use``); the peak is ``allocated_bytes.all.peak``. A
  CPU serve reports None, as JAX's CPU backend does, and every reading
  degrades gracefully.
- **Compile telemetry: absent.** The JAX plane counts XLA compiles,
  retraces after warmup and persistent-cache hits through
  ``jax.monitoring``. Eager torch compiles no program and has no such
  bus, so the same keys stay in ``status()`` and in ``sample()`` at 0,
  and ``status()`` says ``"compile_telemetry": "absent (eager torch)"``;
  no counter is invented for them. The CUDA kernels build once per
  source hash (ops/cuda_build.py), before the serve starts.
- **Donation ledger.** ``note_donation`` keeps JAX's ledger, but the
  port's stages donate no buffers, so nothing in the port calls it; the
  ``device`` block says so.
- **Listener discipline.** ``_lock`` is a leaf held only for
  bookkeeping; metrics observes and recorder appends happen after
  release (the obs/latency.py idiom).

``ProfilerCapture`` is the on-demand deep view: ``/profile?seconds=N``
on the obs server runs ``torch.profiler.profile`` (CPU activity, plus
CUDA on a card serve) for N seconds and writes a Chrome trace into the
capture directory, under a mutually-exclusive-capture guard — never on
the hot path by default, and a capture failure 500s the endpoint (fault
site ``obs.profiler``), never the serve loop.
"""

from __future__ import annotations

import os
import threading
import time

import torch

from ..utils import faults, profiling

COMPILE_TELEMETRY = "absent (eager torch)"
DONATION_NOTE = "the port's stages donate no buffers; nothing calls note_donation"


def _device_of(device) -> torch.device:
    """The observed device: ``device`` if given, else the current card
    when there is one, else the CPU (whose memory reads as None)."""
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class DeviceTelemetry:
    """Memory/dispatch/donation ledger behind the obs plane.

    Lifecycle: ``attach()`` before warmup, ``mark_warmup_complete()``
    after, ``sample()`` per tick, ``detach()`` in the serve's finally.
    Also a context manager (tests). Byte-transparent: everything lands
    in metrics/recorder/stderr surfaces, never stdout.
    """

    def __init__(self, metrics=None, recorder=None, clock=time.time,
                 device=None):
        self._metrics = metrics
        self._recorder = recorder
        self._clock = clock
        self._lock = threading.Lock()
        self._armed = False
        self._warmed = False
        self._last_dispatch_at: float | None = None
        self._donation: dict[str, list[int]] = {}
        self._mem_last: int | None = None
        self._mem_watermark = 0
        self._requested = device
        self._device: torch.device | None = None
        self._backend = None
        self._platform = None

    # -- lifecycle ----------------------------------------------------------
    def attach(self) -> DeviceTelemetry:
        """Resolve the observed device and its names. Idempotent; returns
        self."""
        with self._lock:
            if self._armed:
                return self
            self._armed = True
        dev = _device_of(self._requested)
        if dev.type == "cuda":
            backend, platform = torch.cuda.get_device_name(dev), "gpu"
        else:
            backend, platform = "cpu", "cpu"
        with self._lock:
            self._device = dev
            self._backend = backend
            self._platform = platform
        return self

    def detach(self) -> None:
        """Disarm. Idempotent — safe from the CLI's finally after any
        failure."""
        with self._lock:
            self._armed = False

    def __enter__(self) -> DeviceTelemetry:
        return self.attach()

    def __exit__(self, *exc) -> bool:
        self.detach()
        return False

    # -- serve-loop hooks ----------------------------------------------------
    def mark_warmup_complete(self) -> None:
        """The serve is warm: recorded with the (absent, so 0) compile
        count the JAX plane reports here."""
        with self._lock:
            self._warmed = True
        if self._recorder is not None:
            self._recorder.record(
                "device.warmup_complete", jit_compiles=0, jit_compile_s=0.0,
            )

    def mark_dispatch(self) -> None:
        """The serve loop dispatched device work this tick — feeds the
        /healthz last-dispatch age (a wedged device shows a growing age
        while host ticks keep beating)."""
        with self._lock:
            self._last_dispatch_at = self._clock()

    def note_donation(self, stage: str, reused: bool) -> None:
        """One donation outcome from a double-buffered stage: the donated
        input's storage was (or was not) observed reused by the output."""
        with self._lock:
            ent = self._donation.setdefault(stage, [0, 0])
            ent[0] += 1
            if reused:
                ent[1] += 1
        m = self._metrics
        if m is not None:
            m.inc(f"donation_expected_{stage}")
            if reused:
                m.inc(f"donation_reused_{stage}")

    def _memory(self) -> tuple[int | None, int | None]:
        dev = self._device
        if dev is None or dev.type != "cuda":
            return None, None
        stats = torch.cuda.memory_stats(dev)
        return (stats.get("allocated_bytes.all.current"),
                stats.get("allocated_bytes.all.peak"))

    def sample(self) -> dict:
        """Per-tick poll: refresh the memory gauges (None off a card) and
        return the compact dict the perf recorder persists."""
        in_use, peak = self._memory()
        with self._lock:
            if in_use is not None:
                self._mem_watermark = max(self._mem_watermark, int(in_use))
            self._mem_last = in_use
            watermark = self._mem_watermark
        m = self._metrics
        if m is not None and in_use is not None:
            m.set("device_memory_bytes", in_use)
            m.set("device_memory_peak_bytes",
                  peak if peak is not None else watermark)
        return {
            "jit_compiles": 0,
            "retraces_after_warmup": 0,
            "hbm_bytes": in_use,
        }

    # -- read ---------------------------------------------------------------
    def status(self) -> dict:
        """The /healthz ``device`` block: JAX's keys (the compile ones at
        0) plus the memory readings under the port's names."""
        now = self._clock()
        with self._lock:
            last_dispatch = self._last_dispatch_at
            return {
                "armed": self._armed,
                "backend": self._backend,
                "platform": self._platform,
                "compile_telemetry": COMPILE_TELEMETRY,
                "jit_compiles": 0,
                "jit_compile_s_total": 0.0,
                "compilation_cache_hits": 0,
                "compilation_cache_misses": 0,
                "warmup_complete": self._warmed,
                "retraces_after_warmup": 0,
                "last_compile_program": None,
                "device_memory_bytes": self._mem_last,
                "hbm_bytes": self._mem_last,
                "hbm_watermark_bytes": self._mem_watermark or None,
                "last_dispatch_age_s": (
                    None if last_dispatch is None
                    else round(now - last_dispatch, 6)
                ),
                "donation": {
                    stage: {"expected": e, "reused": r}
                    for stage, (e, r) in sorted(self._donation.items())
                },
                "donation_note": DONATION_NOTE,
            }


class ProfilerBusy(RuntimeError):
    """A capture is already in progress (the endpoint's 409)."""


class ProfilerCapture:
    """On-demand ``torch.profiler`` trace capture into one directory.

    ``status()["tracing"]`` is true while the profiler runs (``active``
    also covers its start and the trace's export). Mutually exclusive: a second ``capture`` while one runs raises
    ``ProfilerBusy`` immediately (the guard is a flag flipped under the
    leaf lock; the sleep happens outside it). The profiler is a ``with``
    block, so a failed capture tears it down and the next request finds
    it free. Failures count and re-raise — the /profile endpoint turns
    them into a 500, the serve loop never sees them (fault site
    ``obs.profiler``).
    """

    MAX_SECONDS = 600.0

    def __init__(self, directory: str, metrics=None, recorder=None,
                 device=None):
        self.directory = os.path.abspath(directory)
        self._metrics = metrics
        self._recorder = recorder
        self._cuda = _device_of(device).type == "cuda"
        self._lock = threading.Lock()
        self._active = False
        self._tracing = False
        self._captures = 0
        self._failures = 0

    def capture(self, seconds: float) -> dict:
        seconds = float(seconds)
        if not 0.0 < seconds <= self.MAX_SECONDS:
            raise ValueError(
                f"seconds must be in (0, {self.MAX_SECONDS:g}], got {seconds}"
            )
        with self._lock:
            if self._active:
                raise ProfilerBusy("a profiler capture is already running")
            self._active = True
        t0 = time.perf_counter()
        try:
            faults.fault_point("obs.profiler")
            with profiling.trace(self.directory,
                                 "cuda" if self._cuda else "cpu") as info:
                with self._lock:
                    self._tracing = True
                try:
                    time.sleep(seconds)
                finally:
                    with self._lock:
                        self._tracing = False
            path = info["path"]
        except Exception as e:
            with self._lock:
                self._failures += 1
                self._active = False
            if self._metrics is not None:
                self._metrics.inc("profiler_capture_failures")
            if self._recorder is not None:
                self._recorder.record("device.profile_failed", error=str(e))
            raise
        wall = time.perf_counter() - t0
        with self._lock:
            self._captures += 1
            self._active = False
        if self._metrics is not None:
            self._metrics.inc("profiler_captures")
        if self._recorder is not None:
            self._recorder.record("device.profile", seconds=seconds,
                                  wall_s=round(wall, 6), trace=path)
        return {
            "directory": self.directory,
            "seconds": seconds,
            "wall_s": round(wall, 6),
            "trace": path,
        }

    def status(self) -> dict:
        with self._lock:
            return {
                "directory": self.directory,
                "active": self._active,
                "tracing": self._tracing,
                "captures": self._captures,
                "failures": self._failures,
            }

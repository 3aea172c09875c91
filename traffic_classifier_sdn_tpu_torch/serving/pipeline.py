"""Bounded two-deep software pipeline for the serve loop — the port of
``traffic_classifier_sdn_tpu/serving/pipeline.py``.

Two stages over one bounded handoff:

- the **host stage** (the serve loop's thread) polls telemetry, parses it,
  scatters it into the device flow table, and *dispatches* each render
  tick's read side (``dispatch_read``): torch launches return before the
  kernels run, so the host does not wait for the device;
- the **device stage** (one worker thread) waits for the dispatched read,
  turns the O(rows) results into host tuples, and renders. Under the
  degrade ladder (a ``host_native`` predict that returns host labels) the
  worker runs the ladder itself, so its deadline-guarded wait for the
  kernel lands here, overlapped with the next tick's ingest.

The stages share the card through CUDA streams. ``dispatch_read`` records
an event on the host stage's stream after everything the read needs; the
worker's launches and copies run on a stream of its own that first waits
on that event (``Fence``), and each tensor the worker touches is marked
for that stream (``record_stream``), so the caching allocator does not
hand its memory to a later tick while the worker still reads it. A
dispatched read holds only tensors that no later tick writes: the table
update is functional (new tensors each tick), the ranked outputs are
fresh gathers, and a device label cache, which the next plan merges into
in place, is copied at dispatch.

Backpressure: the handoff holds at most ``depth`` staged renders. When the
device stage falls behind, a new render *coalesces* into the newest
staged one: the older frame is never printed (``ticks_coalesced``), but
its label commit still runs, in order (``coalesce_renders``), so a host
label cache never misses a plan's rows. With the device stage keeping up,
the pipelined loop prints what the serial loop prints: the read side of
tick N is dispatched at tick N, ``n_flows`` is taken at dispatch, and idle
eviction waits for renders in flight (a released slot's metadata must
outlive its render).

Fault sites ``pipeline.handoff`` and ``pipeline.coalesce``
(utils/faults.py) sit on the handoff.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from collections.abc import Callable

import numpy as np
import torch

from ..core import flow_table as ft
from ..utils import faults


class Handoff:
    """The bounded staging handoff between the two stages: at most
    ``depth`` slots under one condition variable.

    ``put`` never blocks and never grows past ``depth``: when full, the new
    item coalesces into the newest staged slot (``merge(staged, new)``,
    default: replace) and the coalesce counter advances. ``get``/``done``
    are the consumer half; ``join`` waits for empty-and-idle."""

    def __init__(self, depth: int = 2, merge: Callable | None = None):
        if depth < 1:
            raise ValueError("handoff depth must be >= 1")
        self.depth = depth
        self._merge = merge
        self._lock = threading.Condition()
        self._slots: deque = deque()
        self._inflight = 0
        self._coalesced = 0
        self._closed = False

    def put(self, item) -> bool:
        """Stage one item; True if queued, False if it coalesced into the
        newest staged slot (backpressure)."""
        with self._lock:
            faults.fault_point("pipeline.handoff")
            if self._closed:
                raise RuntimeError("handoff is closed")
            if len(self._slots) < self.depth:
                self._slots.append(item)
                self._lock.notify_all()
                return True
            faults.fault_point("pipeline.coalesce")
            staged = self._slots[-1]
            self._slots[-1] = (
                self._merge(staged, item) if self._merge is not None
                else item
            )
            self._coalesced += 1
            return False

    def get(self, timeout: float | None = None):
        """Next staged item (oldest first), blocking up to ``timeout``;
        None on timeout or when closed with nothing staged."""
        with self._lock:
            while not self._slots and not self._closed:
                if not self._lock.wait(timeout):
                    return None
            if not self._slots:
                return None  # closed and drained
            item = self._slots.popleft()
            self._inflight += 1
            self._lock.notify_all()
            return item

    def done(self) -> None:
        """Consumer: the last ``get`` item is fully processed."""
        with self._lock:
            if self._inflight > 0:
                self._inflight -= 1
            self._lock.notify_all()

    def join(self, timeout: float | None = None) -> bool:
        """Wait until nothing is staged or in flight; False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while self._slots or self._inflight:
                if deadline is None:
                    self._lock.wait()
                    continue
                left = deadline - time.monotonic()
                if left <= 0 or not self._lock.wait(left):
                    return False
            return True

    def close(self) -> None:
        """No further puts; staged items still drain through ``get``."""
        with self._lock:
            self._closed = True
            self._lock.notify_all()

    def abort(self) -> None:
        """Drop everything and close: the device stage died, or the host is
        leaving on an exception; ``join`` must not hang."""
        with self._lock:
            self._slots.clear()
            self._inflight = 0
            self._closed = True
            self._lock.notify_all()

    @property
    def queued(self) -> int:
        with self._lock:
            return len(self._slots)

    @property
    def coalesced(self) -> int:
        with self._lock:
            return self._coalesced

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    @property
    def idle(self) -> bool:
        with self._lock:
            return not self._slots and not self._inflight


class _HostBusy:
    """Context manager marking one host-stage busy interval (the overlap
    accounting's producer half)."""

    __slots__ = ("_pipe", "_t0")

    def __init__(self, pipe: "ServePipeline"):
        self._pipe = pipe

    def __enter__(self):
        self._t0 = self._pipe._clock()
        with self._pipe._lock:
            self._pipe._host_open = self._t0
        return self

    def __exit__(self, *exc) -> bool:
        t1 = self._pipe._clock()
        with self._pipe._lock:
            self._pipe._host_iv.append((self._t0, t1))
            self._pipe._host_busy_s += t1 - self._t0
            self._pipe._host_open = None
        return False


class ServePipeline:
    """A ``Handoff`` plus one device-stage worker running ``consume(item)``
    per staged item, with the worker's exception re-raised on the host
    stage (at the next ``submit``/``drain``/``raise_if_failed``) and
    host/device busy and overlap accounting (``stats``). ``metrics`` (a
    ``utils.metrics.Metrics``) receives the JAX pipeline's series: the
    ``queue_depth`` gauge, ``ticks_coalesced`` and ``stage_overlap_s``."""

    def __init__(self, consume: Callable, *, depth: int = 2,
                 metrics=None, merge: Callable | None = None):
        self._consume = consume
        self._metrics = metrics
        self._clock = time.perf_counter
        self._handoff = Handoff(depth=depth, merge=merge)
        self._lock = threading.Lock()
        self._exc: BaseException | None = None
        # recent host busy intervals (bounded): each device job intersects
        # its busy window with them to measure the overlap
        self._host_iv: deque = deque(maxlen=256)
        self._host_open: float | None = None
        self._host_busy_s = 0.0
        self._device_busy_s = 0.0
        self._overlap_s = 0.0
        self._thread = threading.Thread(
            target=self._run, name="tcsdn-device-stage", daemon=True
        )

    # -- host stage --------------------------------------------------------
    def start(self) -> "ServePipeline":
        self._thread.start()
        return self

    def host_stage(self) -> _HostBusy:
        return _HostBusy(self)

    def submit(self, item) -> bool:
        """Stage one device-stage job; True if queued, False if it
        coalesced. Raises the device stage's exception if it died."""
        self.raise_if_failed()
        try:
            queued = self._handoff.put(item)
        except RuntimeError:
            # closed under us: the device stage died between checks
            self.raise_if_failed()
            raise
        if self._metrics is not None:
            self._metrics.set("queue_depth", self._handoff.queued)
            if not queued:
                self._metrics.inc("ticks_coalesced")
        return queued

    def raise_if_failed(self) -> None:
        with self._lock:
            exc = self._exc
        if exc is not None:
            raise exc

    def failed(self) -> bool:
        with self._lock:
            return self._exc is not None

    def idle(self) -> bool:
        """Nothing staged and nothing in flight."""
        return self._handoff.idle

    def drain(self, timeout: float | None = None) -> bool:
        """Wait for every staged job to finish; re-raise a device-stage
        failure. False on timeout."""
        ok = self._handoff.join(timeout)
        self.raise_if_failed()
        return ok

    def shutdown(self, drain: bool = True, timeout: float = 10.0) -> None:
        """Stop the device stage: ``drain=True`` lets staged jobs finish,
        ``drain=False`` drops them. Never raises."""
        if drain and not self.failed():
            self._handoff.join(timeout)
            self._handoff.close()
        else:
            self._handoff.abort()
        if self._thread.is_alive():
            self._thread.join(timeout)

    def stats(self) -> dict:
        with self._lock:
            host_busy = self._host_busy_s
            device_busy = self._device_busy_s
            overlap = self._overlap_s
        return {
            "host_busy_s": host_busy,
            "device_busy_s": device_busy,
            "overlap_s": overlap,
            "ticks_coalesced": self._handoff.coalesced,
        }

    # -- device stage ------------------------------------------------------
    def _run(self) -> None:
        while True:
            item = self._handoff.get(timeout=0.2)
            if item is None:
                if self._handoff.closed:
                    return
                continue
            t0 = self._clock()
            try:
                self._consume(item)
            except BaseException as e:  # noqa: BLE001 — re-raised on the host
                with self._lock:
                    self._exc = e
                self._handoff.done()
                self._handoff.abort()
                return
            self._handoff.done()
            self._account(t0, self._clock())

    def _account(self, t0: float, t1: float) -> None:
        overlap = 0.0
        with self._lock:
            self._device_busy_s += t1 - t0
            for a, b in self._host_iv:
                lo, hi = max(a, t0), min(b, t1)
                if hi > lo:
                    overlap += hi - lo
            if self._host_open is not None and t1 > self._host_open:
                # the host stage is busy right now: its open interval
                # counts too
                lo = max(self._host_open, t0)
                if t1 > lo:
                    overlap += t1 - lo
            self._overlap_s += overlap
        if self._metrics is not None:
            self._metrics.observe("stage_overlap_s", overlap)
            self._metrics.set("queue_depth", self._handoff.queued)


# ---------------------------------------------------------------------------
# Render jobs and coalescing
# ---------------------------------------------------------------------------


class RenderJob:
    """One staged render: the dispatched ``read`` and ``render(read)``,
    which prints its frame on the device stage."""

    __slots__ = ("read", "_render")

    def __init__(self, read, render: Callable):
        self.read = read
        self._render = render

    def commit(self) -> None:
        self.read.commit()

    def __call__(self) -> None:
        self._render(self.read)


class _Superseded:
    """A staged render that a newer one coalesced into: the older frame is
    not printed, but its label commit runs first, in dispatch order."""

    __slots__ = ("_first", "_then")

    def __init__(self, first, then):
        self._first = first
        self._then = then

    def commit(self) -> None:
        self._first.commit()
        self._then.commit()

    def __call__(self) -> None:
        self._first.commit()
        self._then()


def coalesce_renders(staged, new):
    """``Handoff`` merge for render jobs: the new frame replaces the staged
    one, whose commit still runs."""
    return _Superseded(staged, new)


# ---------------------------------------------------------------------------
# Cross-stream ordering
# ---------------------------------------------------------------------------

_STAGE_STREAMS: dict = {}


def device_stage_stream(device: torch.device):
    """The device stage's own CUDA stream on ``device`` (one per process)."""
    s = _STAGE_STREAMS.get(device.index)
    if s is None:
        s = _STAGE_STREAMS[device.index] = torch.cuda.Stream(device)
    return s


class Fence:
    """What orders the device stage's work after the host stage's dispatch:
    an event recorded on the host stage's stream at dispatch, and the
    tensors the worker will read. ``enter()`` (on the worker) makes the
    device stage's stream wait on the event, marks the tensors as used on
    it, and makes it the current stream. On the CPU it does nothing."""

    __slots__ = ("_device", "_event", "_tensors")

    def __init__(self, device: torch.device, tensors=()):
        self._device = torch.device(device)
        self._tensors = [t for t in tensors if isinstance(t, torch.Tensor)]
        self._event = None
        if self._device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(self._device))

    def enter(self):
        if self._event is None:
            return contextlib.nullcontext()
        stream = device_stage_stream(self._device)
        stream.wait_event(self._event)
        for t in self._tensors:
            t.record_stream(stream)
        return torch.cuda.stream(stream)


# ---------------------------------------------------------------------------
# Dispatched read sides (host stage dispatches, device stage waits)
# ---------------------------------------------------------------------------


def _host(tensors) -> list[np.ndarray]:
    return [t.cpu().numpy() for t in tensors]


class RankedRead:
    """The ranked read of tick N, dispatched: the device outputs of
    ``top_active_render`` and the dispatch-time flow count. ``rows()``
    (device stage) waits and builds the ``(slot, label, fwd_active,
    rev_active)`` list — ``FlowStateEngine.render_sample``'s output."""

    __slots__ = ("_outs", "_fence", "n_flows")

    def __init__(self, outs, n_flows: int, fence: Fence):
        self._outs = outs
        self._fence = fence
        self.n_flows = n_flows

    def commit(self) -> None:
        """Nothing to commit: the labels were queued at dispatch."""

    def rows(self) -> list[tuple]:
        with self._fence.enter():
            idx, valid, lab, fa, ra = _host(self._outs)
        return [
            (int(s), int(c), bool(f), bool(r))
            for s, v, c, f, r in zip(idx, valid, lab, fa, ra)
            if v
        ]


class NativeRankedRead:
    """The ranked read for a ``host_native`` predict (the degrade ladder)
    without incremental labels: the worker runs the predict on the
    dispatch-time feature matrix and joins its host labels with the
    ranked flags dispatched at tick N."""

    __slots__ = ("_X", "_flags", "_predict", "_params", "_fence", "n_flows")

    def __init__(self, X, flags, predict, params, n_flows: int,
                 fence: Fence):
        self._X = X
        self._flags = flags
        self._predict = predict
        self._params = params
        self._fence = fence
        self.n_flows = n_flows

    def commit(self) -> None:
        """Nothing to commit: a full-table predict keeps no state."""

    def rows(self) -> list[tuple]:
        with self._fence.enter():
            labels = np.asarray(self._predict(self._params, self._X))
            idx, valid, fa, ra = _host(self._flags)
        return [
            (int(s), int(labels[int(s)]), bool(f), bool(r))
            for s, v, f, r in zip(idx, valid, fa, ra)
            if v
        ]


class ShardedRead:
    """The read of tick N on the sharded spine (parallel/table_sharded.py):
    the engine's dispatched ``Gathered`` per-shard candidates, or the rows
    already merged on the host stage (an eviction tick), and the
    dispatch-time flow count. ``rows()`` (device stage) waits for the
    gather, whose fences order it after the dispatch, and merges."""

    __slots__ = ("_engine", "_outs", "_rows", "n_flows")

    def __init__(self, engine, outs, n_flows: int, rows=None):
        self._engine = engine
        self._outs = outs
        self._rows = rows
        self.n_flows = n_flows

    def commit(self) -> None:
        """Nothing to commit: the label caches merged at dispatch."""

    def rows(self) -> list[tuple]:
        if self._rows is None:
            self._rows = self._engine.tick_read_finish(self._outs)
        return self._rows


class FullRead:
    """The unbounded (``--table-rows 0``) read: the whole label vector (or,
    for a ``host_native`` predict, the features it runs on), the
    per-direction active flags, and a dispatch-time snapshot of the
    slot → (src, dst) metadata."""

    __slots__ = ("_X", "_labels", "_fa", "_ra", "_meta", "_predict",
                 "_params", "_fence", "n_flows")

    def __init__(self, X, labels, fa, ra, meta, predict, params,
                 n_flows: int, fence: Fence):
        self._X = X
        self._labels = labels
        self._fa = fa
        self._ra = ra
        self._meta = meta
        self._predict = predict
        self._params = params
        self._fence = fence
        self.n_flows = n_flows

    def commit(self) -> None:
        """Nothing to commit: a full-table predict keeps no state."""

    def rows(self) -> list[tuple]:
        with self._fence.enter():
            labels = (self._predict(self._params, self._X)
                      if self._labels is None else self._labels)
            if isinstance(labels, torch.Tensor):
                labels = labels.cpu().numpy()
            fa, ra = _host((self._fa, self._ra))
        return [
            (slot, src, dst, int(labels[slot]), bool(fa[slot]),
             bool(ra[slot]))
            for slot, (src, dst) in sorted(self._meta.items())
        ]


def dispatch_read(engine, predict, params, table_rows: int, inc=None):
    """Dispatch one render tick's read side against the engine's CURRENT
    (tick-N) table and return the read object the device stage finishes
    (host stage).

    Everything the device stage touches is a tensor no later tick writes
    (fixed at dispatch, ordered by the read's ``Fence``) or a host value
    taken here (``n_flows``, the full read's metadata). The ranked reads
    resolve slot metadata on the device stage, per slot: safe because
    ranked slots are in use at tick N and the serve loop defers eviction
    while renders are in flight.

    ``inc`` (serving/incremental.IncrementalLabels) replaces the
    full-table predict with the label cache: in device mode the cache is
    read through ``RankedRead`` (gathered on the device); in host mode
    (the degrade ladder) through the incremental read objects, so the
    ladder's predict runs on the device-stage worker."""
    host_native = getattr(predict, "host_native", False)
    floor = engine.tick_floor
    n_flows = engine.num_flows()
    table = engine.table
    device = table.in_use.device
    if table_rows > 0:
        n = min(table_rows, table.capacity)
        if inc is not None:
            if inc.host_native:
                from .incremental import IncRankedRead

                pending = inc.dispatch()
                flags = ft.top_active_flags(table, n, floor)
                fence = Fence(device, (pending.X, pending.idx, *flags))
                return IncRankedRead(inc, pending, flags, n_flows, fence)
            labels = inc.labels()  # queued; the cache stays on the device
            outs = ft.top_active_render(table, labels, n, floor)
            return RankedRead(outs, n_flows, Fence(device, outs))
        if host_native:
            X = engine.features()
            flags = ft.top_active_flags(table, n, floor)
            return NativeRankedRead(X, flags, predict, params, n_flows,
                                    Fence(device, (X, *flags)))
        labels = predict(params, engine.features())
        outs = ft.top_active_render(table, labels, n, floor)
        return RankedRead(outs, n_flows, Fence(device, outs))
    fa = table.fwd.active[:-1]
    ra = table.rev.active[:-1]
    meta = dict(engine.slot_metadata())
    if inc is not None:
        from .incremental import IncFullRead

        pending = inc.dispatch()
        # device mode: copy the cache, which the next plan merges into
        labels = None if inc.host_native else inc.finish(pending).clone()
        return IncFullRead(inc, pending, labels, fa, ra, meta, n_flows,
                           Fence(device, (pending.X, pending.idx, labels,
                                          fa, ra)))
    X = engine.features()
    labels = None if host_native else predict(params, X)
    return FullRead(X, labels, fa, ra, meta, predict, params, n_flows,
                    Fence(device, (X, labels, fa, ra)))

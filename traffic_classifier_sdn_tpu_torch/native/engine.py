"""ctypes bindings of the port's native (C++) ingest engine.

The port's counterpart of ``traffic_classifier_sdn_tpu/native/engine.py``.
``NativeBatcher`` stands in for the pure-Python ``FlowIndex`` + ``Batcher``
pair of ingest/batcher.py: raw monitor bytes in, packed wire batches (or
padded ``flow_table.UpdateBatch``es) out. The Python pair stays the
behavioral oracle (tests/test_torch_native_engine.py holds the two to the
same wire and table state); this path exists because line splitting and
dict routing are the host's hot loop once the counter math lives on the
device.

The library is built from this package's ``flow_engine.cpp`` with g++ on
first use, into ``csrc/build/`` (``loader.LazyLib``). ``available()``
reports whether a build is possible, so callers can fall back to the
Python batcher.
"""

from __future__ import annotations

import ctypes as ct
import threading
from pathlib import Path

import numpy as np

from ..core import flow_table as ft
from ..ingest.protocol import TelemetryRecord, format_line
from ..utils.faults import FaultInjected, fault_point
from .loader import LazyLib

SOURCE = Path(__file__).resolve().parent / "flow_engine.cpp"
_lazy = LazyLib(SOURCE, "native flow engine", flags=("-O3", "-pthread"))
_lock = threading.Lock()
_lib = None

# name → (restype, argtypes) of every function the bindings call
_VP, _U32, _U64 = ct.c_void_p, ct.c_uint32, ct.c_uint64
_SIGNATURES = {
    "tc_engine_create": (_VP, [_U32, _U32]),
    "tc_engine_destroy": (None, [_VP]),
    "tck_feed_lines": (_U64, [_VP, ct.c_char_p, _U64, _U32]),
    "tck_flush_wire": (_U64, [_VP, _VP, _VP, _U32, _U32]),
    "tck_reset_tail": (None, [_VP, _U32]),
    "tck_slots_for_source": (_U32, [_VP, _U32, _VP]),
    "tck_parse_errors_total": (_U64, [_VP]),
    "tck_parse_errors": (_U64, [_VP, _U32]),
    "tck_source_parsed": (_U64, [_VP, _U32]),
    "tc_engine_pending": (_U64, [_VP]),
    "tc_engine_flush": (_U32, [_VP] + [_VP] * 8),
    "tc_engine_dropped": (_U64, [_VP]),
    "tc_engine_parsed": (_U64, [_VP]),
    "tc_engine_last_time": (ct.c_int32, [_VP]),
    "tc_engine_num_flows": (_U32, [_VP]),
    "tc_engine_slot_meta": (ct.c_int, [_VP, _U32, ct.c_char_p, ct.c_char_p,
                                       _U32]),
    "tc_engine_release_slots": (None, [_VP, _VP, _U32]),
}


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = _lazy.load()
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return lib


def library_path() -> Path:
    """Where the engine's library is (or will be) built."""
    return _lazy.path


def build() -> Path:
    """Build the engine's library if it is missing, load it, and return
    its path. Raises RuntimeError with g++'s output when it cannot."""
    _load()
    return library_path()


def available() -> bool:
    """True when the native engine can be built and loaded on this host.

    The ``native.load`` fault site simulates a build or ``dlopen`` failure
    here, uncached, so one injected outage does not poison later calls."""
    try:
        fault_point("native.load")
        _load()
        return True
    except (RuntimeError, FaultInjected):
        return False


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ct.c_void_p)


class NativeBatcher:
    """Raw telemetry bytes → packed wire batches, all routing in C++.

    API-compatible with the batcher.FlowIndex + batcher.Batcher pair where
    FlowStateEngine touches them (add/dropped/release_slots/slot_meta),
    plus the bulk ``feed(bytes)`` path the Python pair lacks.
    ``pin`` page-locks the wire staging (an engine whose table is on a
    card)."""

    def __init__(self, capacity: int, buckets=None, pin: bool = False):
        from ..ingest.batcher import DEFAULT_BUCKETS

        if buckets is None:
            buckets = DEFAULT_BUCKETS
        lib = _load()
        self._lib = lib
        self.capacity = capacity
        self.buckets = tuple(buckets)
        self._max = self.buckets[-1]
        self._h = lib.tc_engine_create(capacity, self._max)
        if not self._h:
            raise RuntimeError(
                "tc_engine_create failed (capacity must be 1..2^30-1 — "
                "the wire layout packs slot|flags in 32 bits, the same "
                "bound pack_wire enforces — and max_batch nonzero)"
            )
        # reused flush() buffers: C fills the first n rows
        m = self._max
        self._slot = np.empty(m, np.int32)
        self._time = np.empty(m, np.int32)
        self._pkts_lo = np.empty(m, np.uint32)
        self._pkts_f = np.empty(m, np.float32)
        self._bytes_lo = np.empty(m, np.uint32)
        self._bytes_f = np.empty(m, np.float32)
        self._is_fwd = np.empty(m, np.uint8)
        self._is_create = np.empty(m, np.uint8)
        # double-buffered wire staging (flush_wire): C++ writes the packed
        # (B, 4|6) uint32 matrix straight into these pages
        self._wire_stage = ft.WireStage(self._max, pin=pin)
        self._buckets_u32 = np.asarray(self.buckets, np.uint32)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.tc_engine_destroy(h)
            self._h = None

    # -- ingest ------------------------------------------------------------
    def feed(self, data: bytes, source: int = 0) -> int:
        """Bulk byte ingest: one ``tck_feed_lines`` call per poll batch,
        routed entirely in C++ under ``source``'s flow-table namespace (0
        is the default namespace). Returns records parsed.

        Fault site ``ingest.native_parse`` (absorbed): a fire turns the
        batch's lead line into a malformed one, counted against this
        source like any real malformed line; the rest of the batch parses
        normally. The line is substituted, not deleted, so a partial line
        carried from the previous chunk ends at an unparseable boundary
        instead of splicing onto the next line; a chunk with no newline
        gets a bogus ``\\t\\xff`` field spliced in, which breaks the exact
        9-column rule wherever the spanning line's pieces land."""
        try:
            fault_point("ingest.native_parse")
        except FaultInjected:
            nl = data.find(b"\n")
            if nl >= 0:
                data = b"data\t\xff\n" + data[nl + 1:]
            else:
                data = data[:4] + b"\t\xff" + data[4:]
        return int(
            self._lib.tck_feed_lines(self._h, data, len(data), source)
        )

    def add(self, r: TelemetryRecord) -> bool:
        """Record-object path (the replay and synthetic sources). The
        record's ``source`` selects the namespace: the wire format itself
        has no source field."""
        self.feed(format_line(r), r.source)
        return True

    def __len__(self) -> int:
        return int(self._lib.tc_engine_pending(self._h))

    # -- flush -------------------------------------------------------------
    def flush(self) -> ft.UpdateBatch | None:
        """Pop the oldest pending generation as a padded UpdateBatch (None
        when idle) — the contract of batcher.Batcher.flush."""
        n = int(
            self._lib.tc_engine_flush(
                self._h, _ptr(self._slot), _ptr(self._time),
                _ptr(self._pkts_lo), _ptr(self._pkts_f),
                _ptr(self._bytes_lo), _ptr(self._bytes_f),
                _ptr(self._is_fwd), _ptr(self._is_create),
            )
        )
        if n == 0:
            return None
        size = next(b for b in self.buckets if n <= b)

        def padded(src, fill, dtype):
            out = np.full(size, fill, dtype)
            out[:n] = src[:n]
            return out

        return ft.UpdateBatch(
            slot=padded(self._slot, self.capacity, np.int32),  # scratch row
            time=padded(self._time, 0, np.int32),
            pkts_lo=padded(self._pkts_lo, 0, np.uint32),
            pkts_f=padded(self._pkts_f, 0, np.float32),
            bytes_lo=padded(self._bytes_lo, 0, np.uint32),
            bytes_f=padded(self._bytes_f, 0, np.float32),
            is_fwd=padded(self._is_fwd, 1, bool),
            is_create=padded(self._is_create, 0, bool),
        )

    def flush_wire(self) -> np.ndarray | None:
        """Pop the oldest pending generation directly as a packed wire
        matrix (``flow_table.pack_wire`` layout): C++ writes the padded
        (B, 4|6) uint32 rows into this batcher's staging, and the returned
        view goes straight to the device scatter. None when idle. The
        staging is double-buffered, so the previous flush's view stays
        intact while its copy may be in flight."""
        buf = self._wire_stage.buffer()
        r = int(
            self._lib.tck_flush_wire(
                self._h, _ptr(buf), _ptr(self._buckets_u32),
                len(self._buckets_u32), self.capacity,
            )
        )
        if r == 0:
            return None
        return self._wire_stage.view(r & 0xFFFFFFFF, r >> 32)

    # -- bookkeeping -------------------------------------------------------
    @property
    def dropped(self) -> int:
        return int(self._lib.tc_engine_dropped(self._h))

    @property
    def parsed(self) -> int:
        return int(self._lib.tc_engine_parsed(self._h))

    @property
    def last_time(self) -> int:
        """Max telemetry timestamp parsed — the idle-eviction clock."""
        return int(self._lib.tc_engine_last_time(self._h))

    def num_flows(self) -> int:
        return int(self._lib.tc_engine_num_flows(self._h))

    def slot_meta(self, slot: int) -> tuple[str, str] | None:
        """(eth_src, eth_dst) of an in-use slot, for the UI table."""
        src = ct.create_string_buffer(64)
        dst = ct.create_string_buffer(64)
        if self._lib.tc_engine_slot_meta(self._h, slot, src, dst, 64):
            # the parser rejects non-UTF-8 fields, so this never replaces
            return (
                src.value.decode(errors="replace"),
                dst.value.decode(errors="replace"),
            )
        return None

    def reset_tail(self, source: int) -> None:
        """Drop ``source``'s carried partial line."""
        self._lib.tck_reset_tail(self._h, source)

    def slots_for_source(self, source: int) -> np.ndarray:
        """Every live slot in ``source``'s namespace, ascending (one
        ctypes crossing; an O(capacity) scan)."""
        out = np.empty(self.capacity, np.uint32)
        n = int(self._lib.tck_slots_for_source(self._h, source, _ptr(out)))
        return out[:n].copy()

    def parse_errors(self, source: int | None = None) -> int:
        """Malformed telemetry lines ('data'-prefixed, invalid body)
        counted and skipped — in total, or of one source."""
        if source is None:
            return int(self._lib.tck_parse_errors_total(self._h))
        return int(self._lib.tck_parse_errors(self._h, source))

    def source_parsed(self, source: int) -> int:
        """Records parsed under ``source``'s namespace."""
        return int(self._lib.tck_source_parsed(self._h, source))

    def release_slots(self, slots) -> None:
        """Bulk release: one ctypes crossing for the whole batch."""
        a = np.ascontiguousarray(slots, np.uint32)
        self._lib.tc_engine_release_slots(self._h, _ptr(a), a.size)

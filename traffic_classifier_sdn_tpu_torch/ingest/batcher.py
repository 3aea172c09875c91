"""Host-side control plane: slot assignment, direction folding, and padded
update batches for the device flow table — the port of
``traffic_classifier_sdn_tpu/ingest/batcher.py``.

The host only decides *where* each record goes (slot index + direction +
create flag); all counter math happens on the device in
``flow_table.apply_batch``. Two spines do that: the Python ``FlowIndex``
+ ``Batcher`` here, and the C++ engine of native/ (``native=True``), which
also takes raw monitor bytes. Both feed the same wire scatter. Batches are
padded to bucketed sizes so the wire shapes stay few and fixed, as in the
JAX spine.
"""

from __future__ import annotations

from collections.abc import Iterable, Sequence
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..core import flow_table as ft
from ..device import resolve_device
from .protocol import PREFIX, TelemetryRecord, parse_line, stable_flow_key

_U32 = np.uint64(0xFFFFFFFF)


def batch_emit_ts(batch) -> float | None:
    """The emit stamp of a direct-source poll batch, for the latency plane
    (obs/latency.py): a poll batch is stamped as one unit on its lead
    record (``protocol.stamp_records``), so the first record's stamp
    speaks for the batch. None for raw byte batches (no records on the
    host) and for unstamped batches."""
    if isinstance(batch, (bytes, bytearray)) or not batch:
        return None
    return getattr(batch[0], "emit_ts", None)


def bucket_size(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class SlotAssignment:
    slot: int
    is_fwd: bool
    is_create: bool


@dataclass
class FlowIndex:
    """key → slot map with direction folding (reference :157-165). Keys
    are namespaced by the record's telemetry source
    (``protocol.stable_flow_key(source=)``); ``slot_source`` remembers the
    namespace of each slot outside the default one (source 0)."""

    capacity: int
    key_to_slot: dict = field(default_factory=dict)
    slot_to_key: dict = field(default_factory=dict)
    slot_meta: dict = field(default_factory=dict)  # slot → (src, dst) for UI
    slot_source: dict = field(default_factory=dict)  # slot → source id
    free: list = field(default_factory=list)
    next_slot: int = 0

    def assign(self, r: TelemetryRecord) -> SlotAssignment | None:
        """Route one record; None when the table is full (the record is
        dropped, counted by the caller)."""
        key = stable_flow_key(r.datapath, r.eth_src, r.eth_dst, r.source)
        slot = self.key_to_slot.get(key)
        if slot is not None:
            return SlotAssignment(slot, True, False)
        rev_key = stable_flow_key(
            r.datapath, r.eth_dst, r.eth_src, r.source
        )
        slot = self.key_to_slot.get(rev_key)
        if slot is not None:
            return SlotAssignment(slot, False, False)
        if self.free:
            slot = self.free.pop()
        elif self.next_slot < self.capacity:
            slot = self.next_slot
            self.next_slot += 1
        else:
            return None
        self.key_to_slot[key] = slot
        self.slot_to_key[slot] = key
        self.slot_meta[slot] = (r.eth_src, r.eth_dst)
        if r.source:
            self.slot_source[slot] = r.source
        return SlotAssignment(slot, True, True)

    def slots_for_source(self, source: int) -> list[int]:
        """Every live slot in ``source``'s namespace. Source 0 (the
        default namespace) is the complement of the tagged slots."""
        if source:
            return [s for s, sid in self.slot_source.items() if sid == source]
        return [s for s in self.slot_to_key if s not in self.slot_source]

    def release_slot(self, slot: int) -> None:
        key = self.slot_to_key.pop(slot, None)
        if key is not None:
            self.key_to_slot.pop(key, None)
            self.slot_meta.pop(slot, None)
            self.slot_source.pop(slot, None)
            self.free.append(slot)

    def release_slots(self, slots) -> None:
        for s in slots:
            self.release_slot(int(s))


DEFAULT_BUCKETS = (256, 1024, 4096, 16384, 65536, 262144, 1048576)


class Batcher:
    """Accumulates records for one poll tick and materializes a padded
    ``UpdateBatch``.

    Per (slot, direction) a batch can hold one create row *and* one update
    row (``apply_batch`` applies creates first). A *third* same-direction
    record in one tick cannot be expressed in a single scatter; ``add``
    refuses it and the engine flushes the partial batch first, preserving
    exact sequential semantics."""

    def __init__(self, index: FlowIndex, buckets=DEFAULT_BUCKETS):
        self.index = index
        self.buckets = tuple(buckets)
        self.dropped = 0
        # (slot, is_fwd) → {"create": rec|None, "update": rec|None}
        self._pending: dict = {}

    def add(self, r: TelemetryRecord) -> bool:
        """True if accepted; False if the caller must flush() first (a
        same-direction update is already pending for this flow)."""
        a = self.index.assign(r)
        if a is None:
            self.dropped += 1
            return True
        entry = self._pending.setdefault(
            (a.slot, a.is_fwd), {"create": None, "update": None}
        )
        if a.is_create:
            entry["create"] = r
        elif entry["update"] is None:
            entry["update"] = r
        else:
            return False
        return True

    def last_flush_was_conflict(self) -> bool:
        """Always False: one drain of the pending dict holds at most one
        create and one update row per (slot, direction), however many
        bucket-capped batches it spans, so the flushes of one drain may
        be applied as one scatter (parallel/table_sharded.py coalesces
        them). The C++ engine's generations can conflict; its
        ``NativeBatcher`` returns the real flag."""
        return False

    def flush(self) -> ft.UpdateBatch | None:
        """Materialize up to one largest-bucket batch (numpy) and clear
        what it consumed; None when empty. Rows beyond the largest bucket
        stay pending — call again until None."""
        rows = []  # (slot, fwd, rec, is_create)
        for (s, fwd), e in self._pending.items():
            if e["create"] is not None:
                rows.append((s, fwd, e["create"], True))
            if e["update"] is not None:
                rows.append((s, fwd, e["update"], False))
        if not rows:
            return None
        self._pending.clear()
        if len(rows) > self.buckets[-1]:
            for s, fwd, r, create in rows[self.buckets[-1]:]:
                entry = self._pending.setdefault(
                    (s, fwd), {"create": None, "update": None}
                )
                entry["create" if create else "update"] = r
            rows = rows[: self.buckets[-1]]
        size = bucket_size(len(rows), self.buckets)
        slot = np.full(size, self.index.capacity, np.int32)  # scratch row pad
        time = np.zeros(size, np.int32)
        pkts_lo = np.zeros(size, np.uint32)
        pkts_f = np.zeros(size, np.float32)
        bytes_lo = np.zeros(size, np.uint32)
        bytes_f = np.zeros(size, np.float32)
        is_fwd = np.ones(size, bool)
        is_create = np.zeros(size, bool)
        for i, (s, fwd, r, create) in enumerate(rows):
            slot[i] = s
            time[i] = r.time
            pkts_lo[i] = np.uint64(r.packets) & _U32
            pkts_f[i] = np.float32(r.packets)
            bytes_lo[i] = np.uint64(r.bytes) & _U32
            bytes_f[i] = np.float32(r.bytes)
            is_fwd[i] = fwd
            is_create[i] = create
        return ft.UpdateBatch(
            slot=slot, time=time, pkts_lo=pkts_lo, pkts_f=pkts_f,
            bytes_lo=bytes_lo, bytes_f=bytes_f, is_fwd=is_fwd,
            is_create=is_create,
        )


class HostSpine:
    """The host half of a serving spine — batcher/index wiring, record
    and raw-byte ingest (native C++ or the Python batcher), the tick
    clock, and slot-metadata lookups. ``FlowStateEngine`` owns the device
    half. Subclass must call ``_init_spine`` and define ``step()``."""

    def _init_spine(self, capacity: int, buckets, native: bool,
                    pin: bool = False) -> None:
        self.native = native
        if native:
            from ..native.engine import NativeBatcher

            self.index = None
            self.batcher = NativeBatcher(capacity, buckets, pin=pin)
        else:
            self.index = FlowIndex(capacity)
            self.batcher = Batcher(self.index, buckets)
        self.buckets = tuple(buckets)
        # partial lines carried across ingest_bytes calls, per source: one
        # source's half line is never completed by another source's bytes
        # (the native engine keeps the same map)
        self._tails: dict[int, bytes] = {}
        # native flushes whose wire copy may be in flight — the step()
        # staging guard's state, kept across calls
        self._staged_flushes = 0
        # malformed telemetry lines of the Python parser, per source — the
        # counterpart of the C++ engine's counters
        self._parse_errors: dict[int, int] = {}
        self._last_time = 0
        # freshness floor for the activity-ranked render sample
        self._tick_floor = 0

    def ingest(self, records: Iterable[TelemetryRecord]) -> int:
        n = 0
        for r in records:
            if not self.batcher.add(r):
                # third same-direction record this tick: apply what we have,
                # then retry — keeps per-line sequential semantics exact
                self.step()
                self.batcher.add(r)
            if r.time > self._last_time:
                self._last_time = r.time
            n += 1
        return n

    def ingest_bytes(self, data: bytes, source: int = 0) -> int:
        """Bulk raw-byte ingest (monitor pipe chunks). On the native path
        no line crosses into Python; the fallback parses each line with
        ``protocol.parse_line``. ``source`` is the namespace the bytes
        belong to (0 = the default). Returns records parsed."""
        if self.native:
            return self.batcher.feed(data, source)
        data = self._tails.get(source, b"") + data
        # split on \n only, the native engine's framing; the last part is
        # the partial-line tail
        parts = data.split(b"\n")
        self._tails[source] = parts.pop()
        n = 0
        for line in parts:
            r = parse_line(line + b"\n")
            if r is not None:
                if source:
                    r = replace(r, source=source)
                self.ingest([r])
                n += 1
            elif line.startswith(PREFIX):
                # telemetry-shaped but unparseable: malformed, as the C++
                # engine counts it (noise lines are free)
                self._parse_errors[source] = (
                    self._parse_errors.get(source, 0) + 1
                )
        return n

    def parse_errors(self, source: int | None = None) -> int:
        """Malformed telemetry lines rejected by the parser (in total, or
        of one source) — the native and Python paths count alike."""
        if self.native:
            return self.batcher.parse_errors(source)
        if source is None:
            return sum(self._parse_errors.values())
        return self._parse_errors.get(source, 0)

    @property
    def last_time(self) -> int:
        """Max telemetry timestamp ingested — the idle-eviction clock."""
        if self.native:
            return max(self._last_time, self.batcher.last_time)
        return self._last_time

    @property
    def dropped(self) -> int:
        return self.batcher.dropped

    def num_flows(self) -> int:
        """Tracked (in-use) flow count — O(1) host work."""
        if self.native:
            return self.batcher.num_flows()
        return len(self.index.slot_meta)

    def mark_tick(self) -> None:
        """Snapshot the freshness floor for the activity-ranked render —
        call at the START of each poll tick. Flows with telemetry strictly
        newer than the floor count as active."""
        self._tick_floor = self.last_time

    @property
    def tick_floor(self) -> int:
        """The freshness floor snapped by the last ``mark_tick``."""
        return self._tick_floor

    def _slot_meta_for(self, slots) -> dict:
        """slot → (eth_src, eth_dst) for exactly the given slots."""
        if self.native:
            out = {}
            for s in slots:
                meta = self.batcher.slot_meta(int(s))
                if meta is not None:
                    out[int(s)] = meta
            return out
        return {
            int(s): self.index.slot_meta[s]
            for s in slots
            if s in self.index.slot_meta
        }

    def step(self) -> bool:  # pragma: no cover - interface
        raise NotImplementedError


class FlowStateEngine(HostSpine):
    """The host↔device ingest spine: records or raw bytes in, feature
    matrix out. The table lives on ``device`` (default CUDA, see
    device.py); every flush crosses as one packed wire. ``native`` routes
    ingest through the C++ engine (native/engine.py), ``track_dirty``
    keeps the per-slot dirty mask of incremental labels
    (serving/incremental.py)."""

    def __init__(self, capacity: int, buckets=DEFAULT_BUCKETS, device=None,
                 native: bool = False, track_dirty: bool = False):
        self.device = resolve_device(device)
        self.table = ft.make_table(capacity, self.device)
        self.dirty = None
        # the reference statistics block of a restored serving checkpoint
        # (io/serving_checkpoint.py), written again by the next save
        self.feature_reference = None
        on_card = self.device.type == "cuda"
        # recorded after each staged wire copy: the staging guard waits on
        # it, not on the whole device
        self._staged = torch.cuda.Event() if on_card else None
        self._init_spine(capacity, buckets, native, pin=on_card)
        if track_dirty:
            self.enable_dirty_tracking()

    def enable_dirty_tracking(self) -> None:
        """Start keeping the per-slot dirty mask that incremental labels
        read. It starts all dirty: whatever the table already holds
        predates the label cache, so the first render predicts it all."""
        self.dirty = torch.ones(
            self.table.capacity + 1, dtype=torch.bool, device=self.device
        )

    def render_sample(self, labels, n: int) -> list[tuple]:
        """Activity-ranked render rows with O(n) host transfer:
        ``(slot, label, fwd_active, rev_active)`` for the ≤n most active
        flows this tick, most active first. ``labels`` is the (capacity,)
        vector on the device, or on the host (a numpy array: the degrade
        ladder's labels), where the ranked slots pick their labels."""
        n = min(n, self.table.capacity)
        if n <= 0:
            return []
        if isinstance(labels, np.ndarray):
            idx, valid, fa, ra = (
                t.cpu().numpy() for t in ft.top_active_flags(
                    self.table, n, self._tick_floor
                )
            )
            lab = labels[idx]
        else:
            idx, valid, lab, fa, ra = (
                t.cpu().numpy() for t in ft.top_active_render(
                    self.table, labels, n, self._tick_floor
                )
            )
        return [
            (int(s), int(c), bool(f), bool(r))
            for s, v, c, f, r in zip(idx, valid, lab, fa, ra)
            if v
        ]

    def slot_metadata(self, slots: Iterable[int] | None = None) -> dict:
        """slot → (eth_src, eth_dst) for in-use slots (UI table), or for
        exactly ``slots``."""
        if slots is not None:
            return self._slot_meta_for(slots)
        if not self.native:
            return dict(self.index.slot_meta)
        in_use = self.table.in_use[:-1].cpu().numpy()
        return self._slot_meta_for(np.nonzero(in_use)[0])

    def step(self) -> bool:
        """Flush all pending records into the device table; False if idle.
        Loops because one tick can exceed the largest batch bucket.

        Native path: the C++ engine writes each generation in the packed
        wire layout into the double-buffered staging (``flush_wire``), and
        the wire goes to ``apply_wire`` as it is. The Python batcher keeps
        the record-object route. Both feed the same scatter (the
        dirty-tracking one when the label cache is live)."""
        applied = False
        if self.native:
            # gated on pending records, so the guard runs only ahead of a
            # real flush (flush_wire itself writes the staging buffer)
            while len(self.batcher):
                if self._staged_flushes >= 2:
                    # flush k reuses flush k-2's buffer, and its copy to
                    # the card may still be in flight: wait for the last
                    # staged copy before the C++ side overwrites it. The
                    # count persists across step() calls because the
                    # hazard spans ticks.
                    if self._staged is not None:
                        self._staged.synchronize()
                    self._staged_flushes = 0
                if (w := self.batcher.flush_wire()) is None:
                    break
                self._apply_wire(w)
                if self._staged is not None:
                    self._staged.record(torch.cuda.current_stream(self.device))
                self._staged_flushes += 1
                applied = True
            return applied
        while (batch := self.batcher.flush()) is not None:
            self._apply_wire(ft.pack_wire(batch))
            applied = True
        return applied

    def _apply_wire(self, w: np.ndarray) -> None:
        """One packed wire batch into the device table (with the dirty
        bits of its slots when the label cache is live)."""
        wire = ft.wire_tensor(w, self.device)
        if self.dirty is None:
            self.table = ft.apply_wire(self.table, wire)
        else:
            self.table, self.dirty = ft.apply_wire_dirty(
                self.table, self.dirty, wire
            )

    def features(self) -> torch.Tensor:
        """(capacity, 12) device feature matrix (classifier input)."""
        return ft.features12(self.table)

    def stale_slots(self, now: int, idle_seconds: int) -> np.ndarray:
        """Slot ids with no telemetry in either direction for
        ``idle_seconds`` — the decision half of idle eviction."""
        # Flush pending records first: device last_time must be current,
        # and no stale pending row may outlive its slot's eviction.
        self.step()
        # decided on the device, crossing to the host bit-packed
        stale = np.unpackbits(
            ft.stale_bits(self.table, now, idle_seconds).cpu().numpy(),
            count=self.table.capacity + 1,
        ).astype(bool)[:-1]
        return np.nonzero(stale)[0]

    def evict_slots(self, slots: np.ndarray) -> int:
        """Release an explicit slot batch chosen by ``stale_slots`` — the
        release half of idle eviction. Returns the evicted count."""
        return self._clear_and_release(slots)

    def evict_idle(self, now: int, idle_seconds: int) -> int:
        """Release flows with no telemetry in either direction for
        ``idle_seconds`` — the capacity-reclaim the reference lacks.
        Returns the number of evicted flows."""
        return self.evict_slots(self.stale_slots(now, idle_seconds))

    def _clear_and_release(self, slots: np.ndarray) -> int:
        """Clear and release an explicit slot batch: bucketed clears, the
        dirty bits of the cleared rows when the label cache is live (their
        features are zeros now), one bulk index release."""
        step = self.buckets[-1]
        capacity = self.table.capacity
        for i in range(0, slots.size, step):
            chunk = slots[i: i + step]
            size = bucket_size(chunk.size, self.buckets)
            padded = np.full(size, capacity, np.int64)
            padded[: chunk.size] = chunk
            slot = torch.from_numpy(padded).to(self.device)
            if self.dirty is None:
                self.table = ft.clear_slots(self.table, slot)
            else:
                self.table, self.dirty = ft.clear_slots_dirty(
                    self.table, self.dirty, slot
                )
        (self.batcher if self.native else self.index).release_slots(slots)
        return int(slots.size)

    def slots_for_source(self, source: int) -> np.ndarray:
        """The slots a source's namespace owns, on either spine."""
        if self.native:
            return self.batcher.slots_for_source(source).astype(np.int64)
        return np.asarray(
            sorted(self.index.slots_for_source(source)), np.int64
        )

    def evict_source(self, source: int) -> int:
        """Evict every flow of one telemetry source's namespace, and drop
        its carried partial line on both spines (a restarted stream's
        first chunk must not complete the dead one's fragment). Returns
        the number of evicted flows."""
        # flush first: a pending row of an about-to-clear slot would
        # scatter stale counters into a freed row
        self.step()
        self._tails.pop(source, None)
        if self.native:
            self.batcher.reset_tail(source)
        return self._clear_and_release(self.slots_for_source(source))

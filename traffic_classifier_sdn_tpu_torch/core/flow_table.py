"""Device-resident flow table: the reference's ``flows = {}`` dict as a
fixed-capacity structure-of-arrays updated by one batched scatter step —
the torch port of ``traffic_classifier_sdn_tpu/core/flow_table.py``.

Every function here is the same elementwise program as its JAX
counterpart, so the table state and the 12-feature matrix are bitwise
those of the reference (tests/test_torch_flow_table.py pins it).

Numerical design — exact semantics without float64:

- ``*_lo`` cumulative counters are the true counter mod 2^32. The JAX
  table holds them as uint32; torch has no uint32 subtraction or shift on
  the CPU, so here they are **int32 bit patterns** of the same 32 bits.
  A delta is computed in int64, masked to 32 bits and folded back to
  int32 (``_delta32``) — exact whenever the true per-poll delta is < 2^31,
  even across the 4 GiB counter wrap, and never relying on int32 overflow.
- ``*_f`` cumulative counters are float32 approximations of the full
  64-bit value (supplied by the host). Only the average-rate features
  divide these.
- Slot assignment (key → row) is host-side control plane
  (ingest/batcher.py).

Row ``capacity`` is reserved as a scratch row so fixed-shape update
batches can pad harmlessly. Functions return new tables (the JAX
reference is functional); the serving engine rebinds ``engine.table``.
The incremental path's dirty mask and label cache are updated in place
(JAX donates them), and returned for the same rebinding.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from .features import NUM_FEATURES

_SLOT_MASK = 0x3FFFFFFF
_FWD_BIT = -(1 << 31)  # bit 31 of an int32 bit pattern
_CREATE_BIT = 1 << 30
_U32_MASK = 0xFFFFFFFF


@dataclass
class DirState:
    """Per-direction counters for every slot, shape (capacity+1,)."""

    pkts_lo: torch.Tensor  # int32 bit pattern of the packet count mod 2^32
    pkts_f: torch.Tensor  # float32 ≈ true packet count
    bytes_lo: torch.Tensor  # int32 bit pattern of the byte count mod 2^32
    bytes_f: torch.Tensor  # float32
    delta_pkts: torch.Tensor  # int32, exact
    delta_bytes: torch.Tensor  # int32, exact
    inst_pps: torch.Tensor  # float32
    avg_pps: torch.Tensor  # float32
    inst_bps: torch.Tensor  # float32
    avg_bps: torch.Tensor  # float32
    last_time: torch.Tensor  # int32
    active: torch.Tensor  # bool


@dataclass
class FlowTable:
    time_start: torch.Tensor  # int32 (capacity+1,)
    in_use: torch.Tensor  # bool (capacity+1,)
    fwd: DirState
    rev: DirState

    @property
    def capacity(self) -> int:
        return self.time_start.shape[0] - 1


@dataclass
class UpdateBatch:
    """One poll tick's worth of telemetry, padded to a fixed length.

    Host side (``ingest/batcher.Batcher.flush``) the fields are numpy
    arrays with uint32 ``*_lo`` lanes, exactly the JAX batcher's; device
    side (``unpack_wire``) they are tensors with int32 bit-pattern lanes.
    Padding rows use ``slot == capacity`` (the scratch row) with
    ``is_create=False, is_fwd=True``. Duplicate (slot, direction) pairs
    within one batch are not allowed (the host batcher deduplicates)."""

    slot: object  # int32 (B,)
    time: object  # int32 (B,) poll timestamp, seconds
    pkts_lo: object  # uint32 (host) / int32 bit pattern (device) (B,)
    pkts_f: object  # float32 (B,)
    bytes_lo: object  # uint32 (host) / int32 bit pattern (device) (B,)
    bytes_f: object  # float32 (B,)
    is_fwd: object  # bool (B,)
    is_create: object  # bool (B,)


def _zeros_dir(n: int, device) -> DirState:
    def z(dtype):
        return torch.zeros(n, dtype=dtype, device=device)

    i32, f32 = torch.int32, torch.float32
    return DirState(
        pkts_lo=z(i32), pkts_f=z(f32), bytes_lo=z(i32), bytes_f=z(f32),
        delta_pkts=z(i32), delta_bytes=z(i32),
        inst_pps=z(f32), avg_pps=z(f32), inst_bps=z(f32), avg_bps=z(f32),
        last_time=z(i32), active=z(torch.bool),
    )


def make_table(capacity: int, device=None) -> FlowTable:
    """An empty table on ``device`` (default CUDA, see device.py)."""
    device = resolve_device(device)
    n = capacity + 1  # last row is the padding scratch slot
    return FlowTable(
        time_start=torch.zeros(n, dtype=torch.int32, device=device),
        in_use=torch.zeros(n, dtype=torch.bool, device=device),
        fwd=_zeros_dir(n, device),
        rev=_zeros_dir(n, device),
    )


def pack_wire(b: UpdateBatch) -> np.ndarray:
    """Host-side: one contiguous uint32 wire matrix per batch, byte for
    byte the JAX ``pack_wire`` layout. Column 0 carries the slot with the
    direction/create flags in bits 31/30 (slot ≤ capacity < 2³⁰).

    - **(B, 4) compact** — slot+flags, time, pkts_lo, bytes_lo — when
      every counter in the batch is < 2³¹: the device rebuilds the f32
      counter lanes exactly as ``float32(lo)``.
    - **(B, 6) full** — adds bit-cast pkts_f/bytes_f — whenever any
      counter reaches 2³¹."""
    if b.slot.size and int(b.slot.max()) >= (1 << 30):
        raise ValueError(
            "pack_wire: slot >= 2^30 collides with the flag bits — "
            "table capacity must stay below 2^30"
        )
    col0 = (
        b.slot.astype(np.uint32)
        | (b.is_fwd.astype(np.uint32) << 31)
        | (b.is_create.astype(np.uint32) << 30)
    )
    lim = np.float32(1 << 31)
    compact = bool((b.pkts_f < lim).all() and (b.bytes_f < lim).all())
    w = np.empty((b.slot.shape[0], 4 if compact else 6), np.uint32)
    w[:, 0] = col0
    w[:, 1] = b.time.view(np.uint32)
    w[:, 2] = b.pkts_lo
    if compact:
        w[:, 3] = b.bytes_lo
        return w
    w[:, 3] = b.pkts_f.view(np.uint32)
    w[:, 4] = b.bytes_lo
    w[:, 5] = b.bytes_f.view(np.uint32)
    return w


def widen_wire(w: np.ndarray) -> np.ndarray:
    """Host-side (B, 4) compact → (B, 6) full wire: rebuilds the f32
    lanes as ``float32(lo)`` (exact under the compact form's < 2³¹
    guarantee)."""
    if w.shape[1] == 6:
        return w
    out = np.empty((w.shape[0], 6), np.uint32)
    out[:, 0] = w[:, 0]
    out[:, 1] = w[:, 1]
    out[:, 2] = w[:, 2]
    out[:, 3] = w[:, 2].astype(np.float32).view(np.uint32)
    out[:, 4] = w[:, 3]
    out[:, 5] = w[:, 3].astype(np.float32).view(np.uint32)
    return out


class WireStage:
    """Reusable host staging for packed wire batches — the zero-copy half
    of native ingest (native/engine.NativeBatcher.flush_wire): the C++
    engine writes each flushed generation straight into one of these
    buffers in the ``pack_wire`` layout, and the view handed back goes to
    ``apply_wire`` untouched. Two rotating buffers: the previous flush's
    view, whose copy to the device may still be in flight, is never
    overwritten by the next flush (the engine's staging guard covers the
    flush after that). Buffers are flat 32-bit words so one allocation
    serves both wire widths. With ``pin`` (an engine on CUDA) they are
    page-locked, so the copy to the card can be asynchronous."""

    def __init__(self, max_rows: int, pin: bool = False):
        self._bufs = tuple(
            torch.empty(max_rows * 6, dtype=torch.int32, pin_memory=pin)
            for _ in range(2)
        )
        self._views = tuple(b.numpy().view(np.uint32) for b in self._bufs)
        self._i = 0

    def buffer(self) -> np.ndarray:
        """The buffer the NEXT flush writes into (flat uint32)."""
        return self._views[self._i]

    def view(self, rows: int, width: int) -> np.ndarray:
        """Consume the current buffer as a (rows, width) wire matrix and
        rotate — the caller owns the view until the flush after next."""
        buf = self._views[self._i]
        self._i ^= 1
        return buf[: rows * width].reshape(rows, width)


def wire_tensor(w: np.ndarray, device) -> torch.Tensor:
    """A host uint32 wire matrix as an int32 bit-pattern tensor on
    ``device`` (torch has no general uint32 arithmetic). The copy to a
    card does not block the host; from pageable memory CUDA has taken the
    bytes by the time it returns, from a pinned ``WireStage`` buffer the
    caller keeps the buffer until the copy is done."""
    return torch.from_numpy(np.ascontiguousarray(w).view(np.int32)).to(
        device, non_blocking=True
    )


def _u32_to_f32(lo: torch.Tensor) -> torch.Tensor:
    """float32 of the unsigned value an int32 bit pattern holds."""
    return (lo.to(torch.int64) & _U32_MASK).to(torch.float32)


def unpack_wire(w: torch.Tensor) -> UpdateBatch:
    """Device-side inverse of ``pack_wire`` over the int32 bit-pattern
    wire tensor. The col-0 flags are decoded with masks, not shifts."""
    col0 = w[:, 0]
    compact = w.shape[1] == 4
    pkts_lo = w[:, 2]
    bytes_lo = w[:, 3] if compact else w[:, 4]
    return UpdateBatch(
        slot=col0 & _SLOT_MASK,
        time=w[:, 1],
        pkts_lo=pkts_lo,
        pkts_f=_u32_to_f32(pkts_lo) if compact
        else w[:, 3].view(torch.float32),
        bytes_lo=bytes_lo,
        bytes_f=_u32_to_f32(bytes_lo) if compact
        else w[:, 5].view(torch.float32),
        is_fwd=(col0 & _FWD_BIT) != 0,
        is_create=(col0 & _CREATE_BIT) != 0,
    )


def apply_wire(table: FlowTable, w: torch.Tensor) -> FlowTable:
    """``apply_batch`` over the packed wire tensor — the serving spine's
    per-flush entry point: one host→device buffer per batch."""
    return apply_batch(table, unpack_wire(w))


def mark_dirty_wire(dirty: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Set the dirty bit of every slot a packed wire batch touches, in
    place, and return the mask.

    ``dirty`` is the per-slot (capacity+1,) bool mask behind incremental
    prediction (serving/incremental.py): the ingest scatter is the only
    thing that changes a row's 12 serving features, so the slots in the
    wire are exactly the rows whose cached labels went stale. Padding
    rows carry the scratch slot and land on the scratch bit, which no
    reader consults."""
    dirty[(w[:, 0] & _SLOT_MASK).to(torch.int64)] = True
    return dirty


def apply_wire_dirty(
    table: FlowTable, dirty: torch.Tensor, w: torch.Tensor
) -> tuple[FlowTable, torch.Tensor]:
    """``apply_wire`` with the dirty-bit scatter of the same wire: one
    wire transfer covers the table update and the staleness
    bookkeeping."""
    return apply_batch(table, unpack_wire(w)), mark_dirty_wire(dirty, w)


def _inverse_index(mask, slot, n: int) -> torch.Tensor:
    """(n,) int64 map: table row → index of the batch row addressing it
    under ``mask``, or B (sentinel) for rows no batch row addresses.

    Masked-out rows are routed to a dump row past the end of the table,
    so the scatter needs no host-side compaction (no device sync).
    Uniqueness precondition: at most one batch row per (slot, direction)
    and per-slot create (ingest/batcher.Batcher)."""
    B = slot.shape[0]
    rows = torch.arange(B, dtype=torch.int64, device=slot.device)
    tgt = torch.where(mask, slot.to(torch.int64), n)
    inv = torch.full((n + 1,), B, dtype=torch.int64, device=slot.device)
    inv[tgt] = rows
    return inv[:n]


def _delta32(new_lo: torch.Tensor, old_lo: torch.Tensor) -> torch.Tensor:
    """``int32(new - old)`` in mod-2^32 arithmetic, computed in int64."""
    d = (new_lo.to(torch.int64) - old_lo.to(torch.int64)) & _U32_MASK
    return torch.where(d >= (1 << 31), d - (1 << 32), d).to(torch.int32)


def _merged_dir(
    d: DirState, b: UpdateBatch, gather, time_start,
    inv_create, inv_update, counters_from_batch: bool, active_init: bool,
) -> DirState:
    """One direction's create-then-update merge, all in table-row space.

    Create first, then update — a batch may hold a flow's create row and
    a same-tick update row, and the update must read the freshly
    initialized counters, exactly like the reference's sequential
    per-line processing."""
    B = b.slot.shape[0]
    hit_c = inv_create != B
    time_c = gather(b.time, inv_create)

    def init(old, batch_col):
        created = (
            gather(batch_col, inv_create) if counters_from_batch
            else torch.zeros_like(old)
        )
        return torch.where(hit_c, created, old)

    def reset(old):
        return torch.where(hit_c, torch.zeros_like(old), old)

    pkts_lo = init(d.pkts_lo, b.pkts_lo)
    pkts_f = init(d.pkts_f, b.pkts_f)
    bytes_lo = init(d.bytes_lo, b.bytes_lo)
    bytes_f = init(d.bytes_f, b.bytes_f)
    delta_pkts = reset(d.delta_pkts)
    delta_bytes = reset(d.delta_bytes)
    inst_pps = reset(d.inst_pps)
    avg_pps = reset(d.avg_pps)
    inst_bps = reset(d.inst_bps)
    avg_bps = reset(d.avg_bps)
    last_time = torch.where(hit_c, time_c, d.last_time)
    active = torch.where(hit_c, active_init, d.active)

    # --- update pass (reference updateforward/updatereverse math) ---------
    hit = inv_update != B
    time_u = gather(b.time, inv_update)
    pkts_lo_u = gather(b.pkts_lo, inv_update)
    pkts_f_u = gather(b.pkts_f, inv_update)
    bytes_lo_u = gather(b.bytes_lo, inv_update)
    bytes_f_u = gather(b.bytes_f, inv_update)

    d_pkts = _delta32(pkts_lo_u, pkts_lo)
    d_bytes = _delta32(bytes_lo_u, bytes_lo)
    age = (time_u - time_start).to(torch.float32)
    gap = (time_u - last_time).to(torch.float32)
    # Guards replicate reference :66-67: keep the old value when the
    # denominator would be zero.
    n_avg_pps = torch.where(age != 0, pkts_f_u / age, avg_pps)
    n_avg_bps = torch.where(age != 0, bytes_f_u / age, avg_bps)
    n_inst_pps = torch.where(
        gap != 0, d_pkts.to(torch.float32) / gap, inst_pps
    )
    n_inst_bps = torch.where(
        gap != 0, d_bytes.to(torch.float32) / gap, inst_bps
    )
    n_active = (d_bytes != 0) & (d_pkts != 0)  # reference :75-78

    def upd(old, new):
        return torch.where(hit, new, old)

    return DirState(
        pkts_lo=upd(pkts_lo, pkts_lo_u),
        pkts_f=upd(pkts_f, pkts_f_u),
        bytes_lo=upd(bytes_lo, bytes_lo_u),
        bytes_f=upd(bytes_f, bytes_f_u),
        delta_pkts=upd(delta_pkts, d_pkts),
        delta_bytes=upd(delta_bytes, d_bytes),
        inst_pps=upd(inst_pps, n_inst_pps),
        avg_pps=upd(avg_pps, n_avg_pps),
        inst_bps=upd(inst_bps, n_inst_bps),
        avg_bps=upd(avg_bps, n_avg_bps),
        last_time=upd(last_time, time_u),
        active=upd(active, n_active),
    )


def apply_batch(table: FlowTable, b: UpdateBatch) -> FlowTable:
    """Apply one padded update batch (device tensors): three inverse-index
    builds plus gathers and elementwise merges over the whole table."""
    n = table.time_start.shape[0]
    scratch = n - 1
    B = b.slot.shape[0]
    real = b.slot < scratch  # padding rows carry slot == scratch
    create = b.is_create & real
    upd_fwd = ~b.is_create & b.is_fwd & real
    upd_rev = ~b.is_create & ~b.is_fwd & real

    inv_c = _inverse_index(create, b.slot, n)
    inv_f = _inverse_index(upd_fwd, b.slot, n)
    inv_r = _inverse_index(upd_rev, b.slot, n)
    hit_c = inv_c != B

    def gather(col, inv):
        # sentinel row B appended so inv == B reads an inert value
        return torch.cat([col, col.new_zeros(1)])[inv]

    time_start = torch.where(hit_c, gather(b.time, inv_c), table.time_start)
    in_use = table.in_use | hit_c

    fwd = _merged_dir(
        table.fwd, b, gather, time_start, inv_c, inv_f,
        counters_from_batch=True, active_init=True,
    )
    rev = _merged_dir(
        table.rev, b, gather, time_start, inv_c, inv_r,
        counters_from_batch=False, active_init=False,
    )
    return FlowTable(time_start=time_start, in_use=in_use, fwd=fwd, rev=rev)


def _cleared_dir(d: DirState, keep) -> DirState:
    def put(arr):
        return torch.where(keep, arr, torch.zeros_like(arr))

    return DirState(**{
        f.name: put(getattr(d, f.name)) for f in dataclasses.fields(d)
    })


def clear_slots(table: FlowTable, slot: torch.Tensor) -> FlowTable:
    """Reset the given slots to the empty state (eviction). ``slot`` is a
    fixed-length int batch padded with ``capacity`` (the scratch row)."""
    n = table.time_start.shape[0]
    cleared = torch.zeros(n, dtype=torch.bool, device=slot.device)
    cleared[slot.to(torch.int64)] = True
    keep = ~cleared
    return FlowTable(
        time_start=torch.where(
            keep, table.time_start, torch.zeros_like(table.time_start)
        ),
        in_use=table.in_use & keep,
        fwd=_cleared_dir(table.fwd, keep),
        rev=_cleared_dir(table.rev, keep),
    )


def clear_slots_dirty(
    table: FlowTable, dirty: torch.Tensor, slot: torch.Tensor
) -> tuple[FlowTable, torch.Tensor]:
    """``clear_slots`` with cache invalidation: an evicted slot's features
    drop to zero, so its cached label is stale and its dirty bit comes up
    (in place) with the clear. A reassigned slot would be marked by its
    create scatter anyway; this covers the window where it sits empty."""
    return clear_slots(table, slot), mark_dirty_slots(dirty, slot)


def mark_dirty_slots(dirty: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Set the dirty bit of an explicit slot batch (padded with the
    scratch slot), in place — the re-invalidation path."""
    dirty[slot.to(torch.int64)] = True
    return dirty


def dirty_count(dirty: torch.Tensor) -> torch.Tensor:
    """Number of set dirty bits outside the scratch row, a 0-d int32
    tensor on the mask's device — the one scalar the host fetches per
    render tick to pick a compaction bucket."""
    return dirty[:-1].sum(dtype=torch.int32)


def compact_dirty(dirty: torch.Tensor, bucket: int) -> torch.Tensor:
    """(bucket,) int32 indices of the dirty rows (scratch excluded),
    ascending, padded with ``capacity`` — the static-shape compaction of
    ``jnp.nonzero(size=bucket, fill_value=capacity)``, and like it keeping
    the first ``bucket`` rows when more are dirty. ``nonzero_static`` has
    a static shape, so nothing waits for the device (``torch.nonzero``
    would)."""
    n = dirty.shape[0] - 1
    idx = torch.nonzero_static(dirty[:-1], size=bucket, fill_value=n)
    return idx[:, 0].to(torch.int32)


def features12_at(table: FlowTable, idx: torch.Tensor) -> torch.Tensor:
    """(len(idx), 12) feature rows of exactly the given slots — the
    dirty-set gather: ``features12(table)[idx]``, the same
    ``_feature12_cols`` and in-use zeroing, so a dirty-set predict is
    bitwise a full-table one's on those rows. The columns are stacked for
    the whole table and then gathered once: on the card one gather costs
    less than twelve. Padding entries (``idx == capacity``) read the
    scratch row: never in use, so they project to zeros, and their labels
    land on the label cache's scratch entry (``merge_labels``)."""
    idx = idx.to(torch.int64)
    X = torch.stack(_feature12_cols(table), dim=1)[idx]
    return torch.where(table.in_use[idx, None], X, torch.zeros_like(X))


def merge_labels(cache: torch.Tensor, idx: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
    """Scatter the dirty rows' fresh labels into the label cache, in
    place, and return it. The cache has ``capacity + 1`` entries: padding
    indices (``idx == capacity``) write the last one, which readers never
    see (they read ``cache[:capacity]``) — the port's form of JAX's
    out-of-bounds ``mode="drop"``, which torch indexing does not have."""
    cache[idx.to(torch.int64)] = labels
    return cache


def stale_mask(table: FlowTable, now: int, idle_seconds: int) -> torch.Tensor:
    """(capacity+1,) bool: in-use slots with no telemetry in either
    direction for ``idle_seconds``."""
    last = torch.maximum(table.fwd.last_time, table.rev.last_time)
    return table.in_use & (now - last >= idle_seconds)


_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def stale_bits(table: FlowTable, now: int, idle_seconds: int) -> torch.Tensor:
    """Bit-packed ``stale_mask``, as ``np.packbits`` packs it (big-endian
    within each byte, the last byte zero-padded): the eviction scan's one
    device-to-host transfer shrinks 8×. The host unpacks it with
    ``np.unpackbits(count=capacity + 1)``."""
    m = stale_mask(table, now, idle_seconds)
    pad = -m.shape[0] % 8
    m = torch.cat([m, m.new_zeros(pad)]).view(-1, 8).to(torch.uint8)
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=m.device)
    return (m * w).sum(1, dtype=torch.uint8)


def _activity_score(table: FlowTable, floor: int) -> torch.Tensor:
    """(capacity,) ranking score: |Δbytes| for slots with telemetry newer
    than ``floor``, 0 for stale in-use slots, −inf for unused."""
    act = (
        torch.abs(table.fwd.delta_bytes.to(torch.float32))
        + torch.abs(table.rev.delta_bytes.to(torch.float32))
    )[:-1]
    fresh = (
        torch.maximum(table.fwd.last_time, table.rev.last_time)[:-1] > floor
    )
    return torch.where(
        table.in_use[:-1],
        torch.where(fresh, act, torch.zeros_like(act)),
        torch.full_like(act, -torch.inf),
    )


def top_active_slots(table: FlowTable, n: int, floor: int):
    """Indices of the ≤n most active in-use slots this tick, ranked by
    |Δbytes| summed over both directions (desc), ties to the lowest slot.

    ``lax.top_k`` breaks ties toward the lower index and ``torch.topk``
    promises no order, so the ranking is a STABLE descending sort: equal
    scores keep ascending slot order. Returns ``(idx, valid)``: unused
    slots score −inf and are masked out via ``valid``."""
    score = _activity_score(table, floor)
    idx = torch.sort(score, descending=True, stable=True).indices[:n]
    return idx, table.in_use[:-1][idx]


def top_active_render(table: FlowTable, labels, n: int, floor: int):
    """Everything one rendered table row needs, gathered on device:
    ``(idx, valid, labels[idx], fwd_active[idx], rev_active[idx])`` for the
    ≤n most active slots (ranking of ``top_active_slots``)."""
    idx, valid = top_active_slots(table, n, floor)
    return (
        idx,
        valid,
        labels[idx],
        table.fwd.active[:-1][idx],
        table.rev.active[:-1][idx],
    )


def _feature12_cols(table: FlowTable) -> list:
    """The 12 serving-feature columns, (capacity+1,) each, order of
    traffic_classifier.py:104."""
    f, r = table.fwd, table.rev
    f32 = torch.float32
    return [
        f.delta_pkts.to(f32), f.delta_bytes.to(f32),
        f.inst_pps, f.avg_pps, f.inst_bps, f.avg_bps,
        r.delta_pkts.to(f32), r.delta_bytes.to(f32),
        r.inst_pps, r.avg_pps, r.inst_bps, r.avg_bps,
    ]


def features12(table: FlowTable) -> torch.Tensor:
    """(capacity, 12) online feature matrix, order of
    traffic_classifier.py:104 — rows for unused slots are zero."""
    X = torch.stack(_feature12_cols(table), dim=1)[:-1]  # drop scratch row
    X = torch.where(table.in_use[:-1, None], X, torch.zeros_like(X))
    if X.shape[1] != NUM_FEATURES:
        raise AssertionError("features12 must produce 12 columns")
    return X.contiguous()

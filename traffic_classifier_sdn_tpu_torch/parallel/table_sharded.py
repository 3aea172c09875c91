"""The flow table sharded across the mesh's data axis — serving capacity
beyond one device's table; the port of
``traffic_classifier_sdn_tpu/parallel/table_sharded.py``.

Each shard owns an independent ``(local_capacity + 1,)`` structure-of-
arrays table on its own device; the host routes update records to shards
round-robin by slot, and every device step runs once per shard. Flows are
partitioned, never replicated: the write path has no cross-shard traffic,
and the read path's one "collective" is a gather of each shard's render
candidates (O(rows)) and bit-packed stale mask (capacity/8 bytes) onto the
host, in shard order, where the merge runs.

Where JAX stacks every leaf to ``(n_shards, …)`` and runs one
``shard_map``, the port holds a list of per-shard ``FlowTable``s and the
programs (``make_apply`` … ``make_clear_dirty``) loop over it. A gather
(``Gathered``) packs every shard's outputs into one byte buffer per device,
so a tick's read side crosses to the host in one copy per device, not one
per shard and output.

Global slot g lives on shard g % n_shards at local row g // n_shards.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import flow_table as ft
from ..ingest.batcher import DEFAULT_BUCKETS, HostSpine, bucket_size
from ..serving.pipeline import Fence
from .mesh import DATA_AXIS, replicated


def _n_shards(mesh) -> int:
    return mesh.shape[DATA_AXIS]


def shard_devices(mesh) -> list[torch.device]:
    """The device of each data-axis shard, in shard order."""
    return mesh.axis_devices(DATA_AXIS)


def make_sharded_table(mesh, capacity_total: int) -> list[ft.FlowTable]:
    """One empty ``(capacity_total / n_shards)``-row table per shard, each
    on its shard's device."""
    n = _n_shards(mesh)
    if capacity_total % n:
        raise ValueError(f"capacity {capacity_total} not divisible by {n}")
    return [ft.make_table(capacity_total // n, dev)
            for dev in shard_devices(mesh)]


def _placed(devices, arr: np.ndarray) -> list[torch.Tensor]:
    """A host (n_shards, …) array as per-shard tensors on the shards'
    devices: one host-to-device copy per distinct device. uint32 arrays
    cross as int32 bit patterns (``flow_table.wire_tensor``)."""
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    whole: dict = {}
    out = []
    for s, dev in enumerate(devices):
        if dev not in whole:
            whole[dev] = torch.from_numpy(np.ascontiguousarray(arr)).to(
                dev, non_blocking=True)
        out.append(whole[dev][s])
    return out


class Gathered:
    """The per-shard outputs of one program, gathered in shard order: the
    outputs of the shards on each device packed into one byte buffer there
    (so the host copy is one transfer per device). ``host()`` waits for
    them and returns one numpy array per output, stacked over shards — the
    host side of JAX's ``all_gather``. With ``fenced``, each buffer carries
    a ``Fence``, so a pipelined device stage may finish the gather on a
    stream of its own; without, ``host()`` copies on the caller's
    stream."""

    __slots__ = ("_bufs", "_layout", "_n")

    def __init__(self, per_shard: list[tuple], fenced: bool = False):
        """``per_shard``: each shard's outputs, a tuple of tensors of the
        same shapes on every shard, in shard order."""
        self._n = len(per_shard)
        first = per_shard[0]
        # (shape, numpy dtype) of each output; every shard's agree
        self._layout = [
            (tuple(t.shape), torch.empty(0, dtype=t.dtype).numpy().dtype)
            for t in first
        ]
        groups: dict = {}
        for s, outs in enumerate(per_shard):
            groups.setdefault(outs[0].device, []).append((s, outs))
        self._bufs = []
        for dev, members in groups.items():
            parts = [t.contiguous().reshape(-1).view(torch.uint8)
                     for _, outs in members for t in outs]
            buf = torch.cat(parts) if parts else torch.empty(
                0, dtype=torch.uint8, device=dev)
            self._bufs.append(([s for s, _ in members], buf,
                               Fence(dev, (buf,)) if fenced else None))

    def host(self) -> tuple[np.ndarray, ...]:
        stacked = [np.empty((self._n,) + shape, dtype)
                   for shape, dtype in self._layout]
        for shards, buf, fence in self._bufs:
            if fence is None:
                raw = buf.cpu().numpy()
            else:
                with fence.enter():
                    raw = buf.cpu().numpy()
            off = 0
            for s in shards:
                for j, (shape, dtype) in enumerate(self._layout):
                    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
                    stacked[j][s] = raw[off: off + nbytes].view(dtype).reshape(
                        shape)
                    off += nbytes
        return tuple(stacked)


def make_apply(mesh):
    """``(tables, wire) -> tables``: per-shard ``apply_wire``. ``wire`` is
    the host (n_shards, B, ncols) uint32 chunk of ``_route_chunks`` (ncols
    4 compact or 6 full, ``flow_table.pack_wire``)."""
    devices = shard_devices(mesh)

    def apply(tables, wire):
        w = _placed(devices, wire)
        return [ft.apply_wire(t, w[s]) for s, t in enumerate(tables)]

    return apply


def make_apply_dirty(mesh):
    """``make_apply`` fused with the per-slot dirty-bit scatter
    (incremental serving): ``(tables, dirty, wire) -> (tables, dirty)``."""
    devices = shard_devices(mesh)

    def apply(tables, dirty, wire):
        w = _placed(devices, wire)
        out = [ft.apply_wire_dirty(t, dirty[s], w[s])
               for s, t in enumerate(tables)]
        return [t for t, _ in out], [d for _, d in out]

    return apply


def make_tick_outputs(mesh, predict_fn, n_rows: int):
    """``(tables, params, floor, now, idle_seconds) -> Gathered``: the
    tick's whole read side — a full-shard predict, the scored local top
    ``n_rows`` (labels and active flags gathered on the device) and the
    bit-packed eviction mask of each shard. ``params`` holds one entry per
    shard (``mesh.replicated``). What crosses to the host is
    O(n_rows + capacity/8) per shard."""

    def tick(tables, params, floor, now, idle_seconds):
        per = []
        for s, t in enumerate(tables):
            labels = predict_fn(params[s], ft.features12(t))
            outs = ft.top_active_scored(t, labels, n_rows, floor)
            per.append((*outs, ft.stale_bits(t, now, idle_seconds)))
        return Gathered(per, fenced=True)

    return tick


def make_dirty_counts(mesh):
    """``(dirty) -> (n_shards,) int32`` per-shard dirty-row counts on the
    host: the one small fetch that picks the tick's compaction bucket (the
    largest count across shards)."""

    def counts(dirty):
        return Gathered([(ft.dirty_count(d),) for d in dirty]).host()[0]

    return counts


def make_tick_outputs_inc(mesh, predict_fn, n_rows: int):
    """The incremental read side (serving/incremental.py's dirty-set
    discipline, per shard): compact each shard's dirty rows to ``bucket``
    entries, gather exactly those rows' features, predict them, merge the
    labels into the shard's persistent label cache, and render the
    candidates from the cache — the full-shard predict's labels, because
    unchanged rows project unchanged features. Returns the ``Gathered``
    outputs of ``make_tick_outputs``; the caches take the merge and the
    dirty masks are cleared, in place. ``bucket == local_capacity``
    re-predicts every dirty row (the first tick's, and over-bucket
    churn)."""

    def tick(tables, caches, dirty, params, floor, now, idle_seconds,
             bucket: int):
        per = []
        for s, t in enumerate(tables):
            idx = ft.compact_dirty(dirty[s], bucket)
            labels = predict_fn(params[s], ft.features12_at(t, idx))
            cache = ft.merge_labels(caches[s], idx, labels)
            outs = ft.top_active_scored(t, cache, n_rows, floor)
            per.append((*outs, ft.stale_bits(t, now, idle_seconds)))
            dirty[s].zero_()
        return Gathered(per, fenced=True)

    return tick


def make_feature_sample(mesh):
    """``(tables, slots) -> (n_shards, k, 12)`` float32 host rows:
    per-shard ``features12_at`` over (n_shards, k) LOCAL slot ids padded
    with local_capacity (the scratch row, never in use: zeros). O(k) across
    the wire; the drift monitor's observation tap on the sharded spine."""
    devices = shard_devices(mesh)

    def sample(tables, slots):
        idx = _placed(devices, slots)
        return Gathered([(ft.features12_at(t, idx[s]),)
                       for s, t in enumerate(tables)]).host()[0]

    return sample


def make_clear(mesh):
    """``(tables, slots) -> tables``: per-shard ``clear_slots``; ``slots``
    is (n_shards, E) LOCAL slot ids padded with local_capacity."""
    devices = shard_devices(mesh)

    def clear(tables, slots):
        idx = _placed(devices, slots)
        return [ft.clear_slots(t, idx[s]) for s, t in enumerate(tables)]

    return clear


def make_clear_dirty(mesh):
    """``make_clear`` fused with label-cache invalidation: evicted slots'
    features drop to zero, so their cached labels must be re-predicted
    (``flow_table.clear_slots_dirty``, per shard)."""
    devices = shard_devices(mesh)

    def clear(tables, dirty, slots):
        idx = _placed(devices, slots)
        out = [ft.clear_slots_dirty(t, dirty[s], idx[s])
               for s, t in enumerate(tables)]
        return [t for t, _ in out], [d for _, d in out]

    return clear


class ShardedFlowEngine(HostSpine):
    """Host spine for the sharded table: ONE global flow index (slots
    [0, capacity_total)), shard routing by slot, per-shard device steps —
    the single-device ``FlowStateEngine`` API shape, scaled across the
    mesh (the host half is the shared ``HostSpine``).

    Global slot g lives on shard g % n_shards at local slot g // n_shards
    — round-robin, not range partitioning, because the index assigns slots
    sequentially: ranges would pile every new flow onto one shard, while
    interleaving keeps any allocation pattern balanced. A flow's whole
    lifetime stays on one shard.

    ``predict_fn(params, X)`` runs on each shard's rows with that shard's
    copy of ``params`` (``mesh.replicated``): on the card a kernel family's
    predict launches its kernel once per shard per render."""

    def __init__(self, mesh, capacity_total: int, buckets=DEFAULT_BUCKETS,
                 predict_fn=None, params=None, table_rows: int = 64,
                 native: bool = False, incremental: bool = False):
        self.mesh = mesh
        self.n_shards = _n_shards(mesh)
        if capacity_total % self.n_shards:
            raise ValueError("capacity must divide evenly across shards")
        self.devices = shard_devices(mesh)
        self.local_capacity = capacity_total // self.n_shards
        self.capacity = capacity_total
        self._init_spine(capacity_total, buckets, native)
        self.tables = make_sharded_table(mesh, capacity_total)
        self._apply = make_apply(mesh)
        self._clear = make_clear(mesh)
        # a shard cannot contribute more rows than it holds, so clamping
        # the per-shard k keeps the global top-table_rows merge exact
        self.table_rows = table_rows
        self._feature_sample = None
        # the reference statistics block of a restored serving checkpoint
        self.feature_reference = None
        # incremental serving: per-shard dirty masks fed by the apply
        # scatter, per-shard label caches, and a bucketed
        # compact-predict-merge read side; the rebuild bucket (==
        # local_capacity) doubles as the full-shard path, so the caches
        # prime on the first tick
        self.incremental = bool(incremental and predict_fn is not None)
        self.dirty = None
        self.caches = None
        if self.incremental:
            from ..serving.incremental import dirty_buckets

            self._apply_dirty = make_apply_dirty(mesh)
            self._clear_dirty = make_clear_dirty(mesh)
            self._dirty_counts = make_dirty_counts(mesh)
            self.dirty_buckets = dirty_buckets(self.local_capacity) + (
                self.local_capacity,
            )
        self._predict_fn = None
        self.params = None
        self._shard_params = None
        self._tick_outputs = None
        if predict_fn is not None:
            self.install_predict(predict_fn, params)

    @property
    def device(self) -> torch.device:
        """Shard 0's device (where the serve loop's syncs wait)."""
        return self.devices[0]

    def _all_dirty(self) -> list[torch.Tensor]:
        return [torch.ones(self.local_capacity + 1, dtype=torch.bool,
                           device=dev) for dev in self.devices]

    # -- device steps ------------------------------------------------------
    def _route_chunks(self, w: np.ndarray):
        """Yield (n_shards, B, ncols) uint32 wire chunks covering every row
        of the concatenated packed batch ``w``: rows split by owning shard
        (order-preserving, so a slot's create still precedes its update),
        rebased to local slots, and cut into ≤ buckets[-1]-row per-shard
        chunks padded (local scratch = local_capacity) to one shared
        bucket size per chunk."""
        gslot = w[:, 0] & np.uint32(0x3FFFFFFF)
        real = np.nonzero(gslot < self.capacity)[0]
        shard = (gslot[real] % np.uint32(self.n_shards)).astype(np.int64)
        # ONE stable sort by shard instead of n_shards mask passes over the
        # batch; stability keeps per-slot create-before-update order
        order = np.argsort(shard, kind="stable")
        sorted_idx = real[order]
        rows_all = w[sorted_idx]
        rows_all[:, 0] = (
            (gslot[sorted_idx] // np.uint32(self.n_shards))
            | (w[sorted_idx, 0] & np.uint32(0xC0000000))
        )
        counts = np.bincount(shard, minlength=self.n_shards)
        bounds = np.concatenate(([0], np.cumsum(counts)))
        per_shard = [rows_all[bounds[s]: bounds[s + 1]]
                     for s in range(self.n_shards)]
        cap = self.buckets[-1]
        ncols = w.shape[1]  # compact (4) or full (6) wire, preserved
        widest_total = max(r.shape[0] for r in per_shard)
        for off in range(0, max(widest_total, 1), cap):
            chunks = [r[off: off + cap] for r in per_shard]
            widest = max(c.shape[0] for c in chunks)
            B = bucket_size(max(widest, 1), self.buckets)
            out = np.empty((self.n_shards, B, ncols), np.uint32)
            # padding rows: local scratch slot, no flags
            out[:, :, 0] = np.uint32(self.local_capacity)
            out[:, :, 1:] = 0
            for s, c in enumerate(chunks):
                out[s, : c.shape[0]] = c
            yield out

    def step(self) -> bool:
        """Coalesced apply: drain EVERY pending flush batch first, then
        route and apply the union in as few per-shard scatters as possible
        (a scatter costs O(local_capacity) per shard whatever its batch
        size, so one per flush batch would pay the whole-table merge many
        times a tick at scale).

        Batches are grouped at CONFLICT boundaries
        (``batcher.last_flush_was_conflict()``: a flush that repeats a
        (slot, direction, create/update) key of its predecessor, the C++
        engine's conflict-started generations). Within a group each key
        holds at most one create and one update row, create first — the
        uniqueness precondition of ``flow_table._inverse_index`` — and the
        groups apply in order, in separate scatters, which keeps the
        reference's sequential per-line semantics.

        Native drain: ``flush_wire`` stages the wire in TWO rotating
        buffers (flush k reuses flush k-2's), so before each next flush
        every held view but the newest is copied into host memory the C++
        side never writes. ``_route_chunks`` copies every row before
        anything is handed to a device, so no staged view is read by a
        copy in flight."""
        groups: list[list[np.ndarray]] = []
        if self.native:
            pending: list[tuple[int, int]] = []  # uncopied staged views
            while len(self.batcher):
                while len(pending) > 1:
                    g, i = pending.pop(0)
                    groups[g][i] = np.array(groups[g][i])
                w = self.batcher.flush_wire()
                if w is None:
                    break
                conflict = self.batcher.last_flush_was_conflict()
                if not groups or (conflict and groups[-1]):
                    groups.append([])
                groups[-1].append(w)
                pending.append((len(groups) - 1, len(groups[-1]) - 1))
        else:
            while (batch := self.batcher.flush()) is not None:
                conflict = self.batcher.last_flush_was_conflict()
                if not groups or (conflict and groups[-1]):
                    groups.append([])
                groups[-1].append(ft.pack_wire(batch))
        if not groups:
            return False
        for packed in groups:
            if len(packed) > 1 and len({p.shape[1] for p in packed}) > 1:
                # rare mixed widths (a >2^31-counter batch among compact
                # ones): widen so the concatenation is well-formed
                packed = [ft.widen_wire(p) for p in packed]
            w = packed[0] if len(packed) == 1 else np.concatenate(packed)
            for chunk in self._route_chunks(w):
                if self.incremental:
                    self.tables, self.dirty = self._apply_dirty(
                        self.tables, self.dirty, chunk)
                else:
                    self.tables = self._apply(self.tables, chunk)
        return True

    def tick_read_dispatch(self, now: int, idle_seconds: int | None = None):
        """Flush pending updates and DISPATCH the tick's whole read side;
        returns the un-synced ``Gathered`` outputs. The pipelined serve's
        host stage calls this, and the device stage finishes it
        (``tick_read_finish``); ``tick_render`` composes both for the
        serial loop.

        ``idle_seconds=None`` computes the stale bits against an inert
        2^30 s horizon — callers that skip eviction must not act on
        them."""
        if self._tick_outputs is None:
            raise ValueError("engine built without a predict_fn")
        self.step()
        horizon = idle_seconds if idle_seconds is not None else (1 << 30)
        if self.incremental:
            outs = self._dispatch_incremental(now, horizon)
            if outs is not None:
                return outs
        return self._tick_outputs(self.tables, self._shard_params,
                                  self._tick_floor, now, horizon)

    def _dispatch_incremental(self, now: int, horizon: int):
        """The incremental read dispatch: the bucket from the per-shard
        dirty counts (the largest: one bucket serves every shard), then
        the compact-predict-merge-render step; the cache and dirty updates
        land at dispatch (host thread), so the pipelined and serial
        callers share the path. Returns None to take the plain full-shard
        read instead (the ABSORBED fault sites: that tick re-predicts
        everything and the caches rebuild at the next render — never a
        stale label as fresh)."""
        from ..utils import faults

        try:
            faults.fault_point("serve.dirty_mask")
            faults.fault_point("serve.label_cache")
        except faults.FaultInjected:
            self.dirty = self._all_dirty()
            return None
        n = int(self._dirty_counts(self.dirty).max())
        bucket = next(b for b in self.dirty_buckets if n <= b)
        return self._tick_outputs_inc(
            self.tables, self.caches, self.dirty, self._shard_params,
            self._tick_floor, now, horizon, bucket=bucket,
        )

    def tick_read_finish(self, outs) -> list[tuple]:
        """Wait for a dispatched read side and merge the per-shard
        candidates into the global top-``table_rows`` render rows — the
        device-stage half of a pipelined sharded render (no eviction:
        that stays on the host stage, which owns the index)."""
        idx, valid, score, lab, fa, ra, _bits = outs.host()
        return self._merge_candidates(idx, valid, score, lab, fa, ra)

    def _merge_candidates(self, idx, valid, score, lab, fa, ra):
        """Global render merge: the best table_rows of the n_shards ×
        table_rows candidates by (score desc, global slot asc), on the
        host."""
        cand = []
        for s in range(self.n_shards):
            for j in range(idx.shape[1]):
                if valid[s, j]:
                    cand.append((
                        float(score[s, j]),
                        int(idx[s, j]) * self.n_shards + s,
                        int(lab[s, j]), bool(fa[s, j]), bool(ra[s, j]),
                    ))
        cand.sort(key=lambda c: (-c[0], c[1]))
        return [(g, c, f, r) for _sc, g, c, f, r in cand[: self.table_rows]]

    def tick_render(self, now: int, idle_seconds: int | None):
        """One read-side dispatch for the whole mesh: returns ``(rows,
        evicted)`` where rows are the global top table_rows ``(global_slot,
        label, fwd_active, rev_active)`` merged across shards by activity
        score, and evicted is the count of idle flows released everywhere
        (after the rows were ranked, as in the JAX engine).

        ``idle_seconds=None`` disables eviction: the host discards the
        stale bits and evicted is 0."""
        if self._tick_outputs is None:
            raise ValueError("engine built without a predict_fn")
        evict = idle_seconds is not None
        outs = self.tick_read_dispatch(now, idle_seconds if evict else None)
        idx, valid, score, lab, fa, ra, bits = outs.host()
        rows = self._merge_candidates(idx, valid, score, lab, fa, ra)
        evicted = 0
        if not evict:
            return rows, evicted
        local_cap = self.local_capacity
        clear_batches = []
        for s in range(self.n_shards):
            stale = np.unpackbits(bits[s], count=local_cap + 1)[:-1]
            slots = np.nonzero(stale)[0]
            evicted += slots.size
            clear_batches.append(slots)
            (self.batcher if self.native else self.index).release_slots(
                slots * self.n_shards + s
            )
        self._clear_sharded(clear_batches)
        return rows, evicted

    def _clear_sharded(self, clear_batches) -> None:
        """Clear per-shard LOCAL slot batches in largest-bucket chunks (an
        idle storm, or a dead source's whole namespace, can mark more
        slots than the biggest padded shape holds). When incremental, the
        fused clear also raises the cleared rows' dirty bits."""
        local_cap = self.local_capacity
        E_max = max((b.size for b in clear_batches), default=0)
        step = self.buckets[-1]
        for off in range(0, E_max, step):
            chunks = [b[off: off + step] for b in clear_batches]
            widest = max(c.size for c in chunks)
            if not widest:
                break
            E = bucket_size(widest, self.buckets)
            padded = np.full((self.n_shards, E), local_cap, np.int64)
            for s, c in enumerate(chunks):
                padded[s, : c.size] = c
            if self.incremental:
                self.tables, self.dirty = self._clear_dirty(
                    self.tables, self.dirty, padded)
            else:
                self.tables = self._clear(self.tables, padded)

    def slots_for_source(self, source: int) -> np.ndarray:
        """The GLOBAL slots a source's namespace owns, on either index."""
        if self.native:
            return self.batcher.slots_for_source(source).astype(np.int64)
        return np.asarray(
            sorted(self.index.slots_for_source(source)), np.int64
        )

    def evict_source(self, source: int) -> int:
        """Release every flow owned by ``source`` across ALL shards — the
        per-source blast radius kept over shard boundaries. Flushes
        pending updates first (no in-flight record re-creates a slot being
        evicted), drops the source's partial-line tail, releases the
        GLOBAL slots in one bulk index call, then clears the rows per
        shard."""
        self.step()
        self._tails.pop(source, None)
        if self.native:
            self.batcher.reset_tail(source)
        slots = self.slots_for_source(source)
        if slots.size:
            (self.batcher if self.native else self.index).release_slots(
                slots
            )
            shard = slots % self.n_shards
            local = slots // self.n_shards
            self._clear_sharded(
                [local[shard == s] for s in range(self.n_shards)]
            )
        return int(slots.size)

    def install_predict(self, predict_fn, params):
        """Swap the serving model (the drift loop's promotion or rollback
        on the sharded spine): rebuild the read steps around the new fn,
        place its params on every shard's device, and reset the
        incremental caches all-dirty, so no label cached under the old
        model renders as fresh under the new one. Returns the previous
        ``(predict_fn, params)`` pair so the caller can retire it."""
        prev = (self._predict_fn, self.params)
        self._predict_fn = predict_fn
        self.params = params
        self._shard_params = replicated(self.mesh, params)
        n_rows = min(self.table_rows, self.local_capacity)
        self._tick_outputs = make_tick_outputs(self.mesh, predict_fn, n_rows)
        if self.incremental:
            self._tick_outputs_inc = make_tick_outputs_inc(
                self.mesh, predict_fn, n_rows)
            self.dirty = self._all_dirty()
            # labels are int32 in every family; the extra entry is the
            # scratch target of padded merges (flow_table.merge_labels)
            self.caches = [
                torch.zeros(self.local_capacity + 1, dtype=torch.int32,
                            device=dev) for dev in self.devices
            ]
        return prev

    def feature_sample(self, gslots) -> np.ndarray:
        """(len(gslots), 12) float32 feature rows of the given GLOBAL
        slots, in input order — the drift monitor's per-render observation
        tap. One fixed-shape per-shard gather (k = the render-row clamp);
        padding entries read each shard's scratch row and are dropped.
        Rows evicted between render and sample read as zeros, which the
        monitor's any-feature mask discards."""
        g = np.asarray(gslots, np.int64)
        k = min(self.table_rows, self.local_capacity)
        if g.size == 0:
            return np.zeros((0, 12), np.float32)
        if self._feature_sample is None:
            self._feature_sample = make_feature_sample(self.mesh)
        shard = g % self.n_shards
        local = g // self.n_shards
        padded = np.full((self.n_shards, k), self.local_capacity, np.int64)
        pos = np.full((self.n_shards, k), -1, np.int64)
        counts = np.zeros(self.n_shards, np.int64)
        for i in range(g.size):
            s = shard[i]
            if counts[s] >= k:
                raise ValueError(
                    f"feature_sample: >{k} slots routed to shard {s}"
                )
            padded[s, counts[s]] = local[i]
            pos[s, counts[s]] = i
            counts[s] += 1
        X = self._feature_sample(self.tables, padded)
        out = np.zeros((g.size, 12), np.float32)
        for s in range(self.n_shards):
            m = int(counts[s])
            if m:
                out[pos[s, :m]] = X[s, :m]
        return out

    def warmup_incremental(self) -> list[str]:
        """Run the incremental read step once at EVERY dirty bucket, on
        scratch state (serving/warmup.py's sharded branch): one
        ``tick_read_dispatch`` reaches only the bucket the current dirty
        counts select, and each bucket's first run loads what its launches
        need."""
        if not self.incremental:
            return []
        warmed = []
        scratch_t = make_sharded_table(self.mesh, self.capacity)
        scratch_c = [c.clone() for c in self.caches]
        for b in self.dirty_buckets:
            self._tick_outputs_inc(
                scratch_t, scratch_c, self._all_dirty(), self._shard_params,
                0, 0, 1 << 30, bucket=b,
            ).host()
            warmed.append(f"sharded.dirty[{b}]")
        return warmed

    def warmup_scatter(self) -> list[str]:
        """Run the write-side scatter once at EVERY wire bucket a tick can
        plausibly fill (≤ two records per tracked flow per shard), on
        scratch state: all-padding chunks (slot == local_capacity) are a
        clean no-op."""
        warmed = []
        limit = bucket_size(
            min(2 * self.local_capacity, self.buckets[-1]), self.buckets
        )
        scratch_t = make_sharded_table(self.mesh, self.capacity)
        scratch_d = self._all_dirty() if self.incremental else None
        for b in self.buckets:
            if b > limit:
                break
            chunk = np.zeros((self.n_shards, b, 4), np.uint32)
            chunk[:, :, 0] = np.uint32(self.local_capacity)
            if self.incremental:
                scratch_t, scratch_d = self._apply_dirty(
                    scratch_t, scratch_d, chunk)
                warmed.append(f"sharded.apply_dirty[{b}]")
            else:
                scratch_t = self._apply(scratch_t, chunk)
                warmed.append(f"sharded.apply[{b}]")
        Gathered([(t.in_use,) for t in scratch_t]).host()
        return warmed

    def slot_metadata(self, slots):
        return self._slot_meta_for(slots)

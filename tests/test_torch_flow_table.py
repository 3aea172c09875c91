"""Flow-table parity: the torch port against the JAX reference, bitwise.

The same wire batches (built with numpy from a seed, or by both
packages' batchers from the same records) go through
``traffic_classifier_sdn_tpu.core.flow_table.apply_wire`` and the port's
``apply_wire``; every table field and the 12-feature matrix must agree
bit for bit. The port holds the uint32 ``*_lo`` lanes as int32 bit
patterns, so lanes are compared as raw 32-bit patterns.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from traffic_classifier_sdn_tpu.core import flow_table as jft
from traffic_classifier_sdn_tpu.ingest import batcher as jbatcher
from traffic_classifier_sdn_tpu.ingest.protocol import TelemetryRecord as JRec
from traffic_classifier_sdn_tpu_torch.core import flow_table as tft
from traffic_classifier_sdn_tpu_torch.ingest import batcher as tbatcher
from traffic_classifier_sdn_tpu_torch.ingest.protocol import (
    TelemetryRecord as TRec,
)

DIR_FIELDS = [f.name for f in dataclasses.fields(tft.DirState)]


def _bits(a) -> np.ndarray:
    """Raw 32-bit patterns (bools as uint8) of a JAX array or tensor."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.uint8) if a.dtype == bool else a.view(np.uint32)


def assert_tables_equal(jt, tt) -> None:
    for name in ("time_start", "in_use"):
        np.testing.assert_array_equal(
            _bits(getattr(jt, name)), _bits(getattr(tt, name)), err_msg=name
        )
    for d in ("fwd", "rev"):
        for name in DIR_FIELDS:
            np.testing.assert_array_equal(
                _bits(getattr(getattr(jt, d), name)),
                _bits(getattr(getattr(tt, d), name)),
                err_msg=f"{d}.{name}",
            )
    np.testing.assert_array_equal(
        _bits(jft.features12(jt)), _bits(tft.features12(tt)),
        err_msg="features12",
    )


def _apply_both(jt, tt, w):
    return (
        jft.apply_wire(jt, jnp.asarray(w)),
        tft.apply_wire(tt, tft.wire_tensor(w, "cpu")),
    )


def random_batch(rng, capacity: int, B: int, t: int,
                 big: bool) -> jft.UpdateBatch:
    """A padded batch obeying the batcher's uniqueness rules: at most one
    create per slot and one update per (slot, direction). ``big`` draws
    counters past 2^31 and 2^32 (full wire, counter wraps)."""
    slots = rng.permutation(capacity)
    n_c, n_f, n_r = (rng.randint(0, capacity // 3 + 1) for _ in range(3))
    c_slots = slots[:n_c]
    f_slots = rng.choice(capacity, n_f, replace=False)
    r_slots = rng.choice(capacity, n_r, replace=False)
    rows = (
        [(s, True, True) for s in c_slots]
        + [(s, True, False) for s in f_slots]
        + [(s, False, False) for s in r_slots]
    )
    slot = np.full(B, capacity, np.int32)
    time = np.zeros(B, np.int32)
    cnt = np.zeros((2, B), np.int64)
    is_fwd = np.ones(B, bool)
    is_create = np.zeros(B, bool)
    hi = (1 << 40) if big else (1 << 30)
    for i, (s, fwd, cr) in enumerate(rows):
        slot[i], is_fwd[i], is_create[i] = s, fwd, cr
        time[i] = t + rng.randint(0, 2)
        cnt[:, i] = rng.randint(0, hi, 2)
    u32 = np.uint64(0xFFFFFFFF)
    return jft.UpdateBatch(
        slot=slot, time=time,
        pkts_lo=(cnt[0].astype(np.uint64) & u32).astype(np.uint32),
        pkts_f=cnt[0].astype(np.float32),
        bytes_lo=(cnt[1].astype(np.uint64) & u32).astype(np.uint32),
        bytes_f=cnt[1].astype(np.float32),
        is_fwd=is_fwd, is_create=is_create,
    )


@pytest.mark.parametrize("seed", range(6))
def test_random_wire_sequences_bitwise(seed):
    """Random create/update sequences, compact and full wires, with scratch
    padding in every batch and a clear in the middle."""
    rng = np.random.RandomState(seed)
    capacity, B = 48, 64
    jt, tt = jft.make_table(capacity), tft.make_table(capacity, "cpu")
    for step in range(8):
        b = random_batch(rng, capacity, B, 10 + 3 * step, big=bool(step % 2))
        w_j = jft.pack_wire(b)
        w_t = tft.pack_wire(tft.UpdateBatch(**dataclasses.asdict(b)))
        assert w_j.shape == w_t.shape and w_j.tobytes() == w_t.tobytes()
        jt, tt = _apply_both(jt, tt, w_j)
        assert_tables_equal(jt, tt)
        if step == 4:
            clear = np.full(16, capacity, np.int32)
            clear[:5] = rng.choice(capacity, 5, replace=False)
            jt = jft.clear_slots(jt, jnp.asarray(clear))
            tt = tft.clear_slots(tt, torch.from_numpy(clear))
            assert_tables_equal(jt, tt)


def _rec(cls, t, src, dst, pkts, byts, dp="1"):
    return cls(time=t, datapath=dp, in_port="1", eth_src=src, eth_dst=dst,
               out_port="2", packets=pkts, bytes=byts)


# (time, src, dst, packets, bytes) per tick. Covers: create then a
# same-tick update of one flow; a reverse direction folding onto the
# forward flow's slot; a byte counter wrapping past 2^32; a counter reset;
# counters >= 2^31 (full wire); a third same-direction record in one tick
# (forces a mid-tick flush).
TICKS = [
    [(1, "a", "b", 10, 1000), (1, "b", "a", 5, 400), (1, "c", "d", 3, 300),
     (1, "c", "d", 7, 700)],
    [(2, "a", "b", 20, 2000), (2, "b", "a", 5, 400),
     (2, "e", "f", 1, (1 << 32) - 100)],
    [(3, "a", "b", 30, 2500), (3, "e", "f", 2, (1 << 32) + 400),
     (3, "d", "c", 9, 900)],
    [(4, "a", "b", 4, 100), (4, "e", "f", 3, (1 << 32) + 900),
     (4, "g", "h", (1 << 31) + 5, (1 << 33) + 7)],
    [(6, "g", "h", (1 << 31) + 9, (1 << 33) + 99), (6, "a", "b", 8, 300),
     (6, "a", "b", 9, 400), (6, "a", "b", 10, 500)],
]


def test_engine_sequence_bitwise():
    """Both packages' Python batchers and engines over the same records,
    with tiny buckets so batches split and pad: identical wires, identical
    tables after every tick, identical slots, identical eviction."""
    buckets = (4, 8)
    je = jbatcher.FlowStateEngine(12, buckets=buckets, native=False)
    te = tbatcher.FlowStateEngine(12, buckets=buckets, device="cpu")
    wires = {"jax": [], "torch": []}
    j_apply, t_apply = je._apply_wire, te._apply_wire
    je._apply_wire = lambda w: (wires["jax"].append(w.copy()), j_apply(w))
    te._apply_wire = lambda w: (wires["torch"].append(w.copy()), t_apply(w))
    saw_full = False
    for tick in TICKS:
        je.mark_tick()
        te.mark_tick()
        je.ingest([_rec(JRec, *r) for r in tick])
        te.ingest([_rec(TRec, *r) for r in tick])
        je.step()
        te.step()
        assert_tables_equal(je.table, te.table)
        assert je.index.slot_meta == te.index.slot_meta
    assert len(wires["jax"]) == len(wires["torch"]) > len(TICKS)
    for wj, wt in zip(wires["jax"], wires["torch"]):
        assert wj.tobytes() == wt.tobytes()
        saw_full |= wj.shape[1] == 6
    assert saw_full
    # flows idle for >= 2 s at t=6 are evicted on both sides
    np.testing.assert_array_equal(je.stale_slots(6, 2), te.stale_slots(6, 2))
    assert je.evict_idle(6, 2) == te.evict_idle(6, 2) > 0
    assert_tables_equal(je.table, te.table)
    assert je.index.free == te.index.free


def test_wire_widen_roundtrip_bitwise():
    rng = np.random.RandomState(3)
    b = random_batch(rng, 40, 32, 5, big=False)
    w = tft.pack_wire(tft.UpdateBatch(**dataclasses.asdict(b)))
    assert w.shape[1] == 4
    wide = tft.widen_wire(w)
    assert wide.tobytes() == jft.widen_wire(w).tobytes()
    jt, tt = _apply_both(jft.make_table(40), tft.make_table(40, "cpu"), w)
    _, tw = _apply_both(jft.make_table(40), tft.make_table(40, "cpu"), wide)
    assert_tables_equal(jt, tt)
    assert_tables_equal(jt, tw)


def test_pack_wire_rejects_flag_bit_slots():
    b = tft.UpdateBatch(
        slot=np.array([1 << 30], np.int32), time=np.zeros(1, np.int32),
        pkts_lo=np.zeros(1, np.uint32), pkts_f=np.zeros(1, np.float32),
        bytes_lo=np.zeros(1, np.uint32), bytes_f=np.zeros(1, np.float32),
        is_fwd=np.ones(1, bool), is_create=np.ones(1, bool),
    )
    with pytest.raises(ValueError, match="2\\^30"):
        tft.pack_wire(b)


def _tie_table(capacity: int):
    """Slots with equal activity scores (and stale and unused slots) in
    both packages: one create batch, then an update batch whose byte
    deltas repeat."""
    rng = np.random.RandomState(7)
    slots = np.arange(capacity - 4, dtype=np.int32)  # last 4 stay unused
    n = slots.size
    u32 = np.uint32
    create = jft.UpdateBatch(
        slot=slots, time=np.full(n, 1, np.int32),
        pkts_lo=np.full(n, 10, u32), pkts_f=np.full(n, 10, np.float32),
        bytes_lo=np.full(n, 100, u32), bytes_f=np.full(n, 100, np.float32),
        is_fwd=np.ones(n, bool), is_create=np.ones(n, bool),
    )
    upd = slots[rng.rand(n) < 0.7]  # the rest go stale
    delta = rng.choice([0, 50, 50, 200], upd.size)
    update = jft.UpdateBatch(
        slot=upd, time=np.full(upd.size, 2, np.int32),
        pkts_lo=np.full(upd.size, 20, u32),
        pkts_f=np.full(upd.size, 20, np.float32),
        bytes_lo=(100 + delta).astype(u32),
        bytes_f=(100 + delta).astype(np.float32),
        is_fwd=np.ones(upd.size, bool), is_create=np.zeros(upd.size, bool),
    )
    jt, tt = jft.make_table(capacity), tft.make_table(capacity, "cpu")
    for b in (create, update):
        jt, tt = _apply_both(jt, tt, jft.pack_wire(b))
    return jt, tt


@pytest.mark.parametrize("n", [1, 7, 40, 64])
def test_top_active_render_ties_to_lowest_slot(n):
    capacity = 64
    jt, tt = _tie_table(capacity)
    labels = np.arange(capacity, dtype=np.int32) % 6
    j = jft.top_active_render(jt, jnp.asarray(labels), n, np.int32(1))
    t = tft.top_active_render(tt, torch.from_numpy(labels), n, 1)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    idx = t[0].numpy()
    score = tft._activity_score(tt, 1).numpy()[idx]
    # descending score; equal scores in ascending slot order
    for i in range(len(idx) - 1):
        assert score[i] > score[i + 1] or (
            score[i] == score[i + 1] and idx[i] < idx[i + 1]
        )


def test_stale_mask_matches():
    jt, tt = _tie_table(32)
    np.testing.assert_array_equal(
        np.asarray(jft.stale_mask(jt, np.int32(5), np.int32(3))),
        tft.stale_mask(tt, 5, 3).numpy(),
    )

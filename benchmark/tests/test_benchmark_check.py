"""The top-k comparison on hand-made records: what counts as a row that
differs."""

from __future__ import annotations

import numpy as np

from harness import check


def _lists(n, k=2):
    sims = np.arange(n * k, dtype=np.float32).reshape(n, k)
    idx = np.arange(n * k, dtype=np.int64).reshape(n, k)
    return sims, idx


def _rec(b, s, n, sims, idx, pad=0):
    slots = np.concatenate([np.arange(s * n, (s + 1) * n),
                            np.full(pad, 10 ** 6)])
    padded = lambda a: np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
    return (b, slots, padded(sims), padded(idx))


def test_equal_lists_count_nothing_and_padding_is_ignored():
    n = 4
    ref = _lists(n)
    recs = {1: _rec(9, 1, n, *ref, pad=3)}
    assert check.topk_rows(recs, {1: (9, 1)}, lambda key: ref, n) == 0


def test_one_bit_of_a_similarity_or_one_index_counts_its_row():
    n = 4
    sims, idx = _lists(n)
    bad_sims = sims.copy()
    bad_sims[2, 1] = np.nextafter(bad_sims[2, 1], np.float32(np.inf))
    bad_idx = idx.copy()
    bad_idx[0, 0] += 1
    recs = {0: _rec(5, 0, n, bad_sims, bad_idx)}
    assert check.topk_rows(recs, {0: (5, 0)}, lambda key: (sims, idx), n) == 2


def test_missing_stale_and_partial_records_count_their_rows():
    n = 4
    ref = _lists(n)
    partial = _rec(7, 1, n, *ref)
    partial = (7, partial[1][:3], partial[2][:3], partial[3][:3])
    recs = {0: _rec(3, 0, n, *ref), 1: partial}
    expected = {0: (4, 0), 1: (7, 1), 2: (8, 2)}
    # switch 0 holds an older burst, switch 1 misses a row, switch 2 nothing
    assert check.topk_rows(recs, expected, lambda key: ref, n) == n + 1 + n


def test_newest_bursts_of_each_switch():
    from harness.traffic import TrafficSpec

    spec = TrafficSpec({"name": "t", "loop": "closed", "switches": 3,
                        "conversations_per_switch": 2, "start_time": 0,
                        "poll_seconds": 1, "classes": [], "queue_depth": 1})
    assert check.newest_bursts(spec, 7) == {0: (6, 0), 1: (7, 1), 2: (5, 2)}
    assert check.newest_bursts(spec, 1) == {0: (0, 0), 1: (1, 1)}


def test_the_recorder_keeps_each_burst_while_the_device_stage_lags():
    """Two bursts of one switch dispatched before the device stage predicts
    either (a coalesced render commits its predict later): both outputs
    are kept, a predict of rows no burst dispatched drops nothing, and an
    expectation older than a seen predict is dropped."""
    import torch

    from families.knn import Recorder

    rec = Recorder(switches=2, capacity=8, watched=[1, 3])
    X1, X3, X5, other = (torch.zeros(2, 12) for _ in range(4))
    slots = torch.tensor([4, 5])
    rec.expect(X1, slots, 1)
    rec.expect(X3, slots, 3)
    rec._seen(other, torch.zeros(2, 5), torch.zeros(2, 5, dtype=torch.int64))
    rec._seen(X1, torch.ones(2, 5), torch.ones(2, 5, dtype=torch.int64))
    rec.expect(X5, slots, 5)
    rec._seen(X3, torch.full((2, 5), 3.0), torch.full((2, 5), 3))
    out = rec.outputs()
    assert sorted(out["watched"]) == [1, 3]
    assert out["watched"][1][2][0, 0] == 1.0 and out["watched"][3][2][0, 0] == 3.0
    assert out["latest"][1][0] == 3
    rec._seen(X5, torch.full((2, 5), 5.0), torch.full((2, 5), 5))
    assert rec.outputs()["latest"][1][0] == 5 and not rec._expect

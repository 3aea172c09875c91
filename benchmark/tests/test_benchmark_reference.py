"""The plain reference against flows worked by hand, a forest walked by
hand and a brute-force top-5."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from reference import flows
from reference.forest import Forest
from reference.knn import Knn, total_order_key


def test_flow_features_by_hand():
    # one conversation; columns: fwd pkts, fwd bytes, rev pkts, rev bytes
    c0 = np.array([[10, 1000, 4, 400]])
    c1 = np.array([[13, 1300, 6, 650]])
    c2 = np.array([[17, 1900, 9, 700]])
    st0 = flows.switch_state(c0, None, 0, 1)
    # the forward line creates the flow; the reverse line updates it
    assert st0["X"][0].tolist() == [0, 0, 0, 0, 0, 0, 4, 400, 0, 0, 0, 0]
    assert st0["fwd_active"][0] and st0["rev_active"][0]
    st2 = flows.switch_state(c2, c1, 2, 1)
    want = [4, 600, 4, 17 / 2, 600, 1900 / 2, 3, 50, 3, 9 / 2, 50, 700 / 2]
    assert st2["X"][0].tolist() == pytest.approx(want)
    assert st2["X"].dtype == np.float32
    assert st2["score"][0] == 650
    st5 = flows.switch_state(c2, c1, 2, 5)  # 5 s polls
    assert st5["X"][0, 2] == np.float32(4) / np.float32(5)
    assert st5["X"][0, 3] == np.float32(17) / np.float32(10)


def test_float32_rounding_is_one_division():
    cum = np.array([[16777217, 3, 1, 1]])
    prev = np.array([[0, 1, 0, 0]])
    st = flows.switch_state(cum, prev, 3, 1)
    assert st["X"][0, 3] == np.float32(np.float32(16777217) / np.float32(3))


def test_counters_past_2_31_are_refused():
    with pytest.raises(ValueError):
        flows.switch_state(np.array([[2 ** 31, 1, 1, 1]]),
                           np.array([[1, 1, 1, 1]]), 1, 1)


def test_frame_ranking_by_hand():
    n = 4
    rounds = np.array([2, 2])
    states = {0: {"score": np.array([5, 9, 9, 1], np.float32)},
              1: {"score": np.array([7, 7, 7, 7], np.float32)}}
    fresh = np.array([True, False])
    assert flows.frame(states, rounds, fresh, n, 3) == [(1, 0), (2, 0), (0, 0)]
    assert flows.frame(states, rounds, fresh, n, 6) == [
        (1, 0), (2, 0), (0, 0), (3, 0), (4, 1), (5, 1)]
    stale = np.array([False, False])
    assert flows.frame(states, rounds, stale, n, 2) == [(0, 0), (1, 0)]
    assert flows.frame_switches(rounds, fresh, n, 6) == [0, 1]
    assert flows.frame_switches(rounds, stale, n, 3) == [0]
    assert flows.freshness(rounds, lambda k: 100 + k, 100).tolist() == [True, True]
    assert flows.freshness(rounds, lambda k: 100 + k, 101).tolist() == [False, False]


def test_forest_walk_by_hand():
    # tree 0: x0 <= 1.5 ? leaf A (class 0) : (x1 <= 0.5 ? B (1) : C (2))
    t0 = {"left": np.array([1, -1, 3, -1, -1]),
          "right": np.array([2, -1, 4, -1, -1]),
          "feature": np.array([0, -2, 1, -2, -2]),
          "threshold": np.array([1.5, -2, 0.5, -2, -2]),
          "values": np.array([[0, 0, 0], [3, 0, 0], [0, 0, 0], [0, 2, 0],
                              [0, 0, 5]], float)}
    # tree 1: a single split on x1 <= 0.25: class 2 : class 1
    t1 = {"left": np.array([1, -1, -1]), "right": np.array([2, -1, -1]),
          "feature": np.array([1, -2, -2]),
          "threshold": np.array([0.25, -2, -2]),
          "values": np.array([[0, 0, 0], [0, 0, 1], [0, 1, 0]], float)}
    f = Forest([t0, t1], ["a", "b", "c"])
    X = torch.tensor([[1.0, 0.0], [2.0, 0.0], [2.0, 1.0], [1.5, 0.3]])
    labels, visits = f.predict(X)
    # row 0: A + class 2 tie -> class 0; row 1: B + 2 -> tie 1/2 -> 1;
    # row 2: C + 1 -> tie 1/2 -> 1; row 3: A (1.5 <= 1.5) + 1 -> 0
    assert labels.tolist() == [0, 1, 1, 0]
    assert visits == (1 + 1) + (2 + 1) + (2 + 1) + (1 + 1)
    assert f.internal_nodes == 3 and f.leaves == 5
    # the threshold is compared in float64: x32 just above a f64 midpoint
    t2 = dict(t1, threshold=np.array([float(np.float32(0.1)) - 1e-12, -2, -2]))
    g = Forest([t2], ["a", "b", "c"])
    lab, _ = g.predict(torch.tensor([[0.0, 0.1]]))
    assert lab.tolist() == [1]


def test_knn_matches_a_brute_force_top5():
    rng = np.random.default_rng(0)
    fit = rng.integers(0, 50, (300, 12)).astype(np.float32) * 3.0
    y = rng.integers(0, 6, 300)
    X = rng.integers(0, 50, (64, 12)).astype(np.float32) * 3.0 + 1.0
    knn = Knn(fit, y, 5, list("abcdef"))
    got = knn.neighbours(torch.from_numpy(X)).numpy()
    d = ((X[:, None, :].astype(np.float64) - fit[None].astype(np.float64)) ** 2).sum(-1)
    want = np.argsort(d, axis=1, kind="stable")[:, :5]
    assert (got == want).all()
    labels, _ = knn.predict(torch.from_numpy(X))
    votes = np.stack([np.bincount(y[w], minlength=6) for w in want])
    assert labels.numpy().tolist() == votes.argmax(1).tolist()


def test_knn_ties_go_to_the_lower_index_and_the_lower_class():
    fit = np.array([[1, 1], [0, 0], [1, 1], [0, 0], [5, 5], [1, 1]], np.float32)
    y = np.array([2, 1, 2, 1, 0, 0])
    knn = Knn(fit, y, 4, ["a", "b", "c"])
    got = knn.neighbours(torch.tensor([[1.0, 1.0]])).tolist()
    assert got == [[0, 2, 5, 1]]
    lab, _ = Knn(fit, y, 2, ["a", "b", "c"]).predict(torch.tensor([[0.0, 0.0]]))
    assert lab.tolist() == [1]
    # a 2-2 vote goes to the lower class
    lab, _ = knn.predict(torch.tensor([[0.5, 0.5]]))
    votes = np.bincount(y[knn.neighbours(torch.tensor([[0.5, 0.5]]))[0].numpy()],
                        minlength=3)
    assert lab.item() == int(np.argmax(votes))


def test_total_order_key():
    x = torch.tensor([-2.0, -0.0, 0.0, 1.0, float("inf")])
    k = total_order_key(x)
    assert (k[1:] > k[:-1]).all()


def test_bfloat16_control_rounds_the_features():
    cum = np.array([[1001, 100003, 7, 70001]])
    prev = np.array([[1, 3, 1, 1]])
    from harness.check import bf16

    low = flows.switch_state(cum, prev, 3, 1, bf16)["X"]
    high = flows.switch_state(cum, prev, 3, 1)["X"]
    assert (low != high).any()
    assert (bf16(low) == low).all()

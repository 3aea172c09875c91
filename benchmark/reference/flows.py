"""Plain reference of the flow state, the 12 features and the rendered
table, worked out from the traffic generator's own counters.

It follows the reference classifier's per-line flow update
(traffic_classifier.py:60-90 of the upstream project; the port's
``core/flow_table.py`` states the same rules): a conversation's first
line creates its flow with the forward counters, the reverse line of the
same poll updates the reverse direction, and from then on every poll
updates both. Per direction, after an update at time t:

- delta = counter - previous counter (exact integers);
- instantaneous rate = delta / (t - previous update time), kept when that
  gap is 0;
- average rate = counter / (t - flow start), kept when that age is 0;
- active = delta packets != 0 and delta bytes != 0.

Everything is float32, as the configurations state: each integer is
rounded to float32 once, and each quotient is one float32 division. The
render ranks flows by |forward delta bytes| + |reverse delta bytes| among
flows with telemetry newer than the freshness floor (the newest time
stamp before the burst), then every other flow in slot order, and shows
the first ``n``. Slots are given in first-seen order, so conversation c of
switch s holds slot ``s * conversations + c``.

It imports nothing of the program under test."""

from __future__ import annotations

import numpy as np

FP, FB, RP, RB = range(4)
COUNTER_LIMIT = 1 << 31  # counters below it cross as exact 32-bit lanes
STATUS = ("INACTIVE", "ACTIVE")


def _same(a: np.ndarray) -> np.ndarray:
    return a


def direction(cum: np.ndarray, prev: np.ndarray | None, rnd: int,
              poll_seconds: int, forward: bool, q=_same):
    """One direction of every conversation of a switch after its poll
    round ``rnd`` (or, for rows of different ages, an (N,) array of rounds
    of at least 1): ((N, 6) float32 features in the order delta packets,
    delta bytes, packets/s, average packets/s, bytes/s, average bytes/s;
    (N,) active; (N,) delta bytes as integers). ``q`` rounds each float32
    result to a lower working precision (the control); by default every
    value stays float32."""
    p, b = (FP, FB) if forward else (RP, RB)
    if int(cum.max(initial=0)) >= COUNTER_LIMIT:
        raise ValueError("counters reached 2^31: outside what this reference states")
    n = cum.shape[0]
    f32 = np.float32
    out = np.zeros((n, 6), f32)
    if np.ndim(rnd) == 0 and rnd == 0 and forward:
        # the flow is created by this line: counters set, nothing derived
        return out, np.ones(n, bool), np.zeros(n, np.int64)
    base = prev if np.ndim(rnd) or rnd > 0 else np.zeros_like(cum)
    dp = cum[:, p] - base[:, p]
    db = cum[:, b] - base[:, b]
    out[:, 0] = q(dp.astype(f32))
    out[:, 1] = q(db.astype(f32))
    if np.ndim(rnd) or rnd > 0:
        gap = q(np.full(n, poll_seconds, f32))
        age = q(np.broadcast_to(np.asarray(rnd) * poll_seconds, (n,)).astype(f32))
        out[:, 2] = q(out[:, 0] / gap)
        out[:, 3] = q(q(cum[:, p].astype(f32)) / age)
        out[:, 4] = q(out[:, 1] / gap)
        out[:, 5] = q(q(cum[:, b].astype(f32)) / age)
    return out, (dp != 0) & (db != 0), db


def switch_state(cum: np.ndarray, prev: np.ndarray | None, rnd: int,
                 poll_seconds: int, q=_same) -> dict:
    """Features (N, 12), active flags and activity scores of a switch's
    conversations after round ``rnd``."""
    f, fa, fdb = direction(cum, prev, rnd, poll_seconds, True, q)
    r, ra, rdb = direction(cum, prev, rnd, poll_seconds, False, q)
    score = q(q(np.abs(fdb.astype(np.float32)))
              + q(np.abs(rdb.astype(np.float32))))
    return {"X": np.concatenate([f, r], 1), "fwd_active": fa,
            "rev_active": ra, "score": score}


def table_features(state_of, rounds: np.ndarray, n: int, poll_seconds: int,
                   q=_same) -> np.ndarray:
    """(switches * n, 12) features of the whole table. ``state_of(s, k)``
    gives switch s's counters after round k; ``rounds[s]`` is how many
    rounds switch s reported (0: its slots are empty, all zeros)."""
    X = np.zeros((len(rounds) * n, 12), np.float32)
    for s, k in enumerate(int(r) - 1 for r in rounds):
        if k < 0:
            continue
        prev = state_of(s, k - 1) if k > 0 else None
        X[s * n:(s + 1) * n] = switch_state(state_of(s, k), prev, k,
                                            poll_seconds, q)["X"]
    return X


def freshness(rounds: np.ndarray, time_of, floor: int) -> np.ndarray:
    """(switches,) bool: the switch's newest time stamp is above ``floor``."""
    return np.array([r > 0 and time_of(int(r) - 1) > floor for r in rounds])


def frame_switches(rounds: np.ndarray, fresh: np.ndarray, n_conv: int,
                   rows: int) -> list[int]:
    """The switches whose conversations a frame of ``rows`` rows can show:
    every fresh one, and the non-fresh ones in slot order until they hold
    ``rows`` flows."""
    out = [s for s in range(len(rounds)) if fresh[s]]
    held = 0
    for s in range(len(rounds)):
        if held >= rows:
            break
        if rounds[s] > 0 and not fresh[s]:
            out.append(s)
            held += n_conv
    return sorted(out)


def frame(states: dict, rounds: np.ndarray, fresh: np.ndarray, n_conv: int,
          rows: int) -> list[tuple[int, int]]:
    """The (slot, switch) pairs a frame shows, in order: fresh flows by
    activity score (descending, then slot), then the other flows in use by
    slot. ``states[s]`` is ``switch_state`` of each switch the frame can
    show."""
    fresh_slots, fresh_scores = [], []
    for s in range(len(rounds)):
        if fresh[s]:
            fresh_slots.append(s * n_conv + np.arange(n_conv))
            fresh_scores.append(states[s]["score"])
    out: list[tuple[int, int]] = []
    if fresh_slots:
        slots = np.concatenate(fresh_slots)
        score = np.concatenate(fresh_scores)
        order = np.lexsort((slots, -score.astype(np.float64)))[:rows]
        out = [(int(slots[i]), int(slots[i]) // n_conv) for i in order]
    for s in range(len(rounds)):
        if len(out) >= rows:
            break
        if rounds[s] > 0 and not fresh[s]:
            take = min(rows - len(out), n_conv)
            out += [(s * n_conv + c, s) for c in range(take)]
    return out[:rows]

"""The generator: counters that rise in every poll, exact class shares,
lines in the monitor protocol that the port's parser reads back."""

from __future__ import annotations

import numpy as np
import pytest

from harness import linegen, traffic as T

SHAPES = [{"name": n, "share": s, "pkts_shape": 4.0, "pkts_scale": 2.0 * 4 ** c,
           "bytes_per_pkt": 40.0 + 10 * c, "rev_share": 0.5}
          for c, (n, s) in enumerate([("dns", 1.0), ("game", 1.0), ("ping", 2.0),
                                      ("quake", 1.0), ("telnet", 1.0),
                                      ("voice", 1.0)])]


def spec(switches=3, n=50):
    return T.TrafficSpec({"name": "t", "loop": "closed", "switches": switches,
                          "conversations_per_switch": n,
                          "start_time": 1700000000, "poll_seconds": 1,
                          "queue_depth": 1, "classes": SHAPES})


def parse(payload: bytes):
    lines = payload.decode().splitlines()
    return [line.split("\t") for line in lines]


def test_counters_rise_in_every_poll_and_every_conversation_reports():
    sp = spec()
    g = T.Generator(sp, 2 ** 31 + 99)
    prev = {}
    for b in range(sp.switches * 5):
        rows = parse(g.burst(b))
        s, k = T.burst_switch_round(sp, b)
        assert len(rows) == 2 * sp.conversations
        assert {r[0] for r in rows} == {"data"}
        assert {int(r[1]) for r in rows} == {sp.time_of(k)}
        assert {r[2] for r in rows} == {str(s + 1)}
        cnt = np.array([[int(r[7]), int(r[8])] for r in rows]).reshape(-1, 4)
        if s in prev:
            assert (cnt > prev[s]).all()
        prev[s] = cnt
        assert (cnt == g.state(s, k)).all()


def test_class_shares_are_exact_per_switch():
    sp = spec(switches=2, n=700)
    g = T.Generator(sp, 5)
    for s in range(2):
        counts = np.bincount(g.cls[s], minlength=6)
        assert counts.tolist() == [100, 100, 200, 100, 100, 100]
    assert not (g.cls[0] == g.cls[1]).all()  # placed by the seed
    assert T.class_counts([1, 1, 1], 10).tolist() == [4, 3, 3]


def test_class_shapes_reach_the_deltas():
    sp = spec(switches=1, n=6000)
    g = T.Generator(sp, 3)
    g.burst(0)
    g.burst(1)
    d = g.state(0, 1) - g.state(0, 0)
    assert (d >= 1).all()
    for c, shape in enumerate(T.class_shapes(SHAPES)):
        fp = d[g.cls[0] == c, T.FP]
        assert fp.mean() == pytest.approx(4.0 * 2.0 * 4 ** c, rel=0.1)
        fb = d[g.cls[0] == c, T.FB]
        assert np.abs(fb - np.round(fp * shape.bytes_per_pkt)).max() == 0


def test_same_seed_same_bytes():
    a, b = T.Generator(spec(), 11), T.Generator(spec(), 11)
    c = T.Generator(spec(), 12)
    out = [(a.burst(i), b.burst(i), c.burst(i)) for i in range(4)]
    assert all(x == y for x, y, _ in out)
    assert any(x != z for x, _, z in out)


def test_macs_and_line_layout():
    assert T.mac_text(3, 258, 1) == "02:03:00:01:02:01"
    m = T.mac_strings(3, 300, 1)
    assert m[258].tobytes().decode() == T.mac_text(3, 258, 1)
    sp = spec(switches=1, n=4)
    rows = parse(T.Generator(sp, 1).burst(0))
    assert rows[0][3:7] == ["1", T.mac_text(0, 0, 0), T.mac_text(0, 0, 1), "2"]
    assert rows[1][3:7] == ["2", T.mac_text(0, 0, 1), T.mac_text(0, 0, 0), "1"]


def test_formatter_matches_python_formatting():
    rng = np.random.default_rng(0)
    mid = rng.integers(33, 126, (40, 7)).astype(np.uint8)
    cum = rng.integers(0, 2 ** 62, (20, 4))
    cum[0] = [0, 9, 10, 99]
    want = b"".join(
        b"data\t7\t" + mid[2 * i + r].tobytes()
        + f"{cum[i, 2 * r]}\t{cum[i, 2 * r + 1]}\n".encode()
        for i in range(20) for r in (0, 1))
    assert linegen.format_lines(b"data\t7\t", mid, cum) == want
    scratch = np.zeros(10, np.uint8)  # too small: a buffer of its own
    assert linegen.format_lines(b"data\t7\t", mid, cum, scratch) == want
    with pytest.raises(ValueError):
        linegen.format_lines(b"x", mid, -cum)
    with pytest.raises(ValueError):
        linegen.format_lines(b"x", mid[:5], cum)


def test_the_ports_parser_reads_every_line():
    from traffic_classifier_sdn_tpu_torch.ingest.protocol import parse_line

    sp = spec(switches=2, n=20)
    g = T.Generator(sp, 4)
    for b in range(4):
        payload = g.burst(b)
        s, k = T.burst_switch_round(sp, b)
        recs = [parse_line(x + b"\n") for x in payload.split(b"\n")[:-1]]
        assert all(r is not None for r in recs)
        cum = g.state(s, k)
        assert [r.packets for r in recs[0::2]] == cum[:, T.FP].tolist()
        assert [r.bytes for r in recs[1::2]] == cum[:, T.RB].tolist()


def test_feeder_hands_bursts_in_order_and_stops():
    sp = spec()
    f = T.Feeder(T.Generator(sp, 1), 2).start()
    try:
        assert [f.get()[0] for _ in range(7)] == list(range(7))
    finally:
        f.stop()

"""Ingest parity: the port's copies of the protocol, replay and batcher
modules produce exactly what the JAX package's do — parsed records, wire
bytes, synthetic telemetry, slot assignment."""

import dataclasses

import pytest

from traffic_classifier_sdn_tpu.core import flow_table as jft
from traffic_classifier_sdn_tpu.ingest import batcher as jb
from traffic_classifier_sdn_tpu.ingest import protocol as jp
from traffic_classifier_sdn_tpu.ingest import replay as jr
from traffic_classifier_sdn_tpu_torch.core import flow_table as tft
from traffic_classifier_sdn_tpu_torch.ingest import batcher as tb
from traffic_classifier_sdn_tpu_torch.ingest import protocol as tp
from traffic_classifier_sdn_tpu_torch.ingest import replay as tr

WIRE_FIELDS = ("time", "datapath", "in_port", "eth_src", "eth_dst",
               "out_port", "packets", "bytes", "source")


def _fields(r):
    return None if r is None else tuple(getattr(r, f) for f in WIRE_FIELDS)


LINES = [
    b"data\t1\t1\t1\t00:00:00:00:00:01\t00:00:00:00:00:02\t2\t10\t1000\n",
    b"data\t7\tdp9\t3\tab\tcd\t4\t18446744073709551615\t5\n",  # > int64
    b"data\t7\tdp9\t3\tab\tcd\t4\t9223372036854775807\t0",  # no newline
    b"data\t-3\t1\t1\ta\tb\t2\t0\t0\n",
    b"data\t1\t1\t1\ta\tb\t2\t-1\t0\n",  # negative counter
    b"data\t1\t1\t1\ta\tb\t2\t10\n",  # a field short
    b"data\t1\t1\t1\ta\tb\t2\t10\t10\tjunk\n",  # a field long
    b"data\tx\t1\t1\ta\tb\t2\t10\t10\n",  # non-integer time
    b"data\t1\t1\t1\t\xff\xfe\tb\t2\t10\t10\n",  # not UTF-8
    b"loading app ryu.controller\n",
    b"datapath\tid\n",
    b"",
]


@pytest.mark.parametrize("line", LINES)
def test_parse_line_matches(line):
    assert _fields(tp.parse_line(line)) == _fields(jp.parse_line(line))


@pytest.mark.parametrize("line", [ln for ln in LINES if jp.parse_line(ln)])
def test_format_line_roundtrip_matches(line):
    r = tp.parse_line(line)
    j = jp.parse_line(line)
    assert tp.format_line(r) == jp.format_line(j)


@pytest.mark.parametrize("source", [0, 1, 7])
def test_stable_flow_key_matches(source):
    for args in (("1", "a", "b"), ("dp", "00:00:00:00:00:01", "x"), ("", "", "")):
        assert (tp.stable_flow_key(*args, source)
                == jp.stable_flow_key(*args, source))


@pytest.mark.parametrize("seed,churn", [(0, 1.0), (3, 1.0), (5, 0.4)])
def test_synthetic_tick_bytes_identical(seed, churn):
    a = tr.SyntheticFlows(n_flows=37, seed=seed, churn=churn)
    b = jr.SyntheticFlows(n_flows=37, seed=seed, churn=churn)
    for _ in range(3):
        assert a.tick_bytes() == b.tick_bytes()


@pytest.mark.parametrize("seed", [0, 11])
def test_synthetic_tick_records_identical(seed):
    a = tr.SyntheticFlows(n_flows=23, seed=seed, mac_base=5)
    b = jr.SyntheticFlows(n_flows=23, seed=seed, mac_base=5)
    for _ in range(3):
        assert [_fields(r) for r in a.tick()] == [_fields(r) for r in b.tick()]


def _capture(tmp_path):
    syn = jr.SyntheticFlows(n_flows=9, seed=2)
    path = tmp_path / "cap.tsv"
    with open(path, "wb") as f:
        for _ in range(4):
            f.write(b"noise line\n" + syn.tick_bytes())
            f.write(b"data\tbad\n")
        f.write(b"data\t9\t1\t1\ta\tb\t2\t3\t4")  # last line, no newline
    return str(path)


def test_iter_capture_identical(tmp_path):
    path = _capture(tmp_path)
    got = [[_fields(r) for r in t] for t in tr.iter_capture(path)]
    want = [[_fields(r) for r in t] for t in jr.iter_capture(path)]
    assert got == want and len(got) == 5
    assert list(tr.iter_capture_bytes(path)) == list(jr.iter_capture_bytes(path))


@pytest.mark.parametrize("capacity", [64, 30])  # 30 < 40 flows: drops
def test_flow_index_and_wire_bytes_identical(capacity):
    """Both batchers route the same records to the same slots (direction
    folding, drops on a full table, slot reuse after release) and pack
    byte-identical wires."""
    ji, ti = jb.FlowIndex(capacity), tb.FlowIndex(capacity)
    jbat, tbat = jb.Batcher(ji, (16, 64)), tb.Batcher(ti, (16, 64))
    syn_j, syn_t = jr.SyntheticFlows(n_flows=40), tr.SyntheticFlows(n_flows=40)
    for step in range(3):
        for rj, rt in zip(syn_j.tick(), syn_t.tick()):
            aj, at = ji.assign(rj), ti.assign(rt)
            assert (aj is None) == (at is None)
            if aj is not None:
                assert dataclasses.astuple(aj) == dataclasses.astuple(at)
            assert jbat.add(rj) == tbat.add(rt)
        while (bj := jbat.flush()) is not None:
            bt = tbat.flush()
            assert jft.pack_wire(bj).tobytes() == tft.pack_wire(bt).tobytes()
        assert tbat.flush() is None
        assert jbat.dropped == tbat.dropped
        if step == 1:
            ji.release_slots([3, 8, 9])
            ti.release_slots([3, 8, 9])
    assert (tbat.dropped > 0) == (capacity < 40)
    assert ji.key_to_slot == ti.key_to_slot
    assert ji.slot_meta == ti.slot_meta
    assert ji.free == ti.free

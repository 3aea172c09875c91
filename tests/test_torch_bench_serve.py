"""``tools/torch_bench_serve.py`` against ``tools/bench_serve.py``: both
tools in subprocesses on the same arguments at toy size (the JAX tool on
the CPU, the twin with ``--device cpu``), every mode: the same
``"metric"``, the same key sets (apart from the device keys of
``torch_bench_pairs.DEVICE_KEYS``), and the deterministic fields equal —
the flows tracked, the records and wire bytes per tick, the per-level
records of the sweeps, the region sweep's identity verdicts. The rendered
rows of the serial and pipelined loops are compared in-process, tick by
tick, on the same payloads. Every twin exits nonzero without a card
unless it is given ``--device cpu``."""

import importlib.util
import sys
import types

import numpy as np
import pytest
import torch

from torch_bench_pairs import (
    ROOT,
    TOOLS,
    assert_fields_equal,
    assert_same_keys,
    pair,
    run,
)

COMMON = ("capacity", "tracked_flows", "records_per_tick",
          "update_wire_mb_per_tick", "native_ingest", "predict_model",
          "table_rows_rendered", "churn_fraction", "incremental_mode",
          "warmup", "platform")
SMALL = ["--capacity", "2048", "--ticks", "2"]

MODES = {
    "serial": SMALL,
    "pipeline_ab": ["--capacity", "1024", "--ticks", "3", "--table-rows",
                    "16", "--pipeline", "both", "--warmup"],
    "incremental_ab": SMALL + ["--incremental", "both", "--warmup",
                               "--churn-fraction", "0.1"],
    "shards": SMALL + ["--shards", "2", "--pipeline", "both"],
    "forest": SMALL + ["--model", "forest", "--pipeline", "on"],
    "knn": SMALL + ["--model", "knn", "--incremental", "on"],
    "knn-synth": SMALL + ["--model", "knn-synth", "--synth-corpus", "512"],
}


@pytest.mark.parametrize("mode", list(MODES))
def test_single_measurements_equal_jax(mode):
    (want,), (got,) = pair("bench_serve.py", MODES[mode])
    assert got["metric"] == want["metric"]
    assert_same_keys(want, got)
    assert_fields_equal(want, got, COMMON + (
        ("shards",) if mode == "shards" else ()))
    assert got["compiles_in_measured_region"] == 0
    if mode == "pipeline_ab":
        # the acceptance fields tests/test_pipeline.py checks of JAX's
        for m in ("serial", "pipelined"):
            assert got[m]["serve_flows_per_sec"] > 0
            assert "first_tick_ms" in got[m]
        assert "speedup_flows_per_sec" in got
        assert "overlap_ratio" in got["pipelined"]
        assert got["pipelined"]["ticks_coalesced"] >= 0
    if mode == "incremental_ab":
        assert want["render_identical"] and got["render_identical"]


def test_churn_sweep_equals_jax():
    args = SMALL + ["--churn-sweep", "0,0.1,1.0", "--warmup"]
    (want,), (got,) = pair("bench_serve.py", args)
    assert got["metric"] == "serve_dirty_sweep"
    assert_same_keys(want, got)
    assert [lv["churn"] for lv in got["levels"]] == [0.0, 0.1, 1.0]
    for w, g in zip(want["levels"], got["levels"]):
        assert_same_keys(w, g)
        assert w["render_identical"] and g["render_identical"]
    assert_fields_equal(want, got, ("tracked_flows", "capacity", "ticks"))


def assert_drained_levels_equal(want: dict, got: dict, ticks: int,
                                keys, records) -> None:
    """``keys`` equal at every level of two sweeps; ``records(level)``
    equal where both loops ended with the sources' streams. A level's
    loop stops after 2 x ``--ticks`` serve ticks in both tools, and a
    serve tick takes whatever batches have arrived (interval-paced
    sources are not lockstep), so a loop that reached that cap may have
    left batches unread, as many as the host's timing made it. Then its
    count is at most the drained side's. A 1-source level never reaches
    the cap (one batch a source tick), so it is always compared."""
    cap = 2 * ticks
    for w, g in zip(want["levels"], got["levels"], strict=True):
        assert_same_keys(w, g)
        assert_fields_equal(w, g, keys)
        drained = [lv["serve_ticks"] < cap for lv in (w, g)]
        assert all(drained) or w["sources"] > 1, (w, g)
        if all(drained):
            assert records(w) == records(g), (w, g)
        elif any(drained):
            short, full = (g, w) if drained[0] else (w, g)
            assert all(a <= b for a, b in zip(records(short),
                                              records(full))), (w, g)
    assert any(lv["sources"] == 1 for lv in got["levels"])


def test_fanin_sweep_equals_jax():
    args = SMALL + ["--sources-sweep", "1,4", "--source-interval", "0.05"]
    (want,), (got,) = pair("bench_serve.py", args)
    assert got["metric"] == "serve_fanin_sources"
    assert_same_keys(want, got)
    assert_drained_levels_equal(
        want, got, 2, ("sources", "flows_per_source", "total_drops"),
        lambda lv: [lv["records_ingested"], lv["tracked_flows"],
                    *(r["records"] for r in lv["per_source"])])


def test_region_sweep_equals_jax(tmp_path):
    """The region sweep with its comparator a fan-in sweep of the twin's
    own (the twin has no default baseline): the composed serve is byte
    for byte every single-spine path through the port's CLI, as through
    JAX's, and every level ingests JAX's records."""
    fanin = tmp_path / "fanin.json"
    base = ["--capacity", "1024", "--ticks", "3", "--flows-per-tick", "256",
            "--source-interval", "0.05"]
    t = run([TOOLS / "torch_bench_serve.py", *base, "--sources-sweep", "1,4",
             "--device", "cpu"])
    assert t.returncode == 0, t.stderr[-3000:]
    fanin.write_text(t.stdout.strip().splitlines()[-1])
    region = base + ["--region-sweep", "--region-sources", "1,4",
                     "--region-shards", "0,2", "--region-churn", "1.0"]
    (want,), (got,) = pair("bench_serve.py", region,
                           twin_args=["--baseline-fanin", str(fanin)])
    assert got["metric"] == "serve_region"
    assert_same_keys(want, got)
    assert got["identity_paths"] == want["identity_paths"]
    assert got["render_identical"] and want["render_identical"]
    assert got["unsharded_fanin_knee_records_per_sec"] is not None
    assert_drained_levels_equal(
        want, got, 3, ("sources", "shards", "churn_fraction", "total_drops"),
        lambda lv: [lv["records_ingested"], lv["tracked_flows"]])


def _module(name: str, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    sys.path.insert(0, str(TOOLS))
    sys.path.insert(0, str(ROOT))
    return (_module("bench_serve_jax", TOOLS / "bench_serve.py"),
            _module("bench_serve_twin", TOOLS / "torch_bench_serve.py"))


def _subsequence(got: list, want: list) -> bool:
    it = iter(want)
    return all(any(g == w for w in it) for g in got)


@pytest.mark.parametrize("loop", ["serial", "pipelined"])
@pytest.mark.parametrize("native", [True, False])
def test_rendered_rows_equal_jax(tools, loop, native):
    """Each tick's rendered rows (slot, source MAC, destination MAC,
    label) of the serial and pipelined loops, JAX's tool and the twin's
    on the same payloads. The pipelined loops hand renders over a depth-2
    handoff that coalesces by timing (a full handoff replaces its newest
    render), so each holds the serial rows by the subsequence rule: every
    render it printed is the serial loop's at some tick, in order, the
    last tick's always, one render for each tick not coalesced."""
    from traffic_classifier_sdn_tpu.ingest.replay import SyntheticFlows

    jt, tt = tools
    args = types.SimpleNamespace(model="gnb", shards=0, table_rows=16,
                                 capacity=1024)
    syn = SyntheticFlows(n_flows=300, seed=0, churn=0.3)
    payloads = [syn.tick_bytes() for _ in range(4)]
    jpredict, jparams, jraw = jt._build_model(args)
    cpu = torch.device("cpu")
    tpredict, tparams, traw = tt._build_model(args, cpu)

    def jax_run(run):
        eng = jt._make_engine(args, native, jraw, jparams)
        out = run(args, eng, jpredict, jparams, payloads)
        out["rendered_rows"] = [[(s, a, b, int(c)) for s, a, b, c in rows]
                                for rows in out["rendered_rows"]]
        return out, eng

    want, jeng = jax_run(jt._run_serial)
    teng = tt._make_engine(args, native, traw, tparams, cpu)
    if loop == "serial":
        got = tt._run_serial(args, teng, tpredict, tparams, payloads, cpu)
        assert got["rendered_rows"] == want["rendered_rows"]
        assert [len(r) for r in got["rendered_rows"]] == [16] * 4
    else:
        jpipe, jeng = jax_run(jt._run_pipelined)
        got = tt._run_pipelined(args, teng, tpredict, tparams, payloads, cpu)
        for run in (got, jpipe):
            rows = run["rendered_rows"]
            assert _subsequence(rows, want["rendered_rows"])
            assert rows[-1] == want["rendered_rows"][-1]
            assert len(rows) + run["pipeline_stats"]["ticks_coalesced"] == 4
    assert got["n_parsed"] == want["n_parsed"]
    assert np.isclose(teng.wire_bytes, jeng.wire_bytes)


TWINS = ("torch_bench_serve", "torch_bench_e2e", "torch_bench_e2e_live",
         "torch_bench_knn", "torch_bench_forest_buckets",
         "torch_bench_sharded", "torch_bench_sharded_scaling",
         "torch_bench_openset", "torch_bench_scenarios")


@pytest.mark.parametrize("twin", TWINS)
def test_twin_needs_a_card_unless_told_cpu(twin):
    """With no ``--device`` a twin runs on the card: without one it exits
    nonzero and says why, before it measures anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default would run there")
    proc = run([TOOLS / f"{twin}.py"])
    assert proc.returncode != 0
    assert "no CUDA device is visible; pass --device cpu" in proc.stderr
    assert not proc.stdout.strip()

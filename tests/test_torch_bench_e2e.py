"""``tools/torch_bench_e2e.py`` and ``tools/torch_bench_e2e_live.py``
against ``tools/bench_e2e.py`` and ``tools/bench_e2e_live.py``, both in
subprocesses at toy size (the JAX tools on the CPU, the twins with
``--device cpu``): the same ``"metric"``, the same key sets (apart from
the device keys and the port's named ``served_predict``), the
deterministic fields equal — records per tick, the render-identity gates,
the per-level records, ticks and folded batches of the live budget, its
stamp-overhead A/B verdicts."""

from torch_bench_pairs import (
    TOOLS,
    assert_fields_equal,
    assert_same_keys,
    json_lines,
    pair,
    run,
)

# the slice budget at 512 rows: both tools' module constant, set before
# main() runs (the JAX tool has no flag for it)
AT_512 = """
import runpy, sys
sys.argv = [sys.argv[1]] + sys.argv[2:]
mod = runpy.run_path(sys.argv[0], run_name="bench")
mod["main"].__globals__["SLICE"] = 512
mod["main"].__globals__["REPEATS"] = 3
mod["main"]()
"""


def test_slice_budget_equals_jax():
    j = run(["-c", AT_512, TOOLS / "bench_e2e.py", "--platform", "cpu"])
    t = run(["-c", AT_512, TOOLS / "torch_bench_e2e.py", "--device", "cpu"],
            cwd=TOOLS)
    assert j.returncode == 0, j.stderr[-3000:]
    assert t.returncode == 0, t.stderr[-3000:]
    (want,), (got,) = json_lines(j.stdout), json_lines(t.stdout)
    assert got["metric"] == want["metric"] == "e2e_latency_budget_16k_slice"
    assert_same_keys(want, got, extra=("served_predict",))
    assert_fields_equal(want, got, ("slice_rows", "model", "native_ingest",
                                    "unit", "platform"))
    # the forest the port serves: its kernel's wrapper (the plain version
    # on the CPU)
    assert got["served_predict"].endswith("forest_kernel.predict")
    # the serve's own transfers: one 512-record tick's packed wire up,
    # the int32 labels down
    assert got["payload_bytes"]["d2h"] == 512 * 4
    assert all(v >= 0 for v in got["budget_p50_ms"].values())


def test_serve_budget_equals_jax():
    args = ["--serve-budget", "--capacity", "4096", "--flows-per-tick",
            "1024", "--ticks", "3"]
    (want,), (got,) = pair("bench_e2e.py", args, jax_args=["--platform",
                                                             "cpu"])
    assert got["metric"] == "e2e_serve_budget_16k"
    assert_same_keys(want, got)
    assert_fields_equal(want, got, ("records_per_tick", "capacity", "ticks",
                                    "table_rows_rendered", "predict_model",
                                    "platform"))
    assert want["render_identical"] and got["render_identical"]


def test_live_budget_equals_jax():
    args = ["--sources", "1,4", "--records-per-tick", "512", "--ticks", "3",
            "--interval", "0.05", "--ab-sources", "2", "--ab-repeat", "1",
            "--capacity", "4096"]
    (want,), (got,) = pair("bench_e2e_live.py", args)
    assert got["metric"] == "e2e_budget_live"
    assert_same_keys(want, got)
    assert_fields_equal(want, got, ("records_per_tick", "cadence_s",
                                    "ticks_per_source", "capacity",
                                    "predict_model", "native_ingest"))
    for w, g in zip(want["levels"], got["levels"], strict=True):
        assert_same_keys(w, g)
        assert_fields_equal(w, g, ("sources", "flows_per_source",
                                   "records_ingested", "serve_ticks",
                                   "batches_folded"))
        assert g["reconciliation_ratio"] is not None
    wab, gab = want["stamp_overhead_ab"], got["stamp_overhead_ab"]
    assert set(wab) == set(gab)
    assert gab["render_identical"] and wab["render_identical"]
    assert gab["within_3pct"] and wab["within_3pct"]

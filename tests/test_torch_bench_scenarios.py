"""``tools/torch_bench_scenarios.py`` against ``tools/bench_scenarios.py``
at the ``t1`` profile (the JAX tool on the CPU, the twin with ``--device
cpu``): the same scorecard keys, the same scenarios in the same order,
each gate's verdict equal; and a failed gate exits nonzero and leaves its
post-mortem bundle under ``--obs-dir``."""

import json

from torch_bench_pairs import TOOLS, assert_same_keys, pair, run


def test_scenario_verdicts_equal_jax(tmp_path):
    want, got = pair("bench_scenarios.py", ["--profile", "t1"],
                     jax_args=["--out", tmp_path / "j.json", "--obs-dir",
                               tmp_path / "pmj"],
                     twin_args=["--out", tmp_path / "t.json", "--obs-dir",
                                tmp_path / "pmt"])
    (want,), (got,) = want, got
    assert got["bench"] == want["bench"] == "scenario_matrix"
    assert_same_keys(want, got)
    assert got["passed"] and want["passed"]
    assert got["gate_failures"] == want["gate_failures"] == []
    assert [c["scenario"] for c in got["scenarios"]] == \
        [c["scenario"] for c in want["scenarios"]]
    for w, g in zip(want["scenarios"], got["scenarios"]):
        assert [(x["id"], x["passed"]) for x in g["gates"]] == \
            [(x["id"], x["passed"]) for x in w["gates"]]
    assert json.loads((tmp_path / "t.json").read_text()) == got


# the twin with one more gate on flash_crowd, which cannot pass
FAILING = """
import dataclasses, runpy, sys
sys.path.insert(0, {tools!r})
from traffic_classifier_sdn_tpu_torch.scenarios import library, timeline
orig = library.SCENARIOS["flash_crowd"]

def builder(profile):
    sc = orig(profile)
    return dataclasses.replace(sc, gates=tuple(sc.gates) + (timeline.Gate(
        "forced_fail", lambda ctx: timeline.GateResult(
            "forced_fail", False, 1, 0, "forced")),))

library.SCENARIOS["flash_crowd"] = builder
sys.argv = [{tool!r}] + sys.argv[1:]
runpy.run_path({tool!r}, run_name="__main__")
"""


def test_failed_gate_exits_nonzero_with_a_postmortem(tmp_path):
    tool = str(TOOLS / "torch_bench_scenarios.py")
    proc = run(["-c", FAILING.format(tools=str(TOOLS), tool=tool),
                "--profile", "t1", "--scenario", "flash_crowd",
                "--scenario", "counter_reset_storm", "--device", "cpu",
                "--out", tmp_path / "t.json", "--obs-dir", tmp_path / "pm"])
    assert proc.returncode != 0
    assert "scenario gates FAILED: flash_crowd:forced_fail" in proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not out["passed"]
    assert out["gate_failures"] == [{"scenario": "flash_crowd",
                                     "gate": "forced_fail", "value": 1,
                                     "bound": 0, "detail": "forced"}]
    assert [c["passed"] for c in out["scenarios"]] == [False, True]
    assert (tmp_path / "pm" / "scenario-flash_crowd-postmortem.json").exists()
    assert not (tmp_path / "pm"
                / "scenario-counter_reset_storm-postmortem.json").exists()


def test_list_names_the_library():
    want = run([TOOLS / "bench_scenarios.py", "--list"])
    got = run([TOOLS / "torch_bench_scenarios.py", "--list"])
    assert got.returncode == want.returncode == 0
    assert got.stdout == want.stdout

"""The port's scenario campaign (``scenarios/``) against the JAX
package's.

- Every library scenario passes at the ``t1`` profile through the port's
  ``run_scenario`` on the CPU. Its deterministic results equal JAX's
  scorecard of the same timeline: every gate's id and verdict, and, on
  the virtual clock, each deterministic gate's value, bound and detail,
  the transition trace, the record/flow/eviction counts, and the
  actuation ledger and switch census of the push-mode scenario. The
  wall-clock gates (``cadence_p50``, ``e2e_p99``) and the one real-clock
  scenario (``queue_saturation_flood``) are held to their verdicts only:
  their values are times.
- The runner resolves the port's ``AccountingSwitch``
  (``tools/torch_fake_switch.py``) and never imports ``fake_switch``,
  which imports the JAX package.
- The post-mortem bundle, the campaign matrix, and the CLI's
  ``--scenario`` hook (``list`` prints JAX's lines; a replay prints the
  scorecard; an unknown id is a usage error).

Tolerances: none — every comparison above is exact.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

from traffic_classifier_sdn_tpu import cli as jcli
from traffic_classifier_sdn_tpu.scenarios import build as jbuild
from traffic_classifier_sdn_tpu.scenarios import run_scenario as jrun
from traffic_classifier_sdn_tpu_torch import cli as tcli
from traffic_classifier_sdn_tpu_torch.ingest.fanin import SourceSpec
from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows
from traffic_classifier_sdn_tpu_torch.scenarios import (
    SCENARIOS,
    build,
    run_campaign,
    run_scenario,
)
from traffic_classifier_sdn_tpu_torch.scenarios.timeline import (
    Gate,
    GateResult,
    Phase,
    Scenario,
    gate_accounting,
    gate_cadence,
)
from torch_witnesses import _torch_locktrace_witness  # noqa: F401 — the lock witness rides this suite

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMED = {"cadence_p50", "e2e_p99"}
CARD_COUNTS = ("ticks_run", "phases", "flows", "records", "parse_errors",
               "evicted_slots", "engine")


def _untimed(card):
    return [{k: v for k, v in e.items() if k != "seq"}
            for e in card["transitions"]]


def _jax_reference(name):
    """JAX's scorecard of the timeline, from its second run in this
    process. Its first run compiles programs inside the timeline: beside
    a loaded CPU those compiles took e2e p99 to 1.6-3.0 s against the
    2.5 s gate of ``device_wedge_degrade``, where a warm run takes
    0.01-0.05 s."""
    jrun(jbuild(name, "t1"))
    return jrun(jbuild(name, "t1"))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_passes_and_deterministic_gates_equal_jax(name):
    card = run_scenario(build(name, "t1"), device="cpu")
    failed = [g for g in card["gates"] if not g["passed"]]
    assert card["passed"], f"{name} failed gates: {json.dumps(failed)}"
    assert card["ticks_run"] > 0
    json.dumps(card)
    assert card["device"]["platform"] == "cpu"
    want = _jax_reference(name)
    assert want["passed"]
    assert [(g["id"], g["passed"]) for g in card["gates"]] == [
        (g["id"], g["passed"]) for g in want["gates"]]
    if build(name, "t1").real_clock:
        return
    for got, exp in zip(card["gates"], want["gates"]):
        if got["id"] not in TIMED:
            assert got == exp, got["id"]
    for key in CARD_COUNTS:
        assert card[key] == want[key], key
    assert _untimed(card) == _untimed(want)
    assert card.get("actuation") == want.get("actuation")
    assert card.get("switch") == want.get("switch")


def test_every_scenario_checks_accounting_and_cpu_profile_builds():
    for name, builder in SCENARIOS.items():
        sc = builder("t1")
        assert "accounting_exact" in {g.id for g in sc.gates}, name
        big = build(name, "cpu")
        assert big.total_ticks > 0 and big.phases
        assert big.total_ticks == jbuild(name, "cpu").total_ticks
    with pytest.raises(ValueError, match="unknown scenario"):
        build("no_such_scenario")
    with pytest.raises(ValueError, match="profile"):
        build("flash_crowd", "gpu")


def test_runner_never_imports_the_jax_fake_switch():
    """In a fresh process: the push-mode scenario's switch class is the
    port's, and neither ``fake_switch`` nor the JAX package is loaded."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "from traffic_classifier_sdn_tpu_torch.scenarios import runner\n"
        "cls = runner._accounting_switch_cls()\n"
        "assert cls.__module__ == 'torch_fake_switch', cls.__module__\n"
        "bad = [m for m in sys.modules if m == 'fake_switch' or "
        "m.split('.')[0] == 'traffic_classifier_sdn_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    src = open(os.path.join(
        ROOT, "traffic_classifier_sdn_tpu_torch/scenarios/runner.py")).read()
    assert 'import_module("fake_switch")' not in src


def test_push_scenario_runs_on_the_ports_switch():
    card = run_scenario(build("label_flap_storm", "t1"), device="cpu")
    assert card["passed"]
    assert card["switch"]["live_rules"] == card["actuation"]["installed_rules"]
    assert "fake_switch" not in sys.modules or sys.modules[
        "fake_switch"].AccountingSwitch.__module__ != "torch_fake_switch"


def _tiny_scenario(gates) -> Scenario:
    gen = SyntheticFlows(2, seed=9)
    return Scenario(
        id="tiny", title="post-mortem fixture", phases=(Phase("only", 2),),
        sources=(SourceSpec(kind="feed", sid=0, lockstep=True,
                            feed=lambda _i: gen.tick_bytes()),),
        capacity=64, gates=gates,
    )


def test_gate_failure_dumps_post_mortem_bundle(tmp_path):
    impossible = Gate(
        "impossible",
        lambda ctx: GateResult("impossible", False, detail="by design"))
    card = run_scenario(_tiny_scenario((impossible, gate_accounting())),
                        obs_dir=str(tmp_path), device="cpu")
    assert card["passed"] is False
    pm = card["post_mortem"]
    manifest_path = tmp_path / "scenario-tiny-postmortem.json"
    assert pm["manifest"] == str(manifest_path)
    manifest = json.loads(manifest_path.read_text())
    assert manifest["timeline_position"]["phase"] == "only"
    assert [g["id"] for g in manifest["failed_gates"]] == ["impossible"]
    assert manifest["device"]["platform"] == "cpu"
    assert isinstance(manifest["perf_tail"], list)
    lines = (tmp_path / os.path.basename(pm["flight"])).read_text().splitlines()
    assert json.loads(lines[0])["kind"] == "meta"
    breaches = [json.loads(ln) for ln in lines[1:]
                if json.loads(ln).get("kind") == "scenario.gate_breach"]
    assert [b["gate"] for b in breaches] == ["impossible"]


def test_passing_run_writes_no_bundle_and_campaign_shape(tmp_path):
    card = run_scenario(_tiny_scenario((gate_cadence(10.0), gate_accounting())),
                        obs_dir=str(tmp_path), device="cpu")
    assert card["passed"] is True and "post_mortem" not in card
    assert [p.name for p in tmp_path.iterdir()] == ["perf"]
    out = run_campaign([_tiny_scenario((gate_accounting(),))],
                       platform="cpu", device="cpu")
    assert out["platform"] == "cpu"
    assert out["passed"] is True and out["gate_failures"] == []
    assert [c["scenario"] for c in out["scenarios"]] == ["tiny"]


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(
            io.StringIO()):
        result = main(argv)
    return out.getvalue(), result


def test_cli_scenario_list_equals_jax():
    got, _ = _cli(tcli.main, ["gaussiannb", "--scenario", "list"])
    want, _ = _cli(jcli.main, ["gaussiannb", "--scenario", "list"])
    assert got == want
    assert len(got.splitlines()) == len(SCENARIOS) == 8


def test_cli_scenario_replay_prints_the_scorecard(tmp_path):
    out, card = _cli(tcli.main, [
        "Randomforest", "--scenario", "counter_reset_storm",
        "--scenario-profile", "t1", "--scenario-obs-dir",
        str(tmp_path / "pm"), "--device", "cpu"])
    printed = json.loads(out)
    assert printed["scenario"] == "counter_reset_storm"
    assert printed["passed"] and card["passed"]
    assert [g["id"] for g in printed["gates"]] == [g["id"] for g in card["gates"]]


def test_cli_unknown_scenario_is_a_usage_error(capsys):
    for main in (tcli.main, jcli.main):
        with pytest.raises(SystemExit) as e:
            main(["gaussiannb", "--scenario", "nope"])
        assert e.value.code == 2
    err = capsys.readouterr().err
    lines = [ln for ln in err.splitlines() if "unknown scenario" in ln]
    assert len(lines) == 2
    assert lines[0].split("error: ", 1)[1] == lines[1].split("error: ", 1)[1]

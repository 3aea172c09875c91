"""The port's fleet mode (``serving/fleet.py``, ``DriftController
(follow_rotation=True)``, ``tools/torch_fleet_serve.py``) against the JAX
package's.

- ``partition_sources`` returns JAX's spans (and refuses what JAX
  refuses) over a grid of shapes.
- Promotion propagates through the shared rotation on the port's
  ``DriftController``: the leader's drift trip retrains and promotes, the
  follower adopts the member as its candidate and promotes it through
  its own parity probes (JAX tests/test_fleet.py's case, virtual clock).
- A follower that rejects an adopted member keeps the peer's member and
  never re-adopts its seq.
- The ``/healthz`` roster-of-rosters aggregator over real port
  exposition servers: health conjunction, sources annotated with their
  member, drift states, 200/503, an unreachable member; its report
  equals the JAX aggregator's over the same members.
- ``tools/torch_fleet_serve.py`` launches port CLI members with
  ``--device`` and no ``--shards``.

Tolerances: none — every comparison is exact.
"""

import json
import os
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from traffic_classifier_sdn_tpu.serving import fleet as jfleet
from traffic_classifier_sdn_tpu_torch import interop
from traffic_classifier_sdn_tpu_torch.obs import ExpositionServer, HealthState
from traffic_classifier_sdn_tpu_torch.serving import fleet, retrain
from traffic_classifier_sdn_tpu_torch.serving.drift import (
    CANDIDATE,
    PROMOTED,
    RETRAINING,
    STEADY,
    DriftController,
    DriftGate,
)
from traffic_classifier_sdn_tpu_torch.utils.metrics import Metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# partition_sources
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_sources", [0, 1, 2, 3, 7, 10, 64, 1000])
@pytest.mark.parametrize("n_members", [-1, 0, 1, 2, 3, 4, 9])
def test_partition_sources_equals_jax(n_sources, n_members):
    def run(mod):
        try:
            return mod.partition_sources(n_sources, n_members)
        except ValueError as e:
            return str(e)

    got = run(fleet)
    assert got == run(jfleet)
    if isinstance(got, list):
        covered = [s for start, n in got for s in range(start, start + n)]
        assert covered == list(range(n_sources))
        counts = [n for _, n in got]
        assert max(counts) - min(counts) <= 1
    with pytest.raises(ValueError):
        fleet.partition_sources(-1, 2)


# ---------------------------------------------------------------------------
# harness: JAX's teacher/stream pair, fleet-sized, on the port
# ---------------------------------------------------------------------------


def _teacher(params, X):
    return (np.asarray(X)[:, 0] > 500.0).astype(np.int32)


def _batch(lo, hi, n=16, seed=0):
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 12), np.float32)
    X[: n // 2, 0] = lo * (1 + 0.01 * rng.rand(n // 2))
    X[n // 2:, 0] = hi * (1 + 0.01 * rng.rand(n - n // 2))
    X[:, 1] = 1.0
    return X


def _boot_params():
    return interop.gnb_params_from_numpy({
        "theta": np.asarray([[10.0] * 12, [1000.0] * 12], np.float64),
        "var": np.ones((2, 12), np.float64),
        "class_prior": np.full(2, 0.5),
    }, device="cpu")


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _member(shared_dir, gate, clock, **kw):
    kw.setdefault("window", 3)
    kw.setdefault("threshold", 3.0)
    kw.setdefault("trips", 2)
    kw.setdefault("calibration_windows", 2)
    kw.setdefault("probe_successes", 2)
    kw.setdefault("min_retrain_rows", 16)
    kw.setdefault("boot_params", _boot_params())
    return DriftController(
        gate, family="gnb", classes=("ping", "voice"),
        directory=str(shared_dir), clock=clock, device="cpu", **kw,
    )


def _drive(gate, ctl, i, shifted):
    lo, hi = (100.0, 10000.0) if shifted else (10.0, 1000.0)
    labels = gate(None, torch.from_numpy(_batch(lo, hi, seed=i)))
    ctl.poll()
    return labels


def _wait_retrain(ctl, timeout=90.0):
    deadline = time.monotonic() + timeout
    while ctl._retrainer.poll() == retrain.RUNNING:
        if time.monotonic() > deadline:
            pytest.fail("background retrain never finished")
        time.sleep(0.05)


def test_fleet_promotion_propagates_through_parity_gate(tmp_path):
    shared = tmp_path / "rotation"
    clock = _Clock()
    m_lead, m_follow = Metrics(), Metrics()
    lead_gate, follow_gate = DriftGate(_teacher), DriftGate(_teacher)
    leader = _member(shared, lead_gate, clock, metrics=m_lead)
    follower = _member(shared, follow_gate, clock, metrics=m_follow,
                       follow_rotation=True)
    try:
        i = 0
        while leader.state != PROMOTED and i < 200:
            i += 1
            clock.advance(1.0)
            _drive(lead_gate, leader, i, shifted=i > 12)
            if leader.state == RETRAINING:
                _wait_retrain(leader)
        assert leader.state == PROMOTED
        assert m_lead.counters["promotions"] == 1
        members = retrain.list_candidates(str(shared))
        assert members[0][0] >= 1
        promoted_path = members[0][1]
        seen = []
        j = 1000
        while follower.state != PROMOTED and j < 1200:
            j += 1
            clock.advance(1.0)
            _drive(follow_gate, follower, j, shifted=True)
            if not seen or seen[-1] != follower.state:
                seen.append(follower.state)
        assert follower.state == PROMOTED
        assert CANDIDATE in seen
        assert RETRAINING not in seen
        assert "retrain_runs" not in m_follow.counters
        assert m_follow.counters["promotions"] == 1
        assert follow_gate.swapped and lead_gate.swapped
        X = torch.from_numpy(_batch(100.0, 10000.0, seed=9999))
        np.testing.assert_array_equal(
            np.asarray(follow_gate(None, X)), _teacher(None, X))
        assert os.path.isdir(promoted_path)
    finally:
        leader.close()
        follower.close()


def test_follower_rejection_keeps_shared_member(tmp_path):
    shared = tmp_path / "rotation"
    clock = _Clock()

    class Disagree:
        def __call__(self, params, X):
            return 1 - _teacher(params, X)

    gate = DriftGate(_teacher)
    follower = _member(
        shared, gate, clock, follow_rotation=True,
        candidate_max_failures=2,
        build_serving=lambda params: (Disagree(), None),
    )
    staged = retrain.save_candidate(
        str(shared), 1, "gnb", _boot_params(), ("ping", "voice"))
    try:
        states = []
        for i in range(1, 40):
            clock.advance(1.0)
            _drive(gate, follower, i, shifted=False)
            states.append(follower.state)
            if follower.state == STEADY and CANDIDATE in states:
                break
        assert CANDIDATE in states
        assert follower.state == STEADY
        assert not gate.swapped
        assert os.path.isdir(staged)
        for i in range(100, 110):
            clock.advance(1.0)
            _drive(gate, follower, i, shifted=False)
            assert follower.state == STEADY
    finally:
        follower.close()


# ---------------------------------------------------------------------------
# the /healthz roster-of-rosters aggregator
# ---------------------------------------------------------------------------


def _scrape(url):
    try:
        with urllib.request.urlopen(url, timeout=5.0) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def _members(clock):
    h0 = HealthState(clock=clock, max_tick_age_s=30.0)
    h1 = HealthState(clock=clock, max_tick_age_s=30.0)
    h0.tick()
    h1.tick()
    h0.set_source_roster(lambda: [
        {"id": 0, "state": "HEALTHY"}, {"id": 1, "state": "HEALTHY"}])
    h1.set_source_roster(lambda: [{"id": 2, "state": "DEAD"}])
    h0.set_drift(lambda: {"state": "STEADY", "swapped": False,
                          "promotions": 0})
    h1.set_drift(lambda: {"state": "PROMOTED", "swapped": True,
                          "promotions": 1})
    return h0, h1


def _strip_ages(report):
    """The aggregator's report without the members' wall-clock reads
    (uptime, model age), which differ between two scrapes."""
    out = json.loads(json.dumps(report))
    for m in out["members"]:
        for k in ("uptime_s", "model_age_s"):
            m.get("report", {}).pop(k, None)
    return out


def test_aggregator_merges_member_rosters():
    clock = _Clock()
    clock.t = 100.0
    h0, h1 = _members(clock)
    servers = [ExpositionServer(Metrics(), health=h) for h in (h0, h1)]
    for s in servers:
        s.start()
    try:
        urls = [f"http://127.0.0.1:{s.port}/healthz" for s in servers]
        with fleet.FleetAggregator(urls) as agg:
            status, report = _scrape(f"http://127.0.0.1:{agg.port}/healthz")
            assert status == 200 and report["healthy"]
            assert report["fleet_size"] == 2
            assert report["members_healthy"] == 2
            assert [s["member"] for s in report["sources"]] == [0, 0, 1]
            assert {s["id"] for s in report["sources"]} == {0, 1, 2}
            assert report["drift_states"] == ["STEADY", "PROMOTED"]
            assert report["swapped"] == [False, True]
            assert report["promotions_total"] == 1
            assert _strip_ages(report) == _strip_ages(
                jfleet.FleetAggregator(urls).check()[1])
            clock.advance(100.0)
            h0.tick()
            status, report = _scrape(f"http://127.0.0.1:{agg.port}/healthz")
            assert status == 503 and not report["healthy"]
            assert report["members_healthy"] == 1
            assert report["members_reachable"] == 2
            assert report["members"][1]["status"] == 503
            assert report["members"][1]["report"]["tick_stale"]
    finally:
        for s in servers:
            s.stop()


def test_aggregator_unreachable_member_is_unhealthy():
    s0 = ExpositionServer(Metrics(), health=None)
    s0.start()
    tmp = ExpositionServer(Metrics(), health=None)
    tmp.start()
    dead_port = tmp.port
    tmp.stop()
    try:
        urls = [f"http://127.0.0.1:{s0.port}/healthz",
                f"http://127.0.0.1:{dead_port}/healthz"]
        healthy, report = fleet.FleetAggregator(urls, timeout=1.0).check()
        assert not healthy
        assert report["members_reachable"] == 1
        assert report["members"][0]["healthy"]
        assert not report["members"][1]["reachable"]
        assert "error" in report["members"][1]
    finally:
        s0.stop()


def test_aggregator_404_off_path():
    with fleet.FleetAggregator([]) as agg:
        status, _ = _scrape(f"http://127.0.0.1:{agg.port}/nope")
        assert status == 404


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def _launcher():
    tools = os.path.join(ROOT, "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import torch_fleet_serve

    return torch_fleet_serve


def test_launcher_member_argv_is_the_ports_cli():
    tfs = _launcher()
    args = tfs.argparse.Namespace(
        model="Randomforest", native_checkpoint="CKPT", synthetic_flows=16,
        capacity=1024, table_rows=8, print_every=5, max_ticks=4,
        drift_dir="ROT", lockstep=True, member_arg=["--warmup"],
        device="cpu", shards=0)
    lead = tfs._member_argv(args, 2, follower=False)
    follow = tfs._member_argv(args, 2, follower=True)
    assert lead[1:4] == ["-m", "traffic_classifier_sdn_tpu_torch.cli",
                         "Randomforest"]
    assert lead[lead.index("--device") + 1] == "cpu"
    assert lead[lead.index("--native-checkpoint") + 1] == "CKPT"
    assert "--shards" not in lead
    assert "--drift-follow" not in lead and "--drift-follow" in follow
    assert lead[-1] == "--warmup"
    args.shards = 2
    sharded = tfs._member_argv(args, 2, follower=False)
    assert sharded[sharded.index("--shards") + 1] == "2"
    assert tfs._shards_per_device(2, "cpu") == 2


def test_launcher_runs_two_cpu_members_to_the_end(tmp_path, capsys):
    """Two port members on the CPU, 2 sources each, lockstep, a shared
    rotation: the roster line lists both, the aggregator's scrapes answer,
    and both members exit 0."""
    tfs = _launcher()
    rng = np.random.RandomState(0)
    from traffic_classifier_sdn_tpu_torch.io import checkpoint as tck

    d = {"theta": rng.gamma(2.0, 100.0, (2, 12)),
         "var": rng.gamma(2.0, 50.0, (2, 12)) + 1.0,
         "class_prior": np.full(2, 0.5)}
    ckpt = str(tmp_path / "gnb")
    tck.save_model(ckpt, "gnb", interop.gnb_params_from_numpy(d, device="cpu"),
                   classes=("ping", "voice"))
    rc = tfs.main([
        "gaussiannb", "--native-checkpoint", ckpt, "--members", "2",
        "--total-sources", "4", "--drift-dir", str(tmp_path / "rot"),
        "--synthetic-flows", "8", "--capacity", "64", "--max-ticks", "6",
        "--print-every", "2", "--lockstep", "--poll-s", "0.2",
        "--device", "cpu", "--log-dir", str(tmp_path / "logs"),
    ])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    roster = json.loads(out[0])
    assert [m["sources"] for m in roster["members"]] == [
        {"first": 0, "count": 2}, {"first": 2, "count": 2}]
    log1 = open(tmp_path / "logs" / "member-1.log", "rb").read()
    assert b"Flow ID" in log1


def _fleet_tables(tfs, tmp_path, ckpt, tag, extra):
    logs = tmp_path / f"logs-{tag}"
    rc = tfs.main([
        "gaussiannb", "--native-checkpoint", ckpt, "--members", "2",
        "--total-sources", "4", "--synthetic-flows", "8",
        "--capacity", "64", "--max-ticks", "6", "--print-every", "2",
        "--lockstep", "--poll-s", "0.2", "--device", "cpu",
        "--log-dir", str(logs), "--member-arg=--pipeline",
        "--member-arg=off", *extra,
    ])
    assert rc == 0
    out = []
    for i in range(2):
        text = (logs / f"member-{i}.log").read_text(errors="replace")
        # the tables only: stderr (ephemeral ports, timings) shares the log
        out.append([ln for ln in text.splitlines()
                    if ln.startswith(("|", "+", "..."))])
    return out


def test_launcher_shards_members_match_the_unsharded_fleet(tmp_path,
                                                           capsys):
    """``--shards 2``: every member serves the sharded spine with its two
    shards on the one CPU (``TCSDN_SHARDS_PER_DEVICE``), and each member
    prints the tables the un-sharded fleet's member prints."""
    tfs = _launcher()
    rng = np.random.RandomState(0)
    from traffic_classifier_sdn_tpu_torch.io import checkpoint as tck

    d = {"theta": rng.gamma(2.0, 100.0, (2, 12)),
         "var": rng.gamma(2.0, 50.0, (2, 12)) + 1.0,
         "class_prior": np.full(2, 0.5)}
    ckpt = str(tmp_path / "gnb")
    tck.save_model(ckpt, "gnb", interop.gnb_params_from_numpy(d, device="cpu"),
                   classes=("ping", "voice"))
    plain = _fleet_tables(tfs, tmp_path, ckpt, "plain", [])
    sharded = _fleet_tables(tfs, tmp_path, ckpt, "sharded",
                            ["--shards", "2"])
    capsys.readouterr()
    assert all(plain)
    assert sharded == plain
    assert all(sum(ln.startswith("| Flow ID") or "Flow ID" in ln
                   for ln in m) >= 3 for m in sharded)

"""The scenario campaign runner: drive a declarative timeline through
the REAL serve composition and score it against its SLO gates — the
port's copy of ``traffic_classifier_sdn_tpu/scenarios/runner.py``, on
the port's serve objects and on the device ``run_scenario`` is given
(CUDA unless ``device="cpu"``).

This is deliberately NOT a simulation harness: each scenario runs the
same objects the ``serve`` command composes — a raw-mode
:class:`~traffic_classifier_sdn_tpu_torch.ingest.fanin.FanInIngest` tier
(native-ingest byte pumps, lockstep-paced), a
:class:`~traffic_classifier_sdn_tpu_torch.ingest.batcher.FlowStateEngine`
(C++ spine when built, Python fallback otherwise),
the degrade ladder / open-set gate / incremental label cache exactly
as ``cli.py`` stacks them, the latency-provenance waterfall
(obs/latency.py), and the flight recorder + metrics planes the gates
read. The tick drive order mirrors the CLI serial loop byte for byte:
``mark_tick → ingest_bytes per (sid, batch) → mark_parse → step →
mark_scatter → evict dead namespaces → idle evict → labels → seal →
mark_device → render_sample → render_visible``.

Determinism: the fan-in tier (and the degrade ladder, when armed) run
on a VIRTUAL clock the runner advances ``clock_step_s`` per tick —
quarantine deadlines, flap windows and probe schedules are measured in
ticks, so the tier-1 scenario tests sleep for nothing. Real wall time
still drives the cadence and e2e gates (those SLOs are real-time
phenomena by definition).

Gate failures record a ``scenario.gate_breach`` ring event per failed
gate and, when ``obs_dir`` is set, write an atomic post-mortem bundle
named by scenario id: the flight-recorder JSONL dump + a metrics
snapshot (obs/flight_recorder.py) + a manifest carrying the timeline
position the run ended at.

The push-mode switch is the port's ``AccountingSwitch``
(``tools/torch_fake_switch.py``); the JAX package's ``tools/fake_switch.py``
imports that package and is never loaded here.
"""

from __future__ import annotations

import importlib
import io
import json
import os
import random
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ingest.batcher import FlowStateEngine
from ..ingest.fanin import FanInIngest
from ..obs.device import DeviceTelemetry
from ..obs.flight_recorder import FlightRecorder, dump_metrics_snapshot
from ..obs.latency import LatencyProvenance
from ..obs.perf_recorder import PerfRecorder
from ..utils import faults
from ..utils.atomicio import atomic_write_bytes
from ..utils.metrics import Metrics
from .timeline import Scenario

# the flight-recorder kinds the scorecard's transition trace keeps —
# the state machines the gates watch, not the whole ring
_TRACE_KINDS = (
    "scenario.phase",
    "fanin.source_dead",
    "fanin.source_restart",
    "fanin.flap_escalated",
    "fanin.restart_refused",
    "fanin.drop",
    "degrade.transition",
    "drift.transition",
    "openset.reject",
    "latency.slo_breach",
    "fault.fire",
    "actuation.install",
    "actuation.retract",
    "actuation.refused",
    "actuation.flap_suppressed",
    "actuation.degrade",
    "actuation.probe",
    "actuation.reconcile",
    "actuation.demote",
    "actuation.repromote",
    "actuation.quarantine",
)


@dataclass
class RunContext:
    """Everything a gate or a scheduled action can reach: the live
    serve objects plus the run's collected observations (``obs``)."""

    scenario: Scenario
    tier: FanInIngest
    engine: FlowStateEngine
    metrics: Metrics
    recorder: FlightRecorder
    lat: LatencyProvenance
    inc: object = None
    openset: object = None
    degrade: object = None
    actuation: object = None
    n_classes: int = 4
    tick: int = 0
    phase: int = 0
    vclock: dict = field(default_factory=lambda: {"t": 0.0})
    obs: dict = field(default_factory=dict)

    # -- scheduled-action ops (the library's timeline verbs) ---------------
    def kill(self, sid: int) -> None:
        """Unclean-kill one source and register the death NOW (at this
        tick's virtual time): kill, join the pump, run one supervision
        pass — the flap clock starts at a deterministic tick instead
        of whenever the serve thread next polls."""
        self.tier.kill_source(sid)
        with self.tier._roster_lock:
            w = self.tier._workers[sid]
        w.join(timeout=5.0)
        self.tier._supervise()

    def restart(self, sid: int, force: bool = False) -> bool:
        ok = self.tier.restart_source(sid, force=force)
        if not ok:
            self.obs["restarts_refused"] = (
                self.obs.get("restarts_refused", 0) + 1
            )
        return ok


def _build_model(n_classes: int, device):
    """The serve composition's model: a synthetic GNB (the cheapest
    full-table family — scenario gates exercise the serve machinery,
    not model accuracy; the open-set tier is feature-space and does
    not consult the model at all), on ``device``."""
    from ..models import gnb, module_predict

    rng = np.random.RandomState(0)
    params = gnb.GnbModel.from_numpy(
        {
            "theta": rng.gamma(2.0, 100.0, (n_classes, 12)),
            "var": rng.gamma(2.0, 50.0, (n_classes, 12)) + 1.0,
            "class_prior": np.full(n_classes, 1.0 / n_classes, dtype=np.float64),
        },
        device=device,
    )
    return module_predict, params


def _block(labels) -> None:
    """Wait for a label vector still being computed on a card (host
    labels, from a demoted ladder, are already done)."""
    if isinstance(labels, torch.Tensor) and labels.device.type == "cuda":
        torch.cuda.current_stream(labels.device).synchronize()


def _compose_serve(sc: Scenario, m: Metrics, recorder: FlightRecorder,
                   engine: FlowStateEngine, vclock, device) -> tuple:
    """Stack the serving ladders exactly as cli.py does: degrade
    innermost (wrapping the device predict), open-set outermost, the
    incremental label cache around the whole composition."""
    predict, params = _build_model(sc.n_classes, device)
    degrade = None
    if sc.degrade is not None:
        from ..models import resolve_fallback
        from ..serving.degrade import DegradeLadder

        degrade = DegradeLadder(
            predict, resolve_fallback("gnb", params),
            deadline=float(sc.degrade.get("deadline", 2.0)),
            probe_every=float(sc.degrade.get("probe_every", 2.0)),
            probe_successes=int(sc.degrade.get("probe_successes", 2)),
            metrics=m, recorder=recorder,
            clock=(lambda: vclock["t"]),
            rng=random.Random(sc.fault_seed),
        )
        predict = degrade
    openset = None
    if sc.openset is not None:
        from ..serving.openset import OpenSetGate

        openset = OpenSetGate(
            predict, n_classes=sc.n_classes,
            margin=float(sc.openset.get("margin", 3.0)),
            calibration_rows=int(
                sc.openset.get("calibration_rows", 256)
            ),
            metrics=m, recorder=recorder,
        )
        predict = openset
    from ..serving.incremental import IncrementalLabels

    inc = IncrementalLabels(
        engine, predict, params, degrade=degrade,
        metrics=m, recorder=recorder,
    )
    return inc, openset, degrade


SWITCH_MODULE = "torch_fake_switch"


def _accounting_switch_cls():
    """tools/torch_fake_switch.AccountingSwitch — the dev harness lives
    outside the package on purpose (it is a test double, not a serve
    component), so the push-mode scenario resolves it off the repo's
    tools/ directory when it is not already importable. Never the JAX
    package's ``fake_switch``, which imports that package."""
    try:
        return importlib.import_module(SWITCH_MODULE).AccountingSwitch
    except ImportError:
        tools = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))),
            "tools",
        )
        if tools not in sys.path:
            sys.path.insert(0, tools)
        return importlib.import_module(SWITCH_MODULE).AccountingSwitch


def _arm_actuation(sc: Scenario, m: Metrics, recorder: FlightRecorder,
                   clock) -> tuple:
    """Build the scenario's actuation plane exactly as cli.py would:
    policy parsed against the scenario's class names (plus ``unknown``
    when the open-set tier is armed), dry-run by default, push mode
    against an in-process AccountingSwitch the runner owns. Returns
    ``(plane, switch, names)`` — all None/() when the scenario does
    not arm actuation."""
    if sc.actuation is None:
        return None, None, ()
    from ..controller.policy import parse_policy
    from ..serving.actuation import ActuationPlane, SwitchLink

    names = tuple(f"class{i}" for i in range(sc.n_classes))
    if sc.openset is not None:
        names = names + ("unknown",)
    policy = parse_policy(sc.actuation["policy"], names)
    mode = sc.actuation.get("mode", "dry-run")
    switch = None
    link_factory = None
    if mode == "push":
        switch = _accounting_switch_cls()()
        switch.start()

        def link_factory():
            return SwitchLink(switch.host, switch.port)

    plane = ActuationPlane(
        policy, mode=mode,
        k_install=int(sc.actuation.get("k_install", 3)),
        k_retract=int(sc.actuation.get("k_retract", 3)),
        clock=clock, link_factory=link_factory,
        backoff_base_s=float(sc.actuation.get("backoff_base_s", 1.0)),
        metrics=m, recorder=recorder,
        # the dry-run intended-mods table is operator UX; the
        # scorecard reads the ledger and the ring instead
        out=io.StringIO(),
    )
    return plane, switch, names


def run_scenario(sc: Scenario, *, native: str = "auto",
                 obs_dir: str | None = None, device=None) -> dict:
    """Run one scenario timeline through the real serve loop on
    ``device`` (CUDA unless ``"cpu"``, device.resolve_device); returns
    its scorecard dict (``passed``, per-gate results, latency status,
    transition trace). See the module docstring for the drive order
    and the post-mortem contract."""
    from ..device import resolve_device
    from ..native import engine as native_engine

    device = resolve_device(device)

    use_native = (
        native == "on"
        or (native == "auto" and native_engine.available())
    )
    m = Metrics()
    recorder = FlightRecorder(capacity=8192)
    # Per-scenario device plane: device memory and the dispatch age
    # scoped to this timeline, for a gate breach's post-mortem. The
    # black-box perf ring only exists when a bundle directory does — it
    # is post-mortem evidence.
    dev = DeviceTelemetry(metrics=m, recorder=recorder, device=device)
    dev.attach()
    perf = None
    if obs_dir:
        perf = PerfRecorder(
            os.path.join(obs_dir, "perf", sc.id),
            ticks_per_segment=32, keep_segments=8, metrics=m,
        )
    vclock = {"t": 0.0}
    clock = time.monotonic if sc.real_clock else (lambda: vclock["t"])
    tier = FanInIngest(
        sc.sources, queue_records=sc.queue_records,
        quarantine_s=sc.quarantine_s, metrics=m, recorder=recorder,
        clock=clock, stamp=True, raw=True,
        max_flaps=sc.max_flaps, flap_window_s=sc.flap_window_s,
    )
    engine = FlowStateEngine(
        sc.capacity, device=device, native=use_native, track_dirty=True,
    )
    lat = LatencyProvenance(m, recorder, slo_s=sc.e2e_slo_s)
    inc, openset, degrade = _compose_serve(
        sc, m, recorder, engine, vclock, device,
    )
    actuation, switch, act_names = _arm_actuation(sc, m, recorder, clock)
    ctx = RunContext(
        scenario=sc, tier=tier, engine=engine, metrics=m,
        recorder=recorder, lat=lat, inc=inc, openset=openset,
        degrade=degrade, actuation=actuation, n_classes=sc.n_classes,
        vclock=vclock,
    )
    ctx.obs["tick_wall_s"] = []
    ctx.obs["evicted_slots"] = 0
    ctx.obs["evicted_sids"] = set()
    plan = faults.FaultPlan(
        [faults.FaultRule(**r) for r in sc.fault_rules],
        seed=sc.fault_seed,
    )
    labels = None
    # Warm the serve OUTSIDE the timeline: the composed predict's first
    # call at (capacity, 12) and the incremental dirty-update path's
    # first non-full sweep pay one-time costs (allocator growth, library
    # handles on a card) — without this, tick 0's cadence/e2e samples
    # would measure them, not the scenario. Runs before faults install, so it
    # consumes no fault-rule `after` budget. The traffic half drives a
    # throwaway namespace (sid 63) through ingest → step → labels
    # twice (full path, then dirty path) and evicts it; it is SKIPPED
    # when the scenario arms the open-set tier, whose calibration
    # would otherwise consume the throwaway rows (openset scenarios
    # do not gate e2e, so the one-off compile there is harmless).
    _block(inc.labels())
    if sc.openset is None:
        from ..ingest.replay import SyntheticFlows

        warm_gen = SyntheticFlows(4, seed=99, mac_base=1 << 40)
        for _ in range(2):
            engine.mark_tick()
            engine.ingest_bytes(warm_gen.tick_bytes(), 63)
            engine.step()
            _block(inc.labels())
        engine.evict_source(63)
        inc.invalidate("scenario-warmup")
        _block(inc.labels())
    # Openset scenarios skip the traffic warm above (they do not gate
    # on e2e).
    dev.mark_warmup_complete()
    tier.start()
    gen = tier.ticks(tick_timeout=sc.tick_timeout, poll_s=0.005)
    try:
        with faults.installed(plan), recorder.observing_faults():
            for tick in range(sc.total_ticks):
                ctx.tick = tick
                phase_idx, phase = sc.phase_at(tick)
                if phase_idx != ctx.phase or tick == 0:
                    ctx.phase = phase_idx
                    m.set("scenario_phase", phase_idx)
                    recorder.record(
                        "scenario.phase", scenario=sc.id, tick=tick,
                        phase=phase.name, index=phase_idx,
                    )
                for action in sc.actions.get(tick, ()):
                    action(ctx)
                t0 = time.perf_counter()
                batch = next(gen, None)
                if batch is None:
                    break  # every source ended and the queue drained
                lat.begin_tick(tier.pop_provenance())
                engine.mark_tick()
                n_rec = sum(
                    engine.ingest_bytes(data, sid)
                    for sid, data in batch
                )
                m.inc("records", n_rec)
                lat.mark_parse()
                engine.step()
                lat.mark_scatter()
                for sid in tier.take_evictions():
                    ctx.obs["evicted_sids"].add(sid)
                    n = engine.evict_source(sid)
                    ctx.obs["evicted_slots"] += n
                    m.inc("evicted", n)
                    lat.drop_source(sid)
                    if inc is not None and n:
                        inc.invalidate(f"evict-source-{sid}")
                if sc.idle_evict_s is not None and engine.last_time:
                    n = engine.evict_idle(
                        engine.last_time, sc.idle_evict_s,
                    )
                    ctx.obs["evicted_slots"] += n
                    m.inc("evicted", n)
                    if inc is not None and n:
                        inc.invalidate("idle-evict")
                seal = lat.seal()
                dev.mark_dispatch()
                labels = inc.labels()
                _block(labels)
                lat.mark_device(seal)
                rendered = engine.render_sample(labels, sc.table_rows)
                lat.render_visible(seal)
                if actuation is not None:
                    # the plane sees what the serve renders: the same
                    # (slot, src, dst, label-name) rows cli.py feeds it
                    meta = engine.slot_metadata(
                        slots=[r[0] for r in rendered],
                    )
                    actuation.observe([
                        (slot, *meta[slot],
                         act_names[c] if c < len(act_names) else "?")
                        for slot, c, _fa, _ra in rendered
                        if slot in meta
                    ])
                wall = time.perf_counter() - t0
                ctx.obs["tick_wall_s"].append(wall)
                devs = dev.sample()
                if perf is not None:
                    sample = {
                        "tick": tick,
                        "phase": phase.name,
                        "tick_wall_s": round(wall, 6),
                        "jit_compiles": devs["jit_compiles"],
                        "retraces_after_warmup": devs[
                            "retraces_after_warmup"
                        ],
                    }
                    if devs["hbm_bytes"] is not None:
                        sample["hbm_bytes"] = devs["hbm_bytes"]
                    perf.record(sample)
                vclock["t"] += sc.clock_step_s
    finally:
        gen.close()
        tier.stop()
        if degrade is not None:
            degrade.close()
        if actuation is not None:
            actuation.close()
        if switch is not None:
            switch.stop()
        if perf is not None:
            perf.flush()
        dev.detach()
    # final-state observations the ground-truth gates read: per-MAC
    # labels from the last tick's full label vector (capacities here
    # are scenario-sized — the full fetch the 2²⁰ serve avoids is
    # fine). One slot per conversation: both endpoints carry its label.
    mac_labels: dict = {}
    if labels is not None:
        lab = (labels.cpu().numpy() if isinstance(labels, torch.Tensor)
               else np.asarray(labels))
        for slot, (src, dst) in engine.slot_metadata().items():
            if slot < lab.shape[0]:
                mac_labels[src] = int(lab[slot])
                mac_labels[dst] = int(lab[slot])
    ctx.obs["mac_labels"] = mac_labels
    results = [g.evaluate(ctx) for g in sc.gates]
    passed = all(r.passed for r in results)
    card = {
        "scenario": sc.id,
        "title": sc.title,
        "passed": passed,
        "ticks_run": len(ctx.obs["tick_wall_s"]),
        "phases": [
            {"name": p.name, "ticks": p.ticks} for p in sc.phases
        ],
        "gates": [r.as_dict() for r in results],
        "latency": lat.status(),
        "flows": engine.num_flows(),
        "records": int(m.counters.get("records", 0)),
        "parse_errors": engine.parse_errors(),
        "evicted_slots": int(ctx.obs["evicted_slots"]),
        "transitions": _transition_trace(recorder),
        "engine": "native" if use_native else "python",
        "device": dev.status(),
    }
    if actuation is not None:
        card["actuation"] = actuation.status()
        if switch is not None:
            card["switch"] = {
                "installs": switch.installs(),
                "deletes": switch.deletes(),
                "refusals": switch.refusals(),
                "live_rules": len(switch.live_cookies()),
                "barriers": switch.barriers,
            }
    if not passed:
        for r in results:
            if not r.passed:
                recorder.record(
                    "scenario.gate_breach", scenario=sc.id,
                    gate=r.id, value=r.value, bound=r.bound,
                    detail=r.detail,
                )
        if obs_dir:
            card["post_mortem"] = _dump_post_mortem(
                sc, ctx, m, recorder, results, obs_dir,
                dev=dev, perf=perf,
            )
    return card


def _transition_trace(recorder: FlightRecorder) -> list[dict]:
    """The scorecard's compact state-machine trace: only the watched
    kinds, only the fields that tell the story."""
    out = []
    for e in recorder.tail(4096):
        if e.get("kind") not in _TRACE_KINDS:
            continue
        row = {
            k: v for k, v in e.items()
            if k not in ("ts",)
        }
        out.append(row)
    return out


def _dump_post_mortem(sc: Scenario, ctx: RunContext, m: Metrics,
                      recorder: FlightRecorder, results,
                      obs_dir: str, dev=None, perf=None) -> dict:
    """A gate failure leaves an atomic bundle named by scenario id —
    flight-recorder JSONL + metrics snapshot + a manifest carrying the
    timeline position. Forensics must never become a second failure:
    each piece is attempted independently and the manifest records
    what landed."""
    reason = f"scenario-{sc.id}"
    bundle: dict = {"scenario": sc.id}
    try:
        bundle["flight"] = recorder.dump(obs_dir, reason)
    except OSError as e:
        bundle["flight_error"] = str(e)
    try:
        bundle["metrics"] = dump_metrics_snapshot(m, obs_dir, reason)
    except OSError as e:
        bundle["metrics_error"] = str(e)
    phase_idx, phase = sc.phase_at(max(0, ctx.tick))
    manifest = {
        "scenario": sc.id,
        "title": sc.title,
        "timeline_position": {
            "tick": ctx.tick,
            "total_ticks": sc.total_ticks,
            "phase": phase.name,
            "phase_index": phase_idx,
        },
        "failed_gates": [
            r.as_dict() for r in results if not r.passed
        ],
        "flight": bundle.get("flight"),
        "metrics": bundle.get("metrics"),
    }
    # Device-plane evidence: what the chip was doing when the gate
    # broke. Attempted independently — a wedged device must not cost
    # us the manifest.
    if dev is not None:
        try:
            manifest["device"] = dev.status()
        except Exception as e:
            manifest["device_error"] = str(e)
    if perf is not None:
        try:
            perf.flush()
            manifest["perf_tail"] = perf.tail(32)
        except Exception as e:
            manifest["perf_tail_error"] = str(e)
    path = os.path.join(obs_dir, f"scenario-{sc.id}-postmortem.json")
    try:
        os.makedirs(obs_dir, exist_ok=True)
        atomic_write_bytes(
            path, json.dumps(manifest, indent=2).encode(),
        )
        bundle["manifest"] = path
    except OSError as e:
        bundle["manifest_error"] = str(e)
    return bundle


def run_campaign(scenarios, *, native: str = "auto",
                 obs_dir: str | None = None,
                 platform: str = "cpu", device=None) -> dict:
    """Run a scenario list on ``device`` and fold the scorecards into
    the campaign matrix (the JAX package's ``scenario_matrix_<platform>
    .json`` shape). ``passed`` is the conjunction — the matrix is a
    gate, not a report."""
    cards = [
        run_scenario(sc, native=native, obs_dir=obs_dir, device=device)
        for sc in scenarios
    ]
    return {
        "platform": platform,
        "scenarios": cards,
        "passed": all(c["passed"] for c in cards),
        "gate_failures": [
            {"scenario": c["scenario"], "gate": g["id"]}
            for c in cards
            for g in c["gates"] if not g["passed"]
        ],
    }

"""The scenario library: the adversarial timelines the campaign runs
(ISSUE 16 / F13, docs/ROBUSTNESS.md).

Each builder composes a :class:`~.timeline.Scenario` from the existing
generators — ``ingest/replay.SyntheticFlows`` for rate-shaped
populations, ``ingest/workload.ClassWorkload`` + ``perturb_pools`` /
``novel_delta_pool`` for class-conditional and open-world traffic —
scripted through ``feed``-kind SourceSpecs (one callable per source,
returning each poll tick's wire bytes). Feeds are STATEFUL closures
that ignore the pump's tick index for content decisions driven by
global time would break under restart; instead they carry their own
cumulative-counter state forward, which is exactly the
monitor-restart story the tier is built around (a restarted feed
resumes its counters → one large first delta).

Two profiles per scenario:

- ``t1``  — scaled down for the tier-1 suite: small populations, short
  phases, everything timed on the virtual clock (no sleeps);
- ``cpu`` — the committed-artifact shape (tools/bench_scenarios.py →
  docs/artifacts/scenario_matrix_cpu.json): larger populations, longer
  phases, same gates.

``SCENARIOS`` maps scenario id → builder; ``build(name, profile)``
instantiates one (builders return FRESH generator state per call —
scenarios are single-use, like fault plans).

The port's copy of ``traffic_classifier_sdn_tpu/scenarios/library.py``, on the port's
ingest modules: the same timelines, the same gates.
"""

from __future__ import annotations

from ..ingest.fanin import SourceSpec
from ..ingest.protocol import format_line
from ..ingest.replay import SyntheticFlows
from ..ingest.workload import (
    ClassWorkload,
    novel_delta_pool,
    perturb_pools,
    synthetic_delta_pools,
)
from .timeline import (
    Gate,
    GateResult,
    Phase,
    Scenario,
    gate_accounting,
    gate_cadence,
    gate_drops,
    gate_e2e_p99,
    gate_events,
    gate_evicted,
    gate_feature_sanity,
    gate_final_state,
    gate_flows,
    gate_known_accept,
    gate_namespace_evicted,
    gate_restart_refused,
    gate_rule_accounting,
    gate_rules_installed,
    gate_unknown_recall,
    gate_zero_rule_flaps,
)

_PROFILES = ("t1", "cpu")


def _check_profile(profile: str) -> bool:
    if profile not in _PROFILES:
        raise ValueError(
            f"unknown scenario profile {profile!r} (expected one of "
            f"{_PROFILES})"
        )
    return profile == "t1"


def _feed_spec(sid: int, feed, name: str = "") -> SourceSpec:
    return SourceSpec(
        kind="feed", sid=sid, feed=feed, lockstep=True, name=name,
    )


def _records_feed(workloads, start_tick: int = 0):
    """A feed emitting ``format_line`` wire bytes for each workload's
    ``tick()`` records — silent (noise line) before ``start_tick``.
    Stateful: counters advance only on emitting ticks."""
    n = {"i": 0}

    def feed(_i: int) -> bytes:
        i = n["i"]
        n["i"] = i + 1
        if i < start_tick:
            return b""
        return b"".join(
            format_line(r) for w in workloads for r in w.tick()
        )

    return feed


# -- 1 · flash crowd ---------------------------------------------------------

def flash_crowd(profile: str = "t1") -> Scenario:
    """10× source ramp mid-serve: one source carries the baseline,
    then nine more populations light up on the SAME serve loop in one
    tick. The serve must absorb a 10× record-rate and flow-population
    step without dropping a record or losing its cadence."""
    t1 = _check_profile(profile)
    n_sources = 10
    flows = 8 if t1 else 32
    baseline = 3 if t1 else 5
    surge = 5 if t1 else 15

    def make_feed(sid: int):
        gen = SyntheticFlows(flows, seed=sid, mac_base=sid * flows)
        start = 0 if sid == 0 else baseline

        def feed(_i: int, n={"i": 0}) -> bytes:
            i = n["i"]
            n["i"] = i + 1
            return gen.tick_bytes() if i >= start else b""

        return feed

    sources = tuple(
        _feed_spec(sid, make_feed(sid), f"crowd-{sid}")
        for sid in range(n_sources)
    )
    total_flows = n_sources * flows  # one flow slot per conversation
    return Scenario(
        id="flash_crowd",
        title="flash crowd: 10x source ramp mid-serve",
        phases=(Phase("baseline", baseline), Phase("surge", surge)),
        sources=sources,
        capacity=max(256, 2 * total_flows),
        gates=(
            gate_cadence(1.0),
            gate_accounting(),
            gate_drops(expect=False),
            gate_e2e_p99(1.0),
            gate_flows(total_flows, total_flows),
        ),
        notes=f"{n_sources} sources x {flows} conversations",
    )


# -- 2 · source flap storm ---------------------------------------------------

def source_flap_storm(profile: str = "t1") -> Scenario:
    """Repeated unclean deaths + restarts racing the quarantine timer
    — the livelock satellite 1 fixed: each restart used to cancel the
    pending quarantine forever. The tier must ESCALATE after the flap
    cap, refuse further restarts, and let the quarantine finally evict
    the namespace while the other sources keep serving."""
    t1 = _check_profile(profile)
    flows = 8 if t1 else 16
    victim = 2

    def make_feed(sid: int):
        gen = SyntheticFlows(flows, seed=sid, mac_base=sid * flows)
        return lambda _i: gen.tick_bytes()

    sources = tuple(
        _feed_spec(sid, make_feed(sid), f"flap-{sid}")
        for sid in range(3)
    )
    # virtual-time script (clock_step_s=1.0 → vt == tick index):
    # kill@2 (quarantine deadline 5) → restart@3 cancels it;
    # kill@4 (deadline 7) → restart@5 cancels; kill@6 is the 3rd flap
    # inside the window → ESCALATED, deadline 9 stands; restart@7 is
    # REFUSED; take_evictions at vt=9 evicts the namespace.
    actions = {
        2: (lambda ctx: ctx.kill(victim),),
        3: (lambda ctx: ctx.restart(victim),),
        4: (lambda ctx: ctx.kill(victim),),
        5: (lambda ctx: ctx.restart(victim),),
        6: (lambda ctx: ctx.kill(victim),),
        7: (lambda ctx: ctx.restart(victim),),
    }
    return Scenario(
        id="source_flap_storm",
        title="source flap storm: restarts racing the quarantine",
        phases=(
            Phase("steady", 2),
            Phase("flapping", 6),
            Phase("escalated", 6),
        ),
        sources=sources,
        actions=actions,
        capacity=max(256, 3 * flows * 4),
        quarantine_s=3.0,
        max_flaps=3,
        flap_window_s=60.0,
        gates=(
            gate_events(required=(
                "fanin.source_dead",
                "fanin.source_restart",
                "fanin.flap_escalated",
                "fanin.restart_refused",
            )),
            gate_restart_refused(1),
            gate_namespace_evicted(victim),
            gate_flows(2 * flows, 2 * flows),
            gate_cadence(1.0),
            gate_accounting(),
            gate_drops(expect=False),
        ),
        notes="victim sid 2 flaps 3x; survivors keep serving",
    )


# -- 3 · cumulative-counter reset storm --------------------------------------

def counter_reset_storm(profile: str = "t1") -> Scenario:
    """Mod-2^32 deltas across MANY flows in ONE tick: the whole
    population's cumulative counters reset simultaneously (a switch
    reboot, not a single flow re-add — PR 13 pinned the single-flow
    shape). Every feature must stay physically plausible and the flow
    population must not change."""
    t1 = _check_profile(profile)
    flows = 32 if t1 else 256
    pre = 3 if t1 else 5
    post = 4 if t1 else 6
    state = {"gen": SyntheticFlows(flows, seed=3)}

    def feed(_i: int, n={"i": 0}) -> bytes:
        i = n["i"]
        n["i"] = i + 1
        if i == pre:
            # the storm: a fresh generator, same flow keys (same seed/
            # mac_base), counters restarted from zero — every flow's
            # next cumulative value goes BACKWARD in the same tick
            state["gen"] = SyntheticFlows(
                flows, seed=3, start_time=state["gen"].t,
            )
        return state["gen"].tick_bytes()

    return Scenario(
        id="counter_reset_storm",
        title="cumulative-counter reset storm across the population",
        phases=(Phase("cruise", pre), Phase("reset_storm", post)),
        sources=(_feed_spec(0, feed, "reset-storm"),),
        capacity=max(256, flows * 4),
        gates=(
            gate_feature_sanity(1e9),
            gate_flows(flows, flows),
            gate_cadence(1.0),
            gate_accounting(),
            gate_drops(expect=False),
        ),
        notes=f"{flows} conversations reset in one tick",
    )


# -- 4 · novel-class wave + boundary-hugging evasion -------------------------

def novel_wave_evasion(profile: str = "t1") -> Scenario:
    """Open-world under adversarial pressure: the stream carries a
    closed-world base AND boundary-hugging perturbed flows
    (workload.perturb_pools — hardest known rows) from tick 0; a NOVEL
    class joins mid-run. The calibrated open-set tier must reject the
    novel wave as ``unknown`` while NOT rejecting the evasion flows it
    calibrated over."""
    t1 = _check_profile(profile)
    fpc = 2 if t1 else 6
    calibrate = 5 if t1 else 8
    wave = 5 if t1 else 8
    pools = synthetic_delta_pools(4)
    base = ClassWorkload(pools, flows_per_class=fpc, seed=0)
    evasion = ClassWorkload(
        perturb_pools(pools, epsilon=0.2), flows_per_class=fpc,
        seed=1, mac_base=2 * len(base.labels),
    )
    novel = ClassWorkload(
        {"novel": novel_delta_pool(pools)},
        flows_per_class=max(2, fpc), seed=2,
        mac_base=2 * len(base.labels) + 2 * len(evasion.labels),
    )
    known_macs = {
        mac
        for w in (base, evasion)
        for i in range(len(w.labels))
        for mac in w.flow_macs(i)
    }
    novel_macs = {
        mac
        for i in range(len(novel.labels))
        for mac in novel.flow_macs(i)
    }
    known_feed = _records_feed([base, evasion])
    wave_feed = _records_feed([novel], start_tick=calibrate)

    def feed(i: int) -> bytes:
        return known_feed(i) + wave_feed(i)

    n_known_rows = 2 * (len(base.labels) + len(evasion.labels))
    return Scenario(
        id="novel_wave_evasion",
        title="novel-class wave + boundary-hugging evasion",
        phases=(Phase("calibrate", calibrate), Phase("wave", wave)),
        sources=(_feed_spec(0, feed, "open-world"),),
        capacity=max(128, 4 * n_known_rows),
        n_classes=4,
        openset={
            "margin": 3.0,
            # arm inside the calibrate phase: ~n_known_rows active
            # rows fold in per tick
            "calibration_rows": 2 * n_known_rows,
        },
        gates=(
            gate_unknown_recall(novel_macs, min_recall=0.9),
            gate_known_accept(known_macs, max_reject=0.05),
            gate_events(required=("openset.reject",)),
            gate_cadence(1.0),
            gate_accounting(),
            gate_drops(expect=False),
        ),
        notes="evasion flows inside the calibration envelope",
    )


# -- 5 · mass-eviction churn spike -------------------------------------------

def mass_eviction_churn(profile: str = "t1") -> Scenario:
    """A churn spike: most of the flow population goes silent at once
    and must be idle-evicted in bulk while a live population keeps
    serving — the table shrinks by thousands of slots (profile-scaled)
    without a cadence wobble or an accounting gap."""
    t1 = _check_profile(profile)
    doomed_flows = 24 if t1 else 512
    live_flows = 8 if t1 else 64
    mixed = 4 if t1 else 6
    churn = 8 if t1 else 10
    idle_s = 3
    doomed = SyntheticFlows(doomed_flows, seed=4)
    live = SyntheticFlows(
        live_flows, seed=5, mac_base=doomed_flows + 8,
    )

    def feed(_i: int, n={"i": 0}) -> bytes:
        i = n["i"]
        n["i"] = i + 1
        if i < mixed:
            return doomed.tick_bytes() + live.tick_bytes()
        return live.tick_bytes()

    return Scenario(
        id="mass_eviction_churn",
        title="mass-eviction churn spike",
        phases=(Phase("mixed", mixed), Phase("churn", churn)),
        sources=(_feed_spec(0, feed, "churn"),),
        capacity=max(256, (doomed_flows + live_flows) * 4),
        idle_evict_s=float(idle_s),
        gates=(
            gate_evicted(doomed_flows),
            gate_flows(live_flows, live_flows),
            gate_cadence(1.0),
            gate_accounting(),
            gate_drops(expect=False),
        ),
        notes=f"{doomed_flows} conversations go silent at tick {mixed}",
    )


# -- 6 · queue-saturation flood ----------------------------------------------

def queue_saturation_flood(profile: str = "t1") -> Scenario:
    """Aggregate rate past the FanInQueue bound: two sources whose
    combined per-tick record count overflows the queue. The contract
    under saturation is NOT zero drops — it is zero SILENT drops:
    every dropped batch is counted against its source, accounting
    stays exact, and the loop keeps its cadence. Runs on the REAL
    clock: the starved lockstep slot can never deliver its dropped
    batch, so the tick-assembly deadline must actually expire."""
    t1 = _check_profile(profile)
    modest = 8 if t1 else 32
    flood = 40 if t1 else 160
    ticks = 5 if t1 else 8

    def make_feed(sid: int, flows: int):
        gen = SyntheticFlows(flows, seed=sid, mac_base=sid * flood)
        return lambda _i: gen.tick_bytes()

    return Scenario(
        id="queue_saturation_flood",
        title="queue-saturation flood past the fan-in bound",
        phases=(Phase("flood", ticks),),
        sources=(
            _feed_spec(0, make_feed(0, modest), "flood-modest"),
            _feed_spec(1, make_feed(1, flood), "flood-heavy"),
        ),
        capacity=max(256, flood * 2 * 4),
        # deterministic saturation, no drain race: the modest source's
        # 2*modest-record batch always fits the bound, the heavy
        # source's 2*flood-record batch NEVER does (even into an empty
        # queue) — every one of its ticks drops whole and attributed
        queue_records=4 * modest,
        real_clock=True,
        tick_timeout=0.25,
        gates=(
            gate_drops(expect=True),
            gate_accounting(),
            gate_events(required=("fanin.drop",)),
            gate_flows(modest, modest),
            gate_cadence(1.0),
        ),
        notes="heavy source's batch alone exceeds the queue bound",
    )


# -- 7 · device wedge + degrade recovery -------------------------------------

def device_wedge_degrade(profile: str = "t1") -> Scenario:
    """A device dispatch stall mid-serve (fault site
    ``degrade.dispatch_stall``): the ladder must demote to the host
    fallback without missing a tick, probe on the virtual clock, and
    END the run recovered (final transition back to HEALTHY)."""
    t1 = _check_profile(profile)
    flows = 16 if t1 else 64
    gen = SyntheticFlows(flows, seed=6)
    return Scenario(
        id="device_wedge_degrade",
        title="device wedge: degrade demotion + probed recovery",
        phases=(
            Phase("healthy", 3),
            Phase("wedged", 4),
            Phase("recovery", 8),
        ),
        sources=(
            _feed_spec(0, lambda _i: gen.tick_bytes(), "wedge"),
        ),
        capacity=max(256, flows * 4),
        degrade={
            "deadline": 2.0,
            "probe_every": 1.5,
            "probe_successes": 2,
        },
        # 3rd in-plan device call wedges (ticks 0,1 pass → tick 2)
        fault_rules=(
            {"site": "degrade.dispatch_stall", "after": 2, "times": 1},
        ),
        gates=(
            gate_events(required=("degrade.transition", "fault.fire")),
            gate_final_state("degrade.transition", "to", "HEALTHY"),
            gate_cadence(1.0),
            gate_accounting(),
            gate_drops(expect=False),
            gate_e2e_p99(2.5),
        ),
        notes="dispatch stall at tick 2; probes on the virtual clock",
    )


# -- 8 · label flap storm vs the actuation hysteresis ------------------------

def label_flap_storm(profile: str = "t1") -> Scenario:
    """Class-boundary oscillation vs the actuation plane (F14): a
    stable population earns its flow-rules, an oscillating population
    flips label every tick (its per-tick deltas alternate between the
    lightest and heaviest class pools — the classifier cannot hold a
    verdict), and a novel wave joins mid-run to blip the open-set
    ``unknown`` through the rendered table. Push mode against the
    AccountingSwitch with an ``actuation.send`` fault mid-storm: the
    plane must degrade to dry-run, re-probe on the virtual clock,
    reconcile, and re-earn its installs — with ZERO rule flaps, the
    rule ledger exact, and the serve cadence untouched throughout."""
    t1 = _check_profile(profile)
    fpc = 2 if t1 else 4               # stable flows per class (4 classes)
    osc_flows = 4 if t1 else 8
    novel_flows = 2 if t1 else 4
    calibrate = 4 if t1 else 6
    storm = 6 if t1 else 10
    wave = 6 if t1 else 8
    pools = synthetic_delta_pools(4)
    stable = ClassWorkload(pools, flows_per_class=fpc, seed=0)
    # the oscillator: same conversations every tick, but the pool its
    # deltas draw from alternates between the lightest and heaviest
    # class shape — cumulative counters stay monotonic (no wrap
    # artifacts), the per-tick features swing ~64x, and the label
    # cannot complete an install streak
    keys = sorted(pools)
    osc_pools = {"osc": pools[keys[0]]}
    osc = ClassWorkload(
        osc_pools, flows_per_class=osc_flows, seed=7,
        mac_base=4 * len(stable.labels),
    )
    novel = ClassWorkload(
        {"novel": novel_delta_pool(pools)},
        flows_per_class=novel_flows, seed=2,
        mac_base=4 * len(stable.labels) + 4 * len(osc.labels),
    )
    stable_feed = _records_feed([stable])
    wave_feed = _records_feed([novel], start_tick=calibrate + storm)

    def osc_feed(_i: int, n={"i": 0}) -> bytes:
        i = n["i"]
        n["i"] = i + 1
        osc_pools["osc"] = pools[keys[0]] if i % 2 else pools[keys[-1]]
        return b"".join(format_line(r) for r in osc.tick())

    def feed(i: int) -> bytes:
        return stable_feed(i) + osc_feed(i) + wave_feed(i)

    n_flows = len(stable.labels) + len(osc.labels)
    return Scenario(
        id="label_flap_storm",
        title="label flap storm vs the actuation hysteresis",
        phases=(
            Phase("calibrate", calibrate),
            Phase("storm", storm),
            Phase("wave", wave),
        ),
        sources=(_feed_spec(0, feed, "flap-storm"),),
        capacity=max(256, 8 * (n_flows + novel_flows)),
        table_rows=2 * (n_flows + novel_flows),
        n_classes=4,
        openset={
            "margin": 3.0,
            "calibration_rows": 2 * n_flows,
        },
        actuation={
            # every class carries a clause: any stable verdict earns a
            # rule, so the hysteresis is exercised on the whole table
            "policy": ("class0=queue:1,class1=queue:2,"
                       "class2=meter:5,class3=drop"),
            "mode": "push",
            "k_install": 3,
            "k_retract": 3,
            "backoff_base_s": 1.0,
        },
        # mid-storm wire fault: the 3rd pushed mod dies — the first
        # install burst must degrade to dry-run, not break accounting
        fault_rules=(
            {"site": "actuation.send", "after": 2, "times": 1},
        ),
        gates=(
            gate_zero_rule_flaps(min_suppressed=1),
            gate_rule_accounting(),
            gate_rules_installed(len(stable.labels)),
            gate_events(required=(
                "actuation.install",
                "actuation.flap_suppressed",
                "actuation.degrade",
                "actuation.probe",
                "actuation.reconcile",
                "fault.fire",
                "openset.reject",
            )),
            gate_cadence(1.0),
            gate_accounting(),
            gate_drops(expect=False),
        ),
        notes=(f"{len(stable.labels)} stable + {len(osc.labels)} "
               f"oscillating conversations; novel wave at tick "
               f"{calibrate + storm}"),
    )


SCENARIOS = {
    "flash_crowd": flash_crowd,
    "source_flap_storm": source_flap_storm,
    "counter_reset_storm": counter_reset_storm,
    "novel_wave_evasion": novel_wave_evasion,
    "mass_eviction_churn": mass_eviction_churn,
    "queue_saturation_flood": queue_saturation_flood,
    "device_wedge_degrade": device_wedge_degrade,
    "label_flap_storm": label_flap_storm,
}


def build(name: str, profile: str = "t1") -> Scenario:
    """Instantiate one scenario by id (fresh generator state)."""
    try:
        builder = SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r} (known: {sorted(SCENARIOS)})"
        ) from None
    return builder(profile)


__all__ = [
    "SCENARIOS",
    "build",
    "Gate",
    "GateResult",
    "Phase",
    "Scenario",
]

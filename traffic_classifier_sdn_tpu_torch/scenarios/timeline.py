"""Scenario timelines and SLO gates — the declarative half of the
adversarial-scenario campaign (F13, docs/ROBUSTNESS.md).

A :class:`Scenario` is a declarative timeline: named phases (each a
tick count), a set of fan-in sources (usually ``feed``-kind
SourceSpecs whose scripts compose the existing generators —
``ingest/replay.SyntheticFlows``, ``ingest/workload.ClassWorkload`` /
``OpenWorldWorkload`` / ``perturb_pools``), scheduled actions at
specific ticks (kill/restart a source, arm nothing new — fault
schedules ride the existing ``utils/faults.SITES`` seams via
``fault_rules``), and a list of SLO :class:`Gate`\\ s evaluated against
the REAL serve loop's observability planes after the run.

Gates are factory-built closures: each returns a :class:`GateResult`
with the measured value beside its bound, so the campaign scorecard
(tools/bench_scenarios.py → docs/artifacts/scenario_matrix_cpu.json)
carries evidence, not just verdicts. The shared gate vocabulary:

- ``cadence_p50``      — scenario tick wall time p50 within bound (the
  1 s cadence SLO, scaled for test profiles)
- ``accounting_exact`` — per-source ``emitted == accepted + (drops −
  purged)``: NO silent drops, ever, in any scenario
- ``drops``            — put-time drops exactly zero (default) or
  expected-and-accounted (the queue-saturation flood)
- ``e2e_p99``          — latency-provenance e2e p99 within bound
  (PR 11's waterfall)
- ``events``           — required flight-recorder kinds observed (and
  forbidden kinds absent): the degrade/drift/fan-in transition gates
- ``final_state``      — the LAST event of a kind carries an expected
  field value (recovery checks: the ladder must end HEALTHY)
- plus scenario-shaped gates over the engine (flow population bounds,
  post-reset feature sanity, eviction counts) and over open-set ground
  truth (novel flows rejected, boundary-hugging evasion NOT rejected).

Everything here is pure data + closures — the drive loop lives in
``scenarios/runner.py``.

The port's copy of ``traffic_classifier_sdn_tpu/scenarios/timeline.py``, on the port's
ingest modules: the same timelines, the same gates.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class Phase:
    """One named span of the scenario timeline, ``ticks`` serve ticks
    long. The runner publishes the active phase index as the
    ``scenario_phase`` gauge and records ``scenario.phase`` to the
    flight recorder at each boundary."""

    name: str
    ticks: int


@dataclass
class GateResult:
    """One gate's verdict with its evidence: the measured ``value``
    beside the ``bound`` it was held to."""

    id: str
    passed: bool
    value: object = None
    bound: object = None
    detail: str = ""

    def as_dict(self) -> dict:
        return {
            "id": self.id,
            "passed": bool(self.passed),
            "value": self.value,
            "bound": self.bound,
            "detail": self.detail,
        }


@dataclass
class Gate:
    """A named SLO check: ``fn(ctx) -> GateResult`` evaluated by the
    runner after the timeline completes (``ctx`` is the runner's
    RunContext — tier, engine, metrics, recorder, latency plane, and
    the run's collected observations)."""

    id: str
    fn: object

    def evaluate(self, ctx) -> GateResult:
        try:
            return self.fn(ctx)
        except Exception as e:  # noqa: BLE001 — a broken gate is a failed gate
            return GateResult(
                self.id, False,
                detail=f"gate crashed: {type(e).__name__}: {e}",
            )


@dataclass
class Scenario:
    """One declarative adversarial scenario (see module docstring).

    ``sources`` are ``ingest.fanin.SourceSpec`` rows (normally
    ``feed``-kind, lockstep). ``actions`` maps a global tick index to
    callables run at that tick's START, before the tier assembles the
    tick (``fn(ctx)`` — the library builds them from the runner's ops
    helpers). ``fault_rules`` are ``utils.faults.FaultRule`` kwargs
    dicts (fresh rule objects are built per run — rules carry fired
    state). Clocks: the tier runs on a VIRTUAL clock the runner
    advances ``clock_step_s`` per tick, so quarantine windows, flap
    windows and degrade probe schedules are measured in ticks —
    deterministic, no sleeps."""

    id: str
    title: str
    phases: tuple
    sources: tuple
    gates: tuple
    actions: dict = field(default_factory=dict)
    fault_rules: tuple = ()
    fault_seed: int = 0
    capacity: int = 256
    queue_records: int = 4096
    quarantine_s: float = 3.0
    max_flaps: int = 5
    flap_window_s: float = 60.0
    clock_step_s: float = 1.0
    tick_timeout: float = 2.0
    table_rows: int = 8
    n_classes: int = 4
    openset: dict | None = None  # {"margin":…, "calibration_rows":…}
    degrade: dict | None = None  # {"deadline":…, "probe_every":…, …}
    # arm the actuation plane (serving/actuation.py): {"policy": SPEC,
    # "mode": "dry-run"|"push", "k_install":…, "k_retract":…,
    # "backoff_base_s":…}. Push mode runs against an in-process
    # AccountingSwitch (tools/fake_switch.py) the runner owns.
    actuation: dict | None = None
    idle_evict_s: float | None = None
    e2e_slo_s: float = 0.0
    # run the tier on REAL time instead of the virtual clock: required
    # when a live lockstep source can fail to deliver a granted tick
    # (the queue-saturation flood drops its batch at the bound) — the
    # assembly deadline must then expire on real time or the tick
    # never completes. Only valid for scenarios with no quarantine /
    # flap / probe timing, which would otherwise lose determinism.
    real_clock: bool = False
    notes: str = ""

    @property
    def total_ticks(self) -> int:
        return sum(p.ticks for p in self.phases)

    def phase_at(self, tick: int) -> tuple[int, Phase]:
        """(phase index, Phase) covering global ``tick``."""
        acc = 0
        for i, p in enumerate(self.phases):
            acc += p.ticks
            if tick < acc:
                return i, p
        return len(self.phases) - 1, self.phases[-1]


# -- gate factories ----------------------------------------------------------

def gate_cadence(p50_bound_s: float = 1.0) -> Gate:
    """Serve cadence held: p50 of full scenario tick wall time (tick
    assembly + ingest + predict + render) within the bound."""

    def fn(ctx) -> GateResult:
        ticks = ctx.obs.get("tick_wall_s", [])
        if not ticks:
            return GateResult("cadence_p50", False, detail="no ticks ran")
        p50 = float(np.percentile(np.asarray(ticks), 50))
        return GateResult(
            "cadence_p50", p50 <= p50_bound_s, round(p50, 6),
            p50_bound_s, f"{len(ticks)} ticks",
        )

    return Gate("cadence_p50", fn)


def gate_accounting() -> Gate:
    """Zero SILENT drops: every record a pump emitted is accounted as
    accepted or dropped, exactly, per source — ``emitted == accepted +
    (drops − purged)`` (purged batches were accepted first, then
    re-classified at eviction; see FanInQueue.purged)."""

    def fn(ctx) -> GateResult:
        accepted = ctx.tier.queue.accepted()
        drops = ctx.tier.queue.drops()
        purged = ctx.tier.queue.purged()
        bad = []
        total = 0
        for row in ctx.tier.roster():
            sid = row["id"]
            emitted = row["emitted"]
            total += emitted
            accounted = (
                accepted.get(sid, 0)
                + drops.get(sid, 0) - purged.get(sid, 0)
            )
            if emitted != accounted:
                bad.append(f"sid {sid}: emitted {emitted} != "
                           f"accounted {accounted}")
        return GateResult(
            "accounting_exact", not bad, total, None,
            "; ".join(bad) if bad else f"{total} records exact",
        )

    return Gate("accounting_exact", fn)


def gate_drops(expect: bool = False) -> Gate:
    """Put-time drop policy: by default ZERO records dropped at the
    queue bound; the flood scenario flips ``expect`` — drops must then
    be nonzero AND (via gate_accounting) exactly attributed."""

    def fn(ctx) -> GateResult:
        drops = ctx.tier.queue.drops()
        purged = ctx.tier.queue.purged()
        put_drops = sum(drops.values()) - sum(purged.values())
        if expect:
            return GateResult(
                "drops_expected", put_drops > 0, put_drops, ">0",
                "queue bound exercised" if put_drops else
                "flood never hit the queue bound",
            )
        return GateResult(
            "drops_zero", put_drops == 0, put_drops, 0,
            "" if put_drops == 0 else f"{put_drops} records dropped",
        )

    return Gate("drops_expected" if expect else "drops_zero", fn)


def gate_e2e_p99(bound_s: float) -> Gate:
    """Bounded end-to-end latency via the provenance waterfall: emit →
    render p99 within ``bound_s`` (obs/latency.py)."""

    def fn(ctx) -> GateResult:
        st = ctx.lat.status()
        if not st.get("observed"):
            return GateResult(
                "e2e_p99", False, detail="no stamped batches folded",
            )
        p99 = st["e2e_p99_s"]
        return GateResult(
            "e2e_p99", p99 <= bound_s, p99, bound_s,
            f"dominant stage: {st.get('dominant_stage')}",
        )

    return Gate("e2e_p99", fn)


def gate_events(required=(), forbid=()) -> Gate:
    """Required flight-recorder event kinds observed at least once;
    forbidden kinds never."""

    def fn(ctx) -> GateResult:
        kinds = {e.get("kind") for e in ctx.recorder.tail(4096)}
        missing = [k for k in required if k not in kinds]
        present = [k for k in forbid if k in kinds]
        ok = not missing and not present
        bits = []
        if missing:
            bits.append(f"missing: {', '.join(missing)}")
        if present:
            bits.append(f"forbidden present: {', '.join(present)}")
        return GateResult(
            "events", ok, sorted(kinds & set(required)), list(required),
            "; ".join(bits) if bits else "all transitions observed",
        )

    return Gate("events", fn)


def gate_final_state(kind: str, fld: str, expect) -> Gate:
    """The LAST flight-recorder event of ``kind`` carries
    ``fld == expect`` — the recovery gate shape (e.g. the degrade
    ladder's final transition must land back on HEALTHY)."""

    def fn(ctx) -> GateResult:
        last = None
        for e in ctx.recorder.tail(4096):
            if e.get("kind") == kind:
                last = e
        gid = f"final:{kind}.{fld}"
        if last is None:
            return GateResult(gid, False, None, expect,
                              f"no {kind} event recorded")
        val = last.get(fld)
        return GateResult(gid, val == expect, val, expect)

    return Gate(f"final:{kind}.{fld}", fn)


def gate_flows(min_flows: int | None = None,
               max_flows: int | None = None) -> Gate:
    """Final flow-table population inside the expected band (flash
    crowd grows it, mass eviction shrinks it, a reset storm must leave
    it untouched)."""

    def fn(ctx) -> GateResult:
        n = ctx.engine.num_flows()
        ok = ((min_flows is None or n >= min_flows)
              and (max_flows is None or n <= max_flows))
        return GateResult(
            "flow_population", ok, n, [min_flows, max_flows],
        )

    return Gate("flow_population", fn)


def gate_feature_sanity(max_abs: float = 1e9) -> Gate:
    """No mod-2³² wrap artifacts: after a cumulative-counter reset
    storm every feature must stay physically plausible — a botched
    wrap delta shows up as ~4.29e9 × bytes-per-packet, orders of
    magnitude past this bound."""

    def fn(ctx) -> GateResult:
        X = ctx.engine.features().cpu().numpy()
        worst = float(np.max(np.abs(X))) if X.size else 0.0
        return GateResult(
            "feature_sanity", worst <= max_abs, worst, max_abs,
        )

    return Gate("feature_sanity", fn)


def gate_evicted(min_slots: int) -> Gate:
    """At least ``min_slots`` flow slots were reclaimed during the run
    (idle eviction + namespace eviction, counted by the runner)."""

    def fn(ctx) -> GateResult:
        n = int(ctx.obs.get("evicted_slots", 0))
        return GateResult("evicted_slots", n >= min_slots, n, min_slots)

    return Gate("evicted_slots", fn)


def gate_unknown_recall(novel_macs, min_recall: float = 0.9) -> Gate:
    """Where the scenario injects novelty: the open-set tier must
    label (at least) ``min_recall`` of the novel population's flows
    ``unknown`` at the final render. Ground truth is the injected
    population's MAC set (OpenWorldWorkload.novel_macs)."""
    novel = frozenset(novel_macs)

    def fn(ctx) -> GateResult:
        mac_labels = ctx.obs.get("mac_labels", {})
        unknown = ctx.n_classes
        seen = [m for m in novel if m in mac_labels]
        if not seen:
            return GateResult(
                "unknown_recall", False, 0.0, min_recall,
                "no novel flow reached the table",
            )
        hit = sum(1 for m in seen if mac_labels[m] == unknown)
        recall = hit / len(seen)
        return GateResult(
            "unknown_recall", recall >= min_recall, round(recall, 4),
            min_recall, f"{hit}/{len(seen)} novel flows rejected",
        )

    return Gate("unknown_recall", fn)


def gate_known_accept(known_macs, max_reject: float = 0.05) -> Gate:
    """The evasion side of the novelty gate: boundary-hugging
    perturbed-but-KNOWN flows (workload.perturb_pools) must NOT be
    rejected — the calibrated threshold covers the known envelope by
    construction."""
    known = frozenset(known_macs)

    def fn(ctx) -> GateResult:
        mac_labels = ctx.obs.get("mac_labels", {})
        unknown = ctx.n_classes
        seen = [m for m in known if m in mac_labels]
        if not seen:
            return GateResult(
                "known_accept", False, None, max_reject,
                "no known flow reached the table",
            )
        rejected = sum(1 for m in seen if mac_labels[m] == unknown)
        frac = rejected / len(seen)
        return GateResult(
            "known_accept", frac <= max_reject, round(frac, 4),
            max_reject,
            f"{rejected}/{len(seen)} known/evasion flows rejected",
        )

    return Gate("known_accept", fn)


def gate_rule_accounting() -> Gate:
    """The actuation ledger is EXACT: every rule the plane ever
    intended is accounted as installed, refused, or retracted —
    ``intended == installed + retracted + refused`` — including the
    rules pushed before a mid-run degrade and the retractions after a
    quarantine."""

    def fn(ctx) -> GateResult:
        st = ctx.actuation.status()
        led = st["ledger"]
        return GateResult(
            "rule_accounting_exact", bool(led["exact"]), led, None,
            f"plane ended {st['state']}",
        )

    return Gate("rule_accounting_exact", fn)


def gate_zero_rule_flaps(min_suppressed: int = 1) -> Gate:
    """The hysteresis contract under oscillating labels: ZERO rule
    flaps (a re-install of a pair whose rule was label-retracted) —
    while ``flaps_suppressed`` proves the storm actually reached the
    plane (at least ``min_suppressed`` broken streaks / ended
    deviation episodes; a quiet run must not pass vacuously)."""

    def fn(ctx) -> GateResult:
        st = ctx.actuation.status()
        flaps = int(st["rule_flaps"])
        suppressed = int(st["flaps_suppressed"])
        ok = flaps == 0 and suppressed >= min_suppressed
        return GateResult(
            "rule_flaps_zero", ok, flaps, 0,
            f"{suppressed} flaps suppressed"
            + ("" if suppressed >= min_suppressed else
               f" (< {min_suppressed}: storm never reached the plane)"),
        )

    return Gate("rule_flaps_zero", fn)


def gate_rules_installed(min_rules: int = 1) -> Gate:
    """The plane actually programmed the switch: at least ``min_rules``
    installs landed over the run (zero-flap gates must not pass by
    never installing anything)."""

    def fn(ctx) -> GateResult:
        n = int(ctx.actuation.status()["ledger"]["installed"])
        return GateResult("rules_installed", n >= min_rules, n, min_rules)

    return Gate("rules_installed", fn)


def gate_namespace_evicted(sid: int) -> Gate:
    """A quarantined namespace was actually evicted: the engine holds
    zero slots for ``sid`` at the end (the flap-storm escalation must
    END in an eviction, not a livelock)."""

    def fn(ctx) -> GateResult:
        evicted = ctx.obs.get("evicted_sids", set())
        return GateResult(
            f"namespace_evicted:{sid}", sid in evicted,
            sorted(evicted), sid,
        )

    return Gate(f"namespace_evicted:{sid}", fn)


def gate_restart_refused(min_refusals: int = 1) -> Gate:
    """The flap-escalation contract: at least ``min_refusals`` restart
    attempts were refused after escalation (the runner's restart ops
    record each refusal)."""

    def fn(ctx) -> GateResult:
        n = int(ctx.obs.get("restarts_refused", 0))
        return GateResult(
            "restart_refused", n >= min_refusals, n, min_refusals,
        )

    return Gate("restart_refused", fn)

"""Deterministic fault injection at the durability, ingest and
label-cache seams.

The port's copy of ``traffic_classifier_sdn_tpu/utils/faults.py``, with
the JAX package's 29 sites. A named *fault site*
sits at each seam (serving-checkpoint write, rename and restore, the model
checkpoint's manifest commit, collector reads, supervisor restart, the
fan-in queue and source pumps, native engine load and parse, the latency
stamp, the perf ring's segment commit, the profiler capture, the pipeline
handoff, the degrade ladder's dispatch and probe, the incremental label
path, the drift loop's observation, refit, swap and rollback, the
open-set gate's scoring and calibration, the actuation plane's send,
barrier and retract); a test installs a
seeded ``FaultPlan`` that fires scripted failures at
exact hit counts (or seeded probabilities). Observers
(``add_observer``/``observing``) see every fire before it manifests: the
flight recorder (obs/flight_recorder.py) logs them that way.

1. **Inert by default.** With no plan installed every site is one module
   attribute load and an ``is None`` branch. The serve loop's sites are
   per tick or per chunk, never per record.
2. **Deterministic.** A plan is seeded; probability schedules draw from a
   private ``random.Random``. Count schedules (``after``/``times``) do
   not touch the RNG.
3. **Scripted, not ambient.** Plans install explicitly (``install`` /
   ``installed``) and tests always clear them.
"""

from __future__ import annotations

import contextlib
import random
from dataclasses import dataclass, field

# The sites this package threads. Keys are the exact strings passed to
# fault_point()/fault_bytes(); values say where the seam lives and what a
# fire simulates.
SITES: dict[str, str] = {
    "serving_ckpt.write": (
        "io/serving_checkpoint.save — temp file half-written (a fire == "
        "crash mid-checkpoint: the temp is torn away, the previous "
        "checkpoint survives)"
    ),
    "serving_ckpt.rename": (
        "io/serving_checkpoint.save — complete fsynced temp, crash at "
        "the atomic rename itself (durability without visibility)"
    ),
    "serving_ckpt.restore": "io/serving_checkpoint.restore entry",
    "train_ckpt.write": (
        "io/checkpoint manifest commit (model and train-state saves)"
    ),
    "collector.read": (
        "ingest/collector raw reader, per pipe chunk; 'truncate' drops "
        "the chunk tail mid-record (framing must poison the seam), "
        "'raise' kills the monitor mid-stream"
    ),
    "supervisor.restart": (
        "ingest/supervisor — the restart attempt itself fails (spawn "
        "failure); consumes one restart-budget slot and re-enters "
        "backoff"
    ),
    "ingest.fanin_put": (
        "ingest/fanin.FanInQueue.put — the MPSC enqueue from a source "
        "pump fails (a fire == a queue-full drop burst); ABSORBED: the "
        "batch is dropped and counted against ITS source only — the "
        "producer is never blocked, the serve loop never sees the "
        "failure, and every other source's telemetry flows untouched"
    ),
    "ingest.source_dead": (
        "ingest/fanin.SourceWorker pump — one telemetry source dies "
        "mid-stream; ABSORBED by the fan-in tier: the source goes DEAD "
        "(unclean), its namespace quarantines and after the quarantine "
        "window exactly its own slots are evicted, while every other "
        "source keeps serving fresh labels every tick"
    ),
    "ingest.native_parse": (
        "native/engine.NativeBatcher.feed — one line of a native-ingest "
        "poll batch is corrupt (a fire == a torn/garbled wire line at "
        "the C++ parse seam); ABSORBED exactly like a real malformed "
        "line: counted against ITS source (parse_errors) and skipped, "
        "the rest of the batch parses normally — never a crash, never "
        "a torn row, and every other source's telemetry is untouched"
    ),
    "obs.perf_ring": (
        "obs/perf_recorder.PerfRecorder segment commit — the black-box "
        "ring's atomic segment write fails (ENOSPC, dead disk, torn "
        "rename); ABSORBED inside the recorder: that segment's samples "
        "are dropped and counted (perf_ring_dropped_segments), the next "
        "segment starts clean, and the serve tick never sees the "
        "failure — the black box must not stall the plane it records"
    ),
    "obs.profiler": (
        "obs/device.ProfilerCapture.capture — the on-demand "
        "torch.profiler trace capture fails mid-start; ABSORBED at the "
        "/profile endpoint: the request 500s with the error, the "
        "failure is counted (profiler_capture_failures) and recorded, "
        "the busy guard releases, and the serve loop never sees it"
    ),
    "obs.stamp": (
        "ingest/protocol.stamp_records — the latency-provenance emit "
        "stamp itself fails; ABSORBED at the stamping seam: the batch "
        "is delivered unstamped and telemetry is NEVER dropped"
    ),
    "native.load": (
        "native/engine.available() — the C++ engine is unavailable "
        "(build/dlopen failure)"
    ),
    "pipeline.handoff": (
        "serving/pipeline.Handoff.put — the host-to-device-stage handoff "
        "itself fails mid-tick; the host stage must surface it, not wedge "
        "behind a dead device stage"
    ),
    "pipeline.coalesce": (
        "serving/pipeline.Handoff.put, coalesce branch — fires only under "
        "backpressure, when a full queue merges the new tick into the "
        "staged one"
    ),
    "degrade.dispatch_stall": (
        "serving/degrade.DegradeLadder device path — a fire simulates a "
        "WEDGED device dispatch: the ladder converts it into a watchdog "
        "deadline trip, so the FaultInjected never escapes — the ladder "
        "absorbs it and demotes to the fallback rung"
    ),
    "degrade.dispatch_error": (
        "serving/degrade.DegradeLadder device path — a fire simulates an "
        "ERRORING device dispatch (a CUDA error mid-kernel); absorbed by "
        "the ladder like dispatch_stall, driving the error edge of "
        "HEALTHY->DEGRADED instead of the deadline edge"
    ),
    "degrade.probe": (
        "serving/degrade.DegradeLadder probe path — the shadow-batch "
        "re-probe itself fails: consumes the probe attempt, resets the "
        "consecutive-success counter, and grows the full-jitter backoff"
    ),
    "serve.dirty_mask": (
        "serving/incremental.IncrementalLabels dirty-mask consult — the "
        "per-slot dirty bookkeeping behind incremental prediction is "
        "suspect this tick; ABSORBED: the tick degrades to a direct "
        "full-table re-predict (served fresh, cache and mask untouched "
        "on the fault path) and the mask/cache pair is rebuilt from "
        "scratch at the next render — a stale label is never served as "
        "fresh"
    ),
    "serve.label_cache": (
        "serving/incremental.IncrementalLabels cache-merge seam — the "
        "device-resident label cache cannot accept this tick's dirty-"
        "row labels; ABSORBED: the tick degrades to a direct full-table "
        "re-predict served fresh, the cache and dirty mask are left "
        "untouched, and the dirty rows re-predict at the next render"
    ),
    "drift.window": (
        "serving/drift.DriftController window observation — the "
        "off-hot-path materialization/stats update for one observed "
        "batch fails; ABSORBED: the observation is dropped (counted in "
        "drift_window_errors) and the serve tick's output is unaffected"
    ),
    "retrain.fit": (
        "serving/retrain.fit_family entry — the background refit "
        "itself dies mid-fit; ABSORBED by the drift controller: the "
        "retrain run is marked failed, the serve keeps the old model, "
        "and a still-drifting stream re-trips later"
    ),
    "promote.swap": (
        "serving/drift.DriftController promotion — the hot swap of the "
        "candidate into the live predict path fails; ABSORBED: the "
        "controller rolls back via serving/retrain.resolve_latest and "
        "the old model keeps serving every tick"
    ),
    "promote.rollback": (
        "serving/drift.DriftController rollback — the rollback reload "
        "itself fails; ABSORBED: the gate keeps the pair it already "
        "holds (the old model), so serving continues regardless"
    ),
    "openset.score": (
        "serving/openset.OpenSetGate scoring — the per-tick open-set "
        "rejection scoring fails; ABSORBED: that tick serves the inner "
        "closed-world labels FRESH (the predict already ran) — never a "
        "fabricated 'unknown', never a stale label, and the serve "
        "never sees the failure"
    ),
    "openset.calibrate": (
        "serving/openset.OpenSetGate calibration/rebase — a "
        "calibration sample fold or a promotion-time rebase fails; "
        "ABSORBED: the sample is dropped (calibration just takes "
        "longer; a failed rebase keeps the previous stats) and labels "
        "are never touched — the gate stays byte-transparent until a "
        "calibration actually lands"
    ),
    "actuation.send": (
        "serving/actuation.ActuationPlane flow-mod send — the switch "
        "socket wedges or refuses a mod mid-write; ABSORBED: the plane "
        "degrades itself to dry-run (in-flight ops resolve as refused, "
        "accounting stays exact) and re-probes the switch on an "
        "exponential backoff while classify serves every tick "
        "byte-identically to --actuation off"
    ),
    "actuation.barrier": (
        "serving/actuation.ActuationPlane barrier collection — the "
        "barrier reply confirming a pushed batch is lost or the read "
        "fails; ABSORBED: the batch's unresolved ops are counted "
        "refused (never silently 'installed'), the plane degrades to "
        "dry-run and re-probes on backoff; the serve cadence never "
        "blocks on the dead barrier"
    ),
    "actuation.retract": (
        "serving/actuation.ActuationPlane retraction push — the DELETE "
        "undoing an installed rule cannot be sent (quarantine, "
        "rollback-demotion, or label-change retract); ABSORBED: the op "
        "resolves refused, the rule is dropped from the installed view "
        "(the switch may hold it until re-probe reconciles), and the "
        "plane degrades to dry-run with backoff re-probe"
    ),
}


class FaultInjected(RuntimeError):
    """Raised by a firing fault site (``kind="raise"``)."""

    def __init__(self, site: str, hit: int):
        super().__init__(f"injected fault at site {site!r} (hit #{hit})")
        self.site = site
        self.hit = hit


@dataclass
class FaultRule:
    """One scheduled failure at one site.

    ``after`` eligible hits are skipped, then the rule fires up to
    ``times`` times (None = every subsequent hit). ``p`` gates each
    otherwise-eligible hit on a seeded coin flip — with count scheduling
    alone (``p=1.0``) the RNG is never consulted, so count plans are
    exactly reproducible regardless of seed.
    """

    site: str
    after: int = 0
    times: int | None = 1
    p: float = 1.0
    kind: str = "raise"  # or "truncate" (byte sites only)
    fired: int = field(default=0, compare=False)


class FaultPlan:
    """Seeded schedule of FaultRules, keyed by site name."""

    def __init__(self, rules, seed: int = 0):
        self.rules: dict[str, list[FaultRule]] = {}
        for r in rules:
            self.rules.setdefault(r.site, []).append(r)
        self.seed = seed
        self._rng = random.Random(seed)
        self.hits: dict[str, int] = {}  # site → eligible-hit count
        self.fires: list[tuple[str, int]] = []  # (site, hit) audit log

    def check(self, site: str) -> FaultRule | None:
        """Record one hit at ``site``; the firing rule, or None."""
        hit = self.hits.get(site, 0) + 1
        self.hits[site] = hit
        for r in self.rules.get(site, ()):
            if hit <= r.after:
                continue
            if r.times is not None and r.fired >= r.times:
                continue
            if r.p < 1.0 and self._rng.random() >= r.p:
                continue
            r.fired += 1
            self.fires.append((site, hit))
            return r
        return None


# The active plan. ``None`` means every site is inert; sites guard on this
# before doing any other work.
_plan: FaultPlan | None = None

# Fire observers: called as fn(site, hit, kind) AFTER a rule fires but
# BEFORE the failure manifests (raise/truncate), so crash forensics (the
# flight recorder) capture the firing even when the fire kills the path
# that would have reported it. Consulted only on a fire.
_observers: list = []


def add_observer(fn) -> None:
    """Register ``fn(site, hit, kind)`` to be called on every fire."""
    if fn not in _observers:
        _observers.append(fn)


def remove_observer(fn) -> None:
    if fn in _observers:
        _observers.remove(fn)


@contextlib.contextmanager
def observing(fn):
    """Scoped observer registration — always detaches (the registry is
    process-global; a leaked observer would haunt later runs)."""
    add_observer(fn)
    try:
        yield fn
    finally:
        remove_observer(fn)


def _notify(site: str, hit: int, kind: str) -> None:
    # observation must never alter injection semantics: a broken observer
    # is reported on stderr, not allowed to mask the fire
    for fn in list(_observers):
        try:
            fn(site, hit, kind)
        except Exception as e:  # noqa: BLE001 — forensics must not inject
            import sys

            print(f"WARNING: fault observer {fn!r} failed: {e}",
                  file=sys.stderr)


def install(plan: FaultPlan | None) -> None:
    global _plan
    _plan = plan


def clear() -> None:
    install(None)


def active() -> FaultPlan | None:
    return _plan


@contextlib.contextmanager
def installed(plan: FaultPlan):
    """Scoped install — the tests' idiom; always clears."""
    install(plan)
    try:
        yield plan
    finally:
        clear()


def fault_point(site: str) -> None:
    """Raise ``FaultInjected`` if a rule fires at ``site``; else no-op."""
    if _plan is None:
        return
    r = _plan.check(site)
    if r is not None:
        _notify(site, _plan.hits[site], r.kind)
        raise FaultInjected(site, _plan.hits[site])


def fault_bytes(site: str, data: bytes) -> bytes:
    """Byte-stream site: pass ``data`` through, truncated to its first
    half on a ``truncate`` fire (a torn read — the tail of the chunk,
    usually mid-record, is lost), or raise on a ``raise`` fire."""
    if _plan is None:
        return data
    r = _plan.check(site)
    if r is None:
        return data
    _notify(site, _plan.hits[site], r.kind)
    if r.kind == "truncate":
        return data[: len(data) // 2]
    raise FaultInjected(site, _plan.hits[site])

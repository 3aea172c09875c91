"""Flap-proof actuation: hysteresis-gated flow programming driven by
the classifier's labels — the port's copy of
``traffic_classifier_sdn_tpu/serving/actuation.py``.

The table the serve renders becomes OpenFlow 1.3 flow-mods, and the
design is about when it is *forbidden* to do so:

* **Hysteresis** — a per-flow rule walks PENDING → ARMED → INSTALLED →
  RETRACTING. A rule arms only after ``k_install`` consecutive observed
  ticks of the same actionable label; an installed rule retracts only
  after ``k_retract`` consecutive deviating ticks. A single-tick label
  flip or an open-set ``unknown`` blip therefore never touches the
  switch — it resets the streak and counts ``flaps_suppressed``.
* **Freshness** — a stale render (degrade ladder on its BROKEN rung)
  or a drift rollback demotes actuation to hold-and-retract: installed
  rules are pulled, nothing new installs, and a rollback latches the
  plane in dry-run until the drift loop PROMOTES again.
* **Blast radius** — a quarantined namespace's rules retract exactly
  with its slots (:meth:`ActuationPlane.retract_source`, called by the
  serve loop before the engine releases them), and a fleet member given
  a source span only ever actuates slots owned by its span.
* **Absorption** — the fault sites ``actuation.send`` /
  ``actuation.barrier`` / ``actuation.retract`` are ABSORBED: a wedged
  socket, refused mod, or lost barrier reply degrades the plane to
  dry-run with exponential-backoff re-probing, in-flight operations
  resolve as refused, and the classify plane serves every tick
  byte-identically to ``--actuation off`` (stdout is never touched —
  dry-run renders to stderr and the flight ring).
* **Exact accounting** — every operation the plane decides to perform
  increments ``intended`` and terminally resolves as exactly one of
  ``installed`` / ``refused`` / ``retracted``; the invariant
  ``intended == installed + refused + retracted`` holds whenever no op
  is on the wire and spans restarts (a rebuilt plane adopts the
  previous ledger via ``ledger=``).

The plane never raises into the serve loop. Unlike the JAX plane, which
pushes under its one lock, this one never holds its FSM lock across a
socket call: ``observe`` runs on the render thread (the pipeline's
device-stage worker) while ``retract_source`` runs on the host stage and
``status`` on the exposition thread, and a stalled barrier (bounded by
the link's timeout) must hold none of them. The thread that holds the
wire drains every queued op; one that finds the wire busy returns at
once. Driven from one thread, the plane's ledger, counters, events and
dry-run table equal the JAX plane's tick for tick.
"""
from __future__ import annotations

import dataclasses
import socket
import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterable

from ..controller import openflow as of
from ..controller.policy import (
    PolicyAction,
    compile_install,
    compile_retract,
    compile_wipe,
)
from ..utils.faults import FaultInjected, fault_point

# actuation_state gauge values (obs idiom shared with degrade/drift)
STATE_GAUGE = {
    "off": 0,
    "dry-run": 1,
    "push": 2,
    "degraded": 3,
    "demoted": 4,
}

# rule lifecycle states
PENDING = "PENDING"        # streak building toward k_install
ARMED = "ARMED"            # streak earned — install op issued this flush
INSTALLED = "INSTALLED"    # resolved on the switch (or dry-run ledger)
RETRACTING = "RETRACTING"  # delete op issued this flush


@dataclass
class _Rule:
    slot: int
    src: str
    dst: str
    label: str                    # label the current streak is for
    streak: int = 0
    state: str = PENDING
    installed_label: str | None = None
    cookie: int = 0
    deviation: int = 0            # consecutive ticks off installed_label


@dataclass
class _Op:
    """One intended switch operation, resolved exactly once."""

    kind: str                     # "install" | "retract"
    rule: _Rule
    reason: str = ""
    xid: int = 0
    payload: bytes = b""
    resolution: str | None = None  # "installed" | "retracted" | "refused"


@dataclass
class Ledger:
    """The exact-accounting invariant: ``intended`` equals the sum of
    the three terminal resolutions at every observe boundary."""

    intended: int = 0
    installed: int = 0
    refused: int = 0
    retracted: int = 0

    def exact(self) -> bool:
        return self.intended == self.installed + self.refused + self.retracted

    def as_dict(self) -> dict:
        return {
            "intended": self.intended, "installed": self.installed,
            "refused": self.refused, "retracted": self.retracted,
            "exact": self.exact(),
        }


class SwitchLink:
    """Minimal OF1.3 controller-side link: hello exchange, flow-mod
    writes, barrier round-trips with refusal collection. Blocking reads
    are bounded by ``timeout`` so a wedged switch costs one timeout,
    never a hung serve."""

    def __init__(self, host: str, port: int, timeout: float = 0.25):
        self.host = host
        self.port = port
        self.timeout = timeout
        self._sock: socket.socket | None = None
        self._reader = of.MessageReader()
        self._xid = 0

    def next_xid(self) -> int:
        self._xid += 1
        return self._xid

    def open(self) -> None:
        sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout
        )
        sock.settimeout(self.timeout)
        self._sock = sock
        self._reader = of.MessageReader()
        self.send(of.hello(self.next_xid()))
        # the peer's HELLO is the liveness probe: a listener that
        # accepts but does not speak OpenFlow fails here, not mid-push
        deadline = time.monotonic() + max(self.timeout, 0.05) * 4
        while time.monotonic() < deadline:
            for mtype, _xid, _body in self._recv():
                if mtype == of.OFPT_HELLO:
                    return
        raise OSError("switch link: no HELLO from peer")

    def send(self, payload: bytes) -> None:
        if self._sock is None:
            raise OSError("switch link not open")
        self._sock.sendall(payload)

    def _recv(self) -> list[tuple[int, int, bytes]]:
        if self._sock is None:
            raise OSError("switch link not open")
        try:
            data = self._sock.recv(65536)
        except socket.timeout:
            return []
        if not data:
            raise OSError("switch link closed by peer")
        return self._reader.feed(data)

    def barrier(self, xid: int) -> set[int]:
        """Send a barrier and wait (bounded) for its reply; returns the
        xids the switch refused with OFPT_ERROR before the barrier.
        Raises ``OSError`` if the reply never arrives."""
        self.send(of.barrier_request(xid))
        refused: set[int] = set()
        deadline = time.monotonic() + max(self.timeout, 0.05) * 4
        while time.monotonic() < deadline:
            for mtype, rxid, body in self._recv():
                if mtype == of.OFPT_ERROR:
                    bad = of.parse_error(body)["offending_xid"]
                    if bad is not None:
                        refused.add(bad)
                elif mtype == of.OFPT_BARRIER_REPLY and rxid == xid:
                    return refused
        raise OSError(f"switch link: barrier {xid} reply lost")

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None


class ActuationPlane:
    """The policy tier's runtime: hysteresis FSM + transport + ledger.

    ``mode`` is the *configured* mode (``dry-run`` or ``push``); the
    *live* state additionally includes ``degraded`` (push demoted by an
    actuation fault, re-probing on backoff) and ``demoted`` (drift
    rollback or stale render latched the plane safe). ``--actuation
    off`` never constructs a plane at all.

    Two locks. ``_lock`` is a leaf around the FSM, the rules and the
    ledger, and is never held across a socket call. ``_wire`` serializes
    the transport: the thread that holds it drains every queued op
    (``_pending``), its own and any another thread queued meanwhile, so a
    caller that finds the wire busy returns at once and the holder pushes
    its ops. A rule whose install is on the wire (``ARMED``) is left
    alone by the FSM until it resolves; one forgotten meanwhile (its
    namespace evicted, the plane demoted) is retracted as soon as its
    install lands.
    """

    def __init__(
        self,
        policy: dict[str, PolicyAction],
        *,
        mode: str = "dry-run",
        k_install: int = 3,
        k_retract: int = 3,
        clock: Callable[[], float] = time.monotonic,
        link_factory: Callable[[], SwitchLink] | None = None,
        span: frozenset[int] | None = None,
        slots_for_source: Callable[[int], Iterable[int]] | None = None,
        ledger: dict | None = None,
        backoff_base_s: float = 1.0,
        backoff_max_s: float = 60.0,
        metrics=None,
        recorder=None,
        out=None,
    ):
        if mode not in ("dry-run", "push"):
            raise ValueError(f"actuation mode {mode!r}: want dry-run|push")
        if mode == "push" and link_factory is None:
            raise ValueError("push mode needs a link_factory (switch addr)")
        if span is not None and slots_for_source is None:
            raise ValueError("a source span needs slots_for_source")
        self.policy = policy
        self.mode = mode
        self.k_install = max(1, int(k_install))
        self.k_retract = max(1, int(k_retract))
        self._clock = clock
        self._link_factory = link_factory
        self._link: SwitchLink | None = None  # owned by the _wire holder
        self._span = span
        self._slots_for_source = slots_for_source
        self._m = metrics
        self._rec = recorder
        self._out = out if out is not None else sys.stderr
        self._lock = threading.Lock()
        self._wire = threading.Lock()
        self._pending: list[_Op] = []
        self._inflight = 0             # ops counted intended, not resolved
        self._rules: dict[int, _Rule] = {}
        self._cookie = 0
        self.ledger = Ledger(**{
            k: int((ledger or {}).get(k, 0))
            for k in ("intended", "installed", "refused", "retracted")
        })
        # the ledger as of the last moment no op was in flight: what
        # status() reports, exact by construction
        self._settled = dataclasses.replace(self.ledger)
        self.flaps_suppressed = int((ledger or {}).get("flaps_suppressed", 0))
        self.rule_flaps = int((ledger or {}).get("rule_flaps", 0))
        # pairs whose rule was retracted because its label deviated: a
        # later re-install of such a pair IS a rule flap (the thing the
        # flap-storm scenario gates to zero)
        self._label_retracted: set[tuple[str, str]] = set()
        # pairs whose retract resolved WITHOUT reaching the wire
        # (dry/degraded/refused in push mode): the switch may still
        # hold their rule — reconcile wipes them even when no INSTALLED
        # rule covers the pair anymore
        self._orphans: set[tuple[str, str]] = set()
        self._degraded = False
        self._demoted = False          # latched by rollback/stale
        self._demote_reason = ""
        self._backoff_base = backoff_base_s
        self._backoff_max = backoff_max_s
        self._backoff = backoff_base_s
        self._next_probe = 0.0
        self._last_drift_state: str | None = None
        self._probes = 0
        self._degrades = 0
        self._set_state_gauge()

    # -- state surface ------------------------------------------------------

    @property
    def state(self) -> str:
        """Live plane state (gauge keys in :data:`STATE_GAUGE`)."""
        if self._demoted:
            return "demoted"
        if self._degraded:
            return "degraded"
        return self.mode

    def _set_state_gauge(self) -> None:
        if self._m is not None:
            self._m.set("actuation_state", STATE_GAUGE[self.state])

    def status(self) -> dict:
        """The /healthz actuation block (json-safe; the ledger is the
        last settled one, so ``exact`` holds while ops are on the wire)."""
        with self._lock:
            states: dict[str, int] = {}
            for r in self._rules.values():
                states[r.state] = states.get(r.state, 0) + 1
            return {
                "mode": self.mode,
                "state": self.state,
                "demote_reason": self._demote_reason or None,
                "rules": states,
                "installed_rules": states.get(INSTALLED, 0),
                "ledger": self._settled.as_dict(),
                "flaps_suppressed": self.flaps_suppressed,
                "rule_flaps": self.rule_flaps,
                "orphan_pairs": len(self._orphans),
                "degrades": self._degrades,
                "probes": self._probes,
                "backoff_s": self._backoff if self._degraded else 0.0,
                "k_install": self.k_install,
                "k_retract": self.k_retract,
            }

    # -- the per-tick observation ------------------------------------------

    def observe(
        self,
        rows: Iterable[tuple[int, str, str, str]],
        *,
        stale: bool = False,
        drift_state: str | None = None,
    ) -> None:
        """Feed one rendered tick: ``rows`` are ``(slot, src_mac,
        dst_mac, label_name)`` as the render decoded them (the open-set
        tier's rejections arrive as the literal ``"unknown"``). Never
        raises; never touches stdout."""
        with self._lock:
            ops = self._pending
            self._note_drift_locked(drift_state, ops)
            if stale and not self._demoted:
                # hold-and-retract: a BROKEN-rung render serves stale
                # labels — pull every installed rule, install nothing
                self._demote_locked("stale_render", ops)
            if not stale and self._demoted and self._demote_reason == (
                "stale_render"
            ):
                # freshness returned on its own (ladder probed back):
                # un-latch; rules re-earn their installs via streaks
                self._demoted = False
                self._demote_reason = ""
                self._event("actuation.repromote", via="fresh_render")
            allowed = self._span_slots_locked()
            for slot, src, dst, label in rows:
                if allowed is not None and slot not in allowed:
                    continue
                self._observe_row_locked(slot, src, dst, label, ops)
        self._drain()

    def _span_slots_locked(self) -> set[int] | None:
        if self._span is None:
            return None
        allowed: set[int] = set()
        for sid in self._span:
            try:
                allowed.update(int(s) for s in self._slots_for_source(sid))
            except Exception:
                continue  # a just-evicted sid resolves to no slots
        return allowed

    def _observe_row_locked(self, slot: int, src: str, dst: str,
                            label: str, ops: list[_Op]) -> None:
        actionable = label in self.policy
        rule = self._rules.get(slot)
        if rule is None:
            if actionable:
                self._rules[slot] = _Rule(slot, src, dst, label, streak=1)
            return
        if (rule.src, rule.dst) != (src, dst):
            # slot reused for a different flow pair: the old rule's
            # match no longer describes this slot — retract if live,
            # then start over for the new pair
            if rule.state == INSTALLED:
                self._queue_retract_locked(rule, "slot_reused", ops)
            self._rules.pop(slot, None)
            if actionable:
                self._rules[slot] = _Rule(slot, src, dst, label, streak=1)
            return
        if rule.state == ARMED:
            return  # its install is on the wire: it resolves first
        if rule.state == INSTALLED:
            if label == rule.installed_label:
                if rule.deviation > 0:
                    # the deviation episode ended before k_retract:
                    # hysteresis ate a would-be flap
                    rule.deviation = 0
                    self._suppress_locked(slot, label)
                return
            rule.deviation += 1
            if rule.deviation >= self.k_retract:
                self._label_retracted.add((src, dst))
                self._queue_retract_locked(rule, "label_changed", ops)
                self._rules.pop(slot, None)
                if actionable:
                    self._rules[slot] = _Rule(slot, src, dst, label, streak=1)
            return
        # PENDING: streak arithmetic toward k_install
        if label == rule.label and actionable:
            rule.streak += 1
            if rule.streak >= self.k_install and not self._demoted:
                self._queue_install_locked(rule, ops)
        else:
            if rule.streak > 0:
                # blip: unknown, an unactionable class, or a flip to
                # another class before the streak earned installation
                self._suppress_locked(slot, label)
            rule.label = label
            rule.streak = 1 if actionable else 0

    def _suppress_locked(self, slot: int, label: str) -> None:
        self.flaps_suppressed += 1
        if self._m is not None:
            self._m.inc("actuation_flaps_suppressed")
        self._event("actuation.flap_suppressed", slot=slot, label=label)

    # -- op lifecycle -------------------------------------------------------

    def _queue_install_locked(self, rule: _Rule, ops: list[_Op]) -> None:
        self._cookie += 1
        rule.cookie = self._cookie
        rule.state = ARMED
        self.ledger.intended += 1
        self._inflight += 1
        if (rule.src, rule.dst) in self._label_retracted:
            self.rule_flaps += 1
            if self._m is not None:
                self._m.inc("actuation_rule_flaps")
        ops.append(_Op("install", rule))

    def _queue_retract_locked(self, rule: _Rule, reason: str,
                              ops: list[_Op]) -> None:
        rule.state = RETRACTING
        self.ledger.intended += 1
        self._inflight += 1
        ops.append(_Op("retract", rule, reason=reason))

    def _retract_all_locked(self, reason: str, ops: list[_Op]) -> None:
        for slot in list(self._rules):
            rule = self._rules[slot]
            if rule.state == INSTALLED:
                self._queue_retract_locked(rule, reason, ops)
            self._rules.pop(slot, None)

    def _note_drift_locked(self, drift_state: str | None,
                           ops: list[_Op]) -> None:
        if drift_state is None or drift_state == self._last_drift_state:
            self._last_drift_state = drift_state or self._last_drift_state
            return
        self._last_drift_state = drift_state
        if drift_state == "ROLLED_BACK":
            # never actuate on unpromoted labels: the rollback latches
            # the plane demoted until the drift loop earns PROMOTED
            self._demote_locked("drift_rollback", ops)
        elif drift_state == "PROMOTED" and self._demoted and (
            self._demote_reason == "drift_rollback"
        ):
            self._demoted = False
            self._demote_reason = ""
            self._event("actuation.repromote", via="drift_promoted")

    def _demote_locked(self, reason: str, ops: list[_Op]) -> None:
        if self._demoted:
            return
        self._demoted = True
        self._demote_reason = reason
        self._retract_all_locked(reason, ops)
        self._event("actuation.demote", reason=reason)

    # -- transport + resolution --------------------------------------------

    def _drain(self, probe: bool = True) -> None:
        """Probe when due (``probe``: an observed tick, not a quarantine
        retract), then push or dry-resolve every queued op. The thread
        that takes ``_wire`` drains for everyone; one that finds it taken
        returns at once (the holder takes its ops), and a holder re-checks
        after releasing, so no op is left queued."""
        while self._wire.acquire(blocking=False):
            try:
                if probe:
                    self._probe_if_due()
                while self._flush_once():
                    pass
            finally:
                self._wire.release()
            with self._lock:
                if not self._pending:
                    self._set_state_gauge()
                    return

    def _flush_once(self) -> bool:
        """One batch of queued ops to its resolution (``_wire`` held);
        False once nothing is queued."""
        with self._lock:
            ops, self._pending = self._pending, []
            if not ops:
                return False
            # demotion forbids NEW installs (none are queued while
            # demoted) but its hold-and-retract deletes must still reach
            # the wire — only a degraded/dry-run transport resolves dry
            if self.mode != "push" or self._degraded:
                self._resolve_dry_locked(ops)
                self._check_ledger_locked()
                return True
        refused, error = self._push(ops)
        with self._lock:
            if error is not None:
                self._degrade_locked(error)
                for op in ops:
                    if op.resolution is None:
                        self._resolve_locked(op, "refused", via="degrade")
            else:
                any_refused = False
                for op in ops:
                    if op.xid in refused:
                        any_refused = True
                        self._resolve_locked(op, "refused",
                                             via="switch_error")
                    else:
                        self._resolve_locked(
                            op,
                            "installed" if op.kind == "install"
                            else "retracted",
                            via="push",
                        )
                if any_refused:
                    # a switch refusing our mods is as suspect as a dead
                    # one: stop pushing, re-probe on backoff
                    self._degrade_locked("switch refused flow-mod")
            self._check_ledger_locked()
        return True

    def _check_ledger_locked(self) -> None:
        # the invariant is checked HERE, every flush: a resolution bug
        # surfaces at the tick that caused it, not in a far-away gate
        assert (self.ledger.intended - self._inflight
                == self.ledger.installed + self.ledger.refused
                + self.ledger.retracted), self.ledger.as_dict()

    def _push(self, ops: list[_Op]) -> tuple[set[int], str | None]:
        """Send ``ops`` and a barrier (``_wire`` held, ``_lock`` not):
        ``(refused xids, None)``, or ``(set(), error)`` when the link,
        a send or the barrier failed."""
        try:
            link = self._ensure_link()
            with self._lock:
                for op in ops:
                    op.xid = link.next_xid()
                    op.payload = self._encode_locked(op)
            for op in ops:
                if op.kind == "retract":
                    fault_point("actuation.retract")
                else:
                    fault_point("actuation.send")
                link.send(op.payload)
            bxid = link.next_xid()
            fault_point("actuation.barrier")
            return link.barrier(bxid), None
        except (FaultInjected, OSError) as e:
            return set(), str(e) or type(e).__name__

    def _resolve_dry_locked(self, ops: list[_Op]) -> None:
        lines = []
        for op in ops:
            self._resolve_locked(
                op,
                "installed" if op.kind == "install" else "retracted",
                via="dry-run",
            )
            rule = op.rule
            if op.kind == "install":
                action = self.policy[rule.label].describe()
                lines.append(
                    f"  + install cookie={rule.cookie} {rule.src}->"
                    f"{rule.dst} class={rule.label} [{action}]"
                )
            else:
                lines.append(
                    f"  - retract cookie={rule.cookie} {rule.src}->"
                    f"{rule.dst} reason={op.reason}"
                )
        # the intended-mods table: stderr only — stdout belongs to the
        # classify render and stays byte-identical to --actuation off
        print(f"actuation[{self.state}] intended mods:", file=self._out)
        for line in lines:
            print(line, file=self._out)

    def _encode_locked(self, op: _Op) -> bytes:
        rule = op.rule
        if op.kind == "install":
            return compile_install(
                op.xid, rule.src, rule.dst,
                self.policy[rule.label], rule.cookie,
            )
        return compile_retract(op.xid, rule.src, rule.dst, rule.cookie)

    def _resolve_locked(self, op: _Op, resolution: str, via: str) -> None:
        op.resolution = resolution
        rule = op.rule
        if resolution == "installed":
            self.ledger.installed += 1
            rule.state = INSTALLED
            rule.installed_label = rule.label
            rule.deviation = 0
            if via == "push":
                # OF1.3 ADD-replace: a landed install evicts any stale
                # rule under the same match — the pair is clean again
                self._orphans.discard((rule.src, rule.dst))
            if self._m is not None:
                self._m.inc("actuation_rules_installed")
            self._event(
                "actuation.install", slot=rule.slot, cookie=rule.cookie,
                src=rule.src, dst=rule.dst, label=rule.label, via=via,
            )
            if self._rules.get(rule.slot) is not rule:
                # forgotten while its install was on the wire (namespace
                # evicted, plane demoted): the landed rule comes off again
                self._queue_retract_locked(rule, "untracked",
                                           self._pending)
        elif resolution == "retracted":
            self.ledger.retracted += 1
            if via == "push":
                self._orphans.discard((rule.src, rule.dst))
            elif self.mode == "push":
                # the delete resolved dry while degraded: the switch
                # may still hold the rule — reconcile must wipe it
                self._orphans.add((rule.src, rule.dst))
            if self._m is not None:
                self._m.inc("actuation_rules_retracted")
            self._event(
                "actuation.retract", slot=rule.slot, cookie=rule.cookie,
                src=rule.src, dst=rule.dst, reason=op.reason, via=via,
            )
        else:
            self.ledger.refused += 1
            if op.kind == "install":
                # the install never landed: back to earning the streak
                rule.state = PENDING
                rule.streak = 0
            if self.mode == "push":
                # a refused op's wire state is UNKNOWN (a delete left
                # the rule live; an install may have landed before the
                # barrier died) — track the pair for a reconcile wipe
                self._orphans.add((rule.src, rule.dst))
            if self._m is not None:
                self._m.inc("actuation_rules_refused")
            self._event(
                "actuation.refused", slot=rule.slot, cookie=rule.cookie,
                op=op.kind, via=via,
            )
        self._inflight -= 1
        if self._inflight == 0:
            self._settled = dataclasses.replace(self.ledger)

    # -- degrade / re-probe -------------------------------------------------

    def _degrade_locked(self, reason: str) -> None:
        if self._link is not None:
            self._link.close()
            self._link = None
        if not self._degraded:
            self._degraded = True
            self._degrades += 1
            self._backoff = self._backoff_base
            self._event(
                "actuation.degrade", reason=reason, backoff_s=self._backoff,
            )
        self._next_probe = self._clock() + self._backoff

    def _probe_if_due(self) -> None:
        """Re-probe a degraded push plane once its backoff expired
        (``_wire`` held); a probe that reaches the switch reconciles it."""
        with self._lock:
            if not self._degraded or self.mode != "push":
                return
            if self._clock() < self._next_probe:
                return
            self._probes += 1
        try:
            self._ensure_link()
        except (OSError, FaultInjected) as e:
            with self._lock:
                self._event("actuation.probe", ok=False, error=str(e))
                self._backoff = min(self._backoff * 2, self._backoff_max)
                self._next_probe = self._clock() + self._backoff
            return
        with self._lock:
            self._degraded = False
            self._backoff = self._backoff_base
            self._event("actuation.probe", ok=True)
        self._reconcile()

    def _ensure_link(self) -> SwitchLink:
        if self._link is None:
            link = self._link_factory()
            link.open()
            self._link = link
        return self._link

    def _reconcile(self) -> None:
        """After a successful re-probe the switch's table may disagree
        with the FSM (rules dry-installed or dry-retracted while
        degraded): replay the FSM's INSTALLED view onto the wire.
        Reconcile ops are idempotent repairs, not new intent — they are
        counted separately and never touch the exact ledger. Runs with
        ``_wire`` held: only its holder resolves ops, so the orphan set
        it wipes cannot change under it."""
        link = self._link
        with self._lock:
            installed = [r for r in self._rules.values()
                         if r.state == INSTALLED]
            pairs = {(r.src, r.dst) for r in installed}
            orphans = sorted(p for p in self._orphans if p not in pairs)
            payloads = [compile_wipe(link.next_xid(), src, dst)
                        for src, dst in orphans]
            for rule in installed:
                # wipe stale copies (any cookie), then assert intent
                payloads.append(
                    compile_wipe(link.next_xid(), rule.src, rule.dst))
                payloads.append(compile_install(
                    link.next_xid(), rule.src, rule.dst,
                    self.policy[rule.installed_label], rule.cookie,
                ))
        try:
            for payload in payloads:
                link.send(payload)
            link.barrier(link.next_xid())
        except OSError as e:
            with self._lock:
                self._degrade_locked(f"reconcile failed: {e}")
            return
        with self._lock:
            self._orphans.clear()
            self._event(
                "actuation.reconcile", rules=len(installed),
                orphans_wiped=len(orphans),
            )

    # -- blast radius -------------------------------------------------------

    def retract_source(self, sid: int, slots: Iterable[int]) -> None:
        """Quarantine hook: called with a namespace's slot set captured
        *before* ``engine.evict_source`` releases them. Retracts exactly
        the dead namespace's installed rules and forgets its tracks —
        no other source's rules move."""
        with self._lock:
            pulled = 0
            for slot in slots:
                rule = self._rules.pop(int(slot), None)
                if rule is None:
                    continue
                if rule.state == INSTALLED:
                    self._queue_retract_locked(rule, f"quarantine sid={sid}",
                                               self._pending)
                    pulled += 1
            self._event("actuation.quarantine", sid=sid, rules=pulled)
        self._drain(probe=False)

    # -- plumbing -----------------------------------------------------------

    def _event(self, kind: str, **fields) -> None:
        if self._rec is not None:
            self._rec.record(kind, **fields)

    def close(self) -> None:
        with self._wire:
            if self._link is not None:
                self._link.close()
                self._link = None

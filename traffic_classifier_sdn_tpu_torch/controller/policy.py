"""Per-class actuation policy: the declarative ``--policy`` spec and
its compilation into OpenFlow 1.3 flow-mods.

The classifier's labels become switch programs here — and nowhere
else: this module is pure (spec string in, wire bytes out, no sockets,
no state), so every encoding is golden-testable byte-for-byte through
``openflow.parse_flow_mod`` and the hysteresis tier (serving/
actuation.py) owns *when* a compiled mod may touch a switch.

Spec grammar (comma-separated, one clause per class)::

    CLASS=queue:N     route via QoS queue N (set_queue + output NORMAL)
    CLASS=meter:N     rate-limit via meter N (meter + output NORMAL)
    CLASS=drop        empty instruction set — OF1.3 drop
    CLASS=mirror:P    copy to port P and forward normally

Classes without a clause are observe-only (classified, never
actuated). The open-set ``unknown`` label can never carry a clause:
rejecting traffic we cannot name is the classifier's job, programming
the switch on a guess is nobody's.

Policy rules install at priority ``POLICY_PRIORITY`` (above the
learning switch's priority-1 flows, below nothing else we emit) with
the rule id in the cookie, which is what makes per-rule accounting and
cookie-masked retraction exact.

The port's copy of ``traffic_classifier_sdn_tpu/controller/policy.py``,
on the port's ``controller/openflow.py``: host code, unchanged, so its
flow-mod bytes equal the JAX package's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import openflow as of

# above controller/switch.py's priority-1 learning flows: a policy
# verdict must shadow plain L2 forwarding for the matched pair
POLICY_PRIORITY = 10

_KINDS_WITH_ARG = {"queue", "meter", "mirror"}
_KINDS_BARE = {"drop"}


@dataclass(frozen=True)
class PolicyAction:
    """One compiled per-class action. ``arg`` is the queue id, meter id
    or mirror port; 0 (unused) for drop."""

    kind: str
    arg: int = 0

    def describe(self) -> str:
        if self.kind == "drop":
            return "drop"
        unit = {"queue": "queue", "meter": "meter", "mirror": "port"}
        return f"{self.kind} {unit[self.kind]}={self.arg}"


def parse_policy(spec: str, classes: tuple[str, ...]) -> dict[str, PolicyAction]:
    """``"video=queue:1,bulk=meter:2,attack=drop"`` → {class: action}.

    Raises ``ValueError`` on unknown classes, unknown kinds, missing or
    malformed arguments, duplicate clauses, and any attempt to actuate
    the open-set ``unknown`` label.
    """
    out: dict[str, PolicyAction] = {}
    for clause in spec.split(","):
        clause = clause.strip()
        if not clause:
            continue
        name, sep, action = clause.partition("=")
        name = name.strip()
        if not sep or not name:
            raise ValueError(f"policy clause {clause!r}: want CLASS=ACTION")
        if name == "unknown":
            raise ValueError(
                "policy may not actuate 'unknown' — open-set rejections "
                "never touch the switch"
            )
        if name not in classes:
            raise ValueError(
                f"policy class {name!r} not in model classes "
                f"{sorted(classes)}"
            )
        if name in out:
            raise ValueError(f"duplicate policy clause for class {name!r}")
        kind, ksep, arg = action.strip().partition(":")
        kind = kind.strip()
        if kind in _KINDS_BARE:
            if ksep:
                raise ValueError(f"policy action {kind!r} takes no argument")
            out[name] = PolicyAction(kind)
        elif kind in _KINDS_WITH_ARG:
            try:
                value = int(arg)
            except ValueError:
                raise ValueError(
                    f"policy action {kind!r} needs an integer argument "
                    f"({clause!r})"
                ) from None
            if value < 0:
                raise ValueError(f"policy action argument must be >= 0 "
                                 f"({clause!r})")
            out[name] = PolicyAction(kind, value)
        else:
            raise ValueError(
                f"unknown policy action {kind!r} (want "
                f"queue:N | meter:N | drop | mirror:P)"
            )
    if not out:
        raise ValueError("empty --policy spec")
    return out


def compile_instructions(action: PolicyAction) -> bytes:
    """Action → OF1.3 instruction list (the flow-mod payload)."""
    if action.kind == "drop":
        return b""  # no instructions == drop in OF1.3
    if action.kind == "queue":
        return of.instruction_apply_actions(
            of.action_set_queue(action.arg)
            + of.action_output(of.OFPP_NORMAL)
        )
    if action.kind == "meter":
        return of.instruction_meter(action.arg) + of.instruction_apply_actions(
            of.action_output(of.OFPP_NORMAL)
        )
    if action.kind == "mirror":
        return of.instruction_apply_actions(
            of.action_output(action.arg)
            + of.action_output(of.OFPP_NORMAL)
        )
    raise ValueError(f"unknown policy action kind {action.kind!r}")


def compile_install(xid: int, src: str, dst: str, action: PolicyAction,
                    cookie: int) -> bytes:
    """(flow pair, action) → the ADD flow-mod the hysteresis tier pushes
    once a label has earned installation. The cookie is the rule id —
    accounting and retraction key on it."""
    return of.flow_mod(
        xid, POLICY_PRIORITY,
        of.encode_match(eth_src=src, eth_dst=dst),
        compile_instructions(action),
        cookie=cookie,
    )


def compile_retract(xid: int, src: str, dst: str, cookie: int) -> bytes:
    """The DELETE undoing :func:`compile_install` — cookie-masked so it
    removes exactly the one rule it names, never a colliding match."""
    return of.flow_mod(
        xid, POLICY_PRIORITY,
        of.encode_match(eth_src=src, eth_dst=dst),
        b"",
        command=of.OFPFC_DELETE,
        cookie=cookie,
        cookie_mask=0xFFFFFFFFFFFFFFFF,
    )


def compile_wipe(xid: int, src: str, dst: str) -> bytes:
    """Unmasked DELETE for the pair: clears every policy rule matching
    it regardless of cookie. Reconciliation uses this — a mod that
    landed on the switch but was accounted refused (lost barrier) left
    an orphan under a cookie the FSM no longer knows."""
    return of.flow_mod(
        xid, POLICY_PRIORITY,
        of.encode_match(eth_src=src, eth_dst=dst),
        b"",
        command=of.OFPFC_DELETE,
    )

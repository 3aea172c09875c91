"""Standalone OpenFlow 1.3 controller (learning switch + telemetry
monitor) — the port's copy of the JAX package's controller, the
replacement for the reference's Ryu layer. ``controller/policy.py``
(actuation) is not ported yet."""

from .switch import Controller  # noqa: F401

"""Standalone OpenFlow 1.3 controller (learning switch + telemetry
monitor) — the port's copy of the JAX package's controller, the
replacement for the reference's Ryu layer, and ``controller/policy.py``,
which compiles the actuation plane's per-class ``--policy`` into OF1.3
flow-mods."""

from .switch import Controller  # noqa: F401

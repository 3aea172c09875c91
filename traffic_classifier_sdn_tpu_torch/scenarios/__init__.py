"""Adversarial scenario campaign of the port (the JAX package's
``scenarios/``): composable traffic-scenario
timelines with per-scenario SLO scorecards, driven through the REAL
serve loop (fan-in tier × native ingest × incremental serving, with
the degrade/open-set ladders live where a scenario arms them).

- ``timeline``  — the declarative half: Scenario/Phase/Gate + the gate
  factory vocabulary (cadence, exact drop accounting, e2e p99,
  transition events, open-world ground truth, …);
- ``library``   — the scenarios themselves (flash crowd, flap storm,
  reset storm, novel wave + evasion, mass eviction, queue flood,
  device wedge) in ``t1`` and ``cpu`` profiles;
- ``runner``    — the campaign runner: drives a timeline through the
  serve composition on a virtual clock, evaluates the gates, and
  dumps an atomic post-mortem bundle on gate failure.

``run_scenario`` runs on CUDA unless ``device="cpu"`` is given; the
CLI's ``--scenario ID`` replays one (``list`` prints the library).
"""

from .library import SCENARIOS, build
from .runner import RunContext, run_campaign, run_scenario
from .timeline import Gate, GateResult, Phase, Scenario

__all__ = [
    "SCENARIOS",
    "build",
    "run_campaign",
    "run_scenario",
    "RunContext",
    "Gate",
    "GateResult",
    "Phase",
    "Scenario",
]

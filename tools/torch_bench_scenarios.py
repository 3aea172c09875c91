#!/usr/bin/env python
"""Adversarial scenario campaign runner of the PyTorch port: drive the
scenario matrix through the port's REAL serve composition and emit the
per-scenario SLO scorecard. The twin of ``tools/bench_scenarios.py``: the
same flags (``--device`` in place of ``--platform``), ``"bench"`` name and
JSON keys, run by the port's ``scenarios/`` library (on the card unless
``--device cpu``).

Each scenario (``scenarios/library.py``) is a declarative phase timeline —
flash crowd, source flap storm, cumulative-counter reset storm, novel-class
wave + boundary-hugging evasion, mass-eviction churn spike,
queue-saturation flood, device wedge, label flap storm against the
actuation hysteresis — run through the fan-in tier × native ingest ×
incremental serving stack with the relevant ladders live, and scored
against its gates.

Writes ``--out`` (default ``docs/artifacts/torch_scenario_matrix_<device
type>.json``) and EXITS NONZERO on any gate failure — the matrix is a
gate, not a report. A failing scenario also leaves its post-mortem bundle
(flight-recorder JSONL + metrics snapshot + timeline-position manifest)
under ``--obs-dir``, named by scenario id.

Usage: torch_bench_scenarios.py [--profile cpu] [--scenario id ...]
       [--native auto|on|off] [--out PATH] [--obs-dir DIR]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from torch_bench_common import (
    ROOT,
    add_device_arg,
    device_fields,
    resolve_device,
    setup_path,
)


def main() -> None:
    ap = argparse.ArgumentParser(
        description="run the adversarial scenario matrix on the port"
    )
    ap.add_argument("--profile", choices=("t1", "cpu"), default="cpu",
                    help="scenario scale: t1 (tier-1 test shape) or cpu "
                    "(the committed-artifact shape)")
    ap.add_argument("--scenario", action="append", default=None,
                    metavar="ID",
                    help="run only this scenario (repeatable; default: "
                    "the whole matrix)")
    ap.add_argument("--native", choices=("auto", "on", "off"),
                    default="auto",
                    help="C++ ingest spine: auto uses it when built")
    add_device_arg(ap)
    ap.add_argument("--out", default=None,
                    help="scorecard path (default docs/artifacts/"
                    "torch_scenario_matrix_<device type>.json)")
    ap.add_argument("--obs-dir", default="scenario-postmortem",
                    help="gate-failure post-mortem bundle directory")
    ap.add_argument("--list", action="store_true",
                    help="list scenario ids and exit")
    args = ap.parse_args()
    setup_path()

    from traffic_classifier_sdn_tpu_torch.scenarios import (
        SCENARIOS,
        build,
        run_scenario,
    )

    if args.list:
        for name, builder in SCENARIOS.items():
            print(f"{name}: {builder('t1').title}")
        return

    names = args.scenario or list(SCENARIOS)
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        sys.exit(f"unknown scenarios: {unknown} "
                 f"(known: {sorted(SCENARIOS)})")

    device = resolve_device(args.device)
    cards = []
    for name in names:
        print(f"running {name} [{args.profile}] ...", file=sys.stderr,
              flush=True)
        t0 = time.perf_counter()
        card = run_scenario(build(name, args.profile), native=args.native,
                            obs_dir=args.obs_dir, device=device)
        card["wall_s"] = round(time.perf_counter() - t0, 3)
        cards.append(card)
        verdict = "PASS" if card["passed"] else "FAIL"
        print(f"  {verdict} in {card['wall_s']}s (dominant stage: "
              f"{card['latency'].get('dominant_stage')})",
              file=sys.stderr, flush=True)

    out = {
        "bench": "scenario_matrix",
        **device_fields(device),
        "profile": args.profile,
        "scenarios": cards,
        "passed": all(c["passed"] for c in cards),
        "gate_failures": [
            {"scenario": c["scenario"], "gate": g["id"],
             "value": g["value"], "bound": g["bound"],
             "detail": g["detail"]}
            for c in cards
            for g in c["gates"] if not g["passed"]
        ],
    }
    print(json.dumps(out))
    path = args.out or os.path.join(
        ROOT, "docs", "artifacts",
        f"torch_scenario_matrix_{device.type}.json")
    with open(path, "w") as f:
        f.write(json.dumps(out, indent=1) + "\n")
    print(f"wrote {path}", file=sys.stderr)
    if not out["passed"]:
        fails = ", ".join(f"{f['scenario']}:{f['gate']}"
                          for f in out["gate_failures"])
        sys.exit(f"scenario gates FAILED: {fails} "
                 f"(post-mortems under {args.obs_dir}/)")


if __name__ == "__main__":
    main()

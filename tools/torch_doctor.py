#!/usr/bin/env python
"""Card preflight doctor for the PyTorch port: a short instrumented
micro-serve that answers "is this card worth spending a run on?" before a
long measurement starts. The port's counterpart of ``tools/tpu_doctor.py``:
the same flags, the same six checks in the same order, the same bundle
keys (``"metric": "torch_doctor"``) and the same exit rule.

Six checks, each an independent pass/fail/skip row in one atomically
written JSON bundle (``--out``: the bundle lands on both verdicts, so a
failing card still leaves evidence of how it failed):

  platform   the torch device the micro-serve runs on against --expect
             (``cuda`` reads as platform ``gpu``). ``--platform default``,
             the default, means the card and expects ``gpu``: with no
             card it fails, it never falls back to the CPU quietly; only
             ``--platform cpu`` runs on the CPU. On the card the row also
             carries the ``nvidia-smi`` name and power limit.
  compile    eager torch compiles no program; the port's compile is
             building and loading its three CUDA kernels
             (``ops/cuda_build.build``, or only the load when the library
             is already built, which the row says) plus
             ``warmup_serving``, all under --compile-budget-s. The
             kernels are built for the card's readiness, not for the
             micro-serve, which launches none of them. On the CPU no
             kernel is built (the wrappers take their plain
             versions), so the row times the warmup alone.
  retrace    nothing is compiled or allocated for the first time inside
             the measured ticks: no kernel library built or loaded
             (``cuda_build.load_library``) and, on the card, no new
             caching-allocator segment (``segment.all.allocated`` of
             ``torch.cuda.memory_stats``). The port's ``DeviceTelemetry``
             reports XLA's compile counters as 0 by design
             (obs/device.py), so a check on them would always pass. The
             GNB micro-serve launches none of the three kernels, so the
             library half cannot fail on this serve: only the allocator
             segment count is informative, and the row's detail says so.
             On the CPU the allocator is not observable and the row checks
             the libraries alone; it passes as JAX's CPU row does.
  hbm        device memory headroom after the table fill
             (``torch.cuda.mem_get_info``) against --hbm-headroom; skip
             with a named reason on the CPU, as JAX's CPU row does.
  transfers  the port's sync witness (utils/syncguard.py) armed over the
             measured ticks, checked against
             docs/artifacts/torch_hot_path_sync_budget.json (or
             $TCSDN_TORCH_SYNC_BUDGET): any hot-span sync off the
             allowlist fails; a missing budget file skips.
  cadence    measured tick p50 under --cadence-budget-s.

The micro-serve is JAX's (a six-class GNB, ``warmup_serving``,
``IncrementalLabels``, ``SyntheticFlows`` bytes) on the port's modules,
with one difference: its engine takes the serve's default ingest,
``--native-ingest auto`` (the C++ engine when g++ builds it), where JAX's
doctor parses in Python. On the card, 65,536 flows a tick through the
Python parser take 2.9 s a tick, so the cadence check would time the
parser and not the card.

Exit 0 iff every non-skip check passed. Run on the card with
``python tools/torch_doctor.py`` (the same as ``--platform default
--expect gpu``; chip_smoke.py's ``doctor`` phase runs it at the serve's
full width), and on the CPU with ``--platform cpu --expect cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

KERNELS = ("forest_proba", "knn_topk", "rbf_decision")


def _check(checks: list, cid: str, status: str, detail: str,
           **fields) -> None:
    checks.append({"id": cid, "status": status, "detail": detail,
                   **fields})
    print(f"# doctor {cid}: {status} — {detail}",
          file=sys.stderr, flush=True)


def _card_identity() -> str | None:
    """``name, power.limit`` as nvidia-smi prints them, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def _library_state(cuda_build) -> tuple:
    """What a kernel load would change: the cached loads and the built
    libraries on disk."""
    built = (sorted(p.name for p in cuda_build.BUILD_DIR.glob("*.so"))
             if cuda_build.BUILD_DIR.is_dir() else [])
    return cuda_build.load_library.cache_info().misses, built


def _build_kernels(cuda_build) -> dict:
    """Build (or find built) and load the three kernels; seconds and
    which libraries were compiled here."""
    t0 = time.perf_counter()
    logs = cuda_build.build(KERNELS)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for name in KERNELS:
        cuda_build.load_library(name)
    return {
        "built": sorted(n for n, log in logs.items() if log),
        "cached": sorted(n for n, log in logs.items() if not log),
        "build_s": round(build_s, 3),
        "load_s": round(time.perf_counter() - t0, 3),
    }


def _no_card_bundle(args, checks: list) -> dict:
    for cid in ("compile", "retrace", "hbm", "transfers", "cadence"):
        _check(checks, cid, "skip", "not run: no CUDA device to run on")
    return _bundle(args, checks, "none", None)


def _bundle(args, checks: list, platform: str, device) -> dict:
    failed = [c["id"] for c in checks if c["status"] == "fail"]
    skipped = [c["id"] for c in checks if c["status"] == "skip"]
    return {
        "metric": "torch_doctor",
        "verdict": "fail" if failed else "pass",
        "platform": platform,
        "failed_checks": failed,
        "skipped_checks": skipped,
        "checks": checks,
        "config": {
            "expect": args.expect,
            "capacity": args.capacity,
            "flows_per_tick": args.flows_per_tick,
            "ticks": args.ticks,
            "table_rows": args.table_rows,
            "compile_budget_s": args.compile_budget_s,
            "hbm_headroom": args.hbm_headroom,
            "cadence_budget_s": args.cadence_budget_s,
        },
        "device": device,
    }


def run_doctor(args) -> dict:
    import numpy as np
    import torch

    from traffic_classifier_sdn_tpu_torch.ingest.batcher import (
        FlowStateEngine,
    )
    from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows
    from traffic_classifier_sdn_tpu_torch.models import gnb, module_predict
    from traffic_classifier_sdn_tpu_torch.native import engine as native_engine
    from traffic_classifier_sdn_tpu_torch.obs.device import DeviceTelemetry
    from traffic_classifier_sdn_tpu_torch.ops import cuda_build
    from traffic_classifier_sdn_tpu_torch.serving.incremental import (
        IncrementalLabels,
    )
    from traffic_classifier_sdn_tpu_torch.serving.warmup import (
        warmup_serving,
    )
    from traffic_classifier_sdn_tpu_torch.utils import syncguard

    checks: list = []

    # -- platform ---------------------------------------------------------
    if args.platform == "default" and not torch.cuda.is_available():
        _check(checks, "platform", "fail",
               "--platform default wants the card and torch finds no CUDA "
               "device; the run would measure the wrong backend",
               platform="none", expected=args.expect)
        return _no_card_bundle(args, checks)
    device = torch.device("cuda" if args.platform == "default" else "cpu")
    on_card = device.type == "cuda"
    platform = "gpu" if on_card else "cpu"
    dev = DeviceTelemetry(device=device)
    dev.attach()
    ident = {"device_type": device.type}
    if on_card:
        ident["device_name"] = torch.cuda.get_device_name(device)
        ident["nvidia_smi"] = _card_identity()
    print(f"# device: {device} {ident}", file=sys.stderr, flush=True)
    if args.expect == "any":
        _check(checks, "platform", "pass",
               f"platform={platform} (no expectation set)",
               platform=platform, **ident)
    elif platform == args.expect:
        _check(checks, "platform", "pass",
               f"platform={platform} as expected", platform=platform,
               **ident)
    else:
        _check(checks, "platform", "fail",
               f"expected platform={args.expect}, got {platform} — "
               "the run would measure the wrong backend",
               platform=platform, expected=args.expect, **ident)

    # -- compile budget: the kernels' build and load, then the warmup -----
    kernels = _build_kernels(cuda_build) if on_card else None
    rng = np.random.RandomState(0)
    params = gnb.GnbModel.from_numpy({
        "theta": rng.gamma(2.0, 100.0, (6, 12)),
        "var": rng.gamma(2.0, 50.0, (6, 12)) + 1.0,
        "class_prior": np.full(6, 1 / 6),
    }, device=device)
    predict = module_predict
    eng = FlowStateEngine(args.capacity, device=device,
                          native=native_engine.available(), track_dirty=True)
    t0 = time.perf_counter()
    warmup_serving(eng, predict, params, table_rows=args.table_rows,
                   idle_timeout=3600, incremental=True)
    warm_wall = time.perf_counter() - t0
    kernel_s = kernels["build_s"] + kernels["load_s"] if kernels else 0.0
    compile_s = kernel_s + warm_wall
    if kernels is None:
        what = ("no kernel built on the CPU (the wrappers take their plain "
                f"versions); warmup {warm_wall:.2f}s")
    else:
        how = (f"built {', '.join(kernels['built'])}" if kernels["built"]
               else "already built, loaded only")
        what = (f"{len(KERNELS)} kernels {how} in {kernel_s:.2f}s "
                f"(build {kernels['build_s']}s, load {kernels['load_s']}s)"
                f", warmup {warm_wall:.2f}s")
    row = {"compile_s": round(compile_s, 3),
           "warm_wall_s": round(warm_wall, 3), "kernels": kernels}
    if compile_s <= args.compile_budget_s:
        _check(checks, "compile", "pass",
               f"{what}, within {args.compile_budget_s}s", **row)
    else:
        _check(checks, "compile", "fail",
               f"{what}: {compile_s:.2f}s exceeds the "
               f"{args.compile_budget_s}s budget", **row)

    # -- measured micro-serve: retrace + transfers + cadence --------------
    syn = SyntheticFlows(n_flows=args.flows_per_tick, seed=0)
    fill = syn.tick_bytes()
    payloads = [syn.tick_bytes() for _ in range(args.ticks)]
    inc = IncrementalLabels(eng, predict, params)

    def settle(labels) -> None:
        if on_card and isinstance(labels, torch.Tensor):
            torch.cuda.current_stream(device).synchronize()

    eng.mark_tick()
    eng.ingest_bytes(fill)
    eng.step()
    settle(inc.labels())
    dev.mark_warmup_complete()
    libs_before = _library_state(cuda_build)
    segs_before = (torch.cuda.memory_stats(device)["segment.all.allocated"]
                   if on_card else None)
    budget = syncguard.load_budget()
    tick_walls = []
    with syncguard.guarding(budget=budget) as witness:
        for payload in payloads:
            t0 = time.perf_counter()
            eng.mark_tick()
            eng.ingest_bytes(payload)
            eng.step()
            labels = inc.labels()
            settle(labels)
            eng.render_sample(labels, args.table_rows)
            eng.evict_idle(now=eng.last_time, idle_seconds=3600)
            tick_walls.append(time.perf_counter() - t0)
    dev.sample()

    libs_after = _library_state(cuda_build)
    loads = libs_after[0] - libs_before[0]
    new_libs = sorted(set(libs_after[1]) - set(libs_before[1]))
    row = {"library_loads": loads, "libraries_built": new_libs}
    if on_card:
        segs = (torch.cuda.memory_stats(device)["segment.all.allocated"]
                - segs_before)
        row["allocator_segments_new"] = segs
        seen = (f"{segs} new allocator segment(s), {loads} kernel library "
                f"load(s), {len(new_libs)} built (the GNB micro-serve "
                "launches no kernel, so only the segment count is "
                "informative here)")
        clean = loads == 0 and not new_libs and segs == 0
    else:
        seen = (f"{loads} kernel library load(s), {len(new_libs)} built "
                "(the CPU allocator has no segments to count, and the GNB "
                "micro-serve launches no kernel)")
        clean = loads == 0 and not new_libs
    if clean:
        _check(checks, "retrace", "pass",
               f"{seen} across {args.ticks} measured ticks", **row)
    else:
        _check(checks, "retrace", "fail",
               f"{seen} inside the {args.ticks} measured ticks — a "
               "first-use cost in the serve would poison every "
               "measurement downstream", **row)

    # -- hbm headroom -----------------------------------------------------
    if not on_card:
        _check(checks, "hbm", "skip",
               f"mem_get_info() unavailable on platform={platform} — "
               "headroom unverifiable here, not a failure",
               hbm_bytes=None)
    else:
        free, total = torch.cuda.mem_get_info(device)
        headroom = free / total
        row = {
            "bytes_in_use": int(total - free), "bytes_limit": int(total),
            "headroom_fraction": round(headroom, 4),
            "allocated_bytes": int(torch.cuda.memory_allocated(device)),
        }
        if headroom >= args.hbm_headroom:
            _check(checks, "hbm", "pass",
                   f"{headroom:.1%} device memory free after table fill "
                   f"(floor {args.hbm_headroom:.0%})", **row)
        else:
            _check(checks, "hbm", "fail",
                   f"only {headroom:.1%} device memory free after table "
                   "fill — the 2^20 table or a leak would run out "
                   "mid-run", **row)

    # -- transfers vs the static ledger -----------------------------------
    if budget is None:
        _check(checks, "transfers", "skip",
               "docs/artifacts/torch_hot_path_sync_budget.json missing — "
               "run `python -m traffic_classifier_sdn_tpu_torch."
               "analysis_static --sync-budget` first")
    else:
        verdict = witness.check_against(budget)
        counts = witness.counts()
        d2h = sum(
            n for kinds in counts.values()
            for kind, n in kinds.items()
            if kind in syncguard.D2H_KINDS
        )
        row = {
            "d2h_syncs_observed": d2h,
            "d2h_syncs_per_tick": round(d2h / args.ticks, 2),
            "unknown_syncs": verdict["unknown_syncs"],
        }
        if verdict["unknown_syncs"]:
            _check(checks, "transfers", "fail",
                   f"{len(verdict['unknown_syncs'])} hot-span sync "
                   "site(s) off the static allowlist — a hot path "
                   "regressed or the resolver has a hole", **row)
        else:
            _check(checks, "transfers", "pass",
                   f"{d2h} device→host syncs over {args.ticks} ticks, "
                   "all hot-span sites on the allowlist", **row)

    # -- cadence ----------------------------------------------------------
    p50 = float(np.median(tick_walls))
    row = {
        "tick_p50_s": round(p50, 4),
        "tick_max_s": round(max(tick_walls), 4),
    }
    if p50 <= args.cadence_budget_s:
        _check(checks, "cadence", "pass",
               f"tick p50 {p50 * 1e3:.1f} ms within the "
               f"{args.cadence_budget_s}s cadence budget", **row)
    else:
        _check(checks, "cadence", "fail",
               f"tick p50 {p50 * 1e3:.1f} ms blows the "
               f"{args.cadence_budget_s}s cadence budget — the serve "
               "loop cannot hold its render cadence here", **row)

    dev.detach()
    return _bundle(args, checks, platform, dev.status())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--platform", choices=("cpu", "default"), default="default",
        help="default (the default) runs on the card and fails without "
        "one; cpu runs on torch.device('cpu')",
    )
    ap.add_argument(
        "--expect", choices=("any", "cpu", "tpu", "gpu"), default=None,
        help="fail the platform check unless the micro-serve runs on "
        "this platform (a card is gpu); defaults to gpu with --platform "
        "default and to any with --platform cpu",
    )
    ap.add_argument("--capacity", type=int, default=1 << 14)
    ap.add_argument("--flows-per-tick", type=int, default=2048)
    ap.add_argument("--ticks", type=int, default=8)
    ap.add_argument("--table-rows", type=int, default=64)
    ap.add_argument("--compile-budget-s", type=float, default=120.0)
    ap.add_argument(
        "--hbm-headroom", type=float, default=0.2,
        help="minimum fraction of device memory that must be free "
        "after the table fill (default 0.2)",
    )
    ap.add_argument("--cadence-budget-s", type=float, default=1.0)
    ap.add_argument(
        "--out", default=None, metavar="PATH",
        help="write the bundle here atomically (in addition to "
        "stdout) — written on BOTH verdicts, so a failing preflight "
        "still leaves its evidence",
    )
    args = ap.parse_args()
    if args.expect is None:
        args.expect = "gpu" if args.platform == "default" else "any"
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )

    bundle = run_doctor(args)
    print(json.dumps(bundle), flush=True)
    if args.out:
        from traffic_classifier_sdn_tpu_torch.utils.atomicio import (
            atomic_write_bytes,
        )

        out_dir = os.path.dirname(os.path.abspath(args.out))
        os.makedirs(out_dir, exist_ok=True)
        atomic_write_bytes(
            args.out, (json.dumps(bundle, indent=2) + "\n").encode(),
        )
        print(f"# doctor bundle: {args.out}", file=sys.stderr,
              flush=True)
    if bundle["verdict"] != "pass":
        sys.exit(
            "torch_doctor: FAIL — " + ", ".join(bundle["failed_checks"])
        )


if __name__ == "__main__":
    main()

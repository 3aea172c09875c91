"""The evidence behind ``chip_smoke.py``'s profile gate, on a card: how
much a ``/profile`` capture slows what runs after it, and how much one
serve's device-stage predicts vary with no capture to explain it.

Two measurements, each in processes of their own:

* ``--iso N``: N fresh processes with no serve threads for each of
  ``--variants``. Each times, on the host clock, 300 forest predicts of
  65,536 rows (kernel, argmax, copy of the labels to the host) and 20
  runs of 1,000 one-element launches: before a 1 s ``torch.profiler``
  capture with CUDA activity (``utils/profiling.trace``), right after
  it, and ten seconds later, and counts the process's threads before and
  after. A variant changes the capture (``utils/profiling.trace``
  throughout): ``none``; ``cpu-only`` (no CUDA activity, so no CUPTI);
  ``teardown`` and ``keep-cupti`` (the process started with
  ``TEARDOWN_CUPTI=1`` or ``0``: kineto tears CUPTI down after the
  trace, or keeps it subscribed); ``twice`` and ``teardown-twice`` (two
  captures back to back). Each capture prints whether its trace names
  the forest kernel.
* ``--serves N``: N runs of ``chip_smoke.profiled_serves`` (a forest
  serve of 65,536 flows in a process of its own, one perf-ring segment a
  tick, ``/profile?seconds=1`` after its warm predicts). Each prints the
  predicts around its capture and the ratio of the p50 after it to the
  p50 before it at 8, 16, 32 and ``chip_smoke.profile_plan``'s window
  of predicts a side.

Run it from the repo root on a machine with the card (~6 minutes)::

    python3 tools/torch_profile_gate.py --iso 2 --serves 2

It builds the kernels as ``chip_smoke.py`` does, and exits 1 without a card.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _forest(cs, dev):
    """The smoke's seeded forest and a 65,536-row feature matrix."""
    import torch

    from traffic_classifier_sdn_tpu_torch.core import flow_table as ft

    X = ft.features12(cs.synthetic_table(cs.CAPACITY, 3, dev))
    sample = X[torch.randperm(cs.CAPACITY, generator=torch.Generator()
                              .manual_seed(cs.SEED))[:4096].to(dev)]
    return cs.random_forest(cs.SEED, sample.cpu().numpy()), X


VARIANT_ENV = {"teardown": {"TEARDOWN_CUPTI": "1"},
               "teardown-twice": {"TEARDOWN_CUPTI": "1"},
               "keep-cupti": {"TEARDOWN_CUPTI": "0"}}
VARIANTS = ("none", "cpu-only", "teardown", "keep-cupti", "twice",
            "teardown-twice")


def _threads() -> int:
    return len(os.listdir("/proc/self/task"))


def iso_child(variant: str = "none") -> None:
    """One process: predicts and launches before and after a capture."""
    import torch

    import chip_smoke as cs
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk
    from traffic_classifier_sdn_tpu_torch.utils import profiling

    dev = torch.device("cuda")
    model, X = _forest(cs, dev)
    k = fk.compile_forest(model, n_features=cs.N_FEATURES, device=dev)
    t = torch.zeros(16, device=dev)

    def predict():
        return fk.forest_proba(k, X).argmax(1).cpu()

    def measure(tag):
        for _ in range(20):
            predict()
        p = []
        for _ in range(300):
            t0 = time.perf_counter()
            predict()
            p.append(time.perf_counter() - t0)
        launch = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(1000):
                t.add_(1)
            launch.append((time.perf_counter() - t0) / 1000)
            torch.cuda.synchronize()
        pm, lm = statistics.median(p) * 1e3, statistics.median(launch) * 1e6
        print(f"  {tag}: predict p50 {pm:.4f} ms (min {min(p) * 1e3:.4f}), "
              f"launch {lm:.3f} us (min {min(launch) * 1e6:.3f})",
              flush=True)
        return pm, lm

    before = measure("before")
    threads = _threads()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        named = []
        for _ in range(2 if variant.endswith("twice") else 1):
            with profiling.trace(d, None if variant == "cpu-only" else dev):
                end = time.perf_counter() + 1.0
                while time.perf_counter() < end:
                    predict()
            trace = max((os.path.join(d, f) for f in os.listdir(d)),
                        key=os.path.getmtime)
            with open(trace) as f:
                named.append("forest_proba" in f.read())
            os.remove(trace)
        print(f"  capture {time.perf_counter() - t0:.2f} s ({variant}); "
              f"threads {threads} -> {_threads()}; the kernel in each "
              f"trace: {named}", flush=True)
    after = measure("after")
    time.sleep(10)
    later = measure("after+10s")
    print(f"  ratio predict {after[0] / before[0]:.3f} launch "
          f"{after[1] / before[1]:.3f}; +10s {later[0] / before[0]:.3f} "
          f"{later[1] / before[1]:.3f}", flush=True)


def serves(n: int) -> None:
    """``n`` profiled serves; the p50 ratio around each capture."""
    import torch

    import chip_smoke as cs
    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.io import checkpoint

    dev = torch.device("cuda")
    model, X = _forest(cs, dev)
    del X
    plan = cs.profile_plan(dev)
    seen = {}
    around = cs.predict_around

    def recording(ring, t0, t1, w):
        seen.update(ring=ring, t0=t0, t1=t1)
        return around(ring, t0, t1, w)

    cs.predict_around = recording
    p50 = cs.nearest_rank_p50
    for run in range(n):
        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "ckpt")
            checkpoint.save_model(
                ckpt, "forest", interop.forest_params_from_numpy(model, dev),
                classes=cs.CLASSES)
            t = time.perf_counter()
            got = cs.profiled_serves(ckpt, tmp, dev)
            series = cs.predicts(seen["ring"])
            b = [(ts, v * 1e3) for ts, v in series if ts < seen["t0"]]
            a = [v * 1e3 for ts, v in series if ts > seen["t1"]]
            gaps = sorted(y[0] - x[0] for x, y in zip(b, b[1:]))
            pm = got["predict_ms"]
            b = [v for _, v in b]
            ratios = {w: round(p50(a[:w]) / p50(b[-w:]), 3)
                      for w in sorted({8, 16, 32, plan[1]})
                      if len(a) >= w and len(b) >= w}
            print(f"SERVE {run} interval {plan[0]} s, window {plan[1]}, warm "
                  f"{plan[2]}: {time.perf_counter() - t:.1f} s, capture "
                  f"{seen['t1'] - seen['t0']:.2f} s, tick gap p50 "
                  f"{gaps[len(gaps) // 2]:.3f} s; p50 {pm['p50_before']} -> "
                  f"{pm['p50_after']} ms; ratio by window {ratios}",
                  flush=True)
            print("  before", [round(v, 3) for v in b[-plan[1]:]])
            print("  after ", [round(v, 3) for v in a[:plan[1]]], flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iso", type=int, default=2,
                    help="fresh processes timing around a capture")
    ap.add_argument("--serves", type=int, default=2,
                    help="profiled serves read around their capture")
    ap.add_argument("--variants", default="none",
                    help="comma-separated variants of the --iso capture: "
                    + ", ".join(VARIANTS))
    ap.add_argument("--iso-child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_gate: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    if args.iso_child:
        iso_child(args.iso_child)  # loads the kernels the parent built
        return 0
    variants = args.variants.split(",")
    unknown = set(variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    cs.phase_environment()
    cs.INSTANCES.update(cs.phase_build())
    for i in range(args.iso):
        for v in variants:
            print(f"ISO {i} {v}", flush=True)
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--iso-child", v],
                cwd=ROOT, capture_output=True, text=True, timeout=600,
                env={**os.environ, **VARIANT_ENV.get(v, {})})
            print(r.stdout.rstrip(), flush=True)
            if r.returncode:
                print(r.stderr[-3000:], file=sys.stderr)
                return 1
    serves(args.serves)
    return 0


if __name__ == "__main__":
    sys.exit(main())

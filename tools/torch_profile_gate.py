"""The evidence behind ``chip_smoke.py``'s profile gates, on a card: what
a ``/profile`` capture costs what runs after it in the same process, and
how much one serve's device-stage predicts vary with no capture to
explain it.

Two measurements, each in processes of their own:

* ``--iso N``: N fresh processes with no serve threads for each of
  ``--variants``. Each times 300 forest predicts of 65,536 rows (kernel,
  argmax, copy of the labels to the host; ``chip_smoke.predict_p50_ms``)
  and the launch loop (``chip_smoke.launch_loops_us``: 20 runs of 1,000
  one-element launches, median, host clock, each run followed by one of
  the same op on a CPU tensor, the host's own pace; a launch's own cost
  is the one less the other) before any capture, after the first and
  after the third of three 1 s captures, and counts the process's
  threads. The captures run back to back, each around a loop of
  predicts, with no CUDA call between the second and the third; each
  prints whether its trace names the forest kernel. A variant picks the
  capture: ``none``, no profiler at all (the same loops of predicts: what
  the readings move by themselves); ``port``, the port's
  ``utils/profiling.trace`` (kineto detaches CUPTI once a trace is taken
  and re-attaches it lazily, and the trace waits for the detach);
  ``cpu-only``, the same with CPU activity only; and two that take the
  trace as the port took it before that (``torch.profiler``'s start,
  stop and export, nothing more) in a process started with
  ``TEARDOWN_CUPTI=0`` (``keep-cupti``, kineto's default: CUPTI stays
  attached) or ``=1`` (``teardown``: detached, but nothing waits for it).
* ``--serves N``: N runs of ``chip_smoke.profiled_serves`` (a forest
  serve of 65,536 flows in a process of its own, one perf-ring segment a
  tick, ``/profile?seconds=1`` after its warm predicts). Each prints the
  predicts around its capture and the ratio of the p50 after it to the
  p50 before it at 8, 16, 32 and ``chip_smoke.profile_plan``'s window
  of predicts a side.

Two more find where a capture goes blind (ROADMAP Queue 3 item 21), each
capture 1 s while a thread launches forest predicts on a stream of its
own, as a serve's device stage does:

* ``--bisect``: ``chip_smoke.main`` in this process with one ``kineto``
  capture (the pre-fix one) before the first call of each phase of
  ``BISECT_BEFORE``, the first before the kernels phase, stopped before
  the ingest breakdown. Each probe prints whether its trace names the
  forest kernel, and the launch loop and a launch's own cost just before
  and after it.
* ``--late PART:CAPTURE,...``: a fresh process for each entry runs a
  part of ``chip_smoke.phase_kernels`` (``kernels``, all of it; or only
  its ``forest``, ``knn``, ``svc`` or ``nonfinite`` checks), then three
  captures (``kineto`` or ``port``): the first CUPTI attach of the
  process comes late, as it did in the script's obs phase.

Run it from the repo root on a machine with the card (~15 minutes for the
first line, ~17 for the second)::

    python3 tools/torch_profile_gate.py --iso 3 --serves 5
    python3 tools/torch_profile_gate.py --iso 0 --serves 0 --bisect \
        --late kernels:kineto,kernels:port,forest:kineto,knn:kineto

It builds the kernels as ``chip_smoke.py`` does, and exits 1 without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
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


VARIANTS = ("none", "port", "cpu-only", "keep-cupti", "teardown")
VARIANT_ENV = {"keep-cupti": {"TEARDOWN_CUPTI": "0"},
               "teardown": {"TEARDOWN_CUPTI": "1"}}
CAPTURES = 3


@contextlib.contextmanager
def kineto_trace(log_dir: str):
    """A trace taken as ``utils/profiling.trace`` took it before it
    detached CUPTI: start, the block, stop, export."""
    from torch.profiler import profile

    from traffic_classifier_sdn_tpu_torch.utils import profiling

    prof = profile(activities=profiling.activities(True))
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace-{time.monotonic_ns()}.json"))


class Stage:
    """The forest, its 65,536 rows and a thread that launches predicts on
    a stream of its own while a capture runs."""

    def __init__(self, cs):
        import torch

        from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk

        self.cs, self.fk, self.torch = cs, fk, torch
        dev = torch.device("cuda")
        model, self.X = _forest(cs, dev)
        self.k = fk.compile_forest(model, n_features=cs.N_FEATURES,
                                   device=dev)
        self.t = torch.zeros(16, device=dev)
        self.stream = torch.cuda.Stream(dev)

    def predict(self):
        return self.fk.forest_proba(self.k, self.X).argmax(1).cpu()

    def launch_us(self) -> list:
        """[the launch loop, its own cost] in µs (``launch_loops_us``)."""
        launch, ref = self.cs.launch_loops_us(self.t)
        return [round(launch, 3), round(launch - ref, 3)]

    def capture(self, capture, log_dir: str) -> dict:
        """One 1 s ``capture`` with the thread launching: whether the trace
        names the forest kernel, its forest events, the launches made while
        it ran, and its wall seconds."""
        import threading

        torch, fk = self.torch, self.fk
        stop = threading.Event()

        def run():
            with torch.cuda.stream(self.stream):
                while not stop.is_set():
                    self.predict()

        th = threading.Thread(target=run)
        th.start()
        t0, n0 = time.perf_counter(), fk.forest_proba.launches
        try:
            with capture(log_dir):
                time.sleep(1.0)
        finally:
            n1 = fk.forest_proba.launches
            stop.set()
            th.join()
        wall = time.perf_counter() - t0
        [trace] = [os.path.join(log_dir, f) for f in os.listdir(log_dir)]
        forest = self.forest_events(trace)
        os.remove(trace)
        return {"named": forest > 0, "forest_events": forest,
                "launches": n1 - n0, "wall_s": round(wall, 3)}

    def forest_events(self, trace: str) -> int:
        """The forest kernel's events in a Chrome trace file."""
        return sum("forest_proba" in e.get("name", "")
                   for e in self.cs.trace_events(trace)
                   if e.get("cat") == "kernel")


CAPTURE_KINDS = ("kineto", "port")
BISECT_BEFORE = (
    "phase_kernels", "phase_serve", "phase_default_serve", "phase_witness",
    "phase_drills", "phase_warmup", "phase_families", "phase_knn_tiers",
    "phase_controller", "phase_obs", "phase_checkpoint", "phase_drift",
    "phase_actuation", "phase_scenarios", "phase_shards", "phase_multihost",
    "phase_dryrun", "phase_ingest_breakdown")
LATE_PARTS = {"forest": "_check_forest", "knn": "_check_knn",
              "svc": "_check_svc", "nonfinite": "_check_nonfinite"}


def _capture_kind(kind: str):
    """The capture ``kind`` names: ``port`` (``utils/profiling.trace`` on
    the card) or ``kineto`` (``kineto_trace``)."""
    import torch

    from traffic_classifier_sdn_tpu_torch.utils import profiling

    if kind == "port":
        return functools.partial(profiling.trace,
                                 device=torch.device("cuda"))
    return kineto_trace


def iso_child(variant: str = "port") -> None:
    """One process: predicts and launches before, between and after
    ``CAPTURES`` captures of ``variant``."""
    import chip_smoke as cs
    from traffic_classifier_sdn_tpu_torch.utils import profiling

    stage = Stage(cs)

    def measure(tag):
        pm = cs.predict_p50_ms(stage.predict, cs.PROFILE_PREDICTS)
        lm, ref = cs.launch_loops_us(stage.t)
        print(f"  {tag}: predict p50 {pm:.4f} ms, launch {lm:.3f} us, "
              f"CPU op {ref:.3f} us, own {lm - ref:.3f} us, "
              f"{len(profiling.thread_ids())} threads", flush=True)
        return pm, lm, ref, lm - ref

    if variant == "none":
        capture = contextlib.nullcontext
    elif variant == "cpu-only":
        capture = functools.partial(profiling.trace, device=None)
    else:
        capture = _capture_kind("port" if variant == "port" else "kineto")
    before = measure("before")
    named, walls = [], []
    with tempfile.TemporaryDirectory() as d:
        for i in range(CAPTURES):
            t0 = time.perf_counter()
            with capture(d):
                end = time.perf_counter() + 1.0
                while time.perf_counter() < end:
                    stage.predict()
            walls.append(round(time.perf_counter() - t0, 3))
            for trace in [os.path.join(d, f) for f in os.listdir(d)]:
                named.append(stage.forest_events(trace) > 0)
                os.remove(trace)
            if i == 0:
                after1 = measure("after 1")
    after = measure(f"after {CAPTURES}")
    print(f"  captures ({variant}) wall s {walls}; the forest kernel in "
          f"each trace: {named}", flush=True)
    names = ("predict", "launch", "CPU op", "own")
    print("  ratio " + "; ".join(
        f"after {n}: " + " ".join(f"{name} {x / b:.3f}" for name, x, b
                                  in zip(names, a, before))
        for n, a in ((1, after1), (CAPTURES, after))), flush=True)


def bisect() -> None:
    """``chip_smoke.main`` with a kineto capture before each phase of
    ``BISECT_BEFORE``, stopped before the ingest breakdown."""
    import chip_smoke as cs

    class Stop(Exception):
        pass

    box: dict = {}

    def probe(phase: str) -> None:
        stage = box.setdefault("stage", Stage(cs))
        with tempfile.TemporaryDirectory() as d:
            before = stage.launch_us()
            c = stage.capture(_capture_kind("kineto"), d)
            after = stage.launch_us()
        print("BISECT " + json.dumps({
            "before": phase, **c, "launch_own_us": [before, after]}),
            flush=True)

    def probed(name: str):
        fn, seen = getattr(cs, name), []

        def wrapped(*a, **kw):
            if not seen:
                seen.append(name)
                probe(name)
                if name == BISECT_BEFORE[-1]:
                    raise Stop()
            return fn(*a, **kw)

        return wrapped

    for name in BISECT_BEFORE:
        setattr(cs, name, probed(name))
    try:
        cs.main()
    except Stop:
        pass


def late_child(part: str, kind: str) -> None:
    """A part of the kernels phase, then three captures of ``kind``."""
    import torch

    import chip_smoke as cs

    if part != "kernels":
        for p, name in LATE_PARTS.items():
            if p != part:
                setattr(cs, name, lambda *a, **kw: {"max_abs_err": 0.0})
    t0 = time.perf_counter()
    cs.phase_kernels(torch.device("cuda"))
    ran = time.perf_counter() - t0
    stage = Stage(cs)
    before = stage.launch_us()
    caps = []
    with tempfile.TemporaryDirectory() as d:
        for _ in range(CAPTURES):
            caps.append(stage.capture(_capture_kind(kind), d))
    after = stage.launch_us()
    print("LATE " + json.dumps({
        "part": part, "capture": kind, "part_s": round(ran, 1),
        "named": [c["named"] for c in caps], "captures": caps,
        "launch_own_us": [before, after]}), flush=True)


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
    ap.add_argument("--iso", type=int, default=3,
                    help="fresh processes timing around a capture")
    ap.add_argument("--serves", type=int, default=5,
                    help="profiled serves read around their capture")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants of the --iso capture: "
                    + ", ".join(VARIANTS))
    ap.add_argument("--bisect", action="store_true",
                    help="chip_smoke.main with a capture before each phase")
    ap.add_argument("--late", default="",
                    help="comma-separated PART:CAPTURE, PART one of "
                    "kernels, " + ", ".join(LATE_PARTS) + "; CAPTURE one "
                    "of " + ", ".join(CAPTURE_KINDS))
    ap.add_argument("--iso-child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--late-child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_gate: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs

    if args.iso_child:
        iso_child(args.iso_child)  # loads the kernels the parent built
        return 0
    if args.late_child:
        late_child(*args.late_child.split(":"))
        return 0
    variants = args.variants.split(",")
    unknown = set(variants) - set(VARIANTS)
    late = [e.split(":") for e in args.late.split(",") if e]
    if unknown or any(len(e) != 2 or e[0] not in ("kernels", *LATE_PARTS)
                      or e[1] not in CAPTURE_KINDS for e in late):
        ap.error(f"unknown variants {sorted(unknown)} or --late entries")
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
    for part, kind in late:
        print(f"LATE {part} {kind}", flush=True)
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--late-child",
             f"{part}:{kind}"], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        print("\n".join(ln for ln in r.stdout.splitlines()
                        if ln.startswith("LATE")), flush=True)
        if r.returncode:
            print(r.stderr[-3000:], file=sys.stderr)
            return 1
    if args.bisect:
        bisect()
    serves(args.serves)
    return 0


if __name__ == "__main__":
    sys.exit(main())

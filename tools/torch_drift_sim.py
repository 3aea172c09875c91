#!/usr/bin/env python3
"""CPU simulation of the drift phase's stream (``chip_smoke.DriftStream``)
against the open-set gate's calibration and the drift monitor.

    python3 tools/torch_drift_sim.py [--flows 61440] [--factor 10]
        [--shift-at 8] [--calibrate-ticks 1,3,4] [--novel 4096]

Runs the port's flow table on the CPU (native ingest where g++ builds it)
over a ``DriftStream`` of ``--flows`` conversations whose packet rates are
multiplied by ``--factor`` from the 0-based tick ``--shift-at`` on, and
``--novel`` novel conversations reporting from ``--shift-at + 6``. The
labels are the seeded 100-tree forest ``chip_smoke.py`` serves (its plain
version). For each ``--calibrate-ticks`` value k it calibrates the
open-set rule (``serving/openset.py``: per-class stats, threshold 3 times
the worst calibration score) on the active rows of the first k ticks,
and prints, each later tick, the share of the drifting population's
active rows rejected and the novel rows rejected; then a ``DriftMonitor``
(windows of 2 ticks, 2 trips) over the gate's labels prints each window's
score. What the chip phase must calibrate on, and where it trips, read
off these lines. No card is used.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--flows", type=int, default=cs.DRIFT_BASE)
    p.add_argument("--factor", type=float, default=cs.DRIFT_FACTOR)
    p.add_argument("--shift-at", type=int, default=8)
    p.add_argument("--calibrate-ticks", default="1,3,4")
    p.add_argument("--novel", type=int, default=cs.DRIFT_NOVEL)
    p.add_argument("--ticks", type=int, default=18)
    args = p.parse_args()

    from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
    from traffic_classifier_sdn_tpu_torch.ingest.batcher import (
        FlowStateEngine,
    )
    from traffic_classifier_sdn_tpu_torch.native import engine as native
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk
    from traffic_classifier_sdn_tpu_torch.serving import openset as os_
    from traffic_classifier_sdn_tpu_torch.serving.drift import DriftMonitor

    X = ft.features12(cs.synthetic_table(cs.CAPACITY, 3, "cpu"))
    sample = X[torch.randperm(cs.CAPACITY, generator=torch.Generator()
                              .manual_seed(cs.SEED))[:4096]].numpy()
    k = fk.compile_forest(cs.random_forest(cs.SEED, sample), n_features=12,
                          device="cpu")
    stream = cs.DriftStream(args.flows, args.novel)
    engine = FlowStateEngine(args.flows + args.novel, device="cpu",
                             native=native.available())
    ticks = []
    for t in range(args.ticks):
        if t == args.shift_at:
            stream.shift(args.factor)
        engine.mark_tick()
        engine.ingest_bytes(stream.tick_bytes(
            novel=args.novel > 0 and t >= args.shift_at + 6))
        engine.step()
        feats = engine.features()
        labels = fk.forest_proba_plain(k, feats).argmax(-1).numpy()
        ticks.append((feats.numpy().astype(np.float64), labels))

    for n_cal in (int(v) for v in args.calibrate_ticks.split(",")):
        cal = [(Xh[Xh.any(1)], y[Xh.any(1)]) for Xh, y in ticks[:n_cal]]
        CX = np.concatenate([c[0] for c in cal])
        Cy = np.concatenate([c[1] for c in cal])
        ref = os_.class_reference(CX, Cy, cs.N_CLASSES)
        mean, inv = os_.reference_matrices(ref, CX.std(axis=0))
        thr = 3.0 * float(os_.openset_scores(CX, mean, inv).max())
        print(f"calibrated on ticks 1-{n_cal} ({CX.shape[0]} rows): "
              f"threshold {thr:.6g}")
        mon = DriftMonitor(n_classes=cs.N_CLASSES, window=2, trips=2)
        for t, (Xh, y) in enumerate(ticks[n_cal:], start=n_cal):
            active = Xh.any(axis=1)
            rej = active & (os_.openset_scores(Xh, mean, inv) > thr)
            out = np.where(rej, cs.N_CLASSES, y)
            base = active[:args.flows]
            share = float(rej[:args.flows][base].mean()) if base.any() else 0
            report = mon.observe(Xh[active], out[active])
            window = ("" if report is None else
                      f"; window {report['window']} score "
                      f"{report['score']:.4g}"
                      + (" tripped" if report["tripped"] else ""))
            print(f"  tick {t + 1}: {share:.4f} of the drifting rows "
                  f"rejected, {int(rej[args.flows:].sum())} novel rows "
                  f"rejected{window}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run the control of a cell's comparison (``harness/control.py``) at the
cell's own size, on several seeds, in one process:

    python3 benchmark/control.py --workload <cell> --bursts <n> --seeds 1 2 3 \\
        [--kernel-only]

Prints one JSON line per seed: the control's reading of every number the
cell compares, beside its limit, and whether the control failed (it must).
``--kernel-only``: the kernel's arithmetic alone in bfloat16, on the
float32 features (families whose kernel returns its k nearest rows).
Not part of a benchmark run."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(1, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--bursts", type=int, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--kernel-only", action="store_true")
    args = p.parse_args(argv)
    import torch

    from harness import cells, check
    from harness.control import readings

    bench = cells.load_benchmark()
    cell = cells.workload(bench, args.workload)
    config = cells.config(bench, cell["config"])
    traffic = cells.traffic(cell["traffic"])
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(config, traffic, seed, args.bursts, device,
                     kernel_only=args.kernel_only)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "device": str(device),
            "bursts": args.bursts, "kernel_only": args.kernel_only,
            "control_failed": not check.passed(r),
            "seconds": time.perf_counter() - t0,
            "readings": {k: {"value": v, "limit": lim}
                         for k, (v, lim) in r.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The benchmark of the PyTorch and CUDA port (``traffic_classifier_sdn_tpu_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. One run measures one cell of
``BENCHMARK.json`` on this machine's card and prints, as its last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, every number compared with its limit (also the last lines of
standard error). It exits non-zero and prints no result without a CUDA
device, without the program, or if a forbidden module was loaded."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

os.environ.setdefault("USE_FLAX", "0")
# the program is imported from the checkout this file sits in
sys.path.insert(1, str(Path(__file__).resolve().parents[1]))


def _cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    build = root / "benchmark" / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from harness import cells

    _cache_dirs(cells.ROOT)
    import torch

    bench = cells.load_benchmark()
    cell = cells.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from harness.result import result_line
    from harness.runner import run_cell

    config = cells.config(bench, cell["config"])
    traffic = cells.traffic(cell["traffic"])
    device = torch.device("cuda", 0)
    print(f"# {args.workload} seed {args.seed} on {_power_limit()}",
          file=sys.stderr, flush=True)
    out = run_cell(config, traffic, args.seed, args.seconds,
                   bool(args.trace), device,
                   log=lambda s: print(s, file=sys.stderr, flush=True))
    result = result_line(bench, args.workload, out, bool(args.trace), {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": cell["chips"]})
    checks = out["checks"]
    for k, (v, lim) in checks.items():
        print(f"check {k}: {v} (limit {lim})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

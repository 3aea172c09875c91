"""Find the knee of a cell's configuration and traffic once: the highest
rate of bursts the spine sustains with no growing backlog. One process
sets the cell up as a run does, measures the closed-loop rate, then offers
each rate in turn, open loop, for ``--seconds`` and prints one JSON line
per rate: bursts due, label latency p50 and p95 (ms, from when each burst
was due), the host stage's lateness at the start and at the end of the
step, and coalesced renders.

    python3 benchmark/sweep.py --workload <cell> --seed <n> \\
        --seconds 6 --rates 30 40 50 60 70

A rate is sustained when the lateness at the end of its step stays within
two burst intervals and no render coalesced (the device stage kept up).
An open-loop traffic file (``"loop": "open"``) then fixes 4/5 of the knee
as its ``rate_bursts_per_s``. Not part of a benchmark run."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(1, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch

    from harness import cells
    from harness.runner import DRAIN_S, drive, percentile
    from harness.spine import Spine
    from harness.traffic import Feeder, Generator, TrafficSpec

    bench = cells.load_benchmark()
    cell = cells.workload(bench, args.workload)
    config = cells.config(bench, cell["config"])
    traffic = cells.traffic(cell["traffic"])
    spec = TrafficSpec(traffic)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    model = cells.family("families", config["family"]).build(
        config, args.seed, device, cells.ROOT)
    spine = Spine(model, device, spec.capacity,
                  int(config["serve"]["table_rows"]),
                  float(config["serve"]["device_deadline"]))
    feeder = Feeder(Generator(spec, args.seed), spec.queue_depth).start()
    try:
        b = 0
        for _ in range(int(traffic.get("setup_rounds", 2)) * spec.switches):
            spine.feed(*feeder.get())
            b += 1
        spine.drain(DRAIN_S)
        steps = [("closed", None)] + [("open", r) for r in args.rates]
        for loop, rate in steps:
            c0 = spine.pipe.stats()["ticks_coalesced"]
            d0 = len(spine.done)
            handed, due, start, t_end = drive(spine, feeder, b, loop, rate,
                                              args.seconds)
            spine.drain(DRAIN_S)
            b += len(handed)
            done = spine.done[d0:]
            labels_at, j = {}, 0
            for x in handed:
                while j < len(done) and done[j][0] < x:
                    j += 1
                labels_at[x] = done[j][1] if j < len(done) else float("inf")
            row = {"workload": args.workload, "loop": loop, "rate": rate,
                   "bursts": len(handed),
                   "bursts_per_s": len(handed) / args.seconds,
                   "coalesced": spine.pipe.stats()["ticks_coalesced"] - c0}
            if loop == "open":
                lat = [(labels_at[x] - due[x]) * 1e3 for x in handed]
                lag = [(start[x] - due[x]) * 1e3 for x in handed]
                tail = max(1, len(lag) // 10)
                row.update(
                    label_p50_ms=percentile(lat, 50),
                    label_p95_ms=percentile(lat, 95),
                    lag_start_ms=sum(lag[:tail]) / tail,
                    lag_end_ms=sum(lag[-tail:]) / tail,
                    sustained=(sum(lag[-tail:]) / tail <= 2e3 / rate
                               and row["coalesced"] == 0))
            print(json.dumps(row), flush=True)
    finally:
        feeder.stop()
        spine.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

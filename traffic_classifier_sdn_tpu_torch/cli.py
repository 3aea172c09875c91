"""Command-line interface of the port: the ``Randomforest``, ``knearest``
(alias ``kneighbors``) and ``svm`` classify serves.

The serial serve of the JAX CLI (``traffic_classifier_sdn_tpu/cli.py``
``_serve_loop`` and ``_print_table``, run with ``--pipeline off
--incremental off --degrade off --native-ingest off``), with the same flag
names and defaults — except ``--source``, which is required here (the JAX
default, ``ryu``, is not ported yet). Each render tick:

1. poll one tick of telemetry and parse it;
2. the Python ``Batcher`` assigns slots and packs the wire;
3. ``apply_wire`` scatters it into the device flow table;
4. ``features12`` projects the whole table;
5. the model predicts all ``capacity`` rows through its CUDA kernel: the
   forest walk (ops/forest_kernel.py), the KNN top-k (ops/knn_kernel.py)
   or the RBF-SVC decision (ops/rbf_kernel.py);
6. the activity-ranked ``top_active_render`` picks ``--table-rows`` rows;
7. ``utils/table.render_table`` prints them, after idle eviction.

The model family comes from the checkpoint and must match the subcommand.
KNN serves one exact top-k, the semantics of the JAX default ``--knn-topk
sort``; the ``--knn-topk`` menu is not ported. SVC serves the two-float
difference form, the JAX default ``TCSDN_SVC_KERNEL=chunked``.

Sources: ``replay`` (recorded capture file) and ``synthetic`` (generated
flow population). The serve runs on CUDA unless ``--device cpu`` is given.

    python -m traffic_classifier_sdn_tpu_torch.cli knearest \\
        --native-checkpoint DIR --source synthetic --max-ticks 4 --print-every 2
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass, field

import torch

SUBCOMMANDS = ("Randomforest", "randomforest", "knearest", "kneighbors", "svm")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="traffic_classifier_sdn_tpu_torch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("subcommand", choices=SUBCOMMANDS)
    p.add_argument(
        "--native-checkpoint", required=True,
        help="model checkpoint directory in the port's format "
        "(io/checkpoint.py: manifest.json + one .npy per array)",
    )
    p.add_argument(
        "--source", choices=("replay", "synthetic"), required=True,
        help="telemetry source: 'replay' reads --capture, 'synthetic' "
        "generates flows",
    )
    p.add_argument("--capture", help="capture file for --source replay")
    p.add_argument(
        "--synthetic-flows", type=int, default=1024,
        help="synthetic source size",
    )
    p.add_argument("--capacity", type=int, default=65536)
    p.add_argument(
        "--idle-timeout", type=int, default=60,
        help="evict flows idle for N seconds (0 disables; default 60)",
    )
    p.add_argument(
        "--print-every", type=int, default=10,
        help="render every N poll ticks (default 10)",
    )
    p.add_argument(
        "--max-ticks", type=int, default=0, help="stop after N ticks (0=∞)"
    )
    p.add_argument(
        "--table-rows", type=int, default=64,
        help="max flows rendered per table (0 = all; classification "
        "always covers the whole table on the device)",
    )
    p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="device of the flow table and the model (default cuda; "
        "there is no fallback to the CPU)",
    )
    return p


@dataclass
class ServeSummary:
    """What one serve did: the engine at the end, and per-tick host times.
    ``ingest_seconds`` covers parse, batcher and the wire scatter, and
    ``tick_seconds`` the whole tick; both end with a device sync, so they
    cover their device work. ``render_ticks`` are the 1-based ticks that
    printed a table."""

    engine: object
    ticks: int = 0
    ingest_seconds: list = field(default_factory=list)
    tick_seconds: list = field(default_factory=list)
    render_ticks: list = field(default_factory=list)


def _tick_source(args):
    """Yield one list of TelemetryRecords per poll tick."""
    if args.source == "replay":
        if not args.capture:
            sys.exit("--source replay requires --capture FILE")
        from .ingest.replay import iter_capture

        yield from iter_capture(args.capture)
    else:
        from .ingest.replay import SyntheticFlows

        syn = SyntheticFlows(n_flows=args.synthetic_flows)
        while True:
            yield syn.tick()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve_loop(args, engine, model, predict, serve_params) -> ServeSummary:
    summary = ServeSummary(engine=engine)
    dropped_seen = 0
    source = _tick_source(args)
    try:
        for batch in source:
            t0 = time.perf_counter()
            engine.mark_tick()  # freshness floor for the render
            engine.ingest(batch)
            engine.step()
            _sync(engine.device)
            summary.ingest_seconds.append(time.perf_counter() - t0)
            summary.ticks += 1
            if summary.ticks % args.print_every == 0:
                if engine.dropped > dropped_seen:
                    print(
                        f"WARNING: flow table full — "
                        f"{engine.dropped - dropped_seen} new flows dropped "
                        f"since last report (capacity {args.capacity}, "
                        f"idle-timeout {args.idle_timeout}s)",
                        file=sys.stderr,
                    )
                    dropped_seen = engine.dropped
                if args.idle_timeout and engine.last_time:
                    engine.evict_idle(engine.last_time, args.idle_timeout)
                _print_table(engine, model, predict, serve_params, args)
                summary.render_ticks.append(summary.ticks)
            _sync(engine.device)
            summary.tick_seconds.append(time.perf_counter() - t0)
            if args.max_ticks and summary.ticks >= args.max_ticks:
                break
    finally:
        source.close()
    return summary


def _print_table(engine, model, predict, serve_params, args) -> None:
    from .utils.table import CLASSIFIER_FIELDS, render_table, status_str

    labels = predict(serve_params, engine.features())  # stays on the device
    names = model.classes.names

    def name(c: int) -> str:
        return names[c] if c < len(names) else "?"

    if args.table_rows > 0:
        # activity-ranked sample: O(table_rows) crosses to the host
        ranked = engine.render_sample(labels, args.table_rows)
        sample = engine.slot_metadata(slots=[s for s, *_ in ranked])
        rows = [
            (slot, *sample[slot], name(c), status_str(fa), status_str(ra))
            for slot, c, fa, ra in ranked
            if slot in sample
        ]
        print(render_table(CLASSIFIER_FIELDS, rows), flush=True)
        n_flows = engine.num_flows()
        if n_flows > len(rows):
            print(f"... showing {len(rows)} of {n_flows} tracked flows",
                  flush=True)
        return
    idx = labels.cpu().numpy()
    fwd_active = engine.table.fwd.active[:-1].cpu().numpy()
    rev_active = engine.table.rev.active[:-1].cpu().numpy()
    rows = [
        (slot, src, dst, name(int(idx[slot])),
         status_str(bool(fwd_active[slot])),
         status_str(bool(rev_active[slot])))
        for slot, (src, dst) in sorted(engine.slot_metadata().items())
    ]
    print(render_table(CLASSIFIER_FIELDS, rows), flush=True)


def run_classify(args) -> ServeSummary:
    from .device import resolve_device
    from .ingest.batcher import FlowStateEngine
    from .io.checkpoint import load_model
    from .models import SUBCOMMAND_ALIASES

    device = resolve_device(args.device)
    model = load_model(args.native_checkpoint, device=device)
    if model.name != SUBCOMMAND_ALIASES[args.subcommand]:
        sys.exit(
            f"--native-checkpoint holds a {model.name!r} model, not "
            f"{SUBCOMMAND_ALIASES[args.subcommand]!r}"
        )
    if model.classes is None:
        sys.exit("--native-checkpoint stores no class names")
    predict, serve_params = model.serving_path()
    engine = FlowStateEngine(args.capacity, device=device)
    return _serve_loop(args, engine, model, predict, serve_params)


def main(argv=None) -> ServeSummary:
    args = _build_parser().parse_args(argv)
    return run_classify(args)


if __name__ == "__main__":
    main()

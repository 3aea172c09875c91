"""Command-line interface of the port: the ``Randomforest``, ``knearest``
(alias ``kneighbors``) and ``svm`` classify serves.

The serial serve of the JAX CLI (``traffic_classifier_sdn_tpu/cli.py``
``_serve_loop`` and ``_print_table``, run with ``--pipeline off --degrade
off``), with the same flag names and defaults. Each poll tick:

1. poll one tick of telemetry: raw monitor pipe bytes (``--source ryu``
   with the native engine) or parsed records;
2. the C++ ingest engine (native/, ``--native-ingest auto|on``) or the
   Python ``Batcher`` (``off``, or ``auto`` when g++ cannot build it)
   assigns slots and packs the wire;
3. ``apply_wire`` scatters it into the device flow table, setting the
   dirty bit of each touched slot under ``--incremental auto``;

and every ``--print-every`` ticks, after idle eviction:

4. labels: under ``--incremental auto`` only the rows dirtied since the
   last render are gathered (``features12_at``) and predicted, into a
   persistent label cache (serving/incremental.py); under ``off``
   ``features12`` projects the whole table and all ``capacity`` rows are
   predicted. Either way the model runs its CUDA kernel: the forest walk
   (ops/forest_kernel.py), the KNN top-k (ops/knn_kernel.py) or the
   RBF-SVC decision (ops/rbf_kernel.py);
5. the activity-ranked ``top_active_render`` picks ``--table-rows`` rows;
6. ``utils/table.render_table`` prints them.

The model family comes from the checkpoint and must match the subcommand.
KNN serves one exact top-k, the semantics of the JAX default ``--knn-topk
sort``; the ``--knn-topk`` menu is not ported. SVC serves the two-float
difference form, the JAX default ``TCSDN_SVC_KERNEL=chunked``.

Sources: ``ryu`` (the default: a monitor subprocess, ``--monitor-cmd``,
whose stdout is the telemetry pipe, restarted up to ``--monitor-restarts``
times when it dies), ``replay`` (recorded capture file) and ``synthetic``
(generated flow population). The serve runs on CUDA unless ``--device
cpu`` is given.

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
        "--source", choices=("ryu", "replay", "synthetic"), default="ryu",
        help="telemetry source: 'ryu' spawns the reference's monitor "
        "command (or --monitor-cmd), 'replay' reads --capture, "
        "'synthetic' generates flows",
    )
    p.add_argument(
        "--monitor-cmd", default=None,
        help="override the spawned monitor command (--source ryu)",
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
        "--native-ingest", choices=("auto", "on", "off"), default="auto",
        help="use the C++ ingest engine (native/flow_engine.cpp); auto "
        "falls back to the pure-Python batcher if g++ is unavailable",
    )
    p.add_argument(
        "--monitor-restarts", type=int, default=5,
        help="restart a dead monitor up to N times with exponential "
        "backoff (0 disables supervision; the reference just exits)",
    )
    p.add_argument(
        "--incremental", choices=("auto", "off"), default="auto",
        help="incremental labels (serving/incremental.py): track which "
        "table rows each ingest scatter touched and re-predict ONLY "
        "those, merging fresh labels into a persistent label cache on "
        "the device; output is byte-identical to the full re-predict. "
        "'off' predicts the whole table every render tick",
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
    printed a table; under ``--incremental auto`` ``render_plans`` holds
    each one's label plan, ``(kind, rows)``: ``none``, ``subset`` or
    ``full`` and the dirty count behind it."""

    engine: object
    ticks: int = 0
    ingest_seconds: list = field(default_factory=list)
    tick_seconds: list = field(default_factory=list)
    render_ticks: list = field(default_factory=list)
    render_plans: list = field(default_factory=list)


def _use_native(args) -> bool:
    if args.native_ingest == "off":
        return False
    from .native import engine as native_engine

    ok = native_engine.available()
    if args.native_ingest == "on" and not ok:
        sys.exit("ERROR: --native-ingest on, but the C++ engine won't build")
    return ok


def _tick_source(args, raw: bool = False):
    """Yield one batch of telemetry per poll tick: a list of
    TelemetryRecords, or raw pipe bytes when ``raw`` (the native engine's
    bulk path — no per-line Python between the pipe and C++)."""
    if args.source == "replay":
        if not args.capture:
            sys.exit("--source replay requires --capture FILE")
        from .ingest.replay import iter_capture

        yield from iter_capture(args.capture)
    elif args.source == "synthetic":
        from .ingest.replay import SyntheticFlows

        syn = SyntheticFlows(n_flows=args.synthetic_flows)
        while True:
            yield syn.tick()
    else:
        from .ingest.collector import DEFAULT_MONITOR_CMD, SubprocessCollector

        cmd = args.monitor_cmd or DEFAULT_MONITOR_CMD
        if args.monitor_restarts:
            from .ingest.supervisor import SupervisedCollector

            coll = SupervisedCollector(
                cmd, raw=raw, max_restarts=args.monitor_restarts
            )
        else:
            coll = SubprocessCollector(cmd, raw=raw)
        coll.start()
        try:
            while True:
                first = coll.wait_record(timeout=2.0)
                if first is None:
                    if not coll.running:
                        break  # monitor exited and the queue is drained
                    continue
                time.sleep(0.05)  # let the 1 Hz burst of lines arrive
                rest = coll.poll_records()
                if raw:
                    yield first + b"".join(rest)
                else:
                    yield [first] + rest
        finally:
            coll.stop()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve_loop(args, engine, model, predict, serve_params,
                inc=None) -> ServeSummary:
    summary = ServeSummary(engine=engine)
    dropped_seen = 0
    errors_seen = 0
    # raw bytes wherever the native engine can take them: the pipe source
    source = _tick_source(args, raw=engine.native and args.source == "ryu")
    try:
        for batch in source:
            t0 = time.perf_counter()
            engine.mark_tick()  # freshness floor for the render
            if isinstance(batch, bytes):
                engine.ingest_bytes(batch)
            else:
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
                if engine.parse_errors() > errors_seen:
                    print(
                        f"WARNING: {engine.parse_errors() - errors_seen} "
                        f"malformed telemetry lines skipped since last "
                        f"report",
                        file=sys.stderr,
                    )
                    errors_seen = engine.parse_errors()
                if args.idle_timeout and engine.last_time:
                    engine.evict_idle(engine.last_time, args.idle_timeout)
                plan = _print_table(engine, model, predict, serve_params,
                                    args, inc)
                summary.render_ticks.append(summary.ticks)
                if plan is not None:
                    summary.render_plans.append((plan.kind, plan.n_dirty))
            _sync(engine.device)
            summary.tick_seconds.append(time.perf_counter() - t0)
            if args.max_ticks and summary.ticks >= args.max_ticks:
                break
    finally:
        source.close()
    return summary


def _print_table(engine, model, predict, serve_params, args, inc=None):
    """Label the table and print the tick's table; returns the incremental
    label plan (None under ``--incremental off``)."""
    from .utils.table import CLASSIFIER_FIELDS, render_table, status_str

    plan = None
    if inc is not None:
        # only this tick's dirty rows are predicted; the rest come from
        # the label cache
        plan = inc.dispatch()
        labels = inc.finish(plan)
    else:
        labels = predict(serve_params, engine.features())  # on the device
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
        return plan
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
    return plan


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
    engine = FlowStateEngine(
        args.capacity, device=device, native=_use_native(args),
        track_dirty=args.incremental != "off",
    )
    inc = None
    if args.incremental != "off":
        from .serving.incremental import IncrementalLabels

        inc = IncrementalLabels(engine, predict, serve_params)
    return _serve_loop(args, engine, model, predict, serve_params, inc)


def main(argv=None) -> ServeSummary:
    args = _build_parser().parse_args(argv)
    return run_classify(args)


if __name__ == "__main__":
    main()

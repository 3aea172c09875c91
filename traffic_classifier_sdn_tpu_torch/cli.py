"""Command-line interface of the port: the ``Randomforest``, ``knearest``
(alias ``kneighbors``), ``svm``, ``logistic``, ``gaussiannb`` and
``kmeans`` classify serves.

The serve of the JAX CLI (``traffic_classifier_sdn_tpu/cli.py``
``_serve_loop``, ``_dispatch_render``, ``_print_table``), with the same flag
names and defaults: with no flag it runs what the JAX CLI runs with no
flag. Each poll tick, on the host stage:

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
   predicted. The forest, KNN and SVC run their CUDA kernel: the forest
   walk (ops/forest_kernel.py), the KNN top-k (ops/knn_kernel.py) or the
   RBF-SVC decision (ops/rbf_kernel.py); logistic regression, Gaussian
   naive Bayes and k-means run as plain torch ops (the JAX package
   computes them in XLA, in no hand-written kernel);
5. the activity-ranked ``top_active_render`` picks ``--table-rows`` rows;
6. ``utils/table.render_table`` prints them.

``--degrade auto`` (the default) runs the predict through the degradation
ladder (serving/degrade.py): the kernel's labels come back to the host
under a watchdog deadline, and a dispatch past its deadline demotes to a
host fallback (the native C++ forest or KNN, the plain torch version on
the CPU for SVC) until probes re-promote it; labels are then host arrays,
read through the host-mode label cache. On the card any other error of
the device predict (a CUDA error, a fault in a kernel wrapper) ends the
serve: only a missed deadline or an armed fault site (utils/faults.py)
demotes. ``--pipeline auto`` (the default)
runs steps 4-6 on a device-stage worker (serving/pipeline.py): the host
stage dispatches each render and goes on ingesting; when the worker falls
behind, renders coalesce (``ticks_coalesced``). ``--pipeline off
--degrade off`` is the serial, bare-kernel serve.

The model family comes from the checkpoint and must match the subcommand.
KNN serves one exact top-k, the semantics of the JAX default ``--knn-topk
sort``; the ``--knn-topk`` menu is not ported. SVC serves the two-float
difference form, the JAX default ``TCSDN_SVC_KERNEL=chunked``.

Sources: ``ryu`` (the default: a monitor subprocess, ``--monitor-cmd``,
whose stdout is the telemetry pipe, restarted up to ``--monitor-restarts``
times when it dies), ``replay`` (recorded capture file) and ``synthetic``
(generated flow population). ``--sources N`` or ``--source-spec KIND:ARG``
(repeatable) serve many sources through the fan-in tier
(ingest/fanin.py), each in its own flow-table namespace: with the native
engine every source's poll batch goes into it as raw bytes under its
source id, and a source that dies uncleanly has exactly its own
namespace evicted once ``--source-quarantine`` expires. The serve runs on
CUDA unless ``--device cpu`` is given.

    python -m traffic_classifier_sdn_tpu_torch.cli knearest \\
        --native-checkpoint DIR --source synthetic --max-ticks 4 --print-every 2
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time
from dataclasses import dataclass, field

import torch

SUBCOMMANDS = ("logistic", "kmeans", "knearest", "kneighbors", "svm",
               "Randomforest", "randomforest", "gaussiannb")
# renders the pipelined serve's handoff holds before new ones coalesce
PIPELINE_DEPTH = 2


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
        "--sources", type=int, default=0, metavar="N",
        help="fan-in ingest tier (ingest/fanin.py): serve N "
        "independently supervised telemetry sources of the base "
        "--source kind through one bounded MPSC queue, each in its own "
        "flow-table namespace (source id folded into the flow key). A "
        "dead source quarantines and evicts only its own namespace; "
        "every other source keeps serving. 0 (default) = the direct "
        "single-collector path",
    )
    p.add_argument(
        "--source-spec", action="append", metavar="KIND:ARG",
        help="explicit fan-in source (repeatable; implies the fan-in "
        "tier, source ids by position): cmd:<monitor command>, "
        "capture:<path>, or synthetic:<n_flows> — mix live and replay "
        "sources in one serve",
    )
    p.add_argument(
        "--source-quarantine", type=float, default=5.0, metavar="SECS",
        help="grace window between a source's unclean death and the "
        "eviction of its namespace (default 5.0): a source restarted "
        "within it re-registers into its old namespace with its flows "
        "intact",
    )
    p.add_argument(
        "--source-interval", type=float, default=1.0, metavar="SECS",
        help="emission pacing for pull-paced fan-in sources "
        "(capture/synthetic): one poll tick per SECS (default 1.0, "
        "the reference monitor's cadence; 0 = flat out)",
    )
    p.add_argument(
        "--source-lockstep", action="store_true",
        help="pace pull-paced fan-in sources by consumer credit (one "
        "emission per serve tick) instead of wall clock — "
        "deterministic multi-source runs (tests, identity checks)",
    )
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
        "--pipeline", choices=("auto", "on", "off"), default="auto",
        help="pipelined serving (serving/pipeline.py): overlap host "
        "poll/parse/scatter with device predict/render through a bounded "
        "two-deep handoff (auto = on). When the device stage falls "
        "behind, render ticks coalesce (ticks_coalesced) instead of "
        "queueing unboundedly; 'off' restores the serial poll -> parse "
        "-> scatter -> predict -> render chain",
    )
    p.add_argument(
        "--degrade", choices=("auto", "off"), default="auto",
        help="degradation ladder (serving/degrade.py): wrap the device "
        "predict in a watchdog and demote to a host fallback (native C++ "
        "forest/KNN, the plain torch version on the CPU otherwise) "
        "instead of wedging when a dispatch misses its deadline; probes "
        "re-promote after recovery. On a CUDA device any other device "
        "error ends the serve. 'off' restores the bare predict path",
    )
    p.add_argument(
        "--device-deadline", type=float, default=2.0, metavar="SECS",
        help="watchdog deadline per device-stage dispatch, the labels' "
        "copy to the host included (default 2.0; 0 disables the deadline "
        "— wedged dispatches then block). The "
        "first dispatch gets 10x (min 60 s)",
    )
    p.add_argument(
        "--probe-every", type=float, default=5.0, metavar="SECS",
        help="base interval between recovery probes while degraded "
        "(default 5.0); failed probes back off exponentially from this "
        "base with full jitter",
    )
    p.add_argument(
        "--probe-successes", type=int, default=3, metavar="N",
        help="consecutive clean probes required to re-promote the device "
        "kernel (default 3); any failed probe resets the chain",
    )
    p.add_argument(
        "--warmup", action="store_true",
        help="pay the serve's first-use costs at startup "
        "(serving/warmup.py: kernel build, pinned wire stages, the "
        "predict at full capacity and at every dirty bucket, the degrade "
        "ladder's first call and host rung, the ranked render) so the "
        "first tick runs hot",
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
    ``tick_seconds`` the whole tick; both end with a wait on the serve
    loop's stream, so they cover their device work (the pipelined tick
    covers the host stage: its renders finish on the device stage).
    ``render_ticks`` are the 1-based ticks that rendered (pipelined: that
    dispatched a render, ``ticks_coalesced`` of which were superseded
    before they printed); under ``--incremental auto`` ``render_plans``
    holds each one's label plan, ``(kind, rows)``: ``none``, ``subset`` or
    ``full`` and the dirty count behind it. ``degrade`` is the ladder's
    final ``status()`` (None under ``--degrade off``) and
    ``degrade_transitions`` its ``(from, to, reason)`` edges, ``pipeline`` the
    pipeline's ``stats()`` (None under ``--pipeline off``), ``warmup``
    what ``--warmup`` returned. Under the fan-in tier ``roster`` is its
    final ``roster()`` (one row per source) and ``source_evictions`` one
    ``(tick, source id, flows evicted, seconds)`` per dead namespace
    evicted."""

    engine: object
    ticks: int = 0
    ingest_seconds: list = field(default_factory=list)
    tick_seconds: list = field(default_factory=list)
    render_ticks: list = field(default_factory=list)
    render_plans: list = field(default_factory=list)
    ticks_coalesced: int = 0
    degrade: dict | None = None
    degrade_transitions: list = field(default_factory=list)
    pipeline: dict | None = None
    warmup: dict | None = None
    roster: list | None = None
    source_evictions: list = field(default_factory=list)

    @property
    def evicted_flows(self) -> int:
        """Flows evicted with dead sources' namespaces."""
        return sum(n for _, _, n, _ in self.source_evictions)


def _use_native(args) -> bool:
    if args.native_ingest == "off":
        return False
    from .native import engine as native_engine

    ok = native_engine.available()
    if args.native_ingest == "on" and not ok:
        sys.exit("ERROR: --native-ingest on, but the C++ engine won't build")
    return ok


def _fanin_active(args) -> bool:
    """The fan-in ingest tier engages on --sources N or any
    --source-spec entry."""
    return args.sources > 0 or bool(args.source_spec)


def _fanin_tier(args, raw: bool):
    """The fan-in tier of the CLI's fan-in flags (exits on a bad spec)."""
    from .ingest import fanin
    from .ingest.collector import DEFAULT_MONITOR_CMD

    try:
        specs = fanin.specs_from_cli(
            args.source, max(1, args.sources), args.source_spec,
            capture=args.capture,
            monitor_cmd=args.monitor_cmd or DEFAULT_MONITOR_CMD,
            synthetic_flows=args.synthetic_flows,
            max_restarts=args.monitor_restarts or 0,
            interval=args.source_interval,
            lockstep=args.source_lockstep,
        )
    except ValueError as e:
        sys.exit(f"ERROR: {e}")
    # native ingest rides the raw wire end to end: pumps deliver bytes,
    # ticks() yields RawTick batches, and the C++ keyer namespaces per
    # (sid, payload) pair. The queue holds at least one poll of every
    # tracked flow (two records each): under the JAX tier's fixed 65,536
    # records, a table above 32,768 flows split over sources drops a
    # whole source's poll whenever two polls queue together.
    return fanin.FanInIngest(
        specs, queue_records=max(1 << 16, 2 * args.capacity),
        quarantine_s=args.source_quarantine, raw=raw,
    )


def _tick_source(args, raw: bool = False, tier=None):
    """Yield one batch of telemetry per poll tick: a list of
    TelemetryRecords, or raw pipe bytes when ``raw`` (the native engine's
    bulk path — no per-line Python between the pipe and C++). With the
    fan-in ``tier`` the batches are its ticks (a ``RawTick`` of ``(source
    id, bytes)`` pairs when raw)."""
    if tier is not None:
        yield from tier.ticks()
    elif args.source == "replay":
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
    """Wait for the serve loop's own stream (not the pipeline's device
    stage, which runs on a stream of its own)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _evict_dead_namespaces(tier, engine, pipe, summary) -> None:
    """Evict namespaces whose source-death quarantine expired (fan-in
    tier, ingest/fanin.py). A pipelined render in flight is waited for
    first (bounded, as idle eviction does): a released slot's metadata
    must outlive its render. The JAX serve only defers to a later tick
    while a render is in flight, which never evicts when every host tick
    is shorter than a render; waiting only on ticks with an eviction due
    lands it in the same tick whatever the host load. A render still in
    flight after the wait defers the eviction to the next tick (the tier
    keeps the sid pending until it is taken)."""
    if pipe is not None and not pipe.idle():
        if not tier.evictions_due():
            return
        pipe.drain(timeout=10.0)
        if not pipe.idle():
            return
    for sid in tier.take_evictions():
        t0 = time.perf_counter()
        # a namespace clear on either spine: the Python index walks its
        # slot_source map, the C++ engine its per-slot namespace tags
        n = engine.evict_source(sid)
        _sync(engine.device)
        summary.source_evictions.append(
            (summary.ticks, sid, n, time.perf_counter() - t0))
        print(
            f"WARNING: telemetry source {sid} dead past quarantine — "
            f"evicted {n} flows from its namespace",
            file=sys.stderr,
        )


def _serve_loop(args, engine, model, predict, serve_params, inc=None,
                degrade=None) -> ServeSummary:
    from .ingest.fanin import RawTick
    from .serving.pipeline import ServePipeline, coalesce_renders

    summary = ServeSummary(engine=engine)
    # raw bytes wherever the native engine can take them: the pipe
    # source, and every fan-in kind (the tier's pumps render capture and
    # synthetic ticks to the wire themselves)
    fanin = _fanin_active(args)
    raw = engine.native and (args.source == "ryu" or fanin)
    tier = _fanin_tier(args, raw) if fanin else None
    dropped_seen = 0
    errors_seen = 0
    # Pipelined serving: this thread (the host stage) polls, parses,
    # scatters and DISPATCHES each render; one worker (the device stage)
    # waits for it and prints. The handoff is bounded; 'off' keeps the
    # serial chain.
    pipe = None
    host_busy = contextlib.nullcontext
    if args.pipeline != "off":
        pipe = ServePipeline(consume=lambda job: job(), depth=PIPELINE_DEPTH,
                             merge=coalesce_renders).start()
        host_busy = pipe.host_stage
    source = _tick_source(args, raw=raw, tier=tier)
    try:
        for batch in source:
            if pipe is not None:
                # a dead device stage must end the serve, not let the
                # host stage spin on
                pipe.raise_if_failed()
            t0 = time.perf_counter()
            with host_busy():
                engine.mark_tick()  # freshness floor for the render
                if isinstance(batch, bytes):
                    engine.ingest_bytes(batch)
                elif isinstance(batch, RawTick):
                    # native fan-in: one feed per (source, poll batch),
                    # under that source's namespace
                    for sid, data in batch:
                        engine.ingest_bytes(data, sid)
                else:
                    engine.ingest(batch)
                engine.step()
                _sync(engine.device)
                summary.ingest_seconds.append(time.perf_counter() - t0)
                summary.ticks += 1
                if tier is not None:
                    _evict_dead_namespaces(tier, engine, pipe, summary)
                if summary.ticks % args.print_every == 0:
                    if engine.dropped > dropped_seen:
                        print(
                            f"WARNING: flow table full — "
                            f"{engine.dropped - dropped_seen} new flows "
                            f"dropped since last report (capacity "
                            f"{args.capacity}, idle-timeout "
                            f"{args.idle_timeout}s)",
                            file=sys.stderr,
                        )
                        dropped_seen = engine.dropped
                    if engine.parse_errors() > errors_seen:
                        print(
                            f"WARNING: {engine.parse_errors() - errors_seen}"
                            f" malformed telemetry lines skipped since "
                            f"last report",
                            file=sys.stderr,
                        )
                        errors_seen = engine.parse_errors()
                    if pipe is not None:
                        plan = _dispatch_render(
                            args, engine, model, predict, serve_params,
                            pipe, inc=inc, degrade=degrade,
                        )
                    else:
                        if args.idle_timeout and engine.last_time:
                            engine.evict_idle(engine.last_time,
                                              args.idle_timeout)
                        plan = _print_table(engine, model, predict,
                                            serve_params, args, inc,
                                            degrade=degrade)
                    summary.render_ticks.append(summary.ticks)
                    if plan is not None:
                        summary.render_plans.append(plan)
                _sync(engine.device)
            summary.tick_seconds.append(time.perf_counter() - t0)
            if args.max_ticks and summary.ticks >= args.max_ticks:
                break
        if pipe is not None:
            # end of stream: staged renders print before the loop returns,
            # and a device-stage failure surfaces here
            pipe.shutdown(drain=True)
            pipe.raise_if_failed()
    finally:
        if pipe is not None:
            pipe.shutdown(drain=False)  # idempotent; error paths drop
        if tier is not None:
            # the sources as the serve left them, before closing the
            # stream stops every pump
            summary.roster = tier.roster()
        source.close()
    if pipe is not None:
        summary.pipeline = pipe.stats()
        summary.ticks_coalesced = summary.pipeline["ticks_coalesced"]
    return summary


def _dispatch_render(args, engine, model, predict, serve_params, pipe,
                     inc=None, degrade=None):
    """Host-stage half of one pipelined render tick: evict, dispatch the
    read side against THIS tick's table, and stage the device-stage job.
    It prints what the serial render of the same tick prints: ``n_flows``
    is taken at dispatch, the dispatched tensors are fixed against tick
    N's state, and eviction waits for renders in flight (a released
    slot's metadata must outlive its render). Returns the incremental
    label plan, ``(kind, dirty rows)`` (None under ``--incremental
    off``)."""
    from .serving.pipeline import RenderJob, dispatch_read

    idle = args.idle_timeout or None
    if idle is not None and engine.last_time:
        # Whether to evict is decided from data time alone, so the stale
        # set is the same in every run; only when the worker is busy is
        # wall-clock. Draining only on ticks that evict keeps the output
        # deterministic under host load.
        stale = engine.stale_slots(engine.last_time, idle)
        if stale.size:
            if not pipe.idle():
                pipe.drain(timeout=10.0)
            if pipe.idle():
                engine.evict_slots(stale)
    read = dispatch_read(engine, predict, serve_params, args.table_rows,
                         inc=inc)

    def render(read):
        rows = read.rows()
        # the stale verdict postdates the predict attempt: a ladder trip
        # during rows() marks this tick's render
        stale = degrade is not None and degrade.render_stale
        if args.table_rows > 0:
            _print_ranked(engine, model, rows, read.n_flows, stale=stale)
        else:
            _print_full(model, rows, stale=stale)

    pipe.submit(RenderJob(read, render))
    return None if inc is None else inc.last_plan


def _stale_fields(fields, rows, stale):
    """Append the ``Label State = STALE`` column when the degrade ladder
    serves last-known-good labels (the BROKEN rung): the column exists
    only while labels are stale, so a no-fault table is unchanged."""
    if not stale:
        return fields, rows
    return (tuple(fields) + ("Label State",),
            [tuple(r) + ("STALE",) for r in rows])


def _label_name(model, c: int) -> str:
    names = model.classes.names
    return names[c] if c < len(names) else "?"


def _print_ranked(engine, model, ranked, n_flows, stale=False) -> None:
    """Render activity-ranked ``(slot, label, fwd, rev)`` rows."""
    from .utils.table import CLASSIFIER_FIELDS, render_table, status_str

    sample = engine.slot_metadata(slots=[s for s, *_ in ranked])
    rows = [
        (slot, *sample[slot], _label_name(model, c), status_str(fa),
         status_str(ra))
        for slot, c, fa, ra in ranked
        if slot in sample
    ]
    fields, rows = _stale_fields(CLASSIFIER_FIELDS, rows, stale)
    print(render_table(fields, rows), flush=True)
    if n_flows > len(rows):
        print(f"... showing {len(rows)} of {n_flows} tracked flows",
              flush=True)


def _print_full(model, rows, stale=False) -> None:
    """Render the unbounded (``--table-rows 0``) table from
    ``(slot, src, dst, label, fwd, rev)`` rows."""
    from .utils.table import CLASSIFIER_FIELDS, render_table, status_str

    out = [
        (slot, src, dst, _label_name(model, c), status_str(f), status_str(r))
        for slot, src, dst, c, f, r in rows
    ]
    fields, out = _stale_fields(CLASSIFIER_FIELDS, out, stale)
    print(render_table(fields, out), flush=True)


def _print_table(engine, model, predict, serve_params, args, inc=None,
                 degrade=None):
    """The serial render: label the table and print the tick's table;
    returns the incremental label plan, ``(kind, dirty rows)`` (None under
    ``--incremental off``)."""
    plan = None
    if inc is not None:
        # only this tick's dirty rows are predicted; the rest come from
        # the label cache
        labels = inc.labels()
        plan = inc.last_plan
    else:
        labels = predict(serve_params, engine.features())
    # the stale verdict postdates the predict attempt
    stale = degrade is not None and degrade.render_stale
    n_flows = engine.num_flows()
    if args.table_rows > 0:
        # activity-ranked sample: O(table_rows) crosses to the host
        _print_ranked(engine, model,
                      engine.render_sample(labels, args.table_rows),
                      n_flows, stale=stale)
        return plan
    if isinstance(labels, torch.Tensor):
        labels = labels.cpu().numpy()
    fwd_active = engine.table.fwd.active[:-1].cpu().numpy()
    rev_active = engine.table.rev.active[:-1].cpu().numpy()
    rows = [
        (slot, src, dst, int(labels[slot]), bool(fwd_active[slot]),
         bool(rev_active[slot]))
        for slot, (src, dst) in sorted(engine.slot_metadata().items())
    ]
    _print_full(model, rows, stale=stale)
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
    # the serving pair; on a card this builds and loads the kernel, so a
    # kernel that does not build raises here, before the serve starts
    predict, serve_params = model.serving_path()
    engine = FlowStateEngine(
        args.capacity, device=device, native=_use_native(args),
        track_dirty=args.incremental != "off",
    )
    # The degradation ladder wraps the kernel predict, built BEFORE warmup
    # so warmup routes through it (its first device call, on its grace
    # deadline, happens there, and its host rung is primed).
    degrade = None
    if args.degrade != "off" and not getattr(predict, "host_native", False):
        from .models import resolve_fallback
        from .serving.degrade import DegradeLadder

        degrade = DegradeLadder(
            predict, resolve_fallback(model.name, model.params),
            deadline=args.device_deadline,
            probe_every=args.probe_every,
            probe_successes=args.probe_successes,
        )
        predict = degrade
    try:
        wstats = None
        if args.warmup:
            from .serving.warmup import warmup_serving

            wstats = warmup_serving(
                engine, predict, serve_params,
                table_rows=args.table_rows, idle_timeout=args.idle_timeout,
                incremental=args.incremental != "off",
            )
            print(
                f"warmup: warmed {len(wstats['warmed'])} serving steps in "
                f"{wstats['seconds']:.2f}s ({', '.join(wstats['warmed'])})",
                file=sys.stderr,
            )
        inc = None
        if args.incremental != "off":
            from .serving.incremental import IncrementalLabels

            inc = IncrementalLabels(engine, predict, serve_params,
                                    degrade=degrade)
        summary = _serve_loop(args, engine, model, predict, serve_params,
                              inc, degrade=degrade)
    finally:
        if degrade is not None:
            degrade.close()
    summary.warmup = wstats
    if degrade is not None:
        summary.degrade = degrade.status()
        summary.degrade_transitions = list(degrade.transitions)
    return summary


def main(argv=None) -> ServeSummary:
    args = _build_parser().parse_args(argv)
    return run_classify(args)


if __name__ == "__main__":
    main()

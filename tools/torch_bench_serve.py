#!/usr/bin/env python
"""Serving-loop scale bench of the PyTorch port: drive the FULL
ingest→device-table→predict→render→evict spine at 2²⁰ concurrent flows and
print one JSON line of per-stage timings. The twin of
``tools/bench_serve.py``: the same flags, modes, ``"metric"`` names and
JSON keys, measured on the port (on the card unless ``--device cpu``).

Stages per tick:
  ingest   — raw wire bytes → C++ engine (or Python fallback) routing
  step     — one scatter of the padded update batch into the device table
  predict  — batched predict over the whole (capacity, 12) feature matrix
  render   — sorted sample of --table-rows flows + footer (never O(N))
  evict    — device stale-mask + host release of idle slots

Modes, as the JAX tool's: the single measurement; ``--pipeline
{off,on,both}`` (serial chain against the pipelined serve loop of
``serving/pipeline.py``, one ``serve_pipeline_ab`` object for ``both``);
``--incremental {off,on,both}``; the dirty sweep (``--churn-sweep``); the
fan-in sweep (``--sources-sweep``); the region sweep (``--region-sweep``).
``--model gnb|forest|knn|forest-synth|knn-synth`` picks the predict:
``gnb`` serves ``models.module_predict``; the others resolve through
``LoadedModel.serving_path``, so on the card ``forest`` and ``knn`` launch
the port's forest and KNN kernels and honour ``TCSDN_FOREST_KERNEL`` /
``TCSDN_KNN_TOPK`` as the port's CLI does. ``--shards N`` places N shards
of the table on the one device through ``parallel/mesh.make_mesh``, as the
CLI's ``--shards`` does. ``--warmup`` runs ``serving/warmup.warmup_serving``.

Timed windows close where the JAX tool's ``block_until_ready`` closes
them, with ``torch.cuda.synchronize()``; the pipelined mode adds no sync
inside a stage (its read objects wait where they must). The port compiles
no program, so the compile counters read 0 and ``compile_telemetry`` says
why. The region sweep's un-sharded comparator is a fan-in sweep of this
tool, given by path (``--baseline-fanin``); with none the comparison is
null. Checkpoints come from ``$TCSDN_MODELS_DIR``, else the committed
``tests/data/reference_pickles/``.

Usage: torch_bench_serve.py [--capacity 1048576] [--ticks 5] [--no-native]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

from torch_bench_common import (
    COMPILE_TELEMETRY,
    add_device_arg,
    device_fields,
    models_dir,
    resolve_device,
    sync,
)


def _gnb_params(device):
    """The 6-class GNB of synthetic moments: the cheapest full-table
    predict."""
    import numpy as np

    from traffic_classifier_sdn_tpu_torch.models.gnb import GnbModel

    rng = np.random.RandomState(0)
    return GnbModel.from_numpy({
        "theta": rng.gamma(2.0, 100.0, (6, 12)),
        "var": rng.gamma(2.0, 50.0, (6, 12)) + 1.0,
        "class_prior": np.full(6, 1 / 6, dtype=np.float64),
    }, device=device)


def _served(args, m):
    raw_predict, params = m.serving_path()
    if getattr(raw_predict, "host_native", False) and args.shards >= 1:
        sys.exit("host-native kernels (TCSDN_FOREST_KERNEL=native, "
                 "TCSDN_KNN_TOPK=native) are single-device host serving; "
                 "use a device kernel with --shards")
    return raw_predict, params, raw_predict


def _build_model(args, device):
    """(predict, params, raw_fn) through the serving-path resolution."""
    import numpy as np

    from traffic_classifier_sdn_tpu_torch.models import (
        load_reference_model,
        make_loaded_model,
        module_predict,
    )
    from traffic_classifier_sdn_tpu_torch.models.base import ClassList

    classes = ClassList(tuple(f"class{i}" for i in range(6)))
    if args.model == "forest-synth":
        # a forest fit on synthetic class-shaped data at bench time
        from traffic_classifier_sdn_tpu_torch.train import forest as tforest

        rng = np.random.RandomState(1)
        n_cls = 6
        theta = rng.gamma(2.0, 100.0, (n_cls, 12))
        ytr = rng.randint(0, n_cls, 8192)
        Xtr = (rng.gamma(2.0, 1.0, (8192, 12)) * theta[ytr]).astype(np.float32)
        params = tforest.fit(Xtr, ytr, n_classes=n_cls,
                             n_trees=args.synth_trees, device=device)
        return _served(args, make_loaded_model("forest", params, classes))
    if args.model == "knn-synth":
        # a conversation-structured KNN corpus (cumulative snapshot rows
        # per flow), the geometry the serving tiers see
        from traffic_classifier_sdn_tpu_torch.train import knn as tknn

        rng = np.random.RandomState(1)
        n_cls = 6
        S = args.synth_corpus
        theta = rng.gamma(2.0, 100.0, (n_cls, 12))
        conv = -(-S // 8)  # ceil: rows cover S for ANY size
        ccls = rng.randint(0, n_cls, conv)
        base = rng.gamma(2.0, 1.0, (conv, 12)) * theta[ccls]
        rows, ys = [], []
        for i in range(conv):
            t = np.sort(rng.uniform(0.1, 1.0, 8))[:, None]
            rows.append(np.abs(
                base[i] * t * (1 + rng.normal(0, 0.02, (8, 12)))
            ))
            ys += [int(ccls[i])] * 8
        Xtr = np.concatenate(rows)[:S].astype(np.float32)
        ytr = np.asarray(ys[:S])
        params = tknn.fit(Xtr, ytr, n_neighbors=5, n_classes=n_cls,
                          device=device)
        return _served(args, make_loaded_model("knn", params, classes))
    if args.model in ("forest", "knn"):
        sub, ck = {
            "forest": ("Randomforest", "RandomForestClassifier"),
            "knn": ("knearest", "KNeighbors"),
        }[args.model]
        return _served(args, load_reference_model(
            sub, os.path.join(models_dir(), ck), device=device))
    return module_predict, _gnb_params(device), module_predict


def _make_engine(args, native, raw_fn, params, device, incremental=False):
    from traffic_classifier_sdn_tpu_torch.ingest.batcher import (
        FlowStateEngine,
    )

    if args.shards >= 1:
        from traffic_classifier_sdn_tpu_torch.parallel import (
            mesh as meshlib,
            table_sharded as tsh,
        )

        # N shards on the one device (the region sweep varies N per level)
        return tsh.ShardedFlowEngine(
            meshlib.make_mesh(n_data=args.shards, n_state=1,
                              devices=[device] * args.shards),
            args.capacity, predict_fn=raw_fn, params=params,
            table_rows=args.table_rows, native=native,
            incremental=incremental,
        )
    return FlowStateEngine(capacity=args.capacity, device=device,
                           native=native, track_dirty=incremental)


def _rows(eng, ranked):
    sample = eng.slot_metadata(slots=[s for s, *_ in ranked])
    return [(s, *sample[s], c) for s, c, *_ in ranked if s in sample]


def _run_serial(args, eng, predict, params, payloads, device, inc=None):
    """The serial chain — one tick fully synchronous, per-stage timed.
    ``inc`` (serving/incremental.IncrementalLabels) swaps the full-table
    predict for the dirty-set/label-cache path; the rendered rows per tick
    ride back in the result for A/B identity checks."""
    import numpy as np

    timings = {k: [] for k in ("ingest", "step", "predict", "render",
                               "evict", "tick")}
    rendered_rows = []
    n_parsed = 0
    t_wall0 = time.perf_counter()
    for ti, payload in enumerate(payloads):
        eng.mark_tick()
        t0 = time.perf_counter()
        n_parsed += eng.ingest_bytes(payload)
        t1 = time.perf_counter()
        eng.step()
        if args.shards >= 1:
            # the scatters are queued: without a wait their cost lands in
            # whichever later stage first fetches device data
            sync(device)
        t2 = time.perf_counter()
        if args.shards >= 1:
            # the sharded read side (per-shard predict + scored render
            # candidates + stale bits) is one step: "predict" carries it
            ranked, evicted = eng.tick_render(
                now=eng.last_time, idle_seconds=3600
            )
            t3 = time.perf_counter()
            rows = _rows(eng, ranked)
            footer = f"showing {len(rows)} of {eng.num_flows()}"
            t4 = t5 = time.perf_counter()
        else:
            # the render's fetch is the tick's first wait, so it also
            # absorbs the queued scatter + predict ("predict" is the
            # launch only); the incremental path's dirty-count fetch is a
            # real wait, so there "predict" carries the compaction
            if inc is not None:
                labels = inc.labels()
            else:
                labels = predict(params, eng.features())
            t3 = time.perf_counter()
            ranked = eng.render_sample(labels, args.table_rows)
            rows = _rows(eng, ranked)
            footer = f"showing {len(rows)} of {eng.num_flows()}"
            t4 = time.perf_counter()
            evicted = eng.evict_idle(now=eng.last_time, idle_seconds=3600)
            t5 = time.perf_counter()
        timings["ingest"].append(t1 - t0)
        timings["step"].append(t2 - t1)
        timings["predict"].append(t3 - t2)
        timings["render"].append(t4 - t3)
        timings["evict"].append(t5 - t4)
        timings["tick"].append(t5 - t0)
        rendered_rows.append(rows)
        print(f"# tick {ti}: {footer}, evicted {evicted}, "
              f"tick {(t5 - t0) * 1e3:.0f} ms", file=sys.stderr, flush=True)
        assert len(rows) <= args.table_rows
    wall = time.perf_counter() - t_wall0
    p50 = {k: float(np.median(v)) for k, v in timings.items()}
    return {"timings": timings, "p50": p50, "wall_s": wall,
            "n_parsed": n_parsed, "pipeline_stats": None,
            "rendered_rows": rendered_rows}


def _run_pipelined(args, eng, predict, params, payloads, device, inc=None):
    """The pipelined loop: the host stage ingests/scatters/dispatches; the
    device stage (worker) waits and builds the render rows — the shape the
    port's CLI serves with (serving/pipeline.py). No sync is added inside
    a stage: the read objects order the worker after the dispatch.

    As in the JAX tool, the single-device mode runs the serial mode's
    per-tick evict pass; the SHARDED pipelined mode does not process stale
    bits, so a sharded A/B slightly favours this mode."""
    import numpy as np

    from traffic_classifier_sdn_tpu_torch.serving.pipeline import (
        ServePipeline,
        dispatch_read,
    )

    rendered = []
    pipe = ServePipeline(lambda job: job(), depth=2).start()
    timings = {k: [] for k in ("ingest", "step", "dispatch", "tick")}
    n_parsed = 0
    t_wall0 = time.perf_counter()
    try:
        for ti, payload in enumerate(payloads):
            with pipe.host_stage():
                eng.mark_tick()
                t0 = time.perf_counter()
                n_parsed += eng.ingest_bytes(payload)
                t1 = time.perf_counter()
                eng.step()
                t2 = time.perf_counter()
                if args.shards >= 1:
                    read = eng.tick_read_dispatch(now=eng.last_time)
                    n_flows = eng.num_flows()

                    def job(read=read, n_flows=n_flows):
                        ranked = eng.tick_read_finish(read)
                        rendered.append((_rows(eng, ranked), n_flows))
                else:
                    # every tick, as the serial mode: the A/B pays equal
                    # per-tick work (the 3600 s horizon releases nothing,
                    # so no render's slot metadata is at stake)
                    eng.evict_idle(now=eng.last_time, idle_seconds=3600)
                    read = dispatch_read(eng, predict, params,
                                         args.table_rows, inc=inc)

                    def job(read=read):
                        rendered.append((_rows(eng, read.rows()),
                                         read.n_flows))
                pipe.submit(job)
                t3 = time.perf_counter()
            timings["ingest"].append(t1 - t0)
            timings["step"].append(t2 - t1)
            timings["dispatch"].append(t3 - t2)
            timings["tick"].append(t3 - t0)
            print(f"# tick {ti}: host {(t3 - t0) * 1e3:.0f} ms "
                  f"(queue {pipe._handoff.queued})",
                  file=sys.stderr, flush=True)
        pipe.shutdown(drain=True)
        pipe.raise_if_failed()
    finally:
        pipe.shutdown(drain=False)
    wall = time.perf_counter() - t_wall0
    for rows, _nf in rendered:
        assert len(rows) <= args.table_rows
    p50 = {k: float(np.median(v)) for k, v in timings.items()}
    return {"timings": timings, "p50": p50, "wall_s": wall,
            "n_parsed": n_parsed, "pipeline_stats": pipe.stats(),
            "ticks_rendered": len(rendered),
            "rendered_rows": [rows for rows, _nf in rendered]}


def _mode_summary(args, runs, n_flows_per_tick):
    """Aggregate one mode's repeats: median-of-repeats throughput, pooled
    stage medians, and first-tick latency from the FIRST repeat."""
    import numpy as np

    fps = [n_flows_per_tick * args.ticks / r["wall_s"] for r in runs]
    pooled = {}
    for r in runs:
        for k, v in r["timings"].items():
            pooled.setdefault(k, []).extend(v)
    t0 = runs[0]["timings"]["tick"]
    steady = t0[1:] or t0
    out = {
        "serve_flows_per_sec": round(float(np.median(fps)), 1),
        "serve_flows_per_sec_per_repeat": [round(f, 1) for f in fps],
        "records_per_sec": round(
            sum(r["n_parsed"] for r in runs)
            / sum(r["wall_s"] for r in runs), 1
        ),
        "wall_s": round(sum(r["wall_s"] for r in runs), 3),
        "first_tick_ms": round(t0[0] * 1e3, 1),
        "steady_tick_p50_ms": round(float(np.median(steady)) * 1e3, 2),
        "stage_p50_ms": {
            k: round(float(np.median(v)) * 1e3, 2) for k, v in pooled.items()
        },
    }
    stats = [r["pipeline_stats"] for r in runs if r["pipeline_stats"]]
    if stats:
        host = sum(s["host_busy_s"] for s in stats)
        dev = sum(s["device_busy_s"] for s in stats)
        ov = sum(s["overlap_s"] for s in stats)
        out.update({
            "host_busy_s": round(host, 3),
            "device_busy_s": round(dev, 3),
            "overlap_s": round(ov, 3),
            "overlap_ratio": round(ov / dev, 3) if dev else 0.0,
            "ticks_coalesced": sum(s["ticks_coalesced"] for s in stats),
        })
    return out


def _compile_fields(dev) -> dict:
    return {"jit_compiles": dev.status()["jit_compiles"],
            "compile_telemetry": COMPILE_TELEMETRY}


def _run_sweep(args, native, predict, params, raw_fn, n_flows: int,
               device, dev) -> None:
    """The dirty sweep: per churn level, A/B incremental against full
    re-predict over IDENTICAL payloads (median of interleaved repeats),
    render identity asserted, one ``serve_dirty_sweep`` JSON object.
    Engines are rebuilt per level and released before the next one."""
    from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows
    from traffic_classifier_sdn_tpu_torch.serving.incremental import (
        IncrementalLabels,
    )
    from traffic_classifier_sdn_tpu_torch.serving.warmup import (
        warmup_serving,
    )

    levels = [float(x) for x in args.churn_sweep.split(",")]
    out_levels = []
    warmed = False
    for lvl in levels:
        # a full-churn fill tick first (churn is meaningful only against a
        # populated table), then the measured payloads at the level
        syn = SyntheticFlows(n_flows=n_flows, seed=0, churn=1.0)
        fill = syn.tick_bytes()
        syn.churn = lvl
        chunks = [[syn.tick_bytes() for _ in range(args.ticks)]
                  for _ in range(args.repeat)]
        engines = {
            "full": _make_engine(args, native, raw_fn, params, device),
            "incremental": _make_engine(args, native, raw_fn, params,
                                        device, incremental=True),
        }
        incs: dict = {"full": None, "incremental": None}
        if args.shards < 1:
            incs["incremental"] = IncrementalLabels(
                engines["incremental"], predict, params)
        if args.warmup and not warmed:
            t0 = time.perf_counter()
            for name, eng in engines.items():
                warmup_serving(
                    eng, predict, params, table_rows=args.table_rows,
                    idle_timeout=3600 if args.shards < 1 else None,
                    incremental=name == "incremental",
                )
            print(f"# warmup in {time.perf_counter() - t0:.2f}s",
                  file=sys.stderr, flush=True)
            warmed = True
        for eng in engines.values():
            eng.mark_tick()
            eng.ingest_bytes(fill)
            eng.step()
        runs: dict = {name: [] for name in engines}
        for rep, chunk in enumerate(chunks):
            for name, eng in engines.items():
                print(f"# sweep churn={lvl} repeat {rep} mode {name}",
                      file=sys.stderr, flush=True)
                runs[name].append(_run_serial(args, eng, predict, params,
                                              chunk, device, inc=incs[name]))
        ident = all(
            rf == ri
            for runf, runi in zip(runs["full"], runs["incremental"])
            for rf, ri in zip(runf["rendered_rows"], runi["rendered_rows"])
        )
        res = {name: _mode_summary(args, runs[name], n_flows)
               for name in runs}
        f = res["full"]["stage_p50_ms"]["tick"]
        i = res["incremental"]["stage_p50_ms"]["tick"]
        out_levels.append({
            "churn": lvl,
            "full": res["full"],
            "incremental": res["incremental"],
            "tick_p50_speedup": round(f / i, 3) if i else None,
            "render_identical": ident,
        })
        del engines, incs, runs  # free two tables before the next level

    out = {
        "metric": "serve_dirty_sweep",
        "capacity": args.capacity,
        "tracked_flows": n_flows,
        "ticks": args.ticks,
        "repeat": args.repeat,
        "table_rows_rendered": args.table_rows,
        "predict_model": args.model,
        "native_ingest": native,
        **({"shards": args.shards} if args.shards >= 1 else {}),
        **device_fields(device),
        "warmup": args.warmup,
        **_compile_fields(dev),
        "levels": out_levels,
    }
    print(json.dumps(out), flush=True)


def _run_fanin_sweep(args, native, predict, params, n_flows: int,
                     device, dev) -> None:
    """The fan-in source sweep: for each source count N, drive the real
    fan-in tier (ingest/fanin.py — per-source pump threads, the bounded
    MPSC queue, per-source supervision) with the aggregate flow population
    split into N synthetic sources at the ``--source-interval`` cadence,
    and measure whether the serve chain holds the 1 s tick budget. A level
    holds when processing p50 <= 1 s and no source dropped records; the
    knee is the largest holding level."""
    import numpy as np

    from traffic_classifier_sdn_tpu_torch.ingest import fanin
    from traffic_classifier_sdn_tpu_torch.ingest.batcher import (
        FlowStateEngine,
    )
    from traffic_classifier_sdn_tpu_torch.serving.warmup import (
        warmup_serving,
    )

    levels = [int(x) for x in args.sources_sweep.split(",")]
    out_levels = []
    warmed = False
    for n_sources in levels:
        per = max(1, n_flows // n_sources)
        specs = [
            fanin.SourceSpec(
                kind="synthetic", sid=sid, n_flows=per, seed=sid,
                mac_base=sid * per, max_ticks=args.ticks,
                interval=args.source_interval,
            )
            for sid in range(n_sources)
        ]
        # queue bound sized to the aggregate record rate (records)
        tier = fanin.FanInIngest(
            specs, quarantine_s=5.0, raw=native,
            queue_records=max(1 << 16, 4 * 2 * n_flows),
        )
        eng = FlowStateEngine(capacity=args.capacity, device=device,
                              native=native)
        if args.warmup and not warmed:
            t0 = time.perf_counter()
            warmup_serving(eng, predict, params, table_rows=args.table_rows,
                           idle_timeout=3600)
            print(f"# warmup in {time.perf_counter() - t0:.2f}s",
                  file=sys.stderr, flush=True)
            warmed = True
        timings = {k: [] for k in ("drain", "ingest", "step", "predict",
                                   "render", "evict", "tick")}
        n_records = 0
        roster = []
        gen = tier.ticks(tick_timeout=max(10.0, 4 * args.source_interval))
        t_wall0 = time.perf_counter()
        try:
            for _ti in range(args.ticks * 2):  # coalesce-split headroom
                t_w = time.perf_counter()
                batch = next(gen, None)
                if batch is None:
                    break
                t0 = time.perf_counter()
                eng.mark_tick()
                if isinstance(batch, fanin.RawTick):
                    n_records += sum(eng.ingest_bytes(data, sid)
                                     for sid, data in batch)
                else:
                    n_records += eng.ingest(batch)
                t1 = time.perf_counter()
                eng.step()
                t2 = time.perf_counter()
                for sid in tier.take_evictions():
                    eng.evict_source(sid)
                labels = predict(params, eng.features())
                sync(device)
                t3 = time.perf_counter()
                rows = _rows(eng, eng.render_sample(labels, args.table_rows))
                t4 = time.perf_counter()
                eng.evict_idle(now=eng.last_time, idle_seconds=3600)
                t5 = time.perf_counter()
                assert len(rows) <= args.table_rows
                timings["drain"].append(t0 - t_w)
                timings["ingest"].append(t1 - t0)
                timings["step"].append(t2 - t1)
                timings["predict"].append(t3 - t2)
                timings["render"].append(t4 - t3)
                timings["evict"].append(t5 - t4)
                timings["tick"].append(t5 - t0)
                # the last MID-SERVE state, not the post-stream teardown
                roster = tier.roster()
        finally:
            gen.close()
        wall = time.perf_counter() - t_wall0
        # steady state: the first serve tick carries thread spin-up
        steady = timings["tick"][1:] or timings["tick"]
        p50 = float(np.median(steady))
        total_drops = sum(r["drops"] for r in roster)
        lags = [r["lag_s"] for r in roster if r["lag_s"] is not None]
        holds = p50 <= 1.0 and total_drops == 0
        level = {
            "sources": n_sources,
            "flows_per_source": per,
            "records_ingested": n_records,
            "serve_ticks": len(timings["tick"]),
            "wall_s": round(wall, 3),
            "tick_processing_p50_ms": round(p50 * 1e3, 2),
            "tick_processing_p95_ms": round(
                float(np.percentile(steady, 95)) * 1e3, 2),
            "stage_p50_ms": {
                k: round(float(np.median(v)) * 1e3, 2)
                for k, v in timings.items() if v
            },
            "tracked_flows": eng.num_flows(),
            "total_drops": total_drops,
            "max_lag_s": round(max(lags), 3) if lags else None,
            "holds_1s_cadence": holds,
            "per_source": [
                {k: r[k] for k in ("id", "state", "records", "drops",
                                   "lag_s")}
                for r in roster
            ],
        }
        out_levels.append(level)
        print(f"# sources={n_sources} tick_p50="
              f"{level['tick_processing_p50_ms']} ms drops={total_drops} "
              f"holds={holds}", file=sys.stderr, flush=True)
        del tier, eng
    holding = [lv["sources"] for lv in out_levels if lv["holds_1s_cadence"]]
    knee = max(holding) if holding else 0
    out = {
        "metric": "serve_fanin_sources",
        "capacity": args.capacity,
        "aggregate_flows_per_tick": n_flows,
        "ticks_per_source": args.ticks,
        "source_interval_s": args.source_interval,
        "table_rows_rendered": args.table_rows,
        "predict_model": args.model,
        "native_ingest": native,
        **device_fields(device),
        "warmup": args.warmup,
        "max_sources_holding_1s_p50": knee,
        "knee_is_sweep_ceiling": bool(
            out_levels and holding and knee == out_levels[-1]["sources"]
        ),
        **_compile_fields(dev),
        "levels": out_levels,
    }
    print(json.dumps(out), flush=True)


@contextlib.contextmanager
def _shards_on(device, n: int):
    """The port CLI's ``--shards n`` placed on the one ``device`` (n
    copies of it in ``parallel/mesh.visible_devices``), for this process
    only."""
    from traffic_classifier_sdn_tpu_torch.parallel import mesh as meshlib

    orig = meshlib.visible_devices
    meshlib.visible_devices = lambda device_=None: [device] * n
    try:
        yield
    finally:
        meshlib.visible_devices = orig


def _region_identity(max_shards: int, device) -> dict:
    """Deterministic byte-identity: the composed region serve (fan-in ×
    sharded × incremental × native ingest) against EACH single-spine path,
    end to end through the port's CLI on lockstep synthetic traffic."""
    import io
    import tempfile

    import numpy as np

    from traffic_classifier_sdn_tpu_torch import cli as _cli
    from traffic_classifier_sdn_tpu_torch.io import checkpoint as ck
    from traffic_classifier_sdn_tpu_torch.models.gnb import GnbModel

    rng = np.random.RandomState(0)
    with tempfile.TemporaryDirectory() as td:
        ckpt = os.path.join(td, "gnb")
        ck.save_model(
            ckpt, "gnb",
            GnbModel.from_numpy({
                "theta": rng.gamma(2.0, 100.0, (2, 12)),
                "var": rng.gamma(2.0, 50.0, (2, 12)) + 1.0,
                "class_prior": np.full(2, 0.5, dtype=np.float64),
            }, device="cpu"),
            classes=("ping", "voice"),
        )
        base = [
            "gaussiannb", "--native-checkpoint", ckpt,
            "--source", "synthetic", "--synthetic-flows", "16",
            "--sources", "2", "--source-lockstep",
            "--capacity", "64", "--print-every", "2",
            "--max-ticks", "6", "--idle-timeout", "0",
            "--table-rows", "8", "--device", device.type,
        ]

        def run(extra):
            out = io.StringIO()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(io.StringIO()), \
                    _shards_on(device, max_shards):
                _cli.main(base + extra)
            return out.getvalue()

        s = str(max_shards)
        composed = run(["--shards", s, "--incremental", "auto",
                        "--native-ingest", "auto"])
        spines = {
            "unsharded_fanin": ["--incremental", "auto",
                                "--native-ingest", "auto"],
            "sharded_full_predict": ["--shards", s, "--incremental",
                                     "off", "--native-ingest", "auto"],
            "sharded_python_ingest": ["--shards", s, "--incremental",
                                      "auto", "--native-ingest", "off"],
            "pipelined_composed": ["--shards", s, "--incremental",
                                   "auto", "--native-ingest", "auto",
                                   "--pipeline", "on"],
        }
        verdicts = {name: run(extra) == composed
                    for name, extra in spines.items()}
    return verdicts


# region-sweep warm ticks per level: tick 0 (pump spin-up, first flush)
# and tick 1 (the steady-churn dirty bucket) are excluded from the timing
_WARM_TICKS = 2


def _run_region_sweep(args, native, predict, params, raw_fn,
                      n_flows: int, device, dev) -> None:
    """The region sweep: drive the COMPOSED spine — the real fan-in tier
    feeding the sharded table with per-shard dirty masks/label caches and
    native ingest — across (sources × shards × churn), and measure the
    aggregate churn it holds under the 1 s serve cadence. shards=0 levels
    run the single-device fan-in path (the un-sharded comparator). The
    comparators: the knee of a fan-in sweep of this tool
    (``--baseline-fanin``, null without one) and this sweep's own
    single-source sharded level. Byte-identity against every single-spine
    path rides in the same object (``render_identical``)."""
    import numpy as np

    from traffic_classifier_sdn_tpu_torch.ingest import fanin
    from traffic_classifier_sdn_tpu_torch.serving.warmup import (
        warmup_serving,
    )

    src_levels = [int(x) for x in args.region_sources.split(",")]
    shard_levels = [int(x) for x in args.region_shards.split(",")]
    churn_levels = [float(x) for x in args.region_churn.split(",")]
    max_shards = max([s for s in shard_levels if s >= 1], default=0)
    if max_shards < 1:
        sys.exit("--region-sweep needs at least one sharded level")

    identity = _region_identity(max_shards, device)

    out_levels = []
    compiles_in_measured = 0  # eager torch: nothing compiles
    for shards in shard_levels:
        for churn in churn_levels:
            for n_sources in src_levels:
                per = max(1, n_flows // n_sources)
                specs = [
                    fanin.SourceSpec(
                        kind="synthetic", sid=sid, n_flows=per,
                        seed=sid, mac_base=sid * per, churn=churn,
                        max_ticks=args.ticks,
                        interval=args.source_interval,
                    )
                    for sid in range(n_sources)
                ]
                tier = fanin.FanInIngest(
                    specs, quarantine_s=5.0, raw=native,
                    queue_records=max(1 << 16, 4 * 2 * n_flows),
                )
                args.shards = shards
                eng = _make_engine(args, native, raw_fn, params, device,
                                   incremental=shards >= 1)
                warmup_serving(
                    eng, predict, params, table_rows=args.table_rows,
                    idle_timeout=None if shards >= 1 else 3600,
                    incremental=shards >= 1,
                )
                timings = {k: [] for k in ("drain", "tick")}
                n_records = 0
                roster = []
                gen = tier.ticks(
                    tick_timeout=max(10.0, 4 * args.source_interval))
                t_wall0 = time.perf_counter()
                try:
                    for _ti in range(args.ticks * 2):
                        t_w = time.perf_counter()
                        batch = next(gen, None)
                        if batch is None:
                            break
                        t0 = time.perf_counter()
                        eng.mark_tick()
                        if isinstance(batch, fanin.RawTick):
                            n_records += sum(eng.ingest_bytes(data, sid)
                                             for sid, data in batch)
                        else:
                            n_records += eng.ingest(batch)
                        eng.step()
                        for sid in tier.take_evictions():
                            eng.evict_source(sid)
                        if shards >= 1:
                            ranked, _ev = eng.tick_render(
                                now=eng.last_time, idle_seconds=3600)
                        else:
                            labels = predict(params, eng.features())
                            sync(device)
                            ranked = eng.render_sample(labels,
                                                       args.table_rows)
                        rows = _rows(eng, ranked)
                        if shards < 1:
                            eng.evict_idle(now=eng.last_time,
                                           idle_seconds=3600)
                        t1 = time.perf_counter()
                        assert len(rows) <= args.table_rows
                        timings["drain"].append(t0 - t_w)
                        timings["tick"].append(t1 - t0)
                        roster = tier.roster()
                finally:
                    gen.close()
                wall = time.perf_counter() - t_wall0
                steady = timings["tick"][_WARM_TICKS:] or timings["tick"]
                p50 = float(np.median(steady))
                total_drops = sum(r["drops"] for r in roster)
                holds = p50 <= 1.0 and total_drops == 0
                serve_ticks = len(timings["tick"])
                level = {
                    "sources": n_sources,
                    "shards": shards,
                    "churn_fraction": churn,
                    "flows_per_source": per,
                    "incremental": shards >= 1,
                    "records_ingested": n_records,
                    "serve_ticks": serve_ticks,
                    "wall_s": round(wall, 3),
                    "aggregate_records_per_tick": (
                        round(n_records / serve_ticks) if serve_ticks else 0
                    ),
                    "records_per_sec": (
                        round(n_records / wall) if wall else 0
                    ),
                    "tick_processing_p50_ms": round(p50 * 1e3, 2),
                    "tick_processing_p95_ms": round(
                        float(np.percentile(steady, 95)) * 1e3, 2),
                    "tracked_flows": eng.num_flows(),
                    "total_drops": total_drops,
                    "holds_1s_cadence": holds,
                }
                out_levels.append(level)
                print(f"# sources={n_sources} shards={shards} "
                      f"churn={churn} tick_p50="
                      f"{level['tick_processing_p50_ms']} ms "
                      f"drops={total_drops} holds={holds}",
                      file=sys.stderr, flush=True)
                del tier, eng

    # comparator 1: the knee of a fan-in sweep of this tool
    knee_rate = None
    if args.baseline_fanin:
        try:
            with open(args.baseline_fanin) as f:
                knee_doc = json.load(f)
            knee_n = knee_doc["max_sources_holding_1s_p50"]
            knee_lv = next(lv for lv in knee_doc["levels"]
                           if lv["sources"] == knee_n)
            knee_rate = round(knee_lv["records_ingested"]
                              / knee_lv["wall_s"])
        except (OSError, KeyError, StopIteration, ValueError) as e:
            print(f"# no un-sharded knee baseline ({e})",
                  file=sys.stderr, flush=True)
    else:
        print("# no un-sharded knee baseline (--baseline-fanin not given)",
              file=sys.stderr, flush=True)

    # comparator 2: this sweep's own single-source sharded level
    single_sharded = [
        lv for lv in out_levels
        if lv["sources"] == 1 and lv["shards"] >= 1
        and lv["churn_fraction"] == max(churn_levels)
    ]
    single_rate = (max(lv["records_per_sec"] for lv in single_sharded)
                   if single_sharded else None)
    composed = [
        lv for lv in out_levels
        if lv["shards"] >= 1 and lv["sources"] > 1
        and lv["holds_1s_cadence"]
    ]
    best_rate = (max(lv["records_per_sec"] for lv in composed)
                 if composed else 0)
    max_churn = (max(lv["aggregate_records_per_tick"] for lv in composed)
                 if composed else 0)

    out = {
        "metric": "serve_region",
        "capacity": args.capacity,
        "aggregate_flows_per_tick": n_flows,
        "ticks_per_source": args.ticks,
        "source_interval_s": args.source_interval,
        "table_rows_rendered": args.table_rows,
        "predict_model": args.model,
        "native_ingest": native,
        **device_fields(device),
        "max_aggregate_records_per_tick_holding_1s": max_churn,
        "best_composed_records_per_sec": best_rate,
        "unsharded_fanin_knee_records_per_sec": knee_rate,
        "exceeds_unsharded_fanin_knee": (
            best_rate > knee_rate if knee_rate is not None else None
        ),
        "single_source_sharded_records_per_sec": single_rate,
        "exceeds_single_source_sharded": (
            best_rate > single_rate if single_rate is not None else None
        ),
        "render_identical": all(identity.values()),
        "identity_paths": identity,
        "compiles_in_measured_region": compiles_in_measured,
        **_compile_fields(dev),
        "levels": out_levels,
    }
    print(json.dumps(out), flush=True)


def _link_mb_s(device) -> float:
    """Host→card rate of a 4 MiB pageable copy, median of 3."""
    import numpy as np
    import torch

    probe_mb = (4 << 20) / 1e6
    blob = torch.from_numpy(np.ones(4 << 20, np.uint8))
    blob.to(device)
    sync(device)
    bw = []
    for _ in range(3):
        t0 = time.perf_counter()
        blob.to(device)
        sync(device)
        bw.append(probe_mb / (time.perf_counter() - t0))
    return float(np.median(bw))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--capacity", type=int, default=1 << 20)
    ap.add_argument(
        "--churn-fraction", type=float, default=1.0,
        help="fraction of the synthetic flow population emitting "
        "telemetry each tick (default 1.0 — every flow every tick)",
    )
    ap.add_argument(
        "--sources-sweep", default=None, metavar="N0,N1,...",
        help="run the fan-in source sweep instead of a single "
        "measurement — one serve_fanin_sources JSON object "
        "(e.g. 1,2,4,8,16,32)",
    )
    ap.add_argument(
        "--source-interval", type=float, default=1.0, metavar="SECS",
        help="fan-in sweep emission cadence per source (default 1.0, "
        "the reference monitor's poll rate)",
    )
    ap.add_argument(
        "--region-sweep", action="store_true",
        help="run the REGION sweep: the composed spine (fan-in × sharded "
        "× incremental × native ingest) across (--region-sources × "
        "--region-shards × --region-churn), plus a lockstep "
        "byte-identity check against every single-spine path through "
        "the port's CLI — one serve_region JSON object",
    )
    ap.add_argument("--region-sources", default="1,96,384",
                    metavar="N0,N1,...",
                    help="region sweep source-count axis (default 1,96,384)")
    ap.add_argument("--region-shards", default="0,8", metavar="S0,S1,...",
                    help="region sweep shard axis (default 0,8; shards are "
                    "placed on the one device)")
    ap.add_argument("--region-churn", default="1.0,0.25",
                    metavar="C0,C1,...",
                    help="region sweep churn axis (default 1.0,0.25)")
    ap.add_argument(
        "--baseline-fanin", default=None, metavar="PATH",
        help="a fan-in sweep of THIS tool (--sources-sweep output) whose "
        "knee the region sweep must beat; no default: a knee taken by "
        "another implementation or on another device judges nothing",
    )
    ap.add_argument(
        "--churn-sweep", default=None, metavar="L0,L1,...",
        help="run the dirty sweep instead of a single measurement — one "
        "serve_dirty_sweep JSON object (e.g. 0,0.01,0.1,1.0)",
    )
    ap.add_argument(
        "--incremental", choices=("off", "on", "both"), default="off",
        help="label source: off = full-table re-predict every render, on "
        "= dirty-set prediction with the device-resident label cache, "
        "both = A/B over identical payloads (serve_incremental_ab)",
    )
    ap.add_argument("--synth-trees", type=int, default=100,
                    help="tree count for --model forest-synth (default 100)")
    ap.add_argument(
        "--flows-per-tick", type=int, default=0,
        help="synthetic conversations per tick (2 records each); 0 = "
        "capacity/2",
    )
    ap.add_argument("--ticks", type=int, default=5)
    ap.add_argument("--no-native", action="store_true")
    add_device_arg(ap)
    ap.add_argument("--table-rows", type=int, default=64)
    ap.add_argument(
        "--model",
        choices=("gnb", "forest", "knn", "forest-synth", "knn-synth"),
        default="gnb",
        help="predict stage: gnb (cheapest full-table predict), forest "
        "or knn (the reference checkpoints through the serving path: the "
        "forest and KNN kernels on the card), forest-synth / knn-synth "
        "(fit at bench time on flow-shaped synthetic data)",
    )
    ap.add_argument("--synth-corpus", type=int, default=4448,
                    help="corpus rows for --model knn-synth (default 4448)")
    ap.add_argument(
        "--shards", type=int, default=0,
        help="shard the flow table N ways on the one device "
        "(parallel/table_sharded.py)",
    )
    ap.add_argument(
        "--pipeline", choices=("off", "on", "both"), default="off",
        help="serve-loop mode: off = serial chain, on = pipelined "
        "(serving/pipeline.py), both = A/B (serve_pipeline_ab)",
    )
    ap.add_argument("--repeat", type=int, default=1,
                    help="repeat the measurement N times (modes "
                    "interleaved per repeat) and report the median")
    ap.add_argument("--warmup", action="store_true",
                    help="pay the serve's first-use costs before timing "
                    "(serving/warmup.py)")
    args = ap.parse_args()
    device = resolve_device(args.device)

    from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows
    from traffic_classifier_sdn_tpu_torch.native import engine as native_engine
    from traffic_classifier_sdn_tpu_torch.obs.device import DeviceTelemetry
    from traffic_classifier_sdn_tpu_torch.serving.incremental import (
        IncrementalLabels,
    )
    from traffic_classifier_sdn_tpu_torch.serving.warmup import (
        warmup_serving,
    )

    native = (not args.no_native) and native_engine.available()
    cap = args.capacity
    # two directions share one slot; the default fills half the table
    n_flows = args.flows_per_tick or cap // 2
    if n_flows > cap:
        sys.exit("--flows-per-tick exceeds --capacity (every "
                 "conversation needs a slot)")
    if args.pipeline == "both" and args.incremental == "both":
        sys.exit("--pipeline both and --incremental both cannot "
                 "combine — A/B one axis at a time")

    print(f"# device: {device_fields(device)}", file=sys.stderr, flush=True)
    dev = DeviceTelemetry(device=device)
    dev.attach()

    predict, params, raw_fn = _build_model(args, device)

    if args.region_sweep:
        _run_region_sweep(args, native, predict, params, raw_fn, n_flows,
                          device, dev)
        return
    if args.sources_sweep is not None:
        _run_fanin_sweep(args, native, predict, params, n_flows, device, dev)
        return
    if args.churn_sweep is not None:
        _run_sweep(args, native, predict, params, raw_fn, n_flows, device,
                   dev)
        return

    syn = SyntheticFlows(n_flows=n_flows, seed=0, churn=args.churn_fraction)
    fill_payload = None
    if args.churn_fraction < 1.0:
        # populate the table before churn applies
        syn.churn = 1.0
        fill_payload = syn.tick_bytes()
        syn.churn = args.churn_fraction

    print(f"# generating {args.repeat} × {args.ticks} ticks × "
          f"~{int(2 * n_flows * args.churn_fraction)} records "
          f"(capacity {cap}, native={native}, "
          f"churn={args.churn_fraction})", file=sys.stderr, flush=True)
    payload_chunks = [[syn.tick_bytes() for _ in range(args.ticks)]
                      for _ in range(args.repeat)]
    total_records = sum(p.count(b"\n") for p in payload_chunks[0])

    # modes: (name, pipelined, incremental) — one A/B axis at a time
    inc_on = args.incremental == "on"
    if args.pipeline == "both":
        modes = [("serial", False, inc_on), ("pipelined", True, inc_on)]
    elif args.incremental == "both":
        pipelined = args.pipeline == "on"
        modes = [("full", pipelined, False),
                 ("incremental", pipelined, True)]
    else:
        pipelined = args.pipeline == "on"
        modes = [("pipelined" if pipelined else "serial", pipelined,
                  inc_on)]
    mode_names = [name for name, _, _ in modes]
    if len(modes) > 1 and not args.warmup:
        print("# NOTE: A/B without --warmup — the first mode pays every "
              "first-use cost the second mode then inherits; pass "
              "--warmup for a clean comparison", file=sys.stderr, flush=True)

    engines = {
        name: _make_engine(args, native, raw_fn, params, device,
                           incremental=inc_flag)
        for name, _, inc_flag in modes
    }
    incs: dict = {}
    for name, _, inc_flag in modes:
        incs[name] = (IncrementalLabels(engines[name], predict, params)
                      if inc_flag and args.shards < 1 else None)
    if args.warmup:
        t0 = time.perf_counter()
        # one warm per engine kind: a dirty-tracking engine scatters
        # through the fused apply+mark step, the plain one doesn't
        warmed_kinds = set()
        for name, _, inc_flag in modes:
            if inc_flag in warmed_kinds:
                continue
            warmed_kinds.add(inc_flag)
            stats = warmup_serving(
                engines[name], predict, params, table_rows=args.table_rows,
                idle_timeout=3600 if args.shards < 1 else None,
                incremental=inc_flag,
            )
        print(f"# warmup: {len(stats['warmed'])} steps in "
              f"{time.perf_counter() - t0:.2f}s", file=sys.stderr,
              flush=True)
    if fill_payload is not None:
        for eng in engines.values():
            eng.mark_tick()
            eng.ingest_bytes(fill_payload)
            eng.step()
    if args.warmup:
        dev.mark_warmup_complete()
    compiles_at_measure = dev.status()["jit_compiles"]
    runs: dict = {name: [] for name in mode_names}
    for rep, chunk in enumerate(payload_chunks):
        for name, pipelined, _inc_flag in modes:
            print(f"# repeat {rep} mode: {name}", file=sys.stderr,
                  flush=True)
            run = _run_pipelined if pipelined else _run_serial
            runs[name].append(run(args, engines[name], predict, params,
                                  chunk, device, inc=incs[name]))
    results = {name: _mode_summary(args, runs[name], n_flows)
               for name in mode_names}
    dev_status = dev.status()
    compiles_in_measured = dev_status["jit_compiles"] - compiles_at_measure

    eng = engines[mode_names[-1]]
    # per-tick host→device wire bytes actually moved for the update
    # batches, and the measured link rate off the CPU
    wire_mb = eng.wire_bytes / (args.ticks * args.repeat) / 1e6
    link_mb_s = _link_mb_s(device) if device.type != "cpu" else None

    common = {
        "capacity": cap,
        "tracked_flows": eng.num_flows(),
        "records_per_tick": total_records // args.ticks,
        "update_wire_mb_per_tick": round(wire_mb, 1),
        **({"host_to_device_mb_per_sec": round(link_mb_s, 1)}
           if link_mb_s is not None else {}),
        "native_ingest": native,
        **({"shards": args.shards} if args.shards >= 1 else {}),
        **device_fields(device),
        "predict_model": args.model,
        "table_rows_rendered": args.table_rows,
        "churn_fraction": args.churn_fraction,
        "incremental_mode": args.incremental,
        "warmup": args.warmup,
        "jit_compiles": dev_status["jit_compiles"],
        "retraces_after_warmup": dev_status["retraces_after_warmup"],
        "compiles_in_measured_region": compiles_in_measured,
        "compile_telemetry": COMPILE_TELEMETRY,
    }

    if args.pipeline == "both":
        s = results["serial"]["serve_flows_per_sec"]
        p = results["pipelined"]["serve_flows_per_sec"]
        out = {
            "metric": "serve_pipeline_ab",
            "serial": results["serial"],
            "pipelined": results["pipelined"],
            "speedup_flows_per_sec": round(p / s, 3) if s else None,
            **common,
        }
    elif args.incremental == "both":
        # identical payloads, identical render expected
        ident = all(
            rf == ri
            for runf, runi in zip(runs["full"], runs["incremental"])
            for rf, ri in zip(runf["rendered_rows"], runi["rendered_rows"])
        )
        f = results["full"]["stage_p50_ms"]["tick"]
        i = results["incremental"]["stage_p50_ms"]["tick"]
        out = {
            "metric": "serve_incremental_ab",
            "full": results["full"],
            "incremental": results["incremental"],
            "tick_p50_speedup": round(f / i, 3) if i else None,
            "render_identical": ident,
            **common,
        }
    else:
        mode = mode_names[0]
        r = results[mode]
        out = {
            "metric": "serve_tick_p50_ms_at_capacity",
            "value": r["stage_p50_ms"]["tick"],
            "unit": "ms",
            "mode": mode,
            **r,
            **common,
        }
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

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

The metrics and observability plane (the JAX CLI's): every serve writes
its counters, gauges and histograms into ``utils.metrics.global_metrics``
(per-tick spans ``poll``, ``tick``, ``parse``, ``scatter``, the render's
``compact``/``feature``/``predict``/``render`` or, pipelined,
``dispatch`` and ``stage.device``, and ``snapshot``, each into its
``stage_*_s`` histogram; record-level latency provenance, on by default,
into ``e2e_emit_to_render_s`` and ``wf_*``); ``--metrics-every N`` prints
the registry on stderr, ``--obs-port`` serves ``/metrics``, ``/healthz``
and ``/events`` (obs/exposition.py), and ``--obs-dir`` receives the
flight recorder's post-mortem on an unhandled exception, SIGTERM or, with
``--obs-dump-on-exit``, a clean exit (SIGUSR1 dumps it and a metrics
snapshot without exiting). A span ends where the port already waits for
the card: ``scatter`` on the serve stream's sync after the table update,
the device stage's ``predict`` on the rows' copy to the host, the serial
``predict`` under the ladder on the ladder's copy of the labels; a bare
kernel predict (``--degrade off``, serial) returns at its launch, and its
kernel time falls into ``render``. Crash-safe serving checkpoints
(io/serving_checkpoint.py, the JAX package's format):
``--serve-checkpoint-every N --serve-checkpoint-dir DIR`` rotates
snapshots between ticks under a wall-clock budget
(``--serve-checkpoint-budget``), ``--save-serve-state FILE`` saves on
exit, and ``--restore-serve-state FILE_OR_DIR`` resumes from one (a
directory rolls back past a corrupt newest member).

``--drift auto --drift-dir DIR`` runs the drift loop (serving/drift.py):
the predict, under the ladder, goes through a ``DriftGate``; after each
render (on the device-stage worker when pipelined) the controller
observes the rendered features and labels, and on sustained drift refits
the family in the background (train/, on the serve's device), probes the
candidate against the live labels and hot-swaps it, with a ladder of its
own; ``--openset auto`` wraps the whole composition in an ``OpenSetGate``
(serving/openset.py) that labels rows far from every known class
``unknown``. Both write their reference into each serving checkpoint's
``feature_reference/`` block and boot from a restored one.

The model family comes from the checkpoint and must match the subcommand.
The JAX package's serving menus pick the predict (models/__init__.py):
``--knn-topk`` (or ``TCSDN_KNN_TOPK``; the flag wins) = ``sort`` (default)
or ``pallas``: the KNN kernel; ``argmax``, ``hier[<group>]``,
``screened[<group>]``: exact torch tiers; ``native``: the C++ host search;
``ivf[<nprobe>]``: the approximate cluster-probed tier.
``TCSDN_SVC_KERNEL`` = ``chunked`` (default: the SVC kernel) or ``dot``.
``TCSDN_FOREST_KERNEL`` = ``gemm`` (default) or any other TPU layout name:
the forest kernel; ``native``: the C++ host walk. A host predict
(``native``, ``ivf`` with g++) serves without the degrade ladder.

Sources: ``ryu`` (the default: a monitor subprocess, ``--monitor-cmd``,
whose stdout is the telemetry pipe, restarted up to ``--monitor-restarts``
times when it dies), ``controller`` (the port's own OpenFlow 1.3
controller as that subprocess, ``python -m
traffic_classifier_sdn_tpu_torch.controller --port <--of-port>``;
switches connect to it), ``replay`` (recorded capture file),
``synthetic`` (generated flow population) and ``workload``
(class-conditional flows whose deltas are sampled from the reference
training CSVs under ``--data-dir``). ``--config FILE`` (config.py's JSON
schema) fills the flags left unset; a flag given wins.
``--sources N`` or ``--source-spec KIND:ARG``
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
import os
import signal
import sys
import threading
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
        "--config", default=None,
        help="JSON config file (config.py schema): fills the flags left "
        "unset; a flag given wins",
    )
    # None defaults are sentinels: a --config file fills them, then main()
    # applies the built-in defaults
    p.add_argument(
        "--native-checkpoint", default=None,
        help="model checkpoint directory in the port's format "
        "(io/checkpoint.py: manifest.json + one .npy per array in the "
        "arrays directory it names); required, here or as "
        "model.native_checkpoint in --config",
    )
    p.add_argument(
        "--data-dir",
        default=os.environ.get("TCSDN_DATA_DIR", "datasets"),
        help="training CSV directory of --source workload (default "
        "$TCSDN_DATA_DIR or ./datasets, the reference repo's own layout)",
    )
    p.add_argument(
        "--source",
        choices=("ryu", "controller", "replay", "synthetic", "workload"),
        default="ryu",
        help="telemetry source: 'ryu' spawns the reference's monitor "
        "command (or --monitor-cmd), 'controller' spawns the port's own "
        "OpenFlow 1.3 controller (controller/switch.py; switches connect "
        "to --of-port), 'replay' reads --capture, 'synthetic' generates "
        "flows, 'workload' generates class-conditional flows sampled from "
        "the training CSVs under --data-dir",
    )
    p.add_argument(
        "--of-port", type=int, default=6653,
        help="OpenFlow listen port for --source controller",
    )
    p.add_argument(
        "--monitor-cmd", default=None,
        help="override the spawned monitor command (--source ryu or "
        "controller; for controller it replaces the built-in controller "
        "and --of-port is ignored)",
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
    p.add_argument("--capacity", type=int, default=None,
                   help="flow-table rows (default 65536)")
    p.add_argument(
        "--idle-timeout", type=int, default=None,
        help="evict flows idle for N seconds (0 disables; default 60)",
    )
    p.add_argument(
        "--print-every", type=int, default=None,
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
        "--openset", choices=("auto", "off"), default="off",
        help="open-set rejection tier (serving/openset.py): wrap the "
        "serving predict in an OpenSetGate that calibrates per-class "
        "feature statistics from the live stream's first windows, then "
        "serves an explicit 'unknown' label for rows whose features sit "
        "further than the calibrated threshold from EVERY known class. "
        "Byte-transparent until calibration completes and on "
        "closed-world traffic (output identical to 'off'); composes with "
        "--drift (promotions re-base the gate on the retrain window; "
        "rejected rows never become training signal)",
    )
    p.add_argument(
        "--openset-margin", type=float, default=3.0, metavar="M",
        help="open-set threshold margin: the rejection threshold is M "
        "times the worst (max) calibration-window score, so traffic "
        "from the calibration distribution is not rejected by "
        "construction (default 3.0; larger = more conservative)",
    )
    p.add_argument(
        "--openset-calibration-rows", type=int, default=4096, metavar="N",
        help="active labeled rows the open-set gate accumulates before "
        "freezing its per-class statistics and arming (default 4096); "
        "the gate is byte-transparent until then",
    )
    p.add_argument(
        "--drift", choices=("auto", "off"), default="off",
        help="online drift loop (serving/drift.py): monitor the live "
        "feature stream against a training-time reference, retrain in "
        "the background on sustained divergence (train/, on the serve's "
        "device), and hot-promote the fresh checkpoint through a "
        "parity-gated probe — wrong-but-fresh never promotes, a bad "
        "promotion rolls back. With no drift the output is "
        "byte-identical to 'off'. Requires --drift-dir",
    )
    p.add_argument(
        "--drift-follow", action="store_true",
        help="fleet mode: adopt newer rotation members that PEER serves "
        "sharing this --drift-dir stage, as this serve's own candidates "
        "— each adoption still earns its own parity probes against this "
        "serve's live labels before installing, and a rejected adoption "
        "never discards the peer's member. Requires --drift auto",
    )
    p.add_argument(
        "--drift-dir", default=None, metavar="DIR",
        help="candidate checkpoint rotation for the drift loop: the boot "
        "model is seeded here (staged-commit save), retrained candidates "
        "land as model-<seq> members, and rollback resolves the newest "
        "member that still loads",
    )
    p.add_argument(
        "--drift-window", type=int, default=8, metavar="N",
        help="observations (render ticks) per drift window (default 8)",
    )
    p.add_argument(
        "--drift-threshold", type=float, default=4.0, metavar="Z",
        help="drift score a window must exceed to count as divergent: "
        "max over features of the EWMA z-shift vs the reference "
        "(default 4.0)",
    )
    p.add_argument(
        "--drift-trips", type=int, default=3, metavar="K",
        help="consecutive over-threshold windows before the retrain "
        "trips (default 3; one noisy window never retrains)",
    )
    p.add_argument(
        "--drift-class-tolerance", type=float, default=0.2, metavar="FRAC",
        help="class-mix sensitivity: a window's max per-class frequency "
        "delta vs the reference is divided by this before comparing to "
        "--drift-threshold (default 0.2, so a full label-mix inversion "
        "scores 5.0 — above the default threshold; values >= "
        "1/threshold make class-mix drift undetectable)",
    )
    p.add_argument(
        "--drift-probe-successes", type=int, default=3, metavar="N",
        help="consecutive clean parity probes a candidate checkpoint "
        "needs before hot promotion (default 3)",
    )
    p.add_argument(
        "--drift-parity", type=float, default=1.0, metavar="FRAC",
        help="minimum probe agreement between the candidate's labels and "
        "the live model's on the shadow batch for a probe to count as "
        "clean (default 1.0 — exact parity; loosen for families whose "
        "refit legitimately disagrees near decision boundaries). kmeans "
        "compares mode-matched (cluster ids are a permutation), so the "
        "default applies there too",
    )
    p.add_argument(
        "--retrain-deadline", type=float, default=300.0, metavar="SECS",
        help="abandon a background retrain that outlives this many "
        "seconds (default 300; the serve keeps the old model and the "
        "loop resumes watching)",
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
        "--knn-topk", default=None, metavar="IMPL",
        help="KNN serving top-k (models/__init__.py resolve_knn_topk): "
        "sort (default) or pallas (the CUDA kernel), argmax, "
        "hier[<group>], screened[<group>] (exact torch tiers), native "
        "(the exact-f64 C++ host search) or ivf[<nprobe>] (the "
        "APPROXIMATE cluster-probed tier, ops/knn_ivf.py, an explicit "
        "opt-in). The flag wins over TCSDN_KNN_TOPK; an unknown value is "
        "a usage error",
    )
    p.add_argument(
        "--compilation-cache-dir", default=None, metavar="DIR",
        help="accepted for the JAX CLI's sake and ignored: the port "
        "compiles no XLA program, and its kernel libraries already "
        "persist under csrc/build/ by source hash",
    )
    p.add_argument(
        "--save-serve-state", default=None, metavar="FILE",
        help="on exit, checkpoint the live serving state (flow table + "
        "index) for a warm restart (io/serving_checkpoint.py; the JAX "
        "package's format, which restores there too)",
    )
    p.add_argument(
        "--restore-serve-state", default=None, metavar="FILE_OR_DIR",
        help="start from a serving-state checkpoint (written by the port "
        "or by the JAX package): every tracked flow resumes with its "
        "counters, rates, and slot intact. A directory resolves to its "
        "newest checkpoint that passes validation (torn/corrupt newest "
        "files roll back to the previous one)",
    )
    p.add_argument(
        "--serve-checkpoint-every", type=int, default=0, metavar="N",
        help="snapshot the live serving state between ticks every N poll "
        "ticks (0 disables) into --serve-checkpoint-dir",
    )
    p.add_argument(
        "--serve-checkpoint-dir", default=None, metavar="DIR",
        help="rotation directory for periodic serving snapshots "
        "(ckpt-<tick>.npz, atomic writes, keep-N); restart with "
        "--restore-serve-state DIR to resume from the newest valid one",
    )
    p.add_argument(
        "--serve-checkpoint-keep", type=int, default=3,
        help="keep the newest N periodic snapshots (default 3)",
    )
    p.add_argument(
        "--serve-checkpoint-budget", type=float, default=0.2,
        metavar="FRAC",
        help="wall-clock budget guard: skip a due snapshot when "
        "checkpointing has already consumed more than FRAC of the serve "
        "loop's elapsed time (default 0.2; 0 disables the guard; skips "
        "are counted in the checkpoint_skipped metric)",
    )
    p.add_argument(
        "--metrics-every", type=int, default=0,
        help="print an ingest/predict metrics line to stderr every N "
        "poll ticks (0 disables)",
    )
    p.add_argument(
        "--obs-port", type=int, default=None, metavar="PORT",
        help="serve the observability plane on this port (omit to "
        "disable; 0 binds an ephemeral port, reported in the startup "
        "line, the obs_port gauge and /healthz): /metrics (Prometheus "
        "text with per-stage stage_* latency series), /healthz "
        "(collector alive, last-tick age, checkpoint freshness, ladder, "
        "label cache, latency budget), /events (flight-recorder tail)",
    )
    p.add_argument(
        "--obs-dir", default=None, metavar="DIR",
        help="flight-recorder post-mortem directory: on an unhandled "
        "serve-loop exception, supervisor terminal failure, or SIGTERM "
        "the recent-event ring is dumped there as JSONL "
        "(obs/flight_recorder.py); SIGUSR1 dumps it and a metrics "
        "snapshot without exiting",
    )
    p.add_argument(
        "--obs-dump-on-exit", action="store_true",
        help="also dump the flight-recorder ring into --obs-dir on a "
        "clean exit",
    )
    p.add_argument(
        "--obs-host", default="127.0.0.1", metavar="ADDR",
        help="bind address for --obs-port (default 127.0.0.1; pass "
        "0.0.0.0 for a scrape target beyond this host)",
    )
    p.add_argument(
        "--obs-stale-after", type=float, default=30.0, metavar="SECS",
        help="/healthz reports unhealthy (503) once the last poll tick "
        "is older than this many seconds (default 30)",
    )
    p.add_argument(
        "--obs-checkpoint-stale-after", type=float, default=0.0,
        metavar="SECS",
        help="/healthz also reports unhealthy once the last committed "
        "serving snapshot (or, before the first one, the serve start) "
        "is older than this many seconds (0 disables)",
    )
    p.add_argument(
        "--latency-provenance", choices=("auto", "on", "off"),
        default="auto",
        help="record-level latency provenance (obs/latency.py): "
        "emit-stamp every telemetry batch host-side and fold per-hop "
        "boundaries (fan-in queue wait, parse, scatter, device "
        "completion, render visibility) into the e2e_emit_to_render_s / "
        "queue_wait_s / batch_wait_s / wf_* histograms and the /healthz "
        "latency block. Stamps never touch the wire or the rendered "
        "output. 'auto' (= on: the port has no sharded serve) or 'off'",
    )
    p.add_argument(
        "--latency-slo", type=float, default=0.0, metavar="SECS",
        help="end-to-end latency SLO: when the running "
        "e2e_emit_to_render_s p99 crosses this, the breach is recorded "
        "(latency.slo_breach) and the latency_slo_breached gauge flips "
        "(0 disables — the default)",
    )
    p.add_argument(
        "--device-obs", choices=("auto", "off"), default="auto",
        help="accepted for the JAX CLI's sake: device-runtime telemetry "
        "(memory gauges, the perf ring, /profile) is not ported yet, so "
        "nothing is armed; with an obs surface on, a note says so",
    )
    p.add_argument(
        "--perf-ring-ticks", type=int, default=64, metavar="N",
        help="accepted and unused (the perf ring is not ported yet)",
    )
    p.add_argument(
        "--perf-ring-keep", type=int, default=16, metavar="N",
        help="accepted and unused (the perf ring is not ported yet)",
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
    evicted. ``drift`` and ``openset`` are the drift controller's and the
    open-set gate's final ``status()`` (None when off). Every counter and
    timing of the metrics plane is in ``utils.metrics.global_metrics``
    after the run."""

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
    drift: dict | None = None
    openset: dict | None = None

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


def _resolved_monitor_cmd(args) -> str:
    """The monitor command a subprocess source spawns: --monitor-cmd, the
    port's own controller (--source controller), or the reference's Ryu
    line."""
    from .ingest.collector import DEFAULT_MONITOR_CMD

    if args.source == "controller":
        return args.monitor_cmd or (
            f"{sys.executable} -m traffic_classifier_sdn_tpu_torch.controller "
            f"--port {args.of_port}"
        )
    return args.monitor_cmd or DEFAULT_MONITOR_CMD


def _provenance_on(args) -> bool:
    """--latency-provenance resolution: 'auto' arms the latency plane (the
    JAX rule arms it on every single-device serve, and the port has no
    other kind)."""
    return args.latency_provenance != "off"


def _fanin_tier(args, raw: bool, recorder=None, stamp: bool = False):
    """The fan-in tier of the CLI's fan-in flags (exits on a bad spec),
    writing into ``global_metrics`` and ``recorder``."""
    from .ingest import fanin
    from .utils.metrics import global_metrics

    try:
        specs = fanin.specs_from_cli(
            args.source, max(1, args.sources), args.source_spec,
            capture=args.capture,
            monitor_cmd=_resolved_monitor_cmd(args),
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
        metrics=global_metrics, recorder=recorder, stamp=stamp,
    )


def _stamped_ticks(gen):
    """Emit-stamp each pull-paced direct-source batch as it is generated,
    on its lead record (one generation moment per batch). An absorbed
    ``obs.stamp`` fire leaves that batch unstamped; it still flows."""
    from .ingest.protocol import stamp_records

    for batch in gen:
        stamp_records(batch[:1])
        yield batch


def _forever(make):
    while True:
        yield make()


def _tick_source(args, raw: bool = False, tier=None, recorder=None,
                 probe_out=None, stamp: bool = False):
    """Yield one batch of telemetry per poll tick: a list of
    TelemetryRecords, or raw pipe bytes when ``raw`` (the native engine's
    bulk path — no per-line Python between the pipe and C++). With the
    fan-in ``tier`` the batches are its ticks (a ``RawTick`` of ``(source
    id, bytes)`` pairs when raw).

    ``recorder`` threads the flight recorder into the collector and
    supervisor; ``probe_out`` (a dict) receives the ``"probe"`` callable
    behind /healthz ``collector_alive`` once a subprocess source starts
    (the fan-in tier's ``alive``, with the tier under ``"fanin"``).
    ``stamp`` arms latency-provenance emit stamps: pull-paced sources at
    generation, collectors at pipe parse on the reader thread, fan-in
    pumps at delivery; a direct raw byte source cannot stamp (no records
    on the host) and the serve loop stamps it at arrival."""
    if tier is not None:
        if probe_out is not None:
            probe_out["probe"] = tier.alive
            probe_out["fanin"] = tier
        yield from tier.ticks()
    elif args.source == "replay":
        if not args.capture:
            sys.exit("--source replay requires --capture FILE")
        from .ingest.replay import iter_capture

        gen = iter_capture(args.capture)
        yield from (_stamped_ticks(gen) if stamp else gen)
    elif args.source == "synthetic":
        from .ingest.replay import SyntheticFlows

        syn = SyntheticFlows(n_flows=args.synthetic_flows)
        gen = _forever(syn.tick)
        yield from (_stamped_ticks(gen) if stamp else gen)
    elif args.source == "workload":
        from .ingest.workload import ClassWorkload, class_delta_pools

        pools = class_delta_pools(args.data_dir)
        wl = ClassWorkload(
            pools,
            flows_per_class=max(1, args.synthetic_flows // len(pools)),
        )
        gen = _forever(wl.tick)
        yield from (_stamped_ticks(gen) if stamp else gen)
    else:
        from .ingest.collector import SubprocessCollector
        from .utils.metrics import global_metrics

        cmd = _resolved_monitor_cmd(args)
        if args.monitor_restarts:
            from .ingest.supervisor import SupervisedCollector

            coll = SupervisedCollector(
                cmd, raw=raw, max_restarts=args.monitor_restarts,
                metrics=global_metrics, recorder=recorder, stamp=stamp,
            )
        else:
            coll = SubprocessCollector(cmd, raw=raw, recorder=recorder,
                                       stamp=stamp)
        if probe_out is not None:
            probe_out["probe"] = lambda: coll.running
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


def _evict_dead_namespaces(tier, engine, pipe, summary, m=None,
                           recorder=None, lat=None) -> None:
    """Evict namespaces whose source-death quarantine expired (fan-in
    tier, ingest/fanin.py). A pipelined render in flight is waited for
    first (bounded, as idle eviction does): a released slot's metadata
    must outlive its render. The JAX serve only defers to a later tick
    while a render is in flight, which never evicts when every host tick
    is shorter than a render; waiting only on ticks with an eviction due
    lands it in the same tick whatever the host load. A render still in
    flight after the wait defers the eviction to the next tick (the tier
    keeps the sid pending until it is taken). Each eviction counts in the
    ``evicted`` and ``source_evictions`` counters of ``m``, lands in
    ``recorder`` and drops the namespace's pending latency entries."""
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
        if lat is not None:
            # the namespace's rows are gone: its pending entries would fold
            # against labels nobody serves
            lat.drop_source(sid)
        if m is not None:
            m.inc("evicted", n)
            m.inc("source_evictions")
        if recorder is not None:
            recorder.record("fanin.namespace_evicted", source=sid, flows=n)
        print(
            f"WARNING: telemetry source {sid} dead past quarantine — "
            f"evicted {n} flows from its namespace",
            file=sys.stderr,
        )


def _begin_tick_provenance(lat, batch, tier) -> None:
    """Register this tick's arrived batches with the latency plane: the
    fan-in tier hands over its per-batch ``(sid, emit, enq, deq, n)``
    entries; a direct source becomes one sid-0 entry stamped at its
    pump or parse moment. Raw byte batches take an arrival-time emit (no
    records on the host to carry a stamp); a record batch arriving
    unstamped (an absorbed ``obs.stamp`` fire) is counted in
    ``latency_unstamped_batches`` and never folded."""
    from .ingest.batcher import batch_emit_ts

    if tier is not None:
        entries = tier.pop_provenance()
        if entries:
            lat.begin_tick(entries)
        return
    if isinstance(batch, (bytes, bytearray)):
        emit, n = lat.clock(), 0
    else:
        emit, n = batch_emit_ts(batch), len(batch)
    lat.begin_tick([(0, emit, None, None, n)])


def _serving_reference(drift, openset) -> dict | None:
    """The serving checkpoint's ``feature_reference`` block: the drift
    monitor's reference and the open-set gate's armed stats and threshold
    ride together (either may be absent; each restores only its own
    keys)."""
    ref: dict = {}
    if drift is not None:
        ref.update(drift.reference_arrays() or {})
    if openset is not None:
        ref.update(openset.reference_arrays() or {})
    return ref or None


def _snapshot_if_due(args, engine, m, ticks: int, loop_t0: float,
                     recorder=None, health=None, drift=None,
                     openset=None) -> None:
    """Periodic in-loop serving snapshot (between ticks).

    The wall-clock budget guard keeps checkpointing from starving the
    serve loop: when cumulative save time exceeds
    ``--serve-checkpoint-budget`` of the loop's elapsed time, the due
    snapshot is skipped (``checkpoint_skipped``) and retried at the next
    due tick. A failed save (disk full, permission) is warned, counted in
    ``checkpoint_errors`` and retried; an injected fault propagates (it
    simulates process death). The drift monitor's reference and the
    open-set gate's armed stats ride in the snapshot (format v3,
    ``_serving_reference``)."""
    from .io import serving_checkpoint as sc
    from .utils.faults import FaultInjected

    h = m.histograms.get("checkpoint_save_s")
    elapsed = time.monotonic() - loop_t0
    # budget <= 0 disables the guard: otherwise any recorded save makes
    # total/elapsed > 0 true forever and the rotation freezes
    if (args.serve_checkpoint_budget > 0 and h is not None
            and elapsed > 0
            and h.total / elapsed > args.serve_checkpoint_budget):
        m.inc("checkpoint_skipped")
        if recorder is not None:
            recorder.record("checkpoint.skip", tick=ticks, reason="budget")
        return
    try:
        with m.time("checkpoint_save_s"):
            _, nbytes = sc.save_rotating(
                engine, args.serve_checkpoint_dir, tick=ticks,
                keep=args.serve_checkpoint_keep,
                feature_reference=_serving_reference(drift, openset),
            )
    except FaultInjected:
        raise
    except OSError as e:
        m.inc("checkpoint_errors")
        if recorder is not None:
            recorder.record("checkpoint.error", tick=ticks,
                            error=type(e).__name__, detail=str(e))
        print(
            f"WARNING: serving snapshot failed (tick {ticks}): {e} — "
            f"will retry at the next due tick",
            file=sys.stderr,
        )
        return
    m.inc("checkpoint_saves")
    m.inc("checkpoint_bytes", nbytes)
    if recorder is not None:
        recorder.record("checkpoint.save", tick=ticks, bytes=nbytes)
    if health is not None:
        health.checkpoint()


def _dump_flight(recorder, obs_dir, reason: str) -> None:
    """Best-effort post-mortem dump: the forensics path must never turn a
    serve-loop failure into a different failure."""
    if recorder is None or not obs_dir:
        return
    try:
        path = recorder.dump(obs_dir, reason)
    except OSError as e:
        print(f"WARNING: flight-recorder dump failed: {e}", file=sys.stderr)
        return
    print(f"flight recorder dumped to {path} ({reason})", file=sys.stderr)


def _dump_metrics(m, obs_dir, reason: str) -> None:
    """Best-effort metrics-snapshot dump (the SIGUSR1 pair of
    ``_dump_flight``)."""
    from .obs import dump_metrics_snapshot

    try:
        path = dump_metrics_snapshot(m, obs_dir, reason)
    except OSError as e:
        print(f"WARNING: metrics snapshot dump failed: {e}", file=sys.stderr)
        return
    print(f"metrics snapshot dumped to {path} ({reason})", file=sys.stderr)


def _serve_loop(args, engine, model, predict, serve_params, inc=None,
                degrade=None, *, m, tracer, recorder=None, health=None,
                lat=None, usr1=None, drift=None,
                openset=None) -> ServeSummary:
    """The poll loop. Spans per tick (obs/trace.py, into ``m``'s
    ``stage_*_s`` histograms): ``poll`` (its own root: waiting on the
    source), then ``tick`` around ``parse``, ``scatter`` (the table update
    and the wait on the serve stream that already ends each ingest),
    the render (serial: ``compact``/``feature``, ``predict``, ``render``;
    pipelined: ``dispatch`` on the host stage, ``stage.device`` around
    ``predict`` and ``render`` on the device stage) and ``snapshot``.
    ``drift.poll()`` runs after each render, its frame printed: on the
    device-stage worker when pipelined, else on this thread."""
    import functools

    from .ingest.fanin import RawTick
    from .serving.pipeline import ServePipeline, coalesce_renders

    summary = ServeSummary(engine=engine)
    # raw bytes wherever the native engine can take them: the pipe
    # source, and every fan-in kind (the tier's pumps render capture and
    # synthetic ticks to the wire themselves)
    fanin = _fanin_active(args)
    raw = engine.native and (args.source in ("ryu", "controller") or fanin)
    stamp = lat is not None
    tier = (_fanin_tier(args, raw, recorder=recorder, stamp=stamp)
            if fanin else None)
    dropped_seen = 0
    # Pipelined serving: this thread (the host stage) polls, parses,
    # scatters and DISPATCHES each render; one worker (the device stage)
    # waits for it and prints. The handoff is bounded; 'off' keeps the
    # serial chain.
    pipe = None
    host_busy = host_span = contextlib.nullcontext
    if args.pipeline != "off":
        pipe = ServePipeline(consume=lambda job: job(), depth=PIPELINE_DEPTH,
                             metrics=m, merge=coalesce_renders).start()
        host_busy = pipe.host_stage
        host_span = functools.partial(tracer.span, "stage.host")
    # A restarted serve keeps numbering ABOVE the rotation's members:
    # lower-numbered snapshots would be pruned first and lose to
    # pre-crash checkpoints in resolve_latest.
    tick_base = 0
    if args.serve_checkpoint_every and args.serve_checkpoint_dir:
        from .io import serving_checkpoint as sc

        existing = sc.list_checkpoints(args.serve_checkpoint_dir)
        if existing:
            tick_base = existing[0][0]
    loop_t0 = time.monotonic()
    probe_out: dict = {}
    probe_wired = False
    end = object()
    source = _tick_source(args, raw=raw, tier=tier, recorder=recorder,
                          probe_out=probe_out, stamp=stamp)
    try:
        while True:
            # poll is its own root span: it measures waiting on EXTERNAL
            # telemetry
            with tracer.span("poll"):
                batch = next(source, end)
            if batch is end:
                break
            if usr1 is not None and usr1["due"]:
                # the deferred half of the SIGUSR1 hook, between ticks:
                # record, dump the ring and the counters, keep serving
                usr1["due"] = False
                recorder.record("signal.sigusr1")
                _dump_flight(recorder, args.obs_dir, "sigusr1")
                _dump_metrics(m, args.obs_dir, "sigusr1")
            if pipe is not None:
                # a dead device stage must end the serve, not let the
                # host stage spin on
                pipe.raise_if_failed()
            if lat is not None:
                _begin_tick_provenance(lat, batch, tier)
            if health is not None:
                health.tick()
                if not probe_wired and "probe" in probe_out:
                    # the collector exists once the source generator has
                    # started: wire the /healthz probe at first arrival
                    health.set_collector_probe(probe_out["probe"])
                    if probe_out.get("fanin") is not None:
                        health.set_source_roster(probe_out["fanin"].roster)
                    probe_wired = True
            t0 = time.perf_counter()
            with tracer.span("tick"), host_busy(), host_span():
                engine.mark_tick()  # freshness floor for the render
                with m.time("ingest_s"):
                    with tracer.span("parse"):
                        if isinstance(batch, bytes):
                            n_rec = engine.ingest_bytes(batch)
                        elif isinstance(batch, RawTick):
                            # native fan-in: one feed per (source, poll
                            # batch), under that source's namespace
                            n_rec = sum(engine.ingest_bytes(data, sid)
                                        for sid, data in batch)
                        else:
                            n_rec = engine.ingest(batch)
                    m.inc("records", n_rec)
                    # malformed wire lines, counted and skipped at the
                    # parse seam, on either spine
                    m.set("native_parse_errors", engine.parse_errors())
                    if lat is not None:
                        lat.mark_parse()
                    with tracer.span("scatter"):
                        engine.step()
                        _sync(engine.device)
                    if lat is not None:
                        lat.mark_scatter()
                summary.ingest_seconds.append(time.perf_counter() - t0)
                summary.ticks += 1
                m.inc("ticks")
                if tier is not None:
                    _evict_dead_namespaces(tier, engine, pipe, summary, m,
                                           recorder, lat)
                # every tick: a scrape between renders must not read a
                # stale drop count
                m.set("flows_dropped", engine.dropped)
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
                    if pipe is not None:
                        plan = _dispatch_render(
                            args, engine, model, predict, serve_params,
                            pipe, inc=inc, degrade=degrade, m=m,
                            tracer=tracer, lat=lat, drift=drift,
                        )
                    else:
                        if args.idle_timeout and engine.last_time:
                            m.inc("evicted", engine.evict_idle(
                                engine.last_time, args.idle_timeout))
                        with m.time("predict_s"):
                            plan = _print_table(
                                engine, model, predict, serve_params, args,
                                inc, degrade=degrade, tracer=tracer,
                                lat=lat,
                            )
                        if drift is not None:
                            # off the hot path: the tick's labels are
                            # already rendered
                            drift.poll()
                    summary.render_ticks.append(summary.ticks)
                    if plan is not None:
                        summary.render_plans.append(plan)
                if (args.serve_checkpoint_every
                        and summary.ticks % args.serve_checkpoint_every == 0):
                    with tracer.span("snapshot"):
                        _snapshot_if_due(args, engine, m,
                                         tick_base + summary.ticks, loop_t0,
                                         recorder=recorder, health=health,
                                         drift=drift, openset=openset)
                _sync(engine.device)
            summary.tick_seconds.append(time.perf_counter() - t0)
            if args.metrics_every and summary.ticks % args.metrics_every == 0:
                print(m.report(), file=sys.stderr, flush=True)
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
                     inc=None, degrade=None, *, m, tracer, lat=None,
                     drift=None):
    """Host-stage half of one pipelined render tick: evict, dispatch the
    read side against THIS tick's table, and stage the device-stage job.
    It prints what the serial render of the same tick prints: ``n_flows``
    is taken at dispatch, the dispatched tensors are fixed against tick
    N's state, and eviction waits for renders in flight (a released
    slot's metadata must outlive its render). The latency plane seals at
    dispatch; the device stage marks the device boundary after
    ``rows()``, whose copy to the host waits for the kernels. After the
    frame prints, the worker polls the drift loop (``drift.poll()``): a
    promotion swaps the served model there, between renders. Returns the
    incremental label plan, ``(kind, dirty rows)`` (None under
    ``--incremental off``)."""
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
                m.inc("evict_deferred")
                pipe.drain(timeout=10.0)
            if pipe.idle():
                m.inc("evicted", engine.evict_slots(stale))
    with tracer.span("dispatch"):
        read = dispatch_read(engine, predict, serve_params, args.table_rows,
                             inc=inc)
    # seal at dispatch, on the host stage: exactly the batches scattered
    # so far become visible when this render prints
    seal = lat.seal() if lat is not None else None

    def render(read):
        with tracer.span("stage.device"):
            with m.time("predict_s"), tracer.span("predict"):
                rows = read.rows()  # ends on the copy to the host
            if lat is not None:
                lat.mark_device(seal)
            # the stale verdict postdates the predict attempt: a ladder
            # trip during rows() marks this tick's render
            stale = degrade is not None and degrade.render_stale
            with tracer.span("render"):
                if args.table_rows > 0:
                    _print_ranked(engine, model, rows, read.n_flows,
                                  stale=stale)
                else:
                    _print_full(model, rows, stale=stale)
            if lat is not None:
                lat.render_visible(seal)
        if drift is not None:
            # the device-stage worker's idle time: the frame is printed,
            # the next render is not yet taken
            drift.poll()

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
                 degrade=None, *, tracer, lat=None):
    """The serial render: label the table and print the tick's table;
    returns the incremental label plan, ``(kind, dirty rows)`` (None under
    ``--incremental off``).

    The ``predict`` span ends where the port already waits: under the
    degrade ladder its device call includes the labels' copy to the host,
    so the span covers the kernel; a bare kernel predict (``--degrade
    off``) returns at its launch, and the kernel's time falls into
    ``render``, whose copy to the host waits for it. No sync is added to
    close a span. The latency plane marks the device boundary after the
    first such wait."""
    # serial render: everything scattered so far becomes visible when this
    # frame prints — seal, wait, fold
    seal = lat.seal() if lat is not None else None
    plan = None
    if inc is not None:
        # only this tick's dirty rows are predicted; the rest come from
        # the label cache
        with tracer.span("predict"):
            labels = inc.labels()
        plan = inc.last_plan
    else:
        with tracer.span("feature"):
            X = engine.features()
        with tracer.span("predict"):
            labels = predict(serve_params, X)
    on_host = not isinstance(labels, torch.Tensor)
    if lat is not None and on_host:
        lat.mark_device(seal)  # host labels: the device work is done
    # the stale verdict postdates the predict attempt
    stale = degrade is not None and degrade.render_stale
    n_flows = engine.num_flows()
    with tracer.span("render"):
        if args.table_rows > 0:
            # activity-ranked sample: O(table_rows) crosses to the host
            ranked = engine.render_sample(labels, args.table_rows)
            if lat is not None and not on_host:
                lat.mark_device(seal)
            _print_ranked(engine, model, ranked, n_flows, stale=stale)
        else:
            if not on_host:
                labels = labels.cpu().numpy()
                if lat is not None:
                    lat.mark_device(seal)
            fwd_active = engine.table.fwd.active[:-1].cpu().numpy()
            rev_active = engine.table.rev.active[:-1].cpu().numpy()
            rows = [
                (slot, src, dst, int(labels[slot]), bool(fwd_active[slot]),
                 bool(rev_active[slot]))
                for slot, (src, dst) in sorted(engine.slot_metadata().items())
            ]
            _print_full(model, rows, stale=stale)
    if lat is not None:
        lat.render_visible(seal)
    return plan


def _check_flags(args) -> None:
    """The serve-durability and obs flag rules, before any model or device
    work, so misuse fails fast."""
    if args.serve_checkpoint_every and not args.serve_checkpoint_dir:
        sys.exit("--serve-checkpoint-every needs --serve-checkpoint-dir")
    if args.obs_dump_on_exit and not args.obs_dir:
        sys.exit("--obs-dump-on-exit needs --obs-dir (the dump target)")
    if args.drift != "off" and not args.drift_dir:
        sys.exit(
            "--drift auto needs --drift-dir (the candidate checkpoint "
            "rotation and rollback target)"
        )
    if args.drift_follow and args.drift == "off":
        sys.exit(
            "--drift-follow needs --drift auto (the follower IS the "
            "drift loop, adopting peers' rotation members)"
        )


def _build_engine(args, device, recorder):
    """The serving engine: restored from ``--restore-serve-state`` (its
    capacity and index kind are the checkpoint's) or fresh."""
    from .ingest.batcher import FlowStateEngine

    if not args.restore_serve_state:
        return FlowStateEngine(
            args.capacity, device=device, native=_use_native(args),
            track_dirty=args.incremental != "off",
        )
    from .io import serving_checkpoint as sc

    engine = sc.restore(args.restore_serve_state, recorder=recorder,
                        device=device)
    if args.incremental != "off":
        # restored rows predate the label cache: everything starts dirty,
        # so the first render re-predicts the whole table
        engine.enable_dirty_tracking()
    if engine.table.capacity != args.capacity:
        print(
            f"WARNING: --capacity {args.capacity} ignored — the checkpoint "
            f"fixes capacity at {engine.table.capacity}",
            file=sys.stderr,
        )
        args.capacity = engine.table.capacity
    print(
        f"restored {engine.num_flows()} tracked flows from "
        f"{args.restore_serve_state}",
        file=sys.stderr,
    )
    return engine


def _start_exposition(args, m, recorder, degrade, inc, lat, drift=None,
                      openset=None):
    """``HealthState`` and the ``ExpositionServer`` of ``--obs-port``, or
    (None, None)."""
    if args.obs_port is None:
        return None, None
    from .obs import ExpositionServer, HealthState

    health = HealthState(
        max_tick_age_s=args.obs_stale_after,
        max_checkpoint_age_s=args.obs_checkpoint_stale_after or None,
    )
    health.model_loaded()  # the model_age_s staleness anchor
    if degrade is not None:
        # 200-but-degraded, with the ladder's rung (following promotions
        # when the drift loop is on)
        health.set_degrade(degrade.status)
    if drift is not None:
        # the drift loop's self-report and promotion timestamps:
        # model_age_s tells "healthy but ancient" from "freshly promoted"
        health.set_drift(drift.status)
        drift.set_health(health)
    if inc is not None:
        health.set_label_cache(inc.status)
    if openset is not None:
        # the rejection tier: state, calibrated threshold, counters
        health.set_openset(openset.status)
    if lat is not None:
        health.set_latency(lat.status)
    server = ExpositionServer(m, recorder=recorder, health=health,
                              port=args.obs_port, host=args.obs_host)
    server.start()
    # --obs-port 0 binds ephemerally: report the ACTUAL port on the
    # startup line, the obs_port gauge and the /healthz self-reference
    health.set_obs_port(server.port)
    m.set("obs_port", server.port)
    print(f"observability plane on port {server.port} "
          "(/metrics /healthz /events)", file=sys.stderr)
    return health, server


def run_classify(args) -> ServeSummary:
    from .device import resolve_device
    from .io.checkpoint import load_model
    from .models import SUBCOMMAND_ALIASES
    from .obs import FlightRecorder, Tracer
    from .utils.metrics import global_metrics as m

    _check_flags(args)
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
    # The obs plane: the flight recorder exists whenever an obs surface is
    # on (it feeds /events and the post-mortem dump); the tracer is always
    # on (per-tick spans cost microseconds and give --metrics-every its
    # stage_* series), and so is latency provenance unless turned off.
    recorder = (FlightRecorder()
                if (args.obs_port is not None or args.obs_dir) else None)
    tracer = Tracer(metrics=m, recorder=recorder)
    lat = None
    if _provenance_on(args):
        from .obs import LatencyProvenance

        lat = LatencyProvenance(metrics=m, recorder=recorder,
                                slo_s=args.latency_slo)
    if args.device_obs != "off" and recorder is not None:
        print("NOTE: --device-obs: device-runtime telemetry (memory gauges, "
              "the perf ring, /profile) is not ported yet (ROADMAP Queue 1 "
              "item 6); nothing is armed", file=sys.stderr)
    engine = _build_engine(args, device, recorder)
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
            metrics=m, recorder=recorder,
        )
        predict = degrade
    server = None
    # SIGTERM must leave a post-mortem: the handler only flags and raises
    # (touching the non-reentrant ring lock from a signal frame could
    # deadlock); the dump runs in the except path below. SIGUSR1 dumps
    # without exiting, deferred to the loop. Handlers install only from
    # the main thread.
    prev_sigterm = prev_sigusr1 = None
    sigterm_seen = False
    usr1 = {"due": False}
    drift = openset = None
    degrade_surface = degrade
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
        # the drift loop and the open-set gate wrap the predict AFTER
        # warmup primed the boot model, and before the label cache, which
        # watches their label_epoch
        predict, drift, degrade_surface = _drift_loop(
            args, model, predict, degrade, engine, device, m, recorder)
        predict, model, openset = _openset_gate(
            args, model, predict, drift, engine, m, recorder)
        inc = None
        if args.incremental != "off":
            from .serving.incremental import IncrementalLabels

            inc = IncrementalLabels(engine, predict, serve_params,
                                    degrade=degrade_surface, metrics=m,
                                    recorder=recorder, tracer=tracer)
        health, server = _start_exposition(args, m, recorder,
                                           degrade_surface, inc, lat,
                                           drift=drift, openset=openset)
        if (recorder is not None and args.obs_dir
                and threading.current_thread() is threading.main_thread()):
            def _on_sigterm(signum, frame):
                nonlocal sigterm_seen
                sigterm_seen = True
                raise SystemExit(143)

            def _on_sigusr1(signum, frame):
                usr1["due"] = True  # flag only — the dump is deferred

            prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
            prev_sigusr1 = signal.signal(signal.SIGUSR1, _on_sigusr1)
        obs_faults = (recorder.observing_faults() if recorder is not None
                      else contextlib.nullcontext())
        try:
            with obs_faults:
                summary = _serve_loop(
                    args, engine, model, predict, serve_params, inc,
                    degrade=degrade_surface, m=m, tracer=tracer,
                    recorder=recorder, health=health, lat=lat, usr1=usr1,
                    drift=drift, openset=openset)
        except BaseException as e:
            # the crash-forensics moment, outside any signal frame: a
            # SystemExit is a dump only when the SIGTERM hook raised it
            if recorder is not None:
                if sigterm_seen and isinstance(e, SystemExit):
                    recorder.record("signal.sigterm")
                    _dump_flight(recorder, args.obs_dir, "sigterm")
                elif not isinstance(e, SystemExit):
                    recorder.record("serve.exception",
                                    error=type(e).__name__, detail=str(e))
                    _dump_flight(recorder, args.obs_dir,
                                 "keyboard-interrupt"
                                 if isinstance(e, KeyboardInterrupt)
                                 else "serve-exception")
            raise
        else:
            if recorder is not None:
                if recorder.count("supervisor.terminal"):
                    # the monitor died for good and the source drained:
                    # the loop ends "cleanly", but the trail matters
                    _dump_flight(recorder, args.obs_dir,
                                 "supervisor-terminal")
                elif args.obs_dump_on_exit:
                    _dump_flight(recorder, args.obs_dir, "on-demand")
    finally:
        if server is not None:
            server.stop()
        if degrade_surface is not None:
            # the view closes the live (possibly promoted) ladder and the
            # boot one; without drift it IS the boot ladder
            degrade_surface.close()
        if drift is not None:
            drift.close()
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)
            signal.signal(signal.SIGUSR1, prev_sigusr1)
        # the checkpoint survives every exit, Ctrl-C and SIGTERM included:
        # the state is consistent between ticks (save() flushes first)
        if args.save_serve_state:
            from .io import serving_checkpoint as sc

            sc.save(engine, args.save_serve_state,
                    feature_reference=_serving_reference(drift, openset))
            print(
                f"saved serving state ({engine.num_flows()} tracked flows) "
                f"to {args.save_serve_state}",
                file=sys.stderr,
            )
    summary.warmup = wstats
    if degrade is not None:
        summary.degrade = degrade_surface.status()
        summary.degrade_transitions = list(degrade.transitions)
    if drift is not None:
        summary.drift = drift.status()
    if openset is not None:
        summary.openset = openset.status()
    return summary


def _drift_loop(args, model, predict, degrade, engine, device, m, recorder):
    """``(predict, drift, degrade_surface)`` under ``--drift auto``: the
    predict wrapped in a ``DriftGate`` (a passthrough until the first
    promotion, the hot-swap point after it), its ``DriftController``, and
    the ladder surface the render and /healthz read (a ``GateLadderView``
    that follows promotions). A promotion under ``--degrade auto``
    rebuilds a ``DegradeLadder`` around the candidate's kernel, with its
    own host rung. Under ``--drift off`` the three come back as given."""
    if args.drift == "off":
        return predict, None, degrade
    from .serving.drift import (
        DriftController,
        DriftGate,
        GateLadderView,
        default_build_serving,
    )

    build_bare = default_build_serving(model.name, tuple(model.classes.names))

    def build_promoted(params):
        """Candidate params → the serving pair a promotion installs: the
        boot resolution plus, when --degrade engaged, the ladder — a
        promoted checkpoint keeps the watchdog and fallback guarantees."""
        pred, p = build_bare(params)
        if degrade is None or getattr(pred, "host_native", False):
            return pred, p
        from .models import resolve_fallback
        from .serving.degrade import DegradeLadder

        return DegradeLadder(
            pred, resolve_fallback(model.name, params),
            deadline=args.device_deadline, probe_every=args.probe_every,
            probe_successes=args.probe_successes, metrics=m,
            recorder=recorder,
        ), p

    gate = DriftGate(predict)
    drift = DriftController(
        gate,
        family=model.name,
        classes=tuple(model.classes.names),
        directory=args.drift_dir,
        window=args.drift_window,
        threshold=args.drift_threshold,
        trips=args.drift_trips,
        class_tolerance=args.drift_class_tolerance,
        probe_successes=args.drift_probe_successes,
        parity_min=args.drift_parity,
        # a refit clustering orders its centroids arbitrarily: parity
        # mode-matches kmeans cluster ids before comparing
        parity_mode="mode-matched" if model.name == "kmeans" else "exact",
        retrain_deadline=args.retrain_deadline,
        reference=engine.feature_reference,
        build_serving=build_promoted,
        boot_params=model.params,
        metrics=m,
        recorder=recorder,
        follow_rotation=args.drift_follow,
        device=device,
    )
    surface = GateLadderView(gate, degrade) if degrade is not None else None
    return gate, drift, surface


def _openset_gate(args, model, predict, drift, engine, m, recorder):
    """``(predict, model, openset)`` under ``--openset auto``: the
    OUTERMOST predict wrapper (drift promotions hot-swap inside it), the
    model's class list extended by ``unknown`` so every render decodes the
    rejection index, and the gate; a restored serving checkpoint's armed
    reference boots it ARMED. Under ``--openset off`` the first two come
    back as given."""
    if args.openset == "off":
        return predict, model, None
    import dataclasses

    from .models.base import ClassList
    from .serving.openset import OpenSetGate

    restored = engine.feature_reference or {}
    keys = ("openset_mean", "openset_inv_std", "openset_threshold")
    openset = OpenSetGate(
        predict, n_classes=len(model.classes.names),
        margin=args.openset_margin,
        calibration_rows=args.openset_calibration_rows,
        metrics=m, recorder=recorder,
        reference=(
            {k: restored[k] for k in (*keys, "openset_calibrated_rows")
             if k in restored}
            if all(k in restored for k in keys) else None
        ),
    )
    model = dataclasses.replace(
        model, classes=ClassList(tuple(model.classes.names) + ("unknown",)))
    if drift is not None:
        # promotions re-base the gate on the retrain window, and the
        # monitor observes the gate's labels (unknown included)
        drift.set_openset(openset)
    return openset, model, openset


def _apply_config(args, parser) -> None:
    """Fill the flags left unset from ``--config`` (config.py's schema),
    then the built-in defaults. A flag given wins over the file."""
    cfg = None
    if args.config:
        from . import config as config_mod

        cfg = config_mod.load(args.config)
        if cfg.ingest.shards:
            parser.error("--config: ingest.shards is set, but sharding is "
                         "not ported yet (set it to 0)")
        if args.capacity is None:
            args.capacity = cfg.ingest.capacity
        if args.idle_timeout is None:
            args.idle_timeout = cfg.ingest.idle_timeout_s
        if args.print_every is None:
            args.print_every = cfg.print_every
        if args.monitor_cmd is None:
            args.monitor_cmd = cfg.ingest.monitor_cmd
        if args.native_checkpoint is None:
            args.native_checkpoint = cfg.model.native_checkpoint
    if args.capacity is None:
        args.capacity = 65536
    if args.idle_timeout is None:
        args.idle_timeout = 60
    if args.print_every is None:
        args.print_every = 10
    if args.native_checkpoint is None:
        parser.error("--native-checkpoint is required (or "
                     "model.native_checkpoint in --config)")


def main(argv=None) -> ServeSummary:
    from .utils.metrics import global_metrics

    global_metrics.reset()  # per-run metrics, even for embedded reuse
    parser = _build_parser()
    args = parser.parse_args(argv)
    if args.knn_topk is not None:
        # validated here (a usage error, exit 2) and published through
        # the env var, so every serving-path build sees the same choice
        from .models import resolve_knn_topk

        try:
            resolve_knn_topk(args.knn_topk)
        except ValueError as e:
            parser.error(f"--knn-topk: {e}")
        os.environ["TCSDN_KNN_TOPK"] = args.knn_topk
    _apply_config(args, parser)
    if args.compilation_cache_dir:
        print("NOTE: --compilation-cache-dir is ignored: the port compiles "
              "no XLA program, and its kernel libraries persist under "
              "csrc/build/ by source hash", file=sys.stderr)
    return run_classify(args)


if __name__ == "__main__":
    main()

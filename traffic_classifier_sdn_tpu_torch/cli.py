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

The device-runtime plane arms with any obs surface (``--device-obs
auto``): the /healthz ``device`` block and the ``device_memory_bytes``
gauges from ``torch.cuda.memory_stats`` (obs/device.py), and under
``--obs-dir`` the black-box perf ring (one sample per poll tick, atomic
segments in ``<obs-dir>/perf``, obs/perf_recorder.py) and ``/profile``
(a ``torch.profiler`` capture into ``<obs-dir>/profile``).
``--profile-dir DIR`` traces the whole serve with ``torch.profiler``.

``--actuation dry-run|push --policy SPEC`` runs the actuation plane
(serving/actuation.py, controller/policy.py): each rendered tick's rows
feed a hysteresis FSM, and labels that hold ``--actuation-k-install``
renders become OF1.3 flow-mods, printed on stderr (dry-run) or pushed to
``--actuation-switch`` with a barrier (push); stdout is the ``--actuation
off`` serve's. ``--scenario ID`` replays one adversarial scenario of the
campaign library (scenarios/) through the serve composition and prints
its scorecard instead of serving.

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
        "--scenario", default=None, metavar="ID",
        help="replay one adversarial scenario from the campaign "
        "library (scenarios/library.py) through the real serve "
        "composition and print its SLO scorecard instead of serving "
        "live traffic — the post-incident replay hook (e.g. "
        "--scenario source_flap_storm; 'list' prints the matrix)",
    )
    p.add_argument(
        "--scenario-profile", choices=("t1", "cpu"), default="cpu",
        help="scenario scale for --scenario replay (default cpu, "
        "the JAX campaign's committed-artifact shape; t1 is the test "
        "size)",
    )
    p.add_argument(
        "--scenario-obs-dir", default="scenario-postmortem",
        metavar="DIR",
        help="--scenario gate failures dump their post-mortem bundle "
        "(flight JSONL + metrics snapshot + timeline manifest) here",
    )
    p.add_argument(
        "--synthetic-flows", type=int, default=1024,
        help="synthetic source size",
    )
    p.add_argument("--capacity", type=int, default=None,
                   help="flow-table rows (default 65536)")
    p.add_argument(
        "--shards", type=int, default=0,
        help="partition the flow table over an N-shard mesh "
        "(parallel/table_sharded.py), one shard per visible device of "
        "--device — serving capacity beyond one device's table; requires "
        "N visible devices. 1 is an EXPLICIT single-shard mesh (the "
        "sharded engine and read steps on one device); 0 (default) is "
        "the single-device engine. Composes with --sources, "
        "--incremental, --native-ingest, serving checkpoints, and "
        "--drift (the region serve)",
    )
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
        "error ends the serve. 'auto' enables it for device kernels on "
        "the single-device serve (sharded and host-native serves have no "
        "device rung to demote from); 'off' restores the bare predict "
        "path",
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
        "rejected rows never become training signal). 'auto' enables it "
        "for single-device serves (sharded serves bind their predict "
        "into the per-shard read steps and are skipped)",
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
        "promotion rolls back. Works on both spines: single-device "
        "serves hot-swap through the DriftGate, sharded serves install "
        "through the engine's install_predict (per-shard read steps "
        "rebuilt, label caches reset). With no drift the output is "
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
        "--actuation", choices=("off", "dry-run", "push"), default="off",
        help="actuation tier (serving/actuation.py): compile per-class "
        "--policy actions into OF1.3 flow-mods, hysteresis-gated so a "
        "label must hold for --actuation-k-install consecutive render "
        "ticks before its rule installs (an open-set 'unknown' blip or "
        "single-tick flip never touches the switch), and retracted "
        "only after --actuation-k-retract deviating ticks. 'dry-run' "
        "renders intended mods to stderr + ring events without a "
        "socket; 'push' programs the switch at --actuation-switch and "
        "degrades itself to dry-run with backoff re-probe on ANY "
        "actuation failure. 'off' (default) is byte-transparent: "
        "stdout is identical with the tier absent. Single-device serves "
        "only (the sharded render has no per-row label surface to gate "
        "on)",
    )
    p.add_argument(
        "--policy", default=None, metavar="SPEC",
        help="declarative per-class actions for --actuation: comma-"
        "separated CLASS=ACTION clauses where ACTION is queue:N (QoS "
        "queue), meter:N (rate limit), drop, or mirror:P (copy to "
        "port P, forward normally). Classes without a clause are "
        "observe-only; 'unknown' may never carry one",
    )
    p.add_argument(
        "--actuation-switch", default=None, metavar="HOST:PORT",
        help="switch address for --actuation push (the OF1.3 peer the "
        "actuation plane dials; tools/torch_fake_switch.py "
        "AccountingSwitch speaks the server side for replay tests)",
    )
    p.add_argument(
        "--actuation-k-install", type=int, default=3, metavar="K",
        help="consecutive stable-label render ticks before a rule "
        "installs (default 3)",
    )
    p.add_argument(
        "--actuation-k-retract", type=int, default=3, metavar="K",
        help="consecutive deviating render ticks before an installed "
        "rule retracts (default 3); a deviation episode that ends "
        "sooner is a suppressed flap",
    )
    p.add_argument(
        "--actuation-span", default=None, metavar="SIDS",
        help="comma-separated source ids this serve may actuate "
        "(fleet blast radius: members only program rules for slots "
        "their own span owns; default: every source)",
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
        "output. 'auto' enables it for single-device serves (the "
        "sharded read side has no single render-visibility point); "
        "'off' disables stamping entirely",
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
        help="device-runtime telemetry (obs/device.py): poll the card's "
        "memory (torch.cuda.memory_stats) into the device_memory_bytes "
        "/ device_memory_peak_bytes gauges per tick and report the "
        "/healthz device block (XLA's compile counters have no eager "
        "torch counterpart and read 0). 'auto' arms it whenever any obs "
        "surface is on (--obs-port or --obs-dir); with --obs-dir it "
        "also runs the black-box perf ring (obs/perf_recorder.py, "
        "<obs-dir>/perf/) and the /profile endpoint (torch.profiler). "
        "Byte-transparent: renders are identical on vs off",
    )
    p.add_argument(
        "--perf-ring-ticks", type=int, default=64, metavar="N",
        help="black-box perf ring: per-tick samples per committed "
        "segment (default 64; needs --obs-dir and --device-obs auto)",
    )
    p.add_argument(
        "--perf-ring-keep", type=int, default=16, metavar="N",
        help="black-box perf ring: committed segments retained on disk "
        "— older ones are pruned, bounding the ring at "
        "keep×ticks-per-segment ticks of evidence (default 16)",
    )
    p.add_argument(
        "--profile-dir", default=None,
        help="capture a torch.profiler trace of the run into this "
        "directory (a Chrome trace, written when the serve ends)",
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
    evicted. ``drift``, ``openset`` and ``actuation`` are the drift
    controller's, the open-set gate's and the actuation plane's final
    ``status()`` (None when off). Every counter and
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
    actuation: dict | None = None

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


def _provenance_on(args, sharded: bool = False) -> bool:
    """--latency-provenance resolution: 'auto' arms the latency plane for
    single-device serves (the sharded read side has no single
    render-visibility point to close an end-to-end measurement at)."""
    if args.latency_provenance == "off":
        return False
    return args.latency_provenance == "on" or not sharded


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
                           recorder=None, lat=None, actuation=None) -> None:
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
    ``recorder``, drops the namespace's pending latency entries and
    retracts the namespace's actuation rules."""
    if pipe is not None and not pipe.idle():
        if not tier.evictions_due():
            return
        pipe.drain(timeout=10.0)
        if not pipe.idle():
            return
    for sid in tier.take_evictions():
        t0 = time.perf_counter()
        if actuation is not None:
            # blast radius: the dead namespace's flow rules retract with
            # its slots, taken BEFORE evict_source releases them (a
            # released slot can be reused next tick, and the retraction
            # would name the wrong flow)
            actuation.retract_source(sid, engine.slots_for_source(sid))
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


def _dump_device(dev, perf, obs_dir, reason: str) -> None:
    """Best-effort device-plane dump: the /healthz device block plus the
    black-box perf-ring tail, frozen as one JSON bundle beside the
    flight-recorder post-mortem."""
    if (dev is None and perf is None) or not obs_dir:
        return
    import json

    from .utils.atomicio import atomic_write_bytes

    payload: dict = {"kind": "device", "reason": reason}
    if dev is not None:
        payload["device"] = dev.status()
    if perf is not None:
        # commit the partial segment first so the on-disk ring and the
        # reported tail agree about the final ticks
        perf.flush()
        payload["perf"] = perf.status()
        payload["perf_tail"] = perf.tail(64)
    try:
        os.makedirs(obs_dir, exist_ok=True)
        path = os.path.join(
            obs_dir,
            f"device-{os.getpid()}-{time.monotonic_ns()}-{reason}.json",
        )
        atomic_write_bytes(
            path,
            json.dumps(payload, sort_keys=True, default=repr).encode(),
        )
    except OSError as e:
        print(f"WARNING: device dump failed: {e}", file=sys.stderr)
        return
    print(f"device telemetry dumped to {path} ({reason})", file=sys.stderr)


def _record_perf_tick(m, dev, perf, ticks, degrade=None, drift=None) -> None:
    """One black-box sample per poll tick: refresh the memory gauges
    (``dev.sample``) and persist the tick's stage timings, queue/dirty
    state, and degrade/drift positions into the on-disk perf ring.
    Host-side dict reads only."""
    devs = dev.sample() if dev is not None else None
    if perf is None:
        return
    sample: dict = {"tick": ticks}
    # newest sample per latency surface — the same underlying readings
    # the latency plane folds into its quantiles, so a ring segment's
    # per-stage p50s reconcile against /healthz by construction
    for name in ("stage_tick_s", "stage_parse_s", "stage_scatter_s",
                 "stage_predict_s", "stage_render_s", "ingest_s",
                 "predict_s"):
        h = m.histograms.get(name)
        if h is not None and h.last is not None:
            sample[name] = round(h.last, 6)
    for gauge in ("queue_depth", "dirty_rows", "flows_dropped"):
        if gauge in m.gauges:
            sample[gauge] = m.gauges[gauge]
    if degrade is not None:
        try:
            sample["degrade_state"] = degrade.status().get("state")
        except Exception:  # noqa: BLE001 — the black box must not inject
            pass
    if drift is not None:
        try:
            sample["drift_state"] = drift.status().get("state")
        except Exception:  # noqa: BLE001 — the black box must not inject
            pass
    if devs is not None:
        sample["jit_compiles"] = devs["jit_compiles"]
        sample["retraces_after_warmup"] = devs["retraces_after_warmup"]
        if devs["hbm_bytes"] is not None:
            sample["hbm_bytes"] = devs["hbm_bytes"]
    perf.record(sample)


def _serve_loop(args, engine, model, predict, serve_params, inc=None,
                degrade=None, *, m, tracer, recorder=None, health=None,
                lat=None, usr1=None, drift=None, openset=None,
                dev=None, perf=None, actuation=None,
                drift_feed=None) -> ServeSummary:
    """The poll loop. Spans per tick (obs/trace.py, into ``m``'s
    ``stage_*_s`` histograms): ``poll`` (its own root: waiting on the
    source), then ``tick`` around ``parse``, ``scatter`` (the table update
    and the wait on the serve stream that already ends each ingest),
    the render (serial: ``compact``/``feature``, ``predict``, ``render``;
    pipelined: ``dispatch`` on the host stage, ``stage.device`` around
    ``predict`` and ``render`` on the device stage) and ``snapshot``.
    ``drift.poll()`` runs after each render, its frame printed: on the
    device-stage worker when pipelined, else on this thread, and so does
    the actuation plane's ``observe`` of the rendered rows. On the sharded
    spine (``--shards``) the render is the engine's one read-side
    dispatch, idle eviction folded in, and ``drift_feed`` (its
    ``ShardedDriftGate``) takes each render's sampled features and
    labels. With the
    device plane on, each poll tick leaves one perf-ring sample
    (``_record_perf_tick``)."""
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
                _dump_device(dev, perf, args.obs_dir, "sigusr1")
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
                                           recorder, lat, actuation)
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
                    if dev is not None:
                        # render dispatch == device work this tick: feeds
                        # the /healthz last-dispatch age
                        dev.mark_dispatch()
                    if pipe is not None:
                        plan = _dispatch_render(
                            args, engine, model, predict, serve_params,
                            pipe, inc=inc, degrade=degrade, m=m,
                            tracer=tracer, lat=lat, drift=drift,
                            actuation=actuation, drift_feed=drift_feed,
                        )
                    elif args.shards >= 1:
                        # the sharded tick's whole read side (per-shard
                        # predict, render candidates, stale masks) is one
                        # dispatch, with eviction folded in
                        with m.time("predict_s"), tracer.span("predict"):
                            rows, evicted = engine.tick_render(
                                now=engine.last_time,
                                idle_seconds=args.idle_timeout or None,
                            )
                        m.inc("evicted", evicted)
                        with tracer.span("render"):
                            _print_ranked(engine, model, rows,
                                          engine.num_flows())
                        if drift is not None:
                            # off the hot path: the frame is printed. The
                            # observation is exact: no ingest between the
                            # render and the sample
                            if drift_feed is not None and rows:
                                _feed_sharded_capture(engine, drift_feed,
                                                      rows)
                            drift.poll()
                        plan = None
                    else:
                        if args.idle_timeout and engine.last_time:
                            m.inc("evicted", engine.evict_idle(
                                engine.last_time, args.idle_timeout))
                        with m.time("predict_s"):
                            plan = _print_table(
                                engine, model, predict, serve_params, args,
                                inc, degrade=degrade, tracer=tracer,
                                lat=lat, drift=drift, actuation=actuation,
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
            if dev is not None or perf is not None:
                # after the tick span closes, so every stage histogram's
                # newest sample is THIS tick's
                _record_perf_tick(m, dev, perf, summary.ticks,
                                  degrade=degrade, drift=drift)
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


def _feed_sharded_capture(engine, gate, rows) -> None:
    """Hand the sharded drift gate one render's (features, labels)
    observation — the stand-in for ``DriftGate.__call__``'s capture. The
    ranked rows' labels came from this render's per-shard predict;
    ``feature_sample`` re-reads the same slots in one gathered fetch."""
    import numpy as np

    X = engine.feature_sample([s for s, *_ in rows])
    gate.feed_capture(
        X, np.asarray([c for _, c, *_ in rows], dtype=np.int64)
    )


def _dispatch_sharded_render(args, engine, model, pipe, *, m, tracer,
                             drift=None, drift_feed=None) -> None:
    """The pipelined render of the sharded spine. With an idle timeout due,
    the read side and the eviction run here on the host stage (releasing
    slots needs the stale bits on the host before ingest resumes), the
    rendered slots' metadata is resolved here too (a released slot may be
    reused by the next tick's ingest), and the worker only prints. Without
    one, the read side is dispatched here and the worker waits for its
    gather, merges the candidates and prints (``ShardedRead``)."""
    from .serving.pipeline import RenderJob, ShardedRead

    idle = args.idle_timeout or None
    if idle is not None and engine.last_time:
        with m.time("predict_s"), tracer.span("predict"):
            rows, evicted = engine.tick_render(now=engine.last_time,
                                               idle_seconds=idle)
        m.inc("evicted", evicted)
        n_flows = engine.num_flows()
        sample = engine.slot_metadata([s for s, *_ in rows])
        if drift is not None and drift_feed is not None and rows:
            # exact pairing: still the host stage, before ingest resumes
            _feed_sharded_capture(engine, drift_feed, rows)

        def render_only(read):
            with tracer.span("stage.device"), tracer.span("render"):
                _print_ranked_resolved(model, read.rows(), sample,
                                       read.n_flows)
            if drift is not None:
                drift.poll()

        pipe.submit(RenderJob(ShardedRead(engine, None, n_flows, rows),
                              render_only))
        return
    with tracer.span("dispatch"):
        outs = engine.tick_read_dispatch(now=engine.last_time)
        n_flows = engine.num_flows()

    def render(read):
        with tracer.span("stage.device"):
            with m.time("predict_s"), tracer.span("predict"):
                rows = read.rows()  # ends on the gather's copy to the host
            with tracer.span("render"):
                _print_ranked(engine, model, rows, read.n_flows)
        if drift is not None:
            if drift_feed is not None and rows:
                # worker-side capture: feature_sample re-reads the LIVE
                # tables, which the host stage may already be advancing —
                # a slightly torn observation is acceptable drift signal,
                # and a torn parity probe only defers a promotion
                _feed_sharded_capture(engine, drift_feed, rows)
            drift.poll()

    pipe.submit(RenderJob(ShardedRead(engine, outs, n_flows), render))


def _dispatch_render(args, engine, model, predict, serve_params, pipe,
                     inc=None, degrade=None, *, m, tracer, lat=None,
                     drift=None, actuation=None, drift_feed=None):
    """Host-stage half of one pipelined render tick: evict, dispatch the
    read side against THIS tick's table, and stage the device-stage job.
    It prints what the serial render of the same tick prints: ``n_flows``
    is taken at dispatch, the dispatched tensors are fixed against tick
    N's state, and eviction waits for renders in flight (a released
    slot's metadata must outlive its render). The latency plane seals at
    dispatch; the device stage marks the device boundary after
    ``rows()``, whose copy to the host waits for the kernels. After the
    frame prints, the worker polls the drift loop (``drift.poll()``): a
    promotion swaps the served model there, between renders. The
    actuation plane observes the printed rows on the worker too. Returns the
    incremental label plan, ``(kind, dirty rows)`` (None under
    ``--incremental off``)."""
    from .serving.pipeline import RenderJob, dispatch_read

    if args.shards >= 1:
        _dispatch_sharded_render(args, engine, model, pipe, m=m,
                                 tracer=tracer, drift=drift,
                                 drift_feed=drift_feed)
        return None
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
                                  stale=stale, actuation=actuation,
                                  drift=drift)
                else:
                    _print_full(model, rows, stale=stale,
                                actuation=actuation, drift=drift)
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


def _observe_actuation(actuation, rows, stale, drift) -> None:
    """Feed one rendered tick's ``(slot, src, dst, label)`` rows to the
    actuation plane, with the freshness verdict (STALE render) and the
    drift loop's current state riding along — the three signals the
    hysteresis tier gates on. A no-op without the tier; never raises
    and never touches stdout, so every render stays byte-identical to
    ``--actuation off``."""
    if actuation is None:
        return
    actuation.observe(
        rows, stale=stale,
        drift_state=drift.state if drift is not None else None,
    )


def _print_ranked(engine, model, ranked, n_flows, stale=False,
                  actuation=None, drift=None) -> None:
    """Render activity-ranked ``(slot, label, fwd, rev)`` rows, then feed
    them to the actuation plane — the table surface of the single-device
    and the sharded serve loops."""
    sample = engine.slot_metadata(slots=[s for s, *_ in ranked])
    _print_ranked_resolved(model, ranked, sample, n_flows, stale=stale,
                           actuation=actuation, drift=drift)


def _print_ranked_resolved(model, ranked, sample, n_flows, stale=False,
                           actuation=None, drift=None) -> None:
    """``_print_ranked`` with the slot → (src, dst) sample already resolved
    — the pipelined sharded eviction path resolves it on the host stage
    (the lookup must precede any slot reuse)."""
    from .utils.table import CLASSIFIER_FIELDS, render_table, status_str

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
    _observe_actuation(
        actuation,
        [(slot, src, dst, label) for slot, src, dst, label, *_ in rows],
        stale, drift,
    )


def _print_full(model, rows, stale=False, actuation=None,
                drift=None) -> None:
    """Render the unbounded (``--table-rows 0``) table from
    ``(slot, src, dst, label, fwd, rev)`` rows, then feed them to the
    actuation plane."""
    from .utils.table import CLASSIFIER_FIELDS, render_table, status_str

    out = [
        (slot, src, dst, _label_name(model, c), status_str(f), status_str(r))
        for slot, src, dst, c, f, r in rows
    ]
    fields, out = _stale_fields(CLASSIFIER_FIELDS, out, stale)
    print(render_table(fields, out), flush=True)
    _observe_actuation(
        actuation,
        [(slot, src, dst, label) for slot, src, dst, label, *_ in out],
        stale, drift,
    )


def _print_table(engine, model, predict, serve_params, args, inc=None,
                 degrade=None, *, tracer, lat=None, drift=None,
                 actuation=None):
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
            _print_ranked(engine, model, ranked, n_flows, stale=stale,
                          actuation=actuation, drift=drift)
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
            _print_full(model, rows, stale=stale, actuation=actuation,
                        drift=drift)
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
    sharded = args.shards >= 1
    if args.latency_provenance == "on" and sharded:
        sys.exit(
            "--latency-provenance on is single-device: the sharded "
            "read side has no single render-visibility point to close "
            "an end-to-end measurement at (auto skips it)"
        )
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
    if args.actuation != "off" and not args.policy:
        sys.exit("--actuation needs --policy (the per-class action spec)")
    if args.policy and args.actuation == "off":
        sys.exit(
            "--policy without --actuation does nothing — pass "
            "--actuation dry-run|push (off is the byte-transparent "
            "default)"
        )
    if args.actuation == "push" and not args.actuation_switch:
        sys.exit("--actuation push needs --actuation-switch HOST:PORT")
    if args.actuation != "off" and sharded:
        sys.exit(
            "--actuation is single-device: the hysteresis tier rides "
            "the per-row label render plus the open-set/drift gates, "
            "which the sharded spine's fused read programs don't expose"
        )


def _actuation_plane(args, model, engine, m, recorder):
    """The actuation plane of ``--actuation dry-run|push`` (None when
    off), built AFTER the open-set gate extended the class list, so
    ``--policy`` validates against the names every render decodes (and
    ``unknown`` is refused by name). The plane only observes rendered
    rows: stdout stays byte-identical to ``--actuation off``."""
    if args.actuation == "off":
        return None
    from .controller.policy import parse_policy
    from .serving.actuation import ActuationPlane, SwitchLink

    try:
        policy = parse_policy(args.policy, tuple(model.classes.names))
    except ValueError as e:
        sys.exit(str(e))
    link_factory = None
    if args.actuation == "push":
        sw_host, _, sw_port = args.actuation_switch.rpartition(":")
        if not sw_host or not sw_port.isdigit():
            sys.exit("--actuation-switch wants HOST:PORT")

        def link_factory(host=sw_host, port=int(sw_port)):
            return SwitchLink(host, port)

    span = None
    if args.actuation_span:
        try:
            span = frozenset(
                int(s) for s in args.actuation_span.split(",") if s.strip()
            )
        except ValueError:
            sys.exit(
                "--actuation-span wants comma-separated integer source ids"
            )
    return ActuationPlane(
        policy, mode=args.actuation,
        k_install=args.actuation_k_install,
        k_retract=args.actuation_k_retract,
        link_factory=link_factory,
        span=span,
        slots_for_source=engine.slots_for_source if span is not None else None,
        metrics=m, recorder=recorder,
    )


def _device_plane(args, m, recorder, device):
    """``(dev, perf, profiler)``: the device-runtime telemetry, armed with
    the rest of the obs plane (``--device-obs auto`` and an obs surface
    on), and under ``--obs-dir`` the black-box perf ring
    (``<obs-dir>/perf``) and the ``/profile`` capture
    (``<obs-dir>/profile``); Nones when off."""
    if args.device_obs == "off" or recorder is None:
        return None, None, None
    from .obs import DeviceTelemetry, PerfRecorder, ProfilerCapture

    dev = DeviceTelemetry(metrics=m, recorder=recorder, device=device)
    dev.attach()
    if not args.obs_dir:
        return dev, None, None
    perf = PerfRecorder(
        os.path.join(args.obs_dir, "perf"),
        ticks_per_segment=args.perf_ring_ticks,
        keep_segments=args.perf_ring_keep,
        metrics=m,
    )
    profiler = ProfilerCapture(
        os.path.join(args.obs_dir, "profile"),
        metrics=m, recorder=recorder, device=device,
    )
    return dev, perf, profiler


def _build_sharded_engine(args, device, recorder, predict, serve_params):
    """The sharded spine of ``--shards N`` (parallel/table_sharded.py): a
    mesh of the first N visible devices of ``device``'s kind, the engine
    restored from ``--restore-serve-state`` (any spine's checkpoint) or
    fresh. The refusals are the JAX CLI's, with its text."""
    from .parallel import mesh as meshlib
    from .parallel import table_sharded as tsh

    if getattr(predict, "host_native", False):
        # the sharded engine runs predict inside its per-shard read steps,
        # on the shards' devices — what a host-native predict cannot do
        sys.exit(
            "host-native kernels (TCSDN_FOREST_KERNEL=native, "
            "TCSDN_KNN_TOPK=native) are single-device host serving; "
            "use a device kernel with --shards"
        )
    if args.table_rows <= 0:
        # the sharded render merges bounded per-shard candidates; an
        # unbounded ("0 = all") table would be an O(capacity) fetch
        sys.exit(
            "--shards requires a bounded --table-rows "
            "(the sharded render merges per-shard top-k candidates)"
        )
    devs = meshlib.visible_devices(device)
    if args.shards > len(devs):
        sys.exit(
            f"--shards {args.shards} needs {args.shards} visible "
            f"devices (have {len(devs)})"
        )
    # an explicit sub-mesh (--shards 1 included) takes the leading devices
    mesh = meshlib.make_mesh(n_data=args.shards, n_state=1,
                             devices=devs[:args.shards])
    if not args.restore_serve_state:
        return tsh.ShardedFlowEngine(
            mesh, args.capacity, predict_fn=predict, params=serve_params,
            table_rows=args.table_rows, native=_use_native(args),
            incremental=args.incremental != "off",
        )
    from .io import serving_checkpoint as sc

    # the checkpoint's GLOBAL leaf layout scatters across the mesh: the
    # format is spine-agnostic, so a single-device checkpoint restores
    # into a sharded serve and the reverse
    try:
        engine = sc.restore_sharded(
            args.restore_serve_state, mesh, predict_fn=predict,
            params=serve_params, table_rows=args.table_rows,
            incremental=args.incremental != "off", recorder=recorder,
        )
    except ValueError as e:
        sys.exit(str(e))
    if engine.capacity != args.capacity:
        print(
            f"WARNING: --capacity {args.capacity} ignored — the checkpoint "
            f"fixes capacity at {engine.capacity}",
            file=sys.stderr,
        )
        args.capacity = engine.capacity
    print(
        f"restored {engine.num_flows()} tracked flows from "
        f"{args.restore_serve_state}",
        file=sys.stderr,
    )
    return engine


def _build_engine(args, device, recorder, predict, serve_params):
    """The serving engine: the sharded spine under ``--shards N``, else
    one device's, restored from ``--restore-serve-state`` (its capacity
    and index kind are the checkpoint's) or fresh."""
    from .ingest.batcher import FlowStateEngine

    if args.shards >= 1:
        return _build_sharded_engine(args, device, recorder, predict,
                                     serve_params)
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
                      openset=None, actuation=None, dev=None,
                      profiler=None):
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
    if actuation is not None:
        # live state (push/dry-run/degraded/demoted), the rule census,
        # the exact ledger, flap counts
        health.set_actuation(actuation.status)
    if lat is not None:
        health.set_latency(lat.status)
    if dev is not None:
        # device memory and its watermark, the last-dispatch age
        health.set_device(dev.status)
    server = ExpositionServer(m, recorder=recorder, health=health,
                              port=args.obs_port, host=args.obs_host,
                              profiler=profiler)
    server.start()
    # --obs-port 0 binds ephemerally: report the ACTUAL port on the
    # startup line, the obs_port gauge and the /healthz self-reference
    health.set_obs_port(server.port)
    m.set("obs_port", server.port)
    print(f"observability plane on port {server.port} "
          f"(/metrics /healthz /events"
          f"{' /profile' if profiler is not None else ''})",
          file=sys.stderr)
    return health, server


def run_classify(args) -> ServeSummary:
    from .device import resolve_device
    from .io.checkpoint import load_model
    from .models import SUBCOMMAND_ALIASES
    from .obs import FlightRecorder, Tracer
    from .utils.metrics import global_metrics as m

    _check_flags(args)
    # --shards >= 1 is the sharded spine; 1 is an EXPLICIT single-shard
    # mesh (the sharded engine and read steps on one device)
    sharded = args.shards >= 1
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
    if _provenance_on(args, sharded):
        from .obs import LatencyProvenance

        lat = LatencyProvenance(metrics=m, recorder=recorder,
                                slo_s=args.latency_slo)
    # the device plane is armed BEFORE the engine is built, so the flow
    # table's allocation shows in its memory readings
    dev, perf, profiler = _device_plane(args, m, recorder, device)
    engine = _build_engine(args, device, recorder, predict, serve_params)
    # The degradation ladder wraps the kernel predict, built BEFORE warmup
    # so warmup routes through it (its first device call, on its grace
    # deadline, happens there, and its host rung is primed). 'auto' skips
    # the serves with no device rung to demote from: sharded (the engine
    # runs its own per-shard predicts) and host-native ones.
    degrade = None
    if (args.degrade != "off" and not sharded
            and not getattr(predict, "host_native", False)):
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
    drift = openset = actuation = drift_feed = None
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
            if dev is not None:
                dev.mark_warmup_complete()
        # the drift loop and the open-set gate wrap the predict AFTER
        # warmup primed the boot model, and before the label cache, which
        # watches their label_epoch
        predict, drift, degrade_surface, drift_feed = _drift_loop(
            args, model, predict, degrade, engine, device, m, recorder)
        predict, model, openset = _openset_gate(
            args, model, predict, drift, engine, m, recorder)
        inc = None
        if args.incremental != "off" and not sharded:
            from .serving.incremental import IncrementalLabels

            inc = IncrementalLabels(engine, predict, serve_params,
                                    degrade=degrade_surface, metrics=m,
                                    recorder=recorder, tracer=tracer)
        actuation = _actuation_plane(args, model, engine, m, recorder)
        health, server = _start_exposition(
            args, m, recorder, degrade_surface, inc, lat, drift=drift,
            openset=openset, actuation=actuation, dev=dev,
            profiler=profiler)
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
        from .utils.profiling import trace

        try:
            with obs_faults, trace(args.profile_dir, device):
                summary = _serve_loop(
                    args, engine, model, predict, serve_params, inc,
                    degrade=degrade_surface, m=m, tracer=tracer,
                    recorder=recorder, health=health, lat=lat, usr1=usr1,
                    drift=drift, openset=openset, dev=dev, perf=perf,
                    actuation=actuation, drift_feed=drift_feed)
        except BaseException as e:
            # the crash-forensics moment, outside any signal frame: a
            # SystemExit is a dump only when the SIGTERM hook raised it
            if recorder is not None:
                if sigterm_seen and isinstance(e, SystemExit):
                    recorder.record("signal.sigterm")
                    _dump_flight(recorder, args.obs_dir, "sigterm")
                    _dump_device(dev, perf, args.obs_dir, "sigterm")
                elif not isinstance(e, SystemExit):
                    recorder.record("serve.exception",
                                    error=type(e).__name__, detail=str(e))
                    reason = ("keyboard-interrupt"
                              if isinstance(e, KeyboardInterrupt)
                              else "serve-exception")
                    _dump_flight(recorder, args.obs_dir, reason)
                    _dump_device(dev, perf, args.obs_dir, reason)
            raise
        else:
            if recorder is not None:
                if recorder.count("supervisor.terminal"):
                    # the monitor died for good and the source drained:
                    # the loop ends "cleanly", but the trail matters
                    _dump_flight(recorder, args.obs_dir,
                                 "supervisor-terminal")
                    _dump_device(dev, perf, args.obs_dir,
                                 "supervisor-terminal")
                elif args.obs_dump_on_exit:
                    _dump_flight(recorder, args.obs_dir, "on-demand")
                    _dump_device(dev, perf, args.obs_dir, "on-demand")
    finally:
        if server is not None:
            server.stop()
        if perf is not None:
            # commit the partial segment: every recorded tick is on disk
            # before the process goes away (the commit absorbs its own
            # failures)
            perf.flush()
        if dev is not None:
            dev.detach()
        if actuation is not None:
            # the plane only closes its switch link — installed rules
            # stay (a serve restart must not blackhole live traffic by
            # retracting QoS rules it will re-earn in seconds)
            actuation.close()
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
    if actuation is not None:
        summary.actuation = actuation.status()
    return summary


def _drift_loop(args, model, predict, degrade, engine, device, m, recorder):
    """``(predict, drift, degrade_surface, drift_feed)`` under ``--drift
    auto``. On one device: the predict wrapped in a ``DriftGate`` (a
    passthrough until the first promotion, the hot-swap point after it),
    its ``DriftController``, and the ladder surface the render and
    /healthz read (a ``GateLadderView`` that follows promotions); a
    promotion under ``--degrade auto`` rebuilds a ``DegradeLadder`` around
    the candidate's kernel, with its own host rung. On the sharded spine
    the predict runs inside the per-shard read steps, so there is no call
    to wrap: a ``ShardedDriftGate`` installs through
    ``engine.install_predict``, and the serve loop feeds it each render's
    (features, labels) as ``drift_feed``. Under ``--drift off`` the first
    three come back as given and ``drift_feed`` is None."""
    if args.drift == "off":
        return predict, None, degrade, None
    from .serving.drift import (
        DriftController,
        DriftGate,
        GateLadderView,
        ShardedDriftGate,
        default_build_serving,
    )

    build_bare = default_build_serving(model.name, tuple(model.classes.names))

    def build_sharded(params):
        """Candidate params → the serving pair a promotion installs on the
        sharded spine. A host-native candidate can never install there;
        raising makes it a counted retrain failure, not a crash in the
        middle of a promotion."""
        pred, p = build_bare(params)
        if getattr(pred, "host_native", False):
            raise RuntimeError(
                "host-native candidate kernels cannot install on the "
                "sharded spine"
            )
        return pred, p

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

    sharded = args.shards >= 1
    gate = ShardedDriftGate(engine) if sharded else DriftGate(predict)
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
        build_serving=build_sharded if sharded else build_promoted,
        boot_params=model.params,
        metrics=m,
        recorder=recorder,
        follow_rotation=args.drift_follow,
        device=device,
    )
    if sharded:
        return predict, drift, degrade, gate
    surface = GateLadderView(gate, degrade) if degrade is not None else None
    return gate, drift, surface, None


def _openset_gate(args, model, predict, drift, engine, m, recorder):
    """``(predict, model, openset)`` under ``--openset auto``: the
    OUTERMOST predict wrapper (drift promotions hot-swap inside it), the
    model's class list extended by ``unknown`` so every render decodes the
    rejection index, and the gate; a restored serving checkpoint's armed
    reference boots it ARMED. Under ``--openset off`` the first two come
    back as given. 'auto' skips sharded serves: per-row rejection would
    need the unknown index threaded through every per-shard read step."""
    if args.openset == "off" or args.shards >= 1:
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
        if args.capacity is None:
            args.capacity = cfg.ingest.capacity
        if args.shards == 0 and cfg.ingest.shards:
            args.shards = cfg.ingest.shards
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
    if args.scenario is not None:
        return _run_scenario_replay(args, parser)
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


def _run_scenario_replay(args, parser):
    """The --scenario replay hook: run one campaign scenario through the
    real serve composition (scenarios/runner.py) on ``--device`` and
    print its scorecard; exits nonzero on a gate failure, with the
    post-mortem bundle under ``--scenario-obs-dir``. Returns the
    scorecard (None for ``list``)."""
    import json

    from .scenarios import SCENARIOS, build, run_scenario

    if args.scenario == "list":
        for name, builder in SCENARIOS.items():
            print(f"{name}: {builder('t1').title}")
        return None
    if args.scenario not in SCENARIOS:
        parser.error(
            f"--scenario: unknown scenario {args.scenario!r} "
            f"(known: {', '.join(sorted(SCENARIOS))}; "
            f"'list' prints them)"
        )
    card = run_scenario(
        build(args.scenario, args.scenario_profile),
        obs_dir=args.scenario_obs_dir, device=args.device,
    )
    print(json.dumps(card, indent=1, default=repr))
    if not card["passed"]:
        failed = ", ".join(
            g["id"] for g in card["gates"] if not g["passed"]
        )
        sys.exit(f"scenario {args.scenario} FAILED gates: {failed} "
                 f"(post-mortem under {args.scenario_obs_dir}/)")
    return card


if __name__ == "__main__":
    main()

#!/bin/sh
# Sanitizer gate over the PyTorch port's native code: the six C++ phases of
# tools/native_sanitize.sh over the port's own sources (its
# native/*.cpp, built through its own loaders), and four CUDA phases that
# run compute-sanitizer over its three CUDA kernels.
#
# C++ (g++; run anywhere):
#   asan   ASan+UBSan builds of the port's forest_eval.cpp, knn_eval.cpp,
#          svc_eval.cpp and flow_engine.cpp, loaded through the port's
#          LazyLib and
#          driven through its ctypes tables (_SIGNATURES): non-finite and
#          odd-shape inputs, chunk-boundary corpus sizes, the committed
#          reference pickles (tests/data/reference_pickles), freshly fit
#          sklearn forests when sklearn is installed, the SVC host rung
#          bitwise against its plain version at odd shapes, and the engine's
#          namespaced feed, wire flush and bulk slot release (the port
#          releases evicted slots in one call, where JAX's binding
#          releases one at a time). The port's loader names a library by
#          a hash under csrc/build/, where a serve would load it: this
#          phase points the loader at its own work dir, so no sanitized
#          library ever lands there.
#   ubsan, asan_engine, tsan   tools/sanitize_feed_flush.cpp linked
#          against the port's native/flow_engine.cpp, under UBSan,
#          ASan+UBSan and TSan, single- and multi-threaded.
#   knn_asan, knn_tsan   tools/sanitize_knn.cpp linked against the port's
#          native/knn_eval.cpp, under ASan+UBSan and TSan.
#
# CUDA (a card and compute-sanitizer; else "skipped" with the reason):
#   memcheck, racecheck, initcheck, synccheck   compute-sanitizer --tool T
#          --error-exitcode 86 over tools/torch_sanitize_kernels.py: the
#          forest, KNN and RBF kernels through their wrappers and every
#          launch shape at rows 1, 7 and 777, non-finite rows, KNN corpora
#          with k == S and S off the stage, the depth-10 forest, each held
#          bitwise to its plain version. PYTORCH_NO_CUDA_MEMORY_CACHING=1
#          makes every tensor an allocation of its own, so the caching
#          allocator's pooled blocks cannot hide an out-of-bounds access.
#          No kernel-name filter: a report from a libtorch kernel fails
#          the phase too. Where the tool refuses the card ("Device not
#          supported") and its log holds nothing but that refusal (the
#          API calls that then fail, no other report, no case run: see
#          refused_alone in tools/torch_sanitize_kernels.py), the phase
#          is "unsupported" with the tool's words; any other failing
#          log fails the phase.
#   kernel_guards   the same program alone, with the caching allocator on:
#          NaN-padded inputs, outputs in 0xFF-poisoned memory, every case
#          twice (see tools/torch_sanitize_kernels.py).
#
# Exits 0 iff every C++ phase passed and no CUDA phase failed ("skipped"
# and "unsupported" are reported, not failures), and always writes a
# per-phase JSON summary to $NATIVE_SANITIZE_SUMMARY (default: a per-run
# file under $TMPDIR, path echoed on exit). The CUDA kernels are built into
# csrc/build/ (ops/cuda_build.py) before the sanitizer starts.
#
# Usage: sh tools/torch_native_sanitize.sh [--cpp-only | --cuda-only]
cd "$(dirname "$0")/.." || exit 2

TMP="${TMPDIR:-/tmp}"
SUMMARY="${NATIVE_SANITIZE_SUMMARY:-$TMP/torch_native_sanitize_summary.$$.json}"
WORK="$(mktemp -d "$TMP/torch_native_sanitize.XXXXXX")" || exit 2
trap 'rm -rf "$WORK"' EXIT
PORT=traffic_classifier_sdn_tpu_torch/native
RESULTS="$WORK/results"
: > "$RESULTS"
run_cpp=1
run_cuda=1
case "${1:-}" in
  --cpp-only) run_cuda=0 ;;
  --cuda-only) run_cpp=0 ;;
  "") ;;
  *) echo "usage: $0 [--cpp-only | --cuda-only]" >&2; exit 2 ;;
esac

# record <phase> <status> [reason]
record() {
  printf '%s\t%s\t%s\n' "$1" "$2" "${3:-}" >> "$RESULTS"
  echo "--- $1: $2${3:+ ($3)}"
}

if [ "$run_cpp" -eq 1 ]; then
# ---- asan: the port's loaders and ctypes tables under ASan+UBSan ----------
echo "=== phase asan: forest_eval, knn_eval, svc_eval and flow_engine through the port's loaders"
if ASAN_OPTIONS=detect_leaks=0 NATIVE_SANITIZE_WORK="$WORK" \
   LD_PRELOAD="$(g++ -print-file-name=libasan.so)" python - <<'EOF'
import os
from pathlib import Path

import numpy as np

from traffic_classifier_sdn_tpu_torch.native import engine as ne
from traffic_classifier_sdn_tpu_torch.native import forest as nf
from traffic_classifier_sdn_tpu_torch.native import knn as nk
from traffic_classifier_sdn_tpu_torch.native import loader
from traffic_classifier_sdn_tpu_torch.native import svc as ns

WORK = Path(os.environ["NATIVE_SANITIZE_WORK"])
loader.BUILD_DIR = WORK  # every sanitized build lands in the work dir
SAN = ("-O1", "-g", "-fsanitize=address,undefined",
       "-fno-sanitize-recover=all")
nf._lazy = loader.LazyLib(nf.SOURCE, "asan forest", flags=SAN)
nk._lazy = loader.LazyLib(nk.SOURCE, "asan knn",
                          flags=SAN + ("-march=native",))
ne._lazy = loader.LazyLib(ne.SOURCE, "asan engine", flags=SAN + ("-pthread",))
ns._lazy = loader.LazyLib(ns.SOURCE, "asan svc",
                          flags=SAN + ("-march=native", "-ffp-contract=off"))
for lazy in (nf._lazy, nk._lazy, ne._lazy, ns._lazy):
    assert lazy.path.parent == WORK, lazy.path

rng = np.random.RandomState(0)
bad = np.zeros((13, 12), np.float32)
bad[0] = -np.inf; bad[1] = np.nan; bad[2] = np.inf

from traffic_classifier_sdn_tpu_torch.io import sklearn_import as ski

pickles = Path("tests/data/reference_pickles")
f = nf.NativeForest(ski.import_forest(str(pickles / "RandomForestClassifier")))
X = np.asarray(rng.rand(300, 12) * 1e3, np.float32)
f.predict(X)
f.predict_proba(X[:256])
for Xs in (bad, X[:1], X[:8], X[:255], X[:257]):
    f.predict(Xs)
f.close()
h = nk.NativeKnn(ski.import_knn(str(pickles / "KNeighbors")))
# 8 = exactly one query block (kQueryBlock): the no-tail path
for Xs in (X, X[:1], X[:7], X[:8], X[:9], bad):
    h.predict(Xs)
h.close()
print("reference pickles: asan/ubsan clean", flush=True)

for S in (5, 255, 256, 257, 511, 513):
    hh = nk.NativeKnn({
        "fit_X": rng.rand(S, 12),
        "y": rng.randint(0, 6, S).astype(np.int32),
        "n_neighbors": 5, "classes": np.arange(6),
    })
    hh.predict(np.asarray(rng.rand(33, 12), np.float32))
    hh.predict(np.asarray(rng.rand(16, 12), np.float32))  # N % 8 == 0
    hh.predict(bad)
    hh.close()
print("knn: asan/ubsan clean", flush=True)

import torch

import chip_smoke
from traffic_classifier_sdn_tpu_torch import interop
from traffic_classifier_sdn_tpu_torch.ops import rbf_kernel as rk

for S in (6, 45, 257):  # 6: one vector a class
    g = rk.compile_svc(interop.svc_params_from_numpy(
        chip_smoke.random_svc(0, X, n_sv=S), "cpu"))
    hs = ns.NativeSvc(g)
    # 1023, 1024 and 1025 rows: either side of the decision loop's block
    for Xs in (X[:0], X[:1], X[:7], bad, np.tile(X, (4, 1))[:1023],
               np.tile(X, (4, 1))[:1024], np.tile(X, (4, 1))[:1025]):
        got = hs.partial(Xs)
        want = rk.partial_decision_plain(g, torch.from_numpy(
            np.ascontiguousarray(Xs)))
        assert torch.equal(got.contiguous().view(torch.int32),
                           want.contiguous().view(torch.int32)), (S, len(Xs))
print("svc: asan/ubsan clean, bitwise its plain version", flush=True)

try:
    import warnings
    warnings.filterwarnings("ignore")
    from sklearn.ensemble import RandomForestClassifier
except ImportError:
    print("NOTE: sklearn absent: no freshly fit forests", flush=True)
else:
    for t in range(3):
        Xt = rng.randint(0, 5, (300, 12)).astype(np.float64)
        yt = rng.randint(0, 4, 300)
        est = RandomForestClassifier(
            n_estimators=6, max_depth=None if t % 2 else 4, random_state=t,
        ).fit(Xt, yt)
        ff = nf.NativeForest(ski.forest_dict_from_estimator(est))
        ff.predict(np.asarray(rng.rand(77, 12) * 6, np.float32))
        ff.predict(bad)
        ff.close()
    print("irregular-forest remap: asan/ubsan clean", flush=True)

# the engine through the port's own ctypes table: namespaced feeds, the
# packed wire flush, eviction by source (bulk slot release), idle
# eviction, the index export and import
from traffic_classifier_sdn_tpu_torch.ingest.batcher import FlowStateEngine
from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows

eng = FlowStateEngine(512, device="cpu", native=True)
gens = [SyntheticFlows(40, seed=s, mac_base=s * 40) for s in range(3)]
for tick in range(4):
    eng.mark_tick()
    for sid, g in enumerate(gens):
        data = g.tick_bytes()
        cut = len(data) // 3  # a chunk split mid-line
        eng.ingest_bytes(data[:cut], sid)
        eng.ingest_bytes(data[cut:] + b"data\tgarbage\n", sid)
    eng.step()
assert eng.num_flows() == 120, eng.num_flows()
assert eng.evict_source(1) == 40
b = eng.batcher
fp, used, next_slot, free = b.export_index()
slots = np.flatnonzero(used).astype(np.uint32)
src, dst = b.export_meta(slots)
fresh = ne.NativeBatcher(512)
fresh.import_index(slots, fp[slots], src, dst, next_slot, b.last_time,
                   free)
assert fresh.num_flows() == b.num_flows() == 80, fresh.num_flows()
assert eng.evict_idle(now=eng.last_time + 10_000, idle_seconds=1) == 80
print(f"engine: asan/ubsan clean ({eng.parse_errors()} malformed lines "
      f"counted, {slots.size} slots exported and imported)", flush=True)
EOF
then record asan pass; else record asan fail; fi

# ---- ubsan / asan_engine / tsan: the feed/flush driver ---------------------
echo "=== phase ubsan: flow_engine under UBSan (single + multi thread)"
if g++ -O1 -g -fsanitize=undefined -fno-sanitize-recover=all \
     -std=c++17 -pthread -o "$WORK/tc_ubsan_drv" \
     tools/sanitize_feed_flush.cpp "$PORT/flow_engine.cpp" \
   && "$WORK/tc_ubsan_drv" && TC_ENGINE_THREADS=4 "$WORK/tc_ubsan_drv"
then record ubsan pass; else record ubsan fail; fi

echo "=== phase asan_engine: flow_engine driver under ASan+UBSan"
if g++ -O1 -g -fsanitize=address,undefined -fno-sanitize-recover=all \
     -std=c++17 -pthread -o "$WORK/tc_asan_drv" \
     tools/sanitize_feed_flush.cpp "$PORT/flow_engine.cpp" \
   && ASAN_OPTIONS=detect_leaks=0 "$WORK/tc_asan_drv" \
   && ASAN_OPTIONS=detect_leaks=0 TC_ENGINE_THREADS=4 "$WORK/tc_asan_drv"
then record asan_engine pass; else record asan_engine fail; fi

echo "=== phase tsan: concurrent feed/flush under TSan"
if g++ -O1 -g -fsanitize=thread -std=c++17 -pthread \
     -o "$WORK/tc_tsan_drv" \
     tools/sanitize_feed_flush.cpp "$PORT/flow_engine.cpp" \
   && TSAN_OPTIONS=halt_on_error=1 "$WORK/tc_tsan_drv" \
   && TSAN_OPTIONS=halt_on_error=1 TC_ENGINE_THREADS=4 "$WORK/tc_tsan_drv"
then record tsan pass; else record tsan fail; fi

# ---- knn_asan / knn_tsan: the pruned/IVF KNN driver ------------------------
echo "=== phase knn_asan: pruned/IVF knn_eval driver under ASan+UBSan"
if g++ -O1 -g -fsanitize=address,undefined -fno-sanitize-recover=all \
     -std=c++17 -pthread -o "$WORK/knn_asan_drv" \
     tools/sanitize_knn.cpp "$PORT/knn_eval.cpp" \
   && ASAN_OPTIONS=detect_leaks=0 "$WORK/knn_asan_drv" \
   && ASAN_OPTIONS=detect_leaks=0 TC_KNN_THREADS=4 "$WORK/knn_asan_drv"
then record knn_asan pass; else record knn_asan fail; fi

echo "=== phase knn_tsan: concurrent knn_eval predicts under TSan"
if g++ -O1 -g -fsanitize=thread -std=c++17 -pthread \
     -o "$WORK/knn_tsan_drv" \
     tools/sanitize_knn.cpp "$PORT/knn_eval.cpp" \
   && TSAN_OPTIONS=halt_on_error=1 TC_KNN_THREADS=4 "$WORK/knn_tsan_drv"
then record knn_tsan pass; else record knn_tsan fail; fi
fi

if [ "$run_cuda" -eq 1 ]; then
# ---- the CUDA kernels under compute-sanitizer -----------------------------
SANITIZER="${COMPUTE_SANITIZER:-}"
if [ -z "$SANITIZER" ]; then
  for c in "${CUDA_HOME:-/usr/local/cuda}/bin/compute-sanitizer" \
           "$(command -v compute-sanitizer 2>/dev/null)"; do
    if [ -n "$c" ] && [ -x "$c" ]; then SANITIZER="$c"; break; fi
  done
fi
# cuda: "ready", or why the CUDA phases cannot run
if ! python -c 'import sys, torch; sys.exit(0 if torch.cuda.is_available() else 1)' 2>/dev/null; then
  cuda="no CUDA device"
elif ! python -c 'from traffic_classifier_sdn_tpu_torch.ops import cuda_build; cuda_build.build(["forest_proba", "knn_topk", "rbf_decision"])'; then
  cuda="build failed"
else
  cuda=ready
fi
for tool in memcheck racecheck initcheck synccheck; do
  echo "=== phase $tool: compute-sanitizer over the three CUDA kernels"
  log="$WORK/$tool.log"
  if [ "$cuda" = "build failed" ]; then
    record "$tool" fail "the CUDA kernels did not build"
  elif [ "$cuda" != ready ]; then
    record "$tool" skipped "$cuda"
  elif [ -z "$SANITIZER" ]; then
    record "$tool" skipped "compute-sanitizer not found"
  elif PYTORCH_NO_CUDA_MEMORY_CACHING=1 "$SANITIZER" --tool "$tool" \
       --error-exitcode 86 python tools/torch_sanitize_kernels.py \
       > "$log" 2>&1; then
    tail -n 3 "$log"
    record "$tool" pass
  elif refusal="$(python -c 'import sys; sys.path.insert(0, "tools")
from torch_sanitize_kernels import refused_alone
r = refused_alone(open(sys.argv[1], errors="replace").read())
print(r or "")
sys.exit(r is None)' "$log")"; then
    tail -n 5 "$log"
    record "$tool" unsupported "$refusal"
  else
    tail -n 40 "$log"
    record "$tool" fail "see the tool's report above"
  fi
done
echo "=== phase kernel_guards: the three CUDA kernels alone, padded and poisoned"
if [ "$cuda" = "build failed" ]; then
  record kernel_guards fail "the CUDA kernels did not build"
elif [ "$cuda" != ready ]; then
  record kernel_guards skipped "$cuda"
elif python tools/torch_sanitize_kernels.py > "$WORK/guards.log" 2>&1; then
  tail -n 1 "$WORK/guards.log"
  record kernel_guards pass
else
  tail -n 20 "$WORK/guards.log"
  record kernel_guards fail "see tools/torch_sanitize_kernels.py's output above"
fi
fi

# ---- summary ---------------------------------------------------------------
python - "$RESULTS" "$SUMMARY" <<'EOF'
import json, sys
results, out = sys.argv[1:3]
phases = []
with open(results) as f:
    for line in f:
        name, status, reason = line.rstrip("\n").split("\t")
        phases.append({"name": name, "status": status,
                       **({"reason": reason} if reason else {})})
cpp = {"asan", "ubsan", "asan_engine", "tsan", "knn_asan", "knn_tsan"}
ok = (all(p["status"] == "pass" for p in phases if p["name"] in cpp)
      and not any(p["status"] == "fail" for p in phases))
summary = {"phases": phases, "ok": ok}
with open(out, "w") as f:
    json.dump(summary, f, indent=2)
print(json.dumps(summary))
sys.exit(0 if ok else 1)
EOF
rc=$?
if [ "$rc" -eq 0 ]; then
  echo "torch_native_sanitize: clean (summary: $SUMMARY)"
  exit 0
fi
echo "torch_native_sanitize: FAILURES (summary: $SUMMARY)" >&2
exit 1

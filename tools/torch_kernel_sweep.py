#!/usr/bin/env python3
"""Launch-shape sweep of the port's forest, KNN top-k and RBF-SVC kernels
on one CUDA card.

    python3 tools/torch_kernel_sweep.py [--sizes 33,777,3000,...]
        [--kernels forest,knn,svc]

Runs from the root of a checkout, on the models and served features that
``chip_smoke.py`` builds (seeded; reference checkpoint shapes). For each
size it checks every launch shape the wrappers can take (forest rows per
tile, with as many trees per stage as fit; KNN rows per warp; SVC rows
per block) against the plain version on the card
(bitwise), times each one (CUDA-event median of 20 calls, the best of 3
such medians), and names the shape the wrapper chooses and the fastest.
It first prints the host time of one call of each selected kernel's
wrapper at 16 and 777 rows (the smallest dirty bucket of incremental
labels, and a size below a wave), and of two parts of the forest's at 777
rows (host clock, median of 2,000 calls, each from an idle device).
The default sizes include one at which each shape is the one chosen:
forest 32 rows per tile at 33 to 6,000 rows, 128 at 12,000 and 65,536,
1024 (a thread per row) at 131,072 and 2^20; KNN 1 row per warp at 33
and 777 rows, 2 at 3,000, 4 at 6,000 and 12,000, 16 from 65,536; SVC 4
rows per block at 33 and 777, 16 at 3,000 and 6,000, 64 from 12,000.
For KNN it also counts, per row, the 128-record chunks in which some
candidate beats the row's running k-th similarity: the chunks that take
the kernel's insertion path (the first chunk of the corpus fills the
empty list instead and is not counted). Prints the card's name and power
limit first, and last the range of the SM clock that ``nvidia-smi``
sampled every 500 ms during the sweep. Imports nothing of JAX; needs the
CUDA toolkit (``nvcc``).
"""

from __future__ import annotations

import argparse
import pathlib
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from traffic_classifier_sdn_tpu_torch import interop  # noqa: E402
from traffic_classifier_sdn_tpu_torch.core import flow_table as ft  # noqa: E402
from traffic_classifier_sdn_tpu_torch.ops import cuda_build  # noqa: E402
from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk  # noqa: E402
from traffic_classifier_sdn_tpu_torch.ops import knn_kernel as kk  # noqa: E402
from traffic_classifier_sdn_tpu_torch.ops import rbf_kernel as rk  # noqa: E402


def best_ms(fn) -> float:
    return min(cs.cuda_median_ms(fn, 20) for _ in range(3))


def insertion_chunks(g, X: torch.Tensor, rows: int = 4096) -> float:
    """Mean count, over the first ``rows`` rows, of the chunks after the
    first in which a similarity beats the k-th best of all earlier
    chunks (the plain version's similarity)."""
    from traffic_classifier_sdn_tpu_torch.models import knn

    sim = knn.dot_expansion_sim(X[:rows], g.fit_X, g.half_sq)
    k, total = g.n_neighbors, torch.zeros(sim.shape[0], device=X.device)
    for lo in range(kk.CHUNK, g.n_rows, kk.CHUNK):
        kth = torch.topk(sim[:, :lo], k, dim=1).values[:, -1]
        total += (sim[:, lo: lo + kk.CHUNK] > kth[:, None]).any(1)
    return float(total.mean())


def sweep_forest(k, X: torch.Tensor) -> int:
    """Times every forest launch shape on X (bitwise checked); returns the
    count of shapes that were not bitwise equal."""
    N, failed, times = X.shape[0], 0, {}
    want = fk.forest_proba_plain(k, X)
    for R in fk.ROWS_PER_TILE:
        per_chunk = fk.trees_per_chunk(k, R)
        got = fk._launch(k, X, R, per_chunk)
        ok = torch.equal(got.view(torch.int32), want.view(torch.int32))
        failed += not ok
        times[R] = best_ms(lambda: fk._launch(k, X, R, per_chunk))
        print(f"forest_proba N={N} rows_per_tile={R} trees_per_chunk="
              f"{per_chunk} blocks={fk.blocks(N, R)}x{fk.threads(R)} "
              f"bitwise={ok} {times[R]:.4f} ms")
    print(f"forest_proba N={N} chosen: {fk.launch_shape(N, k)[0]} rows per "
          f"tile; fastest: {min(times, key=times.get)}")
    return failed


def host_us(fn, calls: int = 2000) -> float:
    """Host time of one call of ``fn`` in microseconds: the median over
    ``calls`` calls, each on the host clock from an idle device
    (synchronized before the call and not waited for within it: a launch
    returns once it is queued). One call at a time, so a full launch
    queue never makes the host wait for the device."""
    for _ in range(100):
        fn()
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


HOST_ROWS = (16, 777)


def host_work(wrappers: dict, X_cap: torch.Tensor) -> None:
    """Prints the host time of one call of each wrapper (name → fn(X)) on
    the first rows of X_cap, at each size of ``HOST_ROWS``."""
    for N in HOST_ROWS:
        X = X_cap[:N].contiguous()
        times = ", ".join(f"{name} {host_us(lambda: fn(X)):.2f} us"
                          for name, fn in wrappers.items())
        print(f"host work of one wrapper call at N={N}: {times}")


def forest_host_work(k, X: torch.Tensor) -> None:
    """Prints the host time of two parts of a forest wrapper call on X:
    the output's allocation and the current stream's raw handle, beside
    what building the Python Stream object would cost."""
    N, dev = X.shape[0], X.device
    parts = {
        "torch.empty of the output": lambda: torch.empty(
            (N, k.n_classes), dtype=torch.float32, device=dev),
        "raw stream handle": lambda: torch._C._cuda_getCurrentRawStream(
            dev.index),
        "torch.cuda.current_stream().cuda_stream": lambda: (
            torch.cuda.current_stream().cuda_stream),
    }
    times = ", ".join(f"{name} {host_us(fn):.2f} us"
                      for name, fn in parts.items())
    print(f"forest_proba host work at N={N}: {times}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes",
                    default="33,777,3000,6000,12000,65536,131072,1048576")
    ap.add_argument("--kernels", default="forest,knn,svc")
    args = ap.parse_args()
    sizes = [int(s) for s in args.sizes.split(",")]
    kernels = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        print("torch_kernel_sweep: no CUDA device is visible", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    cuda_build.build([fk.KERNEL, kk.KERNEL, rk.KERNEL])
    dev = torch.device("cuda")
    cap, big = cs.CAPACITY, max(sizes)
    X_cap = ft.features12(cs.synthetic_table(cap, 3, dev))
    X_big = ft.features12(cs.synthetic_table(big, 3, dev)) if big > cap else X_cap
    sample = X_cap[torch.randperm(
        cap, generator=torch.Generator().manual_seed(cs.SEED)
    )[:4096].to(dev)].cpu().numpy()
    gf = fk.compile_forest(cs.random_forest(cs.SEED, sample),
                           n_features=cs.N_FEATURES, device=dev)
    gk = kk.compile_knn(interop.knn_params_from_numpy(cs.random_knn(cs.SEED, sample), dev))
    gs = rk.compile_svc(interop.svc_params_from_numpy(cs.random_svc(cs.SEED, sample), dev))
    if "knn" in kernels:
        print(f"knn: chunks taking the insertion path per row (of "
              f"{-(-gk.n_rows // kk.CHUNK)}): {insertion_chunks(gk, X_cap):.2f}")
    clocks = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
         "-lms", "500"], stdout=subprocess.PIPE, text=True)
    failed = 0
    wrappers = {  # kernel → (wrapper name, call)
        "forest": ("forest_proba", lambda X: fk.forest_proba(gf, X)),
        "knn": ("topk_sim_idx", lambda X: kk.topk_sim_idx(gk, X)),
        "svc": ("partial_decision", lambda X: rk.partial_decision(gs, X)),
    }
    host_work(dict(w for name, w in wrappers.items() if name in kernels),
              X_cap)
    if "forest" in kernels:
        forest_host_work(gf, X_cap[:777].contiguous())
    for N in sizes:
        X = (X_cap if N <= cap else X_big)[:N].contiguous()
        if "forest" in kernels:
            failed += sweep_forest(gf, X)
        if "knn" in kernels:
            want_v, want_i = kk.topk_sim_idx_plain(gk, X)
            times = {}
            for rw in kk.rows_per_warp_choices(gk.n_neighbors):
                v, i = kk._launch(gk, X, rw)
                ok = torch.equal(i, want_i) and torch.equal(
                    v.view(torch.int32), want_v.view(torch.int32))
                failed += not ok
                times[rw] = best_ms(lambda: kk._launch(gk, X, rw))
                print(f"knn_topk N={N} rows_per_warp={rw} "
                      f"blocks={kk.blocks(N, rw)} bitwise={ok} {times[rw]:.4f} ms")
            print(f"knn_topk N={N} chosen: {kk.launch_shape(N, gk.n_neighbors)} "
                  f"rows per warp; fastest: {min(times, key=times.get)}")
        if "svc" in kernels:
            want = rk.partial_decision_plain(gs, X)
            times = {}
            for R in rk.ROWS_PER_BLOCK:
                got = rk._launch(gs, X, None, R)
                ok = torch.equal(got.view(torch.int32), want.view(torch.int32))
                failed += not ok
                times[R] = best_ms(lambda: rk._launch(gs, X, None, R))
                print(f"rbf_decision N={N} rows_per_block={R} blocks={-(-N // R)} "
                      f"bitwise={ok} {times[R]:.4f} ms")
            print(f"rbf_decision N={N} chosen: {rk.launch_shape(N)} rows per "
                  f"block; fastest: {min(times, key=times.get)}")
    clocks.terminate()
    mhz = [int(v) for v in clocks.communicate()[0].split() if v.isdigit()]
    print(f"SM clock during the sweep: {min(mhz, default=0)}-"
          f"{max(mhz, default=0)} MHz ({len(mhz)} samples)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

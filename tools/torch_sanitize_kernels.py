#!/usr/bin/env python
"""The three CUDA kernels driven at small odd shapes, each result held
bitwise to its plain version: the program that ``tools/
torch_native_sanitize.sh`` runs under ``compute-sanitizer`` (memcheck,
racecheck, initcheck, synccheck), and alone as the ``kernel_guards``
phase.

Cases, through each kernel's wrapper and through every launch shape its
private ``_launch`` forces:

- rows 1, 7 and 777, finite and with NaN/+inf/-inf features in every third
  row;
- the forest of the reference checkpoint's shape (16 trees, depth <= 14)
  and a depth-10 forest fitted by ``train.forest.fit`` (perfect-layout
  node stacks, as a drift promotion serves);
- KNN corpora with k == S (5 rows, k 5), S not a multiple of the 512-row
  stage (777 rows, k 5) and a list of four slots a lane (777 rows, k 33);
- an RBF-SVC whose 45 support vectors are not a multiple of its 32-row
  stage.

Every input sits inside a larger buffer padded with NaN rows, so a read
past either end changes a result. Run alone (the caching allocator on),
each output block is first filled with 0xFF bytes and freed, so an output
element a kernel leaves unwritten reads back as NaN or -1 and disagrees
with the plain version. Each case runs twice and must give the same bits.
Under compute-sanitizer, run with ``PYTORCH_NO_CUDA_MEMORY_CACHING=1`` so
that every tensor is an allocation of its own the tool can bound.

Prints one line per case and ``kernel guards: N cases, all bitwise equal``
last; exits 1 on the first disagreement, and 2 without a card.

``refused_alone(log)`` reads a compute-sanitizer log of this program and
says whether it holds nothing but the tool's refusal of the card: the
shell gate records such a phase ``unsupported``, and any other failing
log ``fail``.
"""

from __future__ import annotations

import argparse
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = (1, 7, 777)
PAD = 64  # NaN rows before and after every input


REFUSAL = "Device not supported"
# What a refused card leaves in the tool's report: its banner and the
# refusal, the CUDA API calls that then fail with their host backtraces
# (memcheck), the program's failed exit (racecheck counts it as a
# hazard in its summary), and the summary. Any other report (an invalid
# access, a race, an uninitialized read, a barrier error) is the tool
# checking a kernel.
_REFUSAL_REPORT = re.compile(
    r"=+\s*(?:$|COMPUTE-SANITIZER$|Error: Device not supported"
    r"|Program hit cudaError\w+ \(error \d+\) due to \".*\" on CUDA API "
    r"call to \w+\.$|Saved host backtrace|Host Frame:"
    r"|Error: process didn't terminate successfully$"
    r"|The application may have hit an error when dereferencing Unified "
    r"Memory from the host\."
    r"|Target application returned an error$|ERROR SUMMARY: \d+ errors?$"
    r"|RACECHECK SUMMARY: \d+ hazards? displayed \(\d+ errors?, "
    r"\d+ warnings?\)$)")


def refused_alone(log: str) -> str | None:
    """The tool's refusal, stripped of its ``=`` prefix, when ``log``
    holds nothing but that refusal and no case of this program ran; else
    None."""
    lines = log.splitlines()
    refusal = next((ln for ln in lines if REFUSAL in ln), None)
    if refusal is None or any("bitwise equal" in ln for ln in lines):
        return None
    if not all(_REFUSAL_REPORT.match(ln) for ln in lines
               if ln.startswith("=")):
        return None
    return refusal.lstrip("= ").strip()


def _bits(t):
    import torch

    t = t.contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b) -> bool:
    import torch

    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _padded(X):
    """X inside a buffer with PAD NaN rows on each side (a contiguous
    view)."""
    import torch

    buf = torch.full((X.shape[0] + 2 * PAD, X.shape[1]), float("nan"),
                     dtype=X.dtype, device=X.device)
    buf[PAD:PAD + X.shape[0]] = X
    return buf[PAD:PAD + X.shape[0]]


def _poison(device) -> None:
    """Fill freed blocks of both allocator pools with 0xFF bytes, so that
    the next ``torch.empty`` of an output hands out poisoned memory."""
    import torch

    if os.environ.get("PYTORCH_NO_CUDA_MEMORY_CACHING") == "1":
        return
    held = [torch.full((n,), 0xFF, dtype=torch.uint8, device=device)
            for n in [512] * 256 + [1 << 16] * 16 + [1 << 21] * 4]
    del held


def _inputs(sample, device):
    """{name: X}: each row count finite and with non-finite rows."""
    import torch

    out = {}
    for n in ROWS:
        X = torch.from_numpy(sample[:n].copy()).to(device)
        out[f"{n} rows"] = X
        bad = X.clone()
        bad[0::3, 0] = float("nan")
        bad[1::3, 3] = float("inf")
        bad[2::3, 7] = float("-inf")
        out[f"{n} rows non-finite"] = bad
    return out


def _cases(device):
    """(kernel, what, run, plain) for every case."""
    import numpy as np

    import chip_smoke
    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
    from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk
    from traffic_classifier_sdn_tpu_torch.ops import knn_kernel as kk
    from traffic_classifier_sdn_tpu_torch.ops import rbf_kernel as rk
    from traffic_classifier_sdn_tpu_torch.train import forest as tforest

    seed = chip_smoke.SEED
    sample = ft.features12(
        chip_smoke.synthetic_table(1024, 3, "cpu")).numpy()[:777]
    sample = np.ascontiguousarray(sample, np.float32)
    inputs = _inputs(sample, device)
    on_card = device.type == "cuda"

    rng = np.random.RandomState(seed)
    fitted = tforest.fit(sample, rng.randint(0, 6, sample.shape[0]), 6,
                         n_trees=8, max_depth=10, seed=seed, device="cpu")
    forests = {
        "forest 16 trees": fk.compile_forest(
            chip_smoke.random_forest(seed, sample, n_trees=16),
            n_features=12, device=device),
        "forest depth 10": fk.compile_forest(
            fitted.node_arrays(), n_features=12, device=device),
    }
    for name, k in forests.items():
        shapes = sorted({(r, k.per_chunk[r]) for r in k.per_chunk})
        for what, X in inputs.items():
            yield ("forest_proba", f"{name}, {what}",
                   lambda k=k, X=X: fk.forest_proba(k, _padded(X)),
                   lambda k=k, X=X: chip_smoke.plain_forest_proba(k, X))
            for rows, chunk in shapes if on_card else ():
                yield ("forest_proba",
                       f"{name}, {what}, {rows} rows/tile {chunk} trees",
                       lambda k=k, X=X, r=rows, c=chunk: fk._launch(
                           k, _padded(X), r, c),
                       lambda k=k, X=X: chip_smoke.plain_forest_proba(k, X))

    corpora = {"knn S 5 k 5": (5, 5), "knn S 777 k 5": (777, 5),
               "knn S 777 k 33": (777, 33)}
    for name, (S, k_nb) in corpora.items():
        g = kk.compile_knn(interop.knn_params_from_numpy(
            chip_smoke.random_knn(seed, sample, n_rows=S, n_neighbors=k_nb),
            device))
        for what, X in inputs.items():
            yield ("knn_topk", f"{name}, {what}",
                   lambda g=g, X=X: kk.topk_sim_idx(g, _padded(X)),
                   lambda g=g, X=X: kk.topk_sim_idx_plain(g, X))
            for rpw in kk.rows_per_warp_choices(k_nb) if on_card else ():
                yield ("knn_topk", f"{name}, {what}, {rpw} rows/warp",
                       lambda g=g, X=X, r=rpw: kk._launch(g, _padded(X), r),
                       lambda g=g, X=X: kk.topk_sim_idx_plain(g, X))

    g = rk.compile_svc(interop.svc_params_from_numpy(
        chip_smoke.random_svc(seed, sample, n_sv=45), device))
    for what, X in inputs.items():
        yield ("rbf_decision", f"svc 45 vectors, {what}",
               lambda X=X: rk.partial_decision(g, _padded(X)),
               lambda X=X: rk.partial_decision_plain(g, X))
        for rpb in rk.ROWS_PER_BLOCK if on_card else ():
            yield ("rbf_decision", f"svc 45 vectors, {what}, {rpb} rows/block",
                   lambda X=X, r=rpb: rk._launch(g, _padded(X), None, r),
                   lambda X=X: rk.partial_decision_plain(g, X))


def main() -> int:
    argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]).parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("kernel guards: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    n = 0
    for kernel, what, run, plain in _cases(device):
        _poison(device)
        first = run()
        _poison(device)
        second = run()
        want = plain()
        torch.cuda.synchronize()
        if not (_same(first, want) and _same(second, first)):
            print(f"kernel guards: {kernel} {what}: NOT bitwise equal to "
                  "its plain version (or to its own second run)", flush=True)
            return 1
        n += 1
        print(f"[{kernel}] {what}: bitwise equal, twice", flush=True)
    print(f"kernel guards: {n} cases, all bitwise equal", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

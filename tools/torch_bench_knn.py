#!/usr/bin/env python
"""KNN bench of the PyTorch port: the exact tier's parity A/B and the IVF
recall sweep. The twin of ``tools/bench_knn.py``: the same flags, the same
two JSON lines (``"artifact": "knn_prune"`` and ``"knn_ivf_recall"``) with
the same keys, measured on the port (on the card unless ``--device cpu``).

- The EXACT tier. The port's native C++ evaluator
  (``native/knn_eval.cpp``): pruned against unpruned on the same handle,
  vote-for-vote parity ENFORCED (nonzero exit on any divergence), plus
  label parity against the sort tier. The torch tiers: ``screened``
  against ``sort`` at the serving batch, and the serving default, the
  port's KNN kernel (``ops/knn_kernel.py``; on the card
  ``csrc/knn_topk.cu``), each held bitwise, by neighbour index, to the
  ``lax.top_k`` oracle's torch form: ``torch.topk`` over the float bits'
  total-order key (``models/knn.total_order_key``) with ties to the
  lowest index. Any index that differs ends the run nonzero.

- The APPROXIMATE tier (``ops/knn_ivf.py``, ``--knn-topk ivf``): an nprobe
  sweep with measured recall@1, label agreement against the exact sort
  path and rates of the torch tier (under the JAX tool's ``xla_*`` keys)
  and the native mirror; nprobe ==
  n_lists must be bitwise the exact search, and ``DEFAULT_NPROBE`` must
  clear 0.99 recall@1 (nonzero exit otherwise).

Corpus: the KNeighbors checkpoint under ``$TCSDN_MODELS_DIR``, else the
committed ``tests/data/reference_pickles/``; with neither, a
conversation-structured synthetic at reference scale (S=4448, k=5).

The two lines are written to ``--out-prune`` / ``--out-recall`` (default
``docs/artifacts/torch_knn_prune.json`` and
``docs/artifacts/torch_knn_ivf_recall.json``).

Usage: python tools/torch_bench_knn.py [--batch 16384] [--repeat 3]
       [--out-prune PATH] [--out-recall PATH] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from torch_bench_common import (
    add_device_arg,
    device_fields,
    models_dir,
    resolve_device,
    sync,
)


def _flow_corpus(rng, S, n_cls=6, rows_per_conv=8):
    """Conversation-structured corpus: per-flow cumulative snapshots."""
    import numpy as np

    theta = rng.gamma(2.0, 100.0, (n_cls, 12))
    conv = max(1, S // rows_per_conv)
    ccls = rng.randint(0, n_cls, conv)
    base = rng.gamma(2.0, 1.0, (conv, 12)) * theta[ccls]
    rows, ys = [], []
    for i in range(conv):
        t = np.sort(rng.uniform(0.1, 1.0, rows_per_conv))[:, None]
        rows.append(np.abs(
            base[i] * t * (1 + rng.normal(0, 0.02, (rows_per_conv, 12)))
        ))
        ys += [int(ccls[i])] * rows_per_conv
    X = np.concatenate(rows)[:S].astype(np.float64)
    return X, np.asarray(ys[:S], np.int32)


def _median_rate(fn, n_rows, repeat, device=None):
    best = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        fn()
        if device is not None:
            sync(device)
        best.append(time.perf_counter() - t0)
    best.sort()
    return n_rows / best[len(best) // 2]


IVF_CHUNK = 2048  # query rows per IVF call: its (N, nprobe·L) gathers


def in_chunks(fn, X, chunk: int = IVF_CHUNK):
    """``fn`` over ``chunk``-row slices of X, concatenated: at nprobe ==
    n_lists the IVF tier's candidate sort holds every corpus row for
    every query."""
    import torch

    return torch.cat([fn(X[i:i + chunk]) for i in range(0, X.shape[0],
                                                          chunk)])


def oracle_idx(sim, k: int):
    """(N, k) int64 indices of the k most similar columns in
    ``lax.top_k``'s order: ``torch.topk`` of a unique int64 key, the float
    bits' total-order key above the reversed column index (ties to the
    lowest index)."""
    import torch

    from traffic_classifier_sdn_tpu_torch.models.knn import total_order_key

    S = sim.shape[1]
    rev = (S - 1) - torch.arange(S, device=sim.device, dtype=torch.int64)
    key = total_order_key(sim).to(torch.int64) * (1 << 32) + rev[None, :]
    return torch.topk(key, k, dim=1).indices


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--out-prune",
                    default="docs/artifacts/torch_knn_prune.json")
    ap.add_argument("--out-recall",
                    default="docs/artifacts/torch_knn_ivf_recall.json")
    add_device_arg(ap)
    args = ap.parse_args()
    device = resolve_device(args.device)

    import numpy as np
    import torch

    from traffic_classifier_sdn_tpu_torch.models import knn
    from traffic_classifier_sdn_tpu_torch.native import knn as native_knn
    from traffic_classifier_sdn_tpu_torch.ops import knn_ivf
    from traffic_classifier_sdn_tpu_torch.ops import knn_kernel as kk

    fields = device_fields(device)
    rng = np.random.RandomState(7)
    ref = os.path.join(models_dir(), "KNeighbors")
    if os.path.exists(ref):
        from traffic_classifier_sdn_tpu_torch.io import sklearn_import as ski

        d = ski.import_knn(ref)
        corpus_kind = "reference"
    else:
        X, y = _flow_corpus(rng, 4448)
        d = {"fit_X": X, "y": y, "n_neighbors": 5, "classes": np.arange(6)}
        corpus_kind = "flow-synthetic"
    S = int(np.asarray(d["fit_X"]).shape[0])
    params = knn.KnnModel.from_numpy(d, device=device)
    k = params.n_neighbors
    # serving-like queries: corpus points under churn-scale jitter
    sel = rng.choice(S, args.batch)
    Xq = np.abs(
        np.asarray(d["fit_X"], np.float64)[sel]
        * (1 + rng.normal(0, 0.05, (args.batch, 12)))
    ).astype(np.float32)
    Xd = torch.from_numpy(Xq).to(device)

    # ---- exact tier: native pruned vs unpruned --------------------------
    if not native_knn.available():
        sys.exit("torch_bench_knn: g++ unavailable — no native evaluator")
    hk = native_knn.NativeKnn(d)
    hk.predict(Xq[:256])
    hk.predict_unpruned(Xq[:256])  # warm both paths
    got_p = hk.predict(Xq)
    got_u = hk.predict_unpruned(Xq)
    if not (got_p == got_u).all():
        sys.exit("torch_bench_knn: PRUNED/UNPRUNED PARITY FAILED")
    votes_ok = bool((hk.votes(Xq[:2048])
                     == hk.votes_unpruned(Xq[:2048])).all())
    if not votes_ok:
        sys.exit("torch_bench_knn: PRUNED/UNPRUNED VOTE PARITY FAILED")
    want_sort = params.predict(Xd).cpu().numpy()
    native_sort_parity = float((got_p == want_sort).mean() * 100.0)
    pruned_rate = _median_rate(lambda: hk.predict(Xq), args.batch,
                               args.repeat)
    unpruned_rate = _median_rate(lambda: hk.predict_unpruned(Xq),
                                 args.batch, args.repeat)
    scr, ab, qn = hk.screen_stats()

    # ---- exact tier: torch screened vs sort, and the kernel -------------
    g = kk.compile_knn(params)

    def sort_fn():
        return params.predict(Xd)

    def scr_fn():
        return params.predict(Xd, top_k_impl="screened")

    def kernel_fn():
        return kk.predict(g, Xd)

    for fn in (sort_fn, scr_fn, kernel_fn):
        fn()
    sync(device)
    # bitwise neighbor-index parity, not just labels
    sim = params._neighbor_sim(Xd)
    want_idx = oracle_idx(sim, k).cpu().numpy()
    idx_sort = knn.neighbor_idx(sim, k, "sort").cpu().numpy()
    idx_scr = knn.neighbor_idx(sim, k, "screened").cpu().numpy()
    idx_kernel = kk.neighbor_idx(g, Xd).cpu().numpy()
    if not (idx_sort == want_idx).all():
        sys.exit("torch_bench_knn: SORT/TOPK-ORACLE BITWISE PARITY FAILED")
    if not (idx_scr == want_idx).all():
        sys.exit("torch_bench_knn: SCREENED/SORT BITWISE PARITY FAILED")
    if not (idx_kernel == want_idx).all():
        sys.exit("torch_bench_knn: KERNEL/SORT BITWISE PARITY FAILED")
    sort_rate = _median_rate(sort_fn, args.batch, args.repeat, device)
    screened_rate = _median_rate(scr_fn, args.batch, args.repeat, device)
    kernel_rate = _median_rate(kernel_fn, args.batch, args.repeat, device)

    prune_line = {
        "artifact": "knn_prune",
        **fields,
        "corpus": corpus_kind,
        "corpus_rows": S,
        "n_neighbors": int(k),
        "batch": args.batch,
        "repeat": args.repeat,
        "knn_native_topk_flows_per_sec": round(pruned_rate, 1),
        "knn_native_unpruned_topk_flows_per_sec": round(unpruned_rate, 1),
        "native_prune_speedup": round(pruned_rate / unpruned_rate, 3),
        "native_parity_pruned_vs_unpruned_pct": 100.0,  # enforced above
        "native_votes_parity": votes_ok,
        "native_label_parity_vs_sort_pct": round(native_sort_parity, 3),
        "native_candidates_screened_per_query": round(scr / qn, 1),
        "native_candidates_abandoned_per_query": round(ab / qn, 1),
        "knn_sort_topk_flows_per_sec": round(sort_rate, 1),
        "knn_screened_topk_flows_per_sec": round(screened_rate, 1),
        "screened_vs_sort_speedup": round(screened_rate / sort_rate, 3),
        "screened_bitwise_parity": True,  # enforced above
        "screened_beats_sort": bool(screened_rate > sort_rate),
        "knn_kernel_topk_flows_per_sec": round(kernel_rate, 1),
        "kernel_vs_sort_speedup": round(kernel_rate / sort_rate, 3),
        "kernel_bitwise_parity": True,  # enforced above
    }
    print(json.dumps(prune_line), flush=True)

    # ---- approximate tier: IVF recall sweep -----------------------------
    ivf = knn_ivf.build(params)
    K = ivf.n_lists
    assign = knn_ivf.assignments(params.fit_X.cpu().numpy(),
                                 ivf.centers.cpu().numpy())
    hk.build_ivf(ivf.centers.cpu().numpy(), assign)
    # the nprobe == K anchor: bit-for-bit the exact search, both tiers
    full_x = in_chunks(lambda x: knn_ivf.predict(ivf, x, nprobe=K),
                       Xd).cpu().numpy()
    if not (full_x == want_sort).all():
        sys.exit("torch_bench_knn: IVF nprobe=K != EXACT (torch)")
    if not (hk.predict_ivf(Xq, K) == got_p).all():
        sys.exit("torch_bench_knn: IVF nprobe=K != EXACT (native)")
    sweep = []
    nprobes = sorted({1, 2, 4, 8, 16, 32, K} & set(range(1, K + 1)))
    exact1 = knn_ivf.exact_top1(params, Xd).cpu().numpy()
    for npb in nprobes:
        def fn(_n=npb):
            return in_chunks(lambda x: knn_ivf.predict(ivf, x, _n), Xd)

        fn()
        torch_rate = _median_rate(fn, args.batch, args.repeat, device)
        nat_rate = _median_rate(lambda: hk.predict_ivf(Xq, npb),
                                args.batch, args.repeat)
        top1 = in_chunks(lambda x, _n=npb: knn_ivf.ivf_top1(ivf, x, _n),
                         Xd).cpu().numpy()
        labels = fn().cpu().numpy()
        sweep.append({
            "nprobe": int(npb),
            "recall_at_1": round(float((top1 == exact1).mean()), 5),
            "label_agreement_vs_sort": round(
                float((labels == want_sort).mean()), 5),
            "xla_flows_per_sec": round(torch_rate, 1),
            "native_flows_per_sec": round(nat_rate, 1),
            "xla_speedup_vs_sort": round(torch_rate / sort_rate, 3),
            "native_speedup_vs_unpruned": round(nat_rate / unpruned_rate, 3),
        })
        print(f"# nprobe={npb}: recall@1={sweep[-1]['recall_at_1']} "
              f"native {nat_rate:,.0f}/s torch {torch_rate:,.0f}/s",
              flush=True)
    default_row = next(r for r in sweep
                       if r["nprobe"] == min(knn_ivf.DEFAULT_NPROBE, K))
    recall_line = {
        "artifact": "knn_ivf_recall",
        **fields,
        "corpus": corpus_kind,
        "corpus_rows": S,
        "n_lists": K,
        "batch": args.batch,
        "default_nprobe": int(min(knn_ivf.DEFAULT_NPROBE, K)),
        "default_nprobe_recall_at_1": default_row["recall_at_1"],
        "default_nprobe_recall_ok": bool(default_row["recall_at_1"] >= 0.99),
        "nprobe_equals_K_bitwise_exact": True,  # enforced above
        "sweep": sweep,
        "knn_sort_topk_flows_per_sec": round(sort_rate, 1),
        "knn_native_unpruned_topk_flows_per_sec": round(unpruned_rate, 1),
    }
    print(json.dumps(recall_line), flush=True)
    if not recall_line["default_nprobe_recall_ok"]:
        sys.exit("torch_bench_knn: shipped DEFAULT_NPROBE misses the 0.99 "
                 "recall@1 gate — the ivf opt-in's evidence is not honest")
    for path, line in ((args.out_prune, prune_line),
                       (args.out_recall, recall_line)):
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as fh:
            json.dump(line, fh, indent=1)
            fh.write("\n")
        print(f"# wrote {path}", flush=True)


if __name__ == "__main__":
    main()

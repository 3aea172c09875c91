#!/usr/bin/env python
"""State-sharded KNN scaling of the PyTorch port at fixed total work. The
twin of ``tools/bench_sharded_scaling.py``: the same flags, ``"metric"``
and result keys, with the N shards placed on the one device (on the card
unless ``--device cpu``).

A 2^20-row corpus (large enough that distance work dominates) is split
1 → 2 → 4 → 8 ways; each shard runs the port's serving local stage, the
KNN kernel over its corpus block (``parallel/knn_sharded.fused_predict``;
on the card ``csrc/knn_topk.cu``, once per shard), and the candidates
merge. All shards share one device, so the total time should stay FLAT
as shards grow while per-shard work drops N×: flat means the sharded path
adds no work (no merge whose operand scales with the corpus, no padding
blow-up).

1. Wall time at every shard count (synchronised), and its ratio to one
   shard.
2. Per-shard work. The JAX tool read the per-device FLOPs from XLA's
   ``cost_analysis()``, which has no counterpart here: ``per_device_flops``
   is COMPUTED from the shapes — queries × corpus rows per shard × (2F+1)
   operations per pair, the count of ``chip_smoke.knn_pair_ops`` — and
   ``per_device_flops_source`` says so.
3. Label parity at every shard count against the one-shard predict (the
   un-sharded kernel) on the first 512 queries; any mismatch ends the run
   nonzero after the JSON line.

Prints ONE JSON line.
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
    resolve_device,
    sync,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--corpus", type=int, default=1 << 20)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--repeats", type=int, default=5)
    add_device_arg(ap)
    args = ap.parse_args()
    device = resolve_device(args.device)

    import numpy as np
    import torch

    from traffic_classifier_sdn_tpu_torch.models.knn import KnnModel
    from traffic_classifier_sdn_tpu_torch.ops import knn_kernel as kk
    from traffic_classifier_sdn_tpu_torch.parallel import (
        knn_sharded,
        mesh as meshlib,
    )

    print(f"# device: {device_fields(device)}", file=sys.stderr, flush=True)
    rng = np.random.RandomState(0)
    S, F, k, C = args.corpus, 12, 5, 6
    d = {
        "fit_X": np.abs(rng.gamma(1.5, 200.0, (S, F))).astype(np.float64),
        "y": rng.randint(0, C, S),
        "n_neighbors": k,
        "classes": np.arange(C),
    }
    X = torch.as_tensor(
        np.abs(rng.gamma(1.5, 200.0, (args.batch, F))), dtype=torch.float32
    ).to(device)

    # the one-shard oracle for parity: the un-sharded kernel
    p0 = KnnModel.from_numpy(d, device=device)
    want = kk.predict(kk.compile_knn(p0), X[:512]).cpu().numpy()

    out: dict = {
        "metric": "sharded_knn_scaling_fixed_total_work",
        "corpus_rows": S,
        "batch": args.batch,
        **device_fields(device),
        "shards_on_one_device": True,
        "host_cores": os.cpu_count(),
        "per_device_flops_source": (
            "computed from shapes: batch x corpus rows per shard x (2F+1), "
            "not compiled"),
        "results": {},
    }
    base_ms = None
    ok = True
    for n_state in (1, 2, 4, 8):
        mesh = meshlib.make_mesh(n_data=1, n_state=n_state,
                                 devices=[device] * n_state)
        kr = knn_sharded.pad_corpus(dict(d), n_state)
        kp = KnnModel.from_numpy(kr, device=device)
        fn = knn_sharded.fused_predict(mesh, kp, pad_mask=kr.get("pad_mask"))
        got = fn(X[:512]).cpu().numpy()
        parity = float((got == want).mean() * 100.0)
        ok = ok and parity == 100.0
        flops_dev = float(args.batch * fn.per * (2 * F + 1))

        fn(X)  # warm
        sync(device)
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            fn(X)
            sync(device)
            times.append(time.perf_counter() - t0)
        ms = float(np.median(times)) * 1e3
        if n_state == 1:
            base_ms = ms
        out["results"][f"state_{n_state}"] = {
            "wall_ms_total_work_fixed": round(ms, 1),
            "wall_vs_state1": round(ms / base_ms, 3),
            "per_device_flops": flops_dev,
            "parity_pct_vs_single": parity,
            "merge_bytes_per_query_row": n_state * k * 8,
            "corpus_rows_per_shard": fn.per,
        }
        print(f"# state_{n_state}: {ms:.1f} ms, per-shard ops "
              f"{flops_dev:.3g}, parity {parity}", file=sys.stderr,
              flush=True)

    r1 = out["results"]["state_1"]
    r8 = out["results"]["state_8"]
    out["per_device_flops_ratio_8v1"] = round(
        r8["per_device_flops"] / r1["per_device_flops"], 4
    ) if r1["per_device_flops"] else None
    out["analysis"] = (
        "every shard shares one device, so wall time tracks TOTAL work and "
        "a sharded wall-clock speedup is not observable here; the scaling "
        "evidence is (a) flat wall time 1->8 shards at fixed total work "
        "(sharding adds no work), (b) per-shard operations ~1/N, counted "
        "from the shapes, (c) O(N*k) merge bytes independent of corpus "
        "size. On N devices each shard's kernel runs on its own device."
    )
    print(json.dumps(out), flush=True)
    if not ok:
        sys.exit("torch_bench_sharded_scaling: sharded labels differ from "
                 "the one-shard predict")


if __name__ == "__main__":
    main()

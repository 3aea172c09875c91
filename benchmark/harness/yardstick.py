"""The yardstick: the card's published peaks and the least time a kernel's
work can take on it, counted from what the function needs (its inputs'
shapes and, for the forest, the node visits these inputs make), never from
a kernel's own layout. Frozen copies of the bound arithmetic of the port's
``chip_smoke.py`` (``_bound``, ``forest_bound``, ``knn_bound``), with
``svc_bound`` counting the function's bytes and operations rather than the
SVC kernel's split support vectors."""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, at its 700 W limit: HBM3 bytes/s and float32
# operations/s outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
F32 = 4  # bytes


def least_ms(nbytes: int, ops: int) -> tuple[float, str]:
    """(ms, "bytes" | "operations"): the larger of the bytes over the HBM
    rate and the operations over the float32 rate."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def forest_ops(rows: int, visits: int, n_trees: int, n_classes: int) -> int:
    """One compare per internal-node visit, and C adds per tree per row."""
    return visits + rows * n_trees * n_classes


def forest_bytes(rows: int, n_features: int, n_classes: int,
                 internal_nodes: int, leaves: int) -> int:
    """X in, (rows, C) class sums out, the forest once: per internal node a
    float32 threshold and one word of feature and children, per leaf its
    C float32 values."""
    return (rows * n_features * F32 + rows * n_classes * F32
            + internal_nodes * 2 * F32 + leaves * n_classes * F32)


def forest_bound(rows: int, visits: int, n_features: int, n_trees: int,
                 n_classes: int, internal_nodes: int, leaves: int):
    return least_ms(
        forest_bytes(rows, n_features, n_classes, internal_nodes, leaves),
        forest_ops(rows, visits, n_trees, n_classes))


def knn_pair_ops(n_features: int) -> int:
    """Per (row, corpus row) pair: F multiplies, F - 1 adds, one subtract
    and one compare."""
    return 2 * n_features + 1


def knn_ops(rows: int, corpus_rows: int, n_features: int) -> int:
    return rows * corpus_rows * knn_pair_ops(n_features)


def knn_bytes(rows: int, corpus_rows: int, n_features: int, k: int) -> int:
    """X in, (rows, k) similarities and int32 indices out, the corpus once
    with its half squared norms."""
    return (rows * n_features * F32 + rows * k * 2 * F32
            + corpus_rows * (n_features + 1) * F32)


def knn_bound(rows: int, corpus_rows: int, n_features: int, k: int):
    return least_ms(knn_bytes(rows, corpus_rows, n_features, k),
                    knn_ops(rows, corpus_rows, n_features))


def svc_pair_ops(n_features: int, n_pairs: int) -> int:
    """Per (row, support vector) pair: F subtracts, F multiplies and F - 1
    adds for the squared distance, the gamma product, the exp, and P
    multiply-adds (3F + 1 + 2P)."""
    return 3 * n_features + 1 + 2 * n_pairs


def svc_bytes(rows: int, n_sv: int, n_features: int, n_classes: int,
              n_pairs: int) -> int:
    """X in, (rows, P) decisions out, the support vectors, their C - 1 dual
    coefficients and the P intercepts once."""
    return (rows * n_features * F32 + rows * n_pairs * F32
            + n_sv * n_features * F32 + n_sv * (n_classes - 1) * F32
            + n_pairs * F32)


def svc_bound(rows: int, n_sv: int, n_features: int, n_classes: int):
    P = n_classes * (n_classes - 1) // 2
    return least_ms(svc_bytes(rows, n_sv, n_features, n_classes, P),
                    rows * n_sv * svc_pair_ops(n_features, P))


def model_work(family: str, model, rows: int, visits: int | None):
    """(least ms, model operations) of predicting ``rows`` rows with the
    reference ``model`` of ``family``; ``visits`` are the forest's
    internal-node visits on those rows."""
    if family == "forest":
        ms, _ = forest_bound(rows, visits, model.n_features, model.n_trees,
                             model.n_classes, model.internal_nodes,
                             model.leaves)
        return ms, forest_ops(rows, visits, model.n_trees, model.n_classes)
    if family == "knn":
        ms, _ = knn_bound(rows, model.n_rows, model.n_features, model.k)
        return ms, knn_ops(rows, model.n_rows, model.n_features)
    raise ValueError(f"no work count for family {family!r}")

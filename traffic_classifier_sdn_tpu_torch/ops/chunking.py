"""Row-chunked mapping over big batches — the torch port of
``traffic_classifier_sdn_tpu/ops/chunking.py``.

The plain versions of the KNN and SVC kernels materialise an (N, S)
matrix: at 2²⁰ rows that is 18.6 GB of similarities against the
reference's 4448-row KNN corpus and 9.5 GB of RBF values against its 2281
support vectors. They run over 65,536-row slices instead. PyTorch runs
eagerly, so the JAX ``lax.map`` becomes a Python loop and a concatenation.
"""

from __future__ import annotations

import torch


def chunked_predict(predict_fn, row_chunk: int, X, X_lo=None):
    """Row-chunked wrapper for the ``predict(X, X_lo=None)`` family (SVC,
    KNN): without ``X_lo`` the function is called on X slices alone."""
    if X_lo is None:
        return map_row_chunks(lambda xc: predict_fn(xc), row_chunk, X)
    return map_row_chunks(
        lambda xc, xlo: predict_fn(xc, xlo), row_chunk, X, X_lo
    )


def map_row_chunks(fn, chunk: int, X, *rest):
    """Apply ``fn(X_slice, *rest_slices)`` over ``chunk``-row slices and
    concatenate along axis 0. ``rest`` tensors share X's leading
    dimension. Calls ``fn`` directly when the batch fits one chunk.
    ``fn`` may return a tensor or a tuple of tensors."""
    N = X.shape[0]
    if N <= chunk:
        return fn(X, *rest)
    outs = [
        fn(X[i: i + chunk], *(a[i: i + chunk] for a in rest))
        for i in range(0, N, chunk)
    ]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)

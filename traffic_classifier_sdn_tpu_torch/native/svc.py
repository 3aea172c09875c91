"""ctypes bindings of the port's native loops of the RBF-SVC's plain version.

The degrade ladder's host rung for SVC (``models.resolve_fallback``, kind
``native-svc``): the plain version of ``ops/rbf_kernel`` on the CPU with its
two loops of small torch ops, the squared distances and the decision sum,
each one call into ``svc_eval.cpp``. The exponential between them is the
plain version's own torch expression over the same (N, S) tensor, so every
label, vote and decision equals the plain version's bit for bit
(tests/test_torch_native_svc.py). One call holds the GIL for none of its
loops: the plain version's 2·S accumulator steps each waited for the GIL
again beside a busy host stage. It is not a port of a TPU kernel and runs
on no card; where g++ cannot build it the rung is the plain version
(``plain-cpu``).

Built with g++ ``-march=native -ffp-contract=off`` on first use into
``csrc/build/`` (``loader.LazyLib``): the host's widest SIMD for the loops,
and no product fused into a sum.
"""

from __future__ import annotations

import ctypes as ct
import threading
from pathlib import Path

import numpy as np
import torch

from ..models import svc
from ..ops import rbf_kernel
from ..ops.chunking import map_row_chunks
from .loader import LazyLib

SOURCE = Path(__file__).resolve().parent / "svc_eval.cpp"
_lazy = LazyLib(SOURCE, "native SVC evaluator",
                flags=("-O3", "-march=native", "-ffp-contract=off"))
_lock = threading.Lock()
_lib = None

_VP, _U32, _U64 = ct.c_void_p, ct.c_uint32, ct.c_uint64
_SIGNATURES = {
    "tcs_sq_dist": (None, [_VP, _U64, _U32, _VP, _VP, _U32, _VP]),
    "tcs_decision_sum_t": (None, [_VP, _U32, _U64, _VP, _U32, _VP]),
}


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = _lazy.load()  # graftlint: disable=blocking-under-lock -- one-time g++ build serialized under the module lock by design (build-once); later calls are cache hits
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


class NativeSvc:
    """The host rung over ``ops/rbf_kernel`` operands on the CPU
    (``rbf_kernel.compile_svc`` of a CPU model): ``partial``, ``scores``
    and ``predict`` as ``rbf_kernel``'s plain versions give them, over the
    same ``ROW_CHUNK``-row slices."""

    def __init__(self, g: rbf_kernel.SvcKernelOperands):
        _load()
        self._g = g
        self._hi_t = g.sv_hi.t().contiguous()
        self._lo_t = g.sv_lo.t().contiguous()
        self._coef_t = g.coef_t.contiguous()

    def _partial(self, X: torch.Tensor) -> torch.Tensor:
        g, lib = self._g, _load()
        n, f = X.shape
        d2 = torch.empty((n, g.n_sv), dtype=torch.float32)
        lib.tcs_sq_dist(X.data_ptr(), n, f, self._hi_t.data_ptr(),
                        self._lo_t.data_ptr(), g.n_sv, d2.data_ptr())
        K_t = torch.exp((-g.gamma_t) * d2).t().contiguous()
        acc_t = torch.empty((g.n_pairs, n), dtype=torch.float32)
        lib.tcs_decision_sum_t(K_t.data_ptr(), g.n_sv, n,
                               self._coef_t.data_ptr(), g.n_pairs,
                               acc_t.data_ptr())
        return acc_t.t()

    def partial(self, X: np.ndarray) -> torch.Tensor:
        """(N, P) decisions without the intercept of an (N, F) host
        matrix: ``rbf_kernel.partial_decision_plain``'s bits."""
        X = torch.from_numpy(np.ascontiguousarray(X, np.float32))
        if X.dim() != 2 or X.shape[1] != self._g.n_features:
            raise ValueError(f"X must be (N, {self._g.n_features}), got "
                             f"{tuple(X.shape)}")
        return map_row_chunks(self._partial, rbf_kernel.ROW_CHUNK, X)

    def _votes(self, X: np.ndarray) -> torch.Tensor:
        g = self._g
        return svc.votes_from_decision(
            self.partial(X) + g.intercept[None, :], g.vote_i, g.vote_j,
            g.n_classes)

    def scores(self, X: np.ndarray) -> np.ndarray:
        """(N, C) vote counts: ``rbf_kernel.scores``'."""
        return self._votes(X).numpy()

    def predict(self, X: np.ndarray) -> np.ndarray:
        """(N,) int32 labels: ``rbf_kernel.predict``'s, ties to the lowest
        class."""
        return torch.argmax(self._votes(X), dim=-1).to(torch.int32).numpy()

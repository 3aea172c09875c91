"""ctypes bindings of the port's native (C++) KNN evaluator.

The port's counterpart of the JAX package's ``native/knn.py``, cut to the
exact pruned search (``predict``, ``votes``) of ``knn_eval.cpp`` (this
package's copy of the JAX package's source): float64 squared distances,
``lax.top_k``'s tie order, screened and early-abandoned candidates, vote
for vote the full scan's answer. It is the degrade ladder's host rung for
KNN (``models.resolve_fallback``), not a port of a TPU kernel. The unpruned
and IVF entry points of the library are not bound.

Built with g++ ``-march=native`` on first use into ``csrc/build/``
(``loader.LazyLib``): the distance loops want the host's widest SIMD. The
library's name hashes the host's resolved target options, so a tree
copied to another CPU builds its own instead of loading a foreign one.
"""

from __future__ import annotations

import ctypes as ct
import threading
from pathlib import Path

import numpy as np

from .loader import LazyLib

SOURCE = Path(__file__).resolve().parent / "knn_eval.cpp"
_lazy = LazyLib(SOURCE, "native knn evaluator", flags=("-O3", "-march=native"))
_lock = threading.Lock()
_lib = None

_VP, _U32, _U64 = ct.c_void_p, ct.c_uint32, ct.c_uint64
_SIGNATURES = {
    "tck_create": (_VP, [_U32, _U32, _U32, _U32, _VP, _VP]),
    "tck_destroy": (None, [_VP]),
    "tck_predict": (None, [_VP, _VP, _U64, _U32, _VP]),
    "tck_votes": (None, [_VP, _VP, _U64, _U32, _VP]),
}


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = _lazy.load()
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return lib


def build() -> Path:
    """Build the evaluator's library if it is missing, load it, and return
    its path. Raises RuntimeError when g++ cannot build it."""
    _load()
    return _lazy.path


def available() -> bool:
    try:
        _load()
        return True
    except RuntimeError:
        return False


class NativeKnn:
    """A compiled corpus handle (arrays copied in at construction). ``d``
    is the importer dict: ``fit_X`` (S, F), ``y`` (S,) class indices,
    ``n_neighbors`` and ``classes``."""

    def __init__(self, d: dict):
        lib = _load()
        fit_X = np.ascontiguousarray(d["fit_X"], np.float32)
        fit_y = np.ascontiguousarray(d["y"], np.int32)
        S, F = fit_X.shape
        k = int(d["n_neighbors"])
        self.n_classes = int(np.asarray(d["classes"]).shape[0])
        self.n_features = F
        self.n_neighbors = k
        self.n_rows = S
        if S < k:
            raise ValueError(f"corpus has {S} rows < n_neighbors={k}")
        if k > 64:
            raise ValueError(f"n_neighbors={k} exceeds the 64-cand cap")
        self._lib = lib
        self._h = lib.tck_create(S, F, self.n_classes, k,
                                 fit_X.ctypes.data_as(_VP),
                                 fit_y.ctypes.data_as(_VP))
        if not self._h:
            raise RuntimeError("tck_create rejected the corpus layout")

    def _checked(self, X) -> np.ndarray:
        if not self._h:
            raise RuntimeError("NativeKnn handle is closed")
        X = np.ascontiguousarray(X, np.float32)
        if X.ndim != 2 or X.shape[1] != self.n_features:
            raise ValueError(f"X shape {X.shape} != (N, {self.n_features})")
        return X

    def predict(self, X) -> np.ndarray:
        """(N, F) float32 features -> (N,) int32 class indices."""
        X = self._checked(X)
        out = np.empty(X.shape[0], np.int32)
        self._lib.tck_predict(self._h, X.ctypes.data_as(_VP), X.shape[0],
                              X.shape[1], out.ctypes.data_as(_VP))
        return out

    def votes(self, X) -> np.ndarray:
        """(N, F) float32 features -> (N, C) int32 neighbor vote counts;
        ``argmax(votes) == predict`` (first maximum)."""
        X = self._checked(X)
        out = np.empty((X.shape[0], self.n_classes), np.int32)
        self._lib.tck_votes(self._h, X.ctypes.data_as(_VP), X.shape[0],
                            X.shape[1], out.ctypes.data_as(_VP))
        return out

    def close(self) -> None:
        if self._h:
            self._lib.tck_destroy(self._h)
            self._h = None

    def __del__(self):  # noqa: D105
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

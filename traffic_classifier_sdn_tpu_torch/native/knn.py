"""ctypes bindings of the port's native (C++) KNN evaluator.

The port's counterpart of the JAX package's ``native/knn.py`` over
``knn_eval.cpp`` (this package's copy of the JAX package's source): the
exact pruned search (``predict``, ``votes``: float64 squared distances,
``lax.top_k``'s tie order, screened and early-abandoned candidates, vote
for vote the full scan's answer), the full scan it is held to
(``predict_unpruned``, ``votes_unpruned``), the IVF mirror
(``build_ivf``, ``predict_ivf``, ``votes_ivf``) and the screening
counters (``screen_stats``). It is the degrade ladder's host rung for KNN
(``models.resolve_fallback``) and the ``--knn-topk native`` / ``ivf``
serves, not a port of a TPU kernel.

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
    "tck_predict_unpruned": (None, [_VP, _VP, _U64, _U32, _VP]),
    "tck_votes_unpruned": (None, [_VP, _VP, _U64, _U32, _VP]),
    "tck_ivf_build": (ct.c_int32, [_VP, _U32, _VP, _VP]),
    "tck_predict_ivf": (None, [_VP, _VP, _U64, _U32, _U32, _VP]),
    "tck_votes_ivf": (None, [_VP, _VP, _U64, _U32, _U32, _VP]),
    "tck_screen_stats": (None, [_VP, _VP]),
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
        self.n_lists = 0  # IVF lists, after build_ivf
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

    def _run(self, fn, X, per_row: int, *extra) -> np.ndarray:
        """``fn(handle, X, N, F, *extra, out)`` into a fresh int32 (N,) or
        (N, C) output."""
        X = self._checked(X)
        shape = (X.shape[0],) if per_row == 1 else (X.shape[0], per_row)
        out = np.empty(shape, np.int32)
        fn(self._h, X.ctypes.data_as(_VP), X.shape[0], X.shape[1], *extra,
           out.ctypes.data_as(_VP))
        return out

    def predict(self, X) -> np.ndarray:
        """(N, F) float32 features -> (N,) int32 class indices."""
        return self._run(self._lib.tck_predict, X, 1)

    def votes(self, X) -> np.ndarray:
        """(N, F) float32 features -> (N, C) int32 neighbor vote counts;
        ``argmax(votes) == predict`` (first maximum)."""
        return self._run(self._lib.tck_votes, X, self.n_classes)

    def predict_unpruned(self, X) -> np.ndarray:
        """The blocked full scan without screening: the pruned engine's
        parity oracle (vote for vote the same)."""
        return self._run(self._lib.tck_predict_unpruned, X, 1)

    def votes_unpruned(self, X) -> np.ndarray:
        return self._run(self._lib.tck_votes_unpruned, X, self.n_classes)

    def build_ivf(self, centers, assignments) -> None:
        """Install the IVF coarse index: ``centers`` (K, F) and
        ``assignments`` (S,) in [0, K), the quantizer of ops/knn_ivf.py.
        Build once, then serve: a rebuild is not guarded against
        concurrent predicts."""
        if not self._h:
            raise RuntimeError("NativeKnn handle is closed")
        centers = np.ascontiguousarray(centers, np.float32)
        assignments = np.ascontiguousarray(assignments, np.int32)
        if centers.ndim != 2 or centers.shape[1] != self.n_features:
            raise ValueError(
                f"centers shape {centers.shape} != (K, {self.n_features})")
        if assignments.shape != (self.n_rows,):
            # the C++ side reads exactly S entries
            raise ValueError(f"assignments shape {assignments.shape} != "
                             f"({self.n_rows},)")
        rc = self._lib.tck_ivf_build(self._h, centers.shape[0],
                                     centers.ctypes.data_as(_VP),
                                     assignments.ctypes.data_as(_VP))
        if rc:
            raise ValueError(f"tck_ivf_build rejected the index (rc={rc}: "
                             "bad K or out-of-range assignment)")
        self.n_lists = int(centers.shape[0])

    def _nprobe(self, nprobe: int) -> int:
        if not self.n_lists:
            raise RuntimeError("no IVF index: call build_ivf first")
        if nprobe < 1:
            raise ValueError(f"nprobe={nprobe} must be >= 1")
        return int(nprobe)

    def predict_ivf(self, X, nprobe: int) -> np.ndarray:
        """Approximate predict over the ``nprobe`` nearest lists (clamped
        to K; ``nprobe >= n_lists`` equals ``predict`` bit for bit)."""
        return self._run(self._lib.tck_predict_ivf, X, 1,
                         self._nprobe(nprobe))

    def votes_ivf(self, X, nprobe: int) -> np.ndarray:
        return self._run(self._lib.tck_votes_ivf, X, self.n_classes,
                         self._nprobe(nprobe))

    def screen_stats(self) -> tuple[int, int, int]:
        """Cumulative (screened, abandoned, queries): candidates skipped by
        the norm bound, distance loops exited early, queries answered."""
        if not self._h:
            raise RuntimeError("NativeKnn handle is closed")
        out = np.zeros(3, np.uint64)
        self._lib.tck_screen_stats(self._h, out.ctypes.data_as(_VP))
        return int(out[0]), int(out[1]), int(out[2])

    def close(self) -> None:
        if self._h:
            self._lib.tck_destroy(self._h)
            self._h = None

    def __del__(self):  # noqa: D105
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

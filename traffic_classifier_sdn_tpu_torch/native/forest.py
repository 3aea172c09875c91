"""ctypes bindings of the port's native (C++) random-forest evaluator.

The port's counterpart of the JAX package's ``native/forest.py``: a host
evaluator of the checkpoint's raw (T, M) node arrays, walked by
``forest_eval.cpp`` (this package's copy of the JAX package's source). It
is the degrade ladder's host rung for the forest (``models.resolve_fallback``):
what still classifies when the card's dispatch stalls or errors. It is not
a port of a TPU kernel and runs on no card.

Exactness: the leaf distributions are handed over as float64 ``v / v.sum()``
computed in numpy and accumulated in tree order, argmax to the first
maximum — the JAX package's evaluator, bit for bit on the same inputs
(tests/test_torch_native_fallback.py).

Built with g++ on first use into ``csrc/build/`` (``loader.LazyLib``);
``available()`` reports whether a build is possible.
"""

from __future__ import annotations

import ctypes as ct
import threading
from pathlib import Path

import numpy as np

from ..io.sklearn_import import f32_safe_thresholds
from .loader import LazyLib

SOURCE = Path(__file__).resolve().parent / "forest_eval.cpp"
_lazy = LazyLib(SOURCE, "native forest evaluator")
_lock = threading.Lock()
_lib = None

_VP, _U32, _U64 = ct.c_void_p, ct.c_uint32, ct.c_uint64
_SIGNATURES = {
    "tcf_create": (_VP, [_U32, _U32, _U32] + [_VP] * 5),
    "tcf_destroy": (None, [_VP]),
    "tcf_predict": (None, [_VP, _VP, _U64, _U32, _VP]),
    "tcf_proba": (None, [_VP, _VP, _U64, _U32, _VP]),
}


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = _lazy.load()  # graftlint: disable=blocking-under-lock -- one-time g++ build serialized under the module lock by design (build-once; shared machinery with engine.py); later calls are cache hits
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


class NativeForest:
    """A compiled forest handle. ``d`` holds the node arrays ``left``,
    ``right``, ``feature``, ``threshold`` (T, M) and ``values`` (T, M, C),
    copied into the library at construction; the handle is freed on GC or
    ``close()``."""

    def __init__(self, d: dict):
        lib = _load()
        feature = np.ascontiguousarray(d["feature"], np.int32)
        # sklearn compares f32(x) <= f64(thr): round thresholds down to f32
        # as every forest path of the port does (leaf slots are
        # overwritten with the library's NaN sentinel)
        threshold = np.ascontiguousarray(
            f32_safe_thresholds(np.asarray(d["threshold"], np.float64)),
            np.float32,
        )
        left = np.ascontiguousarray(d["left"], np.int32)
        right = np.ascontiguousarray(d["right"], np.int32)
        values = np.asarray(d["values"], np.float64)  # (T, M, C)
        T, M = left.shape
        if M > 32767:
            raise ValueError(f"nodes per tree {M} exceeds int16 layout")
        sums = values.sum(axis=2, keepdims=True)
        with np.errstate(invalid="ignore", divide="ignore"):
            leaf = np.ascontiguousarray(
                np.where(sums > 0, values / sums, 0.0)
            )
        self._lib = lib
        self.n_classes = int(values.shape[2])
        interior = left != -1
        self.min_features = (
            int(feature[interior].max()) + 1 if interior.any() else 1
        )
        self.n_features = int(d.get("n_features", self.min_features))
        self._h = lib.tcf_create(
            T, M, self.n_classes,
            feature.ctypes.data_as(_VP),
            threshold.ctypes.data_as(_VP),
            left.ctypes.data_as(_VP),
            right.ctypes.data_as(_VP),
            leaf.ctypes.data_as(_VP),
        )
        if not self._h:
            raise RuntimeError("tcf_create rejected the forest layout")

    def _checked(self, X) -> np.ndarray:
        if not self._h:
            raise RuntimeError("NativeForest handle is closed")
        X = np.ascontiguousarray(X, np.float32)
        if X.ndim != 2 or X.shape[1] < self.min_features:
            raise ValueError(
                f"X shape {X.shape} too narrow: forest reads feature "
                f"indices up to {self.min_features - 1}"
            )
        return X

    def predict(self, X) -> np.ndarray:
        """(N, F) float32 features -> (N,) int32 class indices."""
        X = self._checked(X)
        out = np.empty(X.shape[0], np.int32)
        self._lib.tcf_predict(self._h, X.ctypes.data_as(_VP), X.shape[0],
                              X.shape[1], out.ctypes.data_as(_VP))
        return out

    def predict_proba(self, X) -> np.ndarray:
        """(N, F) float32 -> (N, C) float64 mean class distributions."""
        X = self._checked(X)
        out = np.empty((X.shape[0], self.n_classes), np.float64)
        self._lib.tcf_proba(self._h, X.ctypes.data_as(_VP), X.shape[0],
                            X.shape[1], out.ctypes.data_as(_VP))
        return out

    def close(self) -> None:
        if self._h:
            self._lib.tcf_destroy(self._h)
            self._h = None

    def __del__(self):  # noqa: D105
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

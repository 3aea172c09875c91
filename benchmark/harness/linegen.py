"""The line formatter of the traffic generator: ``linegen.cc``, built once
per checkout with g++ into ``benchmark/build/`` (a fixed path inside the
checkout, named by a hash of the source and flags) and called through
ctypes, which leaves the interpreter lock to the serve while it writes."""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).with_name("linegen.cc")
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")
NUMBER_BYTES = 20  # decimal digits of the largest uint64

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"linegen-{digest.hexdigest()[:16]}.so"


def _load():
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                try:
                    subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)],
                                   check=True, capture_output=True, text=True)
                    os.replace(tmp, out)
                finally:
                    tmp.unlink(missing_ok=True)
            lib = ct.CDLL(str(out))
            fn = lib.tcb_format_lines
            fn.restype = ct.c_size_t
            fn.argtypes = [ct.c_void_p, ct.c_char_p, ct.c_size_t,
                           ct.c_void_p, ct.c_size_t, ct.c_void_p,
                           ct.c_size_t]
            _lib = lib
    return _lib


def format_lines(head: bytes, mid: np.ndarray, cum: np.ndarray,
                 out: np.ndarray | None = None) -> bytes:
    """Two lines per conversation i, as one bytes object:
    ``head + mid[2i] + "<cum[i,0]>\\t<cum[i,1]>\\n"`` (forward) and
    ``head + mid[2i+1] + "<cum[i,2]>\\t<cum[i,3]>\\n"`` (reverse). ``mid`` is
    (2n, width) uint8, ``cum`` (n, 4) non-negative int64; ``out``, when
    given, is the uint8 scratch the lines are written to first (reused
    across calls, it is not paged in again)."""
    rows, width = mid.shape
    n = cum.shape[0]
    if cum.shape != (n, 4) or rows != 2 * n:
        raise ValueError("format_lines: two middles and four counters per conversation")
    if n and cum.min() < 0:
        raise ValueError("format_lines: counters must be non-negative")
    mid = np.ascontiguousarray(mid, np.uint8)
    cum = np.ascontiguousarray(cum, np.int64)
    need = rows * (len(head) + width + 2 * NUMBER_BYTES + 2)
    if out is None or out.size < need:
        out = np.empty(need, np.uint8)
    size = _load().tcb_format_lines(out.ctypes.data, head, len(head),
                                    mid.ctypes.data, width, cum.ctypes.data, n)
    return out[:size].tobytes()

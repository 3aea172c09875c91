"""Lazy g++ build and ``dlopen`` of the port's native host libraries.

The port's counterpart of ``traffic_classifier_sdn_tpu/native/loader.py``
(plain C ABI + ctypes, no pybind11). A library is compiled on first use
from a source in this package into ``csrc/build/`` (listed in
``.gitignore``), named by a hash of its source and flags, so an edited
source is rebuilt and an unchanged one is not. A library built with
``-march=native`` also hashes the target options g++ resolves for this
host, so a tree copied to another CPU rebuilds it instead of loading code
that CPU may not run. The compiler writes to a
temporary file that ``os.replace`` moves into place, so concurrent
processes (test workers) never load a half-written library. The CDLL, and
a build failure, are cached per process.
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import subprocess
import threading
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "csrc" / "build"

_host_target: bytes | None = None


def host_target() -> bytes:
    """The target options ``g++ -march=native`` resolves on this host (the
    CPU's ISA extensions and tuning), cached per process; empty when g++
    cannot say, and then the build itself fails."""
    global _host_target
    if _host_target is None:
        try:
            _host_target = subprocess.run(
                ["g++", "-march=native", "-Q", "--help=target"],
                check=True, capture_output=True,
            ).stdout
        except (OSError, subprocess.CalledProcessError):
            _host_target = b""
    return _host_target


class LazyLib:
    def __init__(self, src: str | os.PathLike, name: str,
                 flags: tuple[str, ...] = ("-O3",)):
        self._src = Path(src)
        self._name = name
        self._flags = (*flags, "-std=c++17", "-fPIC", "-shared")
        self._lock = threading.Lock()
        self._lib: ct.CDLL | None = None
        self._error: str | None = None

    @property
    def path(self) -> Path:
        """The library file: ``csrc/build/<stem>-<hash>.so``, the hash
        over the source, the compiler flags and, for ``-march=native``,
        the host's resolved target options."""
        key = self._src.read_bytes() + " ".join(self._flags).encode()
        if "-march=native" in self._flags:
            key += host_target()
        digest = hashlib.sha256(key).hexdigest()
        return BUILD_DIR / f"{self._src.stem}-{digest[:16]}.so"

    def _build(self, out: Path) -> None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            subprocess.run(
                ["g++", *self._flags, "-o", str(tmp), str(self._src)],
                check=True, capture_output=True, text=True,
            )
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)

    def load(self) -> ct.CDLL:
        """The CDLL, built first if missing. Raises RuntimeError (cached)
        when no build is possible."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            if self._error is not None:
                raise RuntimeError(self._error)
            try:
                out = self.path  # graftlint: disable=blocking-under-lock -- the library's name hashes g++'s resolved target options (one g++ -Q query, cached per process): part of the one-time build the lock serializes by design
                if not out.exists():
                    self._build(out)  # graftlint: disable=blocking-under-lock -- the first caller pays the one-time g++ build under the lock BY DESIGN (build-once guarantee: concurrent loaders must wait, not race a second compile); every later acquisition is a cached-handle hit
                self._lib = ct.CDLL(str(out))
            except (OSError, subprocess.CalledProcessError) as e:
                detail = getattr(e, "stderr", "") or str(e)
                self._error = f"{self._name} unavailable: {detail}"
                raise RuntimeError(self._error) from e
            return self._lib

    def available(self) -> bool:
        try:
            self.load()
            return True
        except RuntimeError:
            return False

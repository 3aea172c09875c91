"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). Libraries go to
``csrc/build/`` (listed in ``.gitignore``), named by a hash of the source,
the shared ``csrc/*.cuh`` headers and the flags, so an edited kernel is
rebuilt and an unchanged one is not.
Several kernels build in parallel: ``build`` starts one ``nvcc`` per
source and then waits for all of them.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, the toolkit's default
    install, or ``nvcc`` on ``PATH``."""
    candidates = [
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
        f"{CSRC} at first use"
    )


def library_path(name: str) -> Path:
    """The library of kernel ``name``, named by a hash of its source, the
    shared headers (``csrc/*.cuh``) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names) -> dict[str, str]:
    """Compile every named kernel whose library is missing, all ``nvcc``
    processes at once. Returns ``{name: compiler log}`` (``-Xptxas -v``
    register and spill report; "" for a library that was already built).
    Raises ``RuntimeError`` with the compiler output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    logs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            logs[name] = ""
            continue
        nvcc = nvcc or find_nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT
        ), tmp, out)
    failed = []
    for name, (proc, tmp, out) in running.items():
        log = proc.communicate()[0].decode(errors="replace")
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built if missing."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))

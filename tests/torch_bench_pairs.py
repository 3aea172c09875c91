"""Shared plumbing of ``tests/test_torch_bench_*.py``: run a JAX bench
tool (``JAX_PLATFORMS=cpu``) and its port twin (``--device cpu``) in
subprocesses on the same arguments, and compare what they print."""

import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOOLS = ROOT / "tools"
PICKLES = ROOT / "tests" / "data" / "reference_pickles"
# keys only the port's tools print: the card's name, and the note that
# the XLA compile counters have no counterpart in eager torch
DEVICE_KEYS = {"device_name", "compile_telemetry"}
TIMEOUT = 240


def env(**extra) -> dict:
    """The tools' environment: the JAX side on the CPU with one device,
    checkpoints from the committed reference-shaped pickles."""
    e = {k: v for k, v in os.environ.items()
         if k not in ("XLA_FLAGS", "TCSDN_KNN_TOPK", "TCSDN_FOREST_KERNEL",
                      "TCSDN_SVC_KERNEL")}
    e.update(JAX_PLATFORMS="cpu", TCSDN_MODELS_DIR=str(PICKLES),
             PYTHONPATH=str(ROOT))
    e.update(extra)
    return e


def run(argv: list, cwd=ROOT, **extra) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, *map(str, argv)], cwd=cwd,
                          env=env(**extra), capture_output=True, text=True,
                          timeout=TIMEOUT)


def json_lines(out: str) -> list:
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def pair(jax_tool: str, args: list, *, twin_args: list = (),
         jax_args: list = (), ok: bool = True) -> tuple:
    """(JAX's JSON lines, the twin's JSON lines) of ``tools/<jax_tool>``
    and ``tools/torch_<jax_tool>`` on ``args``; both must exit 0 unless
    ``ok`` is False."""
    j = run([TOOLS / jax_tool, *args, *jax_args])
    t = run([TOOLS / f"torch_{jax_tool}", *args, "--device", "cpu",
             *twin_args])
    if ok:
        assert j.returncode == 0, j.stderr[-3000:]
        assert t.returncode == 0, t.stderr[-3000:]
    return json_lines(j.stdout), json_lines(t.stdout)


def assert_same_keys(want: dict, got: dict, extra=(), path="") -> None:
    """The same key sets, recursively through nested dicts, apart from
    ``DEVICE_KEYS`` and the port's named ``extra`` keys."""
    skip = DEVICE_KEYS | set(extra)
    assert set(want) - skip == set(got) - skip, (
        path, sorted(set(want) ^ set(got)))
    for k, v in want.items():
        if isinstance(v, dict) and isinstance(got.get(k), dict):
            assert_same_keys(v, got[k], extra, f"{path}.{k}")


def assert_fields_equal(want: dict, got: dict, keys) -> None:
    for k in keys:
        assert want[k] == got[k], (k, want[k], got[k])

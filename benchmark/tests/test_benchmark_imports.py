"""No module a run loads imports JAX, jaxlib, flax or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the plain reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
import types

from harness import cells
from harness.runner import forbidden_modules

PORT = "traffic_classifier_sdn_tpu_torch"
JAX_PACKAGE = "traffic_classifier_sdn_tpu"


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((cells.BENCH_DIR / "reference").glob("*.py"))
    assert files
    for f in files:
        names = _imports(f)
        assert not names & {PORT, JAX_PACKAGE, "jax", "jaxlib", "flax",
                            "families"}, f


def test_no_benchmark_file_imports_jax():
    for f in cells.BENCH_DIR.rglob("*.py"):
        assert not _imports(f) & {JAX_PACKAGE, "jax", "jaxlib", "flax"}, f


def test_forbidden_names_are_compared_whole(monkeypatch):
    before = forbidden_modules()
    monkeypatch.setitem(sys.modules, PORT + "_fake", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", types.ModuleType("x"))
    assert forbidden_modules() == before
    monkeypatch.setitem(sys.modules, JAX_PACKAGE + ".core",
                        types.ModuleType("x"))
    assert JAX_PACKAGE in forbidden_modules()


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r]\n"
        "from small import run_small\n"
        "out = run_small('knn5_refit61k.replay16x64k', 5, 0.5)\n"
        "out = run_small('rf100.replay16x64k', 5, 0.5)\n"
        "from harness.runner import forbidden_modules\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'traffic_classifier_sdn_tpu_torch' in top\n"
        "print(sorted(top & {'jax', 'jaxlib', 'flax', %r}))\n"
    ) % (str(cells.BENCH_DIR / "tests"), str(cells.BENCH_DIR),
         str(cells.ROOT), JAX_PACKAGE)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"

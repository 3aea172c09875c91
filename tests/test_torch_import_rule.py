"""The port's import rule: ``traffic_classifier_sdn_tpu_torch`` and
``chip_smoke.py`` import nothing of JAX (``jax``, ``flax``, ``optax``,
``orbax``) and nothing of the JAX package ``traffic_classifier_sdn_tpu``.

Two checks: every module imports in a fresh interpreter with a meta-path
blocker installed for those names (this test process already has JAX
loaded), and a source scan finds no such import statement.
"""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "traffic_classifier_sdn_tpu_torch"
BLOCKED = ("jax", "flax", "optax", "orbax", "traffic_classifier_sdn_tpu")

BLOCKER = '''
import importlib, pkgutil, sys
BLOCKED = {blocked!r}

def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"import of {{name}} is blocked")
        return None

sys.meta_path.insert(0, Blocker())
import traffic_classifier_sdn_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if blocked(m))
assert not leaked, leaked
assert not blocked("traffic_classifier_sdn_tpu_torch")
print(len(names))
'''


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKER.format(blocked=BLOCKED)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20  # every module of the port


def _imported_names(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


@pytest.mark.parametrize(
    "path", _sources(), ids=lambda p: str(p.relative_to(ROOT))
)
def test_source_has_no_blocked_import(path):
    bad = [
        n for n in _imported_names(path)
        if any(n == b or n.startswith(b + ".") for b in BLOCKED)
    ]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"

"""The port's import rule: ``traffic_classifier_sdn_tpu_torch`` and
``chip_smoke.py`` import nothing of JAX (``jax``, ``flax``, ``optax``,
``orbax``) and nothing of the JAX package ``traffic_classifier_sdn_tpu``,
and the port builds or loads no library from that package's tree.

Checks: every module imports in a fresh interpreter with a meta-path
blocker installed for those names (this test process already has JAX
loaded); a source scan finds no such import statement, and no string
outside a docstring that names the JAX package (the way a path into its
tree would be spelled); and in a fresh interpreter that records every
``ctypes.CDLL`` load and every process started, a build of the native
engine and a native-ingest serve touch no path under that tree.
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
print(" ".join(names))
'''


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKER.format(blocked=BLOCKED)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 20  # every module of the port
    # the fan-in tier and the logistic, GNB and k-means families among them
    assert {f"traffic_classifier_sdn_tpu_torch.{m}" for m in (
        "ingest.fanin", "models.logreg", "models.gnb", "models.kmeans",
    )} <= names


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


def _code_strings(path: pathlib.Path) -> list[str]:
    """The string constants of a source that are not docstrings."""
    tree = ast.parse(path.read_text(), str(path))
    docs = {
        id(node.body[0].value)
        for node in ast.walk(tree)
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef))
        and node.body and isinstance(node.body[0], ast.Expr)
        and isinstance(node.body[0].value, ast.Constant)
    }
    return [
        node.value for node in ast.walk(tree)
        if isinstance(node, ast.Constant) and isinstance(node.value, str)
        and id(node) not in docs
    ]


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT))
)
def test_source_names_no_path_into_the_jax_package(path):
    bad = [
        v for v in _code_strings(path)
        if "traffic_classifier_sdn_tpu" in v.replace(PORT.name, "")
    ]
    assert not bad, f"{path.relative_to(ROOT)} names the JAX package: {bad}"


LOADS = '''
import ctypes, pathlib, subprocess, sys, tempfile
touched = []
cdll_init = ctypes.CDLL.__init__
def cdll(self, name, *a, **k):
    touched.append(("load", str(name)))
    return cdll_init(self, name, *a, **k)
ctypes.CDLL.__init__ = cdll
popen_init = subprocess.Popen.__init__
def popen(self, args, *a, **k):
    touched.append(("run", " ".join(map(str, args)) if not isinstance(args, str) else args))
    return popen_init(self, args, *a, **k)
subprocess.Popen.__init__ = popen

from traffic_classifier_sdn_tpu_torch.native import engine, loader
from traffic_classifier_sdn_tpu_torch.ops import cuda_build
loader.BUILD_DIR = pathlib.Path(tempfile.mkdtemp())  # a fresh build
lib = engine.build()
from traffic_classifier_sdn_tpu_torch.ingest.batcher import FlowStateEngine
from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows
eng = FlowStateEngine(64, device="cpu", native=True, track_dirty=True)
eng.ingest_bytes(SyntheticFlows(40).tick_bytes())
eng.step()
assert eng.num_flows() == 40
print(repr((str(lib), str(engine.SOURCE), str(cuda_build.CSRC), touched)))
'''


def test_port_builds_and_loads_nothing_from_the_jax_tree():
    proc = subprocess.run([sys.executable, "-c", LOADS], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lib, source, csrc, touched = ast.literal_eval(proc.stdout.strip())
    jax_tree = str(ROOT / "traffic_classifier_sdn_tpu") + "/"
    assert source.startswith(str(PORT) + "/") and csrc.startswith(str(PORT))
    assert ("load", lib) in touched
    assert any(kind == "run" and source in cmd for kind, cmd in touched)
    bad = [t for t in touched if jax_tree in t[1]]
    assert not bad, f"the port touched the JAX package's tree: {bad}"

"""The port's import rule: ``traffic_classifier_sdn_tpu_torch`` and
``chip_smoke.py`` import nothing of JAX (``jax``, ``flax``, ``optax``,
``orbax``) and nothing of the JAX package ``traffic_classifier_sdn_tpu``,
and the port builds or loads no library from that package's tree.

Checks: every module imports in a fresh interpreter with a meta-path
blocker installed for those names (this test process already has JAX
loaded; the two ``__main__`` modules, which run an entry point when
imported, run instead under the blocker as ``python -m`` does); a
source scan of the port, ``chip_smoke.py`` and every ``tools/torch_*.py``
(the measurement tools among them, which import neither ``bench.py``
nor anything else of the JAX side) finds no such import statement, and
no string outside a docstring that names the JAX package (the way a path
into its tree would be spelled); each measurement tool imports in a fresh
interpreter with the blocker installed; the Python programs inside
``tools/torch_*.sh`` import none of it and the scripts name no module or
path of it; in a fresh interpreter that records
every ``ctypes.CDLL`` load and every process started, a build of the
native engine and a native-ingest serve touch no path under that tree;
and a spawned port controller, blocker installed, serves a fake switch's
telemetry.
"""

import ast
import pathlib
import re
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
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
         if not m.name.endswith(".__main__")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules if blocked(m))
assert not leaked, leaked
assert not blocked("traffic_classifier_sdn_tpu_torch")
print(" ".join(names))
'''


# every Python tool of the port: the operator's tools, the drift
# simulator, the kernel sweep, the pickle writer, the measurement tools
# (twins of the JAX package's bench tools) and their shared module
TOOLS = sorted((ROOT / "tools").glob("torch_*.py"))
BENCH_TWINS = ("torch_bench_serve", "torch_bench_e2e", "torch_bench_e2e_live",
               "torch_bench_knn", "torch_bench_forest_buckets",
               "torch_bench_sharded", "torch_bench_sharded_scaling",
               "torch_bench_openset", "torch_bench_scenarios",
               "torch_fake_monitor")
SHELL_TOOLS = sorted((ROOT / "tools").glob("torch_*.sh"))
# the rank program chip_smoke.py spawns on the card
MULTIHOST_WORKER = ROOT / "tests" / "torch_multihost_worker.py"


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", *TOOLS,
                                         MULTIHOST_WORKER]


def test_port_imports_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKER.format(blocked=BLOCKED)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 20  # every module of the port
    # the fan-in tier, the logistic, GNB and k-means families, the IVF
    # tier and its trainer, the controller, the workload source, the
    # config, the metrics and observability plane, the serving
    # checkpoints, the importer, the analysis toolkit and the distributed
    # trainers among them
    assert {f"traffic_classifier_sdn_tpu_torch.{m}" for m in (
        "ingest.fanin", "models.logreg", "models.gnb", "models.kmeans",
        "ops.knn_ivf", "train.kmeans", "controller.openflow",
        "controller.switch", "ingest.workload", "io.datasets", "config",
        "utils.metrics", "utils.atomicio", "obs", "obs.trace",
        "obs.flight_recorder", "obs.latency", "obs.exposition",
        "io.serving_checkpoint", "controller.policy", "serving.actuation",
        "serving.fleet", "obs.device", "obs.perf_recorder",
        "utils.profiling", "scenarios", "scenarios.timeline",
        "scenarios.library", "scenarios.runner", "io.sklearn_import",
        "core.flow", "analysis", "analysis.eval", "analysis.preprocess",
        "analysis.figures", "train.distributed",
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
        if any(n == b or n.startswith(b + ".") or n == "bench"
               for b in BLOCKED)
    ]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_tool_glob_finds_every_tool():
    """The glob finds the earlier tools and the ten measurement tools, and
    nothing else: a tool added later must be scanned on purpose."""
    names = {p.stem for p in TOOLS}
    assert names == {
        "torch_doctor", "torch_drift_sim", "torch_fake_switch",
        "torch_fleet_serve", "torch_kernel_sweep", "torch_profile_gate",
        "torch_reference_pickles", "torch_sanitize_kernels",
        "torch_bench_common", *BENCH_TWINS,
    }
    assert len(TOOLS) == 19


TWIN_IMPORT = BLOCKER.split("import traffic_classifier_sdn_tpu_torch as pkg")[0] + \
    """
sys.path.insert(0, {tools!r})
mod = importlib.import_module({name!r})
assert callable(mod.main)
leaked = sorted(m for m in sys.modules if blocked(m))
assert not leaked, leaked
"""


@pytest.mark.parametrize("name", BENCH_TWINS)
def test_measurement_tool_imports_with_jax_and_bench_blocked(name):
    """Each measurement tool's module imports with JAX, the JAX package
    and ``bench.py`` (which imports JAX) blocked."""
    proc = subprocess.run(
        [sys.executable, "-c", TWIN_IMPORT.format(
            blocked=BLOCKED + ("bench",), tools=str(ROOT / "tools"),
            name=name)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr


def _shell_python(path: pathlib.Path) -> list[str]:
    """The Python programs a shell tool runs: each ``python - <<'EOF'``
    here-document and each ``python -c '...'`` argument."""
    text = path.read_text()
    docs = re.findall(r"python - [^\n]*<<'EOF'\n(.*?)^EOF$", text, re.M | re.S)
    inline = re.findall(r"python -c '([^']*)'", text)
    return docs + inline


def test_shell_tools_are_found():
    assert {p.name for p in SHELL_TOOLS} >= {
        "torch_chaos_matrix.sh", "torch_lint.sh", "torch_native_sanitize.sh"}
    assert len(_shell_python(ROOT / "tools" / "torch_native_sanitize.sh")) >= 3


@pytest.mark.parametrize("path", SHELL_TOOLS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_shell_tool_python_imports_nothing_of_jax(path):
    """The Python inside ``tools/torch_*.sh`` imports nothing of JAX or
    of the JAX package, and the scripts start no module of that package
    (``python -m traffic_classifier_sdn_tpu...``) and build nothing from
    its tree."""
    for i, src in enumerate(_shell_python(path)):
        names = []
        for node in ast.walk(ast.parse(src, f"{path.name}#{i}")):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.append(node.module or "")
        bad = [n for n in names
               if any(n == b or n.startswith(b + ".") for b in BLOCKED)]
        assert not bad, f"{path.name} program {i} imports {bad}"
    text = path.read_text().replace(PORT.name, "")
    assert "traffic_classifier_sdn_tpu" not in text, path.name


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
    "path", sorted(PORT.rglob("*.py")) + TOOLS,
    ids=lambda p: str(p.relative_to(ROOT))
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


MAIN = BLOCKER.split("import traffic_classifier_sdn_tpu_torch as pkg")[0] + '''
import runpy
sys.argv = [sys.argv[0]] + {argv!r}
runpy.run_module({module!r}, run_name="__main__", alter_sys=True)
'''


def _blocked_main(module: str, argv: list, **kw) -> subprocess.Popen:
    """``python -m module argv`` with the blocker installed."""
    return subprocess.Popen(
        [sys.executable, "-c",
         MAIN.format(blocked=BLOCKED, module=module, argv=argv)],
        cwd=ROOT, text=True, **kw)


def test_package_main_runs_with_jax_blocked():
    proc = _blocked_main("traffic_classifier_sdn_tpu_torch", ["--help"],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err
    assert "--knn-topk" in out and "controller" in out


def test_spawned_port_controller_serves_with_jax_blocked():
    """``python -m traffic_classifier_sdn_tpu_torch.controller`` under the
    blocker: a fake switch (tools/torch_fake_switch.py) connects and
    converses, and the controller prints flow-stats telemetry, so
    nothing it runs imports JAX or the JAX package."""
    import asyncio
    import socket
    import threading

    sys.path.insert(0, str(ROOT / "tools"))
    from torch_fake_switch import FakeSwitch

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = _blocked_main(
        "traffic_classifier_sdn_tpu_torch.controller",
        ["--host", "127.0.0.1", "--port", str(port), "--poll", "0.1"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    lines, got = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("data\t"):
                got.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()

    async def switch():
        sw = FakeSwitch(dpid=7, n_hosts=4)
        for _ in range(300):  # the controller starts in a second or two
            try:
                await sw.connect("127.0.0.1", port)
                break
            except ConnectionRefusedError:
                if proc.poll() is not None:
                    return
                await asyncio.sleep(0.1)
        await sw.pump(0.3)
        sw.converse(0, 1)
        for _ in range(50):
            await sw.pump(0.2)
            if got.is_set():
                break

    try:
        asyncio.run(asyncio.wait_for(switch(), timeout=120))
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        reader.join(timeout=10)
    assert got.is_set(), "".join(lines)[-2000:]
    assert not any("ImportError" in line for line in lines)


def test_push_scenario_replays_with_jax_and_fake_switch_blocked(tmp_path):
    """The push-mode scenario (``label_flap_storm``: an in-process
    AccountingSwitch) through the port CLI's ``--scenario`` hook, with the
    JAX names and ``fake_switch`` (the JAX package's switch, which imports
    that package) blocked: it passes on the port's ``torch_fake_switch``."""
    proc = subprocess.run(
        [sys.executable, "-c", MAIN.format(
            blocked=BLOCKED + ("fake_switch",),
            module="traffic_classifier_sdn_tpu_torch.cli",
            argv=["gaussiannb", "--scenario", "label_flap_storm",
                  "--scenario-profile", "t1", "--device", "cpu",
                  "--scenario-obs-dir", str(tmp_path / "pm")])],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    card = __import__("json").loads(proc.stdout)
    assert card["passed"] and card["switch"]["live_rules"] > 0


GRAFT_ENTRY = BLOCKER.split("import traffic_classifier_sdn_tpu_torch as pkg")[0] + '''
from traffic_classifier_sdn_tpu_torch import graft_entry
fn, args = graft_entry.entry(device="cpu")
assert fn(*args).shape == (256,)
assert graft_entry.dryrun_multichip(2, device="cpu") is None
leaked = sorted(m for m in sys.modules if blocked(m))
assert not leaked, leaked
'''


def test_graft_entry_never_imports_the_jax_entry_module():
    """The port's twin of ``__graft_entry__.py`` (``graft_entry.py``)
    keeps its own copy of ``_synth_forest``: no source of the port,
    ``chip_smoke.py`` or the tools names ``__graft_entry__`` in an import,
    and ``entry`` and
    ``dryrun_multichip`` run in a fresh interpreter with it blocked beside
    JAX and the JAX package."""
    for path in _sources():
        assert "__graft_entry__" not in _imported_names(path), path
    proc = subprocess.run(
        [sys.executable, "-c", GRAFT_ENTRY.format(
            blocked=BLOCKED + ("__graft_entry__",))],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr

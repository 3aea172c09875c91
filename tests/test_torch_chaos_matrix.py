"""``tools/torch_chaos_matrix.sh`` without its sweep: every site group's
``-m chaos -k`` expression selects at least one test of its files, and the
groups together cover every fault site of the port's ``utils/faults.SITES``.

The groups are read from the script. One subprocess collects each group
with ``pytest --collect-only`` (in one interpreter, so the test modules
import once) and returns the selected test ids with the source of each
test and of the test-module helpers it calls; a site is covered when a
selected test's source, a helper's or its id names it.
"""

import json
import pathlib
import re
import subprocess
import sys

from traffic_classifier_sdn_tpu_torch.utils.faults import SITES

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPT = ROOT / "tools" / "torch_chaos_matrix.sh"

COLLECT = r'''
import inspect, json, sys, types
import pytest

groups = json.loads(sys.argv[1])

class Selected:
    def __init__(self):
        self.items = []

    def pytest_collection_finish(self, session):
        self.items = list(session.items)

def source(obj):
    try:
        return inspect.getsource(obj)
    except (OSError, TypeError):
        return ""

out = {}
for name, files, kexpr in groups:
    sel = Selected()
    rc = pytest.main(["--collect-only", "-q", "-m", "chaos", "-k", kexpr,
                      "-p", "no:cacheprovider", "-p", "no:randomly",
                      *files], plugins=[sel])
    ids, text = [], []
    for item in sel.items:
        ids.append(item.nodeid)
        fn = item.function
        text += [item.nodeid, source(fn)]
        for ref in fn.__code__.co_names:
            obj = getattr(item.module, ref, None)
            mod = getattr(obj, "__module__", "") or ""
            if (isinstance(obj, (types.FunctionType, type))
                    and mod.split(".")[-1].startswith("test_")):
                text.append(source(obj))
    out[name] = {"rc": int(rc), "ids": ids, "text": "\n".join(text)}
print("GROUPS=" + json.dumps(out))
'''


def _groups():
    """``(name, [files], kexpr)`` of each entry of the script's
    GROUPS_KEYS array."""
    text = SCRIPT.read_text()
    chaos = re.search(r"^CHAOS=(\S+)$", text, re.M).group(1)
    body = re.search(r"^GROUPS_KEYS=\((.*?)^\)", text, re.M | re.S).group(1)
    groups = []
    for entry in re.findall(r'^\s*"([^"]+)"\s*$', body, re.M):
        name, files, kexpr = entry.split("|")
        groups.append((name, files.replace("$CHAOS", chaos).split(), kexpr))
    return groups


def test_every_group_selects_a_test_and_the_groups_cover_every_site():
    groups = _groups()
    assert len(groups) == 15
    assert len({g[0] for g in groups}) == 15
    proc = subprocess.run(
        [sys.executable, "-c", COLLECT, json.dumps(groups)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
    )
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("GROUPS=")]
    assert line, proc.stdout[-3000:] + proc.stderr[-3000:]
    got = json.loads(line[0][len("GROUPS="):])
    empty = [name for name, g in got.items() if g["rc"] != 0 or not g["ids"]]
    assert not empty, {n: got[n]["rc"] for n in empty}
    covered = {site for site in SITES
               if any(site in g["text"] for g in got.values())}
    assert len(SITES) == 29
    assert covered == set(SITES), sorted(set(SITES) - covered)


def test_script_sweeps_the_jax_default_seeds_under_both_witnesses():
    text = SCRIPT.read_text()
    assert "SEEDS=(0 1 2 7 1337)" in text
    assert text.count("TCSDN_LOCKTRACE=1 TCSDN_SYNCGUARD=1") == 2
    assert "tests/test_torch_scenarios.py" in text
    assert [g[0] for g in _groups()] == [
        "checkpoint", "collector", "supervisor", "native", "pipeline",
        "degrade", "drift", "dirty", "fanin", "region", "native_ingest",
        "obs", "obsdev", "openset", "actuation",
    ]

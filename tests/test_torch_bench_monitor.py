"""``tools/torch_fake_monitor.py`` against ``tools/fake_monitor.py``: the
same argv gives the same bytes on stdout; and the twin of
tests/test_cli.py's live-monitor cases: the port's CLI reading
``torch_fake_monitor.py`` through its ``--source ryu`` subprocess source
prints the JAX CLI's stdout fed by JAX's monitor, with the Python batcher
and with the C++ engine."""

import sys

import pytest

from torch_bench_pairs import PICKLES, TOOLS, run


@pytest.mark.parametrize("argv", [["64", "2", "0"], ["7", "5", "0"],
                                  ["300", "1", "0"], ["1", "3", "0.01"]])
def test_fake_monitor_bytes_equal_jax(argv):
    want = run([TOOLS / "fake_monitor.py", *argv])
    got = run([TOOLS / "torch_fake_monitor.py", *argv])
    assert got.returncode == want.returncode == 0
    assert got.stdout == want.stdout
    n_flows, n_ticks = int(argv[0]), int(argv[1])
    assert got.stdout.count("\n") == 1 + 2 * n_flows * n_ticks


@pytest.mark.parametrize("native", ["off", "on"])
def test_live_subprocess_fake_monitor_stdout_equals_jax(native):
    """Each CLI warms up before its monitor's first tick and the monitor
    pauses 0.4 s between ticks, so every poll reads one tick on both
    sides."""
    argv = ["gaussiannb", "--source", "ryu", "--checkpoint-dir", PICKLES,
            "--capacity", "32", "--print-every", "2", "--max-ticks", "4",
            "--warmup", "--native-ingest", native, "--idle-timeout", "60"]
    want = run(["-m", "traffic_classifier_sdn_tpu.cli", *argv,
                "--monitor-cmd",
                f"{sys.executable} {TOOLS / 'fake_monitor.py'} 8 6 0.4"])
    got = run(["-m", "traffic_classifier_sdn_tpu_torch.cli", *argv,
               "--device", "cpu", "--monitor-cmd",
               f"{sys.executable} {TOOLS / 'torch_fake_monitor.py'} 8 6 0.4"])
    assert want.returncode == 0, want.stderr[-3000:]
    assert got.returncode == 0, got.stderr[-3000:]
    assert "Flow ID" in got.stdout
    assert "00:00:00" in got.stdout  # the slot metadata came back
    assert got.stdout == want.stdout

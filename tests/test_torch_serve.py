"""Serve parity: the port CLI on the CPU prints byte-identical stdout to the
JAX CLI serve it ports —
``traffic_classifier_sdn_tpu.cli Randomforest --native-checkpoint CKPT
--pipeline off --incremental off --degrade off --native-ingest off`` — on
the same forest and the same telemetry.

The forest comes from ``chip_smoke.random_forest`` (seed 0) with
thresholds drawn from the served features. Its leaves are never pure, so
exact vote ties — where the two packages' differently ordered f32 sums
could pick different classes — do not arise. The comparison is exact; a
difference confined to a row whose JAX top-two margin is at most 1e-5
would be such a tie-order difference, and none occurs with seed 0.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from traffic_classifier_sdn_tpu import cli as jcli
from traffic_classifier_sdn_tpu.io import checkpoint as jck
from traffic_classifier_sdn_tpu.models import forest as jforest
from traffic_classifier_sdn_tpu_torch import cli as tcli
from traffic_classifier_sdn_tpu_torch import interop
from traffic_classifier_sdn_tpu_torch.device import resolve_device
from traffic_classifier_sdn_tpu_torch.ingest.batcher import FlowStateEngine
from traffic_classifier_sdn_tpu_torch.ingest.protocol import (
    TelemetryRecord,
    format_line,
)
from traffic_classifier_sdn_tpu_torch.ingest.replay import (
    SyntheticFlows,
    iter_capture,
)
from traffic_classifier_sdn_tpu_torch.io import checkpoint as tck

CLASSES = ("dns", "game", "ping", "quake", "telnet", "voice")
JAX_SLICE_FLAGS = ["--pipeline", "off", "--incremental", "off",
                   "--degrade", "off", "--native-ingest", "off"]


def _mac(i: int) -> str:
    return ":".join(f"{b:02x}" for b in i.to_bytes(6, "big"))


def write_capture(path, n_flows: int = 40, ticks: int = 8) -> None:
    """A monitor capture: every third flow goes silent after t=3 (idle
    eviction), flow 0's byte counter wraps past 2^32, flow 1's counters
    reset at t=5, flow 2's counters pass 2^31 (full wire), and malformed
    and noise lines are interleaved."""
    rng = np.random.RandomState(5)
    cum = np.zeros((n_flows, 2, 2), np.int64)  # flow, dir, (pkts, bytes)
    cum[0, 0, 1] = (1 << 32) - 5000
    cum[2, :, :] = (1 << 31) - 10
    with open(path, "wb") as f:
        for t in range(1, ticks + 1):
            f.write(b"loading app ryu.controller\n")
            for i in range(n_flows):
                if i % 3 == 0 and i and t > 3:
                    continue
                if i == 1 and t == 5:
                    cum[1] = 0
                cum[i, :, 0] += rng.poisson(20, 2)
                cum[i, :, 1] += rng.randint(0, 3000, 2)
                for d, (src, dst) in enumerate(
                    ((_mac(2 * i), _mac(2 * i + 1)),
                     (_mac(2 * i + 1), _mac(2 * i)))
                ):
                    f.write(format_line(TelemetryRecord(
                        time=t, datapath="1", in_port=str(d + 1),
                        eth_src=src, eth_dst=dst, out_port=str(2 - d),
                        packets=int(cum[i, d, 0]), bytes=int(cum[i, d, 1]),
                    )))
            f.write(b"data\t%d\t1\tbroken\n" % t)


def _sample_features(batches, capacity: int) -> np.ndarray:
    engine = FlowStateEngine(capacity, device="cpu")
    for b in batches:
        engine.mark_tick()
        engine.ingest(b)
        engine.step()
    X = engine.features().numpy()
    return X[np.abs(X).sum(1) > 0]


def _checkpoints(tmp_path, X_sample, n_trees: int = 16):
    d = chip_smoke.random_forest(0, X_sample, n_trees=n_trees)
    jdir, tdir = str(tmp_path / "jax_ckpt"), str(tmp_path / "port_ckpt")
    jck.save_model(jdir, "forest", jforest.from_numpy(d), classes=CLASSES)
    tck.save_model(tdir, "forest", interop.forest_params_from_numpy(d, device="cpu"),
                   classes=CLASSES)
    return jdir, tdir


def _serve_both(capsys, jdir, tdir, argv):
    jcli.main(["Randomforest", "--native-checkpoint", jdir, *argv,
               *JAX_SLICE_FLAGS])
    jax_io = capsys.readouterr()
    summary = tcli.main(["Randomforest", "--native-checkpoint", tdir, *argv,
                         "--device", "cpu"])
    port_io = capsys.readouterr()
    return jax_io, port_io, summary


def _warnings(err: str) -> list:
    return [ln for ln in err.splitlines() if ln.startswith("WARNING")]


def test_synthetic_serve_stdout_identical(tmp_path, capsys):
    """A few hundred synthetic flows on a table too small for them (drops
    and the table-full warning). The synthetic source emits every flow
    every tick, so idle eviction is exercised on the replay capture."""
    syn = SyntheticFlows(n_flows=300)
    X = _sample_features([syn.tick() for _ in range(2)], 512)
    jdir, tdir = _checkpoints(tmp_path, X)
    argv = ["--source", "synthetic", "--synthetic-flows", "300",
            "--capacity", "256", "--max-ticks", "4", "--print-every", "2"]
    jax_io, port_io, summary = _serve_both(capsys, jdir, tdir, argv)
    assert port_io.out == jax_io.out
    assert port_io.out.count("Flow ID") == 2
    assert "... showing 64 of 256 tracked flows" in port_io.out
    assert _warnings(port_io.err) == _warnings(jax_io.err) != []
    assert summary.ticks == 4 and summary.render_ticks == [2, 4]
    assert summary.engine.num_flows() == 256


@pytest.mark.parametrize("table_rows", ["64", "8", "0"])
def test_replay_serve_stdout_identical(tmp_path, capsys, table_rows):
    """Replay with a counter wrap, a reset, a full-width wire, malformed
    lines and idle eviction (--idle-timeout 2); ranked (64, 8 rows) and
    full (0 = all rows) renders."""
    cap = tmp_path / "capture.tsv"
    write_capture(cap)
    X = _sample_features(iter_capture(str(cap)), 64)
    jdir, tdir = _checkpoints(tmp_path, X)
    argv = ["--source", "replay", "--capture", str(cap), "--capacity", "64",
            "--print-every", "2", "--idle-timeout", "2",
            "--table-rows", table_rows]
    jax_io, port_io, summary = _serve_both(capsys, jdir, tdir, argv)
    assert port_io.out == jax_io.out
    assert port_io.out.count("Flow ID") == 4
    assert summary.ticks == 8
    # flows 3, 6, ..., 39 went silent after t=3 and were evicted
    assert summary.engine.num_flows() == 40 - 13


def test_cli_defaults_to_cuda_without_fallback(tmp_path):
    """No ``--device`` means CUDA; with no GPU visible that is an error,
    never a silent CPU serve."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default would run on it")
    _, tdir = _checkpoints(tmp_path, np.ones((4, 12), np.float32), n_trees=2)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tcli.main(["Randomforest", "--native-checkpoint", tdir,
                   "--source", "synthetic", "--max-ticks", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"

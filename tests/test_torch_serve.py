"""Serve parity: the port CLI on the CPU prints byte-identical stdout to the
JAX CLI serve it ports —
``traffic_classifier_sdn_tpu.cli <subcommand> --native-checkpoint CKPT
--pipeline off --incremental off --degrade off --native-ingest off`` — on
the same model and the same telemetry, for ``Randomforest``, ``knearest``
and ``svm`` (``--knn-topk`` and ``TCSDN_SVC_KERNEL`` at their defaults).

The forest comes from ``chip_smoke.random_forest`` (seed 0) with
thresholds drawn from the served features. Its leaves are never pure, so
exact vote ties — where the two packages' differently ordered f32 sums
could pick different classes — do not arise. The comparison is exact; a
difference confined to a row whose JAX top-two margin is at most 1e-5
would be such a tie-order difference, and none occurs with seed 0.

The KNN corpus and the SVC's support vectors are drawn near the served
features (``chip_smoke.random_knn``/``random_svc``, seed 0) and carried
from the JAX params through ``interop``. The two packages round the
similarities and decisions differently in the last bits, so a label may
differ only on a row that is an f32 near-tie: a k-th/(k+1)-th similarity
gap, or a smallest |D|, within rounding of JAX's value. When stdout
differs, the test names each differing row with that margin; with seed 0
none occurs and stdout is byte-identical.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from traffic_classifier_sdn_tpu import cli as jcli
from traffic_classifier_sdn_tpu.io import checkpoint as jck
from traffic_classifier_sdn_tpu.models import forest as jforest
from traffic_classifier_sdn_tpu.models import knn as jknn
from traffic_classifier_sdn_tpu.models import svc as jsvc
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
from traffic_classifier_sdn_tpu_torch.core import flow_table as ft
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


# subcommand → (family, JAX module, chip_smoke model builder, interop
# builder, model size)
FAMILIES = {
    "knearest": ("knn", jknn, chip_smoke.random_knn,
                 interop.knn_params_from_numpy, {"n_rows": 400}),
    "svm": ("svc", jsvc, chip_smoke.random_svc,
            interop.svc_params_from_numpy, {"n_sv": 200}),
}


def _family_checkpoints(tmp_path, sub, X_sample):
    family, jmod, build, carry, size = FAMILIES[sub]
    jp = jmod.from_numpy(build(0, X_sample, **size))
    jdir, tdir = str(tmp_path / "jax_ckpt"), str(tmp_path / "port_ckpt")
    jck.save_model(jdir, family, jp, classes=CLASSES)
    tck.save_model(tdir, family, carry(jp, device="cpu"), classes=CLASSES)
    return jp, jdir, tdir


def _near_tie_report(sub, jp, engine, jax_out, port_out) -> str:
    """Each row whose rendered label differs, with JAX's margin on it: the
    k-th/(k+1)-th similarity gap (knearest) or the smallest |D| (svm),
    beside the f32 rounding scale of that row."""
    import jax.numpy as jnp

    X = jnp.asarray(ft.features12(engine.table).numpy())
    if sub == "knearest":
        sim = np.asarray(jknn._dot_expansion_sim(X, jp.fit_X, jp.half_sq_norms))
        top = -np.sort(-sim, axis=1)[:, : jp.n_neighbors + 1]
        margin = top[:, -2] - top[:, -1]
        scale = np.spacing(np.abs(sim).max(1))
    else:
        margin = np.abs(np.asarray(jsvc.decision_ovo(jp, X))).min(1)
        scale = np.full(len(margin),
                        1e-5 * np.abs(np.asarray(jp.pair_coef)).sum(1).max())
    lines = []
    for tj, tp in zip(chip_smoke.parse_tables(jax_out),
                      chip_smoke.parse_tables(port_out)):
        for (slot, a), (_, b) in zip(tj, tp):
            if a != b:
                lines.append(f"slot {slot}: JAX {a}, port {b}, margin "
                             f"{margin[slot]:.6g}, rounding {scale[slot]:.3g}")
    return "stdout differs; labels differ at:\n" + "\n".join(lines)


def _serve_family(capsys, monkeypatch, sub, jdir, tdir, argv):
    monkeypatch.delenv("TCSDN_KNN_TOPK", raising=False)
    monkeypatch.delenv("TCSDN_SVC_KERNEL", raising=False)
    jcli.main([sub, "--native-checkpoint", jdir, *argv, *JAX_SLICE_FLAGS])
    jax_io = capsys.readouterr()
    summary = tcli.main([sub, "--native-checkpoint", tdir, *argv,
                         "--device", "cpu"])
    return jax_io, capsys.readouterr(), summary


def _classes_shown(out: str) -> set:
    return {lab for t in chip_smoke.parse_tables(out) for _, lab in t}


@pytest.mark.parametrize("sub", ["knearest", "svm"])
def test_family_synthetic_serve_stdout_identical(tmp_path, capsys,
                                                 monkeypatch, sub):
    """The synthetic source on a table too small for its flows, as
    ``test_synthetic_serve_stdout_identical`` does for the forest."""
    syn = SyntheticFlows(n_flows=300)
    X = _sample_features([syn.tick() for _ in range(2)], 512)
    jp, jdir, tdir = _family_checkpoints(tmp_path, sub, X)
    argv = ["--source", "synthetic", "--synthetic-flows", "300",
            "--capacity", "256", "--max-ticks", "4", "--print-every", "2"]
    jax_io, port_io, summary = _serve_family(capsys, monkeypatch, sub, jdir,
                                             tdir, argv)
    assert port_io.out == jax_io.out, _near_tie_report(
        sub, jp, summary.engine, jax_io.out, port_io.out)
    assert port_io.out.count("Flow ID") == 2
    assert _warnings(port_io.err) == _warnings(jax_io.err) != []
    assert len(_classes_shown(port_io.out)) > 1
    assert summary.engine.num_flows() == 256


@pytest.mark.parametrize("table_rows", ["64", "0"])
@pytest.mark.parametrize("sub", ["knearest", "kneighbors", "svm"])
def test_family_replay_serve_stdout_identical(tmp_path, capsys, monkeypatch,
                                              sub, table_rows):
    """The replay capture of ``write_capture`` (counter wrap, reset, full
    wire, malformed lines, idle eviction), ranked and full renders."""
    cap = tmp_path / "capture.tsv"
    write_capture(cap)
    X = _sample_features(iter_capture(str(cap)), 64)
    key = "knearest" if sub == "kneighbors" else sub
    jp, jdir, tdir = _family_checkpoints(tmp_path, key, X)
    argv = ["--source", "replay", "--capture", str(cap), "--capacity", "64",
            "--print-every", "2", "--idle-timeout", "2",
            "--table-rows", table_rows]
    jax_io, port_io, summary = _serve_family(capsys, monkeypatch, sub, jdir,
                                             tdir, argv)
    assert port_io.out == jax_io.out, _near_tie_report(
        key, jp, summary.engine, jax_io.out, port_io.out)
    assert port_io.out.count("Flow ID") == 4
    assert len(_classes_shown(port_io.out)) > 1
    assert summary.engine.num_flows() == 40 - 13


def test_subcommand_must_match_the_checkpoint(tmp_path):
    X = np.random.RandomState(0).rand(8, 12).astype(np.float32)
    _, _, tdir = _family_checkpoints(tmp_path, "svm", X)
    with pytest.raises(SystemExit, match="'svc' model, not 'knn'"):
        tcli.main(["knearest", "--native-checkpoint", tdir,
                   "--source", "synthetic", "--device", "cpu"])

"""The port CLI's ``train`` and ``retrain`` subcommands, ``features16``
and the golden flow oracle (``core/flow.py``) against the JAX package's.

- ``train``: the CSV byte-identical to the JAX CLI's on one replay
  capture (counter wraps, resets, idle flows, malformed lines), with
  ``--native-ingest on`` and ``off`` and with two fan-in sources; the
  exit texts are JAX's.
- ``features16``: bitwise the JAX table's after every tick.
- ``GoldenFlow``: every field equal to JAX's after every update of a
  seeded record stream.
- ``retrain``: for each of the six families the report's layout and
  texts are JAX's line for line (digits aside) and the held-out accuracy
  is within 0.02 of JAX's (the trainer rule: other optimizers' and
  generators' arithmetic); the ``--checkpoint-every`` warning and error
  texts are JAX's.
"""

import contextlib
import dataclasses
import filecmp
import io
import json
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_serve import write_capture
from traffic_classifier_sdn_tpu import cli as jcli
from traffic_classifier_sdn_tpu.core import flow as jflow
from traffic_classifier_sdn_tpu.core import flow_table as jft
from traffic_classifier_sdn_tpu.ingest import batcher as jbatcher
from traffic_classifier_sdn_tpu.ingest import replay as jreplay
from traffic_classifier_sdn_tpu_torch import cli as tcli
from traffic_classifier_sdn_tpu_torch.core import flow as tflow
from traffic_classifier_sdn_tpu_torch.core import flow_table as tft
from traffic_classifier_sdn_tpu_torch.ingest import batcher as tbatcher
from traffic_classifier_sdn_tpu_torch.ingest import replay as treplay
from traffic_classifier_sdn_tpu_torch.io.checkpoint import load_model

SIX = ("logistic", "gaussiannb", "kmeans", "knearest", "Randomforest", "svm")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU fits here issue many small torch ops; one intra-op
    thread each keeps them from contending with the suite's other
    workers for every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        result = main(argv)
    return result, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cap") / "cap.txt")
    write_capture(path, n_flows=40, ticks=8)
    return path


@pytest.mark.parametrize("mode", [
    ["--native-ingest", "on"], ["--native-ingest", "off"],
    ["--sources", "2", "--source-lockstep"]],
    ids=["native", "python", "sources-2"])
def test_train_csv_byte_identical_to_jax(tmp_path, capture, mode):
    argv = ["train", "voice", "--source", "replay", "--capture", capture,
            "--capacity", "64", *mode]
    j, t = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    _, jout, _ = _run(jcli.main, argv + ["--out", j])
    summary, tout, _ = _run(tcli.main, argv + ["--out", t, "--device", "cpu"])
    assert filecmp.cmp(j, t, shallow=False)
    assert tout.replace(t, j) == jout == f"wrote {j}\n"
    with open(t) as f:
        lines = f.read().splitlines()
    assert summary.rows == len(lines) - 1 > 0
    assert len(summary.tick_seconds) == 8
    assert all(ln.endswith("\tvoice") for ln in lines[1:])


def test_train_exit_texts(tmp_path, capture):
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit) as ei:
            main(["train", "--source", "replay", "--capture", capture])
        assert ei.value.code == "ERROR: specify traffic type."
    outs = []
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        out = str(tmp_path / "dns.csv")
        _, text, _ = _run(main, ["train", "dns", "--source", "replay",
                                 "--capture", capture, "--duration", "0",
                                 "--out", out, *extra])
        outs.append(text)
    assert outs[0] == outs[1] == f"Finished collecting data.\nwrote {out}\n"
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        _, text, _ = _run(tcli.main, ["train", "ping", "--source", "replay",
                                      "--capture", capture, "--max-ticks",
                                      "1", "--device", "cpu"])
    finally:
        os.chdir(cwd)
    assert text == "wrote ping_training_data.csv\n"
    assert (tmp_path / "ping_training_data.csv").exists()


def test_features16_bitwise_equal_jax(capture):
    je = jbatcher.FlowStateEngine(64)
    te = tbatcher.FlowStateEngine(64, device="cpu")
    for jb, tb in zip(jreplay.iter_capture(capture),
                      treplay.iter_capture(capture)):
        je.ingest(jb)
        je.step()
        te.ingest(tb)
        te.step()
        want = np.asarray(jft.features16(je.table))
        got = tft.features16(te.table).numpy()
        assert got.shape == want.shape == (64, 16)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
        assert (got[~te.table.in_use[:-1].numpy()] == 0).all()


def test_golden_flow_equals_jax():
    rng = np.random.RandomState(3)
    args = (5, "dp1", "00:00:00:00:00:01", "00:00:00:00:00:02", 40, 5000,
            1, 2)
    j, t = jflow.GoldenFlow.create(*args), tflow.GoldenFlow.create(*args)
    pk, by = [40, 0], [5000, 0]
    for step in range(200):
        now = 5 + step // 2 + int(rng.randint(0, 2))
        side = int(rng.randint(0, 2))
        if rng.rand() < 0.8:  # counters grow, or sometimes stand still
            pk[side] += int(rng.randint(0, 50))
            by[side] += int(rng.randint(0, 9000))
        upd = ("update_forward", "update_reverse")[side]
        getattr(j, upd)(pk[side], by[side], now)
        getattr(t, upd)(pk[side], by[side], now)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.features12() == j.features12()
        assert t.features16() == j.features16()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("datasets")
    chip_smoke.reference_csvs(str(d), rows=40, files=chip_smoke.NOTEBOOK_CSVS)
    return str(d)


def _accuracy(text: str) -> float:
    return float(re.search(r"accuracy: ([0-9.]+)", text).group(1))


def _layout(text: str) -> list:
    return [re.sub(r"\d", "#", ln) for ln in text.splitlines()]


@pytest.mark.parametrize("sub", SIX)
def test_retrain_report_and_accuracy_match_jax(tmp_path, data_dir, sub):
    ckpt = str(tmp_path / "ckpt")
    _, want, _ = _run(jcli.main, ["retrain", sub, "--data-dir", data_dir])
    result, got, _ = _run(tcli.main, ["retrain", sub, "--data-dir", data_dir,
                                      "--native-checkpoint", ckpt,
                                      "--device", "cpu"])
    assert _layout(got)[:-1] == _layout(want)
    assert got.splitlines()[-1] == f"saved native checkpoint to {ckpt}"
    assert abs(_accuracy(got) - _accuracy(want)) <= 0.02, (got, want)
    assert abs(result.accuracy - _accuracy(got)) < 1e-4
    model = load_model(ckpt, device="cpu")
    assert model.name == result.family
    assert model.classes.names == result.classes == (
        "dns", "game", "ping", "quake", "telnet", "voice")


def test_retrain_unknown_family_text_is_jax(data_dir):
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit) as ei:
            main(["retrain", "nosuch", "--data-dir", data_dir])
        assert ei.value.code == (
            "ERROR: retrain needs a model family (logreg, gnb, kmeans, knn, "
            "svc, forest), got 'nosuch'")


def test_checkpoint_every_texts_are_jax(tmp_path, data_dir):
    """The warning for a family without the SGD trainer, the error for
    logreg without a train-state directory, and config
    ``train.checkpoint_every`` / ``train.train_state_dir`` driving the
    resumable trainer."""
    errs = []
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        _, _, err = _run(main, ["retrain", "gaussiannb", "--data-dir",
                                data_dir, "--checkpoint-every", "5", *extra])
        errs.append(err)
        with pytest.raises(SystemExit) as ei:
            main(["retrain", "logistic", "--data-dir", data_dir,
                  "--checkpoint-every", "5", *extra])
        errs.append(ei.value.code)
    assert errs[0] == errs[2] == (
        "WARNING: --checkpoint-every only applies to the logreg SGD "
        "trainer; ignored for gnb\n")
    assert errs[1] == errs[3] and errs[1].startswith(
        "ERROR: --checkpoint-every needs --train-state-dir")
    state = tmp_path / "state"
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"train": {"checkpoint_every": 500,
                                         "train_state_dir": str(state)}}))
    _run(tcli.main, ["retrain", "logistic", "--data-dir", data_dir,
                     "--config", str(cfg), "--device", "cpu"])
    with open(state / "manifest.json") as f:
        assert json.load(f)["step"] == 2000

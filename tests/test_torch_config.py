"""``--config`` in the port: ``config.py`` (a copy of the JAX package's
schema) round-trips through JSON in both packages alike, and the CLI
fills only the flags left unset from the file (a flag given wins),
``ingest.shards`` among them: a shard count the visible devices cannot
hold ends the serve with the JAX CLI's message; and ``train.*`` and
``model.checkpoint_dir`` fill the training flags."""

import dataclasses
import json

import pytest

from traffic_classifier_sdn_tpu import config as jconfig
from traffic_classifier_sdn_tpu_torch import cli as tcli
from traffic_classifier_sdn_tpu_torch import config as tconfig


def _custom(mod):
    return mod.Config(
        mesh=mod.MeshConfig(n_data=2),
        ingest=mod.IngestConfig(capacity=128, idle_timeout_s=7,
                                monitor_cmd="echo hi", buckets=(16, 64)),
        model=mod.ModelConfig(name="knn", native_checkpoint="/ckpt"),
        train=mod.TrainConfig(seed=3),
        print_every=3,
    )


def test_save_load_round_trip(tmp_path):
    cfg = _custom(tconfig)
    path = str(tmp_path / "cfg.json")
    tconfig.save(cfg, path)
    assert tconfig.load(path) == cfg
    assert dataclasses.asdict(jconfig.load(path)) == dataclasses.asdict(cfg)
    jconfig.save(_custom(jconfig), str(tmp_path / "jax.json"))
    assert tconfig.load(str(tmp_path / "jax.json")) == cfg
    assert (tmp_path / "jax.json").read_text() == (tmp_path / "cfg.json"
                                                   ).read_text()


def test_partial_and_unknown_keys(tmp_path):
    assert tconfig.from_dict({"ingest": {"capacity": 9}}).ingest.capacity == 9
    assert tconfig.from_dict({}) == tconfig.Config()
    with pytest.raises(ValueError, match="unknown IngestConfig keys"):
        tconfig.from_dict({"ingest": {"capacty": 9}})


def _args(argv, tmp_path, cfg: dict):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    parser = tcli._build_parser()
    args = parser.parse_args(["Randomforest", "--config", str(path), *argv])
    tcli._apply_config(args)
    return args


def test_config_fills_unset_flags(tmp_path):
    args = _args([], tmp_path, {
        "ingest": {"capacity": 256, "idle_timeout_s": 0,
                   "monitor_cmd": "python emit.py"},
        "model": {"native_checkpoint": "/ckpt"}, "print_every": 4})
    assert (args.capacity, args.idle_timeout, args.print_every,
            args.monitor_cmd, args.native_checkpoint) == (
        256, 0, 4, "python emit.py", "/ckpt")


def test_flags_win_over_config(tmp_path):
    args = _args(["--capacity", "64", "--idle-timeout", "5", "--print-every",
                  "1", "--monitor-cmd", "cat", "--native-checkpoint", "/a"],
                 tmp_path, {"ingest": {"capacity": 256, "idle_timeout_s": 0,
                                       "monitor_cmd": "x"},
                            "model": {"native_checkpoint": "/b"},
                            "print_every": 4})
    assert (args.capacity, args.idle_timeout, args.print_every,
            args.monitor_cmd, args.native_checkpoint) == (64, 5, 1, "cat",
                                                          "/a")


def test_config_fills_training_flags(tmp_path):
    args = _args([], tmp_path, {
        "model": {"checkpoint_dir": "/pickles"},
        "train": {"collect_duration_s": 30, "checkpoint_every": 50,
                  "train_state_dir": "/state"}})
    assert (args.checkpoint_dir, args.duration, args.checkpoint_every,
            args.train_state_dir) == ("/pickles", 30, 50, "/state")
    args = _args(["--duration", "5", "--checkpoint-every", "0"], tmp_path,
                 {"train": {"collect_duration_s": 30,
                            "checkpoint_every": 50}})
    assert (args.duration, args.checkpoint_every) == (5, 0)


def test_defaults_without_config():
    parser = tcli._build_parser()
    args = parser.parse_args(["Randomforest", "--native-checkpoint", "/a"])
    tcli._apply_config(args)
    assert (args.capacity, args.idle_timeout, args.print_every) == (
        65536, 60, 10)
    assert args.monitor_cmd is None
    assert (args.duration, args.checkpoint_every) == (900, None)


def test_shards_is_a_usage_error(tmp_path, capsys):
    """``ingest.shards`` fills ``--shards`` as the JAX CLI does (a given
    flag wins); a serve asking for more shards than the CPU's one visible
    device exits with the JAX CLI's message, before any engine exists."""
    args = _args(["--native-checkpoint", "/a"], tmp_path,
                 {"ingest": {"shards": 4}})
    assert args.shards == 4
    args = _args(["--native-checkpoint", "/a", "--shards", "1"], tmp_path,
                 {"ingest": {"shards": 4}})
    assert args.shards == 1
    import numpy as np

    import chip_smoke
    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.io import checkpoint as tck

    X = np.abs(np.random.RandomState(0).gamma(1, 100, (200, 12)))
    d = chip_smoke.random_forest(0, X.astype(np.float32), n_trees=2)
    tck.save_model(str(tmp_path / "ckpt"), "forest",
                   interop.forest_params_from_numpy(d, device="cpu"),
                   classes=("a", "b", "c", "d", "e", "f"))
    (tmp_path / "cfg.json").write_text(json.dumps({
        "ingest": {"capacity": 64, "shards": 2},
        "model": {"native_checkpoint": str(tmp_path / "ckpt")}}))
    with pytest.raises(SystemExit) as ei:
        tcli.main(["Randomforest", "--config", str(tmp_path / "cfg.json"),
                   "--source", "synthetic", "--device", "cpu"])
    assert ei.value.code == "--shards 2 needs 2 visible devices (have 1)"


def test_missing_checkpoint_is_a_usage_error(tmp_path, monkeypatch):
    """A missing checkpoint, as the JAX CLI handles it: with no
    ``--native-checkpoint`` the serve loads the reference pickle from
    ``--checkpoint-dir`` (default ``$TCSDN_MODELS_DIR``, then
    ``./models``), and a missing pickle raises FileNotFoundError naming
    its path in both CLIs."""
    from traffic_classifier_sdn_tpu import cli as jcli

    missing = str(tmp_path / "none")
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        with pytest.raises(FileNotFoundError,
                           match=f"{missing}/RandomForestClassifier"):
            main(["Randomforest", "--checkpoint-dir", missing,
                  "--source", "synthetic", *extra])
    monkeypatch.setenv("TCSDN_MODELS_DIR", missing)
    with pytest.raises(FileNotFoundError, match=f"{missing}/SVC"):
        tcli.main(["svm", "--source", "synthetic", "--device", "cpu"])


def test_config_serve_and_compilation_cache_note(tmp_path, capsys):
    """A serve whose checkpoint, capacity and cadence come from the
    config file; ``--compilation-cache-dir`` is accepted with a note."""
    import numpy as np

    import chip_smoke
    from traffic_classifier_sdn_tpu_torch import interop
    from traffic_classifier_sdn_tpu_torch.io import checkpoint as tck

    X = np.abs(np.random.RandomState(0).gamma(1, 100, (200, 12)))
    d = chip_smoke.random_forest(0, X.astype(np.float32), n_trees=4)
    tck.save_model(str(tmp_path / "ckpt"), "forest",
                   interop.forest_params_from_numpy(d, device="cpu"),
                   classes=("a", "b", "c", "d", "e", "f"))
    (tmp_path / "cfg.json").write_text(json.dumps({
        "ingest": {"capacity": 64},
        "model": {"native_checkpoint": str(tmp_path / "ckpt")},
        "print_every": 2}))
    summary = tcli.main(["Randomforest", "--config", str(tmp_path / "cfg.json"),
                         "--source", "synthetic", "--synthetic-flows", "16",
                         "--max-ticks", "4", "--device", "cpu",
                         "--pipeline", "off",
                         "--compilation-cache-dir", str(tmp_path / "cc")])
    io = capsys.readouterr()
    assert io.out.count("Flow ID") == 2
    assert summary.engine.table.capacity == 64
    assert "--compilation-cache-dir is ignored" in io.err
    assert not (tmp_path / "cc").exists()

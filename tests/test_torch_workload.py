"""``--source workload`` in the port: ``io/datasets.py`` and
``ingest/workload.py`` (copies of the JAX package's host modules) against
the JAX package's on the same seeded CSVs in the reference layout
(``chip_smoke.reference_csvs``; the reference datasets are not in the
repository), and the CLI serve against the JAX serial serve. Everything
here is host arithmetic on the same inputs, so the comparisons are exact.
"""

import contextlib
import io

import numpy as np
import pytest

import chip_smoke
from traffic_classifier_sdn_tpu import cli as jcli
from traffic_classifier_sdn_tpu.io import checkpoint as jck
from traffic_classifier_sdn_tpu.io import datasets as jdatasets
from traffic_classifier_sdn_tpu.ingest import workload as jworkload
from traffic_classifier_sdn_tpu.models import forest as jforest
from traffic_classifier_sdn_tpu_torch import cli as tcli
from traffic_classifier_sdn_tpu_torch import interop
from traffic_classifier_sdn_tpu_torch.ingest import workload as tworkload
from traffic_classifier_sdn_tpu_torch.ingest.batcher import FlowStateEngine
from traffic_classifier_sdn_tpu_torch.io import checkpoint as tck
from traffic_classifier_sdn_tpu_torch.io import datasets as tdatasets

CLASSES = ("dns", "game", "ping", "quake", "telnet", "voice")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("datasets")
    chip_smoke.reference_csvs(str(d), rows=64)
    return str(d)


def test_datasets_load_as_jax(data_dir):
    want = jdatasets.load_reference_datasets(data_dir)
    got = tdatasets.load_reference_datasets(data_dir)
    assert got.classes == want.classes == ("dns", "game", "ping", "telnet",
                                           "voice")
    for field in ("X16", "X", "y"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert tdatasets.REFERENCE_DATASET_FILES == jdatasets.REFERENCE_DATASET_FILES
    with pytest.raises(FileNotFoundError):
        tdatasets.load_reference_datasets(data_dir + "/none")


def test_pools_equal_jax(data_dir):
    want = jworkload.class_delta_pools(data_dir)
    got = tworkload.class_delta_pools(data_dir)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape[1] == 4 and (got[name] >= 0).all()
        np.testing.assert_array_equal(got[name], want[name])


def _fields(r) -> tuple:
    return (r.time, r.datapath, r.in_port, r.eth_src, r.eth_dst,
            r.out_port, r.packets, r.bytes)


@pytest.mark.parametrize("seed,flows", [(0, 2), (1, 3), (3, 8)])
def test_same_records_as_jax_for_a_seed(data_dir, seed, flows):
    pools = tworkload.class_delta_pools(data_dir)
    tw = tworkload.ClassWorkload(pools, flows_per_class=flows, seed=seed)
    jw = jworkload.ClassWorkload(jworkload.class_delta_pools(data_dir),
                                 flows_per_class=flows, seed=seed)
    assert tw.labels == jw.labels
    for _ in range(5):
        assert [_fields(r) for r in tw.tick()] == [_fields(r)
                                                   for r in jw.tick()]


def test_monotone_cumulative_counters(data_dir):
    wl = tworkload.ClassWorkload(tworkload.class_delta_pools(data_dir),
                                 flows_per_class=2, seed=1)
    last = {}
    for _ in range(5):
        for r in wl.tick():
            key = (r.eth_src, r.eth_dst)
            if key in last:
                assert r.packets >= last[key][0] and r.bytes >= last[key][1]
            last[key] = (r.packets, r.bytes)
    assert len(last) == 2 * len(wl.labels)  # both directions of every flow


def test_synthetic_pools_and_open_world_as_jax():
    tp = tworkload.synthetic_delta_pools(seed=2)
    jp = jworkload.synthetic_delta_pools(seed=2)
    for name in jp:
        np.testing.assert_array_equal(tp[name], jp[name])
    np.testing.assert_array_equal(tworkload.novel_delta_pool(tp, seed=1),
                                  jworkload.novel_delta_pool(jp, seed=1))
    tpp, jpp = (tworkload.perturb_pools(tp, 0.3, seed=4),
                jworkload.perturb_pools(jp, 0.3, seed=4))
    for name in jpp:
        np.testing.assert_array_equal(tpp[name], jpp[name])


def test_workload_drives_the_port_flow_table(data_dir):
    wl = tworkload.ClassWorkload(tworkload.class_delta_pools(data_dir),
                                 flows_per_class=4, seed=0)
    eng = FlowStateEngine(capacity=64, device="cpu")
    for _ in range(3):
        eng.ingest(wl.tick())
        eng.step()
    assert eng.num_flows() == len(wl.labels) == 20


@pytest.fixture(scope="module")
def forest_ckpts(tmp_path_factory, data_dir):
    ds = tdatasets.load_reference_datasets(data_dir)
    d = chip_smoke.random_forest(0, ds.X.astype(np.float32), n_trees=8)
    tmp = tmp_path_factory.mktemp("wl")
    jdir, tdir = str(tmp / "jax"), str(tmp / "port")
    jck.save_model(jdir, "forest", jforest.from_numpy(d), classes=CLASSES)
    tck.save_model(tdir, "forest",
                   interop.forest_params_from_numpy(d, device="cpu"),
                   classes=CLASSES)
    return jdir, tdir


@pytest.mark.parametrize("extra", [[], ["--table-rows", "0"]],
                         ids=["ranked", "full"])
def test_cli_workload_serve_stdout_equals_jax(data_dir, forest_ckpts, extra):
    jdir, tdir = forest_ckpts
    argv = ["--source", "workload", "--data-dir", data_dir,
            "--synthetic-flows", "40", "--capacity", "64", "--max-ticks",
            "6", "--print-every", "2", "--pipeline", "off", *extra]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jcli.main(["Randomforest", "--native-checkpoint", jdir, *argv])
    want = buf.getvalue()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = tcli.main(["Randomforest", "--native-checkpoint", tdir,
                             *argv, "--degrade", "off", "--device", "cpu"])
    assert buf.getvalue() == want
    assert want.count("Flow ID") == 3 and summary.engine.num_flows() == 40


def test_data_dir_defaults_to_the_env(monkeypatch, tmp_path):
    monkeypatch.setenv("TCSDN_DATA_DIR", str(tmp_path))
    args = tcli._build_parser().parse_args(["Randomforest"])
    assert args.data_dir == str(tmp_path)
    monkeypatch.delenv("TCSDN_DATA_DIR")
    assert tcli._build_parser().parse_args(["Randomforest"]).data_dir == \
        "datasets"

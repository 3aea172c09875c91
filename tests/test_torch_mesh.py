"""The port's device mesh (``parallel/mesh.py``) against the JAX package's
``parallel/mesh.py``: the same (data, state) shapes and refusals, a device
list that may repeat one device (N shards on one CPU or one card), and
the placement helpers that stand in for JAX's shardings — replicated
params (one copy per distinct device), batch- and state-sharded rows."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from traffic_classifier_sdn_tpu.parallel import mesh as jmesh
from traffic_classifier_sdn_tpu_torch.parallel import mesh as tmesh

CPU = torch.device("cpu")


@pytest.mark.parametrize("n_data,n_state", [(None, 1), (4, 2), (1, 8),
                                            (2, 4)])
def test_mesh_shapes_match_jax(n_data, n_state):
    jm = jmesh.make_mesh(n_data=n_data, n_state=n_state)
    tm = tmesh.make_mesh(n_data=n_data, n_state=n_state,
                         devices=[CPU] * len(jax.devices()))
    assert tm.devices.shape == jm.devices.shape
    assert tm.shape[tmesh.DATA_AXIS] == jm.shape[jmesh.DATA_AXIS]
    assert tm.shape[tmesh.STATE_AXIS] == jm.shape[jmesh.STATE_AXIS]
    assert (tmesh.DATA_AXIS, tmesh.STATE_AXIS) == jm.axis_names


def test_mesh_refuses_a_shape_the_devices_do_not_fill():
    with pytest.raises(ValueError, match="mesh 3x2 != 8 devices"):
        tmesh.make_mesh(n_data=3, n_state=2, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        jmesh.make_mesh(n_data=3, n_state=2)


def test_visible_devices_on_the_cpu_is_one_device():
    assert tmesh.visible_devices("cpu") == [CPU]


def test_default_mesh_wants_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()


def test_axis_devices_in_shard_order():
    devs = [torch.device("cpu")] * 6
    m = tmesh.make_mesh(n_data=3, n_state=2, devices=devs)
    assert m.axis_devices(tmesh.DATA_AXIS) == [CPU] * 3
    assert m.axis_devices(tmesh.STATE_AXIS) == [CPU] * 2
    with pytest.raises(ValueError, match="unknown mesh axis"):
        m.axis_devices("model")


@dataclasses.dataclass
class _Ops:
    w: torch.Tensor
    groups: list
    n: int


def test_replicated_shares_one_copy_per_device():
    """Shards on one device share the caller's object: no copy, so N
    shards on one card hold one set of operands."""
    ops = _Ops(w=torch.ones(3), groups=[torch.zeros(2)], n=3)
    m = tmesh.make_mesh(devices=["cpu"] * 4)
    reps = tmesh.replicated(m, ops)
    assert len(reps) == 4 and all(r is ops for r in reps)
    module = torch.nn.Linear(2, 2)
    assert tmesh.to_device(module, CPU) is module
    assert tmesh.to_device(None, CPU) is None
    assert tmesh.to_device({"a": ops.w}, CPU)["a"] is ops.w


@pytest.mark.parametrize("axis", ["data", "state"])
def test_sharded_rows_split_in_order(axis):
    X = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    if axis == "data":
        m = tmesh.make_mesh(n_data=4, devices=["cpu"] * 4)
        parts = tmesh.batch_sharded(m, X)
    else:
        m = tmesh.make_mesh(n_data=1, n_state=4, devices=["cpu"] * 4)
        parts = tmesh.state_sharded(m, X)
    assert [tuple(p.shape) for p in parts] == [(2, 3)] * 4
    np.testing.assert_array_equal(torch.cat(parts).numpy(), X.numpy())
    with pytest.raises(ValueError, match="do not split"):
        tmesh.batch_sharded(tmesh.make_mesh(devices=["cpu"] * 3), X)

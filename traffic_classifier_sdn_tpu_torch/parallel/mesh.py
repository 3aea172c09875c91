"""The device mesh of the port: the one parallelism substrate of its
sharded modules — the port of ``traffic_classifier_sdn_tpu/parallel/mesh.py``.

The JAX package runs one ``jax.sharding.Mesh`` under a single controller
process: one host program owns the global state and every shard's device
work. The port keeps that shape with no collective runtime: a ``Mesh`` is
a grid of ``torch.device``s, a sharded value is a list of per-shard
tensors (each on its shard's device), and each JAX collective is an
explicit gather or sum of those tensors, in shard order, by the host
program. Two axes, as in JAX:

- ``data`` — the flow batch and the flow table (``table_sharded.py``);
- ``state`` — model state: the KNN corpus, the forest's trees, the SVC's
  support vectors (``knn_sharded.py``, ``forest_sharded.py``,
  ``svc_sharded.py``).

``make_mesh`` accepts a device list that repeats one device: N shards on
one CPU or on one card, the port's counterpart of the JAX tests'
``--xla_force_host_platform_device_count=8``. Multi-host bring-up
(``init_distributed``) is not ported.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
from torch import nn

from ..device import resolve_device

DATA_AXIS = "data"
STATE_AXIS = "state"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an (n_data, n_state) object array of ``torch.device``;
    ``shape[DATA_AXIS]`` and ``shape[STATE_AXIS]`` are its two sizes."""

    devices: np.ndarray

    @property
    def shape(self) -> dict:
        n_data, n_state = self.devices.shape
        return {DATA_AXIS: n_data, STATE_AXIS: n_state}

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis``, in shard order (the first row or
        column: the other axis's replicas hold the same shards)."""
        if axis == DATA_AXIS:
            return list(self.devices[:, 0])
        if axis == STATE_AXIS:
            return list(self.devices[0, :])
        raise ValueError(f"unknown mesh axis {axis!r}")


def visible_devices(device=None) -> list[torch.device]:
    """Every device a mesh may use on ``device``'s kind: each CUDA device
    of the process, or the one ``cpu`` device."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_data: int | None = None, n_state: int = 1,
              devices=None) -> Mesh:
    """A (data, state) mesh over ``devices`` (default: every visible CUDA
    device), all on the data axis unless ``n_data`` says otherwise. A
    device may appear more than once."""
    devs = list(devices) if devices is not None else visible_devices()
    if n_data is None:
        n_data = len(devs) // n_state
    if n_data * n_state != len(devs):
        raise ValueError(f"mesh {n_data}x{n_state} != {len(devs)} devices")
    grid = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            # the index a tensor placed there reports, so placements on
            # "cuda" and "cuda:<current>" are one device
            d = torch.device("cuda", torch.cuda.current_device())
        grid[i] = d
    return Mesh(grid.reshape(n_data, n_state))


def to_device(obj, device: torch.device):
    """``obj`` with every tensor it holds on ``device``: a tensor, an
    ``nn.Module`` (copied), a dataclass, a list, tuple or dict of these,
    or anything else unchanged. An object already on ``device`` comes back
    as it is, so shards on one device share one copy."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, nn.Module):
        first = next(iter(obj.buffers()), None)
        if first is None or first.device == device:
            return obj
        return copy.deepcopy(obj).to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        moved = {f.name: to_device(getattr(obj, f.name), device)
                 for f in dataclasses.fields(obj)}
        if all(moved[k] is getattr(obj, k) for k in moved):
            return obj
        return dataclasses.replace(obj, **moved)
    if isinstance(obj, (list, tuple)):
        moved = [to_device(o, device) for o in obj]
        if all(a is b for a, b in zip(moved, obj)):
            return obj
        return type(obj)(moved)
    if isinstance(obj, dict):
        moved = {k: to_device(v, device) for k, v in obj.items()}
        if all(moved[k] is obj[k] for k in obj):
            return obj
        return moved
    return obj


def replicated(mesh: Mesh, obj, axis: str = DATA_AXIS) -> list:
    """``obj`` on every device along ``axis``: one entry per shard, one
    copy per distinct device."""
    copies: dict = {}
    out = []
    for dev in mesh.axis_devices(axis):
        if dev not in copies:
            copies[dev] = to_device(obj, dev)
        out.append(copies[dev])
    return out


def _split_rows(mesh: Mesh, X: torch.Tensor, axis: str) -> list:
    devs = mesh.axis_devices(axis)
    n = len(devs)
    if X.shape[0] % n:
        raise ValueError(f"{X.shape[0]} rows do not split over {n} shards")
    per = X.shape[0] // n
    return [X[s * per: (s + 1) * per].to(dev) for s, dev in enumerate(devs)]


def batch_sharded(mesh: Mesh, X: torch.Tensor) -> list:
    """Rows of an (N, …) batch split over the data axis, one contiguous
    block per shard on its device."""
    return _split_rows(mesh, X, DATA_AXIS)


def state_sharded(mesh: Mesh, X: torch.Tensor) -> list:
    """The leading axis of model state split over the state axis."""
    return _split_rows(mesh, X, STATE_AXIS)

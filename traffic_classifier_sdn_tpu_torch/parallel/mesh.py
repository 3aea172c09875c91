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
``--xla_force_host_platform_device_count=8``.

Multi-host (JAX's ``jax.distributed``): ``init_distributed`` joins this
process to a ``torch.distributed`` group (gloo, whose collectives move
host tensors) as one rank of several. ``make_mesh`` with no device list
then builds the GLOBAL mesh, every rank's ``local_devices()`` in rank
order (JAX's ``jax.devices()``), and records the rank that owns each slot
(``Mesh.owners``). A shard's tensors exist only on its owner: the
per-shard lists hold ``None`` in the other ranks' slots. Every rank runs
the same host program (SPMD), computes its own shards and trades host
copies of their outputs through ``exchange``, which returns every shard's
in shard order, never in rank-arrival order; so each rank's results are
bitwise those of the one-process mesh with the same shard count.
``shard_sum`` (the ``psum``) goes through ``gather_tensors``, its
fixed-shape twin (a tensor ``all_gather``, no pickling). ``permute`` (the
``ppermute``) moves blocks point to point between named shards, the KNN
ring and tournament's hops; ``broadcast`` hands the host arrays of the
process owning shard 0 to every rank (the forest fit's draws). The
exchanges are collectives: every rank must make the same ones in the
same order, from one thread.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import os
import time

import numpy as np
import torch
from torch import nn

from ..device import resolve_device

DATA_AXIS = "data"
STATE_AXIS = "state"


# the seconds a rank waits for the rendezvous or a peer's collective
# before it raises: a lost peer ends the program, never hangs it
DEFAULT_TIMEOUT_S = 60.0

# this rank's device kind (None: the default) and the group's timeout in
# seconds, set by init_distributed
_LOCAL_KIND: dict = {"device": None, "timeout": DEFAULT_TIMEOUT_S}

# what the exchanges of this process moved: calls, bytes of the arrays
# sent and received, seconds inside the collective
EXCHANGE_STATS = {"calls": 0, "bytes_sent": 0, "bytes_received": 0,
                  "seconds": 0.0}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an (n_data, n_state) object array of ``torch.device``;
    ``shape[DATA_AXIS]`` and ``shape[STATE_AXIS]`` are its two sizes.
    ``owners``: None when this process owns every slot, else the
    (n_data, n_state) rank of each slot's process (a mesh spanning a
    process group)."""

    devices: np.ndarray
    owners: np.ndarray | None = None

    @property
    def shape(self) -> dict:
        n_data, n_state = self.devices.shape
        return {DATA_AXIS: n_data, STATE_AXIS: n_state}

    @property
    def spans_processes(self) -> bool:
        return self.owners is not None

    def _axis(self, grid: np.ndarray, axis: str) -> list:
        if axis == DATA_AXIS:
            return list(grid[:, 0])
        if axis == STATE_AXIS:
            return list(grid[0, :])
        raise ValueError(f"unknown mesh axis {axis!r}")

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis``, in shard order (the first row or
        column: the other axis's replicas hold the same shards). On a mesh
        spanning processes a slot of another rank names that rank's
        device: nothing is placed there from this process."""
        return self._axis(self.devices, axis)

    def local_shards(self, axis: str) -> list[int]:
        """The shard indices along ``axis`` this process owns, ascending:
        every one of them unless the mesh spans processes."""
        n = len(self.axis_devices(axis))
        if self.owners is None:
            return list(range(n))
        me = process_index()
        return [s for s, r in enumerate(self._axis(self.owners, axis))
                if int(r) == me]


def visible_devices(device=None) -> list[torch.device]:
    """Every device a mesh may use on ``device``'s kind: each CUDA device
    of the process, or the one ``cpu`` device. ``TCSDN_SHARDS_PER_DEVICE=K``
    lists each device K times, so a ``--shards`` serve places K shards on
    each (the fleet launcher sets it when a member's shards outnumber the
    devices)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        devs = [torch.device("cpu")]
    else:
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    k = int(os.environ.get("TCSDN_SHARDS_PER_DEVICE", "1") or 1)
    return [d for d in devs for _ in range(max(1, k))]


def _distributed():
    """``torch.distributed`` when this process is a rank of a group, else
    None."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def init_distributed(coordinator: str | None = None, *,
                     coordinator_address: str | None = None,
                     num_processes: int, process_id: int,
                     init_method: str | None = None,
                     initialization_timeout: float = DEFAULT_TIMEOUT_S,
                     device=None) -> None:
    """Multi-host bring-up with JAX's keyword names: join this process to
    a gloo group as rank ``process_id`` of ``num_processes``. A
    ``"host:port"`` coordinator becomes ``tcp://host:port``; an
    ``init_method`` (for example ``file:///path``), or a coordinator
    already in URL form, is passed through. The timeout is finite, so a
    lost peer raises. ``device`` is the kind of this rank's devices
    (default: the card; ``"cpu"`` for the tests), which ``local_devices``
    and a global ``make_mesh`` list."""
    import torch.distributed as dist

    coordinator = coordinator or coordinator_address
    if init_method is None:
        if coordinator is None:
            raise ValueError("init_distributed needs a coordinator or an "
                             "init_method")
        init_method = (coordinator if "://" in coordinator
                       else f"tcp://{coordinator}")
    elif coordinator is not None:
        raise ValueError("pass a coordinator or an init_method, not both")
    dist.init_process_group(
        backend="gloo", init_method=init_method,
        world_size=int(num_processes), rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(initialization_timeout)))
    _LOCAL_KIND["device"] = device
    _LOCAL_KIND["timeout"] = float(initialization_timeout)


def shutdown_distributed() -> None:
    """Leave the group (no-op outside one)."""
    dist = _distributed()
    if dist is not None:
        dist.destroy_process_group()
    _LOCAL_KIND["device"] = None
    _LOCAL_KIND["timeout"] = DEFAULT_TIMEOUT_S


def process_index() -> int:
    """This process's rank (0 outside a group)."""
    dist = _distributed()
    return dist.get_rank() if dist is not None else 0


def process_count() -> int:
    """The ranks of the group (1 outside one)."""
    dist = _distributed()
    return dist.get_world_size() if dist is not None else 1


def local_devices() -> list[torch.device]:
    """This process's devices: ``visible_devices`` of the kind
    ``init_distributed`` was given (JAX's ``jax.local_devices()``)."""
    return visible_devices(_LOCAL_KIND["device"])


def _grid(devs: list) -> np.ndarray:
    grid = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            # the index a tensor placed there reports, so placements on
            # "cuda" and "cuda:<current>" are one device
            d = torch.device("cuda", torch.cuda.current_device())
        grid[i] = d
    return grid


def make_mesh(n_data: int | None = None, n_state: int = 1,
              devices=None) -> Mesh:
    """A (data, state) mesh over ``devices`` (default: every visible CUDA
    device), all on the data axis unless ``n_data`` says otherwise. A
    device may appear more than once. In a process group and with no
    ``devices``, the global mesh: every rank's ``local_devices()`` in rank
    order, each slot owned by its rank; a device list always makes a mesh
    of this process alone. A global mesh of several ranks with both axes
    above 1 raises ``ValueError``: each axis's shards belong to the ranks
    of its first row or column, which a grid need not give every rank."""
    owners = None
    dist = _distributed() if devices is None else None
    if dist is not None:
        local = [str(d) for d in _grid(local_devices())]
        per_rank: list = [None] * dist.get_world_size()
        dist.all_gather_object(per_rank, local)
        devs = [d for devs in per_rank for d in devs]
        owners = np.asarray([r for r, devs in enumerate(per_rank)
                             for _ in devs], dtype=np.int64)
    else:
        devs = list(devices) if devices is not None else visible_devices()
    if n_data is None:
        n_data = len(devs) // n_state
    if n_data * n_state != len(devs):
        raise ValueError(f"mesh {n_data}x{n_state} != {len(devs)} devices")
    grid = _grid(devs).reshape(n_data, n_state)
    if owners is None:
        return Mesh(grid)
    if n_data > 1 and n_state > 1 and dist.get_world_size() > 1:
        raise ValueError(
            f"a {n_data}x{n_state} mesh over {dist.get_world_size()} "
            "processes is refused: a mesh spanning processes has one axis "
            "of size 1, (N, 1) for the data axis or (1, N) for the state "
            "axis. Each axis's shards are owned through its first row or "
            "column, so in a grid with both axes above 1 some rank would "
            "own no shard of an axis it sums over")
    return Mesh(grid, owners.reshape(n_data, n_state))


def exchange(mesh: Mesh, axis: str, parts: list) -> list:
    """Every shard's host arrays, in shard order, from this rank's:
    ``parts`` holds one entry per shard along ``axis`` — a tuple of numpy
    arrays for each shard this process owns, anything (None) for the
    others — and the result fills the others' entries with what their
    owners sent. One gloo ``all_gather_object`` of {shard: arrays}; the
    identity when the mesh does not span processes."""
    if not mesh.spans_processes:
        return list(parts)
    dist = _distributed()
    mine = {s: tuple(parts[s]) for s in mesh.local_shards(axis)}
    got: list = [None] * dist.get_world_size()
    t0 = time.perf_counter()
    dist.all_gather_object(got, mine)
    EXCHANGE_STATS["seconds"] += time.perf_counter() - t0
    EXCHANGE_STATS["calls"] += 1
    out = list(parts)
    for rank, theirs in enumerate(got):
        nbytes = sum(a.nbytes for arrays in theirs.values() for a in arrays)
        if rank == dist.get_rank():
            EXCHANGE_STATS["bytes_sent"] += nbytes
            continue
        EXCHANGE_STATS["bytes_received"] += nbytes
        for s, arrays in theirs.items():
            out[s] = arrays
    return out


def permute(mesh: Mesh, axis: str, parts: list, perm) -> list:
    """The port's ``lax.ppermute``: ``parts`` holds one block (a tuple of
    tensors) for each shard along ``axis`` this process owns, None in the
    other slots; ``perm`` lists (source shard, destination shard) pairs,
    each destination at most once. Returns, for each destination shard
    this process owns, the block its source sent, on the destination's
    device (None in every other slot). Between two shards of one process a
    block moves device to device; between ranks it is a gloo ``isend`` /
    ``irecv`` of host copies, every receive and send posted before any
    wait and each wait bounded by the group's timeout. Every block of a
    call has the shapes and dtypes of this process's own, which size the
    receive buffers: a call moves the blocks its pairs name, point to
    point, and nothing else."""
    devs = mesh.axis_devices(axis)
    out: list = [None] * len(devs)
    if not mesh.spans_processes:
        for src, dst in perm:
            out[dst] = tuple(t.to(devs[dst]) for t in parts[src])
        return out
    dist = _distributed()
    me = dist.get_rank()
    owners = [int(r) for r in mesh._axis(mesh.owners, axis)]
    own = [p for p in parts if p is not None]
    if not own:
        raise ValueError("permute needs a block of a shard this process "
                         "owns")
    template = own[0]
    works, held, recvs = [], [], []
    t0 = time.perf_counter()
    for src, dst in perm:
        # one tag per destination and tensor: a destination has one source
        tag = dst * len(template)
        if owners[src] == me and owners[dst] == me:
            out[dst] = tuple(t.to(devs[dst]) for t in parts[src])
        elif owners[src] == me:
            for j, t in enumerate(parts[src]):
                host = t.detach().cpu().contiguous()
                held.append(host)  # alive until its send is waited on
                works.append(dist.isend(host, owners[dst], tag=tag + j))
        elif owners[dst] == me:
            bufs = tuple(torch.empty(t.shape, dtype=t.dtype)
                         for t in template)
            for j, b in enumerate(bufs):
                works.append(dist.irecv(b, owners[src], tag=tag + j))
            recvs.append((dst, bufs))
    timeout = datetime.timedelta(seconds=_LOCAL_KIND["timeout"])
    for w in works:
        w.wait(timeout)
    EXCHANGE_STATS["seconds"] += time.perf_counter() - t0
    EXCHANGE_STATS["calls"] += 1
    EXCHANGE_STATS["bytes_sent"] += sum(h.nbytes for h in held)
    for dst, bufs in recvs:
        EXCHANGE_STATS["bytes_received"] += sum(b.nbytes for b in bufs)
        out[dst] = tuple(b.to(devs[dst]) for b in bufs)
    return out


def broadcast(mesh: Mesh, axis: str, arrays: tuple | None) -> tuple:
    """The host arrays of the process owning shard 0 along ``axis``, on
    every process (``arrays`` is read there only): one gloo
    ``broadcast_object_list``; ``arrays`` itself when the mesh does not
    span processes."""
    if not mesh.spans_processes:
        return arrays
    dist = _distributed()
    src = int(mesh._axis(mesh.owners, axis)[0])
    box = [tuple(arrays) if dist.get_rank() == src else None]
    t0 = time.perf_counter()
    dist.broadcast_object_list(box, src=src)
    EXCHANGE_STATS["seconds"] += time.perf_counter() - t0
    EXCHANGE_STATS["calls"] += 1
    nbytes = sum(a.nbytes for a in box[0])
    key = "bytes_sent" if dist.get_rank() == src else "bytes_received"
    EXCHANGE_STATS[key] += nbytes
    return box[0]


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
    copy per distinct device (None in another rank's slots)."""
    copies: dict = {}
    out: list = [None] * len(mesh.axis_devices(axis))
    for s in mesh.local_shards(axis):
        dev = mesh.axis_devices(axis)[s]
        if dev not in copies:
            copies[dev] = to_device(obj, dev)
        out[s] = copies[dev]
    return out


def gather_tensors(mesh: Mesh, axis: str, parts: list) -> list:
    """Every shard's tensor along ``axis``, in shard order, as host
    tensors, from this rank's (``parts``: a tensor for each shard this
    process owns, None in the others' slots; one shape and dtype in
    all). One gloo ``all_gather`` of host tensors, no pickling: each rank
    sends its shards stacked in ascending order, padded to the most
    shards a rank owns."""
    dist = _distributed()
    me = dist.get_rank()
    owners = [int(r) for r in mesh._axis(mesh.owners, axis)]
    by_rank = [[s for s, r in enumerate(owners) if r == rank]
               for rank in range(dist.get_world_size())]
    template = parts[by_rank[me][0]]
    stack = torch.zeros((max(map(len, by_rank)), *template.shape),
                        dtype=template.dtype)
    for j, s in enumerate(by_rank[me]):
        stack[j] = parts[s].detach().cpu()
    got = [torch.empty_like(stack) for _ in by_rank]
    t0 = time.perf_counter()
    dist.all_gather(got, stack)
    EXCHANGE_STATS["seconds"] += time.perf_counter() - t0
    EXCHANGE_STATS["calls"] += 1
    out: list = [None] * len(owners)
    for rank, shards in enumerate(by_rank):
        nbytes = len(shards) * template.numel() * template.element_size()
        key = "bytes_sent" if rank == me else "bytes_received"
        EXCHANGE_STATS[key] += nbytes
        for j, s in enumerate(shards):
            out[s] = got[rank][j]
    return out


def shard_sum(parts: list, mesh: Mesh | None = None,
              axis: str = DATA_AXIS) -> torch.Tensor:
    """Per-shard partial sums added in shard order on the first shard's
    device: the port's ``psum`` (a fixed order, so a sum over the same
    shards rounds the same way on every run). On a ``mesh`` spanning
    processes, ``parts`` holds this rank's shards along ``axis`` (None in
    the others'); every shard's part comes through ``gather_tensors`` and
    each rank adds them all, in shard order, on its first shard's
    device."""
    if mesh is not None and mesh.spans_processes:
        local = mesh.local_shards(axis)
        dev = parts[local[0]].device
        parts = [h.to(dev) for h in gather_tensors(mesh, axis, parts)]
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return total


def _split_rows(mesh: Mesh, X: torch.Tensor, axis: str) -> list:
    devs = mesh.axis_devices(axis)
    n = len(devs)
    if X.shape[0] % n:
        raise ValueError(f"{X.shape[0]} rows do not split over {n} shards")
    per = X.shape[0] // n
    out: list = [None] * n
    for s in mesh.local_shards(axis):
        out[s] = X[s * per: (s + 1) * per].to(devs[s])
    return out


def batch_sharded(mesh: Mesh, X: torch.Tensor) -> list:
    """Rows of an (N, …) batch split over the data axis, one contiguous
    block per shard on its device (None in another rank's slots)."""
    return _split_rows(mesh, X, DATA_AXIS)


def state_sharded(mesh: Mesh, X: torch.Tensor) -> list:
    """The leading axis of model state split over the state axis."""
    return _split_rows(mesh, X, STATE_AXIS)

"""Warm-restart checkpoints of the SERVING state — the port of
``traffic_classifier_sdn_tpu/io/serving_checkpoint.py``.

A checkpoint holds the live serving spine, so a restarted classifier
resumes with every flow's counters, rates and slot intact:

- the device ``FlowTable`` (every leaf, fetched to host numpy),
- the host flow index (per-slot flow keys, metadata and the
  sequential-assignment frontier; the C++ engine exports its fingerprints
  through ``NativeBatcher.export_index``, the Python index its key dicts),
- the tick clock and the render-freshness floor.

**The format is the JAX package's.** The same keys, dtypes, shapes and
content CRC: a checkpoint the JAX package writes restores here, and one
written here restores there (``tests/test_torch_serving_checkpoint.py``).
The port's table holds the ``*_lo`` counters as int32 bit patterns
(core/flow_table.py); they cross the file as the JAX table's uint32 —
the same 32 bits, reinterpreted, never converted. The Python index keys
with BLAKE2b-64 (``ingest.protocol.stable_flow_key``) and the C++ engine
with its own fingerprint, in the port exactly as in JAX, so a checkpoint
records which index wrote it and restores only onto the same kind.

The on-disk table is in the GLOBAL slot layout whichever spine wrote
it: a sharded engine's leaves (parallel/table_sharded.py) interleave by
its routing invariant — global slot g lives on shard g % n_shards at
local row g // n_shards — so a checkpoint restores across spine kinds
(``restore`` onto one device, ``restore_sharded`` onto a mesh) and
across packages.

Restore rebuilds a ``FlowStateEngine`` on the caller's device (CUDA
unless asked for the CPU) that continues exactly: existing flows resolve
to their old slots, the mod-2³² delta math picks up from the stored
``*_lo`` counters, idle eviction keeps its clock, and the free stack is
restored verbatim (allocation is LIFO). What the file does not carry is
rebuilt, not restored: the pinned wire staging of an engine on a card,
and the incremental label cache (a restored serve under ``--incremental
auto`` starts all-dirty, ``enable_dirty_tracking``).

Durability:

- ``save`` is atomic (``utils.atomicio``: temp file in the target
  directory, fsync, ``os.replace``) and embeds a CRC32 of its own content
  (each array's name, dtype, shape and bytes); ``restore`` rejects a
  mismatch with ``CorruptCheckpointError``.
- ``save_rotating`` writes tick-numbered members (``ckpt-000000123.npz``)
  with keep-N pruning under a per-directory lock (a second in-process
  writer can neither sweep the first one's temp nor prune its fresh
  member); ``resolve_latest`` returns the newest member that validates,
  so a torn or bit-flipped newest member rolls back to its predecessor.
- Fault sites (utils/faults.py): ``serving_ckpt.write`` mid temp write,
  ``serving_ckpt.rename`` at the rename, ``serving_ckpt.restore`` at
  restore entry.

Format v3 adds the optional ``feature_reference/`` block (the drift
monitor's and the open-set gate's reference statistics): ``restore``
hands it back on ``engine.feature_reference``, where the drift loop and
the gate boot from it. v2 checkpoints (no block) load; v1 is refused as
old-format.
"""

from __future__ import annotations

import dataclasses
import io
import os
import re
import threading
import zipfile
import zlib

import numpy as np
import torch

from ..core import flow_table as ft
from ..utils.atomicio import atomic_write_bytes, sweep_stale_tmp
from ..utils.faults import fault_point

FORMAT_VERSION = 3
# oldest format this build restores (v1 predates the content checksum and
# is rejected as old-format, never as corruption)
MIN_FORMAT_VERSION = 2

_CKPT_RE = re.compile(r"^ckpt-(\d+)\.npz$")
_REF_PREFIX = "feature_reference/"

# Per-directory rotation locks: keep-N pruning and sweep_stale_tmp assume
# one rotation pass in flight, so whole passes serialize per directory.
_dir_locks: dict[str, threading.Lock] = {}
_dir_registry_lock = threading.Lock()


def _rotation_lock(directory: str) -> threading.Lock:
    key = os.path.abspath(directory)
    with _dir_registry_lock:
        lock = _dir_locks.get(key)
        if lock is None:
            lock = _dir_locks[key] = threading.Lock()
        return lock


class CorruptCheckpointError(ValueError):
    """A checkpoint file that cannot be trusted: torn write, bit flip,
    truncated archive, or missing keys. Names the offending file."""


_DIR_FIELDS = tuple(f.name for f in dataclasses.fields(ft.DirState))
_TABLE_LEAVES = (
    "time_start", "in_use",
    *(f"fwd.{f}" for f in _DIR_FIELDS),
    *(f"rev.{f}" for f in _DIR_FIELDS),
)
# counters the port holds as int32 bit patterns and the file as uint32
_U32_FIELDS = ("pkts_lo", "bytes_lo")


def _leaf(table: ft.FlowTable, name: str) -> torch.Tensor:
    if "." in name:
        side, field = name.split(".")
        return getattr(getattr(table, side), field)
    return getattr(table, name)


def _fetch_leaf(table: ft.FlowTable, name: str) -> np.ndarray:
    """One table leaf as the JAX table's host array: the (capacity+1,)
    layout and dtype, ``*_lo`` counters as uint32."""
    arr = _leaf(table, name).cpu().numpy()
    if name.split(".")[-1] in _U32_FIELDS:
        arr = arr.view(np.uint32)
    return arr


def _is_sharded(engine) -> bool:
    # ShardedFlowEngine holds per-shard ``tables``; the single-device
    # spine one ``table``
    return getattr(engine, "tables", None) is not None


def _global_leaf(engine, name: str) -> np.ndarray:
    """One table leaf in the GLOBAL (capacity+1,) slot layout, whichever
    spine holds it: a sharded engine's per-shard (local+1,) leaves
    interleave by the routing invariant, and the global scratch row is
    written zeroed (each shard's scratch is a local scatter target, never
    state)."""
    if not _is_sharded(engine):
        return _fetch_leaf(engine.table, name)
    stacked = np.stack([_fetch_leaf(t, name) for t in engine.tables])
    n, local = stacked.shape[0], stacked.shape[1] - 1
    cap = n * local
    glob = np.zeros((cap + 1,) + stacked.shape[2:], stacked.dtype)
    glob[:cap] = np.swapaxes(stacked[:, :local], 0, 1).reshape(
        (cap,) + stacked.shape[2:]
    )
    return glob


def _device_leaf(arr: np.ndarray, name: str, device) -> torch.Tensor:
    """The inverse of ``_fetch_leaf``: the port's tensor of a file leaf."""
    arr = np.ascontiguousarray(arr)
    if name.split(".")[-1] in _U32_FIELDS:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


def _content_crc(data: dict) -> int:
    """CRC32 over every entry's name, dtype, shape and raw bytes (sorted
    key order), over the uncompressed content: it survives recompression
    and catches corruption the zip layer never sees."""
    crc = 0
    for key in sorted(data):
        if key == "crc32":
            continue
        arr = np.ascontiguousarray(np.asarray(data[key]))
        meta = f"{key}|{arr.dtype.str}|{arr.shape}|".encode()
        crc = zlib.crc32(arr.tobytes(), zlib.crc32(meta, crc))
    return crc & 0xFFFFFFFF


def _index_arrays(engine) -> dict:
    """The ``index/*`` entries of either index kind."""
    if engine.native:
        fp, used, next_slot, free = engine.batcher.export_index()
        slots = np.nonzero(used)[0].astype(np.int64)
        src_b, dst_b = engine.batcher.export_meta(slots)
        src = np.array([s.decode() for s in src_b], dtype="U64")
        dst = np.array([s.decode() for s in dst_b], dtype="U64")
        keys = fp[slots]
    else:
        idx = engine.index
        slots = np.array(sorted(idx.slot_to_key), dtype=np.int64)
        keys = np.array(
            [np.uint64(idx.slot_to_key[int(s)]) for s in slots], np.uint64
        )
        src = np.array([idx.slot_meta[int(s)][0] for s in slots],
                       dtype="U64")
        dst = np.array([idx.slot_meta[int(s)][1] for s in slots],
                       dtype="U64")
        next_slot = idx.next_slot
        free = np.asarray(idx.free, np.uint32)
    return {
        "index/slots": slots,
        "index/keys": keys,
        "index/src": src,
        "index/dst": dst,
        "index/next_slot": int(next_slot),
        # the free stack VERBATIM: allocation is LIFO, so its exact order
        # makes post-restore slot assignment equal a never-stopped engine's
        "index/free": free,
    }


def save(engine, path: str, feature_reference: dict | None = None) -> int:
    """One ``.npz`` with the full serving state, written atomically with an
    embedded content checksum. Returns the byte size written.

    Call between ticks. ``engine.step()`` runs first, so every pending
    record is in the table, and each leaf's ``.cpu()`` waits on the
    caller's stream: the fetch follows the tick's last table update on
    the serve stream, whatever a pipelined device stage runs on its own.

    ``feature_reference`` (a flat name → array dict) is embedded under the
    ``feature_reference/`` prefix and covered by the same CRC."""
    engine.step()
    data: dict = {
        "format_version": FORMAT_VERSION,
        "capacity": (engine.capacity if _is_sharded(engine)
                     else engine.table.capacity),
        "native": int(engine.native),
        "last_time": int(engine.last_time),
        "tick_floor": int(engine.tick_floor),
    }
    if feature_reference:
        for key, value in feature_reference.items():
            data[f"{_REF_PREFIX}{key}"] = np.asarray(value)
    for name in _TABLE_LEAVES:
        data[f"table/{name}"] = _global_leaf(engine, name)
    data.update(_index_arrays(engine))
    data["crc32"] = np.uint32(_content_crc(data))
    buf = io.BytesIO()
    np.savez_compressed(buf, **data)
    payload = buf.getvalue()
    # "write" fires mid temp write (a torn temp, the SIGKILL state);
    # "rename" with a complete temp but no commit — either way the final
    # name still points at the previous checkpoint
    atomic_write_bytes(
        path, payload,
        mid_write_site="serving_ckpt.write",
        pre_rename_site="serving_ckpt.rename",
    )
    return len(payload)


def checkpoint_path(directory: str, tick: int) -> str:
    return os.path.join(directory, f"ckpt-{tick:09d}.npz")


def list_checkpoints(directory: str) -> list[tuple[int, str]]:
    """``(tick, path)`` for every rotation member, newest tick first."""
    out = []
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    for name in names:
        m = _CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort(reverse=True)
    return out


def save_rotating(engine, directory: str, tick: int, keep: int = 3,
                  feature_reference: dict | None = None) -> tuple[str, int]:
    """Atomic tick-numbered checkpoint + keep-N pruning. Pruning runs after
    the new member commits and never trims below ``keep`` survivors, so a
    corrupt newest member always leaves a valid predecessor. The whole
    pass (sweep + save + prune) holds the directory's rotation lock.
    Returns ``(path, bytes_written)``."""
    os.makedirs(directory, exist_ok=True)
    with _rotation_lock(directory):
        # orphaned temps of killed predecessors: a real kill cannot run
        # atomic_write_bytes's cleanup
        sweep_stale_tmp(directory)
        path = checkpoint_path(directory, tick)
        n = save(engine, path, feature_reference=feature_reference)  # graftlint: disable=blocking-under-lock -- serializing the whole sweep+save+prune file-I/O pass under the per-directory rotation lock is the lock's purpose; it is taken only by checkpoint writers, never by the serve tick
        for _, old in list_checkpoints(directory)[max(keep, 1):]:
            try:
                os.unlink(old)
            except OSError:
                pass  # pruning is advisory; never fail a save over it
    return path, n


def _load_validated(path: str) -> dict:
    """Load the archive and verify format + content CRC in one pass.
    Raises ``CorruptCheckpointError`` (or ValueError for a genuine
    old-format file)."""
    try:
        with np.load(path) as z:
            keys = set(z.files)
            if "format_version" not in keys:
                raise CorruptCheckpointError(
                    f"corrupt/incomplete serving checkpoint {path}: "
                    f"missing format_version"
                )
            # format first: a genuine pre-checksum (v1) file is an
            # old-format error, not a corruption claim
            version = int(z["format_version"])
            if not MIN_FORMAT_VERSION <= version <= FORMAT_VERSION:
                raise ValueError(
                    f"serving checkpoint format {version} unsupported "
                    f"(this build reads {MIN_FORMAT_VERSION}.."
                    f"{FORMAT_VERSION}) ({path})"
                )
            if "crc32" not in keys:
                raise CorruptCheckpointError(
                    f"corrupt/incomplete serving checkpoint {path}: "
                    f"missing crc32"
                )
            data = {k: z[k] for k in keys}
    except (CorruptCheckpointError, ValueError):
        raise
    except (OSError, zipfile.BadZipFile, zlib.error, KeyError, EOFError) as e:
        # torn or truncated archives surface as any of these from the zip
        # layer (its per-member CRC included) — name the file
        raise CorruptCheckpointError(
            f"corrupt/incomplete serving checkpoint {path}: {e}"
        ) from e
    stored = int(np.uint32(data["crc32"]))
    actual = _content_crc(data)
    if stored != actual:
        raise CorruptCheckpointError(
            f"corrupt serving checkpoint {path}: content CRC32 "
            f"{actual:#010x} != stored {stored:#010x} (bit flip or torn "
            f"write)"
        )
    return data


def validate(path: str) -> None:
    """Raise ``CorruptCheckpointError`` unless ``path`` is a complete,
    checksum-clean checkpoint of a supported format."""
    _load_validated(path)


def _resolve_and_load(
    directory: str, recorder=None
) -> tuple[str | None, dict | None]:
    """The newest member that validates, with its loaded content. Each
    invalid member passed over is a rollback: with a ``recorder`` it
    becomes a ``checkpoint.rollback`` event naming the rejected file."""
    for _, path in list_checkpoints(directory):
        try:
            return path, _load_validated(path)
        except (CorruptCheckpointError, ValueError) as e:
            if recorder is not None:
                recorder.record(
                    "checkpoint.rollback", rejected=path,
                    error=type(e).__name__, detail=str(e),
                )
            continue
    return None, None


def resolve_latest(directory: str) -> str | None:
    """The newest checkpoint in the rotation that passes ``validate`` (a
    torn or bit-flipped newest file means rollback to its predecessor);
    None when no valid checkpoint exists."""
    return _resolve_and_load(directory)[0]


def _load_for_restore(path: str, recorder=None):
    """Fault site, directory resolution, required-key check and the
    native-availability gate. Returns ``(resolved_path, content,
    native)``."""
    fault_point("serving_ckpt.restore")
    if os.path.isdir(path):
        resolved, z = _resolve_and_load(path, recorder=recorder)
        if resolved is None:
            raise CorruptCheckpointError(
                f"no valid serving checkpoint in directory {path}"
            )
        path = resolved
    else:
        z = _load_validated(path)
    if recorder is not None:
        recorder.record("checkpoint.restore", path=path)
    required = {
        "capacity", "native", "last_time", "tick_floor", "index/slots",
        "index/keys", "index/src", "index/dst", "index/next_slot",
        "index/free", *(f"table/{n}" for n in _TABLE_LEAVES),
    }
    missing = required - z.keys()
    if missing:
        raise CorruptCheckpointError(
            f"corrupt/incomplete serving checkpoint {path}: missing "
            f"entries {sorted(missing)}"
        )
    native = bool(int(z["native"]))
    if native:
        from ..native import engine as native_engine

        if not native_engine.available():
            raise RuntimeError(
                "checkpoint was written by the native (C++) index, which "
                "is unavailable here — its fingerprints are not "
                "compatible with the Python index's keys"
            )
    return path, z, native


def _import_index(eng, z, native: bool) -> None:
    """Rebuild the host flow index (either kind) and the engine clocks.
    Slot ids are GLOBAL on both spines (the sharded engine keys its one
    index globally), so this is shared."""
    slots = z["index/slots"]
    keys = z["index/keys"]
    next_slot = int(z["index/next_slot"])
    last_time = int(z["last_time"])
    free = z["index/free"]
    if native:
        eng.batcher.import_index(
            slots, keys,
            np.char.encode(z["index/src"]), np.char.encode(z["index/dst"]),
            next_slot, last_time, free,
        )
    else:
        idx = eng.index
        for s, k, src, dst in zip(
            slots, keys, z["index/src"], z["index/dst"]
        ):
            idx.key_to_slot[int(k)] = int(s)
            idx.slot_to_key[int(s)] = int(k)
            idx.slot_meta[int(s)] = (str(src), str(dst))
        idx.free = [int(s) for s in free]
        idx.next_slot = next_slot
    eng._last_time = last_time
    eng._tick_floor = int(z["tick_floor"])


def _reference_block(z) -> dict | None:
    # v3 reference statistics (absent in v2): handed back on the engine
    # so the next save writes them again
    reference = {
        k[len(_REF_PREFIX):]: np.asarray(v)
        for k, v in z.items()
        if k.startswith(_REF_PREFIX)
    }
    return reference or None


def restore(path: str, buckets=None, recorder=None, device=None):
    """Rebuild a ``FlowStateEngine`` on ``device`` (default CUDA, see
    device.py) from ``save`` output. ``path`` may be a rotation directory,
    resolved through ``resolve_latest``; ``recorder`` receives the
    rollback and restore events."""
    from ..ingest.batcher import DEFAULT_BUCKETS, FlowStateEngine

    path, z, native = _load_for_restore(path, recorder=recorder)
    eng = FlowStateEngine(
        int(z["capacity"]), buckets=buckets or DEFAULT_BUCKETS,
        device=device, native=native,
    )
    leaves = {
        name: _device_leaf(z[f"table/{name}"], name, eng.device)
        for name in _TABLE_LEAVES
    }

    def dirstate(side: str) -> ft.DirState:
        return ft.DirState(**{f: leaves[f"{side}.{f}"] for f in _DIR_FIELDS})

    eng.table = ft.FlowTable(
        time_start=leaves["time_start"],
        in_use=leaves["in_use"],
        fwd=dirstate("fwd"),
        rev=dirstate("rev"),
    )
    _import_index(eng, z, native)
    eng.feature_reference = _reference_block(z)
    return eng


def restore_sharded(path: str, mesh, *, predict_fn=None, params=None,
                    table_rows: int = 64, incremental: bool = False,
                    buckets=None, recorder=None):
    """Rebuild a ``ShardedFlowEngine`` on ``mesh`` from ``save`` output —
    the same spine-agnostic format: each GLOBAL table leaf scatters back
    to shard g % n_shards at local row g // n_shards, onto that shard's
    device, so a checkpoint written by either spine (of either package)
    restores onto the mesh, and a sharded checkpoint restores onto one
    device through plain ``restore``. The writer's native/Python index
    kind still binds. When ``incremental``, the dirty masks boot all-dirty,
    so the first render re-predicts every restored row."""
    from ..ingest.batcher import DEFAULT_BUCKETS
    from ..parallel import table_sharded as ts
    from ..parallel.mesh import DATA_AXIS

    path, z, native = _load_for_restore(path, recorder=recorder)
    capacity = int(z["capacity"])
    n = mesh.shape[DATA_AXIS]
    if capacity % n:
        raise ValueError(
            f"checkpoint capacity {capacity} does not divide across "
            f"{n} shards ({path})"
        )
    eng = ts.ShardedFlowEngine(
        mesh, capacity, buckets=buckets or DEFAULT_BUCKETS,
        predict_fn=predict_fn, params=params, table_rows=table_rows,
        native=native, incremental=incremental,
    )
    local = capacity // n
    stacked = {}
    for name in _TABLE_LEAVES:
        glob = np.asarray(z[f"table/{name}"])
        arr = np.zeros((n, local + 1) + glob.shape[1:], glob.dtype)
        arr[:, :local] = np.swapaxes(
            glob[:capacity].reshape((local, n) + glob.shape[1:]), 0, 1
        )
        stacked[name] = arr

    def shard_table(s: int, device) -> ft.FlowTable:
        leaf = {name: _device_leaf(stacked[name][s], name, device)
                for name in _TABLE_LEAVES}

        def dirstate(side: str) -> ft.DirState:
            return ft.DirState(
                **{f: leaf[f"{side}.{f}"] for f in _DIR_FIELDS})

        return ft.FlowTable(
            time_start=leaf["time_start"], in_use=leaf["in_use"],
            fwd=dirstate("fwd"), rev=dirstate("rev"),
        )

    eng.tables = [shard_table(s, dev) for s, dev in enumerate(eng.devices)]
    _import_index(eng, z, native)
    eng.feature_reference = _reference_block(z)
    return eng

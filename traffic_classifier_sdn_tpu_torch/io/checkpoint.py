"""The port's model checkpoint format: a directory holding ``manifest.json``
plus one ``<field>.npy`` per array in an arrays directory the manifest
names.

The JAX package writes orbax directories (``traffic_classifier_sdn_tpu/
io/checkpoint.py``), which need JAX to read; this format keeps the same
manifest fields — ``format_version``, ``model``, ``static``, ``classes``,
``dtypes``, ``arrays_dir`` — with the arrays as plain ``.npy`` files (read
with ``allow_pickle=False``). ``interop.forest_params_from_numpy`` carries a
JAX model's arrays into the port's module, which this module then saves.

Crash safety, as the JAX save: the manifest is the checkpoint's COMMIT
RECORD. The arrays are staged into a fresh ``arrays-<pid>-<n>`` directory
(never the one the current manifest names), then the manifest is written
atomically (temp file + fsync + ``os.replace``, utils/atomicio.py) naming
it, and only then is every other arrays directory and stale temp file
removed. A crash at any point leaves either the previous complete
checkpoint or the new one. The ``train_ckpt.write`` fault site fires
before the manifest's rename. Directories of the first layout (arrays
beside the manifest, no ``arrays_dir``) still load.
"""

from __future__ import annotations

import itertools
import json
import os
import re
import shutil

import numpy as np
import torch

from ..utils.atomicio import atomic_write_bytes, sweep_stale_tmp

FORMAT_VERSION = 1
_MANIFEST = "manifest.json"
_ARRAYS = "arrays"
_stage_counter = itertools.count()
# the temp files of the first layout's in-place array writes
_FIRST_LAYOUT_TMP = re.compile(r"^.+\.npy\.tmp-\d+$")


def _stage_arrays(path: str, arrays: dict) -> str:
    """Write ``arrays`` as ``.npy`` files under a fresh directory and
    return its name (manifest-relative). Staging to a new directory —
    never overwriting the one the current manifest names — is what makes
    the manifest a commit record: a crash mid-save leaves the old
    manifest pointing at old, complete arrays."""
    rel = f"{_ARRAYS}-{os.getpid()}-{next(_stage_counter)}"
    stage = os.path.join(path, rel)
    os.makedirs(stage)
    try:
        for k, a in arrays.items():
            with open(os.path.join(stage, f"{k}.npy"), "wb") as f:
                np.save(f, a, allow_pickle=False)
                f.flush()
                os.fsync(f.fileno())
    except BaseException:
        shutil.rmtree(stage, ignore_errors=True)
        raise
    return rel


def _first_layout_arrays(path: str) -> list[str]:
    """The ``.npy`` files of a first-layout checkpoint at ``path`` (arrays
    beside the manifest, no ``arrays_dir``): what a save over it replaces.
    Empty when there is none, or it is unreadable."""
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return []
    if "arrays_dir" in manifest:
        return []
    return [f"{k}.npy" for k in manifest.get("dtypes", {})]


def _publish(path: str, manifest: dict, arrays_rel: str,
             replaced=()) -> None:
    """Commit the manifest, then remove every arrays directory it does not
    name (stale stages of crashed saves, earlier generations), the
    ``replaced`` first-layout arrays and stale temp files. On a failed
    commit the staged directory is removed."""
    manifest["arrays_dir"] = arrays_rel
    try:
        atomic_write_bytes(
            os.path.join(path, _MANIFEST),
            json.dumps(manifest, indent=1).encode(),
            pre_rename_site="train_ckpt.write",
        )
    except BaseException:
        shutil.rmtree(os.path.join(path, arrays_rel), ignore_errors=True)
        raise
    for name in os.listdir(path):
        full = os.path.join(path, name)
        if name == arrays_rel:
            continue
        if name == _ARRAYS or name.startswith(f"{_ARRAYS}-"):
            shutil.rmtree(full, ignore_errors=True)
        elif name in replaced or _FIRST_LAYOUT_TMP.match(name):
            os.unlink(full)
    # manifest temps a killed predecessor left behind
    sweep_stale_tmp(path)


def _arrays_dir(path: str, manifest: dict) -> str:
    # the first layout kept the arrays beside the manifest
    return os.path.join(path, manifest.get("arrays_dir", ""))


def save_model(path: str, name: str, params, classes=None) -> None:
    """Write a model checkpoint directory. ``name`` is a MODEL_CLASSES key;
    ``params`` the family's module (its buffers are the arrays, its
    ``STATIC_FIELDS`` the non-array fields); ``classes`` an optional
    sequence of label names stored for decode. A save over an existing
    checkpoint replaces it atomically (module note)."""
    from ..models import MODEL_CLASSES

    if name not in MODEL_CLASSES:
        raise ValueError(f"unknown model family {name!r}")
    arrays = {k: v.detach().cpu().numpy() for k, v in params.named_buffers()}
    os.makedirs(path, exist_ok=True)
    replaced = _first_layout_arrays(path)
    rel = _stage_arrays(path, arrays)
    manifest = {
        "format_version": FORMAT_VERSION,
        "model": name,
        "static": {k: getattr(params, k) for k in params.STATIC_FIELDS},
        "classes": list(classes) if classes is not None else None,
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
    }
    _publish(path, manifest, rel, replaced)


def load_model(path: str, device=None):
    """Read a checkpoint directory → models.LoadedModel on ``device``
    (default CUDA, see device.py)."""
    from ..device import resolve_device
    from ..models import MODEL_CLASSES, make_loaded_model
    from ..models.base import ClassList

    device = resolve_device(device)
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["format_version"] > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint {path} has format_version "
            f"{manifest['format_version']} > supported {FORMAT_VERSION}"
        )
    name = manifest["model"]
    if name not in MODEL_CLASSES:
        raise ValueError(f"checkpoint {path}: unknown model family {name!r}")
    tensors = {}
    arrays = _arrays_dir(path, manifest)
    for k, dtype in manifest["dtypes"].items():
        a = np.load(os.path.join(arrays, f"{k}.npy"), allow_pickle=False)
        if str(a.dtype) != dtype:
            raise ValueError(
                f"checkpoint {path}: {k}.npy is {a.dtype}, manifest says "
                f"{dtype}"
            )
        tensors[k] = torch.from_numpy(a).to(device)
    params = MODEL_CLASSES[name](**tensors, **manifest["static"])
    classes = (
        ClassList(tuple(manifest["classes"]))
        if manifest["classes"]
        else None
    )
    return make_loaded_model(name, params, classes)

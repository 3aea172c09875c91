"""The port's model checkpoint format: a directory holding ``manifest.json``
plus one ``<field>.npy`` per array.

The JAX package writes orbax directories (``traffic_classifier_sdn_tpu/
io/checkpoint.py``), which need JAX to read; this format keeps the same
manifest fields — ``format_version``, ``model``, ``static``, ``classes``,
``dtypes`` — with the arrays as plain ``.npy`` files (read with
``allow_pickle=False``). ``interop.forest_params_from_numpy`` carries a
JAX model's arrays into the port's module, which this module then saves.

The manifest is written last, through a temp file and ``os.replace``:
it is the save's commit record.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

FORMAT_VERSION = 1
_MANIFEST = "manifest.json"


def _atomic_write(path: str, write) -> None:
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_model(path: str, name: str, params, classes=None) -> None:
    """Write a model checkpoint directory. ``name`` is a MODEL_CLASSES key;
    ``params`` the family's module (its buffers are the arrays, its
    ``STATIC_FIELDS`` the non-array fields); ``classes`` an optional
    sequence of label names stored for decode."""
    from ..models import MODEL_CLASSES

    if name not in MODEL_CLASSES:
        raise ValueError(f"unknown model family {name!r}")
    arrays = {k: v.detach().cpu().numpy() for k, v in params.named_buffers()}
    os.makedirs(path, exist_ok=True)
    for k, a in arrays.items():
        _atomic_write(
            os.path.join(path, f"{k}.npy"),
            lambda f, a=a: np.save(f, a, allow_pickle=False),
        )
    manifest = {
        "format_version": FORMAT_VERSION,
        "model": name,
        "static": {k: getattr(params, k) for k in params.STATIC_FIELDS},
        "classes": list(classes) if classes is not None else None,
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
    }
    _atomic_write(
        os.path.join(path, _MANIFEST),
        lambda f: f.write(json.dumps(manifest, indent=1).encode()),
    )


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
    for k, dtype in manifest["dtypes"].items():
        a = np.load(os.path.join(path, f"{k}.npy"), allow_pickle=False)
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

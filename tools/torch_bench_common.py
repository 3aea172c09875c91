"""Shared plumbing of the PyTorch port's measurement tools
(``tools/torch_bench_*.py``): the ``--device`` flag, the device fields of
their JSON lines, the checkpoint directory and the wait on the device.

Every tool runs on the card unless it is given ``--device cpu``; with no
card and no ``--device cpu`` it exits nonzero and says why. Nothing falls
back quietly.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REFERENCE_PICKLES = os.path.join(ROOT, "tests", "data", "reference_pickles")
# the port's serves leave XLA's compile counters at 0 (eager torch): the
# tools' JSON says so beside the counters it keeps
COMPILE_TELEMETRY = "absent (eager torch)"


def setup_path() -> None:
    """Make the port importable from a tool run as a script."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def add_device_arg(ap) -> None:
    ap.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="cuda (the default: the card, exit nonzero without one) or "
        "cpu",
    )


def resolve_device(name: str):
    """The torch device of ``--device``; exits nonzero when the card is
    asked for and none is visible."""
    setup_path()
    import torch

    from traffic_classifier_sdn_tpu_torch.device import resolve_device as rd

    if name == "cuda" and not torch.cuda.is_available():
        sys.exit(f"{os.path.basename(sys.argv[0])}: no CUDA device is "
                 "visible; pass --device cpu to run on the CPU")
    return rd(name)


def device_fields(device) -> dict:
    """``platform`` (the torch device type) and ``device_name`` (the
    card's name, or ``cpu``)."""
    import torch

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return {"platform": device.type, "device_name": name}


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def models_dir() -> str:
    """``$TCSDN_MODELS_DIR`` if set, else the committed reference-shaped
    pickles."""
    return os.environ.get("TCSDN_MODELS_DIR") or REFERENCE_PICKLES

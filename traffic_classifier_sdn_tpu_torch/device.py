"""Device choice and float32 precision policy for the port.

Every f32 product in the JAX reference runs at ``Precision.HIGHEST``
(``ops/tree_gemm.py``), so the port turns TF32 off for matmuls and
convolutions and keeps float32 matmul precision at "highest".

Entry points run on CUDA unless the caller asks for the CPU explicitly;
there is no silent fallback when no GPU is present.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def configure_precision() -> None:
    """Full-f32 products everywhere: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else CUDA.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no GPU is visible — the caller must pass ``"cpu"`` to run
    on the CPU."""
    configure_precision()
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' "
            "(--device cpu on the command line) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

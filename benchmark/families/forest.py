"""The program's side of a ``forest`` configuration: the port loads the
configuration's pickled scikit-learn forest as its CLI loads a reference
checkpoint (``models.load_reference_model``)."""

from __future__ import annotations

KERNEL = "forest_proba"  # the kernel's name in the device trace


def build(config: dict, seed: int, device, root):
    from traffic_classifier_sdn_tpu_torch.models import load_reference_model

    return load_reference_model("forest", str(root / config["model_file"]),
                                device=device)

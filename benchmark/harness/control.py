"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place and computed one precision below the
configuration's float32, in bfloat16, over the same generator state a run
leaves: the set-up rounds and ``bursts`` window bursts, with the frames a
run checks. Its readings are the upper ends the limits are set below.

Two controls: the whole spine in bfloat16 (features, model arithmetic and
the render's scores), and, for a family whose kernel returns its k nearest
rows, the kernel alone in bfloat16 on the float32 features (the step a
later change to the kernel would take)."""

from __future__ import annotations

from . import cells, check
from .traffic import Generator, TrafficSpec


def readings(config: dict, traffic: dict, seed: int, bursts: int, device,
             root=cells.ROOT, kernel_only: bool = False) -> dict:
    """{name: (value, limit)} of the control against the reference."""
    spec = TrafficSpec(traffic)
    rows = int(config["serve"]["table_rows"])
    b0 = int(traffic.get("setup_rounds", 2)) * spec.switches
    last = b0 + bursts - 1
    frames = [b for b in check.frame_plan(spec, seed, b0) if b <= last]
    keep: dict = {}
    for b in frames:
        keep.setdefault(b, []).extend(check.frame_keeps(spec, b, rows))
    gen = Generator(spec, seed, keep)
    for b in range(last + 1):
        gen.burst(b)
    model = cells.family("reference", config["family"]).load(config, seed, root)
    ref = check.reference_view(gen, spec, model, device, last, frames, rows)
    if kernel_only:
        low = dict(ref)
        low["labels"], low["topk_lists"] = check.predict(
            model, ref["X"], device, "bfloat16", detail=True)
    else:
        low = check.reference_view(gen, spec, model, device, last, frames,
                                   rows, precision="bfloat16")
    if "topk_lists" in low:
        low["topk"] = check.as_records(spec, last, low["topk_lists"])
    low.update(dropped=0, parse_errors=0)
    meta = check.expected_meta(spec, check.meta_slots(spec, seed))
    return check.compare(low, ref, meta, meta, config["limits"], 0, spec, last)

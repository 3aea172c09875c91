"""Profiling helpers: ``torch.profiler`` trace capture and on-device
call timing — the port's counterpart of
``traffic_classifier_sdn_tpu/utils/profiling.py``.

``trace()`` wraps a block (the CLI: the whole serve, ``--profile-dir``) in
``torch.profiler.profile`` and writes a Chrome trace on exit, whether the
block ends or raises. ``device_seconds_per_call`` is the median cost of a
call: between two CUDA events around back-to-back calls on a card, on the
host clock on the CPU. Eager torch dispatches each call as it comes, so
nothing is hoisted out of the loop and no round trip is subtracted.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time

import torch


def activities(cuda: bool) -> list:
    """CPU activity, plus CUDA (the card's kernels, through CUPTI) when
    ``cuda``."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str | None, device=None):
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (no-op when None): CPU activity, plus CUDA when ``device`` is a card.
    Yields a dict whose ``"path"`` names the trace file once the block
    has exited; the profiler stops however the block ends."""
    info: dict = {}
    if not log_dir:
        yield info
        return
    from torch.profiler import profile

    cuda = device is not None and torch.device(device).type == "cuda"
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities(cuda))
    prof.start()
    try:
        yield info
    finally:
        prof.stop()
        path = os.path.join(
            log_dir, f"trace-{os.getpid()}-{time.monotonic_ns()}.json")
        prof.export_chrome_trace(path)
        info["path"] = path


def device_seconds_per_call(fn, args, iters: int = 16,
                            repeats: int = 5) -> float:
    """Median seconds per ``fn(*args)`` over ``repeats`` runs of ``iters``
    back-to-back calls, after one warm call. On a card (the first tensor
    argument's device) each run is timed between two CUDA events and ends
    in a synchronize; on the CPU by the host clock."""
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
               torch.device("cpu"))
    fn(*args)
    times = []
    for _ in range(repeats):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            times.append(time.perf_counter() - t0)
    return statistics.median(times) / iters

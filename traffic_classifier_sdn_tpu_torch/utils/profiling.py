"""Profiling helpers: ``torch.profiler`` trace capture and on-device
call timing — the port's counterpart of
``traffic_classifier_sdn_tpu/utils/profiling.py``.

``trace()`` wraps a block (the CLI: the whole serve, ``--profile-dir``;
the obs server: ``/profile``) in ``torch.profiler.profile`` and writes a
Chrome trace on exit, whether the block ends or raises.

On a card the trace's kernels come from CUPTI, which kineto (the profiler
behind ``torch.profiler``) attaches to the process at the first start. By
default kineto keeps CUPTI attached after a trace, and every later launch
of the process then pays for it in host time (``PERF.md``, Findings).
So a card trace detaches it once taken: kineto reads ``TEARDOWN_CUPTI``
from the environment when a trace stops, and with it at ``1`` a thread of
its own calls ``cuptiFinalize`` from inside the next CUDA API call; its
lazy re-init then attaches CUPTI again when the next trace starts
(``DISABLE_CUPTI_LAZY_REINIT`` would re-attach it at once, and the
launches would slow again). ``trace()`` sets the one and clears the other
before a card trace starts and, once it has stopped, makes CUDA calls
until that thread has exited: a trace started while the detach is still
pending would be detached mid-window and record no kernel.

``device_seconds_per_call`` is the median cost of a
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


TEARDOWN_WAIT_S = 10.0  # the longest wait for kineto's CUPTI detach


def thread_ids() -> set:
    """Ids of this process's threads (empty where ``/proc`` has none)."""
    try:
        return set(os.listdir("/proc/self/task"))
    except OSError:
        return set()


def _detach_cupti_after_trace() -> None:
    """Have kineto detach CUPTI when a trace stops and attach it again
    lazily at the next start (see the module docstring)."""
    os.environ["TEARDOWN_CUPTI"] = "1"
    os.environ.pop("DISABLE_CUPTI_LAZY_REINIT", None)


def _await_detach(born: set, device) -> None:
    """Wait until the threads born while the trace stopped (kineto's
    teardown thread) have exited, making a CUDA call each millisecond:
    the detach happens inside one."""
    deadline = time.monotonic() + TEARDOWN_WAIT_S
    while born & thread_ids() and time.monotonic() < deadline:
        torch.cuda.synchronize(device)
        time.sleep(0.001)


@contextlib.contextmanager
def trace(log_dir: str | None, device=None):
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (no-op when None): CPU activity, plus CUDA when ``device`` is a card.
    Yields a dict whose ``"path"`` names the trace file once the block
    has exited; the profiler stops however the block ends. A card trace
    leaves CUPTI detached, so later launches cost what they did before it
    and the next trace in the process records its own kernels."""
    info: dict = {}
    if not log_dir:
        yield info
        return
    from torch.profiler import profile

    cuda = device is not None and torch.device(device).type == "cuda"
    os.makedirs(log_dir, exist_ok=True)
    if cuda:
        _detach_cupti_after_trace()
    prof = profile(activities=activities(cuda))
    prof.start()
    try:
        yield info
    finally:
        before = thread_ids()
        prof.stop()
        path = os.path.join(
            log_dir, f"trace-{os.getpid()}-{time.monotonic_ns()}.json")
        prof.export_chrome_trace(path)
        if cuda:
            _await_detach(thread_ids() - before, device)
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

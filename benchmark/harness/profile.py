"""Reading the device trace of a traced window (``torch.profiler`` with
CPU and CUDA activities): device time by operation name, device time of
the kernels launched inside each of the benchmark's ``record_function``
ranges, the busy union and the idle gaps, labelled by the benchmark range
that was open on the host when the gap began.

The trace is taken from the profiler's Chrome-trace export (Kineto's
format: complete events with ``ts``/``dur`` in microseconds; device
events of category ``kernel``, ``gpu_memcpy`` or ``gpu_memset``, each
carrying the ``correlation`` id of the ``cuda_runtime`` or ``cuda_driver``
call that launched it), written to a temporary file and deleted."""

from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
NAME_CHARS = 120  # of an operation's name in the breakdown


def export_events(prof) -> list[dict]:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events: list[dict]) -> dict | None:
    """Seconds of the traced window, of device activity in it, device time
    by operation name and by the benchmark range that launched it, and the
    longest idle gaps. None when the trace holds no window range."""
    windows = [e for e in events if e.get("ph") == "X"
               and e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not windows:
        return None
    w0 = min(float(e["ts"]) for e in windows)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in windows)
    dev, launches, ranges = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        ts, dur = float(e.get("ts", 0)), float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            a, b = max(ts, w0), min(ts + dur, w1)
            if b > a:
                dev.append((e.get("name", "?"), a, b,
                            (e.get("args") or {}).get("correlation")))
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), ts)
        elif (cat == "user_annotation" and str(e.get("name", "")).startswith("bench.")
              and e.get("name") != WINDOW):
            ranges.append((e["name"], e.get("tid"), ts, ts + dur))
    by_name: dict[str, float] = {}
    by_range: dict[str, float] = {}
    for name, a, b, corr in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        launch = launches.get(corr)
        if launch is None:
            continue
        tid, t = launch
        for rname, rtid, r0, r1 in ranges:
            if rtid == tid and r0 <= t <= r1:
                by_range[rname] = by_range.get(rname, 0.0) + (b - a)
                break
    busy = _union((a, b) for _, a, b, _ in dev)
    busy_us = sum(b - a for a, b in busy)
    gaps, last = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    labelled = []
    for g0, g1 in gaps:
        host = "host: no benchmark range"
        for rname, _, r0, r1 in ranges:
            if r0 <= g0 < r1:
                host = f"host: {rname}"
                break
        labelled.append((host, (g1 - g0) * 1e-6))
    labelled.sort(key=lambda x: -x[1])
    top = [(k[:NAME_CHARS], v)
           for k, v in sorted(by_name.items(), key=lambda x: -x[1])[:10]]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "by_name_s": {k: v * 1e-6 for k, v in by_name.items()},
        "by_range_s": {k: v * 1e-6 for k, v in by_range.items()},
        "device_ops": [[k, v * 1e-6] for k, v in top],
        "idle_gaps": [[k, v] for k, v in labelled[:10]],
        "device_events": len(dev),
    }


def kernel_seconds(summary: dict, pattern: str) -> float | None:
    """Device seconds of the operations whose name holds ``pattern``."""
    total = sum(v for k, v in summary["by_name_s"].items() if pattern in k)
    return total if total > 0 else None

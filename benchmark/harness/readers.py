"""What the per-layer metric files (``benchmark/metrics/<metric>.py``)
read from a run. Each returns None when the run holds nothing to read (no
trace, or another model family), and the metric is then left out."""

from __future__ import annotations

from statistics import fmean

from . import profile, yardstick


def mean_span_ms(run, name: str) -> float | None:
    """Mean host milliseconds per burst of a benchmark span, over the
    window's bursts outside the traced ones."""
    vals = [v for b, v in zip(run.span_bursts, run.spans[name])
            if b in run.timed_bursts]
    return 1e3 * fmean(vals) if vals else None


def device_stage_ms(run) -> float | None:
    """The pipeline worker's busy seconds (``ServePipeline.stats``) per
    render completed in the window, in ms."""
    return 1e3 * run.device_busy_s / run.frames if run.frames else None


def predict_rows(run) -> float | None:
    """Mean rows the incremental label cache predicted per render."""
    return float(fmean(run.dirty_rows)) if run.dirty_rows else None


def range_device_ms(run, name: str) -> float | None:
    """Device ms per traced burst of the kernels launched inside a
    benchmark range."""
    if run.trace is None or not run.traced_bursts:
        return None
    s = run.trace["by_range_s"].get(name)
    return None if s is None else 1e3 * s / run.traced_bursts


def roofline(run, family: str, kernel: str) -> float | None:
    """Least time of the traced predicts' work (yardstick) over the device
    time of the kernels whose name holds ``kernel``, in %."""
    if run.family != family or run.trace is None or not run.bound_ms:
        return None
    t = profile.kernel_seconds(run.trace, kernel)
    return None if t is None else 100.0 * run.bound_ms * 1e-3 / t


def idle_share(run) -> float | None:
    """Share of the traced window with no device operation running, %."""
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


def step_mfu(run) -> float | None:
    """Model operations of the traced window's predicts over the window's
    seconds at the card's float32 peak, %."""
    if run.trace is None or not run.model_ops or run.trace["window_s"] <= 0:
        return None
    return 100.0 * run.model_ops / (run.trace["window_s"]
                                    * yardstick.PEAK_F32_OPS_S)

"""Metrics registry: counters, gauges and latency histograms with
percentile snapshots — the port's copy of
``traffic_classifier_sdn_tpu/utils/metrics.py``.

The serve loop, the fan-in tier, the supervisor, the label cache, the
pipeline and the degrade ladder write into ``global_metrics`` under the
JAX package's names; ``--metrics-every`` prints ``report()`` on stderr and
``/metrics`` (obs/exposition.py) renders it in Prometheus text.

Dependency-free and cheap: increments are float adds; histograms keep a
bounded ring of recent samples (exact percentiles over the window).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Histogram:
    """Bounded ring of recent samples; exact percentiles over the window."""

    window: int = 1024
    _samples: list = field(default_factory=list)
    _pos: int = 0
    count: int = 0
    total: float = 0.0

    def observe(self, value: float) -> None:
        self.count += 1
        self.total += value
        if len(self._samples) < self.window:
            self._samples.append(value)
        else:
            self._samples[self._pos] = value
            self._pos = (self._pos + 1) % self.window

    def percentile(self, q: float) -> float:
        """q in [0, 100]; nearest rank over the current window."""
        return self.quantiles((q,))[0]

    def quantiles(self, qs) -> list[float]:
        """Percentiles over ONE sorted copy of the window, so a concurrent
        ``observe`` cannot make the reported quantiles cross."""
        if not self._samples:
            return [0.0 for _ in qs]
        s = sorted(self._samples)
        out = []
        for q in qs:
            idx = min(
                len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1))))
            )
            out.append(s[idx])
        return out

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    @property
    def last(self) -> float | None:
        """The newest observed sample (None before the first): the
        per-tick read the black-box perf recorder persists."""
        if not self._samples:
            return None
        if len(self._samples) < self.window:
            return self._samples[-1]
        # ring full: _pos is the next overwrite slot, so the newest
        # sample sits just behind it (negative index wraps at 0)
        return self._samples[self._pos - 1]


class Metrics:
    """Flat namespace of counters / gauges / histograms."""

    def __init__(self):
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, Histogram] = {}
        self._t0 = time.time()

    def reset(self) -> None:
        """Zero everything (the start of a CLI run: the global registry
        must not carry state between runs in one process)."""
        self.counters.clear()
        self.gauges.clear()
        self.histograms.clear()
        self._t0 = time.time()

    # -- write -------------------------------------------------------------
    def inc(self, name: str, value: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def set(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        h.observe(value)

    def time(self, name: str):
        """Context manager: record elapsed seconds into histogram ``name``."""
        return _TimerCtx(self, name)

    # -- read --------------------------------------------------------------
    @property
    def started_at(self) -> float:
        """Wall-clock time of the last reset (the uptime epoch)."""
        return self._t0

    def snapshot(self) -> dict:
        out: dict = {"uptime_s": time.time() - self._t0}
        out.update({k: v for k, v in self.counters.items()})
        out.update({k: v for k, v in self.gauges.items()})
        for name, h in self.histograms.items():
            out[f"{name}_count"] = h.count
            out[f"{name}_mean"] = h.mean
            out[f"{name}_p50"] = h.percentile(50)
            out[f"{name}_p99"] = h.percentile(99)
        return out

    def report(self) -> str:
        """One human line, stable key order — greppable from stderr."""
        snap = self.snapshot()
        parts = []
        for k in sorted(snap):
            v = snap[k]
            parts.append(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}")
        return "metrics " + " ".join(parts)


class _TimerCtx:
    def __init__(self, m: Metrics, name: str):
        self.m, self.name = m, name

    def __enter__(self):
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.m.observe(self.name, time.perf_counter() - self._t)
        return False


# process-global default registry (cheap to import, reset per run)
global_metrics = Metrics()

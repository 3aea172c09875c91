"""Class-conditional workload generation — the framework's equivalent of
the reference's D-ITG generator scripts (SURVEY.md §2 C15: per-class
VoIP/Quake3/Telnet/CSa/DNS configs driven through Mininet hosts).

Instead of shaping live packets, flows here are *trace-driven*: each
generated conversation belongs to a traffic class, and its per-poll
counter deltas are sampled from that class's rows in the reference
training CSVs (the empirical per-tick delta distribution the real D-ITG
traffic produced). The emitted records speak the monitor line protocol
with cumulative counters, so the whole ingest → flow-table → feature
path computes the same statistics the classifiers were trained on —
making this both a demo workload and a labeled end-to-end accuracy
harness (ground truth is known per flow).

Open-world extensions (the F12 rejection tier's test fuel,
serving/openset.py):

- ``synthetic_delta_pools`` — class-shaped pools with no reference
  CSVs (hosts without the dataset tree still exercise the full path);
- ``novel_delta_pool`` — a traffic class the models were NEVER
  trained on: deltas far outside every known pool's range, the
  "unseen application" an open-world serve must reject;
- ``perturb_pools`` — adversarially-perturbed variants of known
  pools: each delta row nudged a bounded ``epsilon`` toward another
  class's mean (the hardest closed-world rows — near the decision
  boundaries — which a calibrated rejection threshold must NOT
  reject);
- ``OpenWorldWorkload`` — a closed-world population that starts
  emitting a novel class mid-stream at a known tick: the replay
  scenario behind the drift-attribution and rejection chaos tests.

The port's copy of the JAX package's ``ingest/workload.py`` (host code,
unchanged): a seed emits the same records in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io.datasets import load_reference_datasets
from .protocol import TelemetryRecord

# features16 column indices (core/features.py CSV_COLUMNS_16 order)
_FWD_DELTA_PKTS, _FWD_DELTA_BYTES = 2, 3
_REV_DELTA_PKTS, _REV_DELTA_BYTES = 10, 11


def class_delta_pools(dataset_dir: str) -> dict[str, np.ndarray]:
    """class name → (M, 4) array of [fwd Δpkts, fwd Δbytes, rev Δpkts,
    rev Δbytes] per-tick deltas observed in that class's CSV rows."""
    ds = load_reference_datasets(dataset_dir)
    names = np.asarray(ds.classes)
    pools = {}
    cols = [_FWD_DELTA_PKTS, _FWD_DELTA_BYTES,
            _REV_DELTA_PKTS, _REV_DELTA_BYTES]
    for ci, name in enumerate(names):
        rows = ds.X16[ds.y == ci]
        pools[str(name)] = np.maximum(rows[:, cols], 0.0)
    return pools


def synthetic_delta_pools(
    n_classes: int = 4, rows: int = 512, seed: int = 0,
) -> dict[str, np.ndarray]:
    """Class-shaped synthetic delta pools for hosts without the
    reference CSV tree: class c's per-tick [fwd Δpkts, fwd Δbytes,
    rev Δpkts, rev Δbytes] draw from gamma distributions with
    class-specific scales (rates separated by ~4× per class — cleanly
    separable, like the real per-application traffic mixes)."""
    rng = np.random.RandomState(seed)
    pools = {}
    for c in range(n_classes):
        scale = 4.0 ** c
        pkts = rng.gamma(4.0, 2.0 * scale, (rows, 1))
        ratio = 40.0 + 10.0 * c  # class-specific bytes/packet
        pools[f"class{c}"] = np.concatenate(
            [
                pkts, pkts * ratio,
                pkts * 0.5, pkts * 0.5 * ratio,
            ],
            axis=1,
        ).round()
    return pools


def novel_delta_pool(
    pools: dict[str, np.ndarray], rows: int = 256, seed: int = 0,
    scale: float = 40.0,
) -> np.ndarray:
    """A traffic class the models were never trained on: per-tick
    deltas ``scale``× beyond every known pool's maximum, with an
    inverted forward/reverse ratio no known class exhibits. The
    open-world acceptance fuel: these flows must trip drift (as the
    ``unknown`` class) and keep being rejected after the retrain."""
    rng = np.random.RandomState(seed)
    hi = max(float(p.max()) for p in pools.values()) or 1.0
    base = hi * scale
    pkts = base * (1.0 + rng.rand(rows, 1))
    return np.concatenate(
        # reverse-heavy (known pools are forward-heavy or symmetric)
        [pkts * 0.1, pkts * 0.2, pkts, pkts * 8.0],
        axis=1,
    ).round()


def perturb_pools(
    pools: dict[str, np.ndarray], epsilon: float = 0.2, seed: int = 0,
) -> dict[str, np.ndarray]:
    """Adversarially-perturbed pools: each class's delta rows move a
    bounded fraction ``epsilon`` toward ANOTHER class's mean (the
    round-robin next class) — the boundary-hugging rows that maximize
    closed-world confusion. Ground truth keeps the source class, so
    these measure (a) how much accuracy the perturbation costs and
    (b) that a calibrated open-set threshold does NOT reject them
    (they remain inside the known world's envelope)."""
    if not 0.0 <= epsilon <= 1.0:
        raise ValueError("epsilon must be in [0, 1]")
    rng = np.random.RandomState(seed)
    names = sorted(pools)
    means = {c: pools[c].mean(axis=0) for c in names}
    out = {}
    for i, c in enumerate(names):
        target = means[names[(i + 1) % len(names)]]
        pool = np.asarray(pools[c], np.float64)
        # per-row jittered step bounded by epsilon — rows spread over
        # the whole boundary approach instead of collapsing to a line
        step = epsilon * rng.rand(pool.shape[0], 1)
        out[c] = np.maximum(
            pool + step * (target[None, :] - pool), 0.0
        ).round()
    return out


@dataclass
class ClassWorkload:
    """A population of flows, each assigned a traffic class, with deltas
    sampled from the class's empirical pool. Exposes ground truth.
    ``mac_base`` offsets the generated host addresses so two workloads
    (e.g. a closed-world base and a novel-class injection) can share
    one stream without flow-key collisions."""

    pools: dict[str, np.ndarray]
    flows_per_class: int = 8
    seed: int = 0
    start_time: int = 1
    datapath: str = "1"
    mac_base: int = 0
    labels: list = field(init=False)

    def __post_init__(self):
        self._rng = np.random.RandomState(self.seed)
        self.classes = sorted(self.pools)
        self.labels = [
            c for c in self.classes for _ in range(self.flows_per_class)
        ]
        n = len(self.labels)
        self._cum = np.zeros((n, 4), np.int64)
        self.t = self.start_time

    def _mac(self, i: int, side: int) -> str:
        b = (self.mac_base + i * 2 + side + 1).to_bytes(6, "big")
        return ":".join(f"{x:02x}" for x in b)

    def flow_macs(self, i: int) -> tuple[str, str]:
        return self._mac(i, 0), self._mac(i, 1)

    def tick(self) -> list[TelemetryRecord]:
        out = []
        for i, cls in enumerate(self.labels):
            pool = self.pools[cls]
            row = pool[self._rng.randint(len(pool))]
            self._cum[i] += row.astype(np.int64)  # pools are clamped >= 0
            src, dst = self.flow_macs(i)
            out.append(TelemetryRecord(
                time=self.t, datapath=self.datapath, in_port="1",
                eth_src=src, eth_dst=dst, out_port="2",
                packets=int(self._cum[i, 0]), bytes=int(self._cum[i, 1]),
            ))
            out.append(TelemetryRecord(
                time=self.t, datapath=self.datapath, in_port="2",
                eth_src=dst, eth_dst=src, out_port="1",
                packets=int(self._cum[i, 2]), bytes=int(self._cum[i, 3]),
            ))
        self.t += 1
        return out


@dataclass
class OpenWorldWorkload:
    """A closed-world population that starts emitting a NOVEL traffic
    class mid-stream: ticks before ``novel_start_tick`` are pure
    ``base``; from it on, the ``novel`` population's records ride the
    same stream (disjoint hosts via ``mac_base`` — no flow-key
    collisions). The deterministic replay scenario behind the
    open-world acceptance: calibrate on the closed phase, inject, and
    assert the drift trip attributes the ``unknown`` surge while the
    gate rejects exactly the novel flows (``novel_macs`` is the ground
    truth)."""

    base: ClassWorkload
    novel: ClassWorkload
    novel_start_tick: int = 16

    def __post_init__(self):
        # proper interval check on the generated MAC ranges — a base
        # workload with its own nonzero mac_base must not slip past a
        # zero-anchored guard. Population i occupies the half-open
        # address range [mac_base + 1, mac_base + 2·flows + 1): _mac
        # emits mac_base + 1 .. mac_base + 2·flows, so an exactly
        # adjacent packing (novel.mac_base == base.mac_base + 2·flows)
        # is legal
        b0 = self.base.mac_base + 1
        b1 = b0 + 2 * len(self.base.labels)
        n0 = self.novel.mac_base + 1
        n1 = n0 + 2 * len(self.novel.labels)
        if max(b0, n0) < min(b1, n1):
            raise ValueError(
                "novel workload's mac_base range overlaps the base "
                "population — flow keys would collide"
            )
        self.tick_no = 0

    def novel_macs(self) -> set:
        """The novel population's host addresses — per-flow ground
        truth for 'exactly the unseen flows were rejected'."""
        return {
            mac
            for i in range(len(self.novel.labels))
            for mac in self.novel.flow_macs(i)
        }

    def tick(self) -> list[TelemetryRecord]:
        self.tick_no += 1
        out = self.base.tick()
        if self.tick_no >= self.novel_start_tick:
            out.extend(self.novel.tick())
        return out

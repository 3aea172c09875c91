"""Golden pure-Python bidirectional flow tracker — the behavioral oracle;
the port's copy of ``traffic_classifier_sdn_tpu/core/flow.py`` (plain
Python, unchanged).

Reimplements (not copies) the exact update semantics of the reference's
``Flow`` class (traffic_classifier.py:29-96), used as the ground truth the
vectorized device flow table (core/flow_table.py) is property-tested against:

- a conversation is tracked once; the reverse direction folds into the same
  record (reference key folding at traffic_classifier.py:157-165)
- per direction: cumulative packets/bytes, deltas since last poll,
  instantaneous rates (delta / poll gap), average rates (cumulative / flow
  age), and an ACTIVE/INACTIVE status that is INACTIVE iff the latest delta
  of packets *or* bytes is zero (traffic_classifier.py:75-78, 93-96)
- rate guards: average rates only update when curr_time != time_start;
  instantaneous rates only when curr_time != last_time (reference :66-67)
- on creation the forward side starts ACTIVE with the initial counters and
  the reverse side starts INACTIVE at zero (reference :38-60)
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class DirectionState:
    packets: int = 0
    bytes: int = 0
    delta_packets: int = 0
    delta_bytes: int = 0
    inst_pps: float = 0.0
    avg_pps: float = 0.0
    inst_bps: float = 0.0
    avg_bps: float = 0.0
    active: bool = False
    last_time: int = 0


@dataclass
class GoldenFlow:
    """One bidirectional conversation, updated once per telemetry poll."""

    time_start: int
    datapath: str
    ethsrc: str
    ethdst: str
    inport: int = 0
    outport: int = 0
    forward: DirectionState = field(default_factory=DirectionState)
    reverse: DirectionState = field(default_factory=DirectionState)

    def __post_init__(self):
        self.forward.last_time = self.time_start
        self.reverse.last_time = self.time_start

    @classmethod
    def create(cls, time_start, datapath, ethsrc, ethdst, packets, bytes_,
               inport=0, outport=0) -> "GoldenFlow":
        f = cls(time_start, datapath, ethsrc, ethdst, inport, outport)
        f.forward.packets = packets
        f.forward.bytes = bytes_
        f.forward.active = True  # reference :47
        return f

    def _update(self, d: DirectionState, packets, bytes_, curr_time):
        d.delta_packets = packets - d.packets
        d.packets = packets
        if curr_time != self.time_start:
            d.avg_pps = packets / float(curr_time - self.time_start)
        if curr_time != d.last_time:
            d.inst_pps = d.delta_packets / float(curr_time - d.last_time)
        d.delta_bytes = bytes_ - d.bytes
        d.bytes = bytes_
        if curr_time != self.time_start:
            d.avg_bps = bytes_ / float(curr_time - self.time_start)
        if curr_time != d.last_time:
            d.inst_bps = d.delta_bytes / float(curr_time - d.last_time)
        d.last_time = curr_time
        d.active = not (d.delta_bytes == 0 or d.delta_packets == 0)

    def update_forward(self, packets, bytes_, curr_time):
        self._update(self.forward, packets, bytes_, curr_time)

    def update_reverse(self, packets, bytes_, curr_time):
        self._update(self.reverse, packets, bytes_, curr_time)

    def features12(self) -> list:
        """The online feature vector, exact order of
        traffic_classifier.py:104."""
        f, r = self.forward, self.reverse
        return [
            f.delta_packets, f.delta_bytes, f.inst_pps, f.avg_pps,
            f.inst_bps, f.avg_bps,
            r.delta_packets, r.delta_bytes, r.inst_pps, r.avg_pps,
            r.inst_bps, r.avg_bps,
        ]

    def features16(self) -> list:
        """The training-CSV row, exact order of traffic_classifier.py:124-141
        (and the datasets/*.csv column order)."""
        f, r = self.forward, self.reverse
        return [
            f.packets, f.bytes, f.delta_packets, f.delta_bytes,
            f.inst_pps, f.avg_pps, f.inst_bps, f.avg_bps,
            r.packets, r.bytes, r.delta_packets, r.delta_bytes,
            r.inst_pps, r.avg_pps, r.inst_bps, r.avg_bps,
        ]

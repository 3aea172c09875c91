"""The telemetry line protocol between the OpenFlow monitor and the
classifier, plus stable flow keys.

The reference's Ryu app emits one TSV line per flow per 1 Hz poll:
``data\\t<time>\\t<datapath>\\t<in_port>\\t<eth_src>\\t<eth_dst>\\t<out_port>
\\t<packet_count>\\t<byte_count>`` (simple_monitor_13.py:49-66), and the
classifier parses it by prefix match + split (traffic_classifier.py:152-155).

Flow keys: the reference uses Python's ``hash()`` of datapath+src+dst
(traffic_classifier.py:157), which is randomized per process. We use a
stable 64-bit BLAKE2b digest instead, with the same direction-folding rule:
a record keys to an existing reverse-key flow as that flow's reverse
direction (reference :161-165).

A copy of ``traffic_classifier_sdn_tpu/ingest/protocol.py``.
"""

from __future__ import annotations

import hashlib
import time as _time
from dataclasses import dataclass, field

from ..utils.faults import FaultInjected, fault_point

PREFIX = b"data"
_I64_MAX = (1 << 63) - 1


@dataclass(frozen=True)
class TelemetryRecord:
    """One parsed flow-stats line.

    ``source`` is NOT on the wire: it is the fan-in namespace tag folded
    into the flow key. Source 0 is the default namespace.

    ``emit_ts`` is NOT on the wire either: the latency-provenance emit
    stamp (``time.perf_counter`` domain) that ``stamp_records`` sets where
    a collector reads the record. ``compare=False``: records carrying the
    same telemetry are equal whenever they were stamped."""

    time: int
    datapath: str
    in_port: str
    eth_src: str
    eth_dst: str
    out_port: str
    packets: int
    bytes: int
    source: int = 0
    emit_ts: float | None = field(default=None, compare=False)


def stamp_records(records, ts: float | None = None) -> bool:
    """Set each record's ``emit_ts`` in place, once: a record that already
    carries a stamp keeps it. In place through ``object.__setattr__`` on
    the frozen dataclass — the stamp is set by the owning reader before
    the record is published to a queue, and the wire fields stay
    immutable.

    Fault site ``obs.stamp`` (absorbed): a fire leaves the batch
    unstamped and delivers it all the same. Returns False then."""
    try:
        fault_point("obs.stamp")
    except FaultInjected:
        return False
    if ts is None:
        ts = _time.perf_counter()
    for r in records:
        if r.emit_ts is None:
            object.__setattr__(r, "emit_ts", ts)
    return True


def format_line(r: TelemetryRecord) -> bytes:
    """Render a record back to the wire format (for replay files, tests and
    the fake monitor)."""
    return (
        b"\t".join(
            str(x).encode()
            for x in (
                "data", r.time, r.datapath, r.in_port, r.eth_src,
                r.eth_dst, r.out_port, r.packets, r.bytes,
            )
        )
        + b"\n"
    )


def parse_line(line: bytes) -> TelemetryRecord | None:
    """Parse one monitor stdout line; None for non-telemetry lines
    (headers, Ryu logs — the reference filters by the same prefix)."""
    if not line.startswith(PREFIX):
        return None
    fields = line.rstrip(b"\n").split(b"\t")[1:]
    # exactly 8 fields after the prefix: a line with trailing junk fields
    # is corrupt, not slop to ignore
    if len(fields) != 8:
        return None
    try:
        r = TelemetryRecord(
            time=int(fields[0]),
            datapath=fields[1].decode(),
            in_port=fields[2].decode(),
            eth_src=fields[3].decode(),
            eth_dst=fields[4].decode(),
            out_port=fields[5].decode(),
            packets=int(fields[6]),
            bytes=int(fields[7]),
        )
    except (ValueError, UnicodeDecodeError):
        return None
    # Counters are cumulative OFPFlowStats values: negative or >int64 is
    # malformed; time shares the int64 magnitude bound.
    if not (0 <= r.packets <= _I64_MAX and 0 <= r.bytes <= _I64_MAX
            and -_I64_MAX <= r.time <= _I64_MAX):
        return None
    return r


def stable_flow_key(datapath: str, eth_src: str, eth_dst: str,
                    source: int = 0) -> int:
    """Stable 64-bit key over (datapath, src, dst) — replaces the
    reference's process-randomized ``hash()`` (traffic_classifier.py:157).

    ``source`` namespaces the key per telemetry source; source 0 produces
    the un-namespaced digest."""
    h = hashlib.blake2b(digest_size=8)
    # \x00 separators prevent ambiguity between concatenated fields
    h.update(datapath.encode())
    h.update(b"\x00")
    h.update(eth_src.encode())
    h.update(b"\x00")
    h.update(eth_dst.encode())
    if source:
        h.update(b"\x00")
        h.update(source.to_bytes(4, "little"))
    return int.from_bytes(h.digest(), "little")

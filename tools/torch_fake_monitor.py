#!/usr/bin/env python
"""Fake OpenFlow monitor of the PyTorch port: emits the reference's
telemetry line protocol (simple_monitor_13.py:49-66 format) for a
synthetic flow population, through the port's
``ingest/protocol.format_line`` and ``ingest/replay.SyntheticFlows`` — a
stand-in for ``sudo ryu run simple_monitor_13.py`` that needs no
Mininet/OVS/Ryu. The twin of ``tools/fake_monitor.py``: the same argv
gives the same bytes on stdout.

Usage: python tools/torch_fake_monitor.py [n_flows] [n_ticks] [period_sec]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from traffic_classifier_sdn_tpu_torch.ingest.protocol import format_line  # noqa: E402
from traffic_classifier_sdn_tpu_torch.ingest.replay import SyntheticFlows  # noqa: E402


def main() -> None:
    n_flows = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    n_ticks = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    period = float(sys.argv[3]) if len(sys.argv) > 3 else 1.0

    out = sys.stdout.buffer
    # the human header line the reference's monitor logs first
    # (simple_monitor_13.py:32) — consumers must ignore it
    out.write(b"datapath         in-port eth-dst           out-port packets  bytes\n")
    out.flush()
    syn = SyntheticFlows(n_flows=n_flows)
    for _ in range(n_ticks):
        for r in syn.tick():
            out.write(format_line(r))
        out.flush()
        if period > 0:
            time.sleep(period)


if __name__ == "__main__":
    main()

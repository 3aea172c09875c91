"""Standalone OpenFlow 1.3 controller: learning switch + 1 Hz flow-stats
monitor emitting the telemetry line protocol.

This is the framework's own replacement for the reference's entire L2
layer — Ryu's stock ``SimpleSwitch13`` (MAC learning, priority-1 flow
installation; inherited at simple_monitor_13.py:3,10) plus the
``SimpleMonitor13`` poller (datapath registration :18-29, the 1 Hz stats
requester :31-47, and the ``data\\t…`` TSV logger :49-66) — implemented
directly over asyncio TCP with controller/openflow.py, so no external SDN
framework is needed. Open vSwitch (or the port's fake switch,
tools/torch_fake_switch.py) connects to us; stdout speaks exactly the
protocol ingest/protocol.py parses. The port's copy of the JAX package's
``controller/switch.py`` (host code, unchanged); ``python -m
traffic_classifier_sdn_tpu_torch.controller --port N`` runs it, and the
port's ``--source controller`` spawns it that way.

Behavioral parity notes:
- flows are installed at priority 1 matching (in_port, eth_src, eth_dst),
  and the stats logger filters priority == 1 and sorts by
  (in_port, eth_dst) — same as simple_monitor_13.py:53-56
- port stats are requested but their replies are discarded — the
  reference does the same (requested at simple_monitor_13.py:46-47; no
  reply handler), and we keep the request for switch-side parity
- unlike the reference (green threads), this is a single asyncio loop:
  no shared-state races by construction
"""

from __future__ import annotations

import asyncio
import sys
import time
from dataclasses import dataclass, field

from . import openflow as of

ETH_TYPE_LLDP = 0x88CC


@dataclass
class Datapath:
    """One connected switch."""

    reader: asyncio.StreamReader
    writer: asyncio.StreamWriter
    dpid: int | None = None
    mac_to_port: dict = field(default_factory=dict)
    malformed: int = 0  # dropped-frame count (warnings rate-limited)
    _xid: int = 0

    def next_xid(self) -> int:
        self._xid = (self._xid + 1) & 0xFFFFFFFF
        return self._xid

    def send(self, msg: bytes) -> None:
        self.writer.write(msg)


class Controller:
    """Accepts switch connections and runs the learning-switch + monitor
    apps over them."""

    def __init__(self, host: str = "0.0.0.0", port: int = 6653,
                 poll_interval: float = 1.0, out=None):
        self.host = host
        self.port = port
        self.poll_interval = poll_interval
        self.out = out if out is not None else sys.stdout
        self.datapaths: dict[int, Datapath] = {}
        self._server: asyncio.AbstractServer | None = None
        self._monitor_task: asyncio.Task | None = None
        self._writers: set[asyncio.StreamWriter] = set()

    # -- lifecycle ---------------------------------------------------------
    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_connection, self.host, self.port
        )
        self._monitor_task = asyncio.create_task(self._monitor())

    @property
    def bound_port(self) -> int:
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._monitor_task is not None:
            self._monitor_task.cancel()
        # close live connections first: Python 3.12's wait_closed() blocks
        # until every connection handler has finished
        for w in list(self._writers):
            w.close()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    async def serve_forever(self) -> None:
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    # -- connection handling ----------------------------------------------
    async def _handle_connection(self, reader, writer) -> None:
        self._writers.add(writer)
        dp = Datapath(reader, writer)
        dp.send(of.hello(dp.next_xid()))
        dp.send(of.features_request(dp.next_xid()))
        await writer.drain()
        mr = of.MessageReader()
        try:
            while True:
                data = await reader.read(1 << 16)
                if not data:
                    break
                for mtype, xid, body in mr.feed(data):
                    try:
                        self._dispatch(dp, mtype, xid, body)
                    except of.PARSE_ERRORS as e:
                        # one malformed message from a buggy/hostile
                        # switch must not take the connection (or leak a
                        # traceback into the telemetry stream): drop the
                        # frame, keep serving — framing stays intact
                        # because MessageReader already consumed it.
                        # Rate-limited: a switch streaming garbage at
                        # line rate must not stall the event loop on
                        # synchronous stderr writes.
                        dp.malformed += 1
                        if dp.malformed <= 5:
                            print(
                                f"WARNING: dropped malformed OF message "
                                f"type={mtype} "
                                f"({type(e).__name__}: {e})"
                                + (" — further drops counted silently"
                                   if dp.malformed == 5 else ""),
                                file=sys.stderr,
                            )
                await writer.drain()
        except (ConnectionResetError, asyncio.CancelledError):
            pass
        except ValueError as e:
            # unrecoverable FRAMING error (bad header length): the byte
            # stream cannot be resynced — close this connection cleanly
            print(
                f"WARNING: closing datapath connection on framing error: "
                f"{e}",
                file=sys.stderr,
            )
        finally:
            # DEAD_DISPATCHER unregistration (simple_monitor_13.py:26-29)
            if dp.dpid is not None:
                self.datapaths.pop(dp.dpid, None)
            self._writers.discard(writer)
            writer.close()

    def _dispatch(self, dp: Datapath, mtype: int, xid: int, body: bytes):
        if mtype == of.OFPT_ECHO_REQUEST:
            dp.send(of.echo_reply(xid, body))
        elif mtype == of.OFPT_FEATURES_REPLY:
            dp.dpid = of.parse_features_reply(body)
            # MAIN_DISPATCHER registration (simple_monitor_13.py:20-25)
            self.datapaths[dp.dpid] = dp
            # table-miss: everything unmatched goes to the controller
            dp.send(
                of.flow_mod(
                    dp.next_xid(), priority=0, match=of.encode_match(),
                    instructions=of.instruction_apply_actions(
                        of.action_output(of.OFPP_CONTROLLER)
                    ),
                )
            )
        elif mtype == of.OFPT_PACKET_IN:
            self._packet_in(dp, body)
        elif mtype == of.OFPT_MULTIPART_REPLY:
            self._stats_reply(dp, body)
        # ERROR / port-stats replies / everything else: ignored, like the
        # reference's unhandled events

    # -- learning switch (SimpleSwitch13 semantics) ------------------------
    def _packet_in(self, dp: Datapath, body: bytes) -> None:
        pkt = of.parse_packet_in(body)
        frame = pkt["frame"]
        if len(frame) < 14 or pkt.get("eth_type") == ETH_TYPE_LLDP:
            return
        in_port = pkt["match"].get("in_port")
        if in_port is None:
            return
        src, dst = pkt["eth_src"], pkt["eth_dst"]
        dp.mac_to_port[src] = in_port
        out_port = dp.mac_to_port.get(dst, of.OFPP_FLOOD)
        actions = of.action_output(out_port)
        if out_port != of.OFPP_FLOOD:
            # install the forwarding flow so future packets skip the
            # controller; priority 1 = what the monitor reports on
            match = of.encode_match(in_port=in_port, eth_src=src, eth_dst=dst)
            if pkt["buffer_id"] != of.OFP_NO_BUFFER:
                dp.send(
                    of.flow_mod(
                        dp.next_xid(), priority=1, match=match,
                        instructions=of.instruction_apply_actions(actions),
                        buffer_id=pkt["buffer_id"],
                    )
                )
                return  # buffered packet is released by the flow-mod
            dp.send(
                of.flow_mod(
                    dp.next_xid(), priority=1, match=match,
                    instructions=of.instruction_apply_actions(actions),
                )
            )
        dp.send(
            of.packet_out(
                dp.next_xid(), pkt["buffer_id"], in_port, actions, frame
            )
        )

    # -- monitor (SimpleMonitor13 semantics) -------------------------------
    async def _monitor(self) -> None:
        while True:
            for dp in list(self.datapaths.values()):
                # per-dp guard, and OSError not just ConnectionReset: a
                # dead switch (EPIPE/ETIMEDOUT) must never kill the poll
                # loop for the others
                try:
                    dp.send(of.flow_stats_request(dp.next_xid()))
                    dp.send(of.port_stats_request(dp.next_xid()))
                    await dp.writer.drain()
                except (ConnectionError, OSError):
                    pass
            await asyncio.sleep(self.poll_interval)

    def _stats_reply(self, dp: Datapath, body: bytes) -> None:
        mtype, stats = of.parse_multipart_reply(body)
        if mtype != of.OFPMP_FLOW:
            return  # port stats: requested but unconsumed, like the ref
        now = int(time.time())
        lines = [
            "datapath         in-port  eth-dst           out-port packets  bytes",
            "---------------- -------- ----------------- -------- -------- --------",
        ]
        flows = [s for s in stats if s.priority == 1]
        flows.sort(
            key=lambda s: (s.match.get("in_port", 0), s.match.get("eth_dst", ""))
        )
        for s in flows:
            lines.append(
                "data\t{}\t{}\t{}\t{}\t{}\t{}\t{}\t{}".format(
                    now, dp.dpid, s.match.get("in_port", 0),
                    s.match.get("eth_src", "?"), s.match.get("eth_dst", "?"),
                    s.out_port if s.out_port is not None else 0,
                    s.packet_count, s.byte_count,
                )
            )
        print("\n".join(lines), file=self.out, flush=True)


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="OpenFlow 1.3 learning switch + flow-stats monitor "
        "(drop-in for `ryu run simple_monitor_13.py`)"
    )
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=6653)
    p.add_argument(
        "--poll", type=float, default=1.0,
        help="flow-stats poll interval seconds (reference: 1 Hz)",
    )
    args = p.parse_args(argv)

    async def run():
        c = Controller(args.host, args.port, args.poll)
        await c.start()
        await c.serve_forever()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()

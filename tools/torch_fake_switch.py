"""Fake OpenFlow 1.3 switch for the PyTorch/CUDA port: connects to a
controller, speaks enough of the protocol to exercise the learning switch
and the flow-stats monitor, and simulates host traffic so flow counters
evolve.

The port's copy of ``tools/fake_switch.py``, built on the port's own
``controller/openflow.py`` so that a run of the port's controller imports
nothing of the JAX package. It is the test/demo stand-in for Mininet +
Open vSwitch + D-ITG (reference README.md:26-35): hosts exchange packets
(→ PACKET_INs until flows are installed), installed priority-1 flows
accumulate synthetic packet/byte rates, and MULTIPART flow-stats requests
are answered from the simulated flow table. ``AccountingSwitch`` is the
other side: a listening datapath that accounts every FLOW_MOD the
actuation plane (serving/actuation.py) pushes, with scriptable refusals
and withheld barrier replies.

Usable as a library (tests/test_torch_controller.py, in-process asyncio)
or as a script:  python tools/torch_fake_switch.py --port 6653 --hosts 4
"""

from __future__ import annotations

import argparse
import asyncio
import os
import random
import socket
import struct
import sys
import threading

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from traffic_classifier_sdn_tpu_torch.controller import openflow as of  # noqa: E402


def eth_frame(src: str, dst: str, eth_type: int = 0x0800) -> bytes:
    return of.mac_bytes(dst) + of.mac_bytes(src) + struct.pack(
        "!H", eth_type
    ) + b"\x00" * 46


class FakeSwitch:
    """One simulated datapath with ``n_hosts`` hosts on ports 1..n."""

    def __init__(self, dpid: int = 1, n_hosts: int = 4,
                 rates: dict | None = None, seed: int = 0):
        self.dpid = dpid
        self.n_hosts = n_hosts
        self.macs = [f"00:00:00:00:00:{i + 1:02x}" for i in range(n_hosts)]
        self.port_of = {m: i + 1 for i, m in enumerate(self.macs)}
        # installed flows: list of dicts with match/priority/out_port/counters
        self.flows: list[dict] = []
        self.rng = random.Random(seed)
        # per-flow (pkts/s, bytes/s) rate; default: telnet-ish chatter
        self.rates = rates or {}
        self.default_rate = (20, 1200)
        self.reader: asyncio.StreamReader | None = None
        self.writer: asyncio.StreamWriter | None = None
        self._mr = of.MessageReader()
        self._xid = 0
        self.packet_outs: list[dict] = []
        self.eof = False  # controller closed the connection

    def next_xid(self) -> int:
        self._xid += 1
        return self._xid

    async def connect(self, host: str, port: int) -> None:
        self.reader, self.writer = await asyncio.open_connection(host, port)

    async def pump(self, duration: float) -> None:
        """Process controller messages for ``duration`` seconds."""
        loop = asyncio.get_event_loop()
        end = loop.time() + duration
        while True:
            timeout = end - loop.time()
            if timeout <= 0:
                break
            try:
                data = await asyncio.wait_for(
                    self.reader.read(1 << 16), timeout=timeout
                )
            except asyncio.TimeoutError:
                break
            if not data:
                self.eof = True
                break
            for mtype, xid, body in self._mr.feed(data):
                self._handle(mtype, xid, body)
            await self.writer.drain()

    def _handle(self, mtype: int, xid: int, body: bytes) -> None:
        if mtype == of.OFPT_HELLO:
            self.writer.write(of.hello(self.next_xid()))
        elif mtype == of.OFPT_FEATURES_REQUEST:
            self.writer.write(of.features_reply(xid, self.dpid))
        elif mtype == of.OFPT_ECHO_REQUEST:
            self.writer.write(of.echo_reply(xid, body))
        elif mtype == of.OFPT_FLOW_MOD:
            fm = of.parse_flow_mod(body)
            if fm["command"] == of.OFPFC_ADD:
                self.flows.append(
                    {
                        "priority": fm["priority"],
                        "match": fm["match"],
                        "out_port": of.decode_output_port(fm["instructions"]),
                        "packets": 0,
                        "bytes": 0,
                    }
                )
        elif mtype == of.OFPT_PACKET_OUT:
            self.packet_outs.append({"xid": xid})
        elif mtype == of.OFPT_MULTIPART_REQUEST:
            mp_type, = struct.unpack_from("!H", body)
            if mp_type == of.OFPMP_FLOW:
                self._advance_counters()
                stats = [
                    of.FlowStat(
                        f["priority"], f["packets"], f["bytes"],
                        f["match"], f["out_port"],
                    )
                    for f in self.flows
                    if f["priority"] == 1
                ]
                self.writer.write(of.flow_stats_reply(xid, stats))
            # port-stats requests: reply with an empty port-stats body
            # (the controller discards it anyway, like the reference)
            elif mp_type == of.OFPMP_PORT_STATS:
                empty = struct.pack("!HH4x", of.OFPMP_PORT_STATS, 0)
                self.writer.write(
                    of.message(of.OFPT_MULTIPART_REPLY, xid, empty)
                )

    def _advance_counters(self) -> None:
        for f in self.flows:
            if f["priority"] != 1:
                continue
            key = (f["match"].get("eth_src"), f["match"].get("eth_dst"))
            pps, bps = self.rates.get(key, self.default_rate)
            f["packets"] += max(0, int(self.rng.gauss(pps, pps * 0.2)))
            f["bytes"] += max(0, int(self.rng.gauss(bps, bps * 0.2)))

    def send_packet(self, src_host: int, dst_host: int) -> None:
        """Host src sends one packet: emit the PACKET_IN the real switch
        would produce for a table miss."""
        src, dst = self.macs[src_host], self.macs[dst_host]
        match = of.encode_match(in_port=self.port_of[src])
        self.writer.write(
            of.packet_in(
                self.next_xid(), of.OFP_NO_BUFFER, 0, match,
                eth_frame(src, dst),
            )
        )

    def converse(self, a: int, b: int) -> None:
        """Two packets a→b then b→a: after the second, the controller has
        learned both MACs and installs the first priority-1 flow; a third
        a→b installs the reverse. Mirrors how OVS+Ryu converges."""
        self.send_packet(a, b)
        self.send_packet(b, a)
        self.send_packet(a, b)


class AccountingSwitch:
    """A listening OF1.3 datapath with a flow-mod accounting surface —
    the replay-test stand-in for OVS on the actuation side (the image
    has no OVS, so the end-to-end loop closes against this).

    Unlike :class:`FakeSwitch` (which dials out to a controller and
    simulates traffic for the telemetry plane), this one *listens* and
    accounts: every FLOW_MOD is decoded (match + structured
    instructions) into ``flow_log``, ADDs/DELETEs maintain the live
    ``rules`` view keyed by cookie, BARRIER_REQUESTs are answered in
    order, and two scriptable knobs break things on purpose:

    * ``script_refuse(n)`` — the next ``n`` flow-mods bounce with an
      OFPT_ERROR embedding the offending message (so the sender can
      recover the refused xid, as the spec intends)
    * ``script_stall_barrier(n)`` — the next ``n`` barrier replies are
      withheld (the lost-barrier failure an actuation plane must
      absorb without stalling its serve cadence)

    Thread-per-connection so a degraded client can reconnect while an
    old socket lingers; start()/stop() or use as a context manager.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 dpid: int = 1):
        self.host = host
        self.dpid = dpid
        self.flow_log: list[dict] = []
        self.rules: dict[int, dict] = {}  # cookie → live rule
        self.barriers = 0
        self.connections = 0
        self._refuse = 0
        self._stall = 0
        self._lock = threading.Lock()
        self._srv = socket.socket()
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._accept_thread: threading.Thread | None = None
        self._conn_threads: list[threading.Thread] = []

    # -- scripting ----------------------------------------------------------

    def script_refuse(self, n: int = 1) -> None:
        with self._lock:
            self._refuse += n

    def script_stall_barrier(self, n: int = 1) -> None:
        with self._lock:
            self._stall += n

    # -- accounting views ---------------------------------------------------

    def installs(self) -> list[dict]:
        with self._lock:
            return [e for e in self.flow_log if e["op"] == "install"]

    def deletes(self) -> list[dict]:
        with self._lock:
            return [e for e in self.flow_log if e["op"] == "delete"]

    def refusals(self) -> list[dict]:
        with self._lock:
            return [e for e in self.flow_log if e["refused"]]

    def live_cookies(self) -> set[int]:
        with self._lock:
            return set(self.rules)

    # -- server loop --------------------------------------------------------

    def start(self) -> "AccountingSwitch":
        self._srv.listen(8)
        self._srv.settimeout(0.1)
        t = threading.Thread(
            target=self._accept_loop, name="accounting-switch", daemon=True,
        )
        t.start()
        self._accept_thread = t
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=2.0)
        for t in self._conn_threads:
            t.join(timeout=2.0)

    def __enter__(self) -> "AccountingSwitch":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._srv.accept()
            except (socket.timeout, OSError):
                continue
            with self._lock:
                self.connections += 1
            t = threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True,
            )
            t.start()
            self._conn_threads.append(t)

    def _serve_conn(self, conn: socket.socket) -> None:
        mr = of.MessageReader()
        conn.settimeout(0.1)
        xid_out = 1 << 20  # our xids, clear of the client's range
        try:
            while not self._stop.is_set():
                try:
                    data = conn.recv(1 << 16)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not data:
                    break
                for mtype, xid, body in mr.feed(data):
                    xid_out += 1
                    reply = self._handle(mtype, xid, body, xid_out)
                    if reply:
                        conn.sendall(reply)
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, mtype: int, xid: int, body: bytes,
                xid_out: int) -> bytes:
        if mtype == of.OFPT_HELLO:
            return of.hello(xid_out)
        if mtype == of.OFPT_ECHO_REQUEST:
            return of.echo_reply(xid, body)
        if mtype == of.OFPT_FEATURES_REQUEST:
            return of.features_reply(xid, self.dpid)
        if mtype == of.OFPT_BARRIER_REQUEST:
            with self._lock:
                self.barriers += 1
                if self._stall > 0:
                    self._stall -= 1
                    return b""  # withheld: the client's barrier is lost
            return of.barrier_reply(xid)
        if mtype == of.OFPT_FLOW_MOD:
            return self._handle_flow_mod(xid, body)
        return b""

    def _handle_flow_mod(self, xid: int, body: bytes) -> bytes:
        fm = of.parse_flow_mod(body)
        entry = {
            "op": "install" if fm["command"] == of.OFPFC_ADD else (
                "delete" if fm["command"] == of.OFPFC_DELETE else "modify"
            ),
            "xid": xid,
            "cookie": fm["cookie"],
            "priority": fm["priority"],
            "match": fm["match"],
            "instructions": of.decode_instructions(fm["instructions"]),
            "refused": False,
        }
        with self._lock:
            if self._refuse > 0:
                self._refuse -= 1
                entry["refused"] = True
                self.flow_log.append(entry)
                return of.error_msg(
                    xid, of.OFPET_FLOW_MOD_FAILED, 0,
                    of.message(of.OFPT_FLOW_MOD, xid, body),
                )
            self.flow_log.append(entry)
            if fm["command"] == of.OFPFC_ADD:
                # OF1.3 ADD semantics: identical match+priority replaces
                # the existing entry (whatever its cookie)
                for ck in [
                    ck for ck, r in self.rules.items()
                    if r["match"] == fm["match"]
                    and r["priority"] == fm["priority"]
                ]:
                    self.rules.pop(ck, None)
                self.rules[fm["cookie"]] = entry
            elif fm["command"] == of.OFPFC_DELETE:
                if fm["cookie_mask"]:
                    self.rules.pop(fm["cookie"], None)
                else:
                    # unmasked delete: match-wide removal
                    for ck in [
                        ck for ck, r in self.rules.items()
                        if r["match"] == fm["match"]
                    ]:
                        self.rules.pop(ck, None)
        return b""


async def run_standalone(port: int, n_hosts: int, host: str = "127.0.0.1",
                         duration: float = 0.0) -> None:
    sw = FakeSwitch(n_hosts=n_hosts)
    # the controller may take a while to come up (it is spawned after the
    # classifier's model load): retry for up to ~60 s
    for attempt in range(300):
        try:
            await sw.connect(host, port)
            break
        except ConnectionRefusedError:
            if attempt == 299:
                raise
            await asyncio.sleep(0.2)
    await sw.pump(0.5)
    # all host pairs converse so flows get installed
    for a in range(0, n_hosts - 1, 2):
        sw.converse(a, a + 1)
    loop = asyncio.get_event_loop()
    end = loop.time() + duration if duration else None
    while (end is None or loop.time() < end) and not sw.eof:
        await sw.pump(1.0)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=6653)
    p.add_argument("--hosts", type=int, default=4)
    p.add_argument("--duration", type=float, default=0.0, help="0 = forever")
    a = p.parse_args(argv)
    try:
        asyncio.run(run_standalone(a.port, a.hosts, a.host, a.duration))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()

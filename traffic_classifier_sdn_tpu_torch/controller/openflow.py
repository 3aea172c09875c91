"""Minimal OpenFlow 1.3 wire protocol: exactly the subset the telemetry
layer needs (hello/echo/features, flow-mod, packet-in/out, multipart flow
stats), encoded/decoded with ``struct``.

This replaces the reference's dependency on the Ryu framework: the
reference's controller is Ryu's stock learning switch plus a stats poller
(simple_monitor_13.py:3,10 inherits simple_switch_13.SimpleSwitch13); here
the same OpenFlow 1.3 conversation is spoken directly, so the framework
needs no external SDN stack. Switches (e.g. Open vSwitch) connect to us
over TCP and the controller app (controller/switch.py) drives this module.

Only OpenFlow 1.3 (wire version 0x04) is supported — the version the
reference pins via OFP_VERSIONS implicitly through simple_switch_13.

The port's copy of the JAX package's ``controller/openflow.py``: host
code, unchanged, so the port's controller imports nothing of that
package.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

OFP_VERSION = 0x04
OFP_HEADER = struct.Struct("!BBHI")  # version, type, length, xid

# message types
OFPT_HELLO = 0
OFPT_ERROR = 1
OFPT_ECHO_REQUEST = 2
OFPT_ECHO_REPLY = 3
OFPT_FEATURES_REQUEST = 5
OFPT_FEATURES_REPLY = 6
OFPT_PACKET_IN = 10
OFPT_PACKET_OUT = 13
OFPT_FLOW_MOD = 14
OFPT_MULTIPART_REQUEST = 18
OFPT_MULTIPART_REPLY = 19
OFPT_BARRIER_REQUEST = 20
OFPT_BARRIER_REPLY = 21

# ports / groups / buffers
OFPP_NORMAL = 0xFFFFFFFA
OFPP_CONTROLLER = 0xFFFFFFFD
OFPP_FLOOD = 0xFFFFFFFB
OFPP_ANY = 0xFFFFFFFF
OFPG_ANY = 0xFFFFFFFF
OFP_NO_BUFFER = 0xFFFFFFFF
OFPTT_ALL = 0xFF

# flow-mod commands
OFPFC_ADD = 0
OFPFC_DELETE = 3

# multipart types
OFPMP_FLOW = 1
OFPMP_PORT_STATS = 4

# instruction / action types
OFPIT_APPLY_ACTIONS = 4
OFPIT_METER = 6
OFPAT_OUTPUT = 0
OFPAT_SET_QUEUE = 21

# error types (the two the actuation plane distinguishes)
OFPET_FLOW_MOD_FAILED = 5

# OXM (match TLV) basic-class fields
OXM_CLASS_BASIC = 0x8000
OXM_IN_PORT = 0
OXM_ETH_DST = 3
OXM_ETH_SRC = 4

_PACKET_IN_HEAD = struct.Struct("!IHBBQ")
_FLOW_STATS_HEAD = struct.Struct("!HBxIIHHHH4xQQQ")
_FEATURES_BODY = struct.Struct("!QIBB2xII")


def header(msg_type: int, length: int, xid: int) -> bytes:
    return OFP_HEADER.pack(OFP_VERSION, msg_type, length, xid)


def message(msg_type: int, xid: int, body: bytes = b"") -> bytes:
    return header(msg_type, OFP_HEADER.size + len(body), xid) + body


def mac_str(raw: bytes) -> str:
    return ":".join(f"{b:02x}" for b in raw)


def mac_bytes(mac: str) -> bytes:
    return bytes(int(p, 16) for p in mac.split(":"))


# ---------------------------------------------------------------------------
# OXM match encode/decode


def _oxm_header(field_id: int, length: int) -> bytes:
    return struct.pack("!I", (OXM_CLASS_BASIC << 16) | (field_id << 9) | length)


def encode_match(in_port: int | None = None, eth_src: str | None = None,
                 eth_dst: str | None = None) -> bytes:
    """ofp_match with OXM TLVs, padded to an 8-byte boundary."""
    fields = b""
    if in_port is not None:
        fields += _oxm_header(OXM_IN_PORT, 4) + struct.pack("!I", in_port)
    if eth_dst is not None:
        fields += _oxm_header(OXM_ETH_DST, 6) + mac_bytes(eth_dst)
    if eth_src is not None:
        fields += _oxm_header(OXM_ETH_SRC, 6) + mac_bytes(eth_src)
    length = 4 + len(fields)  # type + length prefix included in length
    pad = (8 - length % 8) % 8
    return struct.pack("!HH", 1, length) + fields + b"\x00" * pad


def decode_match(buf: bytes, off: int) -> tuple[dict, int]:
    """Parse one ofp_match at ``off``; returns (fields, next_offset) where
    next_offset is past the match padding."""
    mtype, mlen = struct.unpack_from("!HH", buf, off)
    out: dict = {}
    if mtype == 1:  # OXM
        end = off + mlen
        p = off + 4
        while p + 4 <= end:
            oxm, = struct.unpack_from("!I", buf, p)
            oclass = oxm >> 16
            ofield = (oxm >> 9) & 0x7F
            olen = oxm & 0xFF
            val = buf[p + 4 : p + 4 + olen]
            if oclass == OXM_CLASS_BASIC:
                if ofield == OXM_IN_PORT and olen == 4:
                    out["in_port"] = struct.unpack("!I", val)[0]
                elif ofield == OXM_ETH_DST and olen == 6:
                    out["eth_dst"] = mac_str(val)
                elif ofield == OXM_ETH_SRC and olen == 6:
                    out["eth_src"] = mac_str(val)
            p += 4 + olen
    return out, off + mlen + (8 - mlen % 8) % 8


# ---------------------------------------------------------------------------
# actions / instructions


def action_output(port: int, max_len: int = 0xFFFF) -> bytes:
    return struct.pack("!HHIH6x", OFPAT_OUTPUT, 16, port, max_len)


def action_set_queue(queue_id: int) -> bytes:
    return struct.pack("!HHI", OFPAT_SET_QUEUE, 8, queue_id)


def instruction_apply_actions(actions: bytes) -> bytes:
    return struct.pack("!HH4x", OFPIT_APPLY_ACTIONS, 8 + len(actions)) + actions


def instruction_meter(meter_id: int) -> bytes:
    return struct.pack("!HHI", OFPIT_METER, 8, meter_id)


def decode_instructions(instructions: bytes) -> list[dict]:
    """Structured view of an instruction list: one dict per instruction.

    apply_actions carries its actions decoded in order (output ports,
    queue ids); meter carries its meter id. Unknown instruction or
    action types decode as ``{"type": <int>}`` — never dropped, so a
    golden round-trip sees everything the encoder emitted.
    """
    out: list[dict] = []
    off = 0
    n = len(instructions)
    while off + 8 <= n:
        itype, ilen = struct.unpack_from("!HH", instructions, off)
        if ilen < 8 or off + ilen > n:
            raise ValueError(f"bad instruction length {ilen}")
        if itype == OFPIT_APPLY_ACTIONS:
            actions: list[dict] = []
            a = off + 8
            end = off + ilen
            while a + 8 <= end:
                atype, alen = struct.unpack_from("!HH", instructions, a)
                if alen < 8 or a + alen > end:
                    raise ValueError(f"bad action length {alen}")
                if atype == OFPAT_OUTPUT:
                    actions.append({
                        "type": "output",
                        "port": struct.unpack_from("!I", instructions, a + 4)[0],
                    })
                elif atype == OFPAT_SET_QUEUE:
                    actions.append({
                        "type": "set_queue",
                        "queue_id": struct.unpack_from(
                            "!I", instructions, a + 4
                        )[0],
                    })
                else:
                    actions.append({"type": atype})
                a += alen
            out.append({"type": "apply_actions", "actions": actions})
        elif itype == OFPIT_METER:
            out.append({
                "type": "meter",
                "meter_id": struct.unpack_from("!I", instructions, off + 4)[0],
            })
        else:
            out.append({"type": itype})
        off += ilen
    return out


def decode_output_port(instructions: bytes) -> int | None:
    """First OUTPUT action port inside an instruction list, or None."""
    off = 0
    n = len(instructions)
    while off + 8 <= n:
        itype, ilen = struct.unpack_from("!HH", instructions, off)
        if ilen < 8:
            return None
        if itype == OFPIT_APPLY_ACTIONS:
            a = off + 8
            end = off + ilen
            while a + 8 <= end:
                atype, alen = struct.unpack_from("!HH", instructions, a)
                if alen < 8:
                    return None
                if atype == OFPAT_OUTPUT and a + 8 <= end:
                    return struct.unpack_from("!I", instructions, a + 4)[0]
                a += alen
        off += ilen
    return None


# ---------------------------------------------------------------------------
# whole messages


def hello(xid: int) -> bytes:
    return message(OFPT_HELLO, xid)


def echo_reply(xid: int, payload: bytes = b"") -> bytes:
    return message(OFPT_ECHO_REPLY, xid, payload)


def features_request(xid: int) -> bytes:
    return message(OFPT_FEATURES_REQUEST, xid)


def features_reply(xid: int, datapath_id: int, n_buffers: int = 256,
                   n_tables: int = 254) -> bytes:
    body = _FEATURES_BODY.pack(datapath_id, n_buffers, n_tables, 0, 0x4F, 0)
    return message(OFPT_FEATURES_REPLY, xid, body)


def parse_features_reply(body: bytes) -> int:
    """→ datapath_id."""
    return _FEATURES_BODY.unpack_from(body)[0]


def flow_mod(xid: int, priority: int, match: bytes, instructions: bytes,
             buffer_id: int = OFP_NO_BUFFER, table_id: int = 0,
             command: int = OFPFC_ADD, cookie: int = 0,
             cookie_mask: int = 0) -> bytes:
    body = struct.pack(
        "!QQBBHHHIIIH2x",
        cookie, cookie_mask,
        table_id, command,
        0, 0,  # idle, hard timeout
        priority, buffer_id, OFPP_ANY, OFPG_ANY, 0,
    ) + match + instructions
    return message(OFPT_FLOW_MOD, xid, body)


def parse_flow_mod(body: bytes) -> dict:
    (cookie, cookie_mask, table_id, command, idle, hard, priority,
     buffer_id, out_port, out_group, flags) = struct.unpack_from(
        "!QQBBHHHIIIH2x", body
    )
    off = struct.calcsize("!QQBBHHHIIIH2x")
    match, off = decode_match(body, off)
    return {
        "priority": priority, "command": command, "buffer_id": buffer_id,
        "match": match, "instructions": body[off:],
        "cookie": cookie, "cookie_mask": cookie_mask, "table_id": table_id,
    }


def barrier_request(xid: int) -> bytes:
    return message(OFPT_BARRIER_REQUEST, xid)


def barrier_reply(xid: int) -> bytes:
    return message(OFPT_BARRIER_REPLY, xid)


def error_msg(xid: int, err_type: int, code: int,
              offending: bytes = b"") -> bytes:
    """OFPT_ERROR carrying (a prefix of) the offending message — the
    spec mandates at least its header, which is how the sender maps a
    refusal back to the flow-mod it issued."""
    return message(
        OFPT_ERROR, xid,
        struct.pack("!HH", err_type, code) + offending[:64],
    )


def parse_error(body: bytes) -> dict:
    """→ {type, code, offending_xid} — offending_xid recovered from the
    embedded original header when present (None otherwise)."""
    err_type, code = struct.unpack_from("!HH", body)
    offending_xid = None
    if len(body) >= 4 + OFP_HEADER.size:
        _, _, _, offending_xid = OFP_HEADER.unpack_from(body, 4)
    return {"type": err_type, "code": code, "offending_xid": offending_xid}


def packet_out(xid: int, buffer_id: int, in_port: int, actions: bytes,
               data: bytes = b"") -> bytes:
    body = struct.pack("!IIH6x", buffer_id, in_port, len(actions)) + actions
    if buffer_id == OFP_NO_BUFFER:
        body += data
    return message(OFPT_PACKET_OUT, xid, body)


def packet_in(xid: int, buffer_id: int, reason: int, match: bytes,
              frame: bytes, table_id: int = 0) -> bytes:
    body = (
        _PACKET_IN_HEAD.pack(buffer_id, len(frame), reason, table_id, 0)
        + match + b"\x00\x00" + frame
    )
    return message(OFPT_PACKET_IN, xid, body)


def parse_packet_in(body: bytes) -> dict:
    buffer_id, total_len, reason, table_id, cookie = _PACKET_IN_HEAD.unpack_from(
        body
    )
    off = _PACKET_IN_HEAD.size
    match, off = decode_match(body, off)
    frame = body[off + 2 :]  # 2 pad bytes before the ethernet frame
    out = {"buffer_id": buffer_id, "match": match, "frame": frame}
    if len(frame) >= 12:
        out["eth_dst"] = mac_str(frame[0:6])
        out["eth_src"] = mac_str(frame[6:12])
        out["eth_type"] = struct.unpack_from("!H", frame, 12)[0] if len(
            frame
        ) >= 14 else 0
    return out


def flow_stats_request(xid: int) -> bytes:
    body = struct.pack(
        "!HH4xB3xII4xQQ", OFPMP_FLOW, 0, OFPTT_ALL, OFPP_ANY, OFPG_ANY, 0, 0
    ) + encode_match()
    return message(OFPT_MULTIPART_REQUEST, xid, body)


def port_stats_request(xid: int) -> bytes:
    body = struct.pack("!HH4xI4x", OFPMP_PORT_STATS, 0, OFPP_ANY)
    return message(OFPT_MULTIPART_REQUEST, xid, body)


@dataclass
class FlowStat:
    priority: int
    packet_count: int
    byte_count: int
    match: dict = field(default_factory=dict)
    out_port: int | None = None


def flow_stats_reply(xid: int, stats: list[FlowStat]) -> bytes:
    entries = b""
    for s in stats:
        match = encode_match(
            in_port=s.match.get("in_port"),
            eth_src=s.match.get("eth_src"),
            eth_dst=s.match.get("eth_dst"),
        )
        instr = (
            instruction_apply_actions(action_output(s.out_port))
            if s.out_port is not None
            else b""
        )
        length = _FLOW_STATS_HEAD.size + len(match) + len(instr)
        entries += _FLOW_STATS_HEAD.pack(
            length, 0, 0, 0, s.priority, 0, 0, 0, 0,
            s.packet_count, s.byte_count,
        ) + match + instr
    body = struct.pack("!HH4x", OFPMP_FLOW, 0) + entries
    return message(OFPT_MULTIPART_REPLY, xid, body)


def parse_multipart_reply(body: bytes) -> tuple[int, list[FlowStat]]:
    """→ (multipart type, flow stats list; empty for non-flow types)."""
    mtype, flags = struct.unpack_from("!HH", body)
    stats: list[FlowStat] = []
    if mtype != OFPMP_FLOW:
        return mtype, stats
    off = 8
    n = len(body)
    while off + _FLOW_STATS_HEAD.size <= n:
        (length, table_id, dsec, dnsec, priority, idle, hard, flags_,
         cookie, pkts, byts) = _FLOW_STATS_HEAD.unpack_from(body, off)
        if length < _FLOW_STATS_HEAD.size:
            break
        match, moff = decode_match(body, off + _FLOW_STATS_HEAD.size)
        out_port = decode_output_port(body[moff : off + length])
        stats.append(FlowStat(priority, pkts, byts, match, out_port))
        off += length
    return mtype, stats


# ---------------------------------------------------------------------------
# stream framing


# Exception types a parser may raise on a malformed (but well-framed)
# message body — the connection loop drops such frames; anything else is
# a real bug and propagates. Single-sourced so the controller guard and
# the codec fuzz test cannot drift apart.
PARSE_ERRORS = (ValueError, struct.error, IndexError, KeyError)


class MessageReader:
    """Accumulates raw TCP bytes and yields complete OpenFlow messages as
    (type, xid, body) tuples."""

    def __init__(self):
        self._buf = b""

    def feed(self, data: bytes):
        self._buf += data
        out = []
        while len(self._buf) >= OFP_HEADER.size:
            version, mtype, length, xid = OFP_HEADER.unpack_from(self._buf)
            if length < OFP_HEADER.size:
                raise ValueError(f"bad OpenFlow length {length}")
            if len(self._buf) < length:
                break
            body = self._buf[OFP_HEADER.size : length]
            self._buf = self._buf[length:]
            out.append((mtype, xid, body))
        return out

"""The port's controller (``controller/switch.Controller``) against the
hand-assembled OpenFlow 1.3.5 byte streams of OVS 2.x's quirks in
``tests/test_ovs_replay.py``: the version-bitmap HELLO, ``n_buffers=0``
features, an echo payload returned verbatim, PACKET_IN padding, and a
priority-0 table-miss stats entry the monitor must drop.

The scripted peer, its stream builders and its hand framing are that
module's (never the port's or JAX's codec), driven here against the
port's ``Controller``. The twins require the golden counters and flow
mods by hand-decoded bytes, and the port's telemetry lines equal to JAX's
``Controller`` on the same stream, with each line's time field (the
poll's wall-clock second) masked.
"""

import struct

import pytest

import test_ovs_replay as ovs
from traffic_classifier_sdn_tpu.controller.switch import (
    Controller as JaxController,
)
from traffic_classifier_sdn_tpu_torch.controller.switch import Controller
from traffic_classifier_sdn_tpu_torch.ingest.protocol import parse_line


def _session(controller_cls):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ovs, "Controller", controller_cls)
        return ovs._session()


def _data_lines(telemetry: str) -> list:
    """The telemetry's ``data`` lines with the time field masked."""
    return sorted({
        "\t".join(["data", "<time>", *ln.split("\t")[2:]])
        for ln in telemetry.splitlines() if ln.startswith("data\t")
    })


def test_ovs_style_handshake_and_learning():
    seen, registered, _ = _session(Controller)
    assert seen["hello"], "controller never sent HELLO"
    assert seen["echo"] == b"ovs-echo", "echo payload not returned verbatim"
    assert ovs.DPID in registered
    prio = [struct.unpack_from("!H", b, 22)[0] for b in seen["flow_mods"]]
    miss = [b for b, p in zip(seen["flow_mods"], prio) if p == 0]
    assert miss and struct.pack("!I", 0xFFFFFFFD) in miss[0]
    learned = [b for b, p in zip(seen["flow_mods"], prio) if p == 1]
    assert learned, "no priority-1 flow-mod after packet-in with known dst"
    body = learned[0]
    assert ovs.oxm_eth(3, ovs.HOST_A) in body
    assert ovs.oxm_eth(4, ovs.HOST_B) in body
    assert struct.pack("!HHIH", 0, 16, 1, 0xFFFF) in body
    assert len(seen["packet_outs"]) >= 2
    assert any(ovs.eth(ovs.HOST_B, ovs.HOST_A) in b
               for b in seen["packet_outs"])
    # the same first flow mods and packet-outs, byte for byte, as JAX's
    jseen, _, _ = _session(JaxController)
    assert seen["flow_mods"][:2] == jseen["flow_mods"][:2]
    assert seen["packet_outs"][:2] == jseen["packet_outs"][:2]


def test_ovs_style_stats_render_telemetry():
    _seen, _registered, telemetry = _session(Controller)
    rows = [parse_line((ln + "\n").encode())
            for ln in telemetry.splitlines() if ln.startswith("data\t")]
    rows = [r for r in rows if r is not None]
    assert rows, f"no parseable telemetry rows in:\n{telemetry}"
    assert all(r.packets != 99 for r in rows)
    a_to_b = [r for r in rows if r.packets == 10]
    b_to_a = [r for r in rows if r.packets == 20]
    assert a_to_b and a_to_b[0].bytes == 1000
    assert b_to_a and b_to_a[0].bytes == 2000
    assert (rows[0].packets, rows[1].packets) == (10, 20)
    _, _, jtelemetry = _session(JaxController)
    assert _data_lines(telemetry) == _data_lines(jtelemetry)
    assert len(_data_lines(telemetry)) == 2

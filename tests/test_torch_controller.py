"""The port's OpenFlow 1.3 controller (``controller/``, a copy of the JAX
package's) and ``--source controller``: the codec against the JAX
package's byte for byte, the fake-switch session of JAX's
tests/test_controller.py through the port's modules
(``tools/torch_fake_switch.py``), and the CLI serves.

Every TCP port is 0 or a free port found first, every wait is bounded,
and every spawned process is ended on every exit path.
"""

import asyncio
import contextlib
import io
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import chip_smoke
from traffic_classifier_sdn_tpu import cli as jcli
from traffic_classifier_sdn_tpu.controller import openflow as jof
from traffic_classifier_sdn_tpu.io import checkpoint as jck
from traffic_classifier_sdn_tpu.models import forest as jforest
from traffic_classifier_sdn_tpu_torch import cli as tcli
from traffic_classifier_sdn_tpu_torch import interop
from traffic_classifier_sdn_tpu_torch.controller import openflow as of
from traffic_classifier_sdn_tpu_torch.controller.switch import Controller
from traffic_classifier_sdn_tpu_torch.ingest.batcher import FlowStateEngine
from traffic_classifier_sdn_tpu_torch.ingest.protocol import parse_line
from traffic_classifier_sdn_tpu_torch.io import checkpoint as tck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

from torch_fake_switch import FakeSwitch, eth_frame  # noqa: E402

CLASSES = ("dns", "game", "ping", "quake", "telnet", "voice")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- the codec ----------------------------------------------------------------

MATCH = dict(in_port=7, eth_src="aa:bb:cc:dd:ee:ff", eth_dst="11:22:33:44:55:66")
STATS = [
    (1, 100, 5000, {"in_port": 1, "eth_src": "aa:aa:aa:aa:aa:aa",
                    "eth_dst": "bb:bb:bb:bb:bb:bb"}, 2),
    (0, 7, 70, {}, None),
]
MESSAGES = {  # name -> builder over an openflow module
    "hello": lambda m: m.hello(1),
    "features_request": lambda m: m.features_request(2),
    "features_reply": lambda m: m.features_reply(3, 42),
    "echo_reply": lambda m: m.echo_reply(4, b"ping"),
    "match": lambda m: m.encode_match(**MATCH),
    "empty_match": lambda m: m.encode_match(),
    "flow_mod": lambda m: m.flow_mod(
        3, priority=1, match=m.encode_match(**MATCH),
        instructions=m.instruction_apply_actions(m.action_output(5))),
    "flow_stats_reply": lambda m: m.flow_stats_reply(
        9, [m.FlowStat(p, n, b, mt, out_port=o) for p, n, b, mt, o in STATS]),
    "flow_stats_request": lambda m: m.flow_stats_request(5),
    "port_stats_request": lambda m: m.port_stats_request(6),
    "packet_in": lambda m: m.packet_in(
        4, m.OFP_NO_BUFFER, 0, m.encode_match(in_port=3),
        eth_frame("aa:aa:aa:aa:aa:aa", "bb:bb:bb:bb:bb:bb")),
    "packet_out": lambda m: m.packet_out(
        8, m.OFP_NO_BUFFER, 3, m.action_output(m.OFPP_FLOOD), b"\x01" * 60),
}


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_encodings_equal_jax_bytes(name):
    assert MESSAGES[name](of) == MESSAGES[name](jof)


def test_match_roundtrip():
    raw = of.encode_match(**MATCH)
    assert len(raw) % 8 == 0
    fields, off = of.decode_match(raw, 0)
    assert off == len(raw) and fields == MATCH
    fields, off = of.decode_match(of.encode_match(), 0)
    assert fields == {} and off == 8


def test_flow_mod_roundtrip():
    mtype, xid, body = of.MessageReader().feed(MESSAGES["flow_mod"](of))[0]
    assert (mtype, xid) == (of.OFPT_FLOW_MOD, 3)
    fm = of.parse_flow_mod(body)
    assert fm["priority"] == 1 and fm["match"]["in_port"] == 7
    assert of.decode_output_port(fm["instructions"]) == 5


def test_flow_stats_roundtrip():
    msg = MESSAGES["flow_stats_reply"](of)
    mtype, xid, body = of.MessageReader().feed(msg)[0]
    assert (mtype, xid) == (of.OFPT_MULTIPART_REPLY, 9)
    mp_type, parsed = of.parse_multipart_reply(body)
    assert mp_type == of.OFPMP_FLOW and len(parsed) == 2
    assert (parsed[0].packet_count, parsed[0].byte_count) == (100, 5000)
    assert parsed[0].match["eth_dst"] == "bb:bb:bb:bb:bb:bb"
    assert parsed[0].out_port == 2 and parsed[1].priority == 0


def test_packet_in_roundtrip():
    frame = eth_frame("aa:aa:aa:aa:aa:aa", "bb:bb:bb:bb:bb:bb")
    _, _, body = of.MessageReader().feed(MESSAGES["packet_in"](of))[0]
    pkt = of.parse_packet_in(body)
    assert pkt["match"]["in_port"] == 3 and pkt["frame"] == frame
    assert (pkt["eth_src"], pkt["eth_dst"]) == ("aa:aa:aa:aa:aa:aa",
                                                "bb:bb:bb:bb:bb:bb")


def test_message_reader_partial_frames():
    msg = of.hello(1) + of.features_request(2)
    mr = of.MessageReader()
    assert mr.feed(msg[:5]) == []
    assert [m[0] for m in mr.feed(msg[5:9])] == [of.OFPT_HELLO]
    assert [m[0] for m in mr.feed(msg[9:])] == [of.OFPT_FEATURES_REQUEST]


def test_codec_fuzz_raises_only_handled_types():
    """Byte-mutated frames through every parser raise only
    ``PARSE_ERRORS`` (what the connection loop drops), as in JAX's fuzz."""
    rng = np.random.RandomState(123)
    valid = [MESSAGES[n](of) for n in ("flow_stats_reply", "packet_in",
                                       "flow_mod")]
    parsers = {of.OFPT_MULTIPART_REPLY: of.parse_multipart_reply,
               of.OFPT_PACKET_IN: of.parse_packet_in,
               of.OFPT_FLOW_MOD: of.parse_flow_mod}
    for trial in range(300):
        frame = bytearray(valid[trial % len(valid)])
        for _ in range(rng.randint(1, 4)):
            op = rng.randint(3)
            if op == 0 and len(frame) > 9:
                frame[rng.randint(8, len(frame))] = rng.randint(256)
            elif op == 1 and len(frame) > 9:
                del frame[rng.randint(9, len(frame)):]
            else:
                frame.extend(rng.bytes(rng.randint(1, 9)))
        _, mtype, _, _ = of.OFP_HEADER.unpack_from(frame)
        with contextlib.suppress(*of.PARSE_ERRORS):
            parsers[mtype](bytes(frame[8:]))


# -- the controller and the fake switch ------------------------------------

async def _run_session(n_polls=3, n_hosts=4):
    out = io.StringIO()
    ctl = Controller(host="127.0.0.1", port=0, poll_interval=0.05, out=out)
    await ctl.start()
    try:
        sw = FakeSwitch(dpid=42, n_hosts=n_hosts)
        await sw.connect("127.0.0.1", ctl.bound_port)
        await sw.pump(0.2)  # hello/features/table-miss handshake
        for a in range(0, n_hosts - 1, 2):
            sw.converse(a, a + 1)
        await sw.pump(0.05 * (n_polls + 4))
        registered = dict(ctl.datapaths)
    finally:
        await ctl.stop()
    return registered, sw, out.getvalue()


@pytest.fixture(scope="module")
def session():
    return asyncio.run(asyncio.wait_for(_run_session(), timeout=30))


def test_controller_registers_and_installs_flows(session):
    registered, sw, _ = session
    assert registered[42].dpid == 42
    prios = sorted(f["priority"] for f in sw.flows)
    assert prios[0] == 0  # the table-miss flow
    p1 = [f for f in sw.flows if f["priority"] == 1]
    assert len(p1) == 4  # 2 pairs × 2 directions
    for f in p1:
        assert f["match"]["in_port"] == sw.port_of[f["match"]["eth_src"]]
        assert f["out_port"] == sw.port_of[f["match"]["eth_dst"]]


def test_monitor_emits_parseable_telemetry(session):
    _, sw, text = session
    records = [r for r in (parse_line(line.encode() + b"\n")
                           for line in text.splitlines()) if r is not None]
    assert len(records) >= 4
    by_flow = {}
    for r in records:
        assert r.datapath == "42" and r.eth_src in sw.macs
        assert int(r.out_port) == sw.port_of[r.eth_dst]
        by_flow.setdefault((r.eth_src, r.eth_dst), []).append(r.packets)
    assert any(v[-1] > v[0] for v in by_flow.values() if len(v) > 1)


def test_telemetry_drives_the_port_flow_table(session):
    """The controller's telemetry through the port's ingest: 4 directed
    flows fold into 2 conversations."""
    _, _, text = session
    eng = FlowStateEngine(capacity=32, device="cpu")
    eng.ingest_bytes(text.encode())
    eng.step()
    assert eng.num_flows() == 2


def _echo_probe(frames: list[bytes], want_xid: int, payload: bytes):
    async def run():
        ctl = Controller(host="127.0.0.1", port=0, poll_interval=10,
                         out=io.StringIO())
        await ctl.start()
        try:
            reader, writer = await asyncio.open_connection(
                "127.0.0.1", ctl.bound_port)
            for f in frames:
                writer.write(f)
            writer.write(of.message(of.OFPT_ECHO_REQUEST, want_xid, payload))
            await writer.drain()
            mr, got = of.MessageReader(), {}
            for _ in range(20):
                data = await asyncio.wait_for(reader.read(4096), timeout=2.0)
                if not data:
                    break
                for mtype, xid, body in mr.feed(data):
                    got[(mtype, xid)] = body
                if (of.OFPT_ECHO_REPLY, want_xid) in got:
                    break
            writer.close()
        finally:
            await ctl.stop()
        return got

    return asyncio.run(run())


def test_echo_and_junk_resilience():
    got = _echo_probe([of.message(of.OFPT_ECHO_REQUEST, 77, b"ping"),
                       of.message(25, 78, b"\x00" * 8)], 79, b"pong")
    assert got[(of.OFPT_ECHO_REPLY, 77)] == b"ping"
    assert got[(of.OFPT_ECHO_REPLY, 79)] == b"pong"


def test_malformed_bodies_do_not_kill_connection():
    got = _echo_probe([of.message(of.OFPT_PACKET_IN, 11, b"\x01\x02"),
                       of.message(of.OFPT_MULTIPART_REPLY, 12, b"\x00"),
                       of.message(of.OFPT_FEATURES_REPLY, 13, b"\x00\x01")],
                      14, b"alive")
    assert got[(of.OFPT_ECHO_REPLY, 14)] == b"alive"


# -- the CLI serves ------------------------------------------------------------

@pytest.fixture(scope="module")
def forest_ckpts(tmp_path_factory, session):
    """(JAX checkpoint, port checkpoint) of one seeded forest drawn from
    the session's served features."""
    _, _, text = session
    eng = FlowStateEngine(capacity=32, device="cpu")
    eng.ingest_bytes(text.encode())
    eng.step()
    X = eng.features().numpy()
    X = np.concatenate([X[np.abs(X).sum(1) > 0]] * 4)
    X = X * np.random.RandomState(0).uniform(0.5, 2.0, X.shape)
    d = chip_smoke.random_forest(0, X.astype(np.float32), n_trees=8)
    tmp = tmp_path_factory.mktemp("ctl")
    jdir, tdir = str(tmp / "jax"), str(tmp / "port")
    jck.save_model(jdir, "forest", jforest.from_numpy(d), classes=CLASSES)
    tck.save_model(tdir, "forest",
                   interop.forest_params_from_numpy(d, device="cpu"),
                   classes=CLASSES)
    return jdir, tdir


@contextlib.contextmanager
def fake_switch(port: int, hosts: int, duration: float):
    """``tools/torch_fake_switch.py`` as a subprocess, ended on exit."""
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools", "torch_fake_switch.py"),
         "--port", str(port), "--hosts", str(hosts),
         "--duration", str(duration)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, cwd=ROOT)
    try:
        yield proc
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


def test_cli_source_controller_spawns_the_port_controller(forest_ckpts,
                                                          capsys):
    """JAX tests/test_cli.py's three-process case through the port: the
    serve spawns ``python -m traffic_classifier_sdn_tpu_torch.controller
    --port P`` itself (no --monitor-cmd), the fake switch connects, and
    the learned MACs reach the printed table."""
    _, tdir = forest_ckpts
    port = free_port()
    args = tcli._build_parser().parse_args([
        "Randomforest", "--source", "controller", "--of-port", str(port),
        "--native-checkpoint", tdir])
    assert tcli._resolved_monitor_cmd(args) == (
        f"{sys.executable} -m traffic_classifier_sdn_tpu_torch.controller "
        f"--port {port}")
    with fake_switch(port, 4, 30):
        summary = tcli.main([
            "Randomforest", "--source", "controller", "--of-port", str(port),
            "--native-checkpoint", tdir, "--capacity", "32",
            "--print-every", "2", "--max-ticks", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "Flow ID" in out and "00:00:00:00:00:01" in out
    assert summary.engine.num_flows() == 2 and summary.ticks == 4


EMITTER = textwrap.dedent("""\
    import sys, time
    blocks = open(sys.argv[1]).read().split("\\n\\n")
    for b in blocks:
        print(b, flush=True)
        time.sleep(0.8)
""")


def test_cli_source_controller_stdout_equals_jax(forest_ckpts, session,
                                                 tmp_path):
    """One controller transcript (the session's polls), served poll by
    poll as the ``--source controller`` monitor of both CLIs (its
    --monitor-cmd override), prints the same stdout from both serial
    serves. The polls are 0.8 s apart and the JAX serve compiles at
    startup (--warmup), so each poll is one tick on both sides."""
    jdir, tdir = forest_ckpts
    _, _, text = session
    polls = [b for b in text.split("datapath ")[1:] if "data\t" in b][:4]
    assert len(polls) >= 3
    (tmp_path / "polls.txt").write_text(
        "\n\n".join("datapath " + p.rstrip("\n") for p in polls))
    (tmp_path / "emit.py").write_text(EMITTER)
    cmd = f"{sys.executable} {tmp_path / 'emit.py'} {tmp_path / 'polls.txt'}"
    argv = ["--source", "controller", "--monitor-cmd", cmd, "--capacity",
            "32", "--print-every", "1", "--pipeline", "off"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jcli.main(["Randomforest", "--native-checkpoint", jdir, *argv,
                   "--warmup"])
    want = buf.getvalue()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summary = tcli.main(["Randomforest", "--native-checkpoint", tdir,
                             *argv, "--degrade", "off", "--device", "cpu"])
    assert buf.getvalue() == want
    # a tick per poll, and one more for the exited monitor's last read
    assert want.count("Flow ID") == summary.ticks >= len(polls)

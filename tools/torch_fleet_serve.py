#!/usr/bin/env python
"""Fleet launcher: N serves of the port + one roster-of-rosters scrape
target — the port's copy of ``tools/fleet_serve.py``.

Launches ``--members`` serve processes of the port's CLI (``python -m
traffic_classifier_sdn_tpu_torch.cli``), each owning a contiguous
partition of ``--total-sources`` telemetry sources
(serving/fleet.partition_sources), all sharing ONE model-checkpoint
rotation directory (``--drift-dir``). Member 0 is the leader; every
other member runs ``--drift-follow``, so a promotion staged by any
member propagates fleet-wide through each follower's OWN parity-gated
probes (the wrong-but-fresh gate is never bypassed — see
serving/drift.py and tests/test_torch_fleet.py).

Each member binds an ephemeral observability plane (``--obs-port 0``);
the launcher parses the bound port off the member's startup line and
raises serving/fleet.FleetAggregator over the member ``/healthz``
URLs — one scrape answers the whole fleet: member health conjunction,
every fan-in source annotated with its member, drift state per member,
``promotions_total`` to watch a promotion sweep the fleet.

Emits one JSON roster line once the fleet is up, then a fleet summary
line per ``--poll-s`` until the members exit (``--max-ticks``) or
SIGINT. Exit status 0 iff every member exited 0. Every member runs on
``--device`` (default cuda; the members share one card). The launcher
has no ``--shards`` of its own (the JAX launcher's, which passes a shard
count to every member, is not ported): each member serves one device's
table.

Usage:
  tools/torch_fleet_serve.py gaussiannb --native-checkpoint CKPT \
      --members 2 --total-sources 8 \
      --drift-dir /tmp/fleet-rotation --max-ticks 30 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from traffic_classifier_sdn_tpu_torch.serving import fleet  # noqa: E402

_OBS_LINE = re.compile(r"observability plane on port (\d+)")


def _member_argv(args: argparse.Namespace, count: int,
                 follower: bool) -> list[str]:
    argv = [
        sys.executable, "-m", "traffic_classifier_sdn_tpu_torch.cli",
        args.model,
        "--source", "synthetic",
        "--synthetic-flows", str(args.synthetic_flows),
        "--sources", str(count),
        "--capacity", str(args.capacity),
        "--table-rows", str(args.table_rows),
        "--print-every", str(args.print_every),
        "--max-ticks", str(args.max_ticks),
        "--obs-port", "0",
        "--device", args.device,
    ]
    argv += ["--native-checkpoint", args.native_checkpoint]
    if args.drift_dir:
        argv += ["--drift", "auto", "--drift-dir", args.drift_dir]
        if follower:
            argv.append("--drift-follow")
    if args.lockstep:
        argv.append("--source-lockstep")
    argv += args.member_arg
    return argv


class _Member:
    """One serve process + the stderr pump that finds its obs port."""

    def __init__(self, idx: int, span: tuple[int, int],
                 argv: list[str], env: dict, log_path: str | None):
        self.idx = idx
        self.span = span
        self.port: int | None = None
        self._port_found = threading.Event()
        self._log = open(log_path, "wb") if log_path else None
        self.proc = subprocess.Popen(
            argv, stdout=self._log or subprocess.DEVNULL,
            stderr=subprocess.PIPE, env=env,
        )
        # drain stderr forever (a full pipe would wedge the member);
        # the first obs line carries the ephemeral port
        self._pump = threading.Thread(
            target=self._drain, name=f"fleet-member-{idx}-stderr",
            daemon=True,
        )
        self._pump.start()

    def _drain(self) -> None:
        for raw in self.proc.stderr:
            if self._log is not None:
                self._log.write(raw)
                self._log.flush()
            if self.port is None:
                m = _OBS_LINE.search(raw.decode(errors="replace"))
                if m:
                    self.port = int(m.group(1))
                    self._port_found.set()
        self._port_found.set()  # EOF: stop any waiter either way

    def wait_port(self, timeout: float) -> int | None:
        self._port_found.wait(timeout)
        return self.port

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        if self._log is not None:
            self._log.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__.splitlines()[0], prog="torch_fleet_serve.py"
    )
    ap.add_argument("model", help="model family for every member "
                    "(e.g. gaussiannb)")
    ap.add_argument("--native-checkpoint", required=True,
                    help="the port's model checkpoint every member serves")
    ap.add_argument("--members", type=int, default=2)
    ap.add_argument("--total-sources", type=int, default=4,
                    help="region-wide telemetry sources, partitioned "
                    "contiguously across members")
    ap.add_argument("--drift-dir", default=None, metavar="DIR",
                    help="SHARED rotation directory — what makes the "
                    "fleet one system; member 0 leads, the rest follow")
    ap.add_argument("--synthetic-flows", type=int, default=16)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--table-rows", type=int, default=8)
    ap.add_argument("--print-every", type=int, default=5,
                    help="member render cadence in ticks (renders also "
                    "feed the drift capture, so keep it > 0; member "
                    "stdout goes to --log-dir or is discarded)")
    ap.add_argument("--max-ticks", type=int, default=30)
    ap.add_argument("--lockstep", action="store_true",
                    help="lockstep fan-in pumps (deterministic demo)")
    ap.add_argument("--port", type=int, default=0,
                    help="aggregator bind port (0 = ephemeral)")
    ap.add_argument("--poll-s", type=float, default=2.0)
    ap.add_argument("--log-dir", default=None,
                    help="per-member stdout+stderr logs "
                    "(member-<i>.log); default discards stdout")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="every member's --device (default cuda)")
    ap.add_argument("--member-arg", action="append", default=[],
                    metavar="ARG", help="extra argv appended to every "
                    "member (repeatable)")
    args = ap.parse_args(argv)

    if args.members < 1:
        ap.error("--members must be >= 1")
    spans = fleet.partition_sources(args.total_sources, args.members)
    if any(n == 0 for _, n in spans):
        ap.error(
            f"--total-sources {args.total_sources} leaves an idle "
            f"member at --members {args.members}"
        )

    env = dict(os.environ)
    if args.log_dir:
        os.makedirs(args.log_dir, exist_ok=True)

    members: list[_Member] = []
    rc = 0
    try:
        for i, span in enumerate(spans):
            log = (os.path.join(args.log_dir, f"member-{i}.log")
                   if args.log_dir else None)
            members.append(_Member(
                i, span,
                _member_argv(args, span[1], follower=i > 0),
                env, log,
            ))
        urls = []
        for m in members:
            port = m.wait_port(timeout=120.0)
            if port is None:
                print(
                    f"ERROR: member {m.idx} died before binding its "
                    f"observability plane (rc={m.proc.poll()})",
                    file=sys.stderr,
                )
                return 1
            urls.append(f"http://127.0.0.1:{port}/healthz")

        with fleet.FleetAggregator(urls, port=args.port) as agg:
            print(json.dumps({
                "fleet_healthz": f"http://127.0.0.1:{agg.port}/healthz",
                "members": [
                    {"member": m.idx, "pid": m.proc.pid,
                     "obs_port": m.port,
                     "sources": {"first": m.span[0], "count": m.span[1]}}
                    for m in members
                ],
                "drift_dir": args.drift_dir,
            }, sort_keys=True), flush=True)
            while any(m.proc.poll() is None for m in members):
                time.sleep(args.poll_s)
                healthy, report = agg.check()
                print(json.dumps({
                    "healthy": healthy,
                    "members_reachable": report["members_reachable"],
                    "members_healthy": report["members_healthy"],
                    "drift_states": report["drift_states"],
                    "swapped": report["swapped"],
                    "promotions_total": report["promotions_total"],
                }, sort_keys=True), flush=True)
        rc = max(
            (m.proc.returncode or 0 for m in members), default=0
        )
    except KeyboardInterrupt:
        rc = 130
    finally:
        for m in members:
            m.stop()
    return rc


if __name__ == "__main__":
    signal.signal(signal.SIGINT, signal.default_int_handler)
    sys.exit(main())

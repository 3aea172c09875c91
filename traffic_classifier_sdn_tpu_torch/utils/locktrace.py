"""locktrace: a lockdep-style runtime witness for the port's locks.

The static side (``analysis_static/graftlock.py``) proves lock-order
acyclicity over the edges it can SEE; this module is the dynamic
cross-check. Opt-in (``TCSDN_LOCKTRACE=1`` around ``cli.main``, or the
autouse fixtures of the port's chaos/degrade/drift/pipeline/scenarios
suites): while installed, every ``threading.Lock()`` /
``threading.Condition()`` constructed from the port's code is wrapped
in a tracing shim that

- records the actual acquisition order per thread (a thread-local held
  stack),
- asserts acyclicity ONLINE, lockdep-style: when thread T acquires B
  while holding A, the edge A→B joins a global order graph; if a path
  B→…→A already exists, the AB/BA deadlock is reported *the first time
  the two orders are both observed* — no actual deadlock (no
  unfortunate interleaving) has to manifest, and
- cross-checks observed edges against the static lock-order graph
  (``docs/artifacts/torch_lock_order_graph.json``): locks are
  identified by CONSTRUCTION SITE (file:line), the same lockdep "lock
  class" keying the static graph exports in each node's
  ``constructed_at`` — an observed edge absent from the static graph is
  a hole in the static analysis worth closing.

The witness itself must never deadlock the host: its only lock
(``_meta``) is a leaf — no traced lock is ever acquired while holding
it, and violation hooks (the flight recorder) run strictly after it is
released. Stdlib-internal locks (queue.Queue's mutex, Condition's
default RLock, http.server plumbing) are constructed from stdlib files
and therefore never wrapped — the scope filter keys on the
construction frame's filename.

Nesting: ``install`` captures the factories it replaces and
``uninstall`` puts exactly those back, so two witnesses that patch
``threading.Lock`` (another package's and this one) nest last in first
out. A construction outside this witness's scope is handed to the
factory it replaced, called from a frame that carries the constructing
file and line, so the witness underneath still keys it by its own site.
"""

from __future__ import annotations

import json
import os
import sys
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG_NAME = os.path.basename(_PKG_DIR)
_REPO_ROOT = os.path.dirname(_PKG_DIR)
DEFAULT_GRAPH_PATH = os.path.join(
    _REPO_ROOT, "docs", "artifacts", "torch_lock_order_graph.json"
)
ENV_FLAG = "TCSDN_LOCKTRACE"
# finish() also writes its report there as JSON
ENV_OUT = "TCSDN_LOCKTRACE_OUT"


def _site_key(filename: str, lineno: int) -> str:
    """Normalize a construction frame to the repo-relative form the
    static graph uses (``traffic_classifier_sdn_tpu_torch/...py:line``)."""
    norm = filename.replace(os.sep, "/")
    marker = "/" + _PKG_NAME + "/"
    idx = norm.rfind(marker)
    if idx >= 0:
        norm = _PKG_NAME + "/" + norm[idx + len(marker):]
    return f"{norm}:{lineno}"


class LockWitness:
    """The order graph + per-thread held stacks + violation log."""

    def __init__(self, recorder=None):
        self.active = True
        self.recorder = recorder  # obs.FlightRecorder, attached late
        self._meta = threading.Lock()  # leaf: guards the graph only
        self._local = threading.local()
        self._edges: dict[tuple[str, str], dict] = {}
        self._violations: list[dict] = []
        self._sites: set[str] = set()
        # id()s of violation dicts already sent to self.recorder, so
        # finish() never duplicates a live-recorded event in the ring
        self._logged: set[int] = set()

    # -- the per-acquisition hooks ------------------------------------------
    def _stack(self) -> list[str]:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def note_acquire(self, site: str) -> None:
        if not self.active:
            return
        stack = self._stack()
        held = [s for s in stack if s != site]
        fresh: list[dict] = []
        with self._meta:
            self._sites.add(site)
            for a in held:
                v = self._add_edge_locked(a, site)
                if v is not None:
                    fresh.append(v)
        stack.append(site)
        recorder = self.recorder
        if fresh and recorder is not None:
            # strictly AFTER _meta is released: the recorder's ring
            # lock is itself traced, and the witness must stay a leaf
            for v in fresh:
                recorder.record("locktrace.violation", **v)
            with self._meta:
                self._logged.update(id(v) for v in fresh)

    def note_release(self, site: str) -> None:
        stack = getattr(self._local, "stack", None)
        if not stack:
            return
        # last occurrence: re-entrant wrappers (Condition re-acquire
        # after wait) release in LIFO order
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == site:
                del stack[i]
                return

    # -- the order graph (callers hold _meta) -------------------------------
    def _add_edge_locked(self, a: str, b: str) -> dict | None:
        if (a, b) in self._edges:
            return None
        back = self._path_locked(b, a)
        self._edges[(a, b)] = {
            "thread": threading.current_thread().name,
        }
        if back is None:
            return None
        violation = {
            "edge": [a, b],
            "conflict_path": back,
            "thread": threading.current_thread().name,
        }
        key = frozenset([a, b, *back])
        if not any(
            frozenset([*v["edge"], *v["conflict_path"]]) == key
            for v in self._violations
        ):
            self._violations.append(violation)
            return violation
        return None

    def _path_locked(self, src: str, dst: str) -> list[str] | None:
        adj: dict[str, list[str]] = {}
        for x, y in self._edges:
            adj.setdefault(x, []).append(y)
        prev: dict[str, str] = {}
        frontier, visited = [src], {src}
        while frontier:
            nxt = []
            for n in frontier:
                for m in adj.get(n, ()):
                    if m in visited:
                        continue
                    visited.add(m)
                    prev[m] = n
                    if m == dst:
                        path = [dst]
                        while path[-1] != src:
                            path.append(prev[path[-1]])
                        return list(reversed(path))
                    nxt.append(m)
            frontier = nxt
        return None

    # -- results ------------------------------------------------------------
    @property
    def violations(self) -> list[dict]:
        with self._meta:
            return list(self._violations)

    def edges(self) -> list[tuple[str, str]]:
        with self._meta:
            return sorted(self._edges)

    def report(self) -> dict:
        with self._meta:
            return {
                "edges": [list(e) for e in sorted(self._edges)],
                "violations": list(self._violations),
                "sites": sorted(self._sites),
            }

    def check_against(self, graph: dict | None) -> dict:
        """Cross-check observed edges against the static lock-order
        graph export. Returns ``{"unknown_edges": [...],
        "unmapped_sites": [...]}`` — an unknown edge is one the static
        pass missed (both endpoints map to static nodes but the edge is
        absent); an unmapped site is a lock the static pass never keyed
        at all."""
        if graph is None:
            return {"unknown_edges": [], "unmapped_sites": [],
                    "checked": False}
        site_to_node: dict[str, str] = {}
        for node in graph.get("nodes", ()):
            for site in node.get("constructed_at", ()):
                site_to_node[site] = node["id"]
        static_edges = {
            (e["from"], e["to"]) for e in graph.get("edges", ())
        }
        unknown, unmapped = [], set()
        for a, b in self.edges():
            na, nb = site_to_node.get(a), site_to_node.get(b)
            if na is None:
                unmapped.add(a)
            if nb is None:
                unmapped.add(b)
            if na is None or nb is None:
                continue
            if na != nb and (na, nb) not in static_edges:
                unknown.append({"from": na, "to": nb,
                                "observed": [a, b]})
        return {"unknown_edges": unknown,
                "unmapped_sites": sorted(unmapped), "checked": True}


# ---------------------------------------------------------------------------
# traced wrappers
# ---------------------------------------------------------------------------


class TracedLock:
    """threading.Lock shim: same surface, every transition witnessed."""

    def __init__(self, inner, site: str, witness: LockWitness):
        self._inner = inner
        self._site = site
        self._witness = witness

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._witness.note_acquire(self._site)
        return ok

    def release(self) -> None:
        self._inner.release()
        self._witness.note_release(self._site)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f"<TracedLock {self._site} {self._inner!r}>"


class TracedCondition(TracedLock):
    """threading.Condition shim. ``wait``/``wait_for`` release the
    condition's own lock while waiting — the witness pops the site for
    the duration so a parked waiter is not "holding" its condition."""

    def wait(self, timeout: float | None = None):
        self._witness.note_release(self._site)
        try:
            return self._inner.wait(timeout)
        finally:
            self._witness.note_acquire(self._site)

    def wait_for(self, predicate, timeout: float | None = None):
        self._witness.note_release(self._site)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            self._witness.note_acquire(self._site)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


# ---------------------------------------------------------------------------
# installation
# ---------------------------------------------------------------------------

_REAL_LOCK = threading.Lock
_REAL_CONDITION = threading.Condition
_installed: LockWitness | None = None
# the factories the installed witness replaced (restored on uninstall)
_saved: dict[str, object] = {}
# (filename, line) → a trampoline whose frame carries that file and line
_TRAMPOLINES: dict[tuple[str, int], object] = {}


def _default_scope(filename: str) -> bool:
    norm = filename.replace(os.sep, "/")
    if norm.endswith("utils/locktrace.py"):
        return False
    return f"/{_PKG_NAME}/" in norm or norm.startswith(
        _PKG_NAME + "/"
    )


def _call_from(frame, fn, *args):
    """``fn(*args)`` called from a frame whose code has ``frame``'s file
    and line: a factory underneath that reads ``sys._getframe(1)`` (a
    witness installed before this one) keys the construction by the
    real site, not by this module."""
    key = (frame.f_code.co_filename, frame.f_lineno)
    tramp = _TRAMPOLINES.get(key)
    if tramp is None:
        ns: dict = {}
        exec(compile("\n" * (key[1] - 1)
                     + "def _t(fn, args): return fn(*args)\n",
                     key[0], "exec"), ns)
        tramp = _TRAMPOLINES[key] = ns["_t"]
    return tramp(fn, args)


def install(witness: LockWitness, scope=None) -> None:
    """Monkeypatch ``threading.Lock``/``threading.Condition`` with
    site-keyed tracing factories. ``scope(filename) -> bool`` bounds
    which construction sites are wrapped (default: the port's files
    only — stdlib and third-party locks stay real)."""
    global _installed
    if _installed is not None:
        raise RuntimeError("locktrace already installed")
    in_scope = scope if scope is not None else _default_scope
    prev_lock = threading.Lock
    prev_condition = threading.Condition

    def lock_factory():
        frame = sys._getframe(1)
        if in_scope(frame.f_code.co_filename):
            site = _site_key(frame.f_code.co_filename, frame.f_lineno)
            return TracedLock(_REAL_LOCK(), site, witness)
        if prev_lock is _REAL_LOCK:
            return _REAL_LOCK()
        return _call_from(frame, prev_lock)

    def condition_factory(lock=None):
        frame = sys._getframe(1)
        if lock is None and in_scope(frame.f_code.co_filename):
            site = _site_key(frame.f_code.co_filename, frame.f_lineno)
            return TracedCondition(_REAL_CONDITION(), site, witness)
        if isinstance(lock, TracedLock):
            lock = lock._inner
        if prev_condition is _REAL_CONDITION:
            return (_REAL_CONDITION(lock) if lock is not None
                    else _REAL_CONDITION())
        args = (lock,) if lock is not None else ()
        return _call_from(frame, prev_condition, *args)

    _saved.update({"Lock": prev_lock, "Condition": prev_condition})
    threading.Lock = lock_factory  # type: ignore[misc]
    threading.Condition = condition_factory  # type: ignore[misc,assignment]
    _installed = witness


def uninstall() -> None:
    """Restore the factories ``install`` replaced. Wrappers already
    handed out keep working (their witness goes inactive so late
    acquisitions are ignored, releases stay tolerated)."""
    global _installed
    threading.Lock = _saved.pop("Lock", _REAL_LOCK)  # type: ignore[misc]
    threading.Condition = _saved.pop(  # type: ignore[misc]
        "Condition", _REAL_CONDITION
    )
    if _installed is not None:
        _installed.active = False
    _installed = None


class tracing:
    """``with tracing() as witness:`` — scoped install/uninstall, the
    test-fixture idiom."""

    def __init__(self, recorder=None, scope=None):
        self.witness = LockWitness(recorder=recorder)
        self._scope = scope

    def __enter__(self) -> LockWitness:
        install(self.witness, scope=self._scope)
        return self.witness

    def __exit__(self, *exc) -> bool:
        uninstall()
        return False


# ---------------------------------------------------------------------------
# static-graph loading + the CLI env hook
# ---------------------------------------------------------------------------


def load_static_graph(path: str | None = None) -> dict | None:
    """The exported static lock-order graph, or None when absent (an
    installed package without the repo's docs tree)."""
    candidate = path or os.environ.get(
        "TCSDN_TORCH_LOCK_GRAPH", DEFAULT_GRAPH_PATH
    )
    try:
        with open(candidate, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def maybe_trace_from_env() -> LockWitness | None:
    """CLI hook: install the witness when ``TCSDN_LOCKTRACE=1`` (the
    operator opt-in). Returns the witness, or None when
    the flag is off or a witness is already installed."""
    if os.environ.get(ENV_FLAG) != "1" or _installed is not None:
        return None
    witness = LockWitness()
    install(witness)
    return witness


def finish(witness: LockWitness | None, recorder=None) -> dict | None:
    """CLI teardown: uninstall, surface violations (stderr + the flight
    recorder) and the static cross-check. Returns the report dict."""
    if witness is None:
        return None
    if _installed is witness:
        uninstall()
    report = witness.report()
    report["cross_check"] = witness.check_against(load_static_graph())
    path = os.environ.get(ENV_OUT)
    if path:
        from .atomicio import atomic_write_bytes

        atomic_write_bytes(path, (json.dumps(report, indent=2)
                                  + "\n").encode())
    with witness._meta:
        logged = set(witness._logged)
    for v in report["violations"]:
        print(
            f"LOCKTRACE VIOLATION: edge {v['edge'][0]} -> "
            f"{v['edge'][1]} closes cycle via "
            f"{' -> '.join(v['conflict_path'])} (thread {v['thread']})",
            file=sys.stderr, flush=True,
        )
        # live-recorded violations (witness.recorder attached) are
        # already in the ring — re-recording would duplicate the event
        # and could evict a real earlier one from the bounded ring
        if recorder is not None and not (
            id(v) in logged and recorder is witness.recorder
        ):
            recorder.record("locktrace.violation", **v)
    return report

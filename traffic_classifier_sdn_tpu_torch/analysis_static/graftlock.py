"""graftlock: whole-program concurrency analysis.

The ``lock-discipline`` rule is per-function: it proves shared state
is accessed *under a* lock. Nothing there proves locks are acquired in a
CONSISTENT ORDER across threads, that no unbounded blocking call runs
while a lock is held, or that every spawned worker thread has a
reachable retire path — the bug classes of a SIGTERM handler that takes
the flight recorder's ring lock, or a watchdog thread leaked per drift
cycle. This module makes the analyzer find them:

``lock-order``
    Builds an interprocedural call graph over the scanned tree plus a
    lock-acquisition summary per function, propagates held-lock sets
    through call edges into a global lock-order graph, and reports any
    cycle — two threads interleaving the two acquisition chains of an
    AB/BA cycle deadlock with both locks held forever. Also reports a
    re-acquisition of a non-reentrant ``threading.Lock`` already held
    on the same path (self-deadlock, the single-thread variant).

``blocking-under-lock``
    Flags unbounded blocking operations — zero-arg ``Thread.join()`` /
    ``queue.get()`` / ``Event.wait()`` / ``communicate()``, subprocess
    spawns, ``open()``/pipe reads, ``torch.cuda.synchronize`` and an
    event's or stream's ``.synchronize()`` — reachable
    (transitively, through the call graph) while any project lock is
    held. A wedged blocking call under a lock wedges every thread that
    ever takes that lock; the flight-recorder ring held across a slow
    dump would freeze the whole obs plane, which is why the recorder
    snapshots under the lock and writes outside it.

``thread-lifecycle``
    Every ``threading.Thread(...)`` constructed in the scanned tree
    must be daemonized or have a reachable ``join`` on its binding in
    the owning class's surface (a local bound from the attribute — the
    ``thread, self._thread = self._thread, None`` swap idiom — counts).
    A non-daemon worker with no retire path keeps the interpreter alive
    after the serve exits; a daemon-less worker started per drift cycle
    leaks one thread each cycle.

Bounded-blocking allowlist policy (docs/TORCH_STATIC_ANALYSIS.md):

- A ``wait``/``join``/``get``/``communicate`` call with a REAL timeout
  (a non-``None`` value, positional or keyword) is bounded — the
  watchdog's deadline-guarded ``self._lock.wait(left)`` waits are the
  model. The explicit unbounded spellings — ``join(None)``,
  ``wait(timeout=None)``, ``get(True)``, ``communicate(data)`` — do
  not pass as bounded.
- A zero-arg ``Condition.wait()`` on the lock being held is exempt
  *with respect to that lock*: waiting releases the condition it waits
  on. It still blocks every OTHER held lock, and is flagged for those.
- Everything else intentional carries a reasoned
  ``# graftlint: disable=blocking-under-lock -- <why bounded>``
  suppression (e.g. the serving-checkpoint rotation lock, whose whole
  point is serializing the sweep+save+prune file I/O pass).

Lock identity is lockdep-style: a lock is keyed by its owning class
attribute (``serving/degrade.py::DeviceWatchdog._lock``), module global
(``native/forest.py::_lock``), or lock-returning factory
(``io/serving_checkpoint.py::_rotation_lock()``) — one node per lock
*class*, not per instance, which is what lets the runtime witness
(``utils/locktrace.py``) map observed acquisitions back onto this graph
via construction sites. ``build_graph_report`` exports the graph (JSON
+ DOT) as ``docs/artifacts/torch_lock_order_graph.json`` so review can diff
concurrency structure across PRs.

Resolution is deliberately syntactic-plus-conventions: ``self.m()``,
module functions, package-relative imports, nested defs, attributes
typed by ``self.x = ClassName(...)`` assignments or parameter
annotations, and ``property`` accesses on typed attributes. Untyped
attributes fall back to the curated convention map ``_ATTR_TYPE_HINTS``
(``_recorder`` is always the FlightRecorder, etc.); the runtime witness
cross-check exists precisely to catch edges this static pass misses.
"""

from __future__ import annotations

import ast
import os
from collections.abc import Iterator, Sequence
from dataclasses import dataclass, field

from .framework import Finding, ModuleInfo, Rule

LOCK_ORDER = "lock-order"
BLOCKING_UNDER_LOCK = "blocking-under-lock"
THREAD_LIFECYCLE = "thread-lifecycle"

# attribute-name → class-name conventions for attrs whose constructor
# the scanner cannot see (objects built by the CLI and passed down).
# Resolved against the scanned tree by class NAME; a hint naming a
# class absent from the scan is simply inert.
_ATTR_TYPE_HINTS = {
    "_recorder": "FlightRecorder",
    "_metrics": "Metrics",
    "_health": "HealthState",
    "_tracer": "Tracer",
    "_watchdog": "DeviceWatchdog",
    "_retrainer": "BackgroundRetrainer",
    "_handoff": "Handoff",
    "_gate": "DriftGate",
}

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}


def _dotted(node: ast.AST) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _terminal(node: ast.AST) -> str | None:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _is_lock_name(name: str | None) -> bool:
    return name is not None and (name == "_lock" or name.endswith("_lock"))


# ---------------------------------------------------------------------------
# project index
# ---------------------------------------------------------------------------


@dataclass
class _ClassInfo:
    name: str
    mod: ModuleInfo
    node: ast.ClassDef
    methods: dict[str, ast.FunctionDef] = field(default_factory=dict)
    properties: set[str] = field(default_factory=set)
    # attr → {(module_path, class_name)} — from self.x = Cls(...) /
    # annotated-parameter assignment / the curated hint table
    attr_types: dict[str, set[tuple[str, str]]] = field(
        default_factory=dict
    )


class _Project:
    """Symbol tables over one scanned module set: functions, classes,
    import aliases, and attribute types — everything call resolution
    needs, built once before the per-function walks."""

    def __init__(self, modules: Sequence[ModuleInfo]):
        self.modules = [m for m in modules if m.tree is not None]
        self._real_to_mod = {
            os.path.realpath(m.path): m for m in self.modules
        }
        self.functions: dict[str, dict[str, ast.FunctionDef]] = {}
        self.classes: dict[str, dict[str, _ClassInfo]] = {}
        # module path → local name → ("module", path) | ("symbol", path,
        # name) | ("class", path, name)
        self.imports: dict[str, dict[str, tuple]] = {}
        # module path → global name → {(path, class_name)} for
        # module-level x = Cls(...) assignments (LazyLib handles)
        self.global_types: dict[str, dict[str, set[tuple[str, str]]]] = {}
        self.classes_by_name: dict[str, list[tuple[str, str]]] = {}
        for m in self.modules:
            self._index_defs(m)
        for m in self.modules:
            self._index_imports(m)
        for m in self.modules:
            self._index_types(m)

    # -- defs ---------------------------------------------------------------
    def _index_defs(self, m: ModuleInfo) -> None:
        fns: dict[str, ast.FunctionDef] = {}
        classes: dict[str, _ClassInfo] = {}
        assert m.tree is not None
        for node in m.tree.body:
            if isinstance(node, ast.FunctionDef):
                fns[node.name] = node
            elif isinstance(node, ast.ClassDef):
                ci = _ClassInfo(node.name, m, node)
                for item in node.body:
                    if not isinstance(item, ast.FunctionDef):
                        continue
                    ci.methods[item.name] = item
                    if any(
                        _terminal(d) == "property"
                        for d in item.decorator_list
                    ):
                        ci.properties.add(item.name)
                classes[node.name] = ci
                self.classes_by_name.setdefault(node.name, []).append(
                    (m.display_path, node.name)
                )
        self.functions[m.display_path] = fns
        self.classes[m.display_path] = classes

    # -- imports ------------------------------------------------------------
    def _find_module(self, base: str) -> ModuleInfo | None:
        for cand in (base + ".py", os.path.join(base, "__init__.py")):
            mod = self._real_to_mod.get(os.path.realpath(cand))
            if mod is not None:
                return mod
        return None

    def _find_by_suffix(self, parts: list[str]) -> ModuleInfo | None:
        """Absolute-import resolution: the scanned module whose real
        path ends with ``parts`` (as a module or a package)."""
        suffixes = (
            os.sep + os.path.join(*parts) + ".py",
            os.sep + os.path.join(*parts, "__init__.py"),
        )
        for real, mod in self._real_to_mod.items():
            if real.endswith(suffixes):
                return mod
        return None

    def _index_imports(self, m: ModuleInfo) -> None:
        table: dict[str, tuple] = {}
        base_dir = os.path.dirname(os.path.abspath(m.path))
        assert m.tree is not None
        for node in ast.walk(m.tree):
            if isinstance(node, ast.ImportFrom):
                if node.level:
                    d = base_dir
                    for _ in range(node.level - 1):
                        d = os.path.dirname(d)
                    root = (
                        os.path.join(d, *node.module.split("."))
                        if node.module else d
                    )
                    base_mod = self._find_module(root)
                else:
                    parts = (node.module or "").split(".")
                    root = None
                    base_mod = self._find_by_suffix(parts) if parts[0] else None
                for alias in node.names:
                    name = alias.asname or alias.name
                    sub = None
                    if node.level and root is not None:
                        sub = self._find_module(
                            os.path.join(root, alias.name)
                        )
                    elif not node.level and node.module:
                        sub = self._find_by_suffix(
                            (node.module + "." + alias.name).split(".")
                        )
                    if sub is not None:
                        table[name] = ("module", sub.display_path)
                    elif base_mod is not None:
                        target = base_mod.display_path
                        if alias.name in self.classes.get(target, {}):
                            table[name] = ("class", target, alias.name)
                        else:
                            table[name] = ("symbol", target, alias.name)
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    mod = self._find_by_suffix(alias.name.split("."))
                    if mod is not None:
                        name = alias.asname or alias.name
                        if "." not in name:
                            table[name] = ("module", mod.display_path)
        self.imports[m.display_path] = table

    # -- attribute / global typing ------------------------------------------
    def _resolve_class_ref(
        self, m: ModuleInfo, expr: ast.AST
    ) -> tuple[str, str] | None:
        """``Cls`` / ``mod.Cls`` / imported class name → (path, class)."""
        if isinstance(expr, ast.Name):
            if expr.id in self.classes.get(m.display_path, {}):
                return (m.display_path, expr.id)
            imp = self.imports.get(m.display_path, {}).get(expr.id)
            if imp is not None and imp[0] == "class":
                return (imp[1], imp[2])
        elif isinstance(expr, ast.Attribute) and isinstance(
            expr.value, ast.Name
        ):
            imp = self.imports.get(m.display_path, {}).get(expr.value.id)
            if imp is not None and imp[0] == "module":
                if expr.attr in self.classes.get(imp[1], {}):
                    return (imp[1], expr.attr)
        return None

    def _annotation_class(
        self, m: ModuleInfo, ann: ast.AST | None
    ) -> tuple[str, str] | None:
        if ann is None:
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            name = ann.value.strip().strip("\"'")
            if name in self.classes.get(m.display_path, {}):
                return (m.display_path, name)
            hits = self.classes_by_name.get(name)
            return hits[0] if hits else None
        if isinstance(ann, ast.BinOp):  # "Cls | None"
            return (self._annotation_class(m, ann.left)
                    or self._annotation_class(m, ann.right))
        ref = self._resolve_class_ref(m, ann)
        if ref is not None:
            return ref
        name = _terminal(ann)
        if name:
            hits = self.classes_by_name.get(name)
            if hits:
                return hits[0]
        return None

    def _index_types(self, m: ModuleInfo) -> None:
        assert m.tree is not None
        globals_: dict[str, set[tuple[str, str]]] = {}
        for node in m.tree.body:
            if isinstance(node, ast.Assign):
                refs = {
                    r for sub in ast.walk(node.value)
                    if isinstance(sub, ast.Call)
                    and (r := self._resolve_class_ref(m, sub.func))
                }
                if refs:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            globals_.setdefault(t.id, set()).update(refs)
        self.global_types[m.display_path] = globals_
        for ci in self.classes[m.display_path].values():
            for fn in ci.methods.values():
                params = {
                    a.arg: self._annotation_class(m, a.annotation)
                    for a in (fn.args.posonlyargs + fn.args.args
                              + fn.args.kwonlyargs)
                }
                for node in ast.walk(fn):
                    if not isinstance(node, ast.Assign):
                        continue
                    for t in node.targets:
                        if not (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            continue
                        refs = {
                            r for sub in ast.walk(node.value)
                            if isinstance(sub, ast.Call)
                            and (r := self._resolve_class_ref(m, sub.func))
                        }
                        for sub in ast.walk(node.value):
                            if isinstance(sub, ast.Name) and params.get(
                                sub.id
                            ):
                                refs.add(params[sub.id])
                        if refs:
                            ci.attr_types.setdefault(
                                t.attr, set()
                            ).update(refs)
            for attr, cls_name in _ATTR_TYPE_HINTS.items():
                if attr not in ci.attr_types:
                    hits = self.classes_by_name.get(cls_name)
                    if hits:
                        ci.attr_types[attr] = {hits[0]}

    def class_info(self, path: str, name: str) -> _ClassInfo | None:
        return self.classes.get(path, {}).get(name)


# ---------------------------------------------------------------------------
# per-function summaries
# ---------------------------------------------------------------------------


@dataclass
class _Blocking:
    kind: str
    line: int
    label: str
    receiver_lock: str | None  # condition-own-lock exemption


@dataclass
class _Summary:
    mod: ModuleInfo
    cls: str | None
    name: str
    node: ast.FunctionDef
    acquires: list[tuple[str, int]] = field(default_factory=list)
    # intra-function nested acquisitions: (a, a_line, b, b_line)
    edges: list[tuple[str, int, str, int]] = field(default_factory=list)
    # (callee summary key, call line, held [(lock, line)...])
    calls: list[tuple[int, int, tuple]] = field(default_factory=list)
    blocking: list[_Blocking] = field(default_factory=list)


class _Analysis:
    """The one interprocedural pass the three rules and the graph
    export all share (memoized per scanned module set)."""

    def __init__(self, modules: Sequence[ModuleInfo]):
        self.project = _Project(modules)
        self.summaries: dict[int, _Summary] = {}  # id(fn node) → summary
        self._fn_key: dict[int, int] = {}
        # lock id → {"kind", "constructed_at": [(path, line)]}
        self.lock_nodes: dict[str, dict] = {}
        self._closure_acq: dict[int, dict] = {}
        self._closure_blk: dict[int, dict] = {}
        self.edges: dict[tuple[str, str], dict] = {}
        self.self_edges: list[dict] = []
        self.blocking_hits: list[dict] = []  # filled by the scan walk
        self._scan_constructions()
        for m in self.project.modules:
            self._scan_module(m)
        self._compute_closures()
        self._propagate()

    # -- lock keys ----------------------------------------------------------
    def _lock_key(self, expr: ast.AST, m: ModuleInfo,
                  cls: str | None) -> str | None:
        if isinstance(expr, ast.Attribute) and _is_lock_name(expr.attr):
            base = expr.value
            if isinstance(base, ast.Name) and base.id == "self":
                owner = cls if cls is not None else "<module>"
                return f"{m.display_path}::{owner}.{expr.attr}"
            if (
                isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self"
                and cls is not None
            ):
                ci = self.project.class_info(m.display_path, cls)
                types = ci.attr_types.get(base.attr) if ci else None
                if types:
                    tpath, tcls = sorted(types)[0]
                    return f"{tpath}::{tcls}.{expr.attr}"
                return (f"{m.display_path}::{cls}"
                        f".{base.attr}.{expr.attr}")
            return None
        if isinstance(expr, ast.Name) and _is_lock_name(expr.id):
            return f"{m.display_path}::{expr.id}"
        if isinstance(expr, ast.Call):
            name = _terminal(expr.func)
            if _is_lock_name(name):
                # lock-returning factory: key by the factory, resolved
                # to its defining module when imported
                imp = self.project.imports.get(
                    m.display_path, {}
                ).get(name or "")
                if imp is not None and imp[0] == "symbol":
                    return f"{imp[1]}::{name}()"
                return f"{m.display_path}::{name}()"
        return None

    # -- construction sites (the witness mapping + kind table) --------------
    def _scan_constructions(self) -> None:
        for m in self.project.modules:
            assert m.tree is not None
            stack: list[tuple[ast.AST, str | None, str | None]] = [
                (m.tree, None, None)
            ]
            while stack:
                node, cls, fn = stack.pop()
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, ast.ClassDef):
                        stack.append((child, child.name, fn))
                    elif isinstance(child, ast.FunctionDef):
                        stack.append((child, cls, child.name))
                    else:
                        stack.append((child, cls, fn))
                if not isinstance(node, ast.Assign) or not isinstance(
                    node.value, ast.Call
                ):
                    continue
                ctor = _dotted(node.value.func)
                if ctor is None:
                    continue
                head, _, tail = ctor.rpartition(".")
                if tail not in _LOCK_CTORS or head not in (
                    "", "threading"
                ):
                    continue
                key = None
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                        and cls is not None
                        and _is_lock_name(t.attr)
                    ):
                        key = f"{m.display_path}::{cls}.{t.attr}"
                    elif isinstance(t, ast.Name) and _is_lock_name(t.id):
                        if fn is None and cls is None:
                            key = f"{m.display_path}::{t.id}"
                if key is None and fn is not None and _is_lock_name(fn):
                    # built inside a lock-returning factory (the
                    # per-directory rotation-lock registry shape)
                    key = f"{m.display_path}::{fn}()"
                if key is None:
                    continue
                entry = self.lock_nodes.setdefault(
                    key, {"kind": tail, "constructed_at": []}
                )
                entry["constructed_at"].append(
                    (m.display_path, node.lineno)
                )

    # -- the function walk --------------------------------------------------
    def _scan_module(self, m: ModuleInfo) -> None:
        assert m.tree is not None
        for node in m.tree.body:
            if isinstance(node, ast.FunctionDef):
                self._scan_function(m, None, node)
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, ast.FunctionDef):
                        self._scan_function(m, node.name, item)

    def _local_defs(self, fn: ast.FunctionDef) -> dict[str, ast.FunctionDef]:
        return {
            n.name: n for n in ast.walk(fn)
            if isinstance(n, ast.FunctionDef) and n is not fn
        }

    def _scan_function(self, m: ModuleInfo, cls: str | None,
                       fn: ast.FunctionDef) -> None:
        if id(fn) in self.summaries:
            return
        s = _Summary(m, cls, fn.name, fn)
        self.summaries[id(fn)] = s
        local_defs = self._local_defs(fn)
        for nested in local_defs.values():
            if id(nested) not in self.summaries:
                self._scan_function(m, cls, nested)

        def resolve(call: ast.Call) -> list[ast.FunctionDef]:
            func = call.func
            out: list[ast.FunctionDef] = []
            if isinstance(func, ast.Name):
                name = func.id
                if name in local_defs:
                    return [local_defs[name]]
                mod_fns = self.project.functions.get(m.display_path, {})
                if name in mod_fns:
                    return [mod_fns[name]]
                ref = self.project._resolve_class_ref(m, func)
                if ref is not None:
                    ci = self.project.class_info(*ref)
                    init = ci.methods.get("__init__") if ci else None
                    return [init] if init is not None else []
                imp = self.project.imports.get(
                    m.display_path, {}
                ).get(name)
                if imp is not None and imp[0] == "symbol":
                    target = self.project.functions.get(imp[1], {})
                    if imp[2] in target:
                        return [target[imp[2]]]
                return []
            if not isinstance(func, ast.Attribute):
                return []
            base, attr = func.value, func.attr
            if isinstance(base, ast.Name):
                if base.id == "self" and cls is not None:
                    ci = self.project.class_info(m.display_path, cls)
                    if ci and attr in ci.methods:
                        return [ci.methods[attr]]
                    return []
                imp = self.project.imports.get(
                    m.display_path, {}
                ).get(base.id)
                if imp is not None and imp[0] == "module":
                    target = self.project.functions.get(imp[1], {})
                    if attr in target:
                        return [target[attr]]
                    if attr in self.project.classes.get(imp[1], {}):
                        ci = self.project.class_info(imp[1], attr)
                        init = ci.methods.get("__init__") if ci else None
                        return [init] if init is not None else []
                for ref in sorted(self.project.global_types.get(
                    m.display_path, {}
                ).get(base.id, ())):
                    ci = self.project.class_info(*ref)
                    if ci and attr in ci.methods:
                        out.append(ci.methods[attr])
                return out
            if (
                isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self"
                and cls is not None
            ):
                ci = self.project.class_info(m.display_path, cls)
                types = ci.attr_types.get(base.attr, ()) if ci else ()
                for ref in sorted(types):
                    tci = self.project.class_info(*ref)
                    if tci and attr in tci.methods:
                        out.append(tci.methods[attr])
            return out

        def property_targets(node: ast.Attribute) -> list[ast.FunctionDef]:
            """``self.x`` / ``self.attr.x`` attribute LOADS that invoke
            a property on a known class — a lock acquired inside a
            property is as real as one inside a method call."""
            base = node.value
            if isinstance(base, ast.Name) and base.id == "self" and cls:
                ci = self.project.class_info(m.display_path, cls)
                if ci and node.attr in ci.properties:
                    return [ci.methods[node.attr]]
            if (
                isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id == "self"
                and cls is not None
            ):
                ci = self.project.class_info(m.display_path, cls)
                types = ci.attr_types.get(base.attr, ()) if ci else ()
                return [
                    tci.methods[node.attr]
                    for ref in sorted(types)
                    if (tci := self.project.class_info(*ref))
                    and node.attr in tci.properties
                ]
            return []

        def visit(node: ast.AST, held: tuple) -> None:
            if isinstance(node, ast.FunctionDef) and node is not fn:
                return  # nested defs get their own summaries
            if isinstance(node, (ast.With, ast.AsyncWith)):
                new_held = held
                for item in node.items:
                    # items enter left-to-right: item i's expression
                    # evaluates with items <i ALREADY held (`with
                    # self._lock, open(p):` runs the open under the
                    # lock)
                    visit(item.context_expr, new_held)
                    key = self._lock_key(item.context_expr, m, cls)
                    if key is not None:
                        line = item.context_expr.lineno
                        s.acquires.append((key, line))
                        for a, al in new_held:
                            s.edges.append((a, al, key, line))
                        new_held = new_held + ((key, line),)
                for child in node.body:
                    visit(child, new_held)
                return
            if isinstance(node, ast.Call):
                b = self._classify_blocking(node, m, cls)
                if b is not None:
                    s.blocking.append(b)
                    # direct (same-function) blocking under locks held
                    # RIGHT HERE — recorded in this one walk so the
                    # with-entry rule lives in exactly one place
                    for a, al in held:
                        if b.receiver_lock is not None and (
                            b.receiver_lock == a
                        ):
                            continue  # waiting releases that lock
                        self.blocking_hits.append({
                            "lock": a, "kind": b.kind,
                            "path": m.display_path, "line": b.line,
                            "chain": [
                                (m.display_path, al,
                                 f"acquires {_short(a)}"),
                                (m.display_path, b.line,
                                 f"blocks on {b.label}"),
                            ],
                        })
                # explicit .acquire() on a lock expression: summary +
                # edge only (no release tracking — the with form is the
                # package idiom; acquire() is the rare manual case)
                if (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "acquire"
                ):
                    key = self._lock_key(node.func.value, m, cls)
                    if key is not None:
                        s.acquires.append((key, node.lineno))
                        for a, al in held:
                            s.edges.append((a, al, key, node.lineno))
                callees = resolve(node)
                for c in callees:
                    if id(c) not in self.summaries:
                        # method of a class scanned in another module
                        owner = self._owner_of(c)
                        if owner is not None:
                            self._scan_function(owner[0], owner[1], c)
                    if id(c) in self.summaries:
                        s.calls.append((id(c), node.lineno, held))
            elif isinstance(node, ast.Attribute) and isinstance(
                node.ctx, ast.Load
            ):
                for c in property_targets(node):
                    if id(c) not in self.summaries:
                        owner = self._owner_of(c)
                        if owner is not None:
                            self._scan_function(owner[0], owner[1], c)
                    if id(c) in self.summaries:
                        s.calls.append((id(c), node.lineno, held))
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for child in fn.body:
            visit(child, ())

    def _owner_of(
        self, fn: ast.FunctionDef
    ) -> tuple[ModuleInfo, str | None] | None:
        for path, classes in self.project.classes.items():
            for ci in classes.values():
                if fn in ci.methods.values():
                    return ci.mod, ci.name
        for path, fns in self.project.functions.items():
            if fn in fns.values():
                for m in self.project.modules:
                    if m.display_path == path:
                        return m, None
        return None

    # -- blocking classification --------------------------------------------
    @staticmethod
    def _bounds(call: ast.Call, timeout_pos: int) -> bool:
        """True when the call supplies a REAL timeout: a non-None value
        at positional index ``timeout_pos`` or as ``timeout=``. The
        explicit unbounded spellings — ``join(None)``,
        ``wait(timeout=None)`` — must not pass as bounded."""

        def real(v: ast.AST) -> bool:
            return not (
                isinstance(v, ast.Constant) and v.value is None
            )

        if len(call.args) > timeout_pos:
            return real(call.args[timeout_pos])
        for k in call.keywords:
            if k.arg == "timeout":
                return real(k.value)
        return False

    def _classify_blocking(self, call: ast.Call, m: ModuleInfo,
                           cls: str | None) -> _Blocking | None:
        func = call.func
        kw = {k.arg for k in call.keywords}
        if isinstance(func, ast.Name):
            if func.id == "open":
                return _Blocking("file-io", call.lineno, "open()", None)
            return None
        if not isinstance(func, ast.Attribute):
            return None
        attr = func.attr
        dotted = _dotted(func) or ""
        if dotted.startswith(("os.path.", "posixpath.", "str.")):
            return None
        if dotted.startswith("subprocess.") and attr in (
            "run", "call", "check_call", "check_output", "Popen"
        ):
            return _Blocking(
                "subprocess", call.lineno, f"{dotted}()", None
            )
        recv_lock = self._lock_key(func.value, m, cls)
        if attr == "wait":
            if not self._bounds(call, 0):
                return _Blocking(
                    "wait", call.lineno, f"{dotted or attr}()",
                    recv_lock,
                )
        elif attr == "wait_for":
            if not self._bounds(call, 1):
                return _Blocking(
                    "wait", call.lineno, f"{dotted or attr}()",
                    recv_lock,
                )
        elif attr == "join":
            # a Thread/Process/handoff join with no real timeout —
            # join() and the explicit join(None)/join(timeout=None)
            # spellings alike (str.join's iterable is a non-None arg,
            # so it reads as bounded and never lands here)
            if not self._bounds(call, 0):
                return _Blocking(
                    "join", call.lineno, f"{dotted or attr}()", None
                )
        elif attr == "get":
            # queue.get signature is (block=True, timeout=None); a
            # positional first arg that is the literal True is the
            # explicit blocking spelling. Other positional firsts are
            # ambiguous with dict.get(key) and stay exempt.
            block_true = bool(call.args) and isinstance(
                call.args[0], ast.Constant
            ) and call.args[0].value is True
            plain = (not call.args and "block" not in kw
                     and not self._bounds(call, 1))
            if plain or (block_true and not self._bounds(call, 1)):
                return _Blocking(
                    "queue-get", call.lineno, f"{dotted or attr}()",
                    None,
                )
        elif attr == "communicate":
            # communicate(input=..., timeout=...): only a real timeout
            # bounds it — the input payload does not
            if not self._bounds(call, 1):
                return _Blocking(
                    "subprocess", call.lineno,
                    f"{dotted or attr}()", None,
                )
        elif attr in ("synchronize", "block_until_ready"):
            # torch.cuda.synchronize / Event / Stream .synchronize(): an
            # unbounded wait for the card
            return _Blocking(
                "device-sync", call.lineno,
                f"{dotted or attr}()", None,
            )
        elif attr in ("read", "read1", "readline", "readlines",
                      "recv", "accept", "sendall"):
            # receiver heuristics keep dict/str methods out; these
            # names on pipes/sockets block on the peer
            if dotted.startswith(("self._queue.", "np.", "json.")):
                return None
            return _Blocking(
                "io", call.lineno, f"{dotted or attr}()", None
            )
        return None

    # -- propagation --------------------------------------------------------
    def _compute_closures(self) -> None:
        """Transitive (acquired, blocking) per function, by monotone
        fixed-point over the call graph — sets only ever grow and keys
        are bounded by the lock/blocking-site population, so this is
        linear-ish and safe on call cycles AND on diamond-shaped call
        graphs (a memo-at-top-only recursion re-walks every diamond:
        exponential in depth — measured 37 s at depth 20).

        ``_closure_acq[key]``: lock id → representative chain (list of
        (path, line, what)); ``_closure_blk[key]``: (kind, path, line)
        → (chain, receiver_lock). The first chain found wins — findings
        need one concrete path, not all of them."""
        for key, s in self.summaries.items():
            acq: dict[str, list] = {}
            for lock, line in s.acquires:
                acq.setdefault(
                    lock, [(s.mod.display_path, line,
                            f"acquires {_short(lock)}")]
                )
            blk: dict[tuple, tuple] = {}
            for b in s.blocking:
                blk.setdefault(
                    (b.kind, s.mod.display_path, b.line),
                    ([(s.mod.display_path, b.line,
                       f"blocks on {b.label}")],
                     b.receiver_lock),
                )
            self._closure_acq[key] = acq
            self._closure_blk[key] = blk
        changed = True
        while changed:
            changed = False
            for key, s in self.summaries.items():
                acq = self._closure_acq[key]
                blk = self._closure_blk[key]
                for callee, line, _held in s.calls:
                    c = self.summaries.get(callee)
                    if c is None:
                        continue
                    hop = (s.mod.display_path, line,
                           f"calls {c.cls + '.' if c.cls else ''}"
                           f"{c.name}")
                    for lock, chain in self._closure_acq[callee].items():
                        if lock not in acq:
                            acq[lock] = [hop, *chain]
                            changed = True
                    for bkey, (chain, recv) in (
                        self._closure_blk[callee].items()
                    ):
                        if bkey not in blk:
                            blk[bkey] = ([hop, *chain], recv)
                            changed = True

    def _closure(self, key: int) -> tuple[dict, dict]:
        return self._closure_acq[key], self._closure_blk[key]

    def _propagate(self) -> None:
        for key, s in self.summaries.items():
            for a, al, b, bl in s.edges:
                self._add_edge(
                    a, b,
                    [(s.mod.display_path, al, f"acquires {_short(a)}"),
                     (s.mod.display_path, bl, f"acquires {_short(b)}")],
                )
            for callee, line, held in s.calls:
                if callee not in self.summaries:
                    continue
                acq, blk = self._closure(callee)
                c = self.summaries[callee]
                hop = (s.mod.display_path, line,
                       f"calls {c.cls + '.' if c.cls else ''}{c.name}")
                for a, al in held:
                    pre = [(s.mod.display_path, al,
                            f"acquires {_short(a)}"), hop]
                    for b, chain in acq.items():
                        self._add_edge(a, b, pre + chain)
                    for (kind, bpath, bline), (chain, recv) in (
                        blk.items()
                    ):
                        if recv is not None and recv == a:
                            continue  # waiting releases the held lock
                        self.blocking_hits.append({
                            "lock": a, "kind": kind,
                            "path": s.mod.display_path, "line": line,
                            "chain": pre + chain,
                        })

    def _add_edge(self, a: str, b: str, chain: list) -> None:
        if a == b:
            kind = self.lock_nodes.get(a, {}).get("kind")
            if kind == "Lock":
                self.self_edges.append({"lock": a, "chain": chain})
            return
        self.edges.setdefault((a, b), {"chain": chain})

    # -- cycles -------------------------------------------------------------
    def cycles(self) -> list[list[tuple[str, str]]]:
        """Distinct lock-order cycles as edge lists, shortest first.
        One cycle is reported per distinct node set."""
        adj: dict[str, set[str]] = {}
        for a, b in self.edges:
            adj.setdefault(a, set()).add(b)
        out: list[list[tuple[str, str]]] = []
        seen_sets: set[frozenset] = set()
        for a, b in sorted(self.edges):
            # shortest path b → a closes the cycle through (a, b)
            path = self._shortest_path(adj, b, a)
            if path is None:
                continue
            nodes = frozenset([a, *path])
            if nodes in seen_sets:
                continue
            seen_sets.add(nodes)
            # path is b→…→a inclusive; prepend the closing edge a→b
            cyc = [(a, b)]
            for i in range(len(path) - 1):
                cyc.append((path[i], path[i + 1]))
            out.append(cyc)
        out.sort(key=len)
        return out

    @staticmethod
    def _shortest_path(adj: dict, src: str, dst: str) -> list[str] | None:
        if src == dst:
            return [src]
        prev: dict[str, str] = {}
        frontier = [src]
        visited = {src}
        while frontier:
            nxt = []
            for n in frontier:
                for m2 in sorted(adj.get(n, ())):
                    if m2 in visited:
                        continue
                    visited.add(m2)
                    prev[m2] = n
                    if m2 == dst:
                        path = [dst]
                        while path[-1] != src:
                            path.append(prev[path[-1]])
                        return list(reversed(path))
                    nxt.append(m2)
            frontier = nxt
        return None


def _short(lock_id: str) -> str:
    return lock_id.split("::", 1)[-1]


def _chain_text(chain: list) -> str:
    return " -> ".join(f"{p}:{ln} ({what})" for p, ln, what in chain)


_ANALYSIS_CACHE: list[tuple[tuple[int, ...], _Analysis]] = []


def analyze(modules: Sequence[ModuleInfo]) -> _Analysis:
    key = tuple(id(m) for m in modules)
    for k, a in _ANALYSIS_CACHE:
        if k == key:
            return a
    a = _Analysis(modules)
    _ANALYSIS_CACHE.append((key, a))
    del _ANALYSIS_CACHE[:-4]
    return a


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


class LockOrderRule(Rule):
    id = LOCK_ORDER
    description = (
        "locks must be acquired in one global order: any cycle in the "
        "interprocedural lock-order graph is a deadlock two threads "
        "can reach (AB/BA); re-acquiring a held non-reentrant Lock on "
        "the same path is the single-thread variant"
    )

    def check_project(
        self, modules: Sequence[ModuleInfo]
    ) -> Iterator[Finding]:
        a = analyze(modules)
        for cyc in a.cycles():
            chains = []
            for e in cyc:
                chain = a.edges[e]["chain"]
                chains.append(
                    f"{_short(e[0])} -> {_short(e[1])} via "
                    f"{_chain_text(chain)}"
                )
            first = a.edges[cyc[0]]["chain"][0]
            yield self.finding(
                _mod_proxy(modules, first[0]), first[1],
                "lock-order cycle between "
                + " and ".join(_short(x) for x in
                               dict.fromkeys(n for e in cyc for n in e))
                + ": " + "; ".join(chains)
                + " — two threads interleaving these chains deadlock "
                  "with both locks held",
            )
        for se in a.self_edges:
            site = se["chain"][0]
            yield self.finding(
                _mod_proxy(modules, site[0]), site[1],
                f"non-reentrant Lock {_short(se['lock'])} re-acquired "
                f"while already held on the same path: "
                f"{_chain_text(se['chain'])} — this deadlocks the "
                "acquiring thread against itself",
            )


class BlockingUnderLockRule(Rule):
    id = BLOCKING_UNDER_LOCK
    description = (
        "no unbounded blocking call (zero-arg join/get/wait/"
        "communicate, subprocess spawn, file/pipe I/O, "
        ".synchronize()) may be reachable while a project lock is "
        "held; timeouts bound it, a Condition.wait releases only its "
        "own lock"
    )

    def check_project(
        self, modules: Sequence[ModuleInfo]
    ) -> Iterator[Finding]:
        a = analyze(modules)
        seen: set[tuple] = set()
        for hit in a.blocking_hits:
            key = (hit["path"], hit["line"], hit["lock"], hit["kind"])
            if key in seen:
                continue
            seen.add(key)
            yield self.finding(
                _mod_proxy(modules, hit["path"]), hit["line"],
                f"unbounded {hit['kind']} blocking while holding "
                f"{_short(hit['lock'])}: {_chain_text(hit['chain'])} — "
                "every thread that takes this lock wedges behind the "
                "slow/blocked call; bound it with a timeout or move it "
                "outside the lock",
            )


class ThreadLifecycleRule(Rule):
    id = THREAD_LIFECYCLE
    description = (
        "every threading.Thread must be daemonized or have a reachable "
        "join/retire path on its binding (a non-daemon worker with no "
        "join keeps the process alive; an unretired per-cycle worker "
        "is a thread leak)"
    )

    def check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        if mod.tree is None:
            return
        # class-level pass: Thread(...) assigned to self.<attr> needs a
        # join on that attr (or an alias local) somewhere in the class
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_scope(mod, node, is_class=True)
        yield from self._check_scope(mod, mod.tree, is_class=False)

    def _thread_calls(self, scope: ast.AST) -> list[ast.Call]:
        out = []
        for node in ast.walk(scope):
            if isinstance(node, ast.ClassDef) and node is not scope:
                continue
            if isinstance(node, ast.Call) and _terminal(
                node.func
            ) == "Thread":
                dotted = _dotted(node.func) or "Thread"
                if dotted in ("Thread", "threading.Thread"):
                    out.append(node)
        return out

    def _check_scope(self, mod: ModuleInfo, scope: ast.AST,
                     is_class: bool) -> Iterator[Finding]:
        threads = self._thread_calls(scope)
        if not threads:
            return
        in_classes = set()
        if not is_class:
            for node in ast.walk(scope):
                if isinstance(node, ast.ClassDef):
                    in_classes.update(
                        id(c) for c in self._thread_calls(node)
                    )
        src = mod.source
        for call in threads:
            if not is_class and id(call) in in_classes:
                continue  # owned by the class-level pass
            if any(
                k.arg == "daemon"
                and isinstance(k.value, ast.Constant)
                and k.value.value is True
                for k in call.keywords
            ):
                continue
            binding = self._binding_of(scope, call)
            if binding is not None and self._has_retire(
                scope, src, binding
            ):
                continue
            what = binding if binding is not None else "<unbound>"
            yield self.finding(
                mod, call.lineno,
                f"Thread bound to {what} is neither daemonized "
                "(daemon=True) nor joined anywhere in its owning "
                f"{'class' if is_class else 'scope'} — a non-daemon "
                "worker with no retire path outlives the serve (or "
                "leaks one thread per cycle); daemonize it or join it "
                "from the shutdown surface",
            )

    def _binding_of(self, scope: ast.AST, call: ast.Call) -> str | None:
        for node in ast.walk(scope):
            if not isinstance(node, ast.Assign) or node.value is not call:
                continue
            for t in node.targets:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    return f"self.{t.attr}"
                if isinstance(t, ast.Name):
                    return t.id
        return None

    def _has_retire(self, scope: ast.AST, src: str,
                    binding: str) -> bool:
        attr = binding.removeprefix("self.")
        aliases = {binding}
        # locals assigned FROM the binding (incl. the tuple-swap
        # `thread, self._t = self._t, None` idiom) join on its behalf
        for node in ast.walk(scope):
            if not isinstance(node, ast.Assign):
                continue
            targets, values = node.targets, [node.value]
            if (
                len(node.targets) == 1
                and isinstance(node.targets[0], ast.Tuple)
                and isinstance(node.value, ast.Tuple)
            ):
                targets = node.targets[0].elts
                values = node.value.elts
            for t, v in zip(targets, values):
                if isinstance(t, ast.Name) and (
                    _dotted(v) == binding
                    or (binding.startswith("self.")
                        and _dotted(v) == f"self.{attr}")
                ):
                    aliases.add(t.id)
        for node in ast.walk(scope):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "join"
                and _dotted(node.func.value) in aliases
            ):
                return True
            # daemonized after construction: t.daemon = True
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and t.attr == "daemon"
                        and _dotted(t.value) in aliases
                        and isinstance(node.value, ast.Constant)
                        and node.value.value is True
                    ):
                        return True
        return False


class _ModProxy:
    """Finding factory shim: project-level rules anchor findings on
    modules OTHER than a single ``mod`` argument — this adapts a
    display path to the ``Rule.finding`` signature."""

    def __init__(self, display_path: str):
        self.display_path = display_path


def _mod_proxy(modules: Sequence[ModuleInfo], path: str):
    for m in modules:
        if m.display_path == path:
            return m
    return _ModProxy(path)


GRAFTLOCK_RULES = (
    LockOrderRule,
    BlockingUnderLockRule,
    ThreadLifecycleRule,
)


# ---------------------------------------------------------------------------
# graph export (the artifact + the runtime-witness cross-check input)
# ---------------------------------------------------------------------------


GRAPH_SCHEMA_VERSION = 1


def build_graph_report(modules: Sequence[ModuleInfo]) -> dict:
    """The static lock-order graph as a JSON-ready dict (with an
    embedded DOT rendering): nodes keyed by lock class with their
    construction sites, edges with full acquisition chains, and any
    cycles. ``docs/artifacts/torch_lock_order_graph.json`` is this, generated
    from the repo root, so future PRs diff concurrency structure in
    review and ``utils/locktrace.py`` cross-checks observed runtime
    edges against it."""
    a = analyze(modules)
    node_ids = sorted(
        set(a.lock_nodes)
        | {n for e in a.edges for n in e}
        | {h["lock"] for h in a.blocking_hits}
    )
    nodes = []
    for nid in node_ids:
        meta = a.lock_nodes.get(nid, {})
        nodes.append({
            "id": nid,
            "kind": meta.get("kind"),
            "constructed_at": sorted(
                f"{p}:{ln}" for p, ln in meta.get("constructed_at", ())
            ),
        })
    edges = [
        {
            "from": aid, "to": bid,
            "chain": [f"{p}:{ln} ({what})"
                      for p, ln, what in a.edges[(aid, bid)]["chain"]],
        }
        for aid, bid in sorted(a.edges)
    ]
    cycles = [
        [list(e) for e in cyc] for cyc in a.cycles()
    ]
    dot_lines = ["digraph lock_order {"]
    for n in nodes:
        dot_lines.append(f'  "{n["id"]}";')
    for e in edges:
        dot_lines.append(f'  "{e["from"]}" -> "{e["to"]}";')
    dot_lines.append("}")
    return {
        "schema_version": GRAPH_SCHEMA_VERSION,
        "nodes": nodes,
        "edges": edges,
        "cycles": cycles,
        "dot": "\n".join(dot_lines),
    }

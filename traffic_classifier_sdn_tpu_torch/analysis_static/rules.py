"""The project rules. Each encodes an invariant one of the
port's layers relies on but Python cannot enforce at runtime:

====================  =====================================================
``jit-purity``        host effects inside code torch traces or captures
                      (``torch.compile``, ``torch.jit.script``/``trace``,
                      ``torch.cuda.graph`` capture) run once at trace or
                      capture time, not per call — timestamps freeze, RNG
                      draws repeat, ``.item()``/``.cpu()``/``float()``
                      syncs break the capture or graph-break the compile
``retrace-hazard``    Python scalars / shape-varying literals at compiled
                      call sites recompile per distinct value/structure
                      (``torch.compile`` specializes on them); dtype-less
                      array literals take a default-dependent dtype
``ctypes-abi``        a CDLL symbol called without ``argtypes``/``restype``
                      defaults every argument to int and truncates 64-bit
                      pointers/returns silently on LP64 — wrong-but-
                      plausible results, not crashes (declared one by one
                      or through a module-level ``_SIGNATURES`` table)
``lock-discipline``   attributes written from a ``threading.Thread`` target
                      and touched elsewhere race unless every access holds
                      the owning ``*_lock``
``fault-site-registry``  every injection seam must use a site registered in
                      ``utils.faults.SITES`` and every registered site must
                      have a test, or the chaos coverage silently stops
                      covering a durability seam
``atomic-io``         ad-hoc ``open(.., "w")`` + ``os.replace`` re-implements
                      (usually wrongly: no fsync, wrong temp dir) what
                      ``utils.atomicio.atomic_write_bytes`` already proves
                      under fault injection
``lock-order``        a cycle in the global lock-order graph is a deadlock
                      two threads can reach (AB/BA); whole-program, see
                      ``graftlock.py``
``blocking-under-lock``  an unbounded blocking call reachable while a lock
                      is held wedges every thread that ever takes that lock
``thread-lifecycle``  a non-daemon thread with no reachable join outlives
                      the serve; an unretired per-cycle worker is a leak
``implicit-sync``     a device→host sync (np.asarray/.item()/.cpu()/
                      int()/truthiness/iteration/a data-dependent shape on
                      a device tensor) on a serve hot path blocks the
                      tick; whole-program, see ``graftsync.py``
``transfer-discipline``  a per-tick host→device upload re-pays the
                      transfer every tick unless warmup-primed or
                      epoch-cached
``donation-hazard``   a tensor made outside a ``torch.cuda.stream(s)``
                      block and used inside it, with no ``record_stream``
                      or stream fence, may have its memory handed to a
                      later tick by the caching allocator
``sync-under-lock``   a device sync while holding a project lock wedges
                      every thread that takes that lock
====================  =====================================================

Rules are deliberately module-local and syntactic (no type inference, no
import following) so a finding is always explainable by pointing at the
flagged line; the suppression-with-reason escape hatch covers the
residue. docs/TORCH_STATIC_ANALYSIS.md documents each rule's failure mode.
"""

from __future__ import annotations

import ast
import os
import re
from collections.abc import Iterator, Sequence

from .framework import Finding, ModuleInfo, Rule, _iter_py_files

# the callables torch traces or captures: what their bodies do on the
# host runs once, at trace/compile/capture time
_TRACE_MARKERS = {
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "jit.script", "jit.trace", "torch.cuda.make_graphed_callables",
    "make_graphed_callables",
}
# ``with torch.cuda.graph(g):`` — the body is recorded once and replayed
_CAPTURE_CONTEXTS = ("torch.cuda.graph", "cuda.graph")


def _walk_excluding_defs(root: ast.AST) -> Iterator[ast.AST]:
    """ast.walk that does not descend into nested def/class bodies —
    the per-scope traversal both atomic-io and fault-site-registry
    need so one scope's state never leaks into another's."""
    stack: list[ast.AST] = [root]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if not isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef,
                        ast.ClassDef)
            ):
                stack.append(child)


def _dotted(node: ast.AST) -> str | None:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _terminal(node: ast.AST) -> str | None:
    """Last attribute segment: 'c' for a.b.c, 'x' for x."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _contains_jit_marker(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, (ast.Name, ast.Attribute)) and (
            _dotted(sub) in _TRACE_MARKERS
        ):
            return True
    return False


def _is_capture_with(node: ast.AST) -> bool:
    return isinstance(node, (ast.With, ast.AsyncWith)) and any(
        isinstance(item.context_expr, ast.Call)
        and _dotted(item.context_expr.func) in _CAPTURE_CONTEXTS
        for item in node.items
    )


def _is_literal_payload(node: ast.AST) -> bool:
    """A Python literal an array could be built from: number/bool, or a
    (possibly nested) list/tuple of them — the 'array literal' case that
    has no inherent dtype."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float, complex, bool))
    if isinstance(node, ast.UnaryOp) and isinstance(
        node.op, (ast.USub, ast.UAdd)
    ):
        return _is_literal_payload(node.operand)
    if isinstance(node, (ast.List, ast.Tuple)):
        return all(_is_literal_payload(e) for e in node.elts)
    return False


# ---------------------------------------------------------------------------
# jit-purity
# ---------------------------------------------------------------------------


class JitPurityRule(Rule):
    id = "jit-purity"
    description = (
        "no host-side effects (time.time, np.random, print, .item()/"
        ".tolist()/.cpu()/.numpy()/float()/int() syncs) inside code torch "
        "traces or captures (torch.compile, torch.jit.script/trace, "
        "torch.cuda.graph capture)"
    )

    _TIME_CALLS = {"time", "monotonic", "perf_counter", "time_ns",
                   "monotonic_ns", "perf_counter_ns"}
    _NP_SYNC = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
    _SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}

    def _jit_roots(self, mod: ModuleInfo) -> list[ast.AST]:
        """Bodies torch traces or captures: decorated defs, defs whose
        name is wrapped by a tracing call, lambdas passed to one
        directly, and ``with torch.cuda.graph(...)`` capture blocks."""
        roots: list[ast.AST] = []
        wrapped_names: set[str] = set()
        assert mod.tree is not None
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if any(_contains_jit_marker(d) for d in node.decorator_list):
                    roots.append(node)
            elif _is_capture_with(node):
                roots.append(node)
            elif isinstance(node, ast.Call) and _dotted(
                node.func
            ) in _TRACE_MARKERS:
                for arg in node.args[:1]:
                    if isinstance(arg, ast.Lambda):
                        roots.append(arg)
                    elif isinstance(arg, ast.Name):
                        wrapped_names.add(arg.id)
        if wrapped_names:
            for node in ast.walk(mod.tree):
                if (
                    isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.name in wrapped_names
                    and node not in roots
                ):
                    roots.append(node)
        return roots

    def check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        if mod.tree is None:
            return
        seen: set[tuple[int, str]] = set()
        for root in self._jit_roots(mod):
            for node in ast.walk(root):
                if not isinstance(node, ast.Call):
                    continue
                msg = self._classify(node)
                if msg is None:
                    continue
                key = (node.lineno, msg)
                if key in seen:
                    continue
                seen.add(key)
                yield self.finding(mod, node.lineno, msg)

    def _classify(self, call: ast.Call) -> str | None:
        func = call.func
        dotted = _dotted(func)
        if dotted is not None:
            head, _, tail = dotted.partition(".")
            if head == "time" and tail in self._TIME_CALLS:
                return (f"'{dotted}()' inside a traced/captured function "
                        "is evaluated once at trace time, not per call")
            if head in ("np", "numpy") and tail.startswith("random."):
                return (f"'{dotted}' inside a traced/captured function "
                        "draws at trace time; use a torch.Generator "
                        "passed in")
            if dotted in self._NP_SYNC:
                return (f"'{dotted}()' on a traced tensor forces a "
                        "device→host sync (a graph break, or an error "
                        "under capture); use torch equivalents")
        if isinstance(func, ast.Attribute) and (
            func.attr in self._SYNC_METHODS
        ):
            return (f".{func.attr}() forces a blocking device→host sync "
                    "inside a traced/captured function")
        if isinstance(func, ast.Name):
            if func.id == "print":
                return ("print() inside a traced/captured function runs "
                        "at trace time only (or graph-breaks the "
                        "compile)")
            if func.id in ("float", "int") and call.args and not (
                isinstance(call.args[0], ast.Constant)
            ):
                return (f"{func.id}() on a traced tensor forces a "
                        "device→host sync inside a traced/captured "
                        "function")
        return None


# ---------------------------------------------------------------------------
# retrace-hazard
# ---------------------------------------------------------------------------

_ARRAY_MODS = ("np", "numpy", "torch")
# positional index at which dtype may appear for each numpy constructor
# (torch's constructors take dtype by keyword only)
_CTOR_DTYPE_POS = {"zeros": 1, "ones": 1, "empty": 1, "full": 2}
_CONVERTERS = {"array", "asarray", "tensor", "as_tensor"}


class RetraceHazardRule(Rule):
    id = "retrace-hazard"
    description = (
        "array literals need an explicit dtype; torch.compile'd call "
        "sites must not take bare Python scalars or shape-varying "
        "literals"
    )

    def check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        if mod.tree is None:
            return
        yield from self._implicit_dtype(mod)
        yield from self._jitted_call_sites(mod)

    def _implicit_dtype(self, mod: ModuleInfo) -> Iterator[Finding]:
        assert mod.tree is not None
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            if dotted is None:
                continue
            head, _, fn = dotted.rpartition(".")
            if head not in _ARRAY_MODS:
                continue
            has_dtype_kw = any(
                k.arg == "dtype" for k in node.keywords
            )
            positional_dtype = head != "torch"
            if fn in _CTOR_DTYPE_POS and head != "torch":
                if has_dtype_kw or len(node.args) > _CTOR_DTYPE_POS[fn]:
                    continue
                yield self.finding(
                    mod, node.lineno,
                    f"'{dotted}()' without an explicit dtype: the "
                    "default is platform dependent — state the dtype",
                )
            elif fn in _CONVERTERS and node.args and _is_literal_payload(
                node.args[0]
            ):
                if has_dtype_kw or (positional_dtype and len(node.args) > 1):
                    continue
                yield self.finding(
                    mod, node.lineno,
                    f"'{dotted}()' on a Python literal without a dtype: "
                    "literals carry no dtype, so the result follows the "
                    "process default (and a compiled caller guards on "
                    "it) — state the dtype",
                )

    def _jitted_names(self, mod: ModuleInfo) -> set[str]:
        """Module-local names bound to compiled callables WITHOUT
        ``dynamic=True`` (a dynamic compile legitimately takes Python
        scalars as symbolic inputs)."""
        assert mod.tree is not None

        def dynamic(call_root: ast.AST) -> bool:
            return any(
                k.arg == "dynamic"
                and isinstance(k.value, ast.Constant)
                and k.value.value is True
                for call_node in ast.walk(call_root)
                if isinstance(call_node, ast.Call)
                for k in call_node.keywords
            )

        names: set[str] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ):
                call = node.value
                if _dotted(call.func) in _TRACE_MARKERS and not dynamic(
                    call
                ):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            names.add(t.id)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for d in node.decorator_list:
                    if not _contains_jit_marker(d):
                        continue
                    if not dynamic(d):
                        names.add(node.name)
        return names

    def _jitted_call_sites(self, mod: ModuleInfo) -> Iterator[Finding]:
        assert mod.tree is not None
        jitted = self._jitted_names(mod)
        if not jitted:
            return
        for node in ast.walk(mod.tree):
            if not (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id in jitted
            ):
                continue
            for arg in list(node.args) + [k.value for k in node.keywords]:
                if isinstance(arg, (ast.List, ast.Tuple, ast.Dict)):
                    yield self.finding(
                        mod, node.lineno,
                        f"container literal passed to compiled "
                        f"'{node.func.id}': each distinct structure "
                        "recompiles — pass a tensor with a stable shape",
                    )
                elif isinstance(arg, ast.Constant) and isinstance(
                    arg.value, (int, float)
                ) and not isinstance(arg.value, bool):
                    yield self.finding(
                        mod, node.lineno,
                        f"bare Python scalar passed to compiled "
                        f"'{node.func.id}': torch.compile specializes on "
                        "it and recompiles per distinct value — pass a "
                        "tensor or compile with dynamic=True",
                    )


# ---------------------------------------------------------------------------
# ctypes-abi
# ---------------------------------------------------------------------------


# ---- cross-language ABI comparison (ctypes ↔ extern "C") -----------------
#
# Width/kind categories. ctypes argument passing is by value, so what
# matters is pointer-vs-integer-vs-float and the width; const-ness and
# signedness drift are calling-convention-safe and deliberately NOT
# flagged (flagging them would teach people to suppress the rule).

_C_TYPE_CATEGORY = {
    "void": "void",
    "bool": "i8", "char": "i8", "int8_t": "i8", "uint8_t": "i8",
    "int16_t": "i16", "uint16_t": "i16", "short": "i16",
    "int": "i32", "unsigned": "i32", "int32_t": "i32",
    "uint32_t": "i32",
    "int64_t": "i64", "uint64_t": "i64", "size_t": "i64",
    "ssize_t": "i64", "intptr_t": "i64", "uintptr_t": "i64",
    "float": "f32",
    "double": "f64",
}

_PY_CTYPE_CATEGORY = {
    "c_void_p": "ptr", "c_char_p": "ptr", "c_wchar_p": "ptr",
    "c_bool": "i8", "c_int8": "i8", "c_uint8": "i8", "c_byte": "i8",
    "c_ubyte": "i8", "c_char": "i8",
    "c_int16": "i16", "c_uint16": "i16", "c_short": "i16",
    "c_ushort": "i16",
    "c_int": "i32", "c_uint": "i32", "c_int32": "i32",
    "c_uint32": "i32",
    "c_int64": "i64", "c_uint64": "i64", "c_size_t": "i64",
    "c_ssize_t": "i64", "c_longlong": "i64", "c_ulonglong": "i64",
    "c_float": "f32", "c_double": "f64",
    # c_long is LP64/LLP64-dependent: never compared
}

_CFN_RE = re.compile(
    r"(?m)^\s*((?:const\s+)?[A-Za-z_]\w*(?:\s*\*)*)"  # return type
    r"\s+([A-Za-z_]\w*)\s*\(([^)]*)\)\s*\{"           # name(params) {
)


def _c_category(decl: str) -> str | None:
    d = decl.strip()
    if not d or d == "...":
        return None
    if "*" in d:
        return "ptr"
    toks = [t for t in d.replace("const", " ").split() if t]
    if not toks:
        return None
    # drop the parameter name when present ("uint32_t capacity")
    ty = toks[0] if len(toks) == 1 else " ".join(toks[:-1])
    return _C_TYPE_CATEGORY.get(ty)


def _parse_extern_c(text: str) -> dict[str, tuple]:
    """symbol → (return category, (arg categories...)) for every
    function defined inside an ``extern "C" { ... }`` region. An
    unknown type maps to None in its position (skipped in comparison);
    a symbol defined twice with different shapes is dropped."""
    out: dict[str, tuple] = {}
    dropped: set[str] = set()
    pos = 0
    while True:
        m = re.search(r'extern\s+"C"\s*\{', text[pos:])
        if m is None:
            break
        start = pos + m.end()
        depth = 1
        i = start
        while i < len(text) and depth:
            if text[i] == "{":
                depth += 1
            elif text[i] == "}":
                depth -= 1
            i += 1
        region = text[start:i]
        pos = i
        for fm in _CFN_RE.finditer(region):
            ret, name, params = fm.groups()
            ret_cat = "ptr" if "*" in ret else _C_TYPE_CATEGORY.get(
                ret.replace("const", " ").strip()
            )
            p = params.strip()
            if p in ("", "void"):
                args: tuple = ()
            else:
                args = tuple(_c_category(a) for a in p.split(","))
            sig = (ret_cat, args)
            if name in out and out[name] != sig:
                dropped.add(name)
            out[name] = sig
    for name in dropped:
        out.pop(name, None)
    return out


_EXTERN_C_CACHE: dict[str, dict[str, tuple]] = {}


def _native_symbols(py_path: str) -> dict[str, tuple]:
    """The union extern-"C" symbol table of every sibling ``*.cpp``
    of ``py_path`` (symbols are uniquely prefixed per lib, so the
    union is unambiguous)."""
    d = os.path.dirname(os.path.realpath(py_path))
    cached = _EXTERN_C_CACHE.get(d)
    if cached is not None:
        return cached
    table: dict[str, tuple] = {}
    try:
        names = sorted(os.listdir(d))
    except OSError:
        names = []
    for n in names:
        if not n.endswith(".cpp"):
            continue
        try:
            with open(os.path.join(d, n), encoding="utf-8") as f:
                table.update(_parse_extern_c(f.read()))
        except OSError:
            continue
    _EXTERN_C_CACHE[d] = table
    return table


class CtypesAbiRule(Rule):
    id = "ctypes-abi"
    description = (
        "every symbol called on a LazyLib/CDLL handle needs argtypes AND "
        "restype declared (defaults truncate 64-bit values silently), "
        "and the declaration must match the extern \"C\" definition in "
        "the sibling .cpp (arity and per-position width/kind)"
    )

    _SKIP = {"load"}

    def check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        if mod.tree is None:
            return
        uses_cdll = any(
            isinstance(n, ast.Call)
            and _terminal(n.func) in ("LazyLib", "CDLL")
            for n in ast.walk(mod.tree)
        )
        if not uses_cdll:
            return
        handles = self._handle_names(mod.tree)
        # One loaded lib: every handle name aliases it (the `lib` local
        # in _load() IS the `self._lib` at the call sites), so declared
        # prototypes are keyed by symbol alone. Multiple libs in one
        # module: a prototype on one handle says nothing about the
        # other lib's same-named symbol, so the key includes the handle.
        n_libs = sum(
            1 for n in ast.walk(mod.tree)
            if isinstance(n, ast.Call)
            and _terminal(n.func) in ("LazyLib", "CDLL")
        )
        per_handle = n_libs > 1

        def key(handle: str | None, sym: str):
            return (handle, sym) if per_handle else sym

        declared: dict[object, set[str]] = {}
        # symbol → {"argtypes"/"restype": (value expr, line)} for the
        # cross-language comparison (C symbols are globally unique)
        protos: dict[str, dict[str, tuple[ast.AST, int]]] = {}
        called: dict[tuple[object, str], int] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and t.attr in (
                        "argtypes", "restype"
                    ):
                        sym = _terminal(t.value)
                        if sym is not None and isinstance(
                            t.value, ast.Attribute
                        ):
                            handle = _terminal(t.value.value)
                            declared.setdefault(
                                key(handle, sym), set()
                            ).add(t.attr)
                            protos.setdefault(sym, {})[t.attr] = (
                                node.value, t.lineno
                            )
            elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ):
                base = _terminal(node.func.value)
                if base in handles and (
                    node.func.attr not in self._SKIP
                ):
                    called.setdefault(
                        (key(base, node.func.attr), node.func.attr),
                        node.lineno,
                    )
        # the table idiom: a module-level ``{symbol: (restype,
        # argtypes)}`` dict literal that a loop applies to the loaded
        # handle declares every symbol it names, at the entry's line
        for handle, sym, restype, argtypes, line in (
            self._table_declarations(mod.tree)
        ):
            declared.setdefault(
                key(handle, sym), set()
            ).update(("argtypes", "restype"))
            protos.setdefault(sym, {}).update({
                "restype": (restype, line), "argtypes": (argtypes, line),
            })
        self._aliases = self._ctype_aliases(mod.tree)
        for (k, sym), line in sorted(
            called.items(), key=lambda kv: kv[1]
        ):
            missing = {"argtypes", "restype"} - declared.get(k, set())
            if missing:
                yield self.finding(
                    mod, line,
                    f"CDLL symbol '{sym}' called without declared "
                    f"{' and '.join(sorted(missing))} — ctypes then "
                    "assumes C int everywhere, silently truncating "
                    "64-bit pointers/values on LP64",
                )
        yield from self._check_cross_language(mod, protos)

    # ---- the ``_SIGNATURES`` table idiom
    @staticmethod
    def _table_declarations(tree: ast.Module) -> list[tuple]:
        """(handle, symbol, restype expr, argtypes expr, line) for every
        entry of a module-level dict literal of ``symbol: (a, b)``
        pairs that a ``for name, (a, b) in TABLE.items():`` loop applies
        by setting both ``.restype`` and ``.argtypes`` from the pair.
        A table no such loop applies declares nothing."""
        tables: dict[str, ast.Dict] = {}
        for node in tree.body:
            if (
                isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Dict)
                and all(
                    isinstance(v, ast.Tuple) and len(v.elts) == 2
                    for v in node.value.values
                )
            ):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        tables[t.id] = node.value
        out: list[tuple] = []
        for node in ast.walk(tree):
            if not (
                isinstance(node, ast.For)
                and isinstance(node.iter, ast.Call)
                and isinstance(node.iter.func, ast.Attribute)
                and node.iter.func.attr == "items"
                and isinstance(node.iter.func.value, ast.Name)
                and node.iter.func.value.id in tables
                and isinstance(node.target, ast.Tuple)
                and len(node.target.elts) == 2
                and isinstance(node.target.elts[1], ast.Tuple)
            ):
                continue
            pair = [
                e.id if isinstance(e, ast.Name) else None
                for e in node.target.elts[1].elts
            ]
            which: dict[str, int] = {}
            handle = None
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign):
                    for t in sub.targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and t.attr in ("restype", "argtypes")
                            and isinstance(sub.value, ast.Name)
                            and sub.value.id in pair
                        ):
                            which[t.attr] = pair.index(sub.value.id)
                elif (
                    isinstance(sub, ast.Call)
                    and isinstance(sub.func, ast.Name)
                    and sub.func.id == "getattr"
                    and sub.args
                ):
                    handle = _terminal(sub.args[0])
            if set(which) != {"restype", "argtypes"}:
                continue
            table = tables[node.iter.func.value.id]
            for k, v in zip(table.keys, table.values):
                if isinstance(k, ast.Constant) and isinstance(
                    k.value, str
                ):
                    out.append((
                        handle, k.value, v.elts[which["restype"]],
                        v.elts[which["argtypes"]], k.lineno,
                    ))
        return out

    @staticmethod
    def _ctype_aliases(tree: ast.Module) -> dict[str, str]:
        """Module-level short names for ctypes types
        (``_VP, _U32 = ct.c_void_p, ct.c_uint32``) → the ctypes name."""
        out: dict[str, str] = {}
        for node in tree.body:
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                pairs = []
                if isinstance(t, ast.Name):
                    pairs = [(t, node.value)]
                elif isinstance(t, ast.Tuple) and isinstance(
                    node.value, ast.Tuple
                ):
                    pairs = list(zip(t.elts, node.value.elts))
                for name, value in pairs:
                    term = _terminal(value)
                    if (
                        isinstance(name, ast.Name)
                        and term in _PY_CTYPE_CATEGORY
                    ):
                        out[name.id] = term
        return out

    # ---- cross-language: argtypes/restype vs the extern "C" source
    _aliases: dict[str, str] = {}

    def _py_category(self, expr: ast.AST) -> str | None:
        if isinstance(expr, ast.Constant) and expr.value is None:
            return "void"
        if isinstance(expr, ast.Call):
            t = _terminal(expr.func)
            if t in ("POINTER", "ndpointer"):
                return "ptr"
            return None
        t = _terminal(expr)
        if t is None:
            return None
        return _PY_CTYPE_CATEGORY.get(self._aliases.get(t, t))

    def _eval_argtypes(self, expr: ast.AST) -> list | None:
        """Statically evaluate an argtypes expression to a category
        list, handling ``[A] + [B] * 8``-style computed lists. None if
        the shape cannot be evaluated (never guessed)."""
        if isinstance(expr, (ast.List, ast.Tuple)):
            return [self._py_category(e) for e in expr.elts]
        if isinstance(expr, ast.BinOp):
            if isinstance(expr.op, ast.Add):
                left = self._eval_argtypes(expr.left)
                right = self._eval_argtypes(expr.right)
                if left is None or right is None:
                    return None
                return left + right
            if isinstance(expr.op, ast.Mult):
                seq, count = expr.left, expr.right
                if isinstance(seq, ast.Constant):
                    seq, count = count, seq
                elems = self._eval_argtypes(seq)
                if (
                    elems is not None
                    and isinstance(count, ast.Constant)
                    and isinstance(count.value, int)
                ):
                    return elems * count.value
        return None

    def _check_cross_language(
        self, mod: ModuleInfo,
        protos: dict[str, dict[str, tuple[ast.AST, int]]],
    ) -> Iterator[Finding]:
        native = _native_symbols(mod.path)
        if not native:
            return
        for sym in sorted(protos):
            sig = native.get(sym)
            if sig is None:
                continue  # not one of ours (dlopen'd elsewhere)
            c_ret, c_args = sig
            decls = protos[sym]
            if "argtypes" in decls:
                expr, line = decls["argtypes"]
                py_args = self._eval_argtypes(expr)
                if py_args is not None:
                    if len(py_args) != len(c_args):
                        yield self.finding(
                            mod, line,
                            f"CDLL symbol '{sym}': argtypes declares "
                            f"{len(py_args)} argument(s) but the "
                            f"extern \"C\" definition takes "
                            f"{len(c_args)} — arity drift corrupts "
                            "the stack/registers silently",
                        )
                    else:
                        for i, (p, c) in enumerate(
                            zip(py_args, c_args)
                        ):
                            if p is None or c is None or p == c:
                                continue
                            yield self.finding(
                                mod, line,
                                f"CDLL symbol '{sym}': argtypes[{i}] "
                                f"is {p} but the extern \"C\" "
                                f"definition takes {c} — width/kind "
                                "mismatch truncates or misreads the "
                                "value",
                            )
            if "restype" in decls:
                expr, line = decls["restype"]
                p = self._py_category(expr)
                if p is not None and c_ret is not None and p != c_ret:
                    yield self.finding(
                        mod, line,
                        f"CDLL symbol '{sym}': restype is {p} but "
                        f"the extern \"C\" definition returns "
                        f"{c_ret} — the returned value is truncated "
                        "or reinterpreted",
                    )

    def _handle_names(self, tree: ast.Module) -> set[str]:
        """Names holding a CDLL handle: the conventional lib/_lib plus
        anything assigned from ``CDLL(...)`` or a ``.load()`` call on a
        name assigned from ``LazyLib(...)`` — a handle bound to another
        name must not escape the rule."""
        lazy_objs: set[str] = set()
        handles: set[str] = {"lib", "_lib"}
        for node in ast.walk(tree):
            if not isinstance(node, ast.Assign) or not isinstance(
                node.value, ast.Call
            ):
                continue
            ctor = _terminal(node.value.func)
            if ctor in ("LazyLib", "CDLL"):
                for t in node.targets:
                    name = _terminal(t)
                    if name is not None:
                        lazy_objs.add(name)
                        if ctor == "CDLL":
                            handles.add(name)
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Attribute)
                and node.value.func.attr == "load"
                and _terminal(node.value.func.value) in lazy_objs
            ):
                for t in node.targets:
                    name = _terminal(t)
                    if name is not None:
                        handles.add(name)
        return handles


# ---------------------------------------------------------------------------
# lock-discipline
# ---------------------------------------------------------------------------


class LockDisciplineRule(Rule):
    id = "lock-discipline"
    description = (
        "attributes written from a threading.Thread target method must "
        "be accessed under the owning *_lock everywhere in the class "
        "(container-mutator calls like .append/.update count as writes)"
    )

    # Mutation hides behind method calls as often as behind assignment:
    # an event ring appended from a reader thread (the obs
    # flight-recorder shape) races exactly like a counter `+=`, but a
    # store-only scan never sees it. These are the stdlib container
    # mutators; deliberately NOT queue.Queue's put/get names — Queue
    # does its own locking, and flagging it would teach people to
    # suppress the rule rather than fix real races.
    _CONTAINER_MUTATORS = {
        "append", "appendleft", "extend", "extendleft", "add", "insert",
        "remove", "discard", "pop", "popleft", "popitem", "clear",
        "update", "setdefault",
    }

    def check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        if mod.tree is None:
            return
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                yield from self._check_class(mod, node)

    def _thread_targets(self, cls: ast.ClassDef) -> set[str]:
        targets: set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Call) and _terminal(
                node.func
            ) == "Thread":
                for k in node.keywords:
                    if (
                        k.arg == "target"
                        and isinstance(k.value, ast.Attribute)
                        and isinstance(k.value.value, ast.Name)
                        and k.value.value.id == "self"
                    ):
                        targets.add(k.value.attr)
        return targets

    def _self_attr_accesses(
        self, fn: ast.AST
    ) -> list[tuple[str, int, bool, bool]]:
        """(attr, line, is_store, under_lock) for every ``self.X``
        access in ``fn``, tracking enclosing ``with self.*_lock:``."""
        out: list[tuple[str, int, bool, bool]] = []

        def is_lock_expr(e: ast.AST) -> bool:
            t = _terminal(e)
            return t is not None and (
                t == "_lock" or t.endswith("_lock")
            )

        def visit(node: ast.AST, locked: bool) -> None:
            if isinstance(node, ast.With):
                entered = locked or any(
                    is_lock_expr(item.context_expr)
                    for item in node.items
                )
                for item in node.items:
                    visit(item.context_expr, locked)
                for child in node.body:
                    visit(child, entered)
                return
            if isinstance(node, ast.Attribute) and isinstance(
                node.value, ast.Name
            ) and node.value.id == "self":
                out.append((
                    node.attr, node.lineno,
                    isinstance(node.ctx, (ast.Store, ast.Del)), locked,
                ))
            for child in ast.iter_child_nodes(node):
                visit(child, locked)

        visit(fn, False)
        return out

    def _check_class(
        self, mod: ModuleInfo, cls: ast.ClassDef
    ) -> Iterator[Finding]:
        thread_methods = self._thread_targets(cls)
        if not thread_methods:
            return
        methods = {
            n.name: n
            for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        # closure over self.<method>() calls: a helper invoked (even
        # indirectly) from the target runs ON the worker thread, so its
        # stores are just as shared as the target's own
        on_thread: set[str] = set()
        work = [n for n in thread_methods if n in methods]
        while work:
            name = work.pop()
            if name in on_thread:
                continue
            on_thread.add(name)
            for node in ast.walk(methods[name]):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "self"
                    and node.func.attr in methods
                ):
                    work.append(node.func.attr)
        shared: set[str] = set()
        for name in on_thread:
            for attr, _line, is_store, _locked in (
                self._self_attr_accesses(methods[name])
            ):
                if is_store:
                    shared.add(attr)
            for node in ast.walk(methods[name]):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in self._CONTAINER_MUTATORS
                    and isinstance(node.func.value, ast.Attribute)
                    and isinstance(node.func.value.value, ast.Name)
                    and node.func.value.value.id == "self"
                ):
                    shared.add(node.func.value.attr)
        if not shared:
            return
        for name, fn in methods.items():
            # __init__ runs before the thread exists (happens-before
            # via Thread.start), so unlocked initialization is safe
            if name == "__init__":
                continue
            for attr, line, is_store, locked in (
                self._self_attr_accesses(fn)
            ):
                if attr in shared and not locked:
                    kind = "written" if is_store else "read"
                    ctx = (
                        "its Thread target method"
                        if name in thread_methods
                        else f"'{name}'"
                    )
                    yield self.finding(
                        mod, line,
                        f"'self.{attr}' is {kind} in {ctx} without "
                        f"holding a lock, but it is mutated from the "
                        f"thread started with target=self."
                        f"{'/'.join(sorted(thread_methods))} — guard "
                        "every access with the owning *_lock",
                    )


# ---------------------------------------------------------------------------
# fault-site-registry
# ---------------------------------------------------------------------------


class FaultSiteRegistryRule(Rule):
    id = "fault-site-registry"
    description = (
        "every fault seam must use a site registered in utils.faults."
        "SITES, and every registered site needs a fault test"
    )

    def check_project(
        self, modules: Sequence[ModuleInfo]
    ) -> Iterator[Finding]:
        registry_mod: ModuleInfo | None = None
        sites: dict[str, int] = {}
        for mod in modules:
            if os.path.basename(mod.path) != "faults.py" or (
                mod.tree is None
            ):
                continue
            found = self._extract_sites(mod)
            if found is not None:
                registry_mod = mod
                sites = found
        external_registry = False
        if registry_mod is None:
            loaded = self._load_external_registry(modules)
            if loaded is not None:
                registry_mod, sites = loaded
                external_registry = True
        used: dict[str, tuple[ModuleInfo, int]] = {}
        for mod in modules:
            if mod is registry_mod or mod.tree is None:
                continue
            for site, line, literal in self._site_uses(mod):
                if not literal:
                    yield self.finding(
                        mod, line,
                        "fault site must be a string literal (the "
                        "registry cross-check cannot audit a computed "
                        "site name)",
                    )
                    continue
                used.setdefault(site, (mod, line))
                if registry_mod is not None and site not in sites:
                    yield self.finding(
                        mod, line,
                        f"fault site '{site}' is not registered in "
                        "utils.faults.SITES — register it (with a "
                        "description) so the chaos matrix can cover it",
                    )
        if registry_mod is None:
            if used:
                mod, line = next(iter(used.values()))
                yield self.finding(
                    mod, line,
                    "fault sites are used but no SITES registry was "
                    "found in a faults.py module in the scanned tree",
                )
            return
        if external_registry or not self._full_package_scan(
            registry_mod, modules
        ):
            # Partial scan (registry outside the linted paths, OR in a
            # scanned subtree that omits the rest of its package): only
            # the use→registry direction is auditable — a site used
            # solely outside the scanned subtree would be a false
            # "never used" positive, so registry-side checks are skipped.
            return
        chaos_src = self._chaos_source(registry_mod)
        for site, line in sorted(sites.items()):
            if site not in used:
                yield self.finding(
                    registry_mod, line,
                    f"registered fault site '{site}' is never used at "
                    "any seam — remove it or thread it through",
                )
            if chaos_src is not None and site not in chaos_src:
                yield self.finding(
                    registry_mod, line,
                    f"registered fault site '{site}' has no fault test: "
                    "no tests/test_torch_*.py module references it",
                )

    def _extract_sites(self, mod: ModuleInfo) -> dict[str, int] | None:
        """The ``SITES = {...}`` literal as {site: lineno}, or None if
        this module defines no registry."""
        assert mod.tree is not None
        for node in ast.walk(mod.tree):
            if not (
                isinstance(node, (ast.Assign, ast.AnnAssign))
                and isinstance(node.value, ast.Dict)
            ):
                continue
            targets = (
                node.targets
                if isinstance(node, ast.Assign)
                else [node.target]
            )
            if not any(
                isinstance(t, ast.Name) and t.id == "SITES"
                for t in targets
            ):
                continue
            return {
                k.value: k.lineno
                for k in node.value.keys
                if isinstance(k, ast.Constant)
                and isinstance(k.value, str)
            }
        return None

    def _full_package_scan(
        self, registry_mod: ModuleInfo,
        modules: Sequence[ModuleInfo],
    ) -> bool:
        """True iff every module of the registry's package is in the
        scanned set — the only case where 'registered but never used'
        is a provable claim rather than a partial-scan artifact."""
        root = os.path.dirname(os.path.abspath(registry_mod.path))
        if os.path.basename(root) == "utils":
            root = os.path.dirname(root)
        scanned = {os.path.abspath(m.path) for m in modules}
        return all(
            os.path.abspath(p) in scanned
            for p in _iter_py_files([root])
        )

    def _load_external_registry(
        self, modules: Sequence[ModuleInfo]
    ) -> tuple[ModuleInfo, dict[str, int]] | None:
        """Locate and parse ``utils/faults.py`` near the scanned files
        when the registry module itself is outside the linted paths
        (e.g. ``graftlint traffic_classifier_sdn_tpu_torch/ingest``), so a
        subtree scan can still audit the use→registry direction instead
        of reporting a spurious missing-registry finding."""
        seen: set[str] = set()
        for mod in modules:
            d = os.path.dirname(os.path.abspath(mod.path))
            for _ in range(6):
                candidate = os.path.join(d, "utils", "faults.py")
                if candidate not in seen:
                    seen.add(candidate)
                    if os.path.exists(candidate):
                        try:
                            with open(candidate, encoding="utf-8") as f:
                                source = f.read()
                        except OSError:
                            continue
                        reg = ModuleInfo(candidate, candidate, source)
                        if reg.tree is None:
                            continue
                        sites = self._extract_sites(reg)
                        if sites is not None:
                            return reg, sites
                d = os.path.dirname(d)
        return None

    def _site_uses(
        self, mod: ModuleInfo
    ) -> Iterator[tuple[str, int, bool]]:
        """(site, line, is_literal) for fault_point/fault_bytes calls
        and ``*_site=`` keyword arguments. Forwarding exemption is
        scoped per enclosing function: only that function's OWN
        ``*_site`` parameters count — a same-named local computed in
        another function must not slip past the literal check."""
        assert mod.tree is not None
        yield from self._scope_site_uses(mod.tree, set())
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                params = {
                    a.arg
                    for a in (
                        node.args.args + node.args.kwonlyargs
                        + node.args.posonlyargs
                    )
                    if a.arg.endswith("_site")
                }
                yield from self._scope_site_uses(node, params)

    def _scope_site_uses(
        self, root: ast.AST, param_names: set[str]
    ) -> Iterator[tuple[str, int, bool]]:
        for node in _walk_excluding_defs(root):
            if not isinstance(node, ast.Call):
                continue
            t = _terminal(node.func)
            if t in ("fault_point", "fault_bytes") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant) and isinstance(
                    arg.value, str
                ):
                    yield arg.value, node.lineno, True
                elif not (
                    isinstance(arg, ast.Name) and arg.id in param_names
                ):
                    # forwarding a *_site parameter is fine — the
                    # literal is audited at the original call site
                    yield "", node.lineno, False
            for k in node.keywords:
                if k.arg is None or not k.arg.endswith("_site"):
                    continue
                v = k.value
                if isinstance(v, ast.Constant) and isinstance(
                    v.value, str
                ):
                    yield v.value, node.lineno, True
                elif not (
                    isinstance(v, ast.Name) and v.id in param_names
                ):
                    # same contract as the positional form: a computed
                    # site name cannot be audited against the registry
                    yield "", node.lineno, False

    def _chaos_source(self, registry_mod: ModuleInfo) -> str | None:
        """The text of the port's test modules (``tests/test_torch_*
        .py``): its fault-injection tests are spread over the suites of
        the seams they drive (collector, fan-in, native engine,
        pipeline, degrade, incremental, chaos), not one chaos module."""
        d = os.path.dirname(os.path.abspath(registry_mod.path))
        for _ in range(6):
            tests = os.path.join(d, "tests")
            if os.path.exists(os.path.join(tests, "test_torch_chaos.py")):
                texts = []
                for name in sorted(os.listdir(tests)):
                    if name.startswith("test_torch_") and name.endswith(
                        ".py"
                    ):
                        try:
                            with open(os.path.join(tests, name),
                                      encoding="utf-8") as f:
                                texts.append(f.read())
                        except OSError:
                            return None
                return "\n".join(texts)
            parent = os.path.dirname(d)
            if parent == d:
                break
            d = parent
        return None


# ---------------------------------------------------------------------------
# atomic-io
# ---------------------------------------------------------------------------


class AtomicIoRule(Rule):
    id = "atomic-io"
    description = (
        "write+rename outside utils/atomicio.py: use atomic_write_bytes "
        "(temp-in-target-dir + fsync + os.replace, chaos-tested)"
    )

    # 'a' deliberately absent: an append is not a whole-file rewrite,
    # so atomic_write_bytes is not a valid replacement and pairing an
    # append with an unrelated rename would be a false positive
    _WRITE_MODES = ("w", "x")

    def check_module(self, mod: ModuleInfo) -> Iterator[Finding]:
        if mod.tree is None or mod.path.replace(os.sep, "/").endswith(
            "utils/atomicio.py"
        ):
            return
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # each def is its own scope, nested defs included (they
                # get their own pass): a write inside a nested helper
                # must not pair with a rename in the enclosing body
                yield from self._check_scope(
                    mod, _walk_excluding_defs(node)
                )
        # the module top level is a scope too: script-style
        # write+rename (including under `if __name__ == "__main__":`)
        # must not bypass the rule just because no def wraps it. The
        # shallow walk stops at def/class boundaries so a write inside
        # a nested def cannot pair with an unrelated top-level rename.
        yield from self._check_scope(
            mod, _walk_excluding_defs(mod.tree)
        )

    def _check_scope(
        self, mod: ModuleInfo, nodes: Iterator[ast.AST]
    ) -> Iterator[Finding]:
        opens_for_write = False
        renames: list[int] = []
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name) and node.func.id == "open":
                mode = None
                if len(node.args) > 1 and isinstance(
                    node.args[1], ast.Constant
                ):
                    mode = node.args[1].value
                for k in node.keywords:
                    if k.arg == "mode" and isinstance(
                        k.value, ast.Constant
                    ):
                        mode = k.value.value
                if isinstance(mode, str) and any(
                    c in mode for c in self._WRITE_MODES
                ):
                    opens_for_write = True
            elif _dotted(node.func) in ("os.replace", "os.rename"):
                renames.append(node.lineno)
        if opens_for_write:
            for line in renames:
                yield self.finding(
                    mod, line,
                    "ad-hoc write+rename: use utils.atomicio."
                    "atomic_write_bytes (this pattern, minus the fsync "
                    "and temp-dir subtleties it re-implements, is "
                    "already chaos-tested there)",
                )


from .graftlock import (  # noqa: E402 — graftlock imports framework only
    BlockingUnderLockRule,
    LockOrderRule,
    ThreadLifecycleRule,
)
from .graftsync import (  # noqa: E402 — graftsync imports graftlock only
    DonationHazardRule,
    ImplicitSyncRule,
    SyncUnderLockRule,
    TransferDisciplineRule,
)

ALL_RULES = (
    JitPurityRule,
    RetraceHazardRule,
    CtypesAbiRule,
    LockDisciplineRule,
    FaultSiteRegistryRule,
    AtomicIoRule,
    # graftlock: the whole-program concurrency pass (graftlock.py)
    LockOrderRule,
    BlockingUnderLockRule,
    ThreadLifecycleRule,
    # graftsync: the whole-program device-boundary pass (graftsync.py)
    ImplicitSyncRule,
    TransferDisciplineRule,
    DonationHazardRule,
    SyncUnderLockRule,
)

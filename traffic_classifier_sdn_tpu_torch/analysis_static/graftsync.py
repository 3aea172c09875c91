"""graftsync: whole-program host↔device boundary analysis for the port.

graftlock proves the concurrency invariants the runtime cannot; this
module does the same for the OTHER silent performance killer: a hidden
device→host sync or a per-tick host→device upload on the serve hot
path. In eager PyTorch on CUDA every ``int()``/``bool()``/``.item()``/
``.tolist()``/``.cpu()``/``np.asarray`` of a device tensor, and every
data-dependent shape (``nonzero``, boolean-mask indexing,
``torch.unique``), blocks the host until the card is idle — graftsync
makes the analyzer find the next one before a chip run pays for it.

The pass reuses graftlock's interprocedural infrastructure (call
graph, import resolution, attribute typing, held-lock summaries) and
adds a device-taint layer on top:

hot-path classification
    Functions reachable (through graftlock's call edges) from the
    serve tick's per-tick surfaces — ``dispatch_read``, the pipeline
    host/device stages, the ``*Read.rows`` render boundary, the
    incremental/degrade/drift/openset predict wrappers — are HOT; the
    rest (warmup, CLI setup, checkpoint restore, training) is cold and
    free to sync. A function named ``serve_tick`` is a hot root by
    convention, which is how out-of-tree fixtures opt in.

``implicit-sync``
    ``np.asarray``/``.item()``/``.tolist()``/``.cpu()``/``.numpy()``/
    ``int()``/``float()``/``bool()``/truthiness/iteration on a
    device-tensor value, ``torch.cuda.synchronize``/``Event``/``Stream
    .synchronize``, and data-dependent shapes (``nonzero``, boolean-mask
    indexing, ``torch.unique``, ``masked_select``, ``repeat_interleave``
    without ``output_size``) reachable on a hot path. Every allowed
    instance carries a reasoned suppression NAMING ITS DEFERRAL
    DISCIPLINE (see ``DISCIPLINES``). A suppression whose reason names
    no discipline is a ``bad-suppression`` finding, which cannot itself
    be suppressed.

``transfer-discipline``
    ``torch.as_tensor``/``torch.tensor``/``torch.asarray`` of a host
    value, or ``.to(<device>)``/``.cuda()`` of a value not known to be
    on the device, inside a per-tick path, unless routed through a
    warmup-primed or epoch-cached seam. Fresh wire data crossing to the
    device is the workload, not a finding: the ingest side is not a
    hot root.

``donation-hazard``
    The port donates no buffer; the hazard in that buffer's place is
    the cross-stream use. A tensor made outside a
    ``torch.cuda.stream(s)`` block and used inside it must be marked
    ``record_stream(s)`` (or the function must fence the stream:
    ``wait_stream``/``wait_event``/``synchronize``), else the caching
    allocator may hand its memory to a later tick while ``s`` still
    reads it.

``sync-under-lock``
    Any sync/transfer while holding a project lock, composing
    graftlock's held-lock summaries with the new sync summaries. A
    device sync can take arbitrarily long on a busy card; a thread that
    syncs under a lock wedges every thread that ever takes that lock.

``build_sync_report`` exports the per-tick expected-sync ledger
(``docs/artifacts/torch_hot_path_sync_budget.json``): every allowlisted
sync site with its discipline and reason, the hot-function spans, and
the per-serve-path (serial/pipelined/incremental/degraded) ledgers. The
runtime witness (``utils/syncguard.py``) cross-checks every observed
sync against this budget by call site — an unknown sync is a resolver
hole, exactly like locktrace's unknown-edge check.

Resolution is syntactic-plus-conventions, like graftlock: a value is
device-typed if it comes from a ``torch.*`` factory given a device or a
``torch.*`` op given a tensor argument, ``.to(device)``/``.cuda()``, a
call into the kernel wrappers (``ops/{forest,knn,rbf}_kernel.py``), a
``torch.Tensor`` annotation, an attribute a scanned method assigns a
tensor to, or a call to a scanned function that returns one (a
monotone fixed point). The witness exists precisely to catch the syncs
this static pass misses.
"""

from __future__ import annotations

import ast
import os
from collections.abc import Iterator, Sequence
from dataclasses import dataclass, field

from . import graftlock
from .framework import BAD_SUPPRESSION, Finding, ModuleInfo, Rule
from .graftlock import _chain_text, _mod_proxy, _short

IMPLICIT_SYNC = "implicit-sync"
TRANSFER_DISCIPLINE = "transfer-discipline"
DONATION_HAZARD = "donation-hazard"
SYNC_UNDER_LOCK = "sync-under-lock"

# The deferral-discipline vocabulary: a suppression of implicit-sync /
# transfer-discipline must name exactly how the sync is kept off the
# per-tick critical path (docs/TORCH_STATIC_ANALYSIS.md documents each).
DISCIPLINES = (
    "deferred-drain",    # drained lazily off the dispatch edge
    "epoch-cached",      # uploaded once per label epoch, cached on device
    "warmup-primed",     # primed once at warmup, never re-paid per tick
    "render-sync",       # the render boundary: labels must reach the host
    "watchdog-guarded",  # the degrade ladder's deadline-bounded host fetch
    "cold-path",         # hot-reachable in the graph, cold by construction
    "tick-plan",         # an O(1) planning scalar the host must read to
                         # size this tick's dispatch (e.g. the dirty count)
    "host-native",       # the value is already host-resident (host-native
                         # predict variant) — the conversion is a no-op
)


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


# ---------------------------------------------------------------------------
# hot roots
# ---------------------------------------------------------------------------

# (path suffix | None, class matcher | None, function name). A class
# matcher starting with "*" is a suffix match ("*Read" hits RankedRead,
# IncFullRead, ...). These are the per-tick surfaces of the four serve
# compositions; everything transitively callable from them is hot.
_SERVE_PATH_ROOTS: dict[str, tuple[tuple, ...]] = {
    "serial": (
        ("cli.py", None, "_print_table"),
        ("serving/openset.py", "OpenSetGate", "__call__"),
        ("serving/drift.py", "DriftGate", "__call__"),
    ),
    "pipelined": (
        ("serving/pipeline.py", None, "dispatch_read"),
        ("serving/pipeline.py", "ServePipeline", "submit"),
        ("serving/pipeline.py", "ServePipeline", "_run"),
        # JAX's FeatureStage.features (its donated feature buffers) has
        # no counterpart here: the port stages no donated feature buffers
        ("serving/pipeline.py", "*Read", "rows"),
        ("cli.py", None, "_dispatch_render"),
        ("cli.py", None, "_print_ranked"),
    ),
    "incremental": (
        ("serving/incremental.py", "IncrementalLabels", "labels"),
        ("serving/incremental.py", "IncrementalLabels", "dispatch"),
        ("serving/incremental.py", "IncrementalLabels", "finish"),
        ("serving/incremental.py", "*Read", "rows"),
    ),
    "degraded": (
        ("serving/degrade.py", "DegradeLadder", "__call__"),
    ),
}

# np-dtype scalar constructors: building one is host-side and free, but
# feeding it to a compiled call uploads a fresh scalar every call.
_NP_SCALAR_CTORS = {
    "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "float16", "float32", "float64", "bool_",
}

# ``len()`` is absent: on a torch tensor it reads the shape, no sync
_SYNC_BUILTINS = {"int", "float", "bool"}

# Attribute reads on a device value that stay host-side: tensor and
# table metadata, not data (shape tuples, dtypes, the device, the
# capacity/n_flows host-int properties).
_HOST_META_ATTRS = {
    "shape", "dtype", "ndim", "device", "is_cuda", "layout",
    "requires_grad", "capacity", "n_flows", "at",
}

# Tensor methods that return host metadata, not data
_HOST_META_METHODS = {
    "size", "dim", "numel", "nelement", "element_size", "data_ptr",
    "stride", "is_contiguous", "get_device", "storage_offset",
    "is_floating_point", "is_pinned",
}

# device→host methods on a tensor: each waits for the card
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}

# data-dependent shapes: the output size is read back from the card
# before the host can go on (``repeat_interleave`` only without
# ``output_size``)
_DATA_DEP_SHAPES = {
    "nonzero", "unique", "unique_consecutive", "masked_select",
    "repeat_interleave", "argwhere",
}

# host→device converters of a host value
_TORCH_UPLOADS = {"torch.as_tensor", "torch.tensor", "torch.asarray"}

# torch.* callables that return no tensor (devices, streams, events,
# contexts, flags, generators, compiled callables): host values
_TORCH_HOST_PREFIXES = (
    "torch.cuda.", "torch.backends.", "torch.profiler.",
    "torch.autograd.", "torch.utils.", "torch.distributed.",
    "torch.jit.", "torch.library.", "torch.ops.",
)
_TORCH_HOST_CALLS = {
    "torch.device", "torch.dtype", "torch.Size", "torch.finfo",
    "torch.iinfo", "torch.is_tensor", "torch.no_grad",
    "torch.inference_mode", "torch.enable_grad", "torch.Generator",
    "torch.get_num_threads", "torch.set_num_threads",
    "torch.get_default_dtype", "torch.is_grad_enabled",
    "torch.manual_seed", "torch.compile", "torch.is_floating_point",
    "torch.numel", "torch.from_numpy",
}

# the kernel wrappers: everything they return lives on the card
_KERNEL_WRAPPERS = (
    "ops/forest_kernel.py", "ops/knn_kernel.py", "ops/rbf_kernel.py",
)

# parameter-name → class-name conventions, the graftlock
# _ATTR_TYPE_HINTS idiom at function boundaries: the serve plumbing
# passes these untyped, and losing the chain at the first hop would
# blind the pass to `engine.table.fwd.active`-style device reads
_PARAM_CLASS_HINTS = {
    "engine": "FlowStateEngine",
    "eng": "FlowStateEngine",
    "table": "FlowTable",
}


def _is_tensor_annotation(ann: ast.AST | None) -> bool:
    if ann is None:
        return False
    if isinstance(ann, ast.BinOp):  # "torch.Tensor | None"
        return (_is_tensor_annotation(ann.left)
                or _is_tensor_annotation(ann.right))
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.strip() in ("torch.Tensor", "Tensor")
    return _dotted(ann) in ("torch.Tensor", "Tensor")


def _is_stream_ctx(expr: ast.AST) -> bool:
    """``torch.cuda.stream(s)`` — the block runs its launches on ``s``."""
    return isinstance(expr, ast.Call) and (
        _dotted(expr.func) or ""
    ).endswith("cuda.stream")


# functions a wildcard root spec matches that JAX's roots do not hold:
# JAX finishes the sharded read inline in its CLI, not in a ``*Read``
# class, so the port's ``ShardedRead`` keeps that function's (unrooted)
# place
_NOT_ROOTS = {("serving/pipeline.py", "ShardedRead", "rows")}


def _root_match(s, spec: tuple) -> bool:
    path_suffix, cls, name = spec
    if s.name != name:
        return False
    if any(
        s.cls == ncls and s.name == nname
        and s.mod.display_path.replace(os.sep, "/").endswith(npath)
        for npath, ncls, nname in _NOT_ROOTS
    ):
        return False
    if path_suffix is not None and not s.mod.display_path.replace(
        os.sep, "/"
    ).endswith(path_suffix):
        return False
    if cls is None:
        return s.cls is None
    if s.cls is None:
        return False
    if cls.startswith("*"):
        return s.cls.endswith(cls[1:])
    return s.cls == cls


def _is_hot_root(s) -> bool:
    if s.name == "serve_tick":  # the fixture/out-of-tree convention
        return True
    return any(
        _root_match(s, spec)
        for specs in _SERVE_PATH_ROOTS.values()
        for spec in specs
    )


# ---------------------------------------------------------------------------
# per-function sync scan
# ---------------------------------------------------------------------------


@dataclass
class _SyncEvent:
    rule: str          # IMPLICIT_SYNC | TRANSFER_DISCIPLINE
    kind: str          # "np.asarray", ".item()", "device_put", ...
    line: int
    what: str          # human-readable value description
    held: tuple = ()   # ((lock, line), ...) at the event


@dataclass
class _Donation:
    """A cross-stream use with no allocator fence: ``name`` was made
    outside the ``torch.cuda.stream`` block opened at ``line`` and is
    read inside it at ``use_line``."""

    line: int
    name: str          # the binding ("X" / "self._cache")
    callee: str        # the stream expression's text
    use_line: int      # the use inside the block


@dataclass
class _FnSync:
    events: list[_SyncEvent] = field(default_factory=list)
    donations: list[_Donation] = field(default_factory=list)
    returns_device: bool = False
    device_attr_writes: set[str] = field(default_factory=set)


class _SyncAnalysis:
    """The device-boundary layer over graftlock's interprocedural base:
    per-function sync/transfer/cross-stream summaries, the hot-path set,
    and sync closures for the under-lock composition."""

    def __init__(self, modules: Sequence[ModuleInfo]):
        self.lock = graftlock.analyze(modules)
        self.project = self.lock.project
        # module path → names bound to torch.compile/torch.jit callables
        self.jit_names: dict[str, set[str]] = {}
        for m in self.project.modules:
            self._index_module(m)
        self.fn_sync: dict[int, _FnSync] = {}
        self._stream_cache: dict[int, tuple] = {}
        # (module path, class) → device-typed attribute names
        self.device_attrs: dict[tuple[str, str], set[str]] = {}
        # tensor-record classes (a dataclass of ``torch.Tensor`` fields,
        # the flow table's shape): instances ARE device values
        self.pytree_classes: set[str] = set()
        for m in self.project.modules:
            assert m.tree is not None
            for node in ast.walk(m.tree):
                if isinstance(node, ast.ClassDef) and any(
                    isinstance(st, ast.AnnAssign)
                    and _is_tensor_annotation(st.annotation)
                    for st in node.body
                ):
                    self.pytree_classes.add(node.name)
        # class-level torch.Tensor / record-typed field annotations seed
        # the device-attr sets the method-scan fixed point then grows
        for m in self.project.modules:
            assert m.tree is not None
            for node in ast.walk(m.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                for st in node.body:
                    if not (isinstance(st, ast.AnnAssign)
                            and isinstance(st.target, ast.Name)):
                        continue
                    ann = st.annotation
                    if (
                        _is_tensor_annotation(ann)
                        or _terminal(ann) in self.pytree_classes
                    ):
                        self.device_attrs.setdefault(
                            (m.display_path, node.name), set()
                        ).add(st.target.id)
        # summary key → device-tainted parameter indices (flowed from
        # call sites — including constructor calls, which is how a
        # device output handed to a Read object's __init__ taints the
        # attribute its rows() later converts)
        self.param_taint: dict[int, set[int]] = {}
        self._pt_dirty = False
        self._fixed_point()
        # summary key → chain of qualnames from a hot root
        self.hot: dict[int, tuple[str, ...]] = {}
        self._compute_hot()
        # summary key → {(path, line, kind): chain}
        self.sync_closure: dict[int, dict] = {}
        self._compute_sync_closures()

    # -- module-level indexes -----------------------------------------------
    def _index_module(self, m: ModuleInfo) -> None:
        jits: set[str] = set()
        assert m.tree is not None
        for node in ast.walk(m.tree):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Call
            ) and (_dotted(node.value.func) or "") in (
                "torch.compile", "torch.jit.script", "torch.jit.trace",
            ):
                jits.update(t.id for t in node.targets
                            if isinstance(t, ast.Name))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for d in node.decorator_list:
                    f = d.func if isinstance(d, ast.Call) else d
                    if (_dotted(f) or "") in (
                        "torch.compile", "torch.jit.script",
                    ):
                        jits.add(node.name)
        self.jit_names[m.display_path] = jits

    def _is_jit_name(self, m: ModuleInfo, name: str) -> bool:
        if name in self.jit_names.get(m.display_path, ()):
            return True
        imp = self.project.imports.get(m.display_path, {}).get(name)
        if imp is not None and imp[0] == "symbol":
            return imp[2] in self.jit_names.get(imp[1], ())
        return False

    def _is_kernel_module(self, m: ModuleInfo, name: str) -> bool:
        """``name`` is one of the kernel wrappers' modules (imported as a
        module) — every call through it returns a device tensor."""
        imp = self.project.imports.get(m.display_path, {}).get(name)
        return imp is not None and imp[0] == "module" and imp[1].replace(
            os.sep, "/"
        ).endswith(_KERNEL_WRAPPERS)

    def _is_kernel_symbol(self, m: ModuleInfo, name: str) -> bool:
        imp = self.project.imports.get(m.display_path, {}).get(name)
        return imp is not None and imp[0] == "symbol" and imp[1].replace(
            os.sep, "/"
        ).endswith(_KERNEL_WRAPPERS)

    # -- fixed point over return-taint / attr-taint / param-taint -----------
    def _fixed_point(self) -> None:
        for _ in range(8):  # monotone; tiny bound in practice
            changed = False
            self._pt_dirty = False
            for key, s in self.lock.summaries.items():
                fs = self._scan_function(s)
                prev = self.fn_sync.get(key)
                if (
                    prev is None
                    or fs.returns_device != prev.returns_device
                    or fs.device_attr_writes != prev.device_attr_writes
                ):
                    changed = True
                self.fn_sync[key] = fs
                if s.cls is not None and fs.device_attr_writes:
                    slot = self.device_attrs.setdefault(
                        (s.mod.display_path, s.cls), set()
                    )
                    if not fs.device_attr_writes <= slot:
                        slot |= fs.device_attr_writes
                        changed = True
            if not changed and not self._pt_dirty:
                break

    # -- the per-function walk ----------------------------------------------
    def _stream_facts(self, fn: ast.AST) -> tuple:
        """What ``fn`` fences (``record_stream`` bindings, and whether it
        calls ``wait_stream``/``wait_event``/``synchronize``), which
        names hold a ``torch.cuda.stream(...)`` context (→ its stream
        argument), and which hold a stream taken from
        ``current_stream`` (entering the caller's own stream is no
        cross-stream use). Taint-independent: computed once."""
        cached = self._stream_cache.get(id(fn))
        if cached is not None:
            return cached
        recorded: set[str] = set()
        fenced = False
        # context name → the stream expression its cuda.stream(...) got
        stream_ctx_names: dict[str, ast.AST | None] = {}
        same_stream: set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ):
                if node.func.attr == "record_stream":
                    b = _dotted(node.func.value)
                    if b is not None:
                        recorded.add(b)
                elif node.func.attr in ("wait_stream", "wait_event",
                                        "synchronize"):
                    fenced = True
            if isinstance(node, ast.Assign):
                has_ctx = any(_is_stream_ctx(sub)
                              for sub in ast.walk(node.value))
                current = any(
                    isinstance(sub, ast.Call)
                    and (_dotted(sub.func) or "").endswith(
                        "current_stream")
                    for sub in ast.walk(node.value)
                )
                ctx_arg = next(
                    (sub.args[0] for sub in ast.walk(node.value)
                     if _is_stream_ctx(sub) and sub.args), None
                )
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        if has_ctx:
                            stream_ctx_names[t.id] = ctx_arg
                        if current:
                            same_stream.add(t.id)
        out = (recorded, fenced, stream_ctx_names, same_stream)
        self._stream_cache[id(fn)] = out
        return out

    def _scan_function(self, s) -> _FnSync:
        m, cls, fn = s.mod, s.cls, s.node
        fs = _FnSync()
        # line → callee summary keys (from graftlock's resolved calls)
        line_calls: dict[int, list[int]] = {}
        for callee, line, _held in s.calls:
            line_calls.setdefault(line, []).append(callee)

        tainted: set[str] = set()
        host_np: set[str] = set()
        masks: set[str] = set()  # names bound to a device boolean mask
        param_types: dict[str, tuple[str, str]] = {}
        params = (fn.args.posonlyargs + fn.args.args
                  + fn.args.kwonlyargs)
        for i, a in enumerate(params):
            ann = a.annotation
            if ann is None:
                hint = _PARAM_CLASS_HINTS.get(a.arg)
                hits = (self.project.classes_by_name.get(hint)
                        if hint else None)
                if hits:
                    param_types[a.arg] = hits[0]
                continue
            if (
                _is_tensor_annotation(ann)
                or _terminal(ann) in self.pytree_classes
            ):
                tainted.add(a.arg)
                continue
            ref = self.project._annotation_class(m, ann)
            if ref is not None:
                param_types[a.arg] = ref
        for i in self.param_taint.get(id(fn), ()):
            # a parameter typed as a scanned host class (the engine,
            # by annotation or name convention) holds device fields,
            # not device data: its attributes resolve through the class
            if i < len(params) and (
                param_types.get(params[i].arg, ("", ""))[1]
                in ("", *self.pytree_classes)
            ):
                tainted.add(params[i].arg)
        # serve-root predict wrappers take the dispatched feature
        # matrix as an untyped ``X`` (device-resident on the device
        # serve paths; the host-native variant's conversions are then
        # no-ops — the safe overapproximation): seed it, or the taint
        # dies at the wrapper boundary no caller resolves into
        if _is_hot_root(s) and any(p.arg == "X" for p in params):
            tainted.add("X")

        # cross-stream bookkeeping: what the function fences, and which
        # names hold a ``torch.cuda.stream(...)`` context or a stream
        # taken from ``current_stream`` (entering the caller's own
        # stream is no cross-stream use)
        recorded, fenced, stream_ctx_names, same_stream = (
            self._stream_facts(fn)
        )
        # the open stream blocks: (line, stream text, names bound
        # before the block)
        stream_blocks: list[tuple[int, str, frozenset]] = []
        reported: set[str] = set()

        def attr_device(node: ast.Attribute) -> bool:
            base = node.value
            if isinstance(base, ast.Name):
                if base.id == "self" and cls is not None:
                    return node.attr in self.device_attrs.get(
                        (m.display_path, cls), ()
                    )
                ref = param_types.get(base.id)
                if ref is not None:
                    return node.attr in self.device_attrs.get(ref, ())
            return False

        def binding(node: ast.AST) -> str | None:
            """A trackable binding: a bare local, or self.X."""
            if isinstance(node, ast.Name):
                return node.id
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"
            ):
                return f"self.{node.attr}"
            return None

        def cross_stream_use(bnd: str, line: int) -> None:
            if not stream_blocks or fenced or bnd in recorded:
                return
            bline, stream, outside = stream_blocks[-1]
            if bnd in outside and bnd not in reported:
                reported.add(bnd)
                fs.donations.append(_Donation(bline, bnd, stream, line))

        def is_mask(node: ast.AST) -> bool:
            """A boolean-mask expression (comparison, logical op, or a
            name bound to one)."""
            if isinstance(node, ast.Compare):
                return not all(isinstance(op, (ast.Is, ast.IsNot))
                               for op in node.ops)
            if isinstance(node, ast.UnaryOp):
                return isinstance(node.op, (ast.Invert, ast.Not))
            if isinstance(node, ast.BinOp):
                return isinstance(node.op, (ast.BitAnd, ast.BitOr,
                                            ast.BitXor))
            if isinstance(node, ast.Name):
                return node.id in masks
            if isinstance(node, ast.Call):
                return _terminal(node.func) in (
                    "logical_and", "logical_or", "logical_not",
                    "isnan", "isfinite", "isinf", "eq", "ne", "lt",
                    "le", "gt", "ge",
                )
            return False

        def taint_of(node: ast.AST, held: tuple) -> str | None:
            """'dev' | 'host_np' | None; emits events as a side effect
            (each expression is evaluated exactly once, in source
            order)."""
            if isinstance(node, ast.Name):
                b = node.id
                if isinstance(node.ctx, ast.Load) and b in tainted:
                    cross_stream_use(b, node.lineno)
                if b in tainted:
                    return "dev"
                if b in host_np:
                    return "host_np"
                return None
            if isinstance(node, ast.Attribute):
                bnd = binding(node)
                base_t = taint_of(node.value, held)
                if attr_device(node):
                    if bnd is not None and isinstance(node.ctx, ast.Load):
                        cross_stream_use(bnd, node.lineno)
                    return "dev"
                # a field of a device record is device-resident;
                # metadata reads (shape/dtype/capacity) stay host
                if base_t == "dev" and node.attr not in (
                    _HOST_META_ATTRS
                ):
                    return "dev"
                return None
            if isinstance(node, ast.Call):
                return call_taint(node, held)
            if isinstance(node, ast.Subscript):
                t = taint_of(node.value, held)
                st = taint_of(node.slice, held)
                if (
                    t == "dev" and st == "dev"
                    and isinstance(node.ctx, ast.Load)
                    and is_mask(node.slice)
                ):
                    sync(node.lineno, "mask-index",
                         "boolean-mask indexing of a device tensor "
                         "(a data-dependent shape)", held)
                return t
            if isinstance(node, (ast.BinOp,)):
                lt = taint_of(node.left, held)
                rt = taint_of(node.right, held)
                return "dev" if "dev" in (lt, rt) else None
            if isinstance(node, ast.UnaryOp):
                if isinstance(node.op, ast.Not):
                    truthiness(node.operand, held)
                    return None
                return taint_of(node.operand, held)
            if isinstance(node, ast.Compare):
                ts = [taint_of(node.left, held)] + [
                    taint_of(c, held) for c in node.comparators
                ]
                # identity tests never inspect the value — `x is None`
                # on a device tensor is sync-free
                if all(isinstance(op, (ast.Is, ast.IsNot))
                       for op in node.ops):
                    return None
                return "dev" if "dev" in ts else None
            if isinstance(node, ast.IfExp):
                truthiness(node.test, held)
                bt = taint_of(node.body, held)
                ot = taint_of(node.orelse, held)
                return "dev" if "dev" in (bt, ot) else None
            if isinstance(node, (ast.Tuple, ast.List)):
                ts = [taint_of(e, held) for e in node.elts]
                return "dev" if "dev" in ts else None
            if isinstance(node, ast.BoolOp):
                ts = [taint_of(v, held) for v in node.values]
                return "dev" if "dev" in ts else None
            if isinstance(node, ast.Starred):
                return taint_of(node.value, held)
            if isinstance(node, (ast.JoinedStr, ast.FormattedValue)):
                for child in ast.iter_child_nodes(node):
                    taint_of(child, held)
                return None
            if isinstance(node, (ast.ListComp, ast.SetComp,
                                 ast.GeneratorExp, ast.DictComp)):
                # generators bind before the element expression runs,
                # so a device iterable taints its comprehension target
                def bind(t: ast.AST) -> None:
                    if isinstance(t, ast.Name):
                        tainted.add(t.id)
                    elif isinstance(t, (ast.Tuple, ast.List)):
                        for e in t.elts:
                            bind(e)
                for comp in node.generators:
                    if taint_of(comp.iter, held) == "dev":
                        sync(node.lineno, "iteration",
                             "comprehension over a device tensor",
                             held)
                        bind(comp.target)
                    for cond in comp.ifs:
                        taint_of(cond, held)
                if isinstance(node, ast.DictComp):
                    taint_of(node.key, held)
                    taint_of(node.value, held)
                else:
                    taint_of(node.elt, held)
                return None
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    taint_of(child, held)
            return None

        def sync(line: int, kind: str, what: str, held: tuple) -> None:
            fs.events.append(
                _SyncEvent(IMPLICIT_SYNC, kind, line, what, held)
            )

        def transfer(line: int, kind: str, what: str,
                     held: tuple) -> None:
            fs.events.append(
                _SyncEvent(TRANSFER_DISCIPLINE, kind, line, what, held)
            )

        def device_target(call: ast.Call) -> str | None:
            """'cpu' | 'device' | None (a dtype or tensor argument) for
            ``.to(...)``."""
            cands = [k.value for k in call.keywords if k.arg == "device"]
            cands += call.args[:1]
            for c in cands:
                if isinstance(c, ast.Constant) and isinstance(
                    c.value, str
                ):
                    return "cpu" if c.value == "cpu" else "device"
                if isinstance(c, ast.Call) and _dotted(c.func) == (
                    "torch.device"
                ):
                    if c.args and isinstance(c.args[0], ast.Constant) \
                            and c.args[0].value == "cpu":
                        return "cpu"
                    return "device"
                t = _terminal(c) or ""
                if "device" in t.lower() or t in ("dev", "_dev"):
                    return "device"
            return None

        def cpu_device_kw(call: ast.Call) -> bool:
            for k in call.keywords:
                if k.arg == "device":
                    v = k.value
                    return isinstance(v, ast.Constant) and v.value == "cpu"
            return False

        def call_taint(call: ast.Call, held: tuple) -> str | None:
            func = call.func
            d = _dotted(func) or ""
            name = func.id if isinstance(func, ast.Name) else None
            arg_taints = [taint_of(a, held) for a in call.args]
            kw_taints = [taint_of(k.value, held) for k in call.keywords]
            a0 = arg_taints[0] if arg_taints else None
            any_dev = "dev" in arg_taints or "dev" in kw_taints
            has_device_kw = any(k.arg == "device" for k in call.keywords)
            attr = func.attr if isinstance(func, ast.Attribute) else None

            # ---- device→host sync sinks
            if d in ("np.asarray", "np.array", "numpy.asarray",
                     "numpy.array"):
                if a0 == "dev":
                    sync(call.lineno, d.split(".")[0] + "."
                         + d.split(".")[-1],
                         f"{d}() on a device tensor", held)
                return "host_np" if a0 == "dev" else None
            if name in _SYNC_BUILTINS:
                if a0 == "dev":
                    sync(call.lineno, f"{name}()",
                         f"{name}() on a device value", held)
                return None
            if d in ("torch.cuda.synchronize", "cuda.synchronize"):
                sync(call.lineno, "cuda.synchronize",
                     "torch.cuda.synchronize() waits for the card",
                     held)
                return None
            if attr == "synchronize":
                taint_of(func.value, held)
                sync(call.lineno, ".synchronize()",
                     f"{d or '.synchronize'}() waits for the card",
                     held)
                return None
            if attr in _SYNC_METHODS:
                base_t = taint_of(func.value, held)
                if base_t == "dev":
                    sync(call.lineno, f".{attr}()",
                         f".{attr}() on a device tensor", held)
                    return "host_np" if attr in ("cpu", "numpy") else None
                return base_t if attr == "cpu" else None
            if attr in _DATA_DEP_SHAPES or (
                d.startswith("torch.")
                and d.rsplit(".", 1)[-1] in _DATA_DEP_SHAPES
            ):
                tail = attr if attr in _DATA_DEP_SHAPES else d.rsplit(
                    ".", 1)[-1]
                base_t = (taint_of(func.value, held)
                          if attr is not None and not d.startswith(
                              "torch.") else a0)
                sized = tail == "repeat_interleave" and any(
                    k.arg == "output_size" for k in call.keywords
                )
                if (base_t == "dev" or any_dev) and not sized:
                    sync(call.lineno, f"{tail}()",
                         f"{tail}() on a device tensor has a "
                         "data-dependent shape the host must read back",
                         held)
                    return "dev"
                if base_t == "dev" or any_dev:
                    return "dev"
            if attr == "to":
                base_t = taint_of(func.value, held)
                tgt = device_target(call)
                if tgt == "cpu":
                    if base_t == "dev":
                        sync(call.lineno, ".to(cpu)",
                             ".to('cpu') of a device tensor", held)
                    return "host_np" if base_t == "dev" else None
                if tgt == "device":
                    if base_t != "dev":
                        transfer(call.lineno, "device_put",
                                 ".to(<device>) of a host value "
                                 "uploads it", held)
                    return "dev"
                return base_t
            if attr == "cuda" and not d.startswith("torch."):
                if taint_of(func.value, held) != "dev":
                    transfer(call.lineno, "device_put",
                             ".cuda() of a host value uploads it", held)
                return "dev"

            # ---- host→device transfer sinks
            if d in _TORCH_UPLOADS:
                if call.args and a0 != "dev":
                    tail = d.rsplit(".", 1)[-1]
                    transfer(call.lineno, "upload",
                             f"torch.{tail}() uploads a host array",
                             held)
                    return ("host_np" if cpu_device_kw(call)
                            else "dev")
                return "dev"
            if d.startswith(_TORCH_HOST_PREFIXES) or d in (
                _TORCH_HOST_CALLS
            ):
                return None
            if d.startswith("torch."):
                # a factory given a device, or an op given a tensor,
                # stays device-side; anything else is a host tensor
                if any_dev or (has_device_kw and not cpu_device_kw(call)):
                    return "dev"
                return None

            # ---- np scalar ctors (host-side; upload checked at calls
            # into compiled callables)
            head = d.split(".")[0] if d else ""
            if head in ("np", "numpy") and d.rsplit(".", 1)[-1] in (
                _NP_SCALAR_CTORS
            ):
                return "host_np"

            # ---- compiled callables (torch.compile / torch.jit)
            if name is not None and self._is_jit_name(m, name):
                for i, t in enumerate(arg_taints):
                    if t == "host_np":
                        transfer(
                            call.lineno, "scalar-upload",
                            f"np scalar fed to compiled '{name}' "
                            f"(argument {i}) uploads per call", held,
                        )
                return "dev"

            # ---- the kernel wrappers return device tensors
            if name is not None and self._is_kernel_symbol(m, name):
                return "dev"
            if (
                isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and self._is_kernel_module(m, func.value.id)
            ):
                return "dev"

            # ---- the model-predict convention: predict wrappers are
            # score surfaces returning device labels (the host-native
            # variants overapproximate to device, which is the safe
            # direction — their conversions are then no-ops)
            if (name in ("predict", "_predict")) or (
                isinstance(func, ast.Attribute)
                and func.attr.endswith("predict")
            ):
                if isinstance(func, ast.Attribute):
                    taint_of(func.value, held)
                return "dev"

            # ---- project calls: return taint and parameter-taint
            # propagation (constructor calls resolve to __init__, so a
            # device argument taints the attribute the ctor stores it in)
            dev_result = False
            called = name or _terminal(func)
            for callee in line_calls.get(call.lineno, ()):
                cs = self.fn_sync.get(callee)
                csum = self.lock.summaries.get(callee)
                if cs is None or csum is None:
                    continue
                if csum.name != called and csum.name != "__init__":
                    continue
                offset = 1 if csum.cls is not None else 0
                for i, t in enumerate(arg_taints):
                    if t != "dev":
                        continue
                    slot = self.param_taint.setdefault(callee, set())
                    if isinstance(call.args[i], ast.Starred):
                        # *args of a device-tainted container: the
                        # positional mapping is unknowable — taint
                        # every callee parameter
                        want = set(range(offset,
                                         len(csum.node.args.args)))
                    else:
                        want = {i + offset}
                    if not want <= slot:
                        slot |= want
                        self._pt_dirty = True
                # keyword arguments flow by name (how a read object's
                # constructor carries device handles the device stage
                # later converts)
                callee_params = (csum.node.args.posonlyargs
                                 + csum.node.args.args
                                 + csum.node.args.kwonlyargs)
                for kw, kt in zip(call.keywords, kw_taints):
                    if kw.arg is None or kt != "dev":
                        continue
                    for pi, p in enumerate(callee_params):
                        if p.arg == kw.arg:
                            slot = self.param_taint.setdefault(
                                callee, set()
                            )
                            if pi not in slot:
                                slot.add(pi)
                                self._pt_dirty = True
                            break
                if csum.name != "__init__" and cs.returns_device:
                    dev_result = True
            if dev_result:
                return "dev"
            if called in self.pytree_classes:
                return "dev"  # constructing a device record

            # method call on a device value keeps it device-side
            if isinstance(func, ast.Attribute):
                if taint_of(func.value, held) == "dev":
                    return (None if func.attr in _HOST_META_METHODS
                            else "dev")
            return None

        def assign_target(t: ast.AST, value_taint: str | None,
                          value: ast.AST | None = None) -> None:
            if isinstance(t, ast.Name):
                tainted.discard(t.id)
                host_np.discard(t.id)
                masks.discard(t.id)
                if value_taint == "dev":
                    tainted.add(t.id)
                    if value is not None and is_mask(value):
                        masks.add(t.id)
                elif value_taint == "host_np":
                    host_np.add(t.id)
            elif isinstance(t, ast.Attribute):
                bnd = binding(t)
                if bnd is not None:
                    if value_taint == "dev" and bnd.startswith("self."):
                        fs.device_attr_writes.add(t.attr)
            elif isinstance(t, (ast.Tuple, ast.List)):
                for e in t.elts:
                    assign_target(e, value_taint)
            elif isinstance(t, ast.Starred):
                assign_target(t.value, value_taint)

        def truthiness(test: ast.AST, held: tuple) -> None:
            t = taint_of(test, held)
            if t == "dev":
                sync(test.lineno, "truthiness",
                     "truth test on a device value", held)

        def visit_stmt(node: ast.AST, held: tuple) -> None:
            if isinstance(node, ast.ClassDef):
                return  # nested classes get their own summaries
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # a nested def is a closure over the enclosing frame
                # and runs on the enclosing hot path (watchdog bodies,
                # worker thunks) — charge its syncs here, with the
                # enclosing taint env resolving its free variables
                for child in node.body:
                    visit_stmt(child, held)
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                new_held = held
                opened = 0
                for item in node.items:
                    expr = item.context_expr
                    taint_of(expr, new_held)
                    key = self.lock._lock_key(expr, m, cls)
                    if key is not None:
                        new_held = new_held + ((key, expr.lineno),)
                    stream_arg = None
                    if _is_stream_ctx(expr):
                        stream_arg = expr.args[0] if expr.args else None
                    elif isinstance(expr, ast.Name) and (
                        expr.id in stream_ctx_names
                    ):
                        stream_arg = stream_ctx_names[expr.id] or expr
                    if stream_arg is not None and not (
                        isinstance(stream_arg, ast.Name)
                        and stream_arg.id in same_stream
                    ):
                        outside = frozenset(tainted) | frozenset(
                            f"self.{a}" for a in self.device_attrs.get(
                                (m.display_path, cls), ()
                            )
                        ) if cls is not None else frozenset(tainted)
                        stream_blocks.append((
                            expr.lineno,
                            ast.unparse(expr), outside,
                        ))
                        opened += 1
                    if item.optional_vars is not None:
                        assign_target(item.optional_vars, None)
                for child in node.body:
                    visit_stmt(child, new_held)
                for _ in range(opened):
                    stream_blocks.pop()
                return
            if isinstance(node, ast.Assign):
                vt = taint_of(node.value, held)
                for t in node.targets:
                    assign_target(t, vt, node.value)
                return
            if isinstance(node, ast.AnnAssign):
                vt = taint_of(node.value, held) if node.value else None
                if vt is None and _is_tensor_annotation(node.annotation):
                    vt = "dev" if node.value is not None else None
                assign_target(node.target, vt, node.value)
                return
            if isinstance(node, ast.AugAssign):
                vt = taint_of(node.value, held)
                tt = taint_of(node.target, held)
                assign_target(
                    node.target, "dev" if "dev" in (vt, tt) else vt
                )
                return
            if isinstance(node, ast.Return):
                if node.value is not None:
                    if taint_of(node.value, held) == "dev":
                        fs.returns_device = True
                return
            if isinstance(node, (ast.If, ast.While)):
                truthiness(node.test, held)
                for child in node.body:
                    visit_stmt(child, held)
                for child in node.orelse:
                    visit_stmt(child, held)
                return
            if isinstance(node, (ast.For, ast.AsyncFor)):
                it = taint_of(node.iter, held)
                if it == "dev":
                    sync(node.iter.lineno, "iteration",
                         "for-loop over a device tensor", held)
                assign_target(node.target,
                              "dev" if it == "dev" else None)
                for child in node.body:
                    visit_stmt(child, held)
                for child in node.orelse:
                    visit_stmt(child, held)
                return
            if isinstance(node, ast.Try):
                for seq in (node.body, node.orelse, node.finalbody):
                    for child in seq:
                        visit_stmt(child, held)
                for h in node.handlers:
                    for child in h.body:
                        visit_stmt(child, held)
                return
            if isinstance(node, ast.Expr):
                taint_of(node.value, held)
                return
            if isinstance(node, (ast.Assert,)):
                truthiness(node.test, held)
                return
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.stmt):
                    visit_stmt(child, held)
                elif isinstance(child, ast.expr):
                    taint_of(child, held)

        for child in fn.body:
            visit_stmt(child, ())
        return fs

    # -- hot-path reachability ----------------------------------------------
    def _compute_hot(self) -> None:
        frontier: list[int] = []
        for key, s in self.lock.summaries.items():
            if _is_hot_root(s):
                self.hot[key] = (self._qual(s),)
                frontier.append(key)
        while frontier:
            nxt: list[int] = []
            for key in frontier:
                s = self.lock.summaries[key]
                chain = self.hot[key]
                for callee, _line, _held in s.calls:
                    if callee in self.hot:
                        continue
                    c = self.lock.summaries.get(callee)
                    if c is None:
                        continue
                    self.hot[callee] = chain + (self._qual(c),)
                    nxt.append(callee)
            frontier = nxt

    def reachable_from(self, specs: Sequence[tuple]) -> set[int]:
        seen: set[int] = set()
        frontier = [
            key for key, s in self.lock.summaries.items()
            if any(_root_match(s, spec) for spec in specs)
        ]
        seen.update(frontier)
        while frontier:
            nxt = []
            for key in frontier:
                for callee, _line, _held in (
                    self.lock.summaries[key].calls
                ):
                    if callee not in seen and (
                        callee in self.lock.summaries
                    ):
                        seen.add(callee)
                        nxt.append(callee)
            frontier = nxt
        return seen

    @staticmethod
    def _qual(s) -> str:
        return (f"{s.mod.display_path}::"
                + (f"{s.cls}." if s.cls else "") + s.name)

    # -- sync closures (for sync-under-lock) --------------------------------
    def _compute_sync_closures(self) -> None:
        for key, s in self.lock.summaries.items():
            own: dict = {}
            fs = self.fn_sync.get(key)
            if fs is not None:
                for ev in fs.events:
                    own.setdefault(
                        (s.mod.display_path, ev.line, ev.kind),
                        [(s.mod.display_path, ev.line,
                          f"syncs via {ev.kind}")],
                    )
            self.sync_closure[key] = own
        changed = True
        while changed:
            changed = False
            for key, s in self.lock.summaries.items():
                mine = self.sync_closure[key]
                for callee, line, _held in s.calls:
                    sub = self.sync_closure.get(callee)
                    if not sub:
                        continue
                    c = self.lock.summaries[callee]
                    hop = (s.mod.display_path, line,
                           f"calls {c.cls + '.' if c.cls else ''}"
                           f"{c.name}")
                    for skey, chain in sub.items():
                        if skey not in mine:
                            mine[skey] = [hop, *chain]
                            changed = True


_SYNC_CACHE: list[tuple[tuple[int, ...], _SyncAnalysis]] = []


def sync_analyze(modules: Sequence[ModuleInfo]) -> _SyncAnalysis:
    key = tuple(id(m) for m in modules)
    for k, a in _SYNC_CACHE:
        if k == key:
            return a
    a = _SyncAnalysis(modules)
    _SYNC_CACHE.append((key, a))
    del _SYNC_CACHE[:-4]
    return a


def _hot_chain_text(chain: Sequence[str]) -> str:
    return " -> ".join(chain)


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


def _discipline_of(reason: str | None) -> str | None:
    if not reason:
        return None
    for d in DISCIPLINES:
        if d in reason:
            return d
    return None


class ImplicitSyncRule(Rule):
    id = IMPLICIT_SYNC
    description = (
        "no device→host sync (np.asarray/.item()/int()/float()/bool()/"
        "len()/truthiness/iteration on a device value) on a serve "
        "hot path; allowed seams carry a suppression naming their "
        "deferral discipline"
    )

    def check_project(
        self, modules: Sequence[ModuleInfo]
    ) -> Iterator[Finding]:
        a = sync_analyze(modules)
        seen: set[tuple] = set()
        for key, chain in a.hot.items():
            s = a.lock.summaries[key]
            fs = a.fn_sync.get(key)
            if fs is None:
                continue
            for ev in fs.events:
                if ev.rule != IMPLICIT_SYNC:
                    continue
                fkey = (s.mod.display_path, ev.line, ev.kind)
                if fkey in seen:
                    continue
                seen.add(fkey)
                yield self.finding(
                    _mod_proxy(modules, s.mod.display_path), ev.line,
                    f"{ev.what} on the serve hot path (hot via "
                    f"{_hot_chain_text(chain)}) blocks the tick on "
                    "the device — defer it off the dispatch edge, or "
                    "allowlist it with a reasoned suppression naming "
                    f"its discipline ({', '.join(DISCIPLINES)})",
                )
        # allowlist policy: a suppression of the sync rules whose
        # reason names no deferral discipline is a bad suppression —
        # the allowlist must say HOW the sync stays off the tick, not
        # just that someone wanted it quiet. Emitted as
        # bad-suppression, which cannot itself be suppressed.
        for mod in modules:
            for s in mod.suppressions.values():
                if not {IMPLICIT_SYNC, TRANSFER_DISCIPLINE} & set(
                    s.ids
                ):
                    continue
                if _discipline_of(s.reason) is None:
                    yield Finding(
                        BAD_SUPPRESSION, mod.display_path, s.line,
                        "sync allowlist entry must name its deferral "
                        "discipline in the reason — one of: "
                        + ", ".join(DISCIPLINES),
                    )


class TransferDisciplineRule(Rule):
    id = TRANSFER_DISCIPLINE
    description = (
        "no per-tick host→device upload (torch.as_tensor/torch.tensor of "
        "a host value, .to(<device>)/.cuda() of a host tensor, np "
        "scalar fed to a compiled call) on a serve hot path "
        "unless routed through a warmup-primed or epoch-cached seam"
    )

    def check_project(
        self, modules: Sequence[ModuleInfo]
    ) -> Iterator[Finding]:
        a = sync_analyze(modules)
        seen: set[tuple] = set()
        for key, chain in a.hot.items():
            s = a.lock.summaries[key]
            fs = a.fn_sync.get(key)
            if fs is None:
                continue
            for ev in fs.events:
                if ev.rule != TRANSFER_DISCIPLINE:
                    continue
                fkey = (s.mod.display_path, ev.line, ev.kind)
                if fkey in seen:
                    continue
                seen.add(fkey)
                yield self.finding(
                    _mod_proxy(modules, s.mod.display_path), ev.line,
                    f"{ev.what} on the serve hot path (hot via "
                    f"{_hot_chain_text(chain)}): a per-tick upload "
                    "re-pays the transfer every tick — cache it on "
                    "device (epoch-cached), prime it at warmup, or "
                    "allowlist it with a reasoned suppression naming "
                    "its discipline",
                )


class DonationHazardRule(Rule):
    id = DONATION_HAZARD
    description = (
        "a tensor made outside a torch.cuda.stream(s) block and used "
        "inside it needs record_stream(s) or a stream fence "
        "(wait_stream/wait_event/synchronize) — else the caching "
        "allocator may hand its memory to a later tick while s reads it"
    )

    def check_project(
        self, modules: Sequence[ModuleInfo]
    ) -> Iterator[Finding]:
        a = sync_analyze(modules)
        seen: set[tuple] = set()
        for key, s in a.lock.summaries.items():
            fs = a.fn_sync.get(key)
            if fs is None:
                continue
            for don in fs.donations:
                fkey = (s.mod.display_path, don.use_line, don.name)
                if fkey in seen:
                    continue
                seen.add(fkey)
                yield self.finding(
                    _mod_proxy(modules, s.mod.display_path),
                    don.use_line,
                    f"'{don.name}' was made outside the "
                    f"'{don.callee}' block opened at line {don.line} "
                    "and is used inside it with no record_stream or "
                    "stream fence — the caching allocator may reuse its "
                    "memory for a later tick while that stream still "
                    "reads it; call record_stream on it or fence the "
                    "stream",
                )


class SyncUnderLockRule(Rule):
    id = SYNC_UNDER_LOCK
    description = (
        "no device sync/transfer while holding a project lock "
        "(directly or transitively): a sync can take arbitrarily long "
        "on a busy device, wedging every thread that takes that lock"
    )

    def check_project(
        self, modules: Sequence[ModuleInfo]
    ) -> Iterator[Finding]:
        a = sync_analyze(modules)
        seen: set[tuple] = set()

        def emit(path: str, line: int, lock: str, kind: str,
                 chain: list) -> Iterator[Finding]:
            fkey = (path, line, lock, kind)
            if fkey in seen:
                return
            seen.add(fkey)
            yield self.finding(
                _mod_proxy(modules, path), line,
                f"device sync/transfer ({kind}) while holding "
                f"{_short(lock)}: {_chain_text(chain)} — a busy "
                "device stalls every thread that takes this lock; "
                "move the sync outside the lock or snapshot under "
                "the lock and sync outside",
            )

        for key, s in a.lock.summaries.items():
            fs = a.fn_sync.get(key)
            if fs is not None:
                for ev in fs.events:
                    for lock, lline in ev.held:
                        yield from emit(
                            s.mod.display_path, ev.line, lock, ev.kind,
                            [(s.mod.display_path, lline,
                              f"acquires {_short(lock)}"),
                             (s.mod.display_path, ev.line,
                              f"syncs via {ev.kind}")],
                        )
            for callee, line, held in s.calls:
                if not held:
                    continue
                sub = a.sync_closure.get(callee)
                if not sub:
                    continue
                c = a.lock.summaries[callee]
                hop = (s.mod.display_path, line,
                       f"calls {c.cls + '.' if c.cls else ''}{c.name}")
                for (spath, sline, kind), chain in sub.items():
                    for lock, lline in held:
                        yield from emit(
                            spath, sline, lock, kind,
                            [(s.mod.display_path, lline,
                              f"acquires {_short(lock)}"),
                             hop, *chain],
                        )


GRAFTSYNC_RULES = (
    ImplicitSyncRule,
    TransferDisciplineRule,
    DonationHazardRule,
    SyncUnderLockRule,
)


# ---------------------------------------------------------------------------
# the sync-budget export (the artifact + the runtime witness's input)
# ---------------------------------------------------------------------------


BUDGET_SCHEMA_VERSION = 1


def _suppression_for(mod: ModuleInfo, line: int) -> tuple | None:
    """The (discipline, reason) of a sync-rule suppression covering
    ``line`` (same enclosing-statement widening the framework uses),
    or None."""
    end = mod._stmt_end.get(line, line)
    for ln in range(line, end + 1):
        s = mod.suppressions.get(ln)
        if s is None:
            continue
        if not {IMPLICIT_SYNC, TRANSFER_DISCIPLINE} & set(s.ids):
            continue
        d = _discipline_of(s.reason)
        if d is not None:
            return d, s.reason
    return None


def build_sync_report(modules: Sequence[ModuleInfo]) -> dict:
    """The per-tick expected-sync ledger as a JSON-ready dict:
    hot-function spans, every allowlisted sync site with its
    discipline/reason, and the per-serve-path ledgers. Committed as
    ``docs/artifacts/torch_hot_path_sync_budget.json`` (generated from the
    repo root) and kept current by a tier-1 test the way
    ``torch_lock_order_graph.json`` is; ``utils/syncguard.py`` cross-checks
    observed runtime syncs against it by construction site."""
    a = sync_analyze(modules)
    by_path = {m.display_path: m for m in modules}

    hot_functions: dict[str, dict] = {}
    spans: dict[str, list[list[int]]] = {}
    for key, chain in sorted(
        a.hot.items(), key=lambda kv: kv[1]
    ):
        s = a.lock.summaries[key]
        qual = a._qual(s)
        node = s.node
        hot_functions[qual] = {
            "path": s.mod.display_path.replace(os.sep, "/"),
            "lines": [node.lineno, node.end_lineno or node.lineno],
            "hot_via": list(chain),
        }
        spans.setdefault(
            s.mod.display_path.replace(os.sep, "/"), []
        ).append([node.lineno, node.end_lineno or node.lineno])
    for p in spans:
        spans[p].sort()

    allowed: list[dict] = []
    site_index: dict[int, list[str]] = {}  # summary key → its sites
    for key in a.hot:
        s = a.lock.summaries[key]
        fs = a.fn_sync.get(key)
        mod = by_path.get(s.mod.display_path)
        if fs is None or mod is None:
            continue
        for ev in fs.events:
            sup = _suppression_for(mod, ev.line)
            if sup is None:
                continue
            site = (f"{s.mod.display_path.replace(os.sep, '/')}"
                    f":{ev.line}")
            entry = {
                "site": site,
                "rule": ev.rule,
                "kind": ev.kind,
                "discipline": sup[0],
                "reason": sup[1],
                "function": a._qual(s),
                "count_per_tick": 1,
            }
            if not any(e["site"] == site and e["kind"] == ev.kind
                       for e in allowed):
                allowed.append(entry)
            site_index.setdefault(key, []).append(site)
    allowed.sort(key=lambda e: (e["site"], e["kind"]))

    serve_paths: dict[str, list[dict]] = {}
    for path_name, specs in _SERVE_PATH_ROOTS.items():
        reach = a.reachable_from(specs)
        ledger: list[dict] = []
        for key in sorted(reach & set(site_index)):
            for site in site_index[key]:
                for e in allowed:
                    if e["site"] == site and not any(
                        le["site"] == site and le["kind"] == e["kind"]
                        for le in ledger
                    ):
                        ledger.append({
                            "site": site,
                            "kind": e["kind"],
                            "count_per_tick": e["count_per_tick"],
                            "reason": e["reason"],
                        })
        serve_paths[path_name] = sorted(
            ledger, key=lambda e: (e["site"], e["kind"])
        )

    return {
        "schema_version": BUDGET_SCHEMA_VERSION,
        "hot_roots": sorted(
            a._qual(a.lock.summaries[key])
            for key, chain in a.hot.items() if len(chain) == 1
        ),
        "hot_functions": hot_functions,
        "hot_spans": spans,
        "allowed_syncs": allowed,
        "serve_paths": serve_paths,
        "disciplines": list(DISCIPLINES),
    }

"""syncguard: a runtime witness for the port's host↔device boundary.

The static side (``analysis_static/graftsync.py``) proves the serve
hot paths sync-clean over the calls it can SEE and exports the
expected-sync ledger (``docs/artifacts/torch_hot_path_sync_budget.json``);
this module is the dynamic cross-check, in the locktrace mold. Opt-in
(``TCSDN_SYNCGUARD=1`` around ``cli.main``, or the autouse fixtures of
the port's pipeline/incremental/degrade/drift/openset suites): while
installed, the tensor's conversion seams are wrapped in site-keyed
counting shims —

- ``np.asarray``/``np.array`` of a tensor (``Tensor.__array__``)
                                      → ``kind="np.asarray"``,
- ``Tensor.numpy``/``.cpu()``/``.tolist()``/``.item()``
                                      → ``.numpy()``/``.cpu()``/
                                        ``.tolist()``/``.item()``,
- ``Tensor.to(<cpu>)`` of a card tensor → ``.to(cpu)`` (a ``.to`` onto
  the tensor's own device moves nothing and is not counted),
- scalarization and iteration: ``bool()``/``int()``/``float()``/
  ``operator.index`` and ``for`` over a tensor (the ``__bool__``/
  ``__int__``/``__float__``/``__index__``/``__iter__`` dunders)
                                      → ``bool()``/``int()``/
                                        ``float()``/``index``/
                                        ``iteration``,
- ``torch.as_tensor``/``torch.tensor``/``torch.asarray`` of a host
  value                               → a host→device upload
                                        (``kind="upload"``),
- ``Tensor.to(<device>)``/``.cuda()`` of a host tensor
                                      → an explicit upload
                                        (``kind="device_put"``),

each attributed to its nearest in-scope CALL SITE (``file:line`` — the
same key the static pass stamps into the budget's ``allowed_syncs``):
the first frame above the shim that is not torch's, numpy's or a
witness's own, counted only when that frame is the port's. Conversions
of CPU tensors count too, so the CPU suites exercise the witness (on
the card the same lines move data across PCIe); the conversions that
really crossed between a card and the host are counted apart as well
(``device_counts``: a card tensor read back, an upload onto a card),
which is the census of a serve on the card. ``len()`` of a tensor
reads its shape and is not a seam. A sync observed inside a static hot
span whose site is not on the allowlist is a violation: either a hot
path regressed, or the static resolver has a hole (exactly
locktrace's unknown-edge contract). Violations land in the flight
recorder as ``syncguard.violation`` events, recorded strictly AFTER the
witness's own bookkeeping lock (``_meta``, a leaf) is released.

Unlike a ``jax.Array``, whose scalarization never routes through a
patchable Python callable, a torch tensor's dunders are class
attributes of ``torch.Tensor``: the runtime half covers scalarization,
and both halves cross-check by site. What it still cannot see is a sync
inside a C++ op (``nonzero``, boolean-mask indexing, ``torch.unique``):
``TCSDN_SYNCGUARD_TG`` covers those on a card. Set to ``log`` it arms
``torch.cuda.set_sync_debug_mode("warn")`` (``disallow``: ``"error"``),
only when a card is present; each warning the mode raises is recorded
(``simplefilter("always")``) against the nearest in-package frame of
the stack and reported as ``cuda_sync`` counts beside the shims'.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import warnings

from .locktrace import _PKG_NAME, _REPO_ROOT, _site_key

DEFAULT_BUDGET_PATH = os.path.join(
    _REPO_ROOT, "docs", "artifacts", "torch_hot_path_sync_budget.json"
)
ENV_FLAG = "TCSDN_SYNCGUARD"
ENV_TRANSFER_GUARD = "TCSDN_SYNCGUARD_TG"
# finish() also writes its report there as JSON (a serve in a process of
# its own hands its census back this way)
ENV_OUT = "TCSDN_SYNCGUARD_OUT"

# device→host kinds vs host→device kinds (report bookkeeping only —
# the allowlist check keys on site, not kind: a site the static pass
# blessed for one boundary direction is its seam either way)
D2H_KINDS = ("np.asarray", ".numpy()", ".cpu()", ".tolist()", ".item()",
             ".to(cpu)", "bool()", "int()", "float()", "index",
             "iteration")
H2D_KINDS = ("upload", "device_put")

# the Tensor attributes the shims replace → the kind each reports
_METHOD_KINDS = {
    "__array__": "np.asarray", "numpy": ".numpy()", "cpu": ".cpu()",
    "tolist": ".tolist()", "item": ".item()", "__bool__": "bool()",
    "__int__": "int()", "__float__": "float()", "__index__": "index",
    "__iter__": "iteration",
}
_UPLOADS = ("as_tensor", "tensor", "asarray")

# frames skipped on the way up to the call site: torch's and numpy's
# own Python code, and any witness shim (this one, or another
# package's installed beneath it)
_SKIP_DIRS: tuple[str, ...] = ()
_SKIP_SUFFIXES = ("utils/syncguard.py",)


def _skip_dirs() -> tuple[str, ...]:
    global _SKIP_DIRS
    if not _SKIP_DIRS:
        import numpy
        import torch

        _SKIP_DIRS = tuple(
            os.path.dirname(os.path.abspath(m.__file__)).replace(
                os.sep, "/") + "/"
            for m in (torch, numpy)
        )
    return _SKIP_DIRS


def _record_violation(recorder, violation: dict) -> None:
    """Ring-event form of a violation: the recorder's first positional
    is the EVENT kind, so the sync kind rides as ``sync_kind``."""
    fields = dict(violation)
    fields["sync_kind"] = fields.pop("kind")
    recorder.record("syncguard.violation", **fields)


def _default_scope(filename: str) -> bool:
    norm = filename.replace(os.sep, "/")
    if norm.endswith("utils/syncguard.py"):
        return False
    return f"/{_PKG_NAME}/" in norm or norm.startswith(
        _PKG_NAME + "/"
    )


def _caller_frame(depth: int):
    """The first frame ``depth`` up (or above) that is not torch's,
    numpy's or a witness shim's, or None."""
    skip = _skip_dirs()
    try:
        f = sys._getframe(depth + 1)
    except ValueError:
        return None
    while f is not None:
        fn = f.f_code.co_filename.replace(os.sep, "/")
        if not (fn.startswith(skip) or fn.endswith(_SKIP_SUFFIXES)
                or fn.startswith("<")):
            return f
        f = f.f_back
    return None


class SyncWitness:
    """Site-keyed sync counts + the live allowlist check."""

    def __init__(self, budget: dict | None = None, recorder=None,
                 scope=None):
        self.active = True
        self.recorder = recorder  # obs.FlightRecorder, attached late
        self.scope = scope if scope is not None else _default_scope
        self._meta = threading.Lock()  # leaf: guards the counts only
        self._local = threading.local()
        self._counts: dict[str, dict[str, int]] = {}
        self._device_counts: dict[str, dict[str, int]] = {}
        self._threads: dict[str, set[str]] = {}
        self._cuda: dict[str, int] = {}
        self._violations: list[dict] = []
        self._flagged: set[str] = set()
        # parsed budget: hot spans by path + the allowed site set
        self._spans: dict[str, list[tuple[int, int]]] = {}
        self._allowed: set[str] = set()
        if budget is not None:
            for path, spans in budget.get("hot_spans", {}).items():
                self._spans[path] = [(int(a), int(b)) for a, b in spans]
            for entry in budget.get("allowed_syncs", ()):
                self._allowed.add(entry["site"])

    # -- reentrancy: a shim calling into torch must not re-count --------
    def _enter(self) -> bool:
        if getattr(self._local, "in_shim", False):
            return False
        self._local.in_shim = True
        return True

    def _exit(self) -> None:
        self._local.in_shim = False

    # -- site attribution ------------------------------------------------
    def _find_site(self, depth: int = 2) -> str | None:
        """The call site of the patched seam: the first frame above it
        that is not torch's, numpy's or a witness shim's (torch's own
        Python — ``__format__`` calling ``.item()``, ``__array__``
        calling ``.numpy()`` — is walked through to the line that
        asked). Counted only when that frame is in scope: a conversion
        a test or another package makes is not the port's seam."""
        f = _caller_frame(depth)
        if f is None:
            return None
        fn = f.f_code.co_filename
        if self.scope(fn):
            return _site_key(fn, f.f_lineno)
        return None

    def _split(self, site: str) -> tuple[str, int]:
        path, _, line = site.rpartition(":")
        return path, int(line)

    def _in_hot_span(self, path: str, line: int) -> bool:
        # path-suffix tolerant: the package witness normalizes to
        # pkg-relative paths (matching a pkg-anchored budget exactly);
        # a tmp-dir fixture budget keys bare filenames the observed
        # absolute path must still find
        for bp, spans in self._spans.items():
            if path == bp or path.endswith("/" + bp):
                if any(lo <= line <= hi for lo, hi in spans):
                    return True
        return False

    def _site_allowed(self, path: str, line: int) -> bool:
        for site in self._allowed:
            ap, al = self._split(site)
            if al == line and (path == ap or path.endswith("/" + ap)):
                return True
        return False

    def note_sync(self, kind: str, site: str | None,
                  on_device: bool = False) -> None:
        """One conversion of ``kind`` at ``site``; ``on_device`` when it
        moved data between a card and the host (a card tensor read back,
        an upload to a card) — a real sync, counted apart as well."""
        if not self.active or site is None:
            return
        path, line = self._split(site)
        fresh = None
        thread = threading.current_thread().name
        with self._meta:
            per = self._counts.setdefault(site, {})
            per[kind] = per.get(kind, 0) + 1
            if on_device:
                dev = self._device_counts.setdefault(site, {})
                dev[kind] = dev.get(kind, 0) + 1
            self._threads.setdefault(site, set()).add(thread)
            if (
                self._spans
                and site not in self._flagged
                and self._in_hot_span(path, line)
                and not self._site_allowed(path, line)
            ):
                self._flagged.add(site)
                fresh = {"site": site, "kind": kind, "thread": thread}
                self._violations.append(fresh)
        recorder = self.recorder
        if fresh is not None and recorder is not None:
            # strictly AFTER _meta is released: the recorder's ring
            # lock is traced project state — the witness stays a leaf
            _record_violation(recorder, fresh)

    def note_cuda_sync(self, site: str | None) -> None:
        """One warning of ``torch.cuda.set_sync_debug_mode("warn")``,
        keyed by the nearest in-package frame (None: none in scope)."""
        if not self.active:
            return
        key = site if site is not None else "<outside the package>"
        with self._meta:
            self._cuda[key] = self._cuda.get(key, 0) + 1

    # -- results -----------------------------------------------------------
    @property
    def violations(self) -> list[dict]:
        with self._meta:
            return list(self._violations)

    def counts(self) -> dict[str, dict[str, int]]:
        with self._meta:
            return {s: dict(k) for s, k in self._counts.items()}

    def cuda_counts(self) -> dict[str, int]:
        with self._meta:
            return dict(self._cuda)

    def report(self) -> dict:
        with self._meta:
            return {
                "counts": {
                    s: dict(k) for s, k in sorted(self._counts.items())
                },
                "device_counts": {
                    s: dict(k)
                    for s, k in sorted(self._device_counts.items())
                },
                "threads": {
                    s: sorted(t) for s, t in sorted(self._threads.items())
                },
                "cuda_sync": dict(sorted(self._cuda.items())),
                "violations": list(self._violations),
            }

    def check_against(self, budget: dict | None) -> dict:
        """Re-run the allowlist check over everything observed —
        the post-hoc form of the live check, for a budget loaded
        after the fact (mirrors locktrace ``check_against``). The
        CUDA sync-debug sites come back as ``unbudgeted_cuda_syncs``:
        every site the card's own mode saw that the budget does not
        list, with whether it lies in a hot span."""
        if budget is None:
            return {"unknown_syncs": [], "unbudgeted_cuda_syncs": [],
                    "checked": False}
        probe = SyncWitness(budget=budget)
        unknown = []
        for site, kinds in self.counts().items():
            path, line = probe._split(site)
            if probe._in_hot_span(path, line) and not (
                probe._site_allowed(path, line)
            ):
                unknown.append({
                    "site": site, "kinds": dict(kinds),
                })
        cuda = []
        for site, n in self.cuda_counts().items():
            if ":" not in site:
                cuda.append({"site": site, "count": n, "hot": False})
                continue
            path, line = probe._split(site)
            if not probe._site_allowed(path, line):
                cuda.append({"site": site, "count": n,
                             "hot": probe._in_hot_span(path, line)})
        return {
            "unknown_syncs": sorted(unknown, key=lambda u: u["site"]),
            "unbudgeted_cuda_syncs": sorted(cuda,
                                            key=lambda u: u["site"]),
            "checked": True,
        }


# ---------------------------------------------------------------------------
# installation: patch the conversion seams
# ---------------------------------------------------------------------------

_installed: SyncWitness | None = None
# (owner, attribute) → the value it had in owner.__dict__, or _ABSENT
_saved: dict[tuple[object, str], object] = {}
_ABSENT = object()
_tg_prev: dict | None = None


def _is_cpu_target(args, kwargs) -> bool | None:
    """Where ``Tensor.to(...)`` sends the tensor: True for the CPU,
    False for another device, None when no device is named (a dtype
    conversion)."""
    import torch

    cands = [kwargs.get("device")] + list(args[:1])
    for c in cands:
        if isinstance(c, torch.Tensor):
            return c.device.type == "cpu"
        if isinstance(c, (str, torch.device)):
            try:
                return torch.device(c).type == "cpu"
            except (RuntimeError, TypeError):
                return None
        if isinstance(c, int) and not isinstance(c, bool):
            return False
    return None


def _patch(owner, name: str, value) -> None:
    _saved[(owner, name)] = owner.__dict__.get(name, _ABSENT)
    setattr(owner, name, value)


def install(witness: SyncWitness) -> None:
    """Monkeypatch the conversion seams with counting shims. The
    patched callables behave identically (same return, same raise) —
    the witness only observes."""
    global _installed
    if _installed is not None:
        raise RuntimeError("syncguard already installed")
    import torch

    tensor = torch.Tensor

    def _note(kind: str, on_device: bool = False) -> None:
        witness.note_sync(kind, witness._find_site(depth=3), on_device)

    def method_shim(real, kind: str):
        def shim(self, *args, **kwargs):
            if witness._enter():
                try:
                    _note(kind, self.device.type != "cpu")
                    return real(self, *args, **kwargs)
                finally:
                    witness._exit()
            return real(self, *args, **kwargs)

        shim.__name__ = getattr(real, "__name__", kind)
        return shim

    def to_shim(real):
        def to(self, *args, **kwargs):
            if witness._enter():
                try:
                    # a real move only: .to() onto the tensor's own
                    # device (or a dtype) returns it in place
                    cpu = _is_cpu_target(args, kwargs)
                    on_cpu = self.device.type == "cpu"
                    if cpu is True and not on_cpu:
                        _note(".to(cpu)", True)
                    elif cpu is False and on_cpu:
                        _note("device_put", True)
                    return real(self, *args, **kwargs)
                finally:
                    witness._exit()
            return real(self, *args, **kwargs)

        return to

    def cuda_shim(real):
        def cuda(self, *args, **kwargs):
            if witness._enter():
                try:
                    if self.device.type == "cpu":
                        _note("device_put", True)
                    return real(self, *args, **kwargs)
                finally:
                    witness._exit()
            return real(self, *args, **kwargs)

        return cuda

    def upload_shim(real):
        def shim(data, *args, **kwargs):
            if witness._enter():
                try:
                    if not isinstance(data, torch.Tensor):
                        _note("upload",
                              _is_cpu_target((), kwargs) is False)
                    return real(data, *args, **kwargs)
                finally:
                    witness._exit()
            return real(data, *args, **kwargs)

        shim.__name__ = getattr(real, "__name__", "upload")
        return shim

    for name, kind in _METHOD_KINDS.items():
        _patch(tensor, name, method_shim(getattr(tensor, name), kind))
    _patch(tensor, "to", to_shim(tensor.to))
    _patch(tensor, "cuda", cuda_shim(tensor.cuda))
    for name in _UPLOADS:
        _patch(torch, name, upload_shim(getattr(torch, name)))
    _installed = witness
    _arm_sync_debug(witness)


def uninstall() -> None:
    """Restore the exact originals; the witness goes inactive so any
    shim reference still held (a bound method) stops counting."""
    global _installed
    for (owner, name), value in reversed(list(_saved.items())):
        if value is _ABSENT:
            try:
                delattr(owner, name)
            except AttributeError:
                pass
        else:
            setattr(owner, name, value)
    _saved.clear()
    _disarm_sync_debug()
    if _installed is not None:
        _installed.active = False
    _installed = None


def _arm_sync_debug(witness: SyncWitness) -> None:
    """``TCSDN_SYNCGUARD_TG=log|disallow`` on a card: the CUDA
    sync-debug mode, its warnings recorded by site."""
    global _tg_prev
    level = os.environ.get(ENV_TRANSFER_GUARD)
    if level not in ("log", "disallow"):
        return
    import torch

    if not torch.cuda.is_available():
        return
    prev_show = warnings.showwarning
    prev_filters = list(warnings.filters)

    def showwarning(message, category, filename, lineno, file=None,
                    line=None):
        if "synchronizing CUDA operation" in str(message):
            site = None
            f = sys._getframe(1)
            while f is not None:
                if witness.scope(f.f_code.co_filename):
                    site = _site_key(f.f_code.co_filename, f.f_lineno)
                    break
                f = f.f_back
            witness.note_cuda_sync(site)
            return
        prev_show(message, category, filename, lineno, file, line)

    _tg_prev = {
        "mode": torch.cuda.get_sync_debug_mode(),
        "showwarning": prev_show, "filters": prev_filters,
    }
    warnings.simplefilter("always", UserWarning)
    warnings.showwarning = showwarning
    torch.cuda.set_sync_debug_mode(
        "warn" if level == "log" else "error"
    )


def _disarm_sync_debug() -> None:
    global _tg_prev
    if _tg_prev is None:
        return
    import torch

    torch.cuda.set_sync_debug_mode(_tg_prev["mode"])
    warnings.showwarning = _tg_prev["showwarning"]
    warnings.filters[:] = _tg_prev["filters"]
    warnings._filters_mutated()  # type: ignore[attr-defined]
    _tg_prev = None


class guarding:
    """``with guarding(budget) as witness:`` — scoped
    install/uninstall, the test-fixture idiom."""

    def __init__(self, budget: dict | None = None, recorder=None,
                 scope=None):
        self.witness = SyncWitness(budget=budget, recorder=recorder,
                                   scope=scope)

    def __enter__(self) -> SyncWitness:
        install(self.witness)
        return self.witness

    def __exit__(self, *exc) -> bool:
        uninstall()
        return False


# ---------------------------------------------------------------------------
# budget loading + the CLI env hook
# ---------------------------------------------------------------------------


def load_budget(path: str | None = None) -> dict | None:
    """The exported hot-path sync budget, or None when absent (an
    installed package without the repo's docs tree)."""
    candidate = path or os.environ.get(
        "TCSDN_TORCH_SYNC_BUDGET", DEFAULT_BUDGET_PATH
    )
    try:
        with open(candidate, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def maybe_guard_from_env() -> SyncWitness | None:
    """CLI hook: install the witness when ``TCSDN_SYNCGUARD=1`` (the
    operator opt-in). Returns the witness, or None when the flag is off
    or a witness is already installed."""
    if os.environ.get(ENV_FLAG) != "1" or _installed is not None:
        return None
    witness = SyncWitness(budget=load_budget())
    install(witness)
    return witness


def _write_report(report: dict, path: str | None) -> None:
    if not path:
        return
    from .atomicio import atomic_write_bytes

    atomic_write_bytes(
        path,
        (json.dumps(report, indent=2, sort_keys=True) + "\n").encode(),
    )


def finish(witness: SyncWitness | None, recorder=None) -> dict | None:
    """CLI teardown: uninstall, surface violations (stderr + the
    flight recorder) and the budget cross-check. Returns the report."""
    if witness is None:
        return None
    if _installed is witness:
        uninstall()
    report = witness.report()
    report["cross_check"] = witness.check_against(load_budget())
    _write_report(report, os.environ.get(ENV_OUT))
    for v in report["violations"]:
        print(
            f"SYNCGUARD VIOLATION: {v['kind']} at {v['site']} is "
            "inside a static hot span but not on the allowed-sync "
            f"ledger (thread {v['thread']})",
            file=sys.stderr, flush=True,
        )
        # live-recorded violations (witness.recorder attached) are
        # already in the ring — re-recording would duplicate the event
        if recorder is not None and recorder is not witness.recorder:
            _record_violation(recorder, v)
    return report

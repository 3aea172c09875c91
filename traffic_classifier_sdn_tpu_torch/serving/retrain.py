"""Background retraining and candidate checkpoint rotation for the drift
loop (serving/drift.py) — the port of
``traffic_classifier_sdn_tpu/serving/retrain.py``.

Two halves:

- **Fitting** (``fit_family``): fresh params for any of the six families
  from the drift monitor's recent labeled window, through the port's
  trainers on the given device: forest, gnb, svc and kmeans through
  train/distributed.py on a one-device mesh, logreg and knn through their
  canonical trainers, as in the JAX package. The ``retrain.fit`` fault
  site sits at the entry.
- **Candidate rotation**: candidates are written through
  ``io/checkpoint.save_model`` — staged arrays and an atomic manifest
  commit, so a crash mid-save never publishes a half-written candidate —
  into ``model-<seq>`` directories under the drift directory.
  ``resolve_latest`` returns the newest member that actually LOADS; the
  rotation is seeded with the boot model, so "roll back" is well-defined
  before any promotion.

``BackgroundRetrainer`` runs one fit at a time on a daemon thread with the
``DeviceWatchdog`` abandon discipline: the caller polls, and a fit past
its deadline is ABANDONED — the generation bumps and the late result is
discarded. The deadline is the caller's injectable clock
(serving/drift.DriftController). ``join`` waits for the thread, which
the controller's ``close`` does (bounded): a process that exits while a
fit is still inside torch aborts.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
import traceback

import numpy as np

from ..utils import faults

_MODEL_RE = re.compile(r"^model-(\d+)$")

# BackgroundRetrainer states
IDLE = "idle"
RUNNING = "running"
DONE = "done"
FAILED = "failed"


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------


def fit_family(family: str, X, y, n_classes: int, *, device=None, **kw):
    """Fresh ``family`` params (the port's module, on ``device``, default
    CUDA) from the labeled window ``(X, y)``: gnb, kmeans, forest and svc
    through train/distributed.py on a one-device mesh, logreg and knn
    through their canonical trainers (no distributed variant exists), as
    in the JAX package. ``kw`` forwards the trainer's knobs (e.g.
    ``n_trees``). Raises whatever the trainer raises — the background
    worker owns failure semantics."""
    faults.fault_point("retrain.fit")
    X = np.asarray(X, np.float32)
    y = np.asarray(y, np.int32)
    if family in ("gnb", "kmeans", "forest", "svc"):
        from ..train import distributed as dist

        mesh = dist.single_device_mesh(device)
        if family == "gnb":
            return dist.fit_gnb(mesh, X, y, n_classes, **kw)
        if family == "kmeans":
            return dist.fit_kmeans(mesh, X, k=n_classes, **kw)[0]
        if family == "forest":
            return dist.fit_forest(mesh, X, y, n_classes, **kw)
        return dist.fit_svc(mesh, X, y, n_classes, **kw)
    if family == "logreg":
        from ..train import logreg as t

        return t.fit(X, y, n_classes, device=device, **kw)
    if family == "knn":
        from ..train import knn as t

        kw.setdefault("n_neighbors", 5)
        return t.fit(X, y, n_classes=n_classes, device=device, **kw)
    raise ValueError(f"unknown model family {family!r}")


# ---------------------------------------------------------------------------
# candidate rotation
# ---------------------------------------------------------------------------


def candidate_path(directory: str, seq: int) -> str:
    return os.path.join(directory, f"model-{seq:09d}")


def list_candidates(directory: str) -> list[tuple[int, str]]:
    """``(seq, path)`` for every rotation member, newest seq first."""
    out = []
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    for name in names:
        m = _MODEL_RE.match(name)
        if m and os.path.isdir(os.path.join(directory, name)):
            out.append((int(m.group(1)), os.path.join(directory, name)))
    out.sort(reverse=True)
    return out


def next_seq(directory: str) -> int:
    members = list_candidates(directory)
    return members[0][0] + 1 if members else 0


def save_candidate(directory: str, seq: int, family: str, params,
                   classes) -> str:
    """Write one candidate through the staged-commit model checkpoint
    (io/checkpoint.save_model). Returns its path."""
    from ..io import checkpoint as ck

    path = candidate_path(directory, seq)
    ck.save_model(path, family, params, classes=list(classes))
    return path


def load_candidate(path: str, device=None):
    """``io/checkpoint.load_model`` → models.LoadedModel on ``device``;
    raises on a missing or garbage candidate."""
    from ..io import checkpoint as ck

    return ck.load_model(path, device=device)


def discard_candidate(path: str) -> None:
    """Remove a rejected or rolled-back candidate so ``resolve_latest``
    can never hand it back."""
    shutil.rmtree(path, ignore_errors=True)


def _resolve_and_load(directory: str, device=None):
    """Newest rotation member that LOADS, with its loaded content; members
    that fail to load are skipped on the way down."""
    for _, path in list_candidates(directory):
        try:
            return path, load_candidate(path, device=device)
        except Exception:  # noqa: BLE001 — any unloadable member is skipped
            continue
    return None, None


def resolve_latest(directory: str, device=None) -> str | None:
    """The newest candidate checkpoint that actually loads (on ``device``)
    — a corrupt or discarded newest member means rollback to its
    predecessor (the boot seed at minimum). None when nothing loads."""
    return _resolve_and_load(directory, device=device)[0]


def prune_candidates(directory: str, keep: int = 3) -> None:
    """Keep the newest ``keep`` members; pruning is advisory."""
    for _, old in list_candidates(directory)[max(keep, 1):]:
        shutil.rmtree(old, ignore_errors=True)


# ---------------------------------------------------------------------------
# the background worker
# ---------------------------------------------------------------------------


class BackgroundRetrainer:
    """One background fit at a time, abandonable.

    ``submit(fn)`` starts a daemon worker running ``fn(is_current)``;
    ``is_current()`` reports whether this generation is still the live one
    — the job checks it before PUBLISHING (the candidate save), so an
    abandoned fit leaves no stray in the rotation. The caller polls for
    ``DONE``/``FAILED`` and consumes the terminal state with ``take``;
    ``abandon`` bumps the generation so a late result is dropped. A
    failure is kept with its frames' locals cleared, so a failed fit's
    tensors are freed when it fails, not when it is taken."""

    def __init__(self):
        self._lock = threading.Lock()
        self._gen = 0
        self._state = IDLE
        self._result = None
        self._error: BaseException | None = None
        self._thread: threading.Thread | None = None

    def submit(self, fn) -> None:
        with self._lock:
            if self._state == RUNNING:
                raise RuntimeError("a retrain is already running")
            self._gen += 1
            gen = self._gen
            self._state = RUNNING
            self._result = None
            self._error = None
        thread = threading.Thread(
            target=self._run, args=(gen, fn), name="tcsdn-retrain",
            daemon=True,
        )
        with self._lock:
            self._thread = thread
        thread.start()

    def _is_current(self, gen: int) -> bool:
        with self._lock:
            return gen == self._gen

    def _run(self, gen: int, fn) -> None:
        try:
            out = fn(lambda: self._is_current(gen))
        except BaseException as e:  # noqa: BLE001 — published to the poller
            # the failure is kept until ``take``: its frames' locals would
            # keep every tensor of the failed fit alive meanwhile (an
            # out-of-memory SVC refit's (N, N) kernel). Clear them; the
            # traceback keeps its files and lines
            traceback.clear_frames(e.__traceback__)
            with self._lock:
                if gen == self._gen and self._state == RUNNING:
                    self._state = FAILED
                    self._error = e
            return
        with self._lock:
            if gen == self._gen and self._state == RUNNING:
                self._state = DONE
                self._result = out

    def poll(self) -> str:
        with self._lock:
            return self._state

    def take(self):
        """Consume a terminal state: ``(state, result, error)``, reset to
        IDLE. Call only after ``poll`` reports DONE/FAILED."""
        with self._lock:
            state, result, error = self._state, self._result, self._error
            self._state = IDLE
            self._result = None
            self._error = None
            return state, result, error

    def abandon(self) -> None:
        """Discard the in-flight fit (deadline expiry): its eventual
        result is dropped by the generation check."""
        with self._lock:
            self._gen += 1
            self._state = IDLE
            self._result = None
            self._error = None

    def join(self, timeout: float) -> bool:
        """Wait up to ``timeout`` s for the newest worker thread to end
        (abandoned or not); True when none is running. A process must
        not exit under a fit still inside torch."""
        with self._lock:
            thread = self._thread
        if thread is not None:
            thread.join(timeout)
        return thread is None or not thread.is_alive()

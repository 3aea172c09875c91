"""The program's side of a ``knn`` configuration: the corpus the
benchmark makes from the seed (``harness.corpus``), handed to the port as
an importer dict, the form its reference-checkpoint loader builds the
model from (``KnnModel.from_numpy``, ``make_loaded_model``).

``Recorder`` keeps what the kernel itself returned on the timed path: the
(similarity, index) lists of ``ops/knn_kernel.topk_sim_idx``, the entry
that the serving predict (and so the degrade ladder) reaches, for the
newest predict of each switch's rows and for every watched burst. It
holds the kernel's own output tensors (no copy, no device work) and the
slots the predict covered, and reads them to the host once the window
has closed, for ``check.topk_rows``."""

from __future__ import annotations

import threading

import numpy as np

from harness import corpus

KERNEL = "knn_topk"  # the kernel's name in the device trace


def build(config: dict, seed: int, device, root):
    from traffic_classifier_sdn_tpu_torch.models import (MODEL_CLASSES,
                                                         make_loaded_model)
    from traffic_classifier_sdn_tpu_torch.models.base import ClassList

    X, y = corpus.make(config["corpus"], seed)
    params = MODEL_CLASSES["knn"].from_numpy({
        "fit_X": X.astype(np.float64), "y": y.astype(np.int32),
        "n_neighbors": int(config["n_neighbors"]),
        "classes": np.asarray(config["classes"]),
    }, device=device)
    return make_loaded_model("knn", params, ClassList(tuple(config["classes"])))


class Recorder:
    """``expect(X, slots, b)`` (host stage, at dispatch): the rows ``X`` of
    burst b's predict hold ``slots`` (None: the whole table). When the
    kernel entry is called with that very tensor, its output is kept: as
    the newest of the burst's switch, and under b if b is watched.

    Expectations are kept by burst: the device stage may lag the host stage
    by several bursts (a coalesced render still commits its predict, later),
    so a newer burst of the same switch must not overwrite one still
    waiting. Predicts run in dispatch order, so once burst b's is seen, an
    older expectation never will be, and it is dropped."""

    def __init__(self, switches: int, capacity: int, watched=()):
        self.switches, self.capacity = switches, capacity
        self.watched = set(watched)
        self._lock = threading.Lock()
        self._expect: dict = {}  # burst -> (X, slots), in dispatch order
        self.latest: dict = {}  # switch -> (b, slots, sims, idx)
        self.kept: dict = {}  # watched burst -> (b, slots, sims, idx)
        self._mod = self._inner = None

    def install(self) -> "Recorder":
        from traffic_classifier_sdn_tpu_torch.ops import knn_kernel

        inner = knn_kernel.topk_sim_idx

        def topk_sim_idx(g, X):
            sims, idx = inner(g, X)
            self._seen(X, sims, idx)
            return sims, idx

        # the launch count the kernel module keeps on its entry
        topk_sim_idx.launches = getattr(inner, "launches", 0)
        self._mod, self._inner = knn_kernel, inner
        knn_kernel.topk_sim_idx = topk_sim_idx
        return self

    def uninstall(self) -> None:
        if self._mod is not None:
            launches = getattr(self._mod.topk_sim_idx, "launches", 0)
            self._mod.topk_sim_idx = self._inner
            self._inner.launches = launches
            self._mod = None

    def expect(self, X, slots, b: int) -> None:
        if X is None:
            return
        with self._lock:
            self._expect[b] = (X, slots)

    def _seen(self, X, sims, idx) -> None:
        with self._lock:
            b = next((b for b, (x, _) in self._expect.items() if x is X), None)
            if b is None:
                return
            slots = self._expect[b][1]
            for older in [o for o in self._expect if o <= b]:
                del self._expect[older]
            rec = (b, slots, sims, idx)
            self.latest[b % self.switches] = rec
            if b in self.watched:
                self.kept[b] = rec

    def outputs(self) -> dict:
        """{"latest": {switch: rec}, "watched": {burst: rec}} on the host,
        rec = (burst, (n,) slots, (n, k) float32 similarities, (n, k) int64
        indices)."""
        def host(rec):
            b, slots, sims, idx = rec
            slots = (np.arange(self.capacity) if slots is None
                     else slots.cpu().numpy().astype(np.int64))
            return (b, slots, sims.cpu().numpy().astype(np.float32),
                    idx.cpu().numpy().astype(np.int64))

        with self._lock:
            return {"latest": {s: host(r) for s, r in self.latest.items()},
                    "watched": {b: host(r) for b, r in self.kept.items()}}

"""The system under test: the port's pipelined serve spine, built as the
port's CLI builds it at its defaults (``--native-ingest auto --incremental
auto --pipeline auto --degrade auto --table-rows 64``, one device) and
driven in-process, one burst at a time, as ``cli._serve_loop`` drives it:

- host stage (this thread): ``FlowStateEngine.ingest_bytes`` (the native
  C++ engine), ``step()`` and a wait on the serve stream, then
  ``serving.pipeline.dispatch_read`` through the incremental label cache,
  staged with ``ServePipeline.submit`` (coalescing renders under
  backpressure);
- device stage (the pipeline's worker): the read's rows (the degrade
  ladder's predict of the dirty rows through the family's kernel, the
  label commit) joined with the flows' metadata and rendered by the port's
  ``utils.table.render_table``, into a sink instead of stdout.

The benchmark's own spans sit around these calls: host-clock times per
burst, and ``record_function`` ranges for the device trace. At each
dispatch the incremental plan's rows are handed to the family's recorder,
if it has one, and after the window the degrade ladder's counts are read,
so that a predict served off the kernel shows. The CLI's tracer, latency
provenance and observability servers are not built."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

clock = time.perf_counter


class Sink:
    """Where rendered tables go: counted, not kept."""

    def __init__(self):
        self.chars = 0
        self.tables = 0

    def write(self, text: str) -> None:
        self.chars += len(text)
        self.tables += 1


class Spine:
    def __init__(self, model, device: torch.device, capacity: int,
                 table_rows: int, deadline: float, recorder=None):
        from traffic_classifier_sdn_tpu_torch.cli import PIPELINE_DEPTH
        from traffic_classifier_sdn_tpu_torch.ingest.batcher import FlowStateEngine
        from traffic_classifier_sdn_tpu_torch.models import resolve_fallback
        from traffic_classifier_sdn_tpu_torch.native import engine as native_engine
        from traffic_classifier_sdn_tpu_torch.serving.degrade import DegradeLadder
        from traffic_classifier_sdn_tpu_torch.serving.incremental import IncrementalLabels
        from traffic_classifier_sdn_tpu_torch.serving.pipeline import (
            RenderJob, ServePipeline, coalesce_renders, dispatch_read)
        from traffic_classifier_sdn_tpu_torch.utils.metrics import global_metrics
        from traffic_classifier_sdn_tpu_torch.utils.table import (
            CLASSIFIER_FIELDS, render_table, status_str)

        if not native_engine.available():
            raise RuntimeError("the native ingest engine did not build")
        self._RenderJob, self._dispatch_read = RenderJob, dispatch_read
        self._fields, self._render_table = CLASSIFIER_FIELDS, render_table
        self._status = status_str
        self.m = m = global_metrics
        self.device = device
        self.model = model
        self.names = model.classes.names
        self.table_rows = table_rows
        predict, self.serve_params = model.serving_path()
        self.engine = FlowStateEngine(capacity, device=device, native=True,
                                      track_dirty=True)
        self.degrade = DegradeLadder(
            predict, resolve_fallback(model.name, model.params),
            deadline=deadline, metrics=m)
        self.predict = self.degrade
        self.inc = IncrementalLabels(self.engine, self.predict,
                                     self.serve_params, degrade=self.degrade,
                                     metrics=m)
        self.pipe = ServePipeline(consume=lambda job: job(),
                                  depth=PIPELINE_DEPTH, metrics=m,
                                  merge=coalesce_renders).start()
        self.sink = Sink()
        self.recorder = recorder  # the family's record of its kernel's output
        self.trace = False  # record_function ranges around the calls
        self.done: list = []  # (burst, labels formed, rendered), in order
        self.keep_frames: set = set()
        self.frames: dict = {}  # burst -> (rows, n_flows)
        self.last_frame = None
        self.spans = {"ingest": [], "scatter": [], "dispatch": []}
        self.dirty_rows: list = []

    def _range(self, name: str):
        if self.trace:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def feed(self, b: int, payload: bytes) -> None:
        """The host stage of one burst."""
        eng, m = self.engine, self.m
        self.pipe.raise_if_failed()
        with self.pipe.host_stage():
            eng.mark_tick()
            t0 = clock()
            with self._range("bench.ingest"):
                n = eng.ingest_bytes(payload)
            t1 = clock()
            m.inc("records", n)
            m.set("native_parse_errors", eng.parse_errors())
            with self._range("bench.scatter"):
                eng.step()
                self._sync()
            t2 = clock()
            m.set("flows_dropped", eng.dropped)
            with self._range("bench.dispatch"):
                read = self._dispatch_read(eng, self.predict, self.serve_params,
                                           self.table_rows, inc=self.inc)
                plan = getattr(read, "_pending", None)
                if self.recorder is not None and plan is not None:
                    self.recorder.expect(plan.X, plan.idx, b)
                self.dirty_rows.append(self.inc.status()["dirty_rows"])
                self.pipe.submit(self._RenderJob(read, self._render(b)))
                self._sync()
            t3 = clock()
        self.spans["ingest"].append(t1 - t0)
        self.spans["scatter"].append(t2 - t1)
        self.spans["dispatch"].append(t3 - t2)

    def _render(self, b: int):
        def render(read):
            ranked = read.rows()
            t_labels = clock()
            meta = self.engine.slot_metadata(slots=[s for s, *_ in ranked])
            rows = [
                (slot, *meta[slot], self._name(c), self._status(fa),
                 self._status(ra))
                for slot, c, fa, ra in ranked if slot in meta
            ]
            text = self._render_table(self._fields, rows)
            if read.n_flows > len(rows):
                text += (f"\n... showing {len(rows)} of {read.n_flows} "
                         f"tracked flows")
            self.sink.write(text)
            self.done.append((b, t_labels, clock()))
            self.last_frame = (b, rows, read.n_flows)
            if b in self.keep_frames:
                self.frames[b] = (rows, read.n_flows)
        return render

    def _name(self, c: int) -> str:
        return self.names[c] if c < len(self.names) else "?"

    def drain(self, timeout: float) -> bool:
        return self.pipe.drain(timeout=timeout)

    def reset_spans(self) -> None:
        self.spans = {k: [] for k in self.spans}
        self.dirty_rows = []

    def outputs(self) -> dict:
        """What the program holds once every burst has rendered: the 12
        features of every slot, the label cache, the flow count and the
        engine's drop and parse-error counts."""
        labels = self.inc.labels()
        if isinstance(labels, torch.Tensor):
            labels = labels.cpu().numpy()
        return {
            "X": self.engine.features().cpu().numpy(),
            "labels": np.array(labels, np.int64),
            "n_flows": self.engine.num_flows(),
            "dropped": int(self.engine.dropped),
            "parse_errors": int(self.engine.parse_errors()),
        }

    def ladder(self) -> dict:
        """The degrade ladder's counts: predicts served off the kernel
        (``fallback_calls``) and rung changes (``degrade_transitions``)."""
        return self.degrade.status()

    def metadata(self, slots) -> dict:
        return self.engine.slot_metadata(slots=[int(s) for s in slots])

    def close(self) -> None:
        self.pipe.shutdown(drain=False)
        self.degrade.close()

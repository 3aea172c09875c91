"""One run of one cell: set-up, the measured window, the drain, the
comparison with the plain reference, and the metrics.

Set-up builds the model and the spine, starts the generator, feeds
``setup_rounds`` poll rounds (the first creates every flow, so the table is
full and every shape the window uses has run: the wire bucket, the
full-table and the dirty-subset predicts, the render), and with a trace
makes one throwaway profiler capture, so that CUPTI attaches before the
window. The window then lasts ``seconds``:

- closed loop (``loop: closed``): each burst goes to the host stage as soon
  as it has taken the last; ``flows_per_s`` counts the conversation updates
  whose burst a render covered inside the window;
- open loop (``loop: open``): burst i of the window is due at
  ``i / rate_bursts_per_s``; each is timed from when it was due to when its
  labels were formed on the host, by its own render or a later one that
  covered it (``label_p95_ms``).

After the close no burst is added; those in flight render (a minute at
most) and then the program's state (with the degrade ladder's counts and,
for a family with a recorder, its kernel's own top-k lists) is read,
freed, and compared with the reference. With a trace, ``trace_bursts`` bursts from ``trace_offset_bursts``
into the window run under the profiler, bracketed by drains so that the
trace holds exactly their device work."""

from __future__ import annotations

import gc
import math
import sys
import time

import torch

from . import cells, check, profile, yardstick
from .spine import Spine, clock
from .traffic import Feeder, Generator, TrafficSpec, burst_switch_round

DRAIN_S = 60.0
FORBIDDEN = ("jax", "jaxlib", "flax", "traffic_classifier_sdn_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux), else since import."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        import os

        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that no run may load, compared
    whole (the port's own name begins with the JAX package's)."""
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (``q`` in 0..100) of all values."""
    v = sorted(values)
    if not v:
        return math.inf
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


class Run:
    """What a run measured, for the metric readers."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run_cell(config: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device: torch.device, root=cells.ROOT,
             log=print) -> dict:
    spec = TrafficSpec(traffic)
    S, N = spec.switches, spec.conversations
    serve = config["serve"]
    rows = int(serve["table_rows"])
    b0 = int(traffic.get("setup_rounds", 2)) * S
    frames = check.frame_plan(spec, seed, b0)
    keep: dict = {}
    for b in frames:
        keep.setdefault(b, []).extend(check.frame_keeps(spec, b, rows))
    traced = []
    if trace:
        t0b = b0 + spec.trace_offset_bursts
        traced = list(range(t0b, t0b + spec.trace_bursts))
        for b in traced:
            s, k = burst_switch_round(spec, b)
            keep.setdefault(b, []).extend([(s, k), (s, k - 1)])
    gen = Generator(spec, seed, keep)
    fam = cells.family("families", config["family"])
    model = fam.build(config, seed, device, root)
    recorder = (fam.Recorder(S, spec.capacity, traced)
                if hasattr(fam, "Recorder") else None)
    spine = Spine(model, device, spec.capacity, rows,
                  float(serve["device_deadline"]), recorder)
    spine.keep_frames = set(frames)
    feeder = Feeder(gen, spec.queue_depth).start()
    tracer = Tracer(spine, device, traced)
    if recorder is not None:
        recorder.install()
    try:
        for _ in range(b0):
            spine.feed(*feeder.get())
        spine.drain(DRAIN_S)
        if trace:
            _throwaway_capture(device)
        spine.reset_spans()
        stats0 = spine.pipe.stats()
        done0 = len(spine.done)
        gen_wait0 = feeder.wait_s
        setup_s = process_age_s()
        handed, due, start, t_end = drive(spine, feeder, b0, spec.loop,
                                          spec.rate, seconds, tracer)
        drained = spine.drain(DRAIN_S)
        gen_wait = feeder.wait_s - gen_wait0
        ladder = spine.ladder()
        topk = recorder.outputs() if recorder is not None else None
    finally:
        tracer.close()
        feeder.stop()
        if recorder is not None:
            recorder.uninstall()
    prof = tracer.prof
    stats1 = spine.pipe.stats()
    done = spine.done[done0:]
    found = forbidden_modules()
    if found:
        raise SystemExit(f"forbidden modules loaded: {', '.join(found)}")
    # each burst is covered by the first render at or after it
    labels_at, rendered_at = {}, {}
    j = 0
    for b in handed:
        while j < len(done) and done[j][0] < b:
            j += 1
        if j < len(done):
            labels_at[b], rendered_at[b] = done[j][1], done[j][2]
    unrendered = sum(1 for b in handed if b not in rendered_at)
    e2e = {"setup_s": ("s", setup_s)}
    if spec.loop == "closed":
        covered = sum(1 for b in handed if rendered_at.get(b, math.inf) <= t_end)
        e2e["flows_per_s"] = ("flows/s", covered * N / seconds)
    else:
        lat = [(labels_at.get(b, math.inf) - due[b]) * 1e3 for b in handed]
        e2e["label_p95_ms"] = ("ms", percentile(lat, 95))
        e2e["label_p50_ms"] = ("ms", percentile(lat, 50))
    lag = [start[b] - due[b] for b in handed] if due else []
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    # the program's state, read once everything rendered, then freed
    port = spine.outputs()
    meta_slots = check.meta_slots(spec, seed)
    meta_port = spine.metadata(meta_slots)
    port_frames = dict(spine.frames)
    if spine.last_frame is not None:
        lb, lrows, ln = spine.last_frame
        port_frames[lb] = (lrows, ln)
    port["frames"] = port_frames
    if topk is not None:
        port["topk"] = topk
    timed = [b for b in handed if b not in set(traced)]
    run = Run(
        family=config["family"], spans=dict(spine.spans),
        span_bursts=list(handed),
        timed_bursts=set(timed),
        frames=len(done),
        device_busy_s=stats1["device_busy_s"] - stats0["device_busy_s"],
        coalesced=stats1["ticks_coalesced"] - stats0["ticks_coalesced"],
        dirty_rows=list(spine.dirty_rows), trace=None, bound_ms=None,
        model_ops=None,
        traced_bursts=sum(1 for b in traced if b in set(handed)),
    )
    sink_chars = spine.sink.chars
    spine.close()
    del spine, model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    last_burst = handed[-1] if handed else b0 - 1
    ref_model = cells.family("reference", config["family"]).load(
        config, seed, root)
    ref = check.reference_view(
        gen, spec, ref_model, device, last_burst,
        [f for f in port_frames if f <= last_burst], rows)
    limits = config["limits"]
    checks = check.compare(
        port, ref, meta_port, check.expected_meta(spec, meta_slots), limits,
        unrendered + (0 if drained else 1), spec, last_burst,
        {"fallback_calls": int(ladder["fallback_calls"]),
         "rung_changes": int(ladder["degrade_transitions"])})
    if trace:
        traced_in = [b for b in traced if b in set(handed)]
        if prof is not None:
            run.trace = profile.summarize(profile.export_events(prof))
        if device.type == "cuda":  # a CPU run has no kernel to trace
            absent = (run.trace is None or profile.kernel_seconds(
                run.trace, fam.KERNEL) is None)
            checks["kernel_absent_from_trace"] = (
                int(absent), limits["kernel_absent_from_trace"])
        run.bound_ms, run.model_ops, detail = _traced_work(
            gen, spec, ref_model, config["family"], traced_in, device)
        if topk is not None:
            v, lim = checks["topk_rows"]
            checks["topk_rows"] = (v + check.topk_rows(
                topk["watched"], {b: (b, b % S) for b in traced_in},
                detail.get, N), lim)
    log(f"# generator: made {feeder.made} bursts in {feeder.make_s:.3f} s, "
        f"the serve waited {gen_wait:.3f} s on it; "
        f"open-loop lag max {max(lag, default=0.0) * 1e3:.1f} ms; "
        f"renders {len(done)} ({run.coalesced} coalesced), "
        f"table chars {sink_chars}")
    return {
        "attempted": len(handed),
        "failed": unrendered,
        "e2e": e2e,
        "checks": checks,
        "memory_peak_bytes": int(memory_peak),
        "run": run,
    }


def drive(spine, feeder, first: int, loop: str, rate, seconds: float,
          tracer=None):
    """Feed the window's bursts, from burst ``first``, to the host stage for
    ``seconds``: closed loop, each as soon as the last is taken; open loop,
    burst first + i due at ``i / rate``. Returns (bursts handed, due times, host start times, the
    window's end)."""
    handed, due, start = [], {}, {}
    t_w0 = clock()
    t_end = t_w0 + seconds
    i = 0
    while True:
        if loop == "open":
            d = t_w0 + i / rate
            if d >= t_end:
                break
            wait = d - clock()
            if wait > 0:
                time.sleep(wait)
        elif clock() >= t_end:
            break
        if tracer is not None:
            tracer.before(first + i)
        b, payload = feeder.get()
        start[b] = clock()
        if loop == "open":
            due[b] = d
        spine.feed(b, payload)
        handed.append(b)
        if tracer is not None:
            tracer.after(b)
        i += 1
    if tracer is not None:
        tracer.close()  # the window closed inside the traced bursts
    return handed, due, start, t_end


class Tracer:
    """Runs ``bursts`` under the profiler, bracketed by drains so that the
    trace holds exactly their device work, inside a ``bench.window``
    range."""

    def __init__(self, spine, device, bursts):
        self.spine, self.device, self.bursts = spine, device, list(bursts)
        self.prof = self._range = None
        self.active = False

    def before(self, b: int) -> None:
        if self.bursts and b == self.bursts[0] and not self.active:
            self.spine.drain(DRAIN_S)
            self.prof = torch.profiler.profile(
                activities=_activities(self.device))
            self.prof.__enter__()
            self._range = torch.profiler.record_function(profile.WINDOW)
            self._range.__enter__()
            self.spine.trace = self.active = True

    def after(self, b: int) -> None:
        if self.active and b == self.bursts[-1]:
            self.close()

    def close(self) -> None:
        if self.active:
            self.spine.drain(DRAIN_S)
            self.spine.trace = self.active = False
            self._range.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)


def _activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _throwaway_capture(device) -> None:
    with torch.profiler.profile(activities=_activities(device)):
        x = torch.ones(1024, device=device)
        (x + 1).sum().item()


def _traced_work(gen, spec, ref_model, family, traced, device):
    """(least ms, model operations, {burst: the reference's k nearest rows})
    of the traced bursts' predicts: each predicts its switch's
    conversations at its round."""
    from reference import flows

    total_ms, total_ops, detail = 0.0, 0, {}
    for b in traced:
        s, k = burst_switch_round(spec, b)
        st = flows.switch_state(gen.state(s, k), gen.state(s, k - 1), k,
                                spec.poll_seconds)
        X = st["X"]
        _, more = check.predict(ref_model, X, device, "float32", detail=True)
        visits = None
        if isinstance(more, tuple):
            detail[b] = more
        else:
            visits = more
        ms, ops = yardstick.model_work(family, ref_model, X.shape[0], visits)
        total_ms += ms
        total_ops += ops
    return total_ms, total_ops, detail

"""The port's pipelined serve (``serving/pipeline.py``), warmup
(``serving/warmup.py``) and the CLI with no flag at all, against the JAX
package.

- ``Handoff`` and ``ServePipeline``: the same operation sequences give
  the same put/get/coalesce counters as the JAX classes (``impl``).
- The no-flag CLI (``--pipeline auto --degrade auto``: pipelined, the
  ladder, host-mode incremental labels): whether a render coalesces
  depends on whether the device stage keeps up, so the stdout is held by
  the subsequence rule against the JAX serial serve with the ladder on
  (``--pipeline off``, every other flag at its default): its tables are a
  subsequence of JAX's, in order, the last table is the same, and the
  number missing is ``ticks_coalesced``. With the handoff deeper than the
  number of renders (``PIPELINE_DEPTH``), nothing coalesces and stdout is
  byte-identical.
- ``--warmup``: the first render tick builds nothing and runs the predict
  at no row count warmup did not run (counted through the plain versions
  on the CPU).
"""

import contextlib
import io
import threading
import time

import numpy as np
import pytest

import chip_smoke
from test_torch_incremental import _capture_and_sample, _checkpoints
from traffic_classifier_sdn_tpu import cli as jcli
from traffic_classifier_sdn_tpu.serving import pipeline as jpipeline
from traffic_classifier_sdn_tpu_torch import cli as tcli
from traffic_classifier_sdn_tpu_torch.native import loader
from traffic_classifier_sdn_tpu_torch.ops import cuda_build
from traffic_classifier_sdn_tpu_torch.ops import forest_kernel as fk
from traffic_classifier_sdn_tpu_torch.serving import pipeline as tpipeline
from traffic_classifier_sdn_tpu_torch.utils import faults as tfaults
from torch_witnesses import _torch_locktrace_witness, _torch_syncguard_witness  # noqa: F401 — the lock witness and the sync witness ride this suite

IMPLS = {"jax": jpipeline, "port": tpipeline}
both = pytest.mark.parametrize("impl", sorted(IMPLS))


@pytest.fixture(autouse=True, scope="module")
def _default_serving_menus():
    """The serves here run the default serving menus. A CLI given
    ``--knn-topk`` publishes it through TCSDN_KNN_TOPK for the rest of its
    process, so a serve of another module may have left it set."""
    with pytest.MonkeyPatch.context() as mp:
        for var in ("TCSDN_KNN_TOPK", "TCSDN_SVC_KERNEL",
                    "TCSDN_FOREST_KERNEL"):
            mp.delenv(var, raising=False)
        yield


def _handoff_trace(mod, depth, merge, ops):
    """Apply ``ops`` ('p' put, 'g' get, 'd' done) to a Handoff; the
    (return value, queued, coalesced, idle) after each."""
    h = mod.Handoff(depth=depth, merge=merge)
    out, n = [], 0
    for op in ops:
        if op == "p":
            n += 1
            r = h.put([n])
        elif op == "g":
            r = h.get(timeout=0)
        else:
            r = h.done()
        out.append((r, h.queued, h.coalesced, h.idle))
    return out


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("merged", [False, True])
def test_handoff_counters_equal_jax(depth, merged):
    ops = "ppppgdpgpppgdgdgpd" + "pgd" * 3 + "ppppp" + "gdgdgdgd"
    merge = (lambda staged, new: staged + new) if merged else None
    assert (_handoff_trace(tpipeline, depth, merge, ops)
            == _handoff_trace(jpipeline, depth, merge, ops))


@both
def test_handoff_bounded_with_coalescing_backpressure(impl):
    h = IMPLS[impl].Handoff(depth=2)
    assert h.put("a") and h.put("b")
    assert not h.put("c")  # coalesces into "b"
    assert h.queued == 2 and h.coalesced == 1
    assert h.get(timeout=0) == "a"
    assert h.get(timeout=0) == "c"
    assert h.get(timeout=0) is None


@both
def test_handoff_join_waits_for_inflight(impl):
    h = IMPLS[impl].Handoff(depth=2)
    h.put("job")
    assert not h.join(timeout=0.05)
    assert h.get(timeout=0) == "job"
    assert not h.join(timeout=0.05)
    h.done()
    assert h.join(timeout=1)


@both
def test_pipeline_runs_jobs_in_order_and_drains(impl):
    done = []
    pipe = IMPLS[impl].ServePipeline(done.append, depth=32).start()
    try:
        for i in range(16):
            pipe.submit(i)
        assert pipe.drain(timeout=5)
    finally:
        pipe.shutdown(drain=False)
    assert done == list(range(16))


@both
def test_pipeline_propagates_device_stage_exception(impl):
    boom = ValueError("device stage died")

    def consume(job):
        raise boom

    pipe = IMPLS[impl].ServePipeline(consume).start()
    try:
        pipe.submit("job")
        deadline = time.monotonic() + 5
        while not pipe.failed() and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(ValueError) as ei:
            pipe.submit("next")
        assert ei.value is boom
        with pytest.raises(ValueError):
            pipe.drain(timeout=1)
    finally:
        pipe.shutdown(drain=False)


@both
def test_pipeline_overlap_accounting(impl):
    release = threading.Event()
    pipe = IMPLS[impl].ServePipeline(
        lambda job: release.wait(timeout=5)).start()
    try:
        with pipe.host_stage():
            pipe.submit("job")
            time.sleep(0.05)
        release.set()
        assert pipe.drain(timeout=5)
        s = pipe.stats()
        assert s["host_busy_s"] > 0 and s["device_busy_s"] > 0
        assert s["overlap_s"] > 0.02
    finally:
        release.set()
        pipe.shutdown(drain=False)


class _Read:
    def __init__(self, name, log):
        self.name = name
        self.log = log

    def commit(self):
        self.log.append(("commit", self.name))


@pytest.mark.chaos
def test_coalesced_render_still_commits_in_order():
    """A render superseded in the handoff prints nothing, but its label
    commit runs before the render that replaced it; the fault sites sit
    on the handoff."""
    log = []
    h = tpipeline.Handoff(depth=1, merge=tpipeline.coalesce_renders)
    jobs = [tpipeline.RenderJob(_Read(n, log),
                                lambda r: log.append(("render", r.name)))
            for n in "abc"]
    assert h.put(jobs[0]) and not h.put(jobs[1]) and not h.put(jobs[2])
    h.get(timeout=0)()
    assert log == [("commit", "a"), ("commit", "b"), ("render", "c")]
    with tfaults.installed(tfaults.FaultPlan(
            [tfaults.FaultRule("pipeline.coalesce")])):
        h.put(jobs[0])
        with pytest.raises(tfaults.FaultInjected):
            h.put(jobs[1])
    with tfaults.installed(tfaults.FaultPlan(
            [tfaults.FaultRule("pipeline.handoff")])):
        with pytest.raises(tfaults.FaultInjected):
            h.put(jobs[0])


# ---------------------------------------------------------------------------
# The no-flag CLI against JAX
# ---------------------------------------------------------------------------


def _frames(out: str) -> list[str]:
    """The rendered tables of a stdout, each with its "... showing" line."""
    frames, cur, seps = [], [], 0
    for line in out.splitlines():
        if line.startswith("...") and not cur and frames:
            frames[-1] += "\n" + line
            continue
        cur.append(line)
        if line.startswith("+"):
            seps += 1
            if seps % 3 == 0:
                frames.append("\n".join(cur))
                cur = []
    return frames


def assert_subsequence(got: str, want: str, coalesced: int) -> None:
    """``got``'s tables are ``want``'s in order with ``coalesced`` missing,
    and the last table is the same."""
    g, w = _frames(got), _frames(want)
    assert g and g[-1] == w[-1]
    it = iter(w)
    assert all(any(f == x for x in it) for f in g)
    assert len(w) - len(g) == coalesced


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        summary = main(argv)
    return out.getvalue(), summary


FAMILIES = ("Randomforest", "knearest", "svm")


@pytest.mark.parametrize("table_rows", ["16", "0"])
@pytest.mark.parametrize("idle", ["60", "2"])
@pytest.mark.parametrize("sub", FAMILIES)
def test_no_flag_serve_prints_what_jax_prints(tmp_path, monkeypatch, sub,
                                              idle, table_rows):
    """The port with no ``--pipeline``/``--degrade`` flag against JAX's
    serial serve with the ladder, on the churn capture (full, subset and
    no-dirty plans; with ``--idle-timeout 2`` the fourth render evicts
    every flow): the subsequence rule; the ladder stays HEALTHY; the
    labels run in host mode."""
    monkeypatch.delenv("TCSDN_KNN_TOPK", raising=False)
    monkeypatch.delenv("TCSDN_SVC_KERNEL", raising=False)
    capture, X = _capture_and_sample(tmp_path)
    jdir, tdir = _checkpoints(tmp_path, sub, X)
    common = [sub, "--source", "replay", "--capture", capture,
              "--capacity", "48", "--print-every", "1",
              "--idle-timeout", idle, "--table-rows", table_rows]
    want, _ = _run(jcli.main, common + ["--native-checkpoint", jdir,
                                        "--pipeline", "off"])
    assert want.count("Flow ID") == 6
    got, summary = _run(tcli.main, common + ["--native-checkpoint", tdir,
                                             "--device", "cpu"])
    assert_subsequence(got, want, summary.ticks_coalesced)
    assert summary.pipeline is not None
    assert summary.degrade["state"] == "HEALTHY"
    assert summary.degrade["fallback_calls"] == 0
    assert summary.degrade["device_calls"] == len(
        [p for p in summary.render_plans if p[0] != "none"])
    assert len(summary.render_ticks) == 6


@pytest.mark.parametrize("table_rows", ["16", "0"])
@pytest.mark.parametrize("sub", FAMILIES)
def test_pipelined_serve_deep_enough_is_byte_identical(tmp_path,
                                                       monkeypatch, sub,
                                                       table_rows):
    """With a handoff deeper than the serve's renders nothing coalesces:
    the no-flag serve, the pipelined bare-kernel serve and the serial
    serves print exactly the JAX serial serve's stdout — through every
    read object (ranked and full; host-mode and device-mode label cache;
    the ladder without incremental labels; the feature stage)."""
    monkeypatch.delenv("TCSDN_KNN_TOPK", raising=False)
    monkeypatch.delenv("TCSDN_SVC_KERNEL", raising=False)
    monkeypatch.setattr(tcli, "PIPELINE_DEPTH", 64)
    capture, X = _capture_and_sample(tmp_path)
    jdir, tdir = _checkpoints(tmp_path, sub, X)
    common = [sub, "--source", "replay", "--capture", capture,
              "--capacity", "48", "--print-every", "1",
              "--idle-timeout", "2", "--table-rows", table_rows]
    want, _ = _run(jcli.main, common + ["--native-checkpoint", jdir,
                                        "--pipeline", "off"])
    for flags in ([], ["--degrade", "off"], ["--pipeline", "off"],
                  ["--incremental", "off"],
                  ["--incremental", "off", "--degrade", "off"]):
        got, summary = _run(tcli.main, common + [
            "--native-checkpoint", tdir, "--device", "cpu", *flags])
        assert got == want, flags
        assert summary.ticks_coalesced == 0
        assert (summary.pipeline is None) == ("--pipeline" in flags)


def test_warmup_first_render_builds_and_launches_nothing_new(
        tmp_path, monkeypatch):
    """``--warmup`` on the CPU: every row count the serve's predicts run
    at (full table, each dirty bucket) was run by warmup first, no library
    is built after warmup, and warmup lists what it warmed."""
    capture, X = _capture_and_sample(tmp_path)
    jdir, tdir = _checkpoints(tmp_path, "Randomforest", X)
    phase = {"now": "startup"}
    seen = {"startup": [], "serving": []}
    builds = {"startup": 0, "serving": 0}
    plain = fk.forest_proba_plain

    def counted(k, Xq):
        seen[phase["now"]].append(int(Xq.shape[0]))
        return plain(k, Xq)

    def build_counted(real):
        def wrapper(*a, **kw):
            builds[phase["now"]] += 1
            return real(*a, **kw)
        return wrapper

    monkeypatch.setattr(fk, "forest_proba_plain", counted)
    monkeypatch.setattr(loader.LazyLib, "_build",
                        build_counted(loader.LazyLib._build))
    monkeypatch.setattr(cuda_build, "build", build_counted(cuda_build.build))
    serve_loop = tcli._serve_loop

    def marked(*a, **kw):
        phase["now"] = "serving"
        return serve_loop(*a, **kw)

    monkeypatch.setattr(tcli, "_serve_loop", marked)
    err = io.StringIO()
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(err):
        summary = tcli.main(["Randomforest", "--source", "replay",
                             "--capture", capture, "--capacity", "48",
                             "--print-every", "1", "--idle-timeout", "2",
                             "--native-checkpoint", tdir, "--device", "cpu",
                             "--warmup"])
    assert summary.warmup["warmed"] == [
        "wire_stage", "predict[native]", "fallback_rung", "dirty[16]",
        "top_active_flags", "evict"]
    assert "warmup: warmed 6 serving steps" in err.getvalue()
    assert builds["serving"] == 0
    assert seen["serving"] and set(seen["serving"]) <= set(seen["startup"])
    assert sorted(set(seen["startup"])) == [16, 48]


def test_chip_smoke_subsequence_helpers_agree(tmp_path):
    """``chip_smoke.parse_tables`` and this file's ``_frames`` read the same
    tables out of a serve's stdout."""
    capture, X = _capture_and_sample(tmp_path)
    jdir, tdir = _checkpoints(tmp_path, "Randomforest", X)
    out, _ = _run(tcli.main, ["Randomforest", "--source", "replay",
                              "--capture", capture, "--capacity", "48",
                              "--print-every", "1", "--table-rows", "8",
                              "--native-checkpoint", tdir, "--device", "cpu"])
    frames = _frames(out)
    assert len(frames) == len(chip_smoke.parse_tables(out))
    assert all(f.count("\n|") == 9 for f in frames)
    assert all(f.endswith("tracked flows") for f in frames)
    assert np.all([len(t) == 8 for t in chip_smoke.parse_tables(out)])

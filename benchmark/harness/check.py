"""The comparison that decides ``correct``: what the served spine holds and
rendered, against the plain reference worked out from the generator's own
counters (``reference/``).

Numbers compared, each with the limit the configuration states:

- ``feature_rows``: table rows whose 12 float32 features differ, bit for
  bit, from the reference's (every slot of the table);
- ``label_rows``: slots whose label in the incremental label cache differs
  from the reference model's label of the reference features;
- ``render_rows``: rows of the checked frames (the last one and a sample
  drawn from the seed) that differ in any column, plus one for each frame
  whose flow count differs;
- ``meta_rows``: sampled slots whose (source, destination) differ;
- ``topk_rows`` (families whose kernel returns its k nearest rows): rows
  whose (similarity, index) lists, as the kernel returned them on the timed
  path, differ bit for bit from the reference's, over the newest predict of
  every switch (the whole table, as the labels) and, in a traced run, every
  traced burst; a predict the kernel never returned counts all its rows;
- ``dropped_flows``, ``parse_errors``: the engine's counts;
- ``unrendered_bursts``: bursts of the window that no render covered;
- ``fallback_calls``, ``rung_changes``: predicts that the degrade ladder
  served off the kernel, and its rung changes, over the run;
- ``kernel_absent_from_trace`` (traced runs): 1 when the trace holds no
  device time of the family's kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import flows

from .traffic import TrafficSpec, mac_text, rounds_after

META_SAMPLE = 4096


def frame_plan(spec: TrafficSpec, seed: int, first: int) -> list[int]:
    """The bursts whose frames are checked besides the last one: every
    ``stride``-th burst of the window from an offset drawn from the seed,
    the stride odd so that the frames cover every switch's position."""
    stride = 2 * spec.switches + 5
    offset = int(np.random.default_rng([seed, 4]).integers(stride))
    return [first + offset + i * stride for i in range(spec.render_samples)]


def meta_slots(spec: TrafficSpec, seed: int) -> np.ndarray:
    n = min(META_SAMPLE, spec.capacity)
    return np.sort(np.random.default_rng([seed, 5]).choice(
        spec.capacity, n, replace=False))


def floor_before(spec: TrafficSpec, b: int) -> int:
    """The render's freshness floor at burst b: the newest time stamp of
    the bursts before it (0 before the first)."""
    return spec.time_of((b - 1) // spec.switches) if b > 0 else 0


def frame_keeps(spec: TrafficSpec, b: int, rows: int) -> list[tuple[int, int]]:
    """(switch, round) counters the reference needs for burst b's frame."""
    rounds = rounds_after(spec, b)
    fresh = flows.freshness(rounds, spec.time_of, floor_before(spec, b))
    need = []
    for s in flows.frame_switches(rounds, fresh, spec.conversations, rows):
        k = int(rounds[s]) - 1
        need += [(s, k), (s, k - 1)]
    return need


def bf16(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (the control's working precision)."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def reference_view(gen, spec: TrafficSpec, model, device, last_burst: int,
                   frame_bursts, rows: int, precision: str = "float32") -> dict:
    """What a correct spine holds after bursts 0..last_burst, from the
    generator's counters: features, labels, and the frames of
    ``frame_bursts`` (and of the last burst)."""
    q = bf16 if precision == "bfloat16" else flows._same
    P, N = spec.poll_seconds, spec.conversations
    rounds = rounds_after(spec, last_burst)
    X = flows.table_features(gen.state, rounds, N, P, q)
    labels, detail = predict(model, X, device, precision, detail=True)
    out_frames = {}
    for b in sorted(set(frame_bursts) | {last_burst}):
        r = rounds_after(spec, b)
        fresh = flows.freshness(r, spec.time_of, floor_before(spec, b))
        states = {}
        for s in flows.frame_switches(r, fresh, N, rows):
            k = int(r[s]) - 1
            prev = gen.state(s, k - 1) if k > 0 else None
            states[s] = flows.switch_state(gen.state(s, k), prev, k, P, q)
        shown = flows.frame(states, r, fresh, N, rows)
        if shown:
            Xs = np.stack([states[s]["X"][slot - s * N] for slot, s in shown])
            lab = predict(model, Xs, device, precision)
        out = []
        for i, (slot, s) in enumerate(shown):
            c = slot - s * N
            st = states[s]
            out.append((slot, mac_text(s, c, 0), mac_text(s, c, 1),
                        model.classes[int(lab[i])],
                        flows.STATUS[int(st["fwd_active"][c])],
                        flows.STATUS[int(st["rev_active"][c])]))
        n_flows = int(sum(N for x in r if x > 0))
        out_frames[b] = (out, n_flows)
    out = {"X": X, "labels": labels, "frames": out_frames,
           "n_flows": int(sum(N for x in rounds if x > 0))}
    if isinstance(detail, tuple):  # the k nearest rows of every slot
        out["topk_lists"] = detail
    return out


def predict(model, X: np.ndarray, device, precision: str, detail=False):
    """Labels of rows X; with ``detail``, also the model's detail of the
    work: the forest's node visits, or the KNN's (similarities, indices)
    on the host."""
    with torch.no_grad():
        lab, more = model.predict(torch.from_numpy(X).to(device), precision)
    lab = lab.cpu().numpy()
    if not detail:
        return lab
    if isinstance(more, tuple):
        more = tuple(t.cpu().numpy() for t in more)
    return lab, more


def newest_bursts(spec: TrafficSpec, last_burst: int) -> dict:
    """{switch: (its newest burst up to ``last_burst``, switch)}."""
    S = spec.switches
    return {s: (last_burst - (last_burst - s) % S, s)
            for s in range(min(S, last_burst + 1))}


def as_records(spec: TrafficSpec, last_burst: int, lists) -> dict:
    """Whole-table (similarities, indices) in the form the program's
    record takes: each switch's newest predict covering its rows."""
    N = spec.conversations
    return {"latest": {
        s: (b, np.arange(s * N, (s + 1) * N), lists[0][s * N:(s + 1) * N],
            lists[1][s * N:(s + 1) * N])
        for s, (b, _) in newest_bursts(spec, last_burst).items()}}


def topk_rows(records: dict, expected: dict, reference, n: int) -> int:
    """Rows whose kernel (similarity, index) lists differ bit for bit from
    the reference's. ``records``: key -> (burst, slots, similarities,
    indices) as the kernel returned them; ``expected``: key -> (burst,
    switch); ``reference(key)``: the reference's (n, k) similarities and
    indices of that switch's n conversations at that burst. A missing
    record, one of another burst, and each of the switch's conversations
    that the predict did not cover count as rows."""
    bad = 0
    for key, (b, s) in expected.items():
        rec = records.get(key)
        if rec is None or rec[0] != b:
            bad += n
            continue
        _, slots, sims, idx = rec
        own = (slots >= s * n) & (slots < (s + 1) * n)
        c = slots[own] - s * n
        bad += n - np.unique(c).size
        ref_sims, ref_idx = reference(key)
        ref_sims = np.ascontiguousarray(ref_sims[c], np.float32)
        got = np.ascontiguousarray(sims[own], np.float32)
        if got.shape != ref_sims.shape:
            bad += int(c.size)
            continue
        diff = ((got.view(np.uint32) != ref_sims.view(np.uint32)).any(1)
                | (idx[own] != ref_idx[c]).any(1))
        bad += int(diff.sum())
    return bad


def expected_meta(spec: TrafficSpec, slots) -> dict:
    N = spec.conversations
    return {int(s): (mac_text(int(s) // N, int(s) % N, 0),
                     mac_text(int(s) // N, int(s) % N, 1)) for s in slots}


def compare(port: dict, ref: dict, meta_port: dict, meta_ref: dict,
            limits: dict, unrendered: int, spec: TrafficSpec | None = None,
            last_burst: int = -1, more: dict | None = None) -> dict:
    """{name: (value, limit)} of every number compared; ``more`` holds
    further numbers already counted (the ladder's)."""
    a = np.ascontiguousarray(port["X"], np.float32).view(np.uint32)
    b = np.ascontiguousarray(ref["X"], np.float32).view(np.uint32)
    feature_rows = (int((a != b).any(1).sum()) if a.shape == b.shape
                    else max(a.shape[0], b.shape[0]))
    la, lb = np.asarray(port["labels"]), np.asarray(ref["labels"])
    label_rows = (int((la != lb).sum()) if la.shape == lb.shape
                  else max(la.size, lb.size))
    render_rows = 0
    for bst, (rows_ref, n_ref) in ref["frames"].items():
        got = port["frames"].get(bst)
        if got is None:
            continue  # coalesced: a later frame covers it
        rows_port, n_port = got
        render_rows += abs(len(rows_port) - len(rows_ref))
        render_rows += sum(1 for x, y in zip(rows_port, rows_ref)
                           if tuple(x) != tuple(y))
        render_rows += int(n_port != n_ref)
    meta_rows = sum(1 for s, v in meta_ref.items()
                    if tuple(meta_port.get(s, ())) != tuple(v))
    values = {
        "feature_rows": feature_rows,
        "label_rows": label_rows,
        "render_rows": render_rows,
        "meta_rows": meta_rows,
        "dropped_flows": int(port.get("dropped", 0)),
        "parse_errors": int(port.get("parse_errors", 0)),
        "unrendered_bursts": int(unrendered),
    }
    if "topk" in port:
        N = spec.conversations
        values["topk_rows"] = topk_rows(
            port["topk"]["latest"], newest_bursts(spec, last_burst),
            lambda s: tuple(a[s * N:(s + 1) * N] for a in ref["topk_lists"]),
            N)
    values.update(more or {})
    return {k: (v, limits[k]) for k, v in values.items()}


def passed(checks: dict) -> bool:
    return all(v <= lim for v, lim in checks.values())

"""The last line of a run: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, ``breakdown`` (traced runs) and, last, ``checks``:
every number compared, beside its limit."""

from __future__ import annotations

from . import cells


def result_line(bench: dict, cell: str, out: dict, trace: bool,
                device: dict) -> dict:
    run = out["run"]
    metrics = {}
    if trace:
        for m in cells.reported(bench, cell, "per_layer"):
            v = cells.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cells.reported(bench, cell, "end_to_end"):
            metrics[m["name"]] = {"value": out["e2e"][m["name"]][1],
                                  "unit": m["unit"]}
    device = dict(device, memory_peak_bytes=out["memory_peak_bytes"])
    checks = out["checks"]
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result

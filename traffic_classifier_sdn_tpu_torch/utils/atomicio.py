"""Crash-safe file publication — the port's copy of
``traffic_classifier_sdn_tpu/utils/atomicio.py``.

The temp-file + fsync + ``os.replace`` idiom: the final name only ever
points at complete bytes, whatever kills the writer. Fault sites
(utils/faults.py) thread through here so the chaos tests can kill a write
at either hazard point:

- ``mid_write_site`` fires with the temp file half-written (the torn state
  a SIGKILL mid-write leaves behind);
- ``pre_rename_site`` fires with a complete, fsynced temp but no commit.

A real SIGKILL cannot run the ``finally`` cleanup, so writers that own a
directory call ``sweep_stale_tmp`` at a quiet moment to collect orphaned
temp files (single-writer model: any ``.*.tmp.*`` present when no write is
in flight is garbage).
"""

from __future__ import annotations

import os
import re

from .faults import fault_point

_TMP_RE = re.compile(r"^\..*\.tmp\.\d+$")


def atomic_write_bytes(path: str, payload: bytes, *,
                       mid_write_site: str | None = None,
                       pre_rename_site: str | None = None) -> None:
    """Write ``payload`` to ``path`` via temp file + fsync + rename in the
    same directory."""
    d = os.path.dirname(os.path.abspath(path))
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
    try:
        with open(tmp, "wb") as f:
            if mid_write_site is not None:
                half = len(payload) // 2
                f.write(payload[:half])
                fault_point(mid_write_site)
                f.write(payload[half:])
            else:
                f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        if pre_rename_site is not None:
            fault_point(pre_rename_site)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def sweep_stale_tmp(directory: str) -> int:
    """Unlink orphaned temp files a killed writer left behind. Call only
    when no write is in flight (single writer). Returns the count removed."""
    removed = 0
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return 0
    for name in names:
        if _TMP_RE.match(name):
            try:
                os.unlink(os.path.join(directory, name))
                removed += 1
            except OSError:
                pass
    return removed

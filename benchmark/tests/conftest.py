"""The benchmark's CPU tests: run with

    python -m pytest benchmark/tests -q

from the root of the repository. Tests that need the card carry the
``requires_cuda`` marker and skip without one (decided inside the test)."""

from __future__ import annotations

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

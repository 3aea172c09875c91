"""ASCII table rendering — the reference's PrettyTable output
(traffic_classifier.py:99-118) without the prettytable dependency.

Column set matches the reference exactly:
``Flow ID | Src MAC | Dest MAC | Traffic Type | Forward Status | Reverse
Status``.
"""

from __future__ import annotations

from collections.abc import Iterable, Sequence

CLASSIFIER_FIELDS = (
    "Flow ID",
    "Src MAC",
    "Dest MAC",
    "Traffic Type",
    "Forward Status",
    "Reverse Status",
)


def render_table(field_names: Sequence[str], rows: Iterable[Sequence]) -> str:
    rows = [[str(c) for c in r] for r in rows]
    widths = [len(f) for f in field_names]
    for r in rows:
        for i, c in enumerate(r):
            widths[i] = max(widths[i], len(c))
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    out = [sep]
    out.append(
        "|" + "|".join(f" {f:^{w}} " for f, w in zip(field_names, widths)) + "|"
    )
    out.append(sep)
    for r in rows:
        out.append(
            "|" + "|".join(f" {c:^{w}} " for c, w in zip(r, widths)) + "|"
        )
    out.append(sep)
    return "\n".join(out)


def status_str(active: bool) -> str:
    return "ACTIVE" if active else "INACTIVE"

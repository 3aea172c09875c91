"""CLI: ``python -m traffic_classifier_sdn_tpu_torch.analysis_static``.

Exit status: 0 clean, 1 findings, 2 usage error. With no path it lints
the port's package; ``--lock-graph`` and ``--sync-budget`` write the two
artifacts the runtime witnesses cross-check against.
"""

from __future__ import annotations

import argparse
import os
import sys

from .framework import (
    LintRunner,
    _iter_py_files,
    collect_modules,
    render_report,
    render_sarif,
)
from .rules import ALL_RULES


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m traffic_classifier_sdn_tpu_torch.analysis_static",
        description="graftlint: project-native static analysis "
                    "(torch/ctypes/concurrency invariants)",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files or directories to lint (default: the package)",
    )
    parser.add_argument(
        "--json", action="store_true",
        help="machine-readable findings on stdout "
             "(schema_version-stamped)",
    )
    parser.add_argument(
        "--sarif", metavar="PATH",
        help="also write the findings as SARIF 2.1.0 to PATH, so CI "
             "can annotate them inline (always written, clean or not)",
    )
    parser.add_argument(
        "--lock-graph", metavar="PATH",
        help="write the static lock-order graph (JSON with embedded "
             "DOT) to PATH — the docs/artifacts/torch_lock_order_graph.json "
             "artifact and the runtime witness's cross-check input",
    )
    parser.add_argument(
        "--sync-budget", metavar="PATH",
        help="write the hot-path expected-sync ledger (JSON) to PATH "
             "— the docs/artifacts/torch_hot_path_sync_budget.json artifact "
             "and the syncguard runtime witness's cross-check input",
    )
    parser.add_argument(
        "--select",
        help="comma-separated rule ids to run (default: all)",
    )
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print rule ids and descriptions, then exit",
    )
    args = parser.parse_args(argv)

    rules = [cls() for cls in ALL_RULES]
    all_ids = [r.id for r in rules]
    if args.list_rules:
        for r in rules:
            print(f"{r.id:22s} {r.description}")
        return 0
    if args.select:
        wanted = {s.strip() for s in args.select.split(",") if s.strip()}
        if not wanted:
            # running zero rules would print "clean" for a tree that
            # was never linted — a typo'd --select must not pass a gate
            print("--select given but no rule ids parsed",
                  file=sys.stderr)
            return 2
        unknown = wanted - {r.id for r in rules}
        if unknown:
            print(f"unknown rule id(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        rules = [r for r in rules if r.id in wanted]

    paths = args.paths or [
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ]
    for p in paths:
        if not os.path.exists(p):
            print(f"no such path: {p}", file=sys.stderr)
            return 2
        if not os.path.isdir(p) and not p.endswith(".py"):
            # _iter_py_files would silently skip it and the run would
            # report "clean" for a target that was never linted
            print(f"not a directory or .py file: {p}", file=sys.stderr)
            return 2
    if not any(True for _ in _iter_py_files(paths)):
        # a directory holding zero .py files (typo'd data dir, emptied
        # by a refactor) would otherwise report "clean" for a target
        # that was never linted — same hazard as the non-.py guard
        print("no .py files found under the given path(s)",
              file=sys.stderr)
        return 2

    findings = LintRunner(rules, known_ids=all_ids).run(paths)
    if args.sarif:
        with open(args.sarif, "w", encoding="utf-8") as f:
            f.write(render_sarif(findings, rules))
    if args.lock_graph or args.sync_budget:
        import json as _json

        # display paths pinned to the parent of the TOPMOST enclosing
        # package (walking up through __init__.py), NOT the cwd and
        # not the scanned subtree: a subpackage scan
        # (`--lock-graph g.json pkg/serving`) must still emit
        # `pkg/serving/...` site keys, because the runtime witnesses
        # (locktrace, syncguard) normalize their observed frames
        # against the package root — anything else makes every
        # observed site "unmapped". A fresh parse, not the lint run's
        # modules: the pin changes every display path, and finding
        # paths must stay cwd-relative for editor links.
        anchor = os.path.commonpath(
            [os.path.abspath(p) for p in paths]
        )
        if os.path.isfile(anchor):
            anchor = os.path.dirname(anchor)
        while os.path.exists(os.path.join(anchor, "__init__.py")):
            anchor = os.path.dirname(anchor)
        modules, parse_errs = collect_modules(paths,
                                              relative_to=anchor)
        for fnd in parse_errs:
            # a lock or sync site in an unparseable file would
            # silently vanish from the artifact — say so (the lint
            # findings above already fail the run on the parse error)
            print(f"artifact export: skipping unparseable {fnd.path}: "
                  f"{fnd.message}", file=sys.stderr)
        if args.lock_graph:
            from .graftlock import build_graph_report

            with open(args.lock_graph, "w", encoding="utf-8") as f:
                _json.dump(build_graph_report(modules), f, indent=2,
                           sort_keys=True)
                f.write("\n")
        if args.sync_budget:
            from .graftsync import build_sync_report

            with open(args.sync_budget, "w", encoding="utf-8") as f:
                _json.dump(build_sync_report(modules), f, indent=2,
                           sort_keys=True)
                f.write("\n")
    print(render_report(findings, as_json=args.json))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())

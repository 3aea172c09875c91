#!/bin/sh
# One-shot static-analysis gate over the PyTorch port: graftlint + ruff +
# mypy. The port's counterpart of tools/lint.sh, with the same JSON
# summary and SARIF copy.
#
#   graftlint  the port's own AST rules (python -m
#              traffic_classifier_sdn_tpu_torch.analysis_static: the same
#              13 rule ids as the JAX package's, over torch's sync seams;
#              docs/TORCH_STATIC_ANALYSIS.md) — always runs, zero findings
#              required.
#   ruff       generic baseline, config pinned in [tool.ruff]
#   mypy       typing baseline over the port. [tool.mypy] in pyproject.toml
#              names the JAX package, so this script writes the port's
#              settings into a config of its own and passes the paths
#              itself.
#
# ruff/mypy are optional: when absent they are reported as "skipped" in
# the JSON summary, never silently dropped — the gate still fails if an
# INSTALLED tool finds violations. The summary lands in $LINT_SUMMARY
# (default: a per-run file under $TMPDIR, path echoed on exit): per-tool
# status plus graftlint's --json findings and the path of the SARIF 2.1.0
# copy ($LINT_SARIF, default under $TMPDIR too).
#
# Usage: tools/torch_lint.sh [paths...]   (default: the port's package)
cd "$(dirname "$0")/.." || exit 2

TMP="${TMPDIR:-/tmp}"
SUMMARY="${LINT_SUMMARY:-$TMP/torch_lint_summary.$$.json}"
[ "$#" -eq 0 ] && set -- traffic_classifier_sdn_tpu_torch

fail=0
WORK="$(mktemp -d "$TMP/torch_lint.XXXXXX")" || exit 2
trap 'rm -rf "$WORK"' EXIT

# ---- graftlint -------------------------------------------------------------
echo "=== graftlint ($*)"
GRAFT_JSON="$WORK/graftlint_findings.json"
SARIF_OUT="${LINT_SARIF:-$TMP/torch_graftlint_sarif.$$.json}"
if python -m traffic_classifier_sdn_tpu_torch.analysis_static \
     --json --sarif "$SARIF_OUT" "$@" > "$GRAFT_JSON"; then
  graftlint_status=pass
  echo "graftlint: clean"
else
  graftlint_status=fail
  fail=1
  python - "$GRAFT_JSON" <<'EOF'
import json, sys
try:
    with open(sys.argv[1]) as f:
        report = json.load(f)
except (OSError, ValueError):
    print("graftlint: usage error (no findings report)")
    sys.exit(0)
for finding in report["findings"]:
    print("{path}:{line}: [{rule}] {message}".format(**finding))
print(f"graftlint: {report['count']} finding(s)")
EOF
fi

# ---- ruff ------------------------------------------------------------------
echo "=== ruff"
if python -m ruff --version >/dev/null 2>&1; then
  if python -m ruff check "$@"; then
    ruff_status=pass
    echo "ruff: clean"
  else
    ruff_status=fail
    fail=1
  fi
else
  ruff_status=skipped
  echo "ruff: skipped (not installed; config pinned in [tool.ruff])"
fi

# ---- mypy ------------------------------------------------------------------
# The JAX package's [tool.mypy] settings, pointed at the port: the ctypes
# prototypes on dynamically loaded libraries live in the port's native/*.
echo "=== mypy ($*)"
if python -m mypy --version >/dev/null 2>&1; then
  cat > "$WORK/mypy.ini" <<'EOF'
[mypy]
python_version = 3.10
ignore_missing_imports = True
warn_unused_ignores = True
warn_redundant_casts = True
warn_unreachable = False
no_implicit_optional = True
check_untyped_defs = False

[mypy-traffic_classifier_sdn_tpu_torch.native.*]
disable_error_code = attr-defined
EOF
  if python -m mypy --config-file "$WORK/mypy.ini" "$@"; then
    mypy_status=pass
    echo "mypy: clean"
  else
    mypy_status=fail
    fail=1
  fi
else
  mypy_status=skipped
  echo "mypy: skipped (not installed; the port's settings are in this script)"
fi

# ---- summary ---------------------------------------------------------------
python - "$SUMMARY" "$GRAFT_JSON" \
    "$graftlint_status" "$ruff_status" "$mypy_status" "$SARIF_OUT" <<'EOF'
import json, os, sys
out, graft_json, graftlint, ruff, mypy, sarif = sys.argv[1:7]
try:
    with open(graft_json) as f:
        findings = json.load(f)["findings"]
except (OSError, ValueError, KeyError):
    findings = []
# the enabled rule set, read back from the SARIF driver catalog so the
# summary's list can never drift from what actually ran
try:
    with open(sarif) as f:
        rules = [r["id"] for r in
                 json.load(f)["runs"][0]["tool"]["driver"]["rules"]]
except (OSError, ValueError, KeyError, IndexError):
    rules = []
summary = {
    "tools": [
        {"name": "graftlint", "status": graftlint, "findings": findings,
         "rules": rules,
         "sarif": sarif if os.path.exists(sarif) else None},
        {"name": "ruff", "status": ruff},
        {"name": "mypy", "status": mypy},
    ],
    "ok": graftlint == "pass" and "fail" not in (ruff, mypy),
}
with open(out, "w") as f:
    json.dump(summary, f, indent=2)
print(json.dumps(summary if findings else {
    k: ([{t["name"]: t["status"]} for t in summary["tools"]]
        if k == "tools" else v)
    for k, v in summary.items()
}))
EOF

if [ "$fail" -eq 0 ]; then
  echo "torch lint: gate clean (graftlint=$graftlint_status ruff=$ruff_status mypy=$mypy_status; summary: $SUMMARY)"
  exit 0
fi
echo "torch lint: FAILURES (graftlint=$graftlint_status ruff=$ruff_status mypy=$mypy_status; summary: $SUMMARY)" >&2
exit 1

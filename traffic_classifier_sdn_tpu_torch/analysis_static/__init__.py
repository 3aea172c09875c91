"""graftlint — the port's project-native static analysis.

The port's layers are eager PyTorch on CUDA, hand-written kernels bound
through ctypes, C++ evaluators, and threaded ingest and serving — exactly
the layers where silent invariant violations (a hidden host↔device sync
on the serve tick, an un-typed CDLL call, unlocked cross-thread
mutation, an unregistered fault site, a tensor read on another CUDA
stream without a fence) produce wrong-but-plausible results or a slow
serve rather than crashes. graftlint encodes those invariants as AST
rules and enforces them in tier-1 (tests/test_torch_graftlint.py runs
the whole package through it and asserts zero findings). It is the
port's own copy of the JAX package's pass, with the device rules
retargeted to torch; both print the same 13 rule ids.

Run it:

    python -m traffic_classifier_sdn_tpu_torch.analysis_static [paths] [--json]

Suppress a finding with a trailing comment that CARRIES A REASON::

    x = risky()  # graftlint: disable=rule-id -- why this is safe

A ``disable`` comment without a reason is itself a finding
(``bad-suppression``) that cannot be suppressed. Each rule is
documented in docs/TORCH_STATIC_ANALYSIS.md.
"""

from .framework import Finding, LintRunner, Rule, lint_paths
from .rules import ALL_RULES

__all__ = ["Finding", "LintRunner", "Rule", "ALL_RULES", "lint_paths"]

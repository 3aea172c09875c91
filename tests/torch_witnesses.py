"""The port's two runtime witnesses as autouse fixtures.

The port's serve suites import these into their own namespace, as the
JAX suites get theirs from ``tests/conftest.py``: the lock witness
(``traffic_classifier_sdn_tpu_torch/utils/locktrace.py``) rides the
suites that drive real multi-thread schedules (chaos, degrade, drift,
pipeline, scenarios), and the sync witness (``utils/syncguard.py``)
the suites that drive the serve hot paths (pipeline, incremental,
degrade, drift, openset). Each test runs with the witness installed and
fails on any lock-order violation, or any host↔device sync inside a
static hot span that the budget
(``docs/artifacts/torch_hot_path_sync_budget.json``) does not allow.
A test that installs a witness of its own is left to it.
"""

import pytest

from traffic_classifier_sdn_tpu_torch.utils import locktrace, syncguard


@pytest.fixture(autouse=True)
def _torch_locktrace_witness():
    if locktrace._installed is not None:  # a test drives its own witness
        yield None
        return
    with locktrace.tracing() as witness:
        yield witness
    violations = witness.violations
    assert not violations, (
        "lock-order violations observed at runtime:\n" + "\n".join(
            f"  edge {v['edge'][0]} -> {v['edge'][1]} closes a cycle "
            f"via {' -> '.join(v['conflict_path'])} "
            f"(thread {v['thread']})"
            for v in violations
        )
    )


@pytest.fixture(autouse=True)
def _torch_syncguard_witness():
    if syncguard._installed is not None:  # a test drives its own witness
        yield None
        return
    with syncguard.guarding(budget=syncguard.load_budget()) as witness:
        yield witness
    violations = witness.violations
    assert not violations, (
        "hot-path syncs outside the static budget observed at "
        "runtime:\n" + "\n".join(
            f"  {v['kind']} at {v['site']} (thread {v['thread']})"
            for v in violations
        )
    )

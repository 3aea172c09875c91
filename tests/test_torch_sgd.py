"""The port's resumable logistic-regression trainer (``train/logreg.py``:
``SGDState``, ``make_sgd``, ``fit_sgd``), its train-state checkpoints
(``io/checkpoint.save_train_state`` / ``restore_train_state``) and the
carry of a JAX ``SGDState`` into it (``interop.sgd_state_from_numpy``).

Tolerances. Within the port a killed and resumed run is bitwise an
uninterrupted one (the minibatch of each absolute step is fixed, and the
state is saved whole). Against JAX the trainers run the same Adam in
optax's order but take the cross-entropy's gradient through different
programs (XLA's autodiff against the port's closed form), so their
float32 params drift apart by rounding: after 200 steps from a JAX state
carried across at step 100 the port's params are held to rtol 1e-4 of
JAX's uninterrupted run (measured on these seeds: a max gap of 1.0e-7 of
the largest |coef|, 3e-8 absolute on the intercepts); a whole port run
against JAX's to the same rtol (measured 1.5e-7).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_train import one_torch_thread  # noqa: F401
from traffic_classifier_sdn_tpu.io import checkpoint as jck
from traffic_classifier_sdn_tpu.train import logreg as jlogreg
from traffic_classifier_sdn_tpu_torch import interop
from traffic_classifier_sdn_tpu_torch.io import checkpoint as tck
from traffic_classifier_sdn_tpu_torch.train import logreg as tlogreg
from traffic_classifier_sdn_tpu_torch.utils import faults

N_CLASSES = 4
STEPS = 200


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _data(seed: int = 0, n: int = 500):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, N_CLASSES, n)
    X = (rng.randn(n, 12) * 3).astype(np.float32)
    X[:, 0] += y
    X[:, 5] -= 2 * y
    return X, y


def _params(m):
    return m.coef.numpy(), m.intercept.numpy()


def test_kill_and_resume_is_bitwise_the_whole_run(tmp_path):
    X, y = _data()
    whole = tlogreg.fit_sgd(X, y, N_CLASSES, n_steps=STEPS, device="cpu")
    d = str(tmp_path / "state")
    tlogreg.fit_sgd(X, y, N_CLASSES, n_steps=STEPS, checkpoint_dir=d,
                    checkpoint_every=50, stop_at_step=120, device="cpu")
    with open(os.path.join(d, "manifest.json")) as f:
        assert json.load(f)["step"] == 100  # the last periodic save
    resumed = tlogreg.fit_sgd(X, y, N_CLASSES, n_steps=STEPS,
                              checkpoint_dir=d, checkpoint_every=50,
                              device="cpu")
    for a, b in zip(_params(resumed), _params(whole)):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    with open(os.path.join(d, "manifest.json")) as f:
        assert json.load(f)["step"] == STEPS
    # a finished state resumes to the same params with no step left
    again = tlogreg.fit_sgd(X, y, N_CLASSES, n_steps=STEPS, checkpoint_dir=d,
                            checkpoint_every=50, device="cpu")
    assert torch.equal(again.coef, whole.coef)


def test_whole_run_within_rtol_of_jax():
    X, y = _data()
    want = jlogreg.fit_sgd(X, y, N_CLASSES, n_steps=STEPS)
    got = tlogreg.fit_sgd(X, y, N_CLASSES, n_steps=STEPS, device="cpu")
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(want.coef),
                               rtol=1e-4, atol=1e-4 * np.abs(
                                   np.asarray(want.coef)).max())
    np.testing.assert_allclose(got.intercept.numpy(),
                               np.asarray(want.intercept), rtol=1e-4,
                               atol=1e-6)


def test_state_leaves_in_jax_tree_order():
    """The port's leaves have the shapes and dtypes of JAX's
    ``tree_leaves(SGDState)``, position by position."""
    jinit, _ = jlogreg.make_sgd(1e-2)
    tinit, _ = tlogreg.make_sgd(1e-2, device="cpu")
    jl = [np.asarray(a) for a in jax.tree_util.tree_leaves(jinit(3, 12))]
    tl = [a.numpy() for a in tinit(3, 12).leaves()]
    assert [(a.shape, a.dtype) for a in tl] == [(a.shape, a.dtype)
                                                for a in jl]
    assert [a.shape for a in tl] == [(3, 12), (3,), (), (3, 12), (3,),
                                     (3, 12), (3,)]


def test_jax_state_carried_across_resumes_near_jax(tmp_path):
    """A JAX ``SGDState`` saved at step 100 of 200, carried across with
    ``interop.sgd_state_from_numpy`` and saved as the port's train state:
    the port's ``fit_sgd`` resumes it to params within rtol 1e-4 of JAX's
    uninterrupted run."""
    X, y = _data(1)
    want = jlogreg.fit_sgd(X, y, N_CLASSES, n_steps=STEPS)
    jdir = str(tmp_path / "jax")
    jlogreg.fit_sgd(X, y, N_CLASSES, n_steps=STEPS, checkpoint_dir=jdir,
                    checkpoint_every=100, stop_at_step=100)
    jinit, _ = jlogreg.make_sgd(1e-2)
    jstate, step = jck.restore_train_state(jdir, jinit(N_CLASSES, 12))
    assert step == 100
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(jstate)]
    state = interop.sgd_state_from_numpy(leaves, device="cpu")
    for a, b in zip(state.leaves(), leaves):  # carried bit for bit
        assert np.array_equal(a.numpy(), b) and a.numpy().dtype == b.dtype
    tdir = str(tmp_path / "port")
    tck.save_train_state(tdir, state, step)
    got = tlogreg.fit_sgd(X, y, N_CLASSES, n_steps=STEPS, checkpoint_dir=tdir,
                          checkpoint_every=100, device="cpu")
    scale = np.abs(np.asarray(want.coef)).max()
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(want.coef),
                               rtol=1e-4, atol=1e-4 * scale)
    np.testing.assert_allclose(got.intercept.numpy(),
                               np.asarray(want.intercept), rtol=1e-4,
                               atol=1e-6)


def test_manifest_fields_and_restore(tmp_path):
    X, y = _data()
    init, step = tlogreg.make_sgd(1e-2, device="cpu")
    state = init(N_CLASSES, 12)
    for i in range(3):
        state, loss = step(state, torch.from_numpy(X[i * 8:(i + 1) * 8]),
                           torch.from_numpy(y[i * 8:(i + 1) * 8]))
        assert np.isfinite(float(loss))
    d = str(tmp_path / "s")
    tck.save_train_state(d, state, 3)
    with open(os.path.join(d, "manifest.json")) as f:
        m = json.load(f)
    assert (m["kind"], m["step"], m["n_leaves"]) == ("train_state", 3, 7)
    assert m["dtypes"]["leaf_2"] == "int32" and m["dtypes"]["leaf_0"] == \
        "float32"
    got, at = tck.restore_train_state(d, init(N_CLASSES, 12))
    assert at == 3 and int(got.opt_state.count) == 3
    for a, b in zip(got.leaves(), state.leaves()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="leaves"):
        tck.restore_train_state(d, init(N_CLASSES, 12)._replace(
            params=(state.params[0],)))


@pytest.mark.chaos
def test_train_state_write_fault_keeps_the_previous_step(tmp_path):
    """A save that fails at its commit (``train_ckpt.write``) leaves the
    previous state whole: the restore gives the earlier step's leaves."""
    X, y = _data()
    init, step = tlogreg.make_sgd(1e-2, device="cpu")
    s1, _ = step(init(N_CLASSES, 12), torch.from_numpy(X[:16]),
                 torch.from_numpy(y[:16]))
    s2, _ = step(s1, torch.from_numpy(X[16:32]), torch.from_numpy(y[16:32]))
    d = str(tmp_path / "s")
    tck.save_train_state(d, s1, 1)
    plan = faults.FaultPlan([faults.FaultRule("train_ckpt.write")])
    with faults.installed(plan), pytest.raises(faults.FaultInjected):
        tck.save_train_state(d, s2, 2)
    got, at = tck.restore_train_state(d, init(N_CLASSES, 12))
    assert at == 1
    for a, b in zip(got.leaves(), s1.leaves()):
        assert torch.equal(a, b)
    assert len([n for n in os.listdir(d) if n.startswith("arrays")]) == 1

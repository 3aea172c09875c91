"""The port's data-parallel trainers (``train/distributed.py``) over a
CPU mesh that repeats the one CPU device four times, against the JAX
package's over the test harness's 8 virtual CPU devices, against the
port's single-device trainers (the same fits on a one-device mesh, so
these hold the four shards to one), and ``serving/retrain.fit_family``'s
routing through them.

Tolerances:

- ``fit_gnb``: the folded moments within 1e-6 relative of JAX's (both
  float64; the fold rounds once to float32), and within 1e-12 of the
  port's single-device fit (the shard sums add in another order);
- ``fit_kmeans``: assignments equal — to the port's single-device fit
  (same seed), and the sharded Lloyd step from JAX's initial centers to
  JAX's ``_lloyd``;
- ``fit_forest``: node stacks bitwise the port's single-device fit with
  the same seed, and bitwise JAX's distributed fit given JAX's draws
  (integer-valued float32 counts add exactly in any order);
- ``fit_svc``: decisions within 1e-5 of the largest coefficient sum (the
  sharded SVC tests' tolerance) of the port's single-device fit, and held-out
  accuracy within 0.02 of JAX's distributed fit (the trainer rule).

N = 301 rows: not a multiple of 4 or 8, so padding rows (``y = -1``,
weight 0) or trimming are exercised in every fit.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_train import blobs, jax_draws, one_torch_thread  # noqa: F401
from traffic_classifier_sdn_tpu.models import gnb as jgnb
from traffic_classifier_sdn_tpu.models import svc as jsvc
from traffic_classifier_sdn_tpu.parallel import mesh as jmeshlib
from traffic_classifier_sdn_tpu.train import distributed as jdist
from traffic_classifier_sdn_tpu.train import kmeans as jkmeans
from traffic_classifier_sdn_tpu_torch.parallel import mesh as meshlib
from traffic_classifier_sdn_tpu_torch.serving import retrain
from traffic_classifier_sdn_tpu_torch.train import distributed as dist
from traffic_classifier_sdn_tpu_torch.train import forest as tforest
from traffic_classifier_sdn_tpu_torch.train import gnb as tgnb
from traffic_classifier_sdn_tpu_torch.train import kmeans as tkmeans
from traffic_classifier_sdn_tpu_torch.train import svc as tsvc

N = 301
SHARDS = 4
FOREST_FIELDS = ("left", "right", "feature", "threshold", "values")


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _data_mesh():
    return meshlib.make_mesh(devices=["cpu"] * SHARDS)


def _jax_mesh(n_state: int = 1):
    devs = jax.devices()[:8]
    return jmeshlib.make_mesh(n_data=8 // n_state, n_state=n_state,
                              devices=devs)


def test_fit_gnb_within_1e6_of_jax_and_excludes_padding():
    X, y = blobs(0, N, n_classes=4)
    got = dist.fit_gnb(_data_mesh(), X, y, 4)
    want = jdist.fit_gnb(_jax_mesh(), X, y, 4)
    # the 301 rows alone: the 3 padding rows of the 4-shard fit count in
    # no count, sum or prior
    single = tgnb.fit(X, y, 4, device="cpu")
    for k in ("theta", "inv_var", "log_const"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   getattr(single, k).numpy(), rtol=1e-12,
                                   err_msg=k)


def test_fit_gnb_absent_class():
    """A class with no rows: every other class's moments stay finite (the
    padding rows gather class 0, never the absent class's NaN mean)."""
    X, y = blobs(1, N, n_classes=3)
    got = dist.fit_gnb(_data_mesh(), X, y, 4)
    want = jdist.fit_gnb(_jax_mesh(), X, y, 4)
    for k in ("theta", "inv_var", "log_const"):
        a, b = getattr(got, k).numpy(), np.asarray(getattr(want, k))
        fin = np.isfinite(b)
        assert (np.isfinite(a) == fin).all(), k
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-6, err_msg=k)


def test_fit_kmeans_assignments_equal_the_single_device_fit():
    X, _ = blobs(2, N, n_classes=4)
    got, g_inertia = dist.fit_kmeans(_data_mesh(), X, k=4, n_init=3,
                                     n_iter=20, seed=5)
    want, w_inertia = tkmeans.fit(X[:N - N % SHARDS], k=4, n_init=3,
                                  n_iter=20, seed=5, device="cpu")
    Xt = torch.from_numpy(X)
    assert torch.equal(got.predict(Xt), want.predict(Xt))
    np.testing.assert_allclose(g_inertia, w_inertia, rtol=1e-6)


def test_sharded_lloyd_from_jax_centers_assigns_as_jax():
    X, _ = blobs(3, 296, n_classes=4)
    Xj = jax.numpy.asarray(X)
    c0 = jkmeans._plusplus_init(jax.random.key(1), Xj, 4)
    jc, _ = jkmeans._lloyd(Xj, c0, 15)
    shards = meshlib.batch_sharded(_data_mesh(), torch.from_numpy(X))
    tc, _ = tkmeans._lloyd(shards, torch.from_numpy(np.array(c0)), 15)
    want = np.asarray(jkmeans._assign(Xj, jc)[0])
    got = tkmeans._assign(torch.from_numpy(X), tc)[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_fit_forest_equals_the_single_device_fit():
    X, y = blobs(4, N, n_classes=3)
    kw = dict(n_trees=4, max_depth=5, n_bins=32, seed=9)
    got = dist.fit_forest(_data_mesh(), X, y, 3, **kw)
    want = tforest.fit(X, y, 3, device="cpu", **kw)
    for f in FOREST_FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_fit_forest_equals_jax_distributed_given_jax_draws(monkeypatch):
    """JAX's draws handed to the port's builder (as test_torch_train does
    for the single-device fit): the 4-shard port forest equals JAX's
    8-device one bit for bit."""
    X, y = blobs(5, N, n_classes=3)
    kw = dict(n_trees=3, max_depth=4, n_bins=16, seed=2)
    draws = jax_draws(kw["seed"], kw["n_trees"], N, 12, kw["max_depth"],
                      True, 3)

    def recorded(gen, tree, n_rows, n_features, max_depth, **_):
        w, scores = draws[tree]
        return (torch.from_numpy(w), [torch.from_numpy(s) for s in scores])

    monkeypatch.setattr(tforest, "tree_draws", recorded)
    got = dist.fit_forest(_data_mesh(), X, y, 3, **kw)
    want = jdist.fit_forest(_jax_mesh(), X, y, 3, **kw)
    for f in FOREST_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


def test_fit_svc_over_state_shards():
    X, y = blobs(6, 240, n_classes=4, spread=0.6)
    Xte, yte = blobs(7, 200, n_classes=4, spread=0.6)
    mesh = meshlib.make_mesh(n_data=1, n_state=SHARDS,
                             devices=["cpu"] * SHARDS)
    got = dist.fit_svc(mesh, X, y, 4, n_iters=150)  # 6 pairs: 2 padding
    want = tsvc.fit(X, y, 4, n_iters=150, device="cpu")
    Xt = torch.from_numpy(Xte)
    atol = 1e-5 * float(want.pair_coef.abs().sum(1).max())
    np.testing.assert_allclose(got.decision_ovo(Xt).numpy(),
                               want.decision_ovo(Xt).numpy(), atol=atol)
    jwant = jdist.fit_svc(_jax_mesh(n_state=2), X, y, 4, n_iters=150)
    j_acc = float(np.mean(np.asarray(jsvc.predict(jwant, Xte)) == yte))
    t_acc = float(np.mean(got.predict(Xt).numpy() == yte))
    assert abs(t_acc - j_acc) <= 0.02, (t_acc, j_acc)


@pytest.mark.parametrize("family", ["gnb", "kmeans", "forest", "svc"])
def test_fit_family_routes_through_distributed(monkeypatch, family):
    """``fit_family`` fits these four on a one-device mesh of its device."""
    calls = []
    fn = getattr(dist, f"fit_{family}")

    def spy(mesh, *a, **kw):
        calls.append([str(d) for d in mesh.devices.ravel()])
        return fn(mesh, *a, **kw)

    monkeypatch.setattr(dist, f"fit_{family}", spy)
    X, y = blobs(8, 120, n_classes=3)
    small = {"forest": {"n_trees": 2}, "svc": {"n_iters": 50},
             "kmeans": {"n_init": 2}}.get(family, {})
    params = retrain.fit_family(family, X, y, 3, device="cpu", **small)
    assert calls == [["cpu"]]
    assert params.predict(torch.from_numpy(X)).shape == (120,)

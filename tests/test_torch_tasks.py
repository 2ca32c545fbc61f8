"""The port's tasks against the JAX package's: one ``local_train`` call
and ``evaluate`` from the reference's init, carried across with
``params_from_jax``, on the same client data.

Tolerances: rtol 1e-5 / atol 1e-6 for the linear tasks; the CNN's
convolutions sum in another order in each framework, so rtol 1e-4 /
atol 1e-5 there.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data import make_images, make_regression, make_svm, partition
from repro.data import tasks as jtasks
from repro.kernels.ops import pack_spec
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.data import tasks as ttasks

SIZES = np.array([20, 30, 14])     # m = 3 clients


def _build(name):
    """(jax task, port task, rtol, atol) on identical numpy client data."""
    if name == 'regression':
        x, y = make_regression(n=80)
        data = partition(x, y, SIZES, 5, seed=1)
        return (jtasks.regression_task(data, lr=1e-3, epochs=2),
                ttasks.regression_task(data, lr=1e-3, epochs=2,
                                       device='cpu'), 1e-5, 1e-6)
    if name == 'svm':
        x, y = make_svm(n=80)
        data = partition(x, y, SIZES, 5, seed=1)
        return (jtasks.svm_task(data, lr=1e-2, epochs=2),
                ttasks.svm_task(data, lr=1e-2, epochs=2, device='cpu'),
                1e-5, 1e-6)
    x, y = make_images(n=64)
    data = partition(x, y, SIZES, 8, seed=1)
    return (jtasks.cnn_task(data, lr=1e-3, epochs=1),
            ttasks.cnn_task(data, lr=1e-3, epochs=1, device='cpu'),
            1e-4, 1e-5)


@pytest.fixture(scope='module', params=['regression', 'svm', 'cnn'])
def pair(request):
    jt, tt, rtol, atol = _build(request.param)
    g = {k: np.array(v) for k, v in
         jt.init_global(jax.random.PRNGKey(0)).items()}
    return jt, tt, g, rtol, atol


def _stack(g, m, seed):
    """m client replicas of g, each nudged by seeded noise so the clients
    start apart."""
    rng = np.random.default_rng(seed)
    return {k: (v[None] + 0.01 * rng.normal(size=(m,) + v.shape))
            .astype(np.float32) for k, v in g.items()}


def test_local_train_matches_reference(pair):
    jt, tt, g, rtol, atol = pair
    stacked = _stack(g, len(SIZES), seed=0)
    want = jt.local_train(stacked, 1)
    got = params_to_numpy(tt.local_train(params_from_jax(stacked, 'cpu'), 1))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == np.asarray(want[k]).shape
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


def test_evaluate_matches_reference(pair):
    jt, tt, g, rtol, atol = pair
    want = jt.evaluate(g)
    got = tt.evaluate(params_from_jax(g, 'cpu'))
    for key in ('loss', 'acc'):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol)


def test_fingerprint_matches_reference(pair):
    jt, tt, _, _, _ = pair
    assert tt.fingerprint() == jt.fingerprint()


def test_own_init_has_reference_layout(pair):
    jt, tt, g, _, _ = pair
    mine = tt.init_global(0)
    assert sorted(mine) == sorted(g)
    for k in g:
        assert tuple(mine[k].shape) == g[k].shape
        assert mine[k].dtype == torch.float32
    assert pack_spec(params_to_numpy(mine)).offsets == pack_spec(g).offsets
    again = tt.init_global(0)
    assert all(torch.equal(mine[k], again[k]) for k in mine)


def test_task_on_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    x, y = make_regression(n=40)
    data = partition(x, y, SIZES, 5)
    with pytest.raises(RuntimeError, match='cuda'):
        ttasks.regression_task(data)

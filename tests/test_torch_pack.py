"""Pack layout of the PyTorch port against the JAX package's: offsets,
sizes and padding per task model, identical buffers from the same numpy
params, and the pack/unpack round trip."""
import jax
import numpy as np
import pytest
import torch

from repro.data import make_images, make_regression, make_svm, partition
from repro.data import tasks as jtasks
from repro.kernels import ops as jops
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops as tops


def _data(name):
    sizes = np.array([20, 30, 14])
    if name == 'regression':
        x, y = make_regression(n=80)
        return jtasks.regression_task(partition(x, y, sizes, 5))
    if name == 'svm':
        x, y = make_svm(n=80)
        return jtasks.svm_task(partition(x, y, sizes, 5))
    x, y = make_images(n=80)
    return jtasks.cnn_task(partition(x, y, sizes, 8))


@pytest.fixture(scope='module', params=['regression', 'svm', 'cnn'])
def params(request):
    """(numpy params of the task's JAX init, stacked numpy [3, ...] params
    drawn from a seeded rng)."""
    g = {k: np.asarray(v) for k, v in
         _data(request.param).init_global(jax.random.PRNGKey(0)).items()}
    rng = np.random.default_rng(1)
    stacked = {k: rng.normal(size=(3,) + v.shape).astype(np.float32)
               for k, v in g.items()}
    return g, stacked


@pytest.mark.parametrize('layout', ['pack_spec', 'wire_spec'])
def test_spec_matches_reference(params, layout):
    g, _ = params
    js = getattr(jops, layout)(g)
    ts = getattr(tops, layout)(params_from_jax(g, 'cpu'))
    assert ts.offsets == js.offsets
    assert ts.sizes == js.sizes
    assert ts.shapes == js.shapes
    assert (ts.n_total, ts.n_padded) == (js.n_total, js.n_padded)


def test_cnn_offsets_follow_sorted_leaf_order():
    g = {k: np.asarray(v) for k, v in
         _data('cnn').init_global(jax.random.PRNGKey(0)).items()}
    tg = params_from_jax(g, 'cpu')
    assert tops.pack_spec(tg).keys == ('b1', 'b2', 'c1', 'c2', 'f1', 'f2',
                                       'fb1', 'fb2')
    assert tops.pack_spec(tg).offsets == (0, 20, 70, 570, 25570, 339170,
                                          340450, 340578)
    assert tops.wire_spec(tg).offsets == (0, 128, 256, 768, 25856, 339456,
                                          340736, 340864)
    assert tops.wire_spec(tg).n_padded == tops.pack_spec(tg).n_padded \
        == 342016


@pytest.mark.parametrize('layout', ['pack_spec', 'wire_spec'])
def test_buffers_equal_reference(params, layout):
    g, stacked = params
    js = getattr(jops, layout)(g)
    ts = getattr(tops, layout)(params_from_jax(g, 'cpu'))
    np.testing.assert_array_equal(
        tops.pack_global(params_from_jax(g, 'cpu'), ts).numpy(),
        np.asarray(jops.pack_global(g, js)))
    np.testing.assert_array_equal(
        tops.pack_stacked(params_from_jax(stacked, 'cpu'), ts).numpy(),
        np.asarray(jops.pack_stacked(stacked, js)))


@pytest.mark.parametrize('layout', ['pack_spec', 'wire_spec'])
def test_pack_unpack_round_trip(params, layout):
    g, stacked = params
    tg, ts = params_from_jax(g, 'cpu'), params_from_jax(stacked, 'cpu')
    spec = getattr(tops, layout)(tg)
    back_g = tops.unpack_global(tops.pack_global(tg, spec), spec)
    back_s = tops.unpack_stacked(tops.pack_stacked(ts, spec), spec)
    for k in tg:
        assert torch.equal(back_g[k], tg[k])
        assert torch.equal(back_s[k], ts[k])


def test_comm_bytes_matches_reference(params):
    g, _ = params
    tg = params_from_jax(g, 'cpu')
    for quantized in (False, True):
        for layout in ('tree', 'packed'):
            assert tops.comm_bytes(tg, quantized, layout=layout) == \
                jops.comm_bytes(g, quantized, layout=layout)

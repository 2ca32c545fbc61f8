"""The port's protocol algebra against the JAX package's on identical
masks: Eq. 3 ``distribute``, ``classify_versions``, Eq. 6/7/8 and one
``safa_round`` for every ``use_kernel`` and ``wire``.

Tolerances: selects agree exactly; the Eq. 7 sums run in another order,
so globals are held to rtol 1e-6 / atol 1e-6.  Under the int8 wire the
locals and caches are selects of q * scale, and on these inputs every
scale agrees between the packages, so they too must match exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import protocol as jp
from repro_torch.core import protocol as tp

M = 6
SHAPES = {'b': (), 'k': (3, 5, 2), 'w': (40,)}   # a small model dict


def _tree(rng, lead=()):
    return {k: rng.uniform(-1, 1, lead + s).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.fixture(scope='module')
def state():
    rng = np.random.default_rng(0)
    masks = {k: rng.random(M) < 0.5
             for k in ('sync', 'completed', 'picked', 'undrafted',
                       'deprecated')}
    masks['picked'] |= np.eye(M, dtype=bool)[0]
    masks['deprecated'] |= np.eye(M, dtype=bool)[1]
    w = rng.dirichlet(np.ones(M)).astype(np.float32)
    return dict(g=_tree(rng), local=_tree(rng, (M,)), cache=_tree(rng, (M,)),
                trained=_tree(rng, (M,)), masks=masks, w=w)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got, want, rtol=0.0, atol=0.0):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


def test_distribute(state):
    s = state['masks']['sync']
    _close(tp.distribute(_t(state['g']), _t(state['local']),
                         torch.from_numpy(s)),
           jp.distribute(_j(state['g']), _j(state['local']), jnp.asarray(s)))


@pytest.mark.parametrize('committed_prev', [False, True])
def test_classify_versions(committed_prev):
    rng = np.random.default_rng(1)
    v = rng.integers(0, 9, 20)
    cp = rng.random(20) < 0.3 if committed_prev else None
    want = jp.classify_versions(jnp.asarray(v), 9, 4,
                                None if cp is None else jnp.asarray(cp))
    got = tp.classify_versions(torch.from_numpy(v), 9, 4,
                               None if cp is None else torch.from_numpy(cp))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the host event process calls it on numpy arrays
    for a, b in zip(tp.classify_versions(v, 9, 4, cp), want):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_eq6_eq7_eq8(state):
    m = state['masks']
    pk, dp, ud = (torch.from_numpy(m[k])
                  for k in ('picked', 'deprecated', 'undrafted'))
    c1 = tp.pre_agg_cache_update(_t(state['cache']), _t(state['trained']),
                                 _t(state['g']), pk, dp)
    jc1 = jp.pre_agg_cache_update(_j(state['cache']), _j(state['trained']),
                                  _j(state['g']), jnp.asarray(m['picked']),
                                  jnp.asarray(m['deprecated']))
    _close(c1, jc1)
    _close(tp.aggregate(c1, torch.from_numpy(state['w'])),
           jp.aggregate(jc1, jnp.asarray(state['w'])), rtol=1e-6, atol=1e-6)
    _close(tp.post_agg_cache_update(c1, _t(state['trained']), ud),
           jp.post_agg_cache_update(jc1, _j(state['trained']),
                                    jnp.asarray(m['undrafted'])))


def _train(p, r):
    """A stand-in for local training, the same math on either framework."""
    del r
    return {k: v * 0.9 + 0.05 for k, v in p.items()}


@pytest.mark.parametrize('use_kernel,wire', [
    (False, 'f32'), (True, 'f32'), ('packed', 'f32'), (False, 'int8')])
def test_safa_round(state, use_kernel, wire):
    m = state['masks']
    kw = dict(use_kernel=use_kernel, wire=wire)
    want = jp.safa_round(
        _j(state['g']), _j(state['local']), _j(state['cache']),
        sync_mask=jnp.asarray(m['sync']),
        completed=jnp.asarray(m['completed']),
        picked=jnp.asarray(m['picked']), undrafted=jnp.asarray(m['undrafted']),
        deprecated=jnp.asarray(m['deprecated']),
        weights=jnp.asarray(state['w']), local_train_fn=_train,
        train_args=(1,), **kw)
    got = tp.safa_round(
        _t(state['g']), _t(state['local']), _t(state['cache']),
        sync_mask=torch.from_numpy(m['sync']),
        completed=torch.from_numpy(m['completed']),
        picked=torch.from_numpy(m['picked']),
        undrafted=torch.from_numpy(m['undrafted']),
        deprecated=torch.from_numpy(m['deprecated']),
        weights=torch.from_numpy(state['w']), local_train_fn=_train,
        train_args=(1,), **kw)
    new_global, new_local, new_cache = got
    _close(new_global, want[0], rtol=1e-6, atol=1e-6)
    _close(new_local, want[1])
    _close(new_cache, want[2])


def test_unknown_wire_and_kernel_modes_raise(state):
    with pytest.raises(ValueError, match='unknown wire'):
        tp.check_wire('fp16')
    m = state['masks']
    with pytest.raises(ValueError, match='unknown use_kernel'):
        tp.discriminative_aggregation(
            _t(state['cache']), _t(state['trained']), _t(state['g']),
            picked=torch.from_numpy(m['picked']),
            undrafted=torch.from_numpy(m['undrafted']),
            deprecated=torch.from_numpy(m['deprecated']),
            weights=torch.from_numpy(state['w']), use_kernel='fused')

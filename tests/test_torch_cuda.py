"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small shapes, including a client count above the kernels'
shared-memory chunk of 256.  Needs an NVIDIA GPU (marker ``cuda``; skips
without one).  The file imports no JAX, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: caches, locals, q and scales are selects, one multiply or one
IEEE division, so they match exactly; new_global is a sum taken in
another order, held to rtol 1e-5 / atol 1e-6.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import backend, ref
from repro_torch.kernels.comm_quant import quantize_packed
from repro_torch.kernels.safa_aggregate import (safa_aggregate,
                                                safa_aggregate_packed,
                                                safa_aggregate_packed_q8)

pytestmark = pytest.mark.cuda

SHAPES = [(5, 4096), (100, 2048), (300, 2048)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (torch.cuda.is_available() is '
                    'False)')
    backend.reset_launches()
    return torch.device('cuda')


def _inputs(m, n, dev, seed=0):
    rng = np.random.default_rng(seed)
    t = {k: torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                            device=dev)
         for k, shape in (('cache', (m, n)), ('trained', (m, n)),
                          ('base', (m, n)), ('global_prev', (n,)))}
    t['weights'] = torch.as_tensor(rng.dirichlet(np.ones(m)),
                                   dtype=torch.float32, device=dev)
    for k in ('picked', 'undrafted', 'deprecated', 'completed'):
        t[k] = torch.as_tensor(rng.random(m) < 0.4, device=dev)
    return t


AGG = ('trained', 'global_prev', 'picked', 'undrafted', 'deprecated',
       'weights')


@pytest.mark.parametrize('m,n', SHAPES)
def test_aggregate_packed_matches_plain(dev, m, n):
    t = _inputs(m, n, dev)
    want_g, want_c = ref.safa_aggregate_ref(t['cache'], *(t[k] for k in AGG))
    cache = t['cache'].clone()
    got_g, got_c = safa_aggregate_packed(cache, *(t[k] for k in AGG))
    torch.cuda.synchronize()
    assert got_c is cache
    assert torch.equal(got_c, want_c)
    torch.testing.assert_close(got_g, want_g, rtol=1e-5, atol=1e-6)
    assert backend.LAUNCHES['safa_aggregate_packed'] == 1


@pytest.mark.parametrize('m,n', [(5, 1000), (300, 3000)])
def test_aggregate_per_leaf_matches_plain(dev, m, n):
    t = _inputs(m, n, dev, seed=1)
    want_g, want_c = ref.safa_aggregate_ref(t['cache'], *(t[k] for k in AGG))
    got_g, got_c = safa_aggregate(t['cache'], *(t[k] for k in AGG))
    torch.cuda.synchronize()
    assert torch.equal(got_c, want_c)
    torch.testing.assert_close(got_g, want_g, rtol=1e-5, atol=1e-6)
    assert backend.LAUNCHES['safa_aggregate'] == 1


@pytest.mark.parametrize('m,n', SHAPES)
def test_quantize_packed_matches_plain(dev, m, n):
    x = _inputs(m, n, dev, seed=2)['trained'] * 3
    x[0, :128] = 0.0                      # an all-zero block: scale 1e-30/127
    want_q, want_s = ref.quantize_packed_ref(x)
    got_q, got_s = quantize_packed(x)
    torch.cuda.synchronize()
    assert torch.equal(got_q, want_q)
    assert torch.equal(got_s, want_s)
    assert backend.LAUNCHES['quantize_packed'] == 1


@pytest.mark.parametrize('m,n', SHAPES)
def test_aggregate_q8_matches_plain(dev, m, n):
    t = _inputs(m, n, dev, seed=3)
    q, s = ref.quantize_packed_ref(t['trained'])
    args = ('global_prev', 'picked', 'undrafted', 'deprecated', 'completed',
            'weights')
    want = ref.safa_aggregate_q8_ref(q, s, t['base'], t['cache'],
                                     *(t[k] for k in args))
    cache = t['cache'].clone()
    got = safa_aggregate_packed_q8(q, s, t['base'], cache,
                                   *(t[k] for k in args))
    torch.cuda.synchronize()
    assert got[1] is cache
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    assert backend.LAUNCHES['safa_aggregate_packed_q8'] == 1


def test_operand_on_another_device_raises(dev):
    t = _inputs(4, 2048, dev)
    with pytest.raises(ValueError, match='weights'):
        safa_aggregate_packed(t['cache'], t['trained'], t['global_prev'],
                              t['picked'], t['undrafted'], t['deprecated'],
                              t['weights'].cpu())
    assert backend.LAUNCHES['safa_aggregate_packed'] == 0

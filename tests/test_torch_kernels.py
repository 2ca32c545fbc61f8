"""The port's kernel wrappers on CPU tensors (their plain PyTorch
versions) against the JAX package's Pallas kernels run in interpret mode,
on the same seeded numpy inputs.

Tolerances: the Eq. 7 sum runs in another order on each side, so
new_global is held to rtol 1e-6 / atol 1e-7; the inputs are drawn
positive so no sum cancels below that.  Caches and locals are selects and
one multiply, so they match exactly.  Scales match to rtol 1e-6 and q to
+-1 where a scale differs: the JAX package's own formulations disagree on
some scales by one ulp.
"""
import numpy as np
import pytest
import torch

from repro.kernels.comm_quant import quantize_packed as j_quantize_packed
from repro.kernels.safa_aggregate import (
    safa_aggregate_packed as j_safa_aggregate_packed,
    safa_aggregate_packed_q8 as j_safa_aggregate_packed_q8)
from repro_torch.kernels import backend, ref
from repro_torch.kernels.comm_quant import quantize_packed
from repro_torch.kernels.safa_aggregate import (safa_aggregate,
                                                safa_aggregate_packed,
                                                safa_aggregate_packed_q8)

SHAPES = [(6, 4096), (5, 2048)]


def _inputs(m, n, seed=0):
    rng = np.random.default_rng(seed)
    arr = {
        'cache': rng.uniform(0.5, 1.5, (m, n)).astype(np.float32),
        'trained': rng.uniform(0.5, 1.5, (m, n)).astype(np.float32),
        'base': rng.uniform(0.5, 1.5, (m, n)).astype(np.float32),
        'global_prev': rng.uniform(0.5, 1.5, n).astype(np.float32),
        'weights': rng.dirichlet(np.ones(m)).astype(np.float32),
    }
    for name in ('picked', 'undrafted', 'deprecated', 'completed'):
        arr[name] = rng.random(m) < 0.5
    arr['picked'][0], arr['deprecated'][1] = True, True
    return arr


def _t(arr):
    return {k: torch.from_numpy(np.array(v)) for k, v in arr.items()}


AGG_ARGS = ('cache', 'trained', 'global_prev', 'picked', 'undrafted',
            'deprecated', 'weights')


@pytest.fixture(autouse=True)
def _zero_launches():
    backend.reset_launches()
    yield
    assert all(v == 0 for v in backend.LAUNCHES.values()), \
        'a wrapper launched a kernel on CPU tensors'


def _quantized(x):
    """Quantise with the JAX package so both sides see one wire."""
    q, s = j_quantize_packed(x)
    return np.array(q), np.array(s)


@pytest.mark.parametrize('m,n', SHAPES)
def test_aggregate_packed_matches_reference(m, n):
    a = _inputs(m, n)
    jg, jc = j_safa_aggregate_packed(*(a[k] for k in AGG_ARGS))
    t = _t(a)
    cache = t['cache']
    tg, tc = safa_aggregate_packed(*(t[k] for k in AGG_ARGS))
    assert tc is cache                   # written in place, like the kernel
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize('m,n', SHAPES)
def test_aggregate_per_leaf_matches_packed(m, n):
    a = _inputs(m, n, seed=1)
    t = _t(a)
    pg, pc = safa_aggregate_packed(*(_t(a)[k] for k in AGG_ARGS))
    g, c = safa_aggregate(*(t[k] for k in AGG_ARGS))
    assert torch.equal(g, pg) and torch.equal(c, pc)
    assert torch.equal(t['cache'], torch.from_numpy(a['cache']))  # fresh out


@pytest.mark.parametrize('m,n', SHAPES)
def test_quantize_packed_matches_reference(m, n):
    x = np.random.default_rng(2).normal(size=(m, n)).astype(np.float32) * 3
    jq, js = _quantized(x)
    tq, ts = quantize_packed(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-6)
    same_scale = np.repeat(ts.numpy() == js, 128, axis=1)
    np.testing.assert_array_equal(tq.numpy()[same_scale], jq[same_scale])
    assert np.abs(tq.numpy().astype(int) - jq.astype(int)).max() <= 1


@pytest.mark.parametrize('m,n', SHAPES)
def test_quantize_packed_matches_numpy_oracle(m, n):
    """Scales and q bit for bit against a float32 numpy statement of the
    same math (IEEE division, half-to-even rounding)."""
    x = np.random.default_rng(3).normal(size=(m, n)).astype(np.float32)
    xb = x.reshape(m, n // 128, 128)
    scale = np.maximum(np.abs(xb).max(axis=2, keepdims=True),
                       np.float32(1e-30)) / np.float32(127)
    q = np.clip(np.rint(xb / scale), -127, 127).astype(np.int8)
    tq, ts = quantize_packed(torch.from_numpy(x))
    np.testing.assert_array_equal(ts.numpy(), scale.reshape(m, -1))
    np.testing.assert_array_equal(tq.numpy(), q.reshape(m, n))


@pytest.mark.parametrize('m,n', SHAPES)
def test_aggregate_q8_matches_reference(m, n):
    a = _inputs(m, n, seed=4)
    q, s = _quantized(a['trained'])
    args = ('base', 'cache', 'global_prev', 'picked', 'undrafted',
            'deprecated', 'completed', 'weights')
    jg, jc, jl = j_safa_aggregate_packed_q8(q, s, *(a[k] for k in args))
    t = _t(a)
    cache = t['cache']
    tg, tc, tl = safa_aggregate_packed_q8(torch.from_numpy(q),
                                          torch.from_numpy(s),
                                          *(t[k] for k in args))
    assert tc is cache
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)


def test_dequantize_inverts_quantize_within_half_a_step():
    x = torch.from_numpy(
        np.random.default_rng(5).normal(size=(3, 2048)).astype(np.float32))
    q, s = quantize_packed(x)
    back = ref.dequantize_packed_ref(q, s)
    step = s.repeat_interleave(128, dim=1)
    assert torch.all((back - x).abs() <= 0.5 * step * (1 + 1e-6))


@pytest.mark.parametrize('bad', ['width', 'quantize_width', 'q8_width'])
def test_packed_width_is_checked(bad):
    a = _t(_inputs(2, 2048))
    narrow = {k: v[..., :1024] if v.shape[-1] == 2048 else v
              for k, v in a.items()}
    with pytest.raises(ValueError, match='not a multiple of PACK_TILE'):
        if bad == 'width':
            safa_aggregate_packed(*(narrow[k] for k in AGG_ARGS))
        elif bad == 'quantize_width':
            quantize_packed(narrow['trained'])
        else:
            q, s = ref.quantize_packed_ref(narrow['trained'])
            safa_aggregate_packed_q8(
                q, s, *(narrow[k] for k in (
                    'base', 'cache', 'global_prev', 'picked', 'undrafted',
                    'deprecated', 'completed', 'weights')))


def test_mixed_devices_raise():
    a = _t(_inputs(2, 2048))
    meta = a['trained'].to('meta')
    with pytest.raises(ValueError, match='mixed devices'):
        safa_aggregate_packed(a['cache'], meta, a['global_prev'], a['picked'],
                              a['undrafted'], a['deprecated'], a['weights'])


def test_cuda_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='cuda'):
        backend.resolve_device('cuda')
    assert backend.resolve_device('cpu') == torch.device('cpu')


def test_build_dir_from_env_or_checkout(monkeypatch, tmp_path):
    monkeypatch.setenv(backend.BUILD_DIR_ENV, str(tmp_path))
    assert backend.build_dir() == tmp_path.resolve()
    monkeypatch.delenv(backend.BUILD_DIR_ENV)
    root = backend.CSRC.parents[2]
    assert backend.build_dir() == root / 'build' / 'repro_torch'
    monkeypatch.setattr(backend, 'CSRC',
                        tmp_path / 'site-packages' / 'repro_torch' / 'csrc')
    with pytest.raises(RuntimeError, match=backend.BUILD_DIR_ENV):
        backend.build_dir()


def test_library_name_keys_on_sources_flags_and_nvcc(tmp_path):
    src = tmp_path / 'k.cu'
    src.write_text('// v1\n')
    flags = ('-O3',)
    name = backend.library_name([src], flags, 'nvcc 12.4')
    assert name == backend.library_name([src], flags, 'nvcc 12.4')
    assert name != backend.library_name([src], ('-O2',), 'nvcc 12.4')
    assert name != backend.library_name([src], flags, 'nvcc 12.6')
    src.write_text('// v2\n')
    assert name != backend.library_name([src], flags, 'nvcc 12.4')

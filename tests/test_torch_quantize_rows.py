"""The rows forms of kernels 5 and 6 (``quantize_rows`` /
``dequantize_rows``: every client row of one leaf's [m, n] stack, one
launch per row from one C call on the card), which the per-leaf int8
reference (``SafaSpec(quantize_uploads=True)``) calls once a leaf.

Tolerances, as ``tests/test_torch_quantize_uploads.py`` holds the flat
forms:

* against the JAX package's ``quantize`` / ``dequantize`` (Pallas, in
  interpret mode) row by row: q equal, scales within rtol 1e-6 (the JAX
  package's division moves some scales by one ulp against an IEEE
  division), the dequantised rows equal given the same (q, scales);
* against the port's flat wrappers (their plain versions here) row by
  row: bit for bit, since each row is the same arithmetic.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.comm_quant import dequantize as j_dequantize
from repro.kernels.comm_quant import quantize as j_quantize
from repro_torch.core import federation as tfed
from repro_torch.data import tasks as ttasks
from repro_torch.kernels import backend
from repro_torch.kernels.comm_quant import (dequantize, dequantize_rows,
                                            quantize, quantize_rows)

SIZES = [1, 13, 127, 128, 129, 2047, 2048, 2049, 313_600]
ROWS = [1, 3, 7]


@pytest.fixture(autouse=True)
def _zero_launches():
    backend.reset_launches()
    yield
    assert all(v == 0 for v in backend.LAUNCHES.values()), \
        'a wrapper launched a kernel on CPU tensors'


def _stack(m, n):
    """Seeded [m, n] f32 rows; row 0 starts with a zero (or half-zero)
    block, as the flat test's vector does."""
    x = np.random.default_rng(1000 * m + n).normal(size=(m, n)) * 3
    x = x.astype(np.float32)
    x[0, :min(n, 128) // 2] = 0.0
    return x


@pytest.mark.parametrize('n', SIZES)
@pytest.mark.parametrize('m', ROWS)
def test_rows_match_reference_row_by_row(m, n):
    x = _stack(m, n)
    q, s = quantize_rows(torch.from_numpy(x))
    assert q.dtype == torch.int8 and q.shape == (m, n)
    assert s.dtype == torch.float32 and s.shape == (m, -(-n // 128))
    jqs = [j_quantize(jnp.asarray(row)) for row in x]
    for k, (jq, js) in enumerate(jqs):
        np.testing.assert_array_equal(q[k].numpy(), np.array(jq),
                                      err_msg=f'row {k}')
        np.testing.assert_allclose(s[k].numpy(), np.array(js), rtol=1e-6,
                                   atol=0, err_msg=f'row {k}')
    got = dequantize_rows(
        torch.from_numpy(np.stack([np.array(jq) for jq, _ in jqs])),
        torch.from_numpy(np.stack([np.array(js) for _, js in jqs])), n=n)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    for k, (jq, js) in enumerate(jqs):
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.array(j_dequantize(jq, js, n=n)),
                                      err_msg=f'row {k}')


@pytest.mark.parametrize('n', SIZES)
@pytest.mark.parametrize('m', ROWS)
def test_rows_equal_flat_wrappers_bitwise(m, n):
    x = torch.from_numpy(_stack(m, n))
    q, s = quantize_rows(x)
    back = dequantize_rows(q, s, n=n)
    assert q.is_contiguous() and s.is_contiguous() and back.is_contiguous()
    for k in range(m):
        fq, fs = quantize(x[k])
        assert torch.equal(q[k], fq) and torch.equal(s[k], fs), k
        assert torch.equal(back[k], dequantize(fq, fs, n=n)), k


def _refusal(case):
    x = torch.ones(3, 300)
    q, s = quantize_rows(x)
    return {
        'x_dtype': (TypeError, 'float32', lambda: quantize_rows(x.double())),
        'x_rank': (ValueError, r'\[m, n\]', lambda: quantize_rows(x[0])),
        'x_empty': (ValueError, r'\[m, n\]',
                    lambda: quantize_rows(torch.ones(0, 300))),
        'x_strided': (ValueError, 'contiguous',
                      lambda: quantize_rows(torch.ones(3, 600)[:, ::2])),
        'q_dtype': (TypeError, 'int8',
                    lambda: dequantize_rows(q.int(), s, n=300)),
        'q_width': (ValueError, '299 values',
                    lambda: dequantize_rows(q, s, n=299)),
        'q_strided': (ValueError, 'contiguous',
                      lambda: dequantize_rows(
                          torch.zeros(3, 600, dtype=torch.int8)[:, ::2], s,
                          n=300)),
        'scales_shape': (ValueError, 'scales',
                         lambda: dequantize_rows(q, s[:, :2], n=300)),
        'scales_rows': (ValueError, 'scales',
                        lambda: dequantize_rows(q, s[:2], n=300)),
        'scales_dtype': (TypeError, 'float32',
                         lambda: dequantize_rows(q, s.double(), n=300)),
        'mixed_devices': (ValueError, 'mixed devices',
                          lambda: dequantize_rows(q, s.to('meta'), n=300)),
    }[case]


REFUSALS = ['x_dtype', 'x_rank', 'x_empty', 'x_strided', 'q_dtype',
            'q_width', 'q_strided', 'scales_shape', 'scales_rows',
            'scales_dtype', 'mixed_devices']


@pytest.mark.parametrize('case', REFUSALS)
def test_rows_wrappers_refuse_bad_operands(case):
    err, match, call = _refusal(case)
    with pytest.raises(err, match=match):
        call()


def test_per_leaf_path_calls_the_rows_wrappers_once_a_leaf(monkeypatch):
    """``_quantized_train_fn`` makes one ``quantize_rows`` and one
    ``dequantize_rows`` call a leaf, whatever m, and its uploads equal the
    flat wrappers' row by row."""
    calls = {'quantize_rows': 0, 'dequantize_rows': 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name, fn in (('quantize_rows', quantize_rows),
                     ('dequantize_rows', dequantize_rows)):
        monkeypatch.setattr(tfed, name, counted(name, fn))
    init = ttasks._cnn_init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    m = 5
    stacked = {k: v + torch.from_numpy(
        0.05 * rng.normal(size=(m,) + tuple(v.shape)).astype(np.float32))
        for k, v in init.items()}
    out = tfed._quantized_train_fn(lambda s: s)(stacked)
    assert calls == {'quantize_rows': len(init), 'dequantize_rows': len(init)}
    for k, v in stacked.items():
        flat = v.reshape(m, -1)
        want = torch.stack([dequantize(*quantize(row), n=flat.shape[1])
                            for row in flat]).reshape(v.shape)
        assert out[k].shape == v.shape and torch.equal(out[k], want), k

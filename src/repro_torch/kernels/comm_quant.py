"""Int8 per-block quantisation of upload values, and its inverse.

The paper assumes models are compressed before transmission (§IV-A).  The
int8 wire carries one f32 scale per ``QBLOCK`` values.  Two granularities,
as in the JAX package:

* ``quantize`` / ``dequantize`` — one flat [n] vector per call, any
  n >= 1 (the last block may be partial), one launch;
* ``quantize_rows`` / ``dequantize_rows`` — every client row of one leaf's
  [m, n] stack, one launch of the same kernel per row, all from one C
  call: the per-leaf reference path (``SafaSpec(quantize_uploads=True)``),
  two launches per leaf per client;
* ``quantize_packed`` / ``dequantize_packed`` — a whole packed [m, N]
  upload buffer, each client row on its own, in one launch: the wire of
  ``ExecSpec(wire='int8')``.  Each has a fleet form (``*_fleet``) for a
  fleet's [S, m, N] buffer in one launch.

On CUDA tensors a wrapper launches its kernel of ``csrc/comm_quant.cu``;
on CPU tensors it runs the plain version in ``kernels.ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend, ref

QBLOCK = ref.QBLOCK
#: width multiple of every pack buffer (``ops.pack_spec``'s default
#: ``pad_to``); the JAX package pads to the same width, so both packages
#: lay a model out at the same offsets
PACK_TILE = 2048

#: In-place inventory of this module's kernel wrappers (the counterpart
#: of the JAX package's ``ALIAS_CONTRACTS``): wrapper -> the admissible
#: tuples of operand names it writes in place.  The quantisation kernels
#: change width and dtype between input and output, so none writes an
#: operand.  ``repro_torch.analysis`` holds every call of a run to this
#: (rule T003) and every wrapper to an entry here (REP005).
ALIAS_CONTRACTS = {
    'quantize': ((),),
    'dequantize': ((),),
    'quantize_rows': ((),),
    'dequantize_rows': ((),),
    'quantize_packed': ((),),
    'quantize_packed_fleet': ((),),
    'dequantize_packed': ((),),
    'dequantize_packed_fleet': ((),),
}


def _check_packed(n: int):
    if n % PACK_TILE:
        raise ValueError(
            f'packed buffer width {n} not a multiple of '
            f'PACK_TILE={PACK_TILE}; pack with ops.pack_spec')


def _quantize(key: str, entry: str, rank: int, x: torch.Tensor):
    if x.ndim != rank:
        raise ValueError(f'expected a rank-{rank} pack buffer, got shape '
                         f'{tuple(x.shape)}')
    n = x.shape[-1]
    _check_packed(n)
    if not backend.is_cuda(x):
        return ref.quantize_packed_ref(x)
    lead = tuple(x.shape[:-1])
    backend.check_operand(x, 'x', torch.float32, lead + (n,), x.device)
    q = torch.empty(lead + (n,), dtype=torch.int8, device=x.device)
    scales = torch.empty(lead + (n // QBLOCK,), dtype=torch.float32,
                         device=x.device)
    backend.call(entry, x.device, x.data_ptr(), q.data_ptr(),
                 scales.data_ptr(), *lead, n)
    backend.LAUNCHES[key] += 1
    return q, scales


def quantize_packed(x: torch.Tensor):
    """x: [m, N] f32 pack buffer (N % PACK_TILE == 0) -> (q [m, N] int8,
    scales [m, N / QBLOCK] f32), one kernel launch for the whole buffer."""
    return _quantize('quantize_packed', 'quantize_packed_f32', 2, x)


def quantize_packed_fleet(x: torch.Tensor):
    """Fleet form: x [S, m, N] -> (q [S, m, N] int8, scales
    [S, m, N / QBLOCK] f32), every member's upload buffer in one launch
    (of the same kernel, over the S * m rows)."""
    return _quantize('quantize_packed_fleet', 'quantize_packed_fleet_f32', 3,
                     x)


def _dequantize(key: str, entry: str, rank: int, q: torch.Tensor,
                scales: torch.Tensor):
    if q.ndim != rank:
        raise ValueError(f'expected a rank-{rank} int8 pack buffer, got '
                         f'shape {tuple(q.shape)}')
    n = q.shape[-1]
    _check_packed(n)
    lead = tuple(q.shape[:-1])
    if not backend.is_cuda(q, scales):
        return ref.dequantize_packed_ref(q, scales)
    backend.check_operand(q, 'q', torch.int8, lead + (n,), q.device)
    backend.check_operand(scales, 'scales', torch.float32,
                          lead + (n // QBLOCK,), q.device)
    x = torch.empty(lead + (n,), dtype=torch.float32, device=q.device)
    backend.call(entry, q.device, q.data_ptr(), scales.data_ptr(),
                 x.data_ptr(), *lead, n)
    backend.LAUNCHES[key] += 1
    return x


def dequantize_packed(q: torch.Tensor, scales: torch.Tensor):
    """Inverse of ``quantize_packed``: (q [m, N] int8, scales
    [m, N / QBLOCK] f32) -> x [m, N] f32, x = q * scale per block, one
    kernel launch for the whole buffer."""
    return _dequantize('dequantize_packed', 'dequantize_packed_f32', 2, q,
                       scales)


def dequantize_packed_fleet(q: torch.Tensor, scales: torch.Tensor):
    """Fleet form: (q [S, m, N], scales [S, m, N / QBLOCK]) -> x [S, m, N]
    f32, every member's buffer in one launch (of the same kernel, over the
    S * m rows)."""
    return _dequantize('dequantize_packed_fleet',
                       'dequantize_packed_fleet_f32', 3, q, scales)


def _check_flat(t: torch.Tensor, name: str):
    if t.ndim != 1 or t.shape[0] < 1:
        raise ValueError(f'{name}: expected a flat [n] vector with n >= 1, '
                         f'got shape {tuple(t.shape)}')


def quantize(x: torch.Tensor):
    """x: [n] f32, any n >= 1 -> (q [n] int8, scales [ceil(n / QBLOCK)]
    f32), one kernel launch.  A row view of a larger tensor is taken as
    it is (no copy): the kernel reads any 4-byte-aligned address."""
    _check_flat(x, 'x')
    if not backend.is_cuda(x):
        return ref.quantize_ref(x)
    n = x.shape[0]
    backend.check_operand(x, 'x', torch.float32, (n,), x.device)
    q = torch.empty(n, dtype=torch.int8, device=x.device)
    scales = torch.empty(-(-n // QBLOCK), dtype=torch.float32,
                         device=x.device)
    backend.call('quantize_f32', x.device, x.data_ptr(), q.data_ptr(),
                 scales.data_ptr(), n)
    backend.LAUNCHES['quantize'] += 1
    return q, scales


def dequantize(q: torch.Tensor, scales: torch.Tensor, *, n: int):
    """Inverse of ``quantize``; ``n`` is the original length: (q [n] int8,
    scales [ceil(n / QBLOCK)] f32) -> x [n] f32, x = q * scale per block,
    one kernel launch."""
    _check_flat(q, 'q')
    if q.shape[0] != n:
        raise ValueError(f'q: expected {n} values, got {q.shape[0]}')
    n_scales = -(-n // QBLOCK)
    if tuple(scales.shape) != (n_scales,):
        raise ValueError(f'scales: expected shape ({n_scales},) for n = {n}, '
                         f'got {tuple(scales.shape)}')
    if not backend.is_cuda(q, scales):
        return ref.dequantize_ref(q, scales, n)
    backend.check_operand(q, 'q', torch.int8, (n,), q.device)
    backend.check_operand(scales, 'scales', torch.float32, (n_scales,),
                          q.device)
    x = torch.empty(n, dtype=torch.float32, device=q.device)
    backend.call('dequantize_f32', q.device, q.data_ptr(), scales.data_ptr(),
                 x.data_ptr(), n)
    backend.LAUNCHES['dequantize'] += 1
    return x


def _check_rows(t: torch.Tensor, name: str):
    if t.ndim != 2 or t.shape[0] < 1 or t.shape[1] < 1:
        raise ValueError(f'{name}: expected an [m, n] stack with m, n >= 1, '
                         f'got shape {tuple(t.shape)}')


def quantize_rows(x: torch.Tensor):
    """x: [m, n] f32, any n >= 1 (one leaf of m clients' uploads) ->
    (q [m, n] int8, scales [m, ceil(n / QBLOCK)] f32), each row bit for
    bit ``quantize`` of it.  On the card: m launches of ``quantize``'s
    kernel, one per row, from one C call (``LAUNCHES['quantize']`` grows
    by m)."""
    _check_rows(x, 'x')
    m, n = x.shape
    cuda = backend.is_cuda(x)
    backend.check_operand(x, 'x', torch.float32, (m, n), x.device)
    if not cuda:
        return ref.quantize_ref(x)
    q = torch.empty((m, n), dtype=torch.int8, device=x.device)
    scales = torch.empty((m, -(-n // QBLOCK)), dtype=torch.float32,
                         device=x.device)
    backend.call('quantize_rows_f32', x.device, x.data_ptr(), q.data_ptr(),
                 scales.data_ptr(), m, n)
    backend.LAUNCHES['quantize'] += m
    return q, scales


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor, *, n: int):
    """Inverse of ``quantize_rows``; ``n`` is the rows' original length:
    (q [m, n] int8, scales [m, ceil(n / QBLOCK)] f32) -> x [m, n] f32,
    each row bit for bit ``dequantize`` of it.  On the card: m launches of
    ``dequantize``'s kernel from one C call."""
    _check_rows(q, 'q')
    m = q.shape[0]
    if q.shape[1] != n:
        raise ValueError(f'q: expected {n} values a row, got {q.shape[1]}')
    cuda = backend.is_cuda(q, scales)
    backend.check_operand(q, 'q', torch.int8, (m, n), q.device)
    backend.check_operand(scales, 'scales', torch.float32,
                          (m, -(-n // QBLOCK)), q.device)
    if not cuda:
        return ref.dequantize_ref(q, scales, n)
    x = torch.empty((m, n), dtype=torch.float32, device=q.device)
    backend.call('dequantize_rows_f32', q.device, q.data_ptr(),
                 scales.data_ptr(), x.data_ptr(), m, n)
    backend.LAUNCHES['dequantize'] += m
    return x

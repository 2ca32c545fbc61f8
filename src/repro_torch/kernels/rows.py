"""Row gather and row scatter on [R, N] pack buffers: how the sparse
schedules' engines move the K active clients' rows out of, and back into,
the carried local and cache buffers.

``gather_rows(buf, rows)`` returns the rows ``rows`` of ``buf``;
``scatter_rows(buf, rows, vals)`` writes ``vals`` over them in place, the
last slot winning where slots share a row.  A row index outside [0, R)
reads and writes row R - 1: the engines' buffers are [m + 1, N] with a
trailing scratch row, where the schedule's sentinel slots (index m) land.
On CUDA tensors a wrapper launches its kernel of ``csrc/rows.cu``; on CPU
tensors it runs the plain version in ``kernels.ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend, ref
from repro_torch.kernels.comm_quant import _check_packed


def _shapes(buf, rows):
    if buf.ndim != 2 or rows.ndim != 1:
        raise ValueError(f'expected buf [R, N] and rows [K], got shapes '
                         f'{tuple(buf.shape)} and {tuple(rows.shape)}')
    r, n = buf.shape
    _check_packed(n)
    return r, rows.shape[0], n


def _check(buf, rows, r, k, n):
    backend.check_operand(buf, 'buf', torch.float32, (r, n), buf.device)
    backend.check_operand(rows, 'rows', torch.int32, (k,), buf.device)


def gather_rows(buf, rows):
    """buf [R, N] f32 pack buffer (N % PACK_TILE == 0), rows [K] int32 ->
    [K, N], one launch."""
    r, k, n = _shapes(buf, rows)
    if not backend.is_cuda(buf, rows):
        return ref.gather_rows_ref(buf, rows)
    _check(buf, rows, r, k, n)
    out = torch.empty((k, n), dtype=torch.float32, device=buf.device)
    backend.call('gather_rows_f32', buf.device, buf.data_ptr(),
                 rows.data_ptr(), out.data_ptr(), r, k, n)
    backend.LAUNCHES['gather_rows'] += 1
    return out


def scatter_rows(buf, rows, vals):
    """Write vals [K, N] f32 into buf [R, N] at ``rows`` [K] int32, in
    place, one launch; returns ``buf``.  ``vals`` must not overlap
    ``buf``."""
    r, k, n = _shapes(buf, rows)
    if tuple(vals.shape) != (k, n):
        raise ValueError(f'vals shape {tuple(vals.shape)} does not match '
                         f'(K={k}, N={n})')
    if not backend.is_cuda(buf, rows, vals):
        return ref.scatter_rows_ref(buf, rows, vals)
    _check(buf, rows, r, k, n)
    backend.check_operand(vals, 'vals', torch.float32, (k, n), buf.device)
    backend.call('scatter_rows_f32', buf.device, buf.data_ptr(),
                 rows.data_ptr(), vals.data_ptr(), r, k, n)
    backend.LAUNCHES['scatter_rows'] += 1
    return buf

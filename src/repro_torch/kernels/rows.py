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

#: In-place inventory (format: ``comm_quant.ALIAS_CONTRACTS``): the
#: scatter writes ``buf`` in place (rows it does not name never move);
#: the gather writes a fresh output.
ALIAS_CONTRACTS = {
    'gather_rows': ((),),
    'gather_rows_fleet': ((),),
    'scatter_rows': (('buf',),),
    'scatter_rows_fleet': (('buf',),),
}


def _shapes(buf, rows, fleet: bool):
    """(lead, r, k, n) of a launch: lead is (S,) for a fleet, () for one
    run; raises on the wrong ranks or a width the kernels do not take."""
    want = 2 + fleet
    if buf.ndim != want or rows.ndim != want - 1 or \
            (fleet and rows.shape[0] != buf.shape[0]):
        form = '[S, R, N] and rows [S, K]' if fleet else '[R, N] and rows [K]'
        raise ValueError(f'expected buf {form}, got shapes '
                         f'{tuple(buf.shape)} and {tuple(rows.shape)}')
    lead = tuple(buf.shape[:1]) if fleet else ()
    r, n = buf.shape[-2:]
    _check_packed(n)
    return lead, r, rows.shape[-1], n


def _gather(key: str, entry: str, fleet: bool, buf, rows):
    lead, r, k, n = _shapes(buf, rows, fleet)
    if not backend.is_cuda(buf, rows):
        return ref.gather_rows_ref(buf, rows)
    backend.check_operand(buf, 'buf', torch.float32, lead + (r, n),
                          buf.device)
    backend.check_operand(rows, 'rows', torch.int32, lead + (k,), buf.device)
    out = torch.empty(lead + (k, n), dtype=torch.float32, device=buf.device)
    backend.call(entry, buf.device, buf.data_ptr(), rows.data_ptr(),
                 out.data_ptr(), *lead, r, k, n)
    backend.LAUNCHES[key] += 1
    return out


def _scatter(key: str, entry: str, fleet: bool, buf, rows, vals):
    lead, r, k, n = _shapes(buf, rows, fleet)
    if tuple(vals.shape) != lead + (k, n):
        dims = (f'S={lead[0]}, ' if fleet else '') + f'K={k}, N={n}'
        raise ValueError(f'vals shape {tuple(vals.shape)} does not match '
                         f'({dims})')
    if not backend.is_cuda(buf, rows, vals):
        return ref.scatter_rows_ref(buf, rows, vals)
    dev = buf.device
    backend.check_operand(buf, 'buf', torch.float32, lead + (r, n), dev)
    backend.check_operand(rows, 'rows', torch.int32, lead + (k,), dev)
    backend.check_operand(vals, 'vals', torch.float32, lead + (k, n), dev)
    backend.call(entry, dev, buf.data_ptr(), rows.data_ptr(),
                 vals.data_ptr(), *lead, r, k, n)
    backend.LAUNCHES[key] += 1
    return buf


def gather_rows(buf, rows):
    """buf [R, N] f32 pack buffer (N % PACK_TILE == 0), rows [K] int32 ->
    [K, N], one launch."""
    return _gather('gather_rows', 'gather_rows_f32', False, buf, rows)


def gather_rows_fleet(buf, rows):
    """Fleet form of ``gather_rows``: buf [S, R, N], rows [S, K] int32 ->
    [S, K, N], one launch for all S members."""
    return _gather('gather_rows_fleet', 'gather_rows_fleet_f32', True, buf,
                   rows)


def scatter_rows(buf, rows, vals):
    """Write vals [K, N] f32 into buf [R, N] at ``rows`` [K] int32, in
    place, one launch; returns ``buf``.  ``vals`` must not overlap
    ``buf``."""
    return _scatter('scatter_rows', 'scatter_rows_f32', False, buf, rows,
                    vals)


def scatter_rows_fleet(buf, rows, vals):
    """Fleet form of ``scatter_rows``: vals [S, K, N] into buf [S, R, N] at
    each member's ``rows`` [S, K], in place, one launch for all S members;
    returns ``buf``."""
    return _scatter('scatter_rows_fleet', 'scatter_rows_fleet_f32', True,
                    buf, rows, vals)

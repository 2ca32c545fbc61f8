"""Plain PyTorch versions of the port's CUDA kernels.

They are the CPU path of every kernel wrapper and the oracle each kernel
is held to on the card.  They repeat the kernels' arithmetic and are no
yardstick of speed.  Each takes one run's operands ([m, N] rows, [N]
global, [m] masks) or a fleet's, with a leading member axis ([S, m, N],
[S, N], [S, m]): the plain version of a fleet kernel is the same function
on the stacked operands, and member s's result is bit for bit the
single-run result on member s's slices."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.attention import attention_ref

QBLOCK = 128


def safa_aggregate_ref(cache, trained, global_prev, picked, undrafted,
                       deprecated, weights):
    """Three-step discriminative aggregation on [(S,) m, N] matrices
    (Eq. 6-8).  Returns (new_global [(S,) N], new_cache [(S,) m, N])."""
    picked = picked[..., None]
    undrafted = undrafted[..., None]
    deprecated = deprecated[..., None]
    c1 = torch.where(deprecated & ~picked, global_prev[..., None, :], cache)
    c1 = torch.where(picked, trained, c1)
    new_global = torch.sum(c1.float() * weights.float()[..., None], dim=-2)
    c2 = torch.where(undrafted, trained, c1)
    return new_global.to(cache.dtype), c2


def quantize_packed_ref(x, qblock: int = QBLOCK):
    """Block-quantise every row of an [(S,) m, N] buffer (N % qblock == 0):
    returns (q [(S,) m, N] int8, scales [(S,) m, N / qblock] f32).

    The divisor 127 is a tensor on x's device: PyTorch's CUDA division by
    a Python scalar multiplies by its reciprocal, one ulp away from the
    IEEE division the kernel (and the JAX reference) performs."""
    *lead, n = x.shape
    xb = x.float().reshape(*lead, n // qblock, qblock)
    amax = xb.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-30) / torch.tensor(127.0, device=x.device)
    q = torch.round(xb / scale).clamp(-127, 127).to(torch.int8)
    return q.reshape(*lead, n), scale.reshape(*lead, -1)


def dequantize_packed_ref(q, scales, qblock: int = QBLOCK):
    """Inverse of ``quantize_packed_ref``: q * scale per block."""
    *lead, n = q.shape
    x = q.float().reshape(*lead, n // qblock, qblock) * scales[..., None]
    return x.reshape(*lead, n)


def quantize_ref(x, qblock: int = QBLOCK):
    """Block-quantise a flat [n] vector, any n >= 1, or each row of an
    [m, n] stack on its own: returns (q [(m,) n] int8, scales
    [(m,) ceil(n / qblock)] f32).  The last block may be partial; its
    amax is taken over the values that exist (zero padding cannot raise
    it), so it is ``quantize_packed_ref`` on the zero-padded vector, cut
    back to n."""
    n = x.shape[-1]
    q, scales = quantize_packed_ref(F.pad(x.float(), (0, (-n) % qblock)),
                                    qblock)
    return q[..., :n].contiguous(), scales


def dequantize_ref(q, scales, n: int, qblock: int = QBLOCK):
    """Inverse of ``quantize_ref``: q * scale per block, cut back to n."""
    x = dequantize_packed_ref(F.pad(q, (0, (-n) % qblock)), scales, qblock)
    return x[..., :n].contiguous()


def safa_aggregate_q8_ref(q, scales, base, cache, global_prev, picked,
                          undrafted, deprecated, completed, weights):
    """The int8 kernel's composition: dequantise the wire rows, take base
    for clients that did not complete, then Eq. 6-8.  Returns
    (new_global, new_cache, new_local)."""
    trained = torch.where(completed[..., None],
                          dequantize_packed_ref(q, scales), base)
    ng, nc = safa_aggregate_ref(cache, trained, global_prev, picked,
                                undrafted, deprecated, weights)
    return ng, nc, trained


def weighted_merge_ref(trained, global_prev, wrow):
    """The weighted-merge family's server step on [(S,) m, N] rows:
    (1 - sum(wrow)) * global + sum_k wrow[k] * trained[k], in f32.
    Returns the new global [(S,) N]."""
    w = wrow.float()
    residual = 1.0 - w.sum(dim=-1, keepdim=True)
    agg = torch.sum(trained.float() * w[..., None], dim=-2)
    return residual * global_prev.float() + agg


# -- the sparse schedules' row kernels: [R, N] buffers, rows [K] -----------
#
# A row index outside [0, R) reads and writes row R - 1, the buffer's
# scratch row: that is where a sparse schedule's sentinel slots (index m
# of an [m + 1, N] buffer) go, and no index can reach past the buffer.
# Each takes one run's operands or a fleet's, with a leading member axis
# (buf [S, R, N], rows [S, K], slot rows [S, K, N], vectors [S, N]), the
# scratch row then being member s's own row R - 1.

# SAFA role bits (``core.protocol.ROLE_*``), repeated so that this module
# stands alone beside the kernels
_COMMITTED, _PICKED, _UNDRAFTED, _DEPRECATED = 2, 4, 8, 16


def row_index(rows, r: int):
    """``rows`` as int64 indices into an [r, N] buffer, every index outside
    [0, r) sent to the scratch row r - 1."""
    rows = rows.long()
    return torch.where((rows >= 0) & (rows < r), rows, r - 1)


def _flat_rows(rows, r: int):
    """Rows [(S,) K] as int64 indices into the [S * R, N] view of a
    fleet's buffer (member s's rows offset by s * R), every index outside
    [0, R) first sent to member s's scratch row R - 1."""
    idx = row_index(rows, r)
    if rows.ndim == 2:
        idx = idx + r * torch.arange(rows.shape[0],
                                     device=rows.device)[:, None]
    return idx.reshape(-1)


def gather_rows_ref(buf, rows):
    """buf [(S,) R, N], rows [(S,) K] -> [(S,) K, N]: row rows[j] of buf in
    slot j."""
    n = buf.shape[-1]
    got = buf.reshape(-1, n).index_select(0, _flat_rows(rows, buf.shape[-2]))
    return got.reshape(tuple(rows.shape) + (n,))


def scatter_rows_ref(buf, rows, vals):
    """Write vals [(S,) K, N] into buf [(S,) R, N] at ``rows``, in place,
    and return buf.  Where slots share a row the last slot wins: every
    slot writes the value of the last slot with its row, so the writes
    agree whatever their order."""
    n = buf.shape[-1]
    idx = _flat_rows(rows, buf.shape[-2])
    k = idx.shape[0]
    slot = torch.arange(k, device=idx.device)
    last = torch.where(idx[:, None] == idx[None, :], slot[None, :],
                       -1).amax(dim=1)
    buf.view(-1, n).index_copy_(0, idx, vals.reshape(-1, n)[last])
    return buf


def _rows_math(c0, tr, global_prev, agg, roles, w_rows):
    """Eq. 6-8 on K gathered cache rows c0 with the trained rows tr, as
    deltas on the running aggregate: (new_global, new_agg, c2)."""
    def bit(b):
        return ((roles & b) != 0)[..., None]
    p, u, d = bit(_PICKED), bit(_UNDRAFTED), bit(_DEPRECATED)
    c1 = torch.where(d & ~p, global_prev[..., None, :], c0)   # Eq. 6
    c1 = torch.where(p, tr, c1)
    c2 = torch.where(u, tr, c1)                                # Eq. 8
    w = w_rows.float()[..., None]
    new_global = agg + torch.sum(w * (c1 - c0), dim=-2)        # Eq. 7
    new_agg = agg + torch.sum(w * (c2 - c0), dim=-2)
    return new_global, new_agg, c2


def safa_aggregate_rows_ref(cache, trained_rows, global_prev, agg, rows,
                            roles, w_rows):
    """The rows kernel's formula: on the K cache rows c0 = cache[rows],
    new_global = agg + sum_k w_k (c1_k - c0_k) and new_agg = agg +
    sum_k w_k (c2_k - c0_k), with c1, c2 of Eq. 6 and 8 from the ROLE_*
    bits in ``roles`` [(S,) K] uint8.  Returns (new_global [(S,) N],
    new_agg [(S,) N], c2 [(S,) K, N])."""
    return _rows_math(gather_rows_ref(cache, rows), trained_rows,
                      global_prev, agg, roles, w_rows)


def safa_aggregate_q8_rows_ref(q, scales, base_rows, cache, global_prev,
                               agg, rows, roles, w_rows):
    """The int8 rows kernel's composition: the trained row is the
    dequantised upload where the slot committed and its base row
    elsewhere, then ``safa_aggregate_rows_ref``.  Returns (new_global,
    new_agg, c2 [(S,) K, N], local [(S,) K, N]), local being the trained
    rows."""
    done = ((roles & _COMMITTED) != 0)[..., None]
    tr = torch.where(done, dequantize_packed_ref(q, scales), base_rows)
    return _rows_math(gather_rows_ref(cache, rows), tr, global_prev, agg,
                      roles, w_rows) + (tr,)


# -- the lag tier's forms: the value buffer read and written in place -------
#
# buf is the tier's [(S,) capacity + 1, N] value buffer, its last row the
# scratch slot; ``srcs`` name each slot's cache row c0, ``dsts`` the row
# that receives its c2.  Every slot reads before any slot writes, and
# where slots share a destination the last slot wins, so the scratch row
# (read and written by the inert slots) comes out defined too.

def safa_aggregate_tier_rows_ref(buf, trained_rows, global_prev, agg, srcs,
                                 dsts, roles, w_rows):
    """The tier kernel's formula: ``safa_aggregate_rows_ref`` on the rows
    c0 = buf[srcs], then c2 written into buf at ``dsts`` in place.
    Returns (new_global [(S,) N], new_agg [(S,) N], buf)."""
    ng, na, c2 = _rows_math(gather_rows_ref(buf, srcs), trained_rows,
                            global_prev, agg, roles, w_rows)
    return ng, na, scatter_rows_ref(buf, dsts, c2)


def safa_aggregate_q8_tier_rows_ref(q, scales, base_rows, buf, global_prev,
                                    agg, srcs, dsts, roles, w_rows):
    """The int8 tier kernel's composition: the trained row is the
    dequantised upload where the slot committed and its base row
    elsewhere, then ``safa_aggregate_tier_rows_ref``.  There is no local
    output: the tier's local state is the version ring.  Returns
    (new_global, new_agg, buf)."""
    done = ((roles & _COMMITTED) != 0)[..., None]
    tr = torch.where(done, dequantize_packed_ref(q, scales), base_rows)
    return safa_aggregate_tier_rows_ref(buf, tr, global_prev, agg, srcs,
                                        dsts, roles, w_rows)


def swa_attention_ref(q, k, v, *, window=None):
    """Causal (+window) attention oracle, the naive O(S^2) path: kernel
    21's plain version.  q: [B, S, H, D]; k, v: [B, S, KH, D]."""
    return attention_ref(q, k, v, causal=True, window=window)


def swa_attention_spread_ref(q, k, v, *, window=None):
    """sqrt(sum_j w_ij^2 v_jd^2) over the causal (+window) band, w the
    softmax weights of ``swa_attention_ref``, in f32, [B, S, H, D]: the
    scale of the error that rounding the probabilities to bf16 puts on
    kernel 21's output.  Each w_ij v_jd moves by at most 2^-8 of itself,
    so an output moves by about 2^-8 / sqrt(3) of this scale when the
    roundings are independent, and by at most 2^-8 sqrt(keys) of it."""
    B, S, H, D = q.shape
    KH = k.shape[2]
    pos = torch.arange(S, device=q.device)
    band = pos[:, None] >= pos[None, :]
    if window is not None:
        band &= pos[:, None] - pos[None, :] < window
    qf = (q.float() * D ** -0.5).reshape(B, S, KH, H // KH, D)
    s = torch.einsum('bqhgd,bkhd->bqhgk', qf, k.float())
    s.masked_fill_(~band[None, :, None, None, :], -1e30)
    w = torch.softmax(s, dim=-1)
    del s
    w.square_()
    out = torch.einsum('bqhgk,bkhd->bqhgd', w, v.float().square())
    return out.sqrt_().reshape(B, S, H, D)

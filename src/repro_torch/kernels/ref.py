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

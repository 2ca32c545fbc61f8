"""Causal sliding-window attention with grouped KV heads: kernel 21.

On CUDA tensors ``swa_attention`` launches ``csrc/swa_attention.cu`` into
a fresh output in q's dtype: bf16 operands on the tensor cores (wgmma,
f32 sums, the probabilities rounded to bf16; within 3e-2 of the plain
version, and of each output within 2e-2 of its magnitude plus its spread,
``ref.swa_attention_spread_ref``), f32 operands on the CUDA cores (within
2e-5).  On CPU tensors it
runs the plain version, ``ref.swa_attention_ref`` (the naive O(S^2)
oracle).  The models reach it through ``attn_impl='pallas'``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend, ref

_ENTRIES = {torch.float32: 'swa_attention_f32',
            torch.bfloat16: 'swa_attention_bf16'}
MAX_HEAD_DIM = 256

#: In-place inventory (format: ``comm_quant.ALIAS_CONTRACTS``): the
#: attention output is a fresh buffer.
ALIAS_CONTRACTS = {
    'swa_attention': ((),),
}


def swa_attention(q, k, v, *, window=None, block_q: int = 128,
                  block_k: int = 128):
    """q: [B, S, H, D]; k, v: [B, S, KH, D] (H % KH == 0).  Causal, with an
    optional sliding window (key j is visible to query i iff j <= i and
    i - j < window).  Returns [B, S, H, D] in q's dtype.

    ``block_q``/``block_k`` are the reference's TPU tiling and do not
    change the function: the bf16 kernel tiles 128 query rows x 128 keys
    (64 keys past D 128), the f32 one 64 x 64.  The kernel takes f32 or bf16, contiguous
    operands, any S >= 1 and head_dim D % 8 == 0 up to 256; bf16 operands
    must start 16-byte aligned (its TMA loads)."""
    del block_q, block_k   # the reference's tiling, not the function's
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f'want q [B, S, H, D] and k, v [B, S, KH, D]; got '
                         f'{tuple(q.shape)}, {tuple(k.shape)}, '
                         f'{tuple(v.shape)}')
    B, S, H, D = q.shape
    KH = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D or H % KH:
        raise ValueError(f'k, v {tuple(k.shape)} do not fit q '
                         f'{tuple(q.shape)} (H % KH must be 0)')
    if window is not None and window < 1:
        raise ValueError(f'window must be None or >= 1, got {window}')
    if not backend.is_cuda(q, k, v):
        return ref.swa_attention_ref(q, k, v, window=window)
    if q.dtype not in _ENTRIES:
        raise TypeError(f'swa_attention: want float32 or bfloat16, got '
                        f'{q.dtype}')
    if D % 8 or D > MAX_HEAD_DIM:
        raise ValueError(f'swa_attention: head_dim {D} must be a multiple '
                         f'of 8 and at most {MAX_HEAD_DIM}')
    dev = q.device
    backend.check_operand(q, 'q', q.dtype, (B, S, H, D), dev)
    backend.check_operand(k, 'k', q.dtype, (B, S, KH, D), dev)
    backend.check_operand(v, 'v', q.dtype, (B, S, KH, D), dev)
    if q.dtype == torch.bfloat16:
        for name, t in (('q', q), ('k', k), ('v', v)):
            if t.data_ptr() % 16:
                raise ValueError(f'swa_attention: {name} must start 16-byte '
                                 f'aligned for the bf16 kernel\'s TMA loads '
                                 f'(data_ptr % 16 = {t.data_ptr() % 16})')
    out = torch.empty_like(q)
    backend.call(_ENTRIES[q.dtype], dev, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), B, S, H, KH, D,
                 0 if window is None or window >= S else window, D ** -0.5)
    backend.LAUNCHES['swa_attention'] += 1
    return out

"""Attention: GQA + optional sliding window, on [B, S, H, D] tensors.

``flash_attention`` is the plain blocked path (a loop over KV blocks with
an online softmax), so its working set stays at [*, q_block, kv_block]
instead of [*, seq, seq]; it is the ``attn_impl='flash_jnp'`` path of the
models.  As in the reference, its products take the operands in their
own dtype (bf16 at full width) and accumulate in f32, with the scale
applied to the f32 scores and the probabilities rounded to v's dtype
before the second product.  ``attention_ref`` is the naive O(S^2)-memory
oracle (and, through ``kernels.ref.swa_attention_ref``, kernel 21's plain
version); ``decode_attention`` is one decode step against a cache.  All
three are plain PyTorch, as the reference's are plain jnp.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _block_mask(q_pos, k_pos, causal: bool, window: Optional[int]):
    """q_pos: [qb], k_pos: [kb] -> bool [qb, kb] (True = attend)."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def _arange(n, device):
    return torch.arange(n, dtype=torch.int32, device=device)


def flash_attention(q, k, v, *, causal=True, window=None, q_positions=None,
                    k_positions=None, q_block=512, kv_block=512,
                    kv_valid=None):
    """Online-softmax attention.

    q: [B, Sq, H, D];  k, v: [B, Sk, KH, D]  (GQA: H % KH == 0).
    window: sliding-window size (keys with q_pos - k_pos >= window masked).
    kv_valid: optional count of valid kv entries (decode caches).
    Returns [B, Sq, H, D] in q's dtype.
    """
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    if H % KH:
        raise ValueError(f'{H} query heads are not a multiple of {KH} KV '
                         f'heads')
    G = H // KH
    scale = D ** -0.5
    dev = q.device
    if q_positions is None:
        q_positions = _arange(Sq, dev)
    if k_positions is None:
        k_positions = _arange(Sk, dev)

    # Pad sequence dims to block multiples.
    pq = (-Sq) % q_block
    pk = (-Sk) % kv_block
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
        q_positions = F.pad(q_positions, (0, pq), value=2**30)
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
        k_positions = F.pad(k_positions, (0, pk), value=-(2**30))
    nq, nk = q.shape[1] // q_block, k.shape[1] // kv_block

    qr = q.reshape(B, nq, q_block, KH, G, D)
    kr = k.reshape(B, nk, kv_block, KH, D)
    vr = v.reshape(B, nk, kv_block, KH, D)
    qpos = q_positions.reshape(nq, q_block)
    kpos = k_positions.reshape(nk, kv_block)

    out = []
    for i in range(nq):
        # bf16 operands, f32 accumulation: a bf16 product is exact in f32,
        # so the f32 product of the upcast operands is the reference's
        qb = qr[:, i].float()
        m_i = torch.full((B, q_block, KH, G), NEG_INF, dtype=torch.float32,
                         device=dev)
        l_i = torch.zeros((B, q_block, KH, G), dtype=torch.float32,
                          device=dev)
        acc = torch.zeros((B, q_block, KH, G, D), dtype=torch.float32,
                          device=dev)
        for j in range(nk):
            vb = vr[:, j]
            s = torch.einsum('bqhgd,bkhd->bqhgk', qb, kr[:, j].float()) * scale
            mask = _block_mask(qpos[i], kpos[j], causal, window)
            mask &= (kpos[j] >= 0)[None, :]  # exclude block-padding keys
            if kv_valid is not None:
                mask &= kpos[j][None, :] < kv_valid
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m_i, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_i - m_new)
            l_i = l_i * corr + p.sum(dim=-1)
            pv = torch.einsum('bqhgk,bkhd->bqhgd', p.to(vb.dtype).float(),
                              vb.float())
            acc = acc * corr[..., None] + pv
            m_i = m_new
        out.append(acc / torch.clamp(l_i, min=1e-30)[..., None])
    out = torch.stack(out, dim=1).reshape(B, nq * q_block, H, D)
    return out[:, :Sq].to(q.dtype)


def attention_ref(q, k, v, *, causal=True, window=None, q_positions=None,
                  k_positions=None, kv_valid=None):
    """Naive O(S^2)-memory oracle, in f32."""
    B, Sq, H, D = q.shape
    _, Sk, KH, _ = k.shape
    G = H // KH
    if q_positions is None:
        q_positions = _arange(Sq, q.device)
    if k_positions is None:
        k_positions = _arange(Sk, q.device)
    qf = (q.float() * (D ** -0.5)).reshape(B, Sq, KH, G, D)
    s = torch.einsum('bqhgd,bkhd->bqhgk', qf, k.float())
    mask = _block_mask(q_positions, k_positions, causal, window)
    if kv_valid is not None:
        mask &= k_positions[None, :] < kv_valid
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum('bqhgk,bkhd->bqhgd', p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None,
                     cache_positions=None):
    """Single-step decode attention.

    q: [B, 1, H, D]; caches: [B, S, KH, D]; cache_len: number of valid
    entries (the new token's position + 1).  ``cache_positions`` [B, S]
    supports ring-buffer (SWA) caches where slot index != token position;
    -1 marks an empty slot.  Defaults to arange.
    """
    B, _, H, D = q.shape
    _, S, KH, _ = k_cache.shape
    G = H // KH
    if cache_positions is None:
        cache_positions = _arange(S, q.device)[None, :].expand(B, S)
    q_pos = cache_len - 1  # position of the new token
    qf = (q.float() * (D ** -0.5)).reshape(B, KH, G, D)
    s = torch.einsum('bhgd,bkhd->bhgk', qf, k_cache.float())
    valid = (cache_positions >= 0) & (cache_positions < cache_len)
    if window is not None:
        valid &= (q_pos - cache_positions) < window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum('bhgk,bkhd->bhgd', p, v_cache.float())
    return o.reshape(B, 1, H, D).to(q.dtype)

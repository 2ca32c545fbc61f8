"""Serving path of the dense family: the KV cache and single-token decode
steps.

``decode_step`` consumes a cache representing ``length`` already
processed tokens and produces logits for one new token.  Sliding-window
architectures use a ring-buffer cache of ``window`` slots (token ``pos``
goes to slot ``pos % slots``; ``positions`` holds each slot's token
position, -1 for an empty slot), so their decode memory is O(window),
independent of context length.

The cache is a dict as the reference's: ``k``, ``v`` [L, B, slots, KH, hd]
in the model's dtype, ``positions`` [slots] int32 on the device, and
``length``, a host-side Python int (the reference keeps a device scalar).
``decode_step`` updates the cache IN PLACE and returns it (the JAX code
donates it and returns a new one).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


def kv_cache_slots(cfg: ModelConfig, max_len: int) -> int:
    if cfg.window is not None:
        return min(max_len, cfg.window)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, length: int = 0,
               device='cuda'):
    """Zero-initialised cache.  ``length`` marks how many tokens the cache
    is considered to already hold (the decode shapes set it to seq_len).
    ``device='meta'`` gives shapes and dtypes only."""
    tfm.check_ported(cfg)
    dev = torch.device(device)
    if dev.type != 'meta':
        dev = resolve_device(dev)
    hd = cfg.head_dim
    S = kv_cache_slots(cfg, max_len)
    shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, hd)
    slots = torch.arange(S, dtype=torch.int32, device=dev)
    return {'length': int(length),
            'k': torch.zeros(shape, dtype=cfg.dtype, device=dev),
            'v': torch.zeros(shape, dtype=cfg.dtype, device=dev),
            'positions': torch.where(slots < length, slots, -1)}


def _attn_decode(layer_attn, h, kc, vc, positions, length: int,
                 cfg: ModelConfig):
    """One attention decode step against (and updating, in place) a cache
    slice.  h: [B, 1, D]; kc/vc: [B, S, KH, hd]; positions: [S].  Returns
    (attn_out, kc, vc, positions)."""
    B = h.shape[0]
    S = kc.shape[1]
    pos = length  # position of the incoming token
    q, k, v = tfm._project_qkv(
        layer_attn, h, cfg,
        torch.full((1,), pos, dtype=torch.int32, device=h.device))
    slot = pos % S
    kc[:, slot] = k[:, 0]
    vc[:, slot] = v[:, 0]
    positions[slot] = pos
    o = attn_mod.decode_attention(q, kc, vc, pos + 1, window=cfg.window,
                                  cache_positions=positions[None, :]
                                  .expand(B, S))
    return o.reshape(B, 1, -1) @ layer_attn['wo'], kc, vc, positions


def decode_step(params, cache, tokens, cfg: ModelConfig):
    """tokens: [B, 1] -> (cache, logits [B, V_padded]); the cache is
    updated in place."""
    tfm.check_ported(cfg)
    x = tfm.embed_tokens(params, tokens, cfg)
    length = cache['length']
    layers = params['layers']
    for i in range(cache['k'].shape[0]):
        layer = tfm.layer_slice(layers, i)
        xn = cm.rms_norm(x, layer['ln1'])
        o, _, _, _ = _attn_decode(layer['attn'], xn, cache['k'][i],
                                  cache['v'][i], cache['positions'], length,
                                  cfg)
        h = x + o
        pre = cm.rms_norm(h, layer['ln2'])
        x = h + mlp_mod.apply_mlp(layer['mlp'], pre, cfg.mlp_kind)
    cache['length'] = length + 1
    x = cm.rms_norm(x, params['ln_f'])
    return cache, (x @ params['unembed'])[:, 0]


def prefill(params, cache, tokens, cfg: ModelConfig):
    """Sequential prefill via decode steps (correct, not fast: the bulk
    prefill is ``forward_logits``).  tokens: [B, S] -> (cache, logits
    [B, S, V_padded])."""
    logits = []
    for t in range(tokens.shape[1]):
        cache, step = decode_step(params, cache, tokens[:, t:t + 1], cfg)
        logits.append(step)
    return cache, torch.stack(logits, dim=1)

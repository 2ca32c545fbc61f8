"""Serving path: KV / cross / conv / SSM caches and single-token decode
steps of every family.

``decode_step`` consumes a cache representing ``length`` already
processed tokens and produces logits for one new token.  Sliding-window
architectures use a ring-buffer cache of ``window`` slots (token ``pos``
goes to slot ``pos % slots``; ``positions`` holds each slot's token
position, -1 for an empty slot), so their decode memory is O(window),
independent of context length.

The cache is a dict as the reference's: ``k``, ``v`` [L, B, slots, KH, hd]
in the model's dtype (the hybrid family: one slice per application of
its shared attention block), ``positions`` [slots] int32 on the device;
for the audio family ``xk``, ``xv`` [L, B, enc_seq, KH, hd] in the
model's dtype, the cross-attention's keys and values of the encoder's
output, zero-filled as the reference's (its ``serve.run`` never fills
them, so its whisper decodes against zeros; a caller that wants the
encoder's context fills them with ``transformer.project_enc_kv``); for
the SSM and hybrid families ``conv`` [L, B, CONV_K - 1, ch] in the
model's dtype and ``ssm`` [L, B, heads, headdim, state] in f32; and
``length``, a host-side Python int (the reference keeps a device scalar).
``decode_step`` updates the cache IN PLACE and returns it (the JAX code
donates it and returns a new one).  An MoE layer decodes with a capacity
of no drops, ``max(capacity_factor, n_experts)``, as the reference does.
The VLM decodes text only, with no patch context, as the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
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
    tfm.check_family(cfg)
    dev = torch.device(device)
    if dev.type != 'meta':
        dev = resolve_device(dev)
    c = {'length': int(length)}
    if cfg.family in ('ssm', 'hybrid'):
        one = ssm_mod.init_mamba_cache(batch, cfg.d_model, cfg.ssm_state,
                                       cfg.ssm_headdim, cfg.dtype,
                                       device=dev)
        for key, t in one.items():
            c[key] = t.new_zeros((cfg.n_layers,) + t.shape)
    if cfg.family != 'ssm':
        n_kv = (cfg.n_layers if cfg.family != 'hybrid'
                else len(tfm.hybrid_groups(cfg)) - 1)
        S = kv_cache_slots(cfg, max_len)
        shape = (n_kv, batch, S, cfg.n_kv_heads, cfg.head_dim)
        slots = torch.arange(S, dtype=torch.int32, device=dev)
        c.update(k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                 v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                 positions=torch.where(slots < length, slots, -1))
    if cfg.family == 'audio':
        shape = (cfg.n_layers, batch, cfg.enc_seq, cfg.n_kv_heads,
                 cfg.head_dim)
        c.update(xk=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                 xv=torch.zeros(shape, dtype=cfg.dtype, device=dev))
    return c


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


def _layer_decode(layer, x, cache, i: int, cfg: ModelConfig):
    """One attention layer (dense or MoE feed-forward; audio: a decoder
    layer, its cross-attention against slice ``i`` of ``xk``/``xv``)
    against KV slice ``i`` of the cache."""
    o, _, _, _ = _attn_decode(layer['attn'], cm.rms_norm(x, layer['ln1']),
                              cache['k'][i], cache['v'][i],
                              cache['positions'], cache['length'], cfg)
    h = x + o
    if 'xattn' in layer:
        h = h + tfm.cross_attn_block(layer['xattn'],
                                     cm.rms_norm(h, layer['ln_x']),
                                     (cache['xk'][i], cache['xv'][i]), cfg)
        return h + mlp_mod.apply_mlp(layer['mlp'],
                                     cm.rms_norm(h, layer['ln2']), 'gelu')
    pre = cm.rms_norm(h, layer['ln2'])
    if 'moe' in layer:
        # no-drop capacity at decode time: a single-token routing group
        # would otherwise drop tokens that competed fine in the full
        # prefill group (train/serve capacity mismatch)
        y, _ = moe_mod.apply_moe(
            layer['moe'], pre,
            capacity_factor=float(max(cfg.capacity_factor, cfg.n_experts)))
    else:
        y = mlp_mod.apply_mlp(layer['mlp'], pre, cfg.mlp_kind)
    return h + y


def _ssm_decode(layers, x, cache, lo: int, hi: int, cfg: ModelConfig):
    """SSM layers ``lo``..``hi - 1`` one step, their conv and SSM caches
    updated in place."""
    for i in range(lo, hi):
        layer = tfm.layer_slice(layers, i)
        nc, y = ssm_mod.step_mamba_block(
            layer['mamba'], {'conv': cache['conv'][i], 'ssm': cache['ssm'][i]},
            cm.rms_norm(x, layer['ln1']), d_state=cfg.ssm_state,
            headdim=cfg.ssm_headdim)
        cache['conv'][i] = nc['conv']
        cache['ssm'][i] = nc['ssm']
        x = x + y
    return x


def decode_step(params, cache, tokens, cfg: ModelConfig):
    """tokens: [B, 1] -> (cache, logits [B, V_padded]); the cache is
    updated in place."""
    tfm.check_family(cfg)
    x = tfm.embed_tokens(params, tokens, cfg)
    layers = params['dec_layers' if cfg.family == 'audio' else 'layers']
    if cfg.family == 'ssm':
        x = _ssm_decode(layers, x, cache, 0, cfg.n_layers, cfg)
    elif cfg.family == 'hybrid':
        groups = tfm.hybrid_groups(cfg)
        for gi, (s, e) in enumerate(groups):
            x = _ssm_decode(layers, x, cache, s, e, cfg)
            if gi < len(groups) - 1:
                x = _layer_decode(params['shared_attn'], x, cache, gi, cfg)
    else:
        # dense, MoE, VLM, audio's decoder; with super-blocks, layer i of
        # the cache is sub-layer i % moe_every of block i // moe_every, its
        # MoE layer the last
        for i, layer in enumerate(tfm.dense_layers(layers)):
            x = _layer_decode(layer, x, cache, i, cfg)
    cache['length'] += 1
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

"""Decoder stacks of every assigned family (dense, MoE, SSM, hybrid, VLM,
audio): parameters, the prefill forward, the training loss and their
primitives.

Parameters keep the reference's tree: a nested dict with the layers
stacked on a leading ``[L, ...]`` axis, dense weights ``[in, out]``;
llama4-maverick's interleaved super-blocks are ``{'dense': [nb,
moe_every - 1, ...], 'moe': [nb, ...]}``, the hybrid family's one
shared attention block is ``shared_attn``, the VLM's projector of the
(stubbed) patch embeddings is ``patch_proj`` ``[d_model, d_model]``, and
the audio family's encoder-decoder holds ``enc_layers`` (dense layers),
``dec_layers`` (self-attention, cross-attention ``xattn`` and a gelu
MLP, each with its pre-norm), ``enc_ln_f`` and ``enc_pos`` ``[enc_seq,
d_model]``.  A Python loop over the layers takes the place of
``lax.scan``.  With ``cfg.remat`` and grad enabled each layer body runs
under ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of
its scan bodies): memory only, the values are the same, and a forward
without grad (serving) never checkpoints.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding as shd
from repro_torch.kernels.swa_attention import swa_attention
from repro_torch.models import attention as attn_mod
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig

FAMILIES = ('dense', 'moe', 'ssm', 'hybrid', 'vlm', 'audio')


def check_family(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a family the reference does not have."""
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def _norm(generator, cfg: ModelConfig, lead=()):
    """A norm's f32 gain [d_model], zeros (the gain is ``1 + scale``)."""
    return cm.param(generator, (cfg.d_model,), ('embed',), torch.float32,
                    init=cm.zeros_init, lead=lead)


def init_attn_layer(generator, cfg: ModelConfig, lead=()):
    hd = cfg.head_dim
    p = {
        'wq': cm.param(generator, (cfg.d_model, cfg.n_heads * hd),
                       ('embed', 'qkv'), cfg.dtype, lead=lead),
        'wk': cm.param(generator, (cfg.d_model, cfg.n_kv_heads * hd),
                       ('embed', 'kv'), cfg.dtype, lead=lead),
        'wv': cm.param(generator, (cfg.d_model, cfg.n_kv_heads * hd),
                       ('embed', 'kv'), cfg.dtype, lead=lead),
        'wo': cm.param(generator, (cfg.n_heads * hd, cfg.d_model),
                       ('qkv', 'embed'), cfg.dtype, lead=lead),
    }
    if cfg.qk_norm:
        p['q_norm'] = cm.param(generator, (hd,), (None,), torch.float32,
                               init=cm.zeros_init, lead=lead)
        p['k_norm'] = cm.param(generator, (hd,), (None,), torch.float32,
                               init=cm.zeros_init, lead=lead)
    return p


def init_dense_layer(generator, cfg: ModelConfig, lead=()):
    """One dense layer's params (its feed-forward an MoE when
    ``cfg.n_experts``), or ``lead`` of them stacked."""
    layer = {
        'ln1': _norm(generator, cfg, lead),
        'attn': init_attn_layer(generator, cfg, lead),
        'ln2': _norm(generator, cfg, lead),
    }
    if cfg.n_experts:
        layer['moe'] = moe_mod.init_moe(generator, cfg.d_model, cfg.d_ff,
                                        cfg.n_experts, cfg.dtype,
                                        cfg.moe_shared_expert, lead)
    else:
        layer['mlp'] = mlp_mod.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                        cfg.mlp_kind, cfg.dtype, lead)
    return layer


def init_ssm_layer(generator, cfg: ModelConfig, lead=()):
    return {
        'ln1': _norm(generator, cfg, lead),
        'mamba': ssm_mod.init_mamba_block(generator, cfg.d_model,
                                          cfg.ssm_state, cfg.ssm_headdim,
                                          cfg.dtype, lead=lead),
    }


def init_dec_layer(generator, cfg: ModelConfig, lead=()):
    """Encoder-decoder (whisper) decoder layer: self-attention,
    cross-attention and a gelu MLP, or ``lead`` of them stacked."""
    return {
        'ln1': _norm(generator, cfg, lead),
        'attn': init_attn_layer(generator, cfg, lead),
        'ln_x': _norm(generator, cfg, lead),
        'xattn': init_attn_layer(generator, cfg, lead),
        'ln2': _norm(generator, cfg, lead),
        'mlp': mlp_mod.init_mlp(generator, cfg.d_model, cfg.d_ff, 'gelu',
                                cfg.dtype, lead),
    }


def init_params(generator, cfg: ModelConfig):
    """The whole model's params on ``generator``'s device, drawn from it
    (``generator=None``: ``meta`` tensors, shapes and dtypes only)."""
    check_family(cfg)
    p = {
        'embed': cm.param(generator, (cfg.padded_vocab, cfg.d_model),
                          ('vocab', 'embed'), cfg.dtype, init=cm.embed_init),
        'ln_f': _norm(generator, cfg),
        'unembed': cm.param(generator, (cfg.d_model, cfg.padded_vocab),
                            ('embed', 'vocab'), cfg.dtype),
    }
    if cfg.family in ('dense', 'moe', 'vlm'):
        if cfg.n_experts and cfg.moe_every > 1:
            # interleaved dense/MoE blocks (llama4-maverick style):
            # super-blocks of (moe_every - 1) dense layers + 1 MoE layer
            if cfg.n_layers % cfg.moe_every:
                raise ValueError(f'n_layers {cfg.n_layers} is not a multiple '
                                 f'of moe_every {cfg.moe_every}')
            nb = cfg.n_layers // cfg.moe_every
            dense_cfg = dataclasses.replace(cfg, n_experts=0)
            p['layers'] = {
                'dense': init_dense_layer(generator, dense_cfg,
                                          lead=(nb, cfg.moe_every - 1)),
                'moe': init_dense_layer(generator, cfg, lead=(nb,)),
            }
        else:
            p['layers'] = init_dense_layer(generator, cfg,
                                           lead=(cfg.n_layers,))
    elif cfg.family == 'audio':
        p['enc_layers'] = init_dense_layer(generator, cfg,
                                           lead=(cfg.enc_layers,))
        p['dec_layers'] = init_dec_layer(generator, cfg,
                                         lead=(cfg.n_layers,))
        p['enc_ln_f'] = _norm(generator, cfg)
        p['enc_pos'] = cm.param(generator, (cfg.enc_seq, cfg.d_model),
                                (None, 'embed'), cfg.dtype,
                                init=cm.embed_init)
    else:   # ssm, hybrid
        p['layers'] = init_ssm_layer(generator, cfg, lead=(cfg.n_layers,))
        if cfg.family == 'hybrid':
            p['shared_attn'] = init_dense_layer(generator, cfg)
    if cfg.family == 'vlm':
        # projector from the (stubbed) vision encoder into the LLM
        # embedding
        p['patch_proj'] = cm.param(generator, (cfg.d_model, cfg.d_model),
                                   ('embed', 'embed_out'), cfg.dtype)
    return p


def layer_slice(stacked, i):
    """Layer ``i`` (an int or a slice) of a stacked ``[L, ...]`` tree
    (views, no copy)."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


def n_stacked(stacked) -> int:
    """The leading axis of a stacked tree."""
    v = next(iter(stacked.values()))
    return n_stacked(v) if isinstance(v, dict) else v.shape[0]


def unstack(stacked):
    """The layers of a stacked ``[L, ...]`` tree, in order, as views: one
    ``unbind`` a leaf, whose backward stacks the layers' gradients in one
    operation (indexing layer by layer would zero-fill and add a whole
    ``[L, ...]`` gradient for every layer)."""
    cols = {k: unstack(v) if isinstance(v, dict) else v.unbind(0)
            for k, v in stacked.items()}
    return [{k: c[i] for k, c in cols.items()}
            for i in range(n_stacked(stacked))]


def dense_layers(stacked):
    """The attention layers of a dense or MoE stack, in order, as views:
    for interleaved super-blocks (``{'dense', 'moe'}``) each block's dense
    layers, then its MoE layer, so that layer ``i`` of the list is layer
    ``i`` of the KV cache."""
    if not ('dense' in stacked and 'moe' in stacked):
        return unstack(stacked)
    layers = []
    for block, moe in zip(unstack(stacked['dense']), unstack(stacked['moe'])):
        layers += unstack(block)
        layers.append(moe)
    return layers


# ---------------------------------------------------------------------------
# Forward primitives
# ---------------------------------------------------------------------------

def _project_qkv(p, x, cfg: ModelConfig, positions, rope=True):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p['wq']).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p['wk']).reshape(B, S, cfg.n_kv_heads, hd)
    v = (x @ p['wv']).reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = cm.rms_norm(q, p['q_norm'])
        k = cm.rms_norm(k, p['k_norm'])
    if rope:
        q = cm.apply_rope(q, positions, cfg.rope_theta)
        k = cm.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_block(p, x, cfg: ModelConfig, *, causal=True, positions=None,
               window=None):
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions, rope=causal)
    if cfg.attn_impl == 'pallas' and causal:
        o = swa_attention(q, k, v, window=window,
                          block_q=cfg.q_block, block_k=cfg.kv_block)
    else:
        o = attn_mod.flash_attention(q, k, v, causal=causal, window=window,
                                     q_positions=positions,
                                     k_positions=positions,
                                     q_block=cfg.q_block,
                                     kv_block=cfg.kv_block)
    return o.reshape(B, S, -1) @ p['wo']


def cross_attn_block(p, x, enc_kv, cfg: ModelConfig):
    """x: [B, S, D]; enc_kv: (k, v) each [B, S_enc, KH, hd], already
    projected (``project_enc_kv``).  q is not roped; non-causal."""
    B, S, _ = x.shape
    q = (x @ p['wq']).reshape(B, S, cfg.n_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = cm.rms_norm(q, p['q_norm'])
    k, v = enc_kv
    o = attn_mod.flash_attention(q, k, v, causal=False, q_block=cfg.q_block,
                                 kv_block=cfg.kv_block)
    return o.reshape(B, S, -1) @ p['wo']


def project_enc_kv(p, enc_out, cfg: ModelConfig):
    """The cross-attention's (k, v) [B, S_enc, KH, hd] of the encoder's
    output (``k_norm`` on k only)."""
    B, Se, _ = enc_out.shape
    k = (enc_out @ p['wk']).reshape(B, Se, cfg.n_kv_heads, cfg.head_dim)
    v = (enc_out @ p['wv']).reshape(B, Se, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        k = cm.rms_norm(k, p['k_norm'])
    return k, v


def dense_layer_fwd(layer, x, cfg: ModelConfig, *, causal=True,
                    positions=None):
    """One layer; returns (output, aux) as the reference does (aux is the
    MoE's stats, empty for a dense feed-forward)."""
    x = shd.constrain_act(x, 'local_batch', 'seq', None)
    h = x + attn_block(layer['attn'], cm.rms_norm(x, layer['ln1']), cfg,
                       causal=causal, positions=positions, window=cfg.window)
    pre = cm.rms_norm(h, layer['ln2'])
    if 'moe' in layer:
        y, aux = moe_mod.apply_moe(layer['moe'], pre,
                                   capacity_factor=cfg.capacity_factor)
    else:
        y, aux = mlp_mod.apply_mlp(layer['mlp'], pre, cfg.mlp_kind), {}
    return h + y, aux


def ssm_layer_fwd(layer, x, cfg: ModelConfig):
    x = shd.constrain_act(x, 'local_batch', 'seq', None)
    return x + ssm_mod.apply_mamba_block(
        layer['mamba'], cm.rms_norm(x, layer['ln1']),
        d_state=cfg.ssm_state, headdim=cfg.ssm_headdim, chunk=cfg.ssm_chunk)


# ---------------------------------------------------------------------------
# Stacks
# ---------------------------------------------------------------------------

def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` recomputed in the backward pass instead of keeping its
    activations, when ``cfg.remat`` and grad is enabled."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn

    def remat(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, **kwargs)
    return remat


def run_dense_stack(stacked, x, cfg: ModelConfig, *, causal=True,
                    positions=None):
    """The layers in order (super-blocks: each block's dense layers, then
    its MoE layer); returns (h, summed load-balance loss, f32)."""
    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    layer_fwd = _maybe_remat(dense_layer_fwd, cfg)
    for layer in dense_layers(stacked):
        x, aux = layer_fwd(layer, x, cfg, causal=causal, positions=positions)
        if 'load_balance_loss' in aux:
            lb = lb + aux['load_balance_loss']
    return x, lb


def run_ssm_stack(layers, x, cfg: ModelConfig):
    """``layers`` (a list, as ``unstack`` gives them) in order."""
    layer_fwd = _maybe_remat(ssm_layer_fwd, cfg)
    for layer in layers:
        x = layer_fwd(layer, x, cfg)
    return x


def hybrid_groups(cfg: ModelConfig):
    """Split cfg.n_layers ssm layers into groups; a shared attention block
    runs between consecutive groups (zamba2-style)."""
    k = cfg.attn_every
    bounds, start = [], 0
    while start < cfg.n_layers:
        end = min(start + k, cfg.n_layers)
        bounds.append((start, end))
        start = end
    return bounds  # attention after every group except the last


def run_hybrid_stack(params, x, cfg: ModelConfig, *, positions=None):
    groups = hybrid_groups(cfg)
    layers = unstack(params['layers'])
    for gi, (s, e) in enumerate(groups):
        x = run_ssm_stack(layers[s:e], x, cfg)
        if gi < len(groups) - 1:
            x, _ = dense_layer_fwd(params['shared_attn'], x, cfg,
                                   causal=True, positions=positions)
    return x


# ---------------------------------------------------------------------------
# Model-level forward (prefill logits)
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens, cfg: ModelConfig):  # noqa: ARG001
    """The tokens' rows of ``embed``.  ``F.embedding`` (not indexing):
    its backward sums repeated tokens' gradients in a fixed order, where
    indexing's scatters them with atomic adds on the CPU."""
    return F.embedding(tokens, params['embed'])


def encode(params, frame_embeds, cfg: ModelConfig):
    """The audio encoder: ``frame_embeds`` [B, enc_seq, D] (any float
    dtype) cast to the model's, plus ``enc_pos``, through the non-causal,
    unroped dense stack, then ``enc_ln_f``."""
    frames = frame_embeds.to(cfg.dtype) + params['enc_pos'][None]
    enc, _ = run_dense_stack(params['enc_layers'], frames, cfg, causal=False)
    return cm.rms_norm(enc, params['enc_ln_f'])


def dec_layer_fwd(layer, x, enc, cfg: ModelConfig, *, positions=None):
    """One decoder layer of the audio family over the encoder's output
    ``enc``: causal self-attention, cross-attention, gelu MLP."""
    h = x + attn_block(layer['attn'], cm.rms_norm(x, layer['ln1']), cfg,
                       causal=True, positions=positions)
    kv = project_enc_kv(layer['xattn'], enc, cfg)
    h = h + cross_attn_block(layer['xattn'], cm.rms_norm(h, layer['ln_x']),
                             kv, cfg)
    return h + mlp_mod.apply_mlp(layer['mlp'], cm.rms_norm(h, layer['ln2']),
                                 'gelu')


def forward_logits(params, batch, cfg: ModelConfig):
    """batch: dict with 'tokens' [B, S]; the VLM adds 'patch_embeds'
    [B, n_patches, D], prepended after ``patch_proj`` (early fusion); audio
    adds 'frame_embeds' [B, enc_seq, D] for the encoder.  Returns (logits
    [B, S, V_padded], aux); aux holds the summed ``load_balance_loss`` for
    the dense, MoE and VLM families and is empty for the others, as in
    the reference."""
    check_family(cfg)
    tokens = batch['tokens']
    S = tokens.shape[1]
    x = embed_tokens(params, tokens, cfg)
    if cfg.family == 'vlm':
        patches = batch['patch_embeds'].to(cfg.dtype) @ params['patch_proj']
        x = torch.cat([patches, x], dim=1)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux = {}
    if cfg.family in ('dense', 'moe', 'vlm'):
        x, aux['load_balance_loss'] = run_dense_stack(params['layers'], x,
                                                      cfg,
                                                      positions=positions)
    elif cfg.family == 'ssm':
        x = run_ssm_stack(unstack(params['layers']), x, cfg)
    elif cfg.family == 'hybrid':
        x = run_hybrid_stack(params, x, cfg, positions=positions)
    else:   # audio
        enc = encode(params, batch['frame_embeds'], cfg)
        layer_fwd = _maybe_remat(dec_layer_fwd, cfg)
        for layer in unstack(params['dec_layers']):
            x = layer_fwd(layer, x, enc, cfg, positions=positions)
    if cfg.family == 'vlm':
        x = x[:, -S:]   # logits for the text positions only
    # gradient dtype barrier: keep f32 cotangents confined to the loss head
    x = cm.grad_cast(x, cfg.dtype)
    x = cm.rms_norm(x, params['ln_f'])
    return x @ params['unembed'], aux


def loss_fn(params, batch, cfg: ModelConfig):
    """Mean next-token cross-entropy of ``batch['labels']`` (masked by
    ``batch['loss_mask']`` when given), plus 0.01 x the summed
    load-balance loss for the dense, MoE and VLM families (0 without
    experts), as the reference's."""
    logits, aux = forward_logits(params, batch, cfg)
    loss = cm.cross_entropy_loss(logits, batch['labels'], cfg.vocab_size,
                                 batch.get('loss_mask'))
    if 'load_balance_loss' in aux:
        loss = loss + 0.01 * aux['load_balance_loss']
    return loss

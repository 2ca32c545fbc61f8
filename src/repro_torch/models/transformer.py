"""Decoder stack of the dense family: parameters, the prefill forward and
its primitives.

Parameters keep the reference's tree: a nested dict with the layers
stacked on a leading ``[L, ...]`` axis, dense weights ``[in, out]``.  A
Python loop over the layers takes the place of ``lax.scan``; there is no
remat (forward only).  The other families (MoE, SSM, hybrid, VLM, audio)
are not ported yet: ``check_ported`` names the ROADMAP item of each.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.swa_attention import swa_attention
from repro_torch.models import attention as attn_mod
from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.config import ModelConfig

#: family not ported yet -> the ROADMAP queue-1 item that ports it
FAMILY_ITEMS = {'moe': 24, 'ssm': 25, 'hybrid': 25, 'vlm': 26, 'audio': 26}


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for a model
    the port cannot build yet (any family but dense, or experts)."""
    if cfg.family != 'dense':
        raise NotImplementedError(
            f'the {cfg.family!r} family ({cfg.arch_id}) is not ported to '
            f'repro_torch yet (ROADMAP queue 1, item '
            f'{FAMILY_ITEMS.get(cfg.family, 24)})')
    if cfg.n_experts:
        raise NotImplementedError(
            f'mixture-of-experts layers ({cfg.arch_id}, n_experts='
            f'{cfg.n_experts}) are not ported to repro_torch yet (ROADMAP '
            f'queue 1, item {FAMILY_ITEMS["moe"]})')


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def init_attn_layer(generator, cfg: ModelConfig, lead=()):
    hd = cfg.head_dim
    p = {
        'wq': cm.param(generator, (cfg.d_model, cfg.n_heads * hd), cfg.dtype,
                       lead=lead),
        'wk': cm.param(generator, (cfg.d_model, cfg.n_kv_heads * hd),
                       cfg.dtype, lead=lead),
        'wv': cm.param(generator, (cfg.d_model, cfg.n_kv_heads * hd),
                       cfg.dtype, lead=lead),
        'wo': cm.param(generator, (cfg.n_heads * hd, cfg.d_model), cfg.dtype,
                       lead=lead),
    }
    if cfg.qk_norm:
        p['q_norm'] = cm.param(generator, (hd,), torch.float32,
                               init=cm.zeros_init, lead=lead)
        p['k_norm'] = cm.param(generator, (hd,), torch.float32,
                               init=cm.zeros_init, lead=lead)
    return p


def init_dense_layer(generator, cfg: ModelConfig, lead=()):
    """One dense layer's params, or ``lead=(L,)`` of them stacked."""
    check_ported(cfg)
    return {
        'ln1': cm.param(generator, (cfg.d_model,), torch.float32,
                        init=cm.zeros_init, lead=lead),
        'attn': init_attn_layer(generator, cfg, lead),
        'ln2': cm.param(generator, (cfg.d_model,), torch.float32,
                        init=cm.zeros_init, lead=lead),
        'mlp': mlp_mod.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                cfg.mlp_kind, cfg.dtype, lead),
    }


def init_params(generator, cfg: ModelConfig):
    """The whole model's params on ``generator``'s device, drawn from it
    (``generator=None``: ``meta`` tensors, shapes and dtypes only)."""
    return {
        'embed': cm.param(generator, (cfg.padded_vocab, cfg.d_model),
                          cfg.dtype, init=cm.embed_init),
        'ln_f': cm.param(generator, (cfg.d_model,), torch.float32,
                         init=cm.zeros_init),
        'unembed': cm.param(generator, (cfg.d_model, cfg.padded_vocab),
                            cfg.dtype),
        'layers': init_dense_layer(generator, cfg, lead=(cfg.n_layers,)),
    }


def layer_slice(stacked, i: int):
    """Layer ``i`` of a stacked ``[L, ...]`` tree (views, no copy)."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


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


def dense_layer_fwd(layer, x, cfg: ModelConfig, *, causal=True,
                    positions=None):
    """One layer; returns (output, aux) as the reference does (aux is
    empty: a dense layer has no load-balance loss)."""
    h = x + attn_block(layer['attn'], cm.rms_norm(x, layer['ln1']), cfg,
                       causal=causal, positions=positions, window=cfg.window)
    pre = cm.rms_norm(h, layer['ln2'])
    return h + mlp_mod.apply_mlp(layer['mlp'], pre, cfg.mlp_kind), {}


def run_dense_stack(stacked, x, cfg: ModelConfig, *, causal=True,
                    positions=None):
    """The layers in order; returns (h, summed load-balance loss = 0)."""
    for i in range(stacked['ln1'].shape[0]):
        x, _ = dense_layer_fwd(layer_slice(stacked, i), x, cfg,
                               causal=causal, positions=positions)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Model-level forward (prefill logits)
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens, cfg: ModelConfig):  # noqa: ARG001
    return params['embed'][tokens]


def forward_logits(params, batch, cfg: ModelConfig):
    """batch: dict with 'tokens' [B, S].  Returns (logits [B, S, V_padded],
    aux)."""
    check_ported(cfg)
    tokens = batch['tokens']
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    x, lb = run_dense_stack(params['layers'], x, cfg, positions=positions)
    x = cm.rms_norm(x, params['ln_f'])
    return x @ params['unembed'], {'load_balance_loss': lb}

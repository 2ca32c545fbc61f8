"""Analytic (napkin-math) FLOPs / HBM-bytes estimators per arch x shape.

The reference's formulas, unchanged: the standard 6ND-style accounting
from the architecture's config, which the dry run's roofline terms are
built from (the port traces its steps on the ``meta`` device, which
counts nothing).

Conventions:
  N   total params;  Na  active params (MoE top-1: shared + 1 expert)
  T   tokens processed;  S  seq;  B  batch;  W  attention window
  train flops  = 8 Na T   (fwd 2NaT + bwd 4NaT + remat re-fwd 2NaT)
  prefill flops= 2 Na T
  decode flops = 2 Na B   (one token per sequence)
  attention adds 2*2*B*H*hd*S*S_eff per layer (QK^T + PV), x4 for training
  (bwd+remat), with S_eff = min(S, W)/2-ish causal average.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig


def _attn_tokens_eff(S: int, window) -> float:
    """Average causal KV footprint per query."""
    if window is not None and window < S:
        return window  # steady-state: each query sees ~W keys
    return S / 2.0


def _attn_layers(cfg: ModelConfig) -> int:
    if cfg.family in ('dense', 'moe', 'vlm'):
        return cfg.n_layers
    if cfg.family == 'hybrid':
        # shared attention block between groups of attn_every ssm layers
        return max(0, -(-cfg.n_layers // cfg.attn_every) - 1)
    if cfg.family == 'audio':
        return cfg.n_layers + cfg.enc_layers  # + cross-attn handled below
    return 0


def flops_estimate(cfg: ModelConfig, *, kind: str, batch: int, seq: int,
                   n_active: int, local_steps: int = 1) -> float:
    """Total FLOPs for one step across the whole mesh."""
    T = batch * seq if kind != 'decode' else batch
    H, hd = cfg.n_heads, cfg.head_dim
    L_attn = _attn_layers(cfg)

    if kind == 'train':
        # fwd 2NaT + bwd 4NaT (+ remat re-forward 2NaT)
        factor = 8.0 if cfg.remat else 6.0
        mat = factor * n_active * T * local_steps
        s_eff = _attn_tokens_eff(seq, cfg.window)
        attn = (factor / 2) * (2 * 2 * batch * H * hd * seq * s_eff) \
            * L_attn * local_steps
    elif kind == 'prefill':
        mat = 2.0 * n_active * T
        s_eff = _attn_tokens_eff(seq, cfg.window)
        attn = 2 * 2 * batch * H * hd * seq * s_eff * L_attn
    else:  # decode: one token attends to the full (or windowed) cache
        mat = 2.0 * n_active * batch
        kv_seen = min(seq, cfg.window) if cfg.window else seq
        attn = 2 * 2 * batch * H * hd * kv_seen * L_attn
    if cfg.family == 'audio' and kind != 'train':
        # cross-attention reads enc_seq keys per decoder layer
        attn += 2 * 2 * batch * H * hd * cfg.enc_seq * cfg.n_layers
    return mat + attn


def bytes_estimate(cfg: ModelConfig, *, kind: str, batch: int, seq: int,
                   n_params: int, n_clients: int = 1, dtype_bytes: int = 2,
                   local_steps: int = 1) -> float:
    """Total HBM bytes moved for one step across the whole mesh.

    train (silo SAFA round): per client — read global + local + cache,
    write local + cache (+ grads transient), plus activations ~2 passes
    (remat) of L*B*S*D; aggregation reads cache once more + writes global.
    """
    D, L = cfg.d_model, cfg.n_layers
    P = n_params * dtype_bytes
    if kind == 'train':
        act = 2 * L * batch * seq * D * dtype_bytes * 2  # fwd+refwd residual streams
        params_traffic = n_clients * (3 + 2) * P + 2 * P  # clients*(r3+w2) + agg r/w
        grads = n_clients * 2 * P * local_steps
        return params_traffic + grads + act * local_steps
    if kind == 'prefill':
        act = 2 * L * batch * seq * D * dtype_bytes
        kv_write = 2 * L * batch * seq * cfg.n_kv_heads * cfg.head_dim * dtype_bytes
        return P + act + kv_write
    # decode: read all params + read cache + write cache slot
    cache_bytes = 0
    if cfg.n_heads:
        S_c = min(seq, cfg.window) if cfg.window else seq
        cache_bytes = 2 * _attn_layers(cfg) * batch * S_c * \
            max(1, cfg.n_kv_heads) * cfg.head_dim * dtype_bytes
    if cfg.family in ('ssm', 'hybrid'):
        d_inner = 2 * D
        cache_bytes += L * batch * (d_inner // cfg.ssm_headdim) * \
            cfg.ssm_headdim * cfg.ssm_state * 4 * 2  # f32 state r+w
    return P + cache_bytes + batch * D * L * dtype_bytes

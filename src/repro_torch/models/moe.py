"""Top-1 routed Mixture-of-Experts (llama4-style MoE layers).

Capacity-based dispatch in the Mesh-TensorFlow style, as the reference
computes it: tokens are grouped (``min(N, 1024)`` a group, N padded with
zero tokens), each token is routed in f32 to its top-1 expert (softmax,
then the first argmax), takes its place in that expert's queue in token
order within its group, and is dropped when that place is at or past the
capacity ``C = max(1, int(capacity_factor * group / E))`` (only its
residual passes).  The expert SwiGLU runs in the model's dtype, and the
combine multiplies by the gate cast to that dtype.

The reference dispatches and combines with one-hot ``[G, S, E, C]``
einsums; here a token is copied into its ``[E, G, C, M]`` slot and read
back from it by index, and the experts run as one batched product over
``E``.  Each slot holds one token or none, so both give the same values.

llama4 also has a *shared* expert applied to every token
(``shared_expert=True``), as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models import mlp as mlp_mod


def init_moe(generator, d_model, d_ff, n_experts, dtype, shared_expert=True,
             lead=()):
    """One MoE layer's params, or ``lead`` of them stacked.  Expert stacks
    are ``[E, in, out]``; as in the reference, their init's fan-in is
    their first axis, ``E``."""
    p = {
        'router': cm.param(generator, (d_model, n_experts), torch.float32,
                           lead=lead),
        'w_gate': cm.param(generator, (n_experts, d_model, d_ff), dtype,
                           lead=lead),
        'w_up': cm.param(generator, (n_experts, d_model, d_ff), dtype,
                         lead=lead),
        'w_down': cm.param(generator, (n_experts, d_ff, d_model), dtype,
                           lead=lead),
    }
    if shared_expert:
        p['shared'] = mlp_mod.init_mlp(generator, d_model, d_ff, 'swiglu',
                                       dtype, lead)
    return p


def route(p, tokens):
    """tokens [..., M] -> (top-1 expert [...], its gate [...], the router's
    probabilities [..., E]), in f32: softmax, then the first max."""
    probs = torch.softmax(tokens.float() @ p['router'], dim=-1)
    idx = probs.argmax(dim=-1)
    return idx, probs.gather(-1, idx[..., None])[..., 0], probs


def apply_moe(p, x, *, capacity_factor=1.25, group_size=None):
    """x: [B, S, M] -> (y, aux) where aux carries the router's
    load-balance stats (``load_balance_loss``, ``dropped_frac``), both
    counting the pad tokens as the reference does."""
    B, S, M = x.shape
    E = p['router'].shape[-1]
    N = B * S
    tokens = x.reshape(N, M)
    if group_size is None:
        group_size = min(N, 1024)
    pad = (-N) % group_size
    if pad:
        tokens = F.pad(tokens, (0, 0, 0, pad))
    G = tokens.shape[0] // group_size
    tg = tokens.reshape(G, group_size, M)

    idx, gate, probs = route(p, tg)                                 # [G,S]
    onehot = F.one_hot(idx, E)                                      # [G,S,E]

    C = max(1, int(capacity_factor * group_size / E))
    # each token's place in its expert's queue, in token order
    pos = (onehot.cumsum(dim=1).gather(-1, idx[..., None])[..., 0] - 1)
    keep = pos < C
    g_of = torch.arange(G, device=x.device)[:, None].expand(G, group_size)
    e_k, g_k, c_k = idx[keep], g_of[keep], pos[keep]

    xin = tg.new_zeros((E, G, C, M))
    xin[e_k, g_k, c_k] = tg[keep]
    xin = xin.reshape(E, G * C, M)
    h = F.silu(torch.bmm(xin, p['w_gate'])) * torch.bmm(xin, p['w_up'])
    xout = torch.bmm(h, p['w_down']).reshape(E, G, C, M)
    y = tg.new_zeros((G, group_size, M))
    y[keep] = gate[keep].to(x.dtype)[:, None] * xout[e_k, g_k, c_k]

    y = y.reshape(-1, M)[:N].reshape(B, S, M)
    if 'shared' in p:
        y = y + mlp_mod.apply_mlp(p['shared'], x, 'swiglu')

    # load-balance aux loss (Shazeer-style): E * sum(frac_tokens * frac_probs)
    frac_tokens = onehot.float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = {'load_balance_loss': E * torch.sum(frac_tokens * frac_probs),
           'dropped_frac': 1.0 - keep.sum().float() / max(1, N)}
    return y, aux

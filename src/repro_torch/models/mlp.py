"""Feed-forward variants: SwiGLU (llama-style), squared-ReLU (nemotron)
and GELU (whisper)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm


def init_mlp(generator, d_model, d_ff, kind: str, dtype, lead=()):
    p = {
        'w_up': cm.param(generator, (d_model, d_ff), ('embed', 'mlp'), dtype,
                         lead=lead),
        'w_down': cm.param(generator, (d_ff, d_model), ('mlp', 'embed'),
                           dtype, lead=lead),
    }
    if kind == 'swiglu':
        p['w_gate'] = cm.param(generator, (d_model, d_ff), ('embed', 'mlp'),
                               dtype, lead=lead)
    return p


def apply_mlp(p, x, kind: str):
    up = x @ p['w_up']
    if kind == 'swiglu':
        h = F.silu(x @ p['w_gate']) * up
    elif kind == 'relu2':
        h = torch.square(F.relu(up))
    elif kind == 'gelu':
        h = F.gelu(up, approximate='tanh')   # jax.nn.gelu's default
    else:
        raise ValueError(kind)
    return h @ p['w_down']

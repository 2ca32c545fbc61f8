"""Mamba2 / SSD (state-space duality) block [arXiv:2405.21060].

Chunked "dual form": quadratic attention-like computation inside chunks
plus a linear recurrence across chunk boundary states, in f32.  Decode is
an O(1) single-step state update.  ``ssd_ref`` is the sequential oracle
of the tests.

The reference writes the chunked form's products as four-operand
einsums; here each is contracted in a written-out order that never
builds a ``[b, L, h, c, c, p]`` tensor (17 GB at zamba2-1.2b's 8192-token
prefill): the within-chunk weights ``[b, L, h, c, c]`` times the inputs,
and the chunk states and outputs as products over the chunk or the state
axis.  Plain PyTorch, as the reference is plain jnp.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm


def segsum(x):
    """x: [..., T] -> cumulative segment sums [..., T, T]; entry (i, j) =
    sum_{k=j+1..i} x_k for i >= j, -inf above the diagonal."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    d = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(T, device=x.device)
    return d.masked_fill(i[:, None] < i[None, :], -torch.inf)


def ssd_chunked(x, dt, A, B, C, chunk=128, initial_state=None):
    """SSD scan in chunked dual form.

    x: [b, s, h, p]   inputs per head
    dt: [b, s, h]     softplus'd step sizes
    A: [h]            negative per-head decay rates (A = -exp(A_log))
    B, C: [b, s, n]   (single group, broadcast over heads)
    Returns (y [b, s, h, p] in x's dtype, final_state [b, h, p, n] f32).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    L = x.shape[1] // chunk

    xb = x.reshape(b, L, chunk, h, p).float()
    dtb = dt.reshape(b, L, chunk, h).float()
    Bb = B.reshape(b, L, chunk, n).float()
    Cb = C.reshape(b, L, chunk, n).float()

    dA = dtb * A.float()                                     # [b,L,c,h]
    dAc = torch.cumsum(dA, dim=2)                            # within-chunk
    xdt = (dtb[..., None] * xb).permute(0, 1, 3, 2, 4)       # [b,L,h,c,p]
    # 1. intra-chunk (diagonal blocks): (C_i . B_j) L_hij, then times x_j dt_j
    Lmat = torch.exp(segsum(dA.permute(0, 1, 3, 2)))         # [b,L,h,c,c]
    scores = Cb @ Bb.transpose(-1, -2)                       # [b,L,c,c]
    y_diag = (scores[:, :, None] * Lmat) @ xdt               # [b,L,h,c,p]
    del Lmat
    # 2. chunk-final states: sum over the chunk of decayed x_c dt_c B_c
    decay_states = torch.exp(dAc[:, :, -1:, :] - dAc)        # [b,L,c,h]
    xw = decay_states.permute(0, 1, 3, 2)[..., None] * xdt   # [b,L,h,c,p]
    states = xw.transpose(-1, -2) @ Bb[:, :, None]           # [b,L,h,p,n]
    del xw, xdt
    # 3. inter-chunk recurrence
    chunk_decay = torch.exp(dAc[:, :, -1, :])                # [b,L,h]
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    prev = []
    for li in range(L):
        prev.append(carry)              # the state *entering* chunk li
        carry = carry * chunk_decay[:, li, :, None, None] + states[:, li]
    prev_states = torch.stack(prev, dim=1)                   # [b,L,h,p,n]
    # 4. inter-chunk outputs: C_c . state, decayed to position c
    state_decay_out = torch.exp(dAc).permute(0, 1, 3, 2)     # [b,L,h,c]
    y_off = (Cb[:, :, None] @ prev_states.transpose(-1, -2)) \
        * state_decay_out[..., None]                         # [b,L,h,c,p]
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(b, -1, h, p)[:, :s]
    return y.to(x.dtype), carry


def ssd_step(state, x_t, dt_t, A, B_t, C_t):
    """O(1) decode step.  state: [b,h,p,n]; x_t: [b,h,p]; dt_t: [b,h];
    B_t, C_t: [b,n].  Returns (new_state f32, y_t [b,h,p] in x_t's
    dtype)."""
    state = state.float()
    dtf = dt_t.float()
    dA = torch.exp(dtf * A.float())                                # [b,h]
    dBx = (dtf[:, :, None, None] * x_t.float()[..., None]
           * B_t.float()[:, None, None, :])                        # [b,h,p,n]
    new = state * dA[:, :, None, None] + dBx
    y = (new @ C_t.float()[:, None, :, None])[..., 0]
    return new, y.to(x_t.dtype)


def ssd_ref(x, dt, A, B, C, initial_state=None):
    """Sequential oracle (step-by-step recurrence) for tests."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    st = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
          if initial_state is None else initial_state.float())
    ys = []
    for t in range(s):
        st, y = ssd_step(st, x[:, t], dt[:, t], A, B[:, t], C[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), st


# ---------------------------------------------------------------------------
# Full Mamba2 block
# ---------------------------------------------------------------------------

CONV_K = 4  # depthwise causal conv kernel width


def _dt_bias(u):
    return torch.log(torch.expm1(u))    # softplus^-1 of U(1e-3, 0.1)


def init_mamba_block(generator, d_model, d_state, headdim, dtype, expand=2,
                     lead=()):
    """One block's params, or ``lead`` of them stacked, drawn as the
    reference draws them: ``conv_w`` normal x 0.1 (not truncated),
    ``A_log`` = log U(1, 16), ``dt_bias`` = log(expm1(U(1e-3, 0.1))),
    ``D`` ones, ``norm_scale`` zeros."""
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    conv_ch = d_inner + 2 * d_state  # conv over (x, B, C)
    f32 = torch.float32
    return {
        'in_proj': cm.param(generator,
                            (d_model, 2 * d_inner + 2 * d_state + n_heads),
                            ('embed', 'ssm_inner'), dtype, lead=lead),
        'conv_w': cm.param(generator, (CONV_K, conv_ch), (None, 'ssm_inner'),
                           dtype, init=cm.normal_init(0.1), lead=lead),
        'conv_b': cm.param(generator, (conv_ch,), ('ssm_inner',), dtype,
                           init=cm.zeros_init, lead=lead),
        'A_log': cm.param(generator, (n_heads,), (None,), f32,
                          init=cm.uniform_init(1.0, 16.0, torch.log),
                          lead=lead),
        'D': cm.param(generator, (n_heads,), (None,), f32, init=cm.ones_init,
                      lead=lead),
        'dt_bias': cm.param(generator, (n_heads,), (None,), f32,
                            init=cm.uniform_init(1e-3, 0.1, _dt_bias),
                            lead=lead),
        'norm_scale': cm.param(generator, (d_inner,), ('ssm_inner',), f32,
                               init=cm.zeros_init, lead=lead),
        'out_proj': cm.param(generator, (d_inner, d_model),
                             ('ssm_inner', 'embed'), dtype, lead=lead),
    }


def _split_in_proj(zxbcdt, d_inner, d_state):
    """z, x, B, C, dt along the last axis."""
    n_heads = zxbcdt.shape[-1] - 2 * d_inner - 2 * d_state
    return torch.split(zxbcdt, [d_inner, d_inner, d_state, d_state, n_heads],
                       dim=-1)


def _causal_conv(xbc, w, b):
    """xbc: [batch, seq, ch]; w: [K, ch] depthwise causal conv, summed tap
    by tap in xbc's dtype as the reference sums."""
    K, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + S, :] * w[i] for i in range(K))
    return F.silu(out + b)


def _gated_out(p, y, z):
    """RMSNorm of y gated by silu(z), then the output projection."""
    y = cm.rms_norm(y * F.silu(z.float()).to(y.dtype), p['norm_scale'])
    return y @ p['out_proj']


def apply_mamba_block(p, x, *, d_state, headdim, chunk=128, expand=2):
    """x: [b, s, d_model] -> [b, s, d_model]."""
    bsz, s, d_model = x.shape
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    z, xc, B, C, dt = _split_in_proj(x @ p['in_proj'], d_inner, d_state)
    xbc = _causal_conv(torch.cat([xc, B, C], dim=-1), p['conv_w'],
                       p['conv_b'])
    xc, B, C = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)
    dt = F.softplus(dt.float() + p['dt_bias'])
    A = -torch.exp(p['A_log'])
    xh = xc.reshape(bsz, s, n_heads, headdim)
    y, _ = ssd_chunked(xh, dt, A, B, C, chunk=chunk)
    y = y + xh * p['D'][None, None, :, None].to(y.dtype)
    return _gated_out(p, y.reshape(bsz, s, d_inner), z)


def init_mamba_cache(bsz, d_model, d_state, headdim, dtype, expand=2,
                     device='cpu'):
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    conv_ch = d_inner + 2 * d_state
    return {
        'conv': torch.zeros((bsz, CONV_K - 1, conv_ch), dtype=dtype,
                            device=device),
        'ssm': torch.zeros((bsz, n_heads, headdim, d_state),
                           dtype=torch.float32, device=device),
    }


def step_mamba_block(p, cache, x_t, *, d_state, headdim, expand=2):
    """x_t: [b, 1, d_model] -> (new_cache, y_t [b, 1, d_model]); the cache
    passed in is not changed."""
    bsz, _, d_model = x_t.shape
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    z, xc, B, C, dt = _split_in_proj((x_t @ p['in_proj'])[:, 0], d_inner,
                                     d_state)
    conv_in = torch.cat([xc, B, C], dim=-1)                      # [b, ch]
    conv_win = torch.cat([cache['conv'], conv_in[:, None]], dim=1)  # [b,K,ch]
    conv_out = F.silu(torch.einsum('bkc,kc->bc', conv_win, p['conv_w'])
                      + p['conv_b'])
    xc, B, C = torch.split(conv_out, [d_inner, d_state, d_state], dim=-1)
    dt = F.softplus(dt.float() + p['dt_bias'])
    A = -torch.exp(p['A_log'])
    xh = xc.reshape(bsz, n_heads, headdim)
    new_ssm, y = ssd_step(cache['ssm'], xh, dt, A, B, C)
    y = y + xh * p['D'][None, :, None].to(y.dtype)
    y = _gated_out(p, y.reshape(bsz, d_inner), z)
    return {'conv': conv_win[:, 1:], 'ssm': new_ssm}, y[:, None, :]

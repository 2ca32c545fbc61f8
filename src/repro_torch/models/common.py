"""Parameter initialisers, RMSNorm, RoPE and the loss of the model path.

Parameters are nested dicts of tensors, as the JAX package's unboxed
trees are.  Each ``param`` call names its *logical* axes, as the
reference's ``cm.param(key, shape, axes, ...)`` does; where the reference
boxes a value with its axes, the port asks the same init code for one or
the other: an initialiser draws on a ``torch.Generator`` on the
parameter's device; given ``generator=None``, ``param`` returns a tensor
on the ``meta`` device (shape and dtype, no storage), which is how
``Model.n_params`` counts without allocating; given ``generator=AXES``,
it returns the axis names (``Model.param_axes``), the layers' stacked
axes named ``'layers'``.  ``repro_torch.sharding`` maps the names to
mesh axes.
"""
from __future__ import annotations

import itertools
import math

import torch

# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


#: the most f32 values drawn at once: a tensor is drawn in slices of its
#: first axis of at most this many values (llama4-maverick's [128, 5120,
#: 8192] expert stack would take 21.5 GB in f32 beside the 10.7 GB it fills)
DRAW_LIMIT = 1 << 28


def _trunc_normal(generator, shape, dtype, stddev, device):
    """``stddev * truncated_normal(-2, 2)`` drawn in f32, then cast, as the
    reference draws it.  ``trunc_normal_``'s bounds are absolute, so they
    are ``±2 * stddev`` here."""
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = max(1, DRAW_LIMIT // math.prod(shape[1:]))
    for i in range(0, shape[0], rows):
        t = torch.empty((min(rows, shape[0] - i),) + tuple(shape[1:]),
                        dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(t, mean=0.0, std=stddev,
                                    a=-2.0 * stddev, b=2.0 * stddev,
                                    generator=generator)
        out[i:i + rows] = t
        del t   # before the next slice is drawn
    return out


def dense_init(generator, shape, dtype, device):
    """LeCun-normal style init: stddev = 1/sqrt(fan_in), fan_in = shape[0]."""
    return _trunc_normal(generator, shape, dtype,
                         1.0 / math.sqrt(max(1, shape[0])), device)


def embed_init(generator, shape, dtype, device):
    return _trunc_normal(generator, shape, dtype, 1.0, device)


def zeros_init(generator, shape, dtype, device):  # noqa: ARG001
    return torch.zeros(shape, dtype=dtype, device=device)


def ones_init(generator, shape, dtype, device):  # noqa: ARG001
    return torch.ones(shape, dtype=dtype, device=device)


def normal_init(scale):
    """``scale * normal`` (not truncated), drawn in f32, then cast."""
    def init(generator, shape, dtype, device):
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(dtype)
    return init


def uniform_init(lo, hi, fn):
    """``fn(U(lo, hi))`` in f32, then cast (the SSM's ``A_log`` and
    ``dt_bias``)."""
    def init(generator, shape, dtype, device):
        u = torch.rand(shape, generator=generator, device=device)
        return fn(u * (hi - lo) + lo).to(dtype)
    return init


class _Axes:
    """The type of ``AXES``."""

    def __repr__(self):
        return 'AXES'


#: pass as ``param``'s generator to get each parameter's logical axes
AXES = _Axes()


def param(generator, shape, axes, dtype=torch.float32, init=dense_init,
          lead=()):
    """One parameter of ``shape`` with ``lead`` stacked axes in front (the
    layers' ``[L, ...]``), each layer drawn on its own, so a stacked dense
    weight's fan-in is the layer's.  ``axes`` names each axis of
    ``shape`` (``None``: unsharded).  ``generator=None`` gives a ``meta``
    tensor, ``generator=AXES`` the tuple of axis names, ``'layers'`` for
    each axis of ``lead``."""
    if len(shape) != len(axes):
        raise ValueError(f'{len(axes)} axis names {axes} for shape {shape}')
    if generator is AXES:
        return ('layers',) * len(lead) + tuple(axes)
    shape = tuple(int(s) for s in shape)
    lead = tuple(int(s) for s in lead)
    if generator is None:
        return torch.empty(lead + shape, dtype=dtype, device='meta')
    if not lead:
        return init(generator, shape, dtype, generator.device)
    # one layer at a time: the f32 draw of a whole stack (3.8 GB for
    # h2o-danube-3-4b's w_up) would outweigh the bf16 model it fills
    out = torch.empty(lead + shape, dtype=dtype, device=generator.device)
    for i in itertools.product(*map(range, lead)):
        out[i] = init(generator, shape, dtype, generator.device)
    return out


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def _rms_norm_fwd(x, scale, eps):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    return (xf * r * (1.0 + scale.float())).to(x.dtype)


class _RMSNorm(torch.autograd.Function):
    """The reference's custom VJP: f32 inside, the input cotangent in x's
    dtype and the gain's in scale's."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _rms_norm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        xf, gf = x.float(), g.float()
        gain = 1.0 + scale.float()
        d = x.shape[-1]
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        r = torch.rsqrt(var + ctx.eps)
        gg = gf * gain
        dot = torch.sum(gg * xf, dim=-1, keepdim=True)
        dx = r * gg - (r ** 3) * xf * dot / d
        dscale = torch.sum(gf * xf * r, dim=tuple(range(x.dim() - 1)))
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def rms_norm(x, scale, eps=1e-6):
    """RMSNorm with (1 + scale) gain, computed in f32 and cast back to x's
    dtype.  Differentiated by the reference's custom VJP
    (``_RMSNorm.backward``); without grad, the plain forward."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    return _rms_norm_fwd(x, scale, eps)


class _GradCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def grad_cast(x, dtype):
    """Identity forward; the cotangent is cast to ``dtype`` on the way
    back (the reference puts it before the unembedding, so the loss
    head's f32 cotangents stay in the head).  Autograd hands x's own
    dtype on to x, so the cast shows as a rounding of the values."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GradCast.apply(x, dtype)
    return x


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0, device=None):
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)  # [head_dim/2]


def apply_rope(x, positions, theta: float = 10000.0):
    """x: [..., seq, heads, head_dim]; positions: [..., seq] int32.  Split
    halves (not interleaved pairs), computed in f32, cast back."""
    head_dim = x.shape[-1]
    freqs = rope_freqs(head_dim, theta, device=x.device)        # [hd/2]
    angles = positions[..., :, None].float() * freqs            # [..., s, hd/2]
    angles = angles[..., :, None, :]                            # [..., s, 1, hd/2]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def pad_vocab(vocab_size: int, multiple: int = 256) -> int:
    return int(-(-vocab_size // multiple) * multiple)


def cross_entropy_loss(logits, labels, vocab_size: int, mask=None):
    """Mean next-token CE in f32; ``vocab_size`` is the unpadded size (the
    padded ids' logits are set to -1e9, out of the softmax).  A stable
    logsumexp, as the reference's; the gold logit is gathered where the
    reference contracts a one-hot (for its sharded vocabulary): the same
    value, without a [B, S, V] one-hot."""
    padded = logits.shape[-1]
    logits = logits.float()
    if padded != vocab_size:
        ids = torch.arange(padded, device=logits.device)
        logits = torch.where(ids < vocab_size, logits, -1e9)
    m = torch.amax(logits, dim=-1)                                 # [B,S]
    logz = m + torch.log(torch.sum(torch.exp(logits - m[..., None]),
                                   dim=-1))
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)

"""``Model.loss`` and its gradient against the JAX package on the CPU for
every configuration (reduced, f32; MoE routes equal), ``cfg.remat``
(values unchanged; serving never checkpoints), the custom backward
passes (``rms_norm``, ``grad_cast``) and the cross-entropy.  The
reference's params are carried across (``params_from_jax``).

Tolerances: one loss and gradient of a reduced f32 model, two layers of
f32 arithmetic in another order on each side: the loss within 1e-5,
every gradient leaf within atol 1e-5 + rtol 1e-4.  The custom backward
passes compute the reference's formula: f32 within 1e-6, bf16 within
one bf16 rounding (rtol 2^-7); the cross-entropy's value within 1e-6
and its gradient within 1e-7.  Remat recomputes the same operations, so
its loss and gradients are equal bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models import common as j_cm
from repro.models import moe as j_moe
from repro.models.model import build_model as j_build_model
from repro_torch import configs as tcfgs
from repro_torch.convert import params_from_jax
from repro_torch.models import common as t_cm
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as tfm
from repro_torch.models.model import build_model

LOSS_ATOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(arch, **kw):
    return (jcfgs.get_config(arch).reduced(**kw),
            tcfgs.get_config(arch).reduced(**kw))


def _carried(jc, seed):
    tree = _np(j_build_model(jc).init(jax.random.PRNGKey(seed)))
    return tree, params_from_jax(tree, device='cpu')


def _batch(cfg, lead, S, seed=0):
    """Seeded tokens and labels of shape ``lead + (S,)``; the VLM's patch
    and the audio family's frame embeddings 0.1 N(0, 1), f32.  Returns
    (numpy batch, JAX batch, port batch)."""
    rng = np.random.default_rng(seed)
    b = {'tokens': rng.integers(0, cfg.vocab_size, lead + (S,)),
         'labels': rng.integers(0, cfg.vocab_size, lead + (S,))}
    b = {k: v.astype(np.int32) for k, v in b.items()}
    if cfg.family == 'vlm':
        b['patch_embeds'] = (0.1 * rng.normal(
            size=lead + (cfg.n_patches, cfg.d_model))).astype(np.float32)
    if cfg.family == 'audio':
        b['frame_embeds'] = (0.1 * rng.normal(
            size=lead + (cfg.enc_seq, cfg.d_model))).astype(np.float32)
    return (b, {k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _close(got, want, atol, rtol=0.0):
    got = jax.tree.map(lambda t: t.detach().float().numpy(), got)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol,
                                   err_msg=jax.tree_util.keystr(path))


def _loss_and_grads(model, params, batch):
    p = jax.tree.map(lambda t: t.clone().requires_grad_(), params)
    loss = model.loss(p, batch)
    grads = torch.autograd.grad(loss, jax.tree.leaves(p), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), jax.tree.unflatten(jax.tree.structure(p), grads)


# -- (a) the loss and its gradient, every configuration -----------------------

@pytest.mark.parametrize('arch', jcfgs.ARCH_IDS)
def test_loss_and_grads_match_reference(arch, monkeypatch):
    """Every family trains: the loss within 1e-5, each gradient leaf
    within atol 1e-5 + rtol 1e-4, and an MoE layer's routes equal (read
    on the reference's forward and the port's loss forward)."""
    jc, tc = _pair(arch)
    tree, params = _carried(jc, 60 + jcfgs.ARCH_IDS.index(arch))
    _, jb, tb = _batch(jc, (2,), 16)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        j_build_model(jc).loss))(tree, jb)

    seen = {'jax': [], 'torch': []}
    j_apply, t_apply = j_moe.apply_moe, t_moe.apply_moe

    def j_wrap(p, x, **kw):
        logits = x.reshape(-1, x.shape[-1]).astype(jnp.float32) @ p['router']
        seen['jax'].append(np.asarray(jnp.argmax(
            jax.nn.softmax(logits, axis=-1), axis=-1)))
        return j_apply(p, x, **kw)

    def t_wrap(p, x, **kw):
        with torch.no_grad():
            seen['torch'].append(
                t_moe.route(p, x.reshape(-1, x.shape[-1]))[0].numpy())
        return t_apply(p, x, **kw)
    monkeypatch.setattr(j_moe, 'apply_moe', j_wrap)
    monkeypatch.setattr(t_moe, 'apply_moe', t_wrap)
    with jax.disable_jit():
        j_build_model(jc).logits(tree, jb)
    loss, grads = _loss_and_grads(build_model(tc), params, tb)

    assert loss.dtype == torch.float32 and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(want_loss), atol=LOSS_ATOL)
    _close(grads, want_grads, GRAD_ATOL, GRAD_RTOL)
    assert len(seen['torch']) == len(seen['jax'])
    assert len(seen['jax']) == (jc.n_layers // jc.moe_every if jc.n_experts
                                else 0)
    for a, b in zip(seen['torch'], seen['jax']):
        np.testing.assert_array_equal(a, b)


def test_remat_changes_no_value():
    """``cfg.remat`` checkpoints the layer bodies under grad: the loss and
    every gradient leaf bit for bit those without it, for a dense, an
    MoE, an SSM, a hybrid and the audio stack; without grad (serving) the
    forward checkpoints nothing."""
    for arch in ('qwen3-1.7b', 'llama4-maverick-400b-a17b', 'mamba2-130m',
                 'zamba2-1.2b', 'whisper-medium'):
        jc, tc = _pair(arch, n_layers=4 if arch.startswith('llama4') else 5)
        _, params = _carried(jc, 3)
        _, _, tb = _batch(tc, (2,), 16)
        base = _loss_and_grads(build_model(tc), params, tb)
        remat = _loss_and_grads(
            build_model(dataclasses.replace(tc, remat=True)), params, tb)
        assert torch.equal(base[0], remat[0]), arch
        for a, b in zip(jax.tree.leaves(base[1]), jax.tree.leaves(remat[1])):
            assert torch.equal(a, b), arch
    calls = []
    orig = tfm.checkpoint
    try:
        tfm.checkpoint = lambda *a, **k: calls.append(1) or orig(*a, **k)
        model = build_model(dataclasses.replace(tc, remat=True))
        _loss_and_grads(model, params, tb)
        assert len(calls) == tc.enc_layers + tc.n_layers
        calls.clear()
        with torch.no_grad():
            model.logits(params, tb)
    finally:
        tfm.checkpoint = orig
    assert calls == []


# -- (b)-(d) the custom backward passes and the loss --------------------------

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_rms_norm_backward_matches_reference_vjp(dtype):
    """dx in x's dtype and dscale in scale's (f32), the reference's
    formula: f32 within 1e-6, bf16 within one bf16 rounding."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = (0.1 * rng.normal(size=(64,))).astype(np.float32)
    g = rng.normal(size=(2, 5, 64)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    y, vjp = jax.vjp(j_cm.rms_norm, jnp.asarray(x, jdt), jnp.asarray(scale))
    jdx, jds = vjp(jnp.asarray(g, jdt))

    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    ty = t_cm.rms_norm(tx, ts)
    dx, ds = torch.autograd.grad(ty, (tx, ts), torch.from_numpy(g).to(tdt))
    assert ty.dtype == dx.dtype == tdt and ds.dtype == torch.float32
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == 'float32' else \
        dict(atol=1e-6, rtol=2 ** -7)
    np.testing.assert_allclose(ty.detach().float().numpy(),
                               np.asarray(y, np.float32), **tol)
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(jdx, np.float32),
                               **tol)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), rtol=1e-5,
                               atol=1e-5)


def test_rms_norm_without_grad_is_the_serving_forward():
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(0))
    s = torch.full((8,), 0.5)
    assert torch.equal(t_cm.rms_norm(x, s), t_cm._rms_norm_fwd(x, s, 1e-6))
    assert t_cm.rms_norm(x, s).grad_fn is None


def test_grad_cast_rounds_the_cotangent_to_its_dtype():
    """Identity forward; the cotangent cast to the given dtype, as the
    reference's (which hands the bf16 cotangent on; autograd casts it to
    x's own dtype, so here the cast shows as bf16-rounded values)."""
    x = np.array([1.0, -2.0, 3.0], np.float32)
    g = np.array([1.001, -0.3337, 7.777], np.float32)
    _, vjp = jax.vjp(lambda v: j_cm.grad_cast(v, jnp.bfloat16),
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    assert want.dtype == jnp.bfloat16
    tx = torch.from_numpy(x).requires_grad_()
    y = t_cm.grad_cast(tx, torch.bfloat16)
    assert torch.equal(y, tx)
    (dx,) = torch.autograd.grad(y, tx, torch.from_numpy(g))
    assert dx.dtype == torch.float32
    np.testing.assert_array_equal(dx.numpy(), np.asarray(want, np.float32))
    assert not np.array_equal(dx.numpy(), g)     # rounded, not passed on
    assert t_cm.grad_cast(torch.ones(2), torch.bfloat16).dtype == \
        torch.float32


@pytest.mark.parametrize('masked', [False, True])
def test_cross_entropy_matches_reference(masked):
    """A padded vocabulary (100 of 128 ids) and, with ``masked``, a
    loss_mask: the loss within 1e-6 and d loss / d logits within 1e-7."""
    rng = np.random.default_rng(2)
    logits = (3 * rng.normal(size=(2, 6, 128))).astype(np.float32)
    labels = rng.integers(0, 100, (2, 6)).astype(np.int32)
    mask = (rng.random((2, 6)) < 0.6) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    want, jg = jax.value_and_grad(j_cm.cross_entropy_loss)(
        jnp.asarray(logits), jnp.asarray(labels), 100, jmask)
    tl = torch.from_numpy(logits).requires_grad_()
    got = t_cm.cross_entropy_loss(
        tl, torch.from_numpy(labels), 100,
        None if mask is None else torch.from_numpy(mask))
    (tg,) = torch.autograd.grad(got, tl)
    np.testing.assert_allclose(float(got.detach()), float(want), atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-7)
    assert float(tg[..., 100:].abs().max()) == 0.0

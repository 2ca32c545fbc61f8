"""The port's VLM (internvl2-26b) and audio (whisper-medium) families
against the JAX package on the CPU: the init's tree, the cross-attention
and its projection of the encoder's output, the encoder stack, reduced
models through ``forward_logits`` on both ``attn_impl`` paths (patches or
frames of 0.1 N(0, 1)), whisper's teacher-forced ``Model.prefill`` with
its cross caches filled from the encoder, greedy decode (whisper against
zero cross caches, as ``serve.run`` decodes), the caches, the step
inputs and ``serve.run``, from the reference's params carried across
(f32).

Tolerances: the attention functions and the encoder stack are f32
products in another order (atol 1e-5); a reduced model 1e-4, as
``tests/test_torch_models.py`` holds the dense family; the decode-step
prefill against the bulk forward is the JAX package's own bound
(``tests/test_models.py``: atol 3e-4, rtol 2e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.launch import serve as j_serve
from repro.launch.steps import ServeSetup as JServeSetup
from repro.models import common as j_cm
from repro.models import transformer as j_tfm
from repro.models.model import build_model as j_build_model
from repro_torch import configs as tcfgs
from repro_torch.convert import params_from_jax
from repro_torch.kernels import backend
from repro_torch.launch import serve
from repro_torch.launch.steps import ServeSetup
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model, build_model

CASES = {'internvl2': 'internvl2-26b', 'whisper': 'whisper-medium'}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _meta(tree):
    """(shape, dtype name) of every leaf of a port tree."""
    return jax.tree.map(lambda t: (tuple(t.shape),
                                   str(t.dtype).removeprefix('torch.')), tree)


def _pair(case, impl='flash_jnp', **kw):
    arch = CASES[case]
    return (jcfgs.get_config(arch).reduced(attn_impl=impl, **kw),
            tcfgs.get_config(arch).reduced(attn_impl=impl, **kw))


@pytest.fixture(scope='module')
def carried():
    out = {}
    for i, case in enumerate(CASES):
        jc, _ = _pair(case)
        tree = _np(j_build_model(jc).init(jax.random.PRNGKey(40 + i)))
        out[case] = tree, params_from_jax(tree, device='cpu')
    return out


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _extra(cfg, B, seed=0):
    """The VLM's patch or the audio family's frame embeddings, 0.1 N(0, 1)
    in f32, as the reference's tests draw them."""
    rng = np.random.default_rng(100 + seed)
    if cfg.family == 'vlm':
        return {'patch_embeds': (0.1 * rng.normal(
            size=(B, cfg.n_patches, cfg.d_model))).astype(np.float32)}
    return {'frame_embeds': (0.1 * rng.normal(
        size=(B, cfg.enc_seq, cfg.d_model))).astype(np.float32)}


def _batches(cfg, toks, seed=0):
    batch = {'tokens': toks, **_extra(cfg, toks.shape[0], seed)}
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _fill_cross(params, cache, frames, cfg):
    """``xk``/``xv`` from the encoder's output, layer by layer, as
    ``tests/test_models.py`` fills the reference's."""
    enc = tfm.encode(params, frames, cfg)
    for i in range(cfg.n_layers):
        layer = tfm.layer_slice(params['dec_layers'], i)
        cache['xk'][i], cache['xv'][i] = tfm.project_enc_kv(layer['xattn'],
                                                            enc, cfg)
    return cache


# -- params ------------------------------------------------------------------

@pytest.mark.parametrize('case', list(CASES))
def test_vlm_audio_init_matches_reference_tree(case):
    """Same keys, shapes and dtypes as the reference's init (reduced,
    drawn), and at full size on meta tensors; the projector and the
    encoder's positions drawn, the norms at zero."""
    jc, tc = _pair(case)
    port = build_model(tc).init(torch.Generator().manual_seed(0))
    ref = _np(j_build_model(jc).init(jax.random.PRNGKey(0)))
    assert _meta(port) == jax.tree.map(lambda a: (a.shape, a.dtype.name),
                                       ref)
    arch = CASES[case]
    assert _meta(build_model(tcfgs.get_config(arch)).param_shapes()) == \
        jax.tree.map(lambda a: (a.shape, jnp.dtype(a.dtype).name),
                     j_build_model(jcfgs.get_config(arch)).param_shapes())
    # a normal cut at +-2 sigma has a standard deviation of 0.8796 sigma
    if case == 'internvl2':
        w = port['patch_proj']                            # [256, 256]
        assert abs(w.std().item() / (0.8796 * tc.d_model ** -0.5) - 1) < 0.05
    else:
        assert abs(port['enc_pos'].std().item() / 0.8796 - 1) < 0.05
        assert torch.count_nonzero(port['enc_ln_f']) == 0
        assert torch.count_nonzero(port['dec_layers']['ln_x']) == 0
        assert not torch.equal(port['dec_layers']['xattn']['wq'][0],
                               port['dec_layers']['attn']['wq'][0])


# -- the encoder-decoder's primitives ------------------------------------------

@pytest.mark.parametrize('qk_norm', [False, True])
def test_cross_attn_block_and_project_enc_kv_match_reference(qk_norm):
    """A decoder layer's ``xattn`` params (with ``q_norm``/``k_norm``
    made non-zero where ``qk_norm``): the projected (k, v) of a [2, 8, D]
    encoder output and the cross-attention of 13 queries (not a multiple
    of the 16-row block) over it."""
    jc, tc = _pair('whisper', qk_norm=qk_norm)
    tree = _np(j_build_model(jc).init(jax.random.PRNGKey(5)))
    rng = np.random.default_rng(3)
    xattn = jax.tree.map(lambda a: a[0], tree['dec_layers']['xattn'])
    for key in ('q_norm', 'k_norm'):
        if key in xattn:
            xattn[key] = (0.3 * rng.normal(size=xattn[key].shape)).astype(
                np.float32)
    p = params_from_jax(xattn, device='cpu')
    enc = rng.normal(size=(2, tc.enc_seq, tc.d_model)).astype(np.float32)
    x = rng.normal(size=(2, 13, tc.d_model)).astype(np.float32)
    jkv = j_tfm.project_enc_kv(xattn, jnp.asarray(enc), jc)
    kv = tfm.project_enc_kv(p, torch.from_numpy(enc), tc)
    for got, want in zip(kv, jkv):
        assert got.shape == (2, tc.enc_seq, tc.n_kv_heads, tc.head_dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    want = j_tfm.cross_attn_block(xattn, jnp.asarray(x), jkv, jc)
    got = tfm.cross_attn_block(p, torch.from_numpy(x), kv, tc)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_audio_encoder_stack_matches_reference(carried):
    """``run_dense_stack(..., causal=False)`` over the frames plus
    ``enc_pos``, then ``enc_ln_f`` (``encode``): no rope, no causal mask,
    the plain attention on both ``attn_impl``s."""
    tree, params = carried['whisper']
    for impl in ('flash_jnp', 'pallas'):
        jc, tc = _pair('whisper', impl)
        frames = _extra(tc, 2)['frame_embeds']
        x = frames + tree['enc_pos'][None]
        want, _ = j_tfm.run_dense_stack(tree['enc_layers'], jnp.asarray(x),
                                        jc, causal=False)
        backend.reset_launches()
        got, lb = tfm.run_dense_stack(params['enc_layers'],
                                      torch.from_numpy(x), tc, causal=False)
        assert backend.LAUNCHES['swa_attention'] == 0
        assert float(lb) == 0.0
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
        want = j_cm.rms_norm(want, tree['enc_ln_f'])
        got = tfm.encode(params, torch.from_numpy(frames), tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# -- the models ----------------------------------------------------------------

@pytest.mark.parametrize('impl', ['flash_jnp', 'pallas'])
@pytest.mark.parametrize('case', list(CASES))
def test_vlm_audio_forward_logits_match_reference(carried, case, impl):
    """Reduced internvl2-26b (4 patches prepended, logits of the text
    positions only) and whisper-medium (8 frames through the encoder):
    40 tokens, not a multiple of the 16-row block."""
    jc, tc = _pair(case, impl)
    tree, params = carried[case]
    jb, tb = _batches(tc, _tokens(jc, 2, 40))
    want, jaux = j_build_model(jc).logits(tree, jb)
    backend.reset_launches()
    got, aux = build_model(tc).logits(params, tb)
    assert backend.LAUNCHES['swa_attention'] == 0   # the CPU: plain only
    assert got.shape == (2, 40, tc.padded_vocab)
    assert set(aux) == set(jaux)
    for key in aux:
        np.testing.assert_allclose(aux[key].numpy(), np.asarray(jaux[key]),
                                   atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_whisper_teacher_forced_prefill_equals_forward_logits(carried):
    """With ``xk``/``xv`` filled from the encoder, token-by-token decode
    reproduces the bulk forward's logits (the reference's own test and
    bound)."""
    _, tc = _pair('whisper')
    _, params = carried['whisper']
    model = build_model(tc)
    S = 21
    _, batch = _batches(tc, _tokens(tc, 2, S, seed=S))
    full, _ = model.logits(params, batch)
    cache = _fill_cross(params, model.init_cache(2, S, device='cpu'),
                        batch['frame_embeds'], tc)
    cache, step = model.prefill(params, cache, batch['tokens'])
    assert cache['length'] == S
    np.testing.assert_allclose(step.numpy(), full.numpy(), atol=3e-4,
                               rtol=2e-3)


@pytest.mark.parametrize('case', list(CASES))
def test_vlm_audio_prefill_cache_matches_reference(carried, case):
    """The caches after a 9-token prefill (whisper's cross caches filled
    from the encoder on both sides) equal the reference's, and so do the
    logits."""
    jc, tc = _pair(case)
    tree, params = carried[case]
    toks = _tokens(jc, 2, 9, seed=4)
    jm, model = j_build_model(jc), build_model(tc)
    jcache, cache = jm.init_cache(2, 9), model.init_cache(2, 9, device='cpu')
    if case == 'whisper':
        frames = _extra(tc, 2, seed=4)['frame_embeds']
        cache = _fill_cross(params, cache, torch.from_numpy(frames), tc)
        jcache = dict(jcache, xk=jnp.asarray(cache['xk'].numpy()),
                      xv=jnp.asarray(cache['xv'].numpy()))
    jcache, jlog = jm.prefill(tree, jcache, jnp.asarray(toks))
    cache, log = model.prefill(params, cache, torch.from_numpy(toks))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-4)
    assert set(cache) == set(jcache)
    for key in set(cache) - {'length'}:
        assert cache[key].dtype == getattr(torch, jcache[key].dtype.name)
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-5)
    assert cache['length'] == int(jcache['length'])


@pytest.mark.parametrize('case', list(CASES))
def test_vlm_audio_greedy_decode_matches_reference(carried, case):
    """A 12-token prompt, then 8 greedy tokens through ``serve_step``,
    against the reference's jitted ``ServeSetup.serve_step``; whisper
    with zero cross caches, as ``serve.run`` decodes it."""
    jc, tc = _pair(case)
    tree, params = carried[case]
    B, P, G = 2, 12, 8
    prompts = _tokens(jc, B, P, seed=P)
    jm = j_build_model(jc)
    jstep = jax.jit(JServeSetup(jm).serve_step)
    jcache, jlog = jm.prefill(tree, jm.init_cache(B, P + G),
                              jnp.asarray(prompts))
    tok = jnp.argmax(jlog[:, -1], axis=-1)
    want = [np.asarray(tok)]
    for _ in range(G - 1):
        jcache, tok = jstep(tree, jcache, tok[:, None])
        want.append(np.asarray(tok))

    model = build_model(tc)
    setup = ServeSetup(model)
    cache, log = model.prefill(params, model.init_cache(B, P + G,
                                                        device='cpu'),
                               torch.from_numpy(prompts))
    tok = log[:, -1].argmax(-1)
    got = [tok.numpy()]
    for _ in range(G - 1):
        cache, tok = setup.serve_step(params, cache, tok[:, None])
        got.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(got, 1), np.stack(want, 1))
    if case == 'whisper':
        assert torch.count_nonzero(cache['xk']) == 0


@pytest.mark.parametrize('case', list(CASES))
def test_vlm_audio_init_cache_matches_reference(case):
    """``init_cache`` keys, shapes, dtypes and values at reduced size
    (length 3 of 10), and ``decode_batch``'s at full size on meta tensors
    (whisper's ``xk``/``xv`` [24, 8, 1500, 16, 64])."""
    jc, tc = _pair(case)
    jcache = j_build_model(jc).init_cache(2, 10, length=3)
    cache = build_model(tc).init_cache(2, 10, length=3, device='cpu')
    assert set(cache) == set(jcache)
    assert cache['length'] == int(jcache['length'])
    for key in set(cache) - {'length'}:
        assert cache[key].dtype == getattr(torch, jcache[key].dtype.name)
        np.testing.assert_array_equal(cache[key].numpy(),
                                      np.asarray(jcache[key]))
    arch = CASES[case]
    (tc_, _), (jc_, _) = (
        ServeSetup(build_model(tcfgs.get_config(arch))).decode_batch(
            tcfgs.INPUT_SHAPES['decode_32k']),
        JServeSetup(j_build_model(jcfgs.get_config(arch))).decode_batch(
            jcfgs.INPUT_SHAPES['decode_32k']))
    assert set(tc_) == set(jc_)
    for key in set(tc_) - {'length'}:
        assert tc_[key].device.type == 'meta'
        assert tuple(tc_[key].shape) == jc_[key].shape, key
        assert str(tc_[key].dtype).removeprefix('torch.') == \
            jnp.dtype(jc_[key].dtype).name, key


@pytest.mark.parametrize('shape', ['prefill_32k', 'decode_32k'])
@pytest.mark.parametrize('case', list(CASES))
def test_vlm_audio_prefill_batch_matches_reference(case, shape):
    """``prefill_batch`` at full width: tokens plus ``patch_embeds``
    [B, 256, 6144] or ``frame_embeds`` [B, 1500, 1024] in f32, the
    reference's shapes and dtypes, as meta tensors."""
    arch = CASES[case]
    jb = JServeSetup(j_build_model(jcfgs.get_config(arch))).prefill_batch(
        jcfgs.INPUT_SHAPES[shape])
    tb = ServeSetup(build_model(tcfgs.get_config(arch))).prefill_batch(
        tcfgs.INPUT_SHAPES[shape])
    assert set(tb) == set(jb)
    for key, t in tb.items():
        assert t.device.type == 'meta'
        assert (tuple(t.shape), str(t.dtype).removeprefix('torch.')) == \
            (jb[key].shape, jnp.dtype(jb[key].dtype).name), key


@pytest.mark.parametrize('case', list(CASES))
def test_vlm_audio_serve_run_matches_reference_cli(case, capsys,
                                                   monkeypatch):
    """``serve.run(..., device='cpu')`` of the reduced model, started from
    the reference CLI's params and prompts (``PRNGKey(seed)``), gives the
    reference ``serve.run``'s tokens: a text-only decode for the VLM, a
    decode against zero cross caches for whisper."""
    arch, B, P, G, seed = CASES[case], 2, 6, 5, 2
    want = np.asarray(j_serve.run(arch, batch=B, prompt_len=P, gen=G,
                                  seed=seed))
    jc, _ = _pair(case)
    key = jax.random.PRNGKey(seed)
    tree = _np(j_build_model(jc).init(key))
    prompts = np.array(jax.random.randint(key, (B, P), 0, jc.vocab_size))
    monkeypatch.setattr(Model, 'init', lambda self, seed=0, device='cuda':
                        params_from_jax(tree, device='cpu'))
    draw = torch.randint

    def randint(*a, **kw):   # serve.run's prompts: the reference CLI's
        if a[2:3] == ((B, P),):
            return torch.from_numpy(prompts).long()
        return draw(*a, **kw)
    monkeypatch.setattr(torch, 'randint', randint)
    capsys.readouterr()
    toks = serve.run(arch, batch=B, prompt_len=P, gen=G, seed=seed,
                     device='cpu')
    out = capsys.readouterr().out
    assert f'prefill: {B}x{P} tokens' in out and f'decode:  {B}x{G}' in out
    assert toks.shape == (B, G)
    np.testing.assert_array_equal(toks.numpy(), want)


@pytest.mark.parametrize('case', list(CASES))
def test_vlm_audio_serve_run_on_the_cpu(case, capsys):
    """``serve.run`` from its own seeded params and prompts: the greedy
    decode of ``serve_step`` on them."""
    arch, B, P, G = CASES[case], 2, 5, 4
    toks = serve.run(arch, batch=B, prompt_len=P, gen=G, seed=3,
                     device='cpu')
    assert 'decode:  2x4 tokens' in capsys.readouterr().out
    cfg = tcfgs.get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(3))
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(3))
    cache, log = model.prefill(params, model.init_cache(B, P + G,
                                                        device='cpu'),
                               prompts)
    tok = log[:, -1].argmax(-1)
    want = [tok]
    for _ in range(G - 1):
        cache, tok = ServeSetup(model).serve_step(params, cache,
                                                  tok[:, None])
        want.append(tok)
    assert torch.equal(toks, torch.stack(want, 1))


def test_unknown_family_is_refused():
    cfg = dataclasses.replace(tcfgs.get_config('whisper-medium').reduced(),
                              family='diffusion')
    with pytest.raises(ValueError, match='diffusion'):
        build_model(cfg)
    with pytest.raises(ValueError, match='diffusion'):
        tfm.init_params(None, cfg)

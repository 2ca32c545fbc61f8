"""The port's SSM (mamba2) and hybrid (zamba2) families against the JAX
package on the CPU: ``segsum``, the chunked SSD scan (with padding and an
initial state) against the reference and against the sequential oracle
``ssd_ref``, ``ssd_step``, the Mamba2 block and its decode step, the
init's tree and draws, and reduced mamba2-130m and zamba2-1.2b
(``n_layers=5``: groups (0, 2), (2, 4), (4, 5), so the shared attention
block runs twice and the last group is short) through ``forward_logits``,
the teacher-forced ``Model.prefill``, greedy decode and ``serve``, from
the reference's params carried across (f32).

Tolerances: the scan and the block are f32 products in another order
(atol 1e-5); a reduced model 1e-4, as ``tests/test_torch_models.py``
holds the dense family; the decode-step prefill against the bulk forward
is the JAX package's own bound (``tests/test_models.py``: atol 3e-4,
rtol 2e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.launch.steps import ServeSetup as JServeSetup
from repro.models import common as j_cm
from repro.models import ssm as j_ssm
from repro.models.model import build_model as j_build_model
from repro_torch import configs as tcfgs
from repro_torch.convert import params_from_jax
from repro_torch.kernels import backend
from repro_torch.launch import serve
from repro_torch.launch.steps import ServeSetup
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.model import build_model

CASES = {'mamba2': ('mamba2-130m', {}),
         'zamba2': ('zamba2-1.2b', dict(n_layers=5))}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ssd_inputs(b, s, h, p, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)) - 2.0)).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, 2.0, size=(h,))).astype(np.float32)
    B = rng.normal(size=(b, s, n)).astype(np.float32)
    C = rng.normal(size=(b, s, n)).astype(np.float32)
    s0 = rng.normal(size=(b, h, p, n)).astype(np.float32)
    return x, dt, A, B, C, s0


def test_segsum_matches_reference():
    x = np.random.default_rng(0).normal(size=(2, 3, 7)).astype(np.float32)
    np.testing.assert_allclose(t_ssm.segsum(torch.from_numpy(x)).numpy(),
                               np.asarray(j_ssm.segsum(jnp.asarray(x))),
                               atol=1e-6)


#: (b, s, h, p, n, chunk): whole chunks, a padded last chunk, one short
#: chunk, a single token
SSD_SHAPES = [(2, 32, 3, 4, 5, 8), (2, 37, 3, 4, 5, 8), (1, 5, 2, 8, 4, 16),
              (1, 1, 2, 4, 3, 4)]


@pytest.mark.parametrize('init', [False, True])
@pytest.mark.parametrize('b,s,h,p,n,chunk', SSD_SHAPES)
def test_ssd_chunked_matches_reference_and_oracle(b, s, h, p, n, chunk,
                                                  init):
    x, dt, A, B, C, s0 = _ssd_inputs(b, s, h, p, n, seed=s)
    s0 = s0 if init else None
    j = [jnp.asarray(a) if a is not None else None
         for a in (x, dt, A, B, C, s0)]
    t = [torch.from_numpy(a) if a is not None else None
         for a in (x, dt, A, B, C, s0)]
    want_y, want_s = j_ssm.ssd_chunked(*j[:5], chunk=chunk,
                                       initial_state=j[5])
    y, st = t_ssm.ssd_chunked(*t[:5], chunk=chunk, initial_state=t[5])
    assert y.shape == x.shape and st.shape == (b, h, p, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(want_s), atol=1e-5)
    ref_y, ref_s = t_ssm.ssd_ref(*t[:5], initial_state=t[5])
    np.testing.assert_allclose(y.numpy(), ref_y.numpy(), atol=1e-5)
    np.testing.assert_allclose(st.numpy(), ref_s.numpy(), atol=1e-5)
    jref_y, jref_s = j_ssm.ssd_ref(*j[:5], initial_state=j[5])
    np.testing.assert_allclose(ref_y.numpy(), np.asarray(jref_y), atol=1e-5)
    np.testing.assert_allclose(ref_s.numpy(), np.asarray(jref_s), atol=1e-5)


def test_ssd_chunked_keeps_the_input_dtype():
    x, dt, A, B, C, _ = _ssd_inputs(1, 20, 2, 4, 3)
    y, st = t_ssm.ssd_chunked(torch.from_numpy(x).bfloat16(),
                              *map(torch.from_numpy, (dt, A, B, C)), chunk=8)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32


def test_ssd_step_matches_reference():
    x, dt, A, B, C, s0 = _ssd_inputs(3, 1, 4, 8, 6, seed=9)
    args = (s0, x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0])
    want_s, want_y = j_ssm.ssd_step(*map(jnp.asarray, args))
    st, y = t_ssm.ssd_step(*map(torch.from_numpy, args))
    np.testing.assert_allclose(st.numpy(), np.asarray(want_s), atol=1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-5)


# -- the Mamba2 block ----------------------------------------------------------

D_MODEL, D_STATE, HEADDIM = 32, 8, 16


def _block(seed=0):
    tree = _np(j_cm.unbox(j_ssm.init_mamba_block(
        jax.random.PRNGKey(seed), D_MODEL, D_STATE, HEADDIM,
        jnp.float32))[0])
    # zero-init leaves made non-trivial, so that the test sees them
    rng = np.random.default_rng(seed)
    tree['conv_b'] = rng.normal(size=tree['conv_b'].shape).astype(np.float32)
    tree['norm_scale'] = (0.1 * rng.normal(size=tree['norm_scale'].shape)
                          ).astype(np.float32)
    tree['D'] = rng.uniform(0.5, 1.5, tree['D'].shape).astype(np.float32)
    return tree, params_from_jax(tree, device='cpu')


@pytest.mark.parametrize('s,chunk', [(24, 8), (19, 8), (3, 16)])
def test_apply_mamba_block_matches_reference(s, chunk):
    tree, p = _block()
    x = np.random.default_rng(s).normal(size=(2, s, D_MODEL)).astype(
        np.float32)
    want = j_ssm.apply_mamba_block(tree, jnp.asarray(x), d_state=D_STATE,
                                   headdim=HEADDIM, chunk=chunk)
    got = t_ssm.apply_mamba_block(p, torch.from_numpy(x), d_state=D_STATE,
                                  headdim=HEADDIM, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_step_mamba_block_matches_reference_and_the_bulk_block():
    """One decode step from a non-zero cache against the reference's; and
    steps from a zero cache over a sequence equal the bulk block."""
    tree, p = _block(seed=1)
    rng = np.random.default_rng(4)
    jcache = _np(j_ssm.init_mamba_cache(2, D_MODEL, D_STATE, HEADDIM,
                                        jnp.float32))
    jcache = {k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in jcache.items()}
    x = rng.normal(size=(2, 1, D_MODEL)).astype(np.float32)
    want_c, want_y = j_ssm.step_mamba_block(
        tree, {k: jnp.asarray(v) for k, v in jcache.items()},
        jnp.asarray(x), d_state=D_STATE, headdim=HEADDIM)
    cache = {k: torch.from_numpy(v) for k, v in jcache.items()}
    got_c, got_y = t_ssm.step_mamba_block(p, cache, torch.from_numpy(x),
                                          d_state=D_STATE, headdim=HEADDIM)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-5)
    for key in ('conv', 'ssm'):
        np.testing.assert_allclose(got_c[key].numpy(),
                                   np.asarray(want_c[key]), atol=1e-5)
    assert torch.equal(cache['conv'], torch.from_numpy(jcache['conv']))

    seq = torch.from_numpy(rng.normal(size=(2, 11, D_MODEL)).astype(
        np.float32))
    cache = t_ssm.init_mamba_cache(2, D_MODEL, D_STATE, HEADDIM,
                                   torch.float32)
    steps = []
    for t in range(11):
        cache, y = t_ssm.step_mamba_block(p, cache, seq[:, t:t + 1],
                                          d_state=D_STATE, headdim=HEADDIM)
        steps.append(y)
    bulk = t_ssm.apply_mamba_block(p, seq, d_state=D_STATE, headdim=HEADDIM,
                                   chunk=4)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), bulk.numpy(),
                               atol=1e-5)


def test_mamba_init_matches_reference_tree_and_draws():
    """Same keys, shapes and dtypes as the reference; ``conv_w`` normal x
    0.1, not truncated; ``A_log`` = log U(1, 16); ``dt_bias`` the softplus
    inverse of U(1e-3, 0.1); ``D`` ones; ``norm_scale``, ``conv_b``
    zeros; layers drawn apart."""
    cfg = tcfgs.get_config('mamba2-130m').reduced(n_layers=3)
    port = build_model(cfg).init(torch.Generator().manual_seed(0))
    ref = _np(j_build_model(jcfgs.get_config('mamba2-130m').reduced(
        n_layers=3)).init(jax.random.PRNGKey(0)))
    assert jax.tree.map(lambda t: (tuple(t.shape),
                                   str(t.dtype).removeprefix('torch.')),
                        port) == jax.tree.map(lambda a: (a.shape,
                                                         a.dtype.name), ref)
    m = port['layers']['mamba']
    cw = m['conv_w']                              # [3, 4, 544]
    assert abs(cw.std().item() - 0.1) < 0.005 and cw.abs().max() > 0.3
    a = m['A_log'].exp()
    assert a.min() >= 1.0 and a.max() <= 16.0 and a.std() > 2.0
    dt = torch.nn.functional.softplus(m['dt_bias'])
    assert dt.min() >= 1e-3 - 1e-7 and dt.max() <= 0.1 + 1e-7
    assert torch.equal(m['D'], torch.ones_like(m['D']))
    assert torch.count_nonzero(m['norm_scale']) == 0
    assert torch.count_nonzero(m['conv_b']) == 0
    assert not torch.equal(m['in_proj'][0], m['in_proj'][1])


# -- the model -----------------------------------------------------------------

def _pair(case, impl='flash_jnp'):
    arch, kw = CASES[case]
    return (jcfgs.get_config(arch).reduced(attn_impl=impl, **kw),
            tcfgs.get_config(arch).reduced(attn_impl=impl, **kw))


@pytest.fixture(scope='module')
def carried():
    out = {}
    for i, case in enumerate(CASES):
        jc, _ = _pair(case)
        tree = _np(j_build_model(jc).init(jax.random.PRNGKey(30 + i)))
        out[case] = tree, params_from_jax(tree, device='cpu')
    return out


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_zamba2_groups_and_shared_block():
    """Reduced zamba2 at ``n_layers=5``: three groups, the shared block
    between them twice, one KV slice per application."""
    _, tc = _pair('zamba2')
    assert tfm.hybrid_groups(tc) == [(0, 2), (2, 4), (4, 5)]
    cache = build_model(tc).init_cache(2, 16, device='meta')
    assert cache['k'].shape == (2, 2, 16, tc.n_kv_heads, tc.head_dim)
    assert cache['conv'].shape[0] == cache['ssm'].shape[0] == 5
    assert cache['conv'].dtype == tc.dtype
    assert cache['ssm'].dtype == torch.float32


@pytest.mark.parametrize('case,impl', [('mamba2', 'flash_jnp'),
                                       ('zamba2', 'flash_jnp'),
                                       ('zamba2', 'pallas')])
def test_ssm_forward_logits_match_reference(carried, case, impl):
    jc, tc = _pair(case, impl)
    tree, params = carried[case]
    toks = _tokens(jc, 2, 40)                      # 40 % ssm_chunk 16 != 0
    want, jaux = j_build_model(jc).logits(tree, {'tokens': jnp.asarray(toks)})
    backend.reset_launches()
    got, aux = build_model(tc).logits(params,
                                      {'tokens': torch.from_numpy(toks)})
    assert backend.LAUNCHES['swa_attention'] == 0   # the CPU: plain only
    assert got.shape == (2, 40, tc.padded_vocab)
    assert aux == {} == jaux
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize('case', list(CASES))
def test_ssm_teacher_forced_prefill_equals_forward_logits(carried, case):
    _, tc = _pair(case)
    _, params = carried[case]
    model = build_model(tc)
    S = 21
    toks = torch.from_numpy(_tokens(tc, 2, S, seed=S))
    full, _ = model.logits(params, {'tokens': toks})
    cache, step = model.prefill(params, model.init_cache(2, S, device='cpu'),
                                toks)
    assert cache['length'] == S
    np.testing.assert_allclose(step.numpy(), full.numpy(), atol=3e-4,
                               rtol=2e-3)


@pytest.mark.parametrize('case', list(CASES))
def test_ssm_prefill_cache_matches_reference(carried, case):
    """The conv and SSM caches (and the hybrid's KV slices) after a
    prefill equal the reference's, and so do the logits."""
    jc, tc = _pair(case)
    tree, params = carried[case]
    toks = _tokens(jc, 2, 9, seed=4)
    jm = j_build_model(jc)
    jcache, jlog = jm.prefill(tree, jm.init_cache(2, 9), jnp.asarray(toks))
    model = build_model(tc)
    cache, log = model.prefill(params, model.init_cache(2, 9, device='cpu'),
                               torch.from_numpy(toks))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-4)
    assert set(cache) == set(jcache)
    for key in set(cache) - {'length', 'positions'}:
        assert cache[key].dtype == getattr(torch, jcache[key].dtype.name)
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-5)
    assert cache['length'] == int(jcache['length'])


@pytest.mark.parametrize('case', list(CASES))
def test_ssm_greedy_decode_matches_reference(carried, case):
    """A 12-token prompt, then 8 greedy tokens through ``serve_step``,
    against the reference's jitted ``ServeSetup.serve_step``."""
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


@pytest.mark.parametrize('arch', ['mamba2-130m', 'zamba2-1.2b'])
def test_ssm_n_params_and_cache_shapes_match_reference(arch):
    """At full size, on meta tensors: the parameter count, every leaf's
    shape and dtype, and the decode cache of ``decode_32k``."""
    jm, tm = (j_build_model(jcfgs.get_config(arch)),
              build_model(tcfgs.get_config(arch)))
    assert tm.n_params() == jm.n_params()
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)
                                   .removeprefix('torch.')),
                        tm.param_shapes()) == \
        jax.tree.map(lambda a: (a.shape, jnp.dtype(a.dtype).name),
                     jm.param_shapes())
    (tc, _), (jc, _) = (ServeSetup(tm).decode_batch(
        tcfgs.INPUT_SHAPES['decode_32k']), JServeSetup(jm).decode_batch(
            jcfgs.INPUT_SHAPES['decode_32k']))
    assert set(tc) == set(jc)
    for key in set(tc) - {'length'}:
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert str(tc[key].dtype).removeprefix('torch.') == \
            jnp.dtype(jc[key].dtype).name, key


def test_serve_main_default_is_mamba2(capsys):
    """``python -m repro_torch.launch.serve --device cpu`` serves the JAX
    CLI's default, mamba2-130m (reduced), at its defaults (4 x 32 prompt
    tokens, 16 generated), and its tokens are the greedy decode of
    ``serve_step`` on the params and prompts its seed names."""
    serve.main(['--device', 'cpu'])
    out = capsys.readouterr().out
    assert 'prefill: 4x32 tokens' in out and 'decode:  4x16 tokens' in out
    toks = serve.run('mamba2-130m', batch=2, prompt_len=6, gen=4,
                     device='cpu')
    cfg = tcfgs.get_config('mamba2-130m').reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (2, 6),
                            generator=torch.Generator().manual_seed(0))
    cache, log = model.prefill(params, model.init_cache(2, 10, device='cpu'),
                               prompts)
    tok = log[:, -1].argmax(-1)
    want = [tok]
    for _ in range(3):
        cache, tok = ServeSetup(model).serve_step(params, cache,
                                                  tok[:, None])
        want.append(tok)
    assert torch.equal(toks, torch.stack(want, 1))


def test_serve_run_zamba2_on_the_cpu(capsys):
    toks = serve.run('zamba2-1.2b', batch=2, prompt_len=5, gen=3,
                     device='cpu')
    assert toks.shape == (2, 3)
    assert 'decode:  2x3 tokens' in capsys.readouterr().out

"""The port's MoE family against the JAX package on the CPU: ``apply_moe``
(top-1 routing with a capacity, drops, pad tokens, the shared expert and
the router's stats), the init's tree and fan-in, and reduced
llama4-scout and llama4-maverick (two super-blocks) through
``forward_logits`` on both ``attn_impl``s, the teacher-forced
``Model.prefill`` and greedy decode, from the reference's params carried
across (f32).

Routes are compared exactly: each MoE call's top-1 expert per token,
read by a wrapper around ``apply_moe`` on each side (the JAX side runs
with ``jax.disable_jit`` so that its layer scan hands the wrapper
values).  Tolerances: ``apply_moe`` is one layer of f32 products in
another order (atol 1e-5, its stats 1e-6); a reduced model 1e-4, as
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
from repro.launch.steps import ServeSetup as JServeSetup
from repro.models import common as j_cm
from repro.models import moe as j_moe
from repro.models.model import build_model as j_build_model
from repro_torch import configs as tcfgs
from repro_torch.convert import params_from_jax
from repro_torch.kernels import backend
from repro_torch.launch.steps import ServeSetup
from repro_torch.models import moe as t_moe
from repro_torch.models.model import build_model

#: reduced configurations: scout (4 experts, 2 layers), maverick with two
#: super-blocks of a dense and an MoE layer
CASES = {'scout': ('llama4-scout-17b-a16e', {}),
         'maverick': ('llama4-maverick-400b-a17b', dict(n_layers=4))}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# -- apply_moe -----------------------------------------------------------------

def _moe_case(E=4, M=32, F=48, shared=True, seed=0):
    p = _np(j_cm.unbox(j_moe.init_moe(jax.random.PRNGKey(seed), M, F, E,
                                      jnp.float32, shared))[0])
    return p, params_from_jax(p, device='cpu')


def _j_routes(p, x):
    logits = x.reshape(-1, x.shape[-1]).astype(jnp.float32) @ p['router']
    return np.asarray(jnp.argmax(jax.nn.softmax(logits, axis=-1), axis=-1))


#: (tokens B x S, group size, capacity factor): N = 26 in groups of 8
#: (padded to 32 with zero tokens) and in one group of 26, with drops
#: (1.25: capacity 2 a group of 8) and without (capacity = E)
MOE_CASES = {'pad-drops': (2, 13, 8, 1.25), 'pad-no-drops': (2, 13, 8, 4.0),
             'one-group-drops': (2, 13, None, 1.25),
             'one-group-no-drops': (2, 13, None, 4.0),
             'decode-b4': (4, 1, None, 4.0)}


@pytest.mark.parametrize('shared', [True, False])
@pytest.mark.parametrize('case', sorted(MOE_CASES))
def test_apply_moe_matches_reference(case, shared):
    B, S, group, cap = MOE_CASES[case]
    tree, p = _moe_case(shared=shared)
    x = np.random.default_rng(1).normal(size=(B, S, 32)).astype(np.float32)
    # a zero token: uniform probabilities, routed to expert 0 (the first max)
    x[0, 0] = 0.0
    want, jaux = j_moe.apply_moe(tree, jnp.asarray(x), capacity_factor=cap,
                                 group_size=group)
    got, aux = t_moe.apply_moe(p, torch.from_numpy(x), capacity_factor=cap,
                               group_size=group)
    routes = t_moe.route(p, torch.from_numpy(x).reshape(-1, 32))[0]
    np.testing.assert_array_equal(routes.numpy(), _j_routes(tree, x))
    assert int(routes[0]) == 0
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    for key in ('load_balance_loss', 'dropped_frac'):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   atol=1e-6)
    assert (float(aux['dropped_frac']) > 0) == (cap < 4), aux


def test_apply_moe_drops_pass_only_the_residual_and_pads_queue_last():
    """Capacity 1 a group: of the tokens routed to one expert only the
    first in token order is kept; a dropped token's routed output is 0
    (the shared expert still runs).  Pad tokens are routed to expert 0
    behind every real token and count in the stats, but ``dropped_frac``
    divides by the unpadded N."""
    tree, p = _moe_case(shared=False, seed=3)
    x = np.random.default_rng(2).normal(size=(1, 6, 32)).astype(np.float32)
    tx = torch.from_numpy(x)
    y, aux = t_moe.apply_moe(p, tx, capacity_factor=0.5, group_size=8)
    routes = t_moe.route(p, tx.reshape(6, 32))[0].tolist()
    kept = [routes.index(e) for e in sorted(set(routes))]
    for t in range(6):
        assert (y[0, t].abs().max() > 0) == (t in kept), (t, routes)
    # 8 slots a group at capacity 1: the 2 pad tokens go to expert 0,
    # kept only if no real token took expert 0
    n_kept = len(kept) + (0 not in routes)
    np.testing.assert_allclose(float(aux['dropped_frac']), 1 - n_kept / 6,
                               atol=1e-6)
    _, jaux = j_moe.apply_moe(tree, jnp.asarray(x), capacity_factor=0.5,
                              group_size=8)
    np.testing.assert_allclose(float(aux['dropped_frac']),
                               float(jaux['dropped_frac']), atol=1e-6)


def test_apply_moe_bf16_keeps_the_model_dtype():
    tree, p = _moe_case()
    pb = {k: (v.bfloat16() if k.startswith('w_') else v)
          for k, v in p.items() if k != 'shared'}
    x = torch.randn((2, 5, 32), generator=torch.Generator().manual_seed(0))
    y, aux = t_moe.apply_moe(pb, x.bfloat16())
    assert y.dtype == torch.bfloat16
    assert aux['load_balance_loss'].dtype == torch.float32


def test_moe_init_matches_reference_tree_and_fan_in():
    """Same keys, shapes and dtypes as the reference's init; the router in
    f32; an expert stack ``[E, in, out]`` drawn at stddev E^-0.5 (the
    reference's fan-in is the stack's first axis), cut at 2 sigma."""
    E, M, F = 16, 64, 96
    ref = _np(j_cm.unbox(j_moe.init_moe(jax.random.PRNGKey(0), M, F, E,
                                        jnp.float32))[0])
    port = t_moe.init_moe(torch.Generator().manual_seed(0), M, F, E,
                          torch.float32)
    assert jax.tree.map(lambda a: (a.shape, a.dtype.name), ref) == \
        jax.tree.map(lambda t: (tuple(t.shape),
                                str(t.dtype).removeprefix('torch.')), port)
    sigma = E ** -0.5
    for key in ('w_gate', 'w_up', 'w_down'):
        w = port[key]
        assert w.abs().max() <= 2 * sigma
        assert abs(w.std().item() / sigma - 0.8796) < 0.01, key
        assert abs(np.asarray(ref[key]).std() / sigma - 0.8796) < 0.01, key


# -- the model -----------------------------------------------------------------

def _pair(case, impl='flash_jnp', **over):
    arch, kw = CASES[case]
    return (jcfgs.get_config(arch).reduced(attn_impl=impl, **kw, **over),
            tcfgs.get_config(arch).reduced(attn_impl=impl, **kw, **over))


@pytest.fixture(scope='module')
def carried():
    out = {}
    for i, case in enumerate(CASES):
        jc, _ = _pair(case)
        tree = _np(j_build_model(jc).init(jax.random.PRNGKey(20 + i)))
        out[case] = tree, params_from_jax(tree, device='cpu')
    return out


@pytest.fixture
def routes(monkeypatch):
    """Record each ``apply_moe`` call's top-1 expert per token, on both
    sides: {'jax': [...], 'torch': [...]}."""
    seen = {'jax': [], 'torch': []}
    j_apply, t_apply = j_moe.apply_moe, t_moe.apply_moe

    def j_wrap(p, x, **kw):
        seen['jax'].append(_j_routes(p, np.asarray(x)))
        return j_apply(p, x, **kw)

    def t_wrap(p, x, **kw):
        seen['torch'].append(t_moe.route(p, x.reshape(-1, x.shape[-1]))[0]
                             .numpy())
        return t_apply(p, x, **kw)
    monkeypatch.setattr(j_moe, 'apply_moe', j_wrap)
    monkeypatch.setattr(t_moe, 'apply_moe', t_wrap)
    return seen


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize('impl', ['flash_jnp', 'pallas'])
@pytest.mark.parametrize('case', list(CASES))
def test_moe_forward_logits_match_reference(carried, routes, case, impl):
    """Logits within 1e-4, every MoE layer's routes equal, and the summed
    load-balance loss within 1e-5 (one per MoE layer: 2 for each)."""
    jc, tc = _pair(case, impl)
    tree, params = carried[case]
    toks = _tokens(jc, 2, 24)
    with jax.disable_jit():
        want, jaux = j_build_model(jc).logits(tree,
                                              {'tokens': jnp.asarray(toks)})
    backend.reset_launches()
    got, aux = build_model(tc).logits(params,
                                      {'tokens': torch.from_numpy(toks)})
    assert backend.LAUNCHES['swa_attention'] == 0   # the CPU: plain only
    assert got.shape == (2, 24, tc.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(float(aux['load_balance_loss']),
                               float(jaux['load_balance_loss']), atol=1e-5)
    assert len(routes['torch']) == len(routes['jax']) == 2
    for a, b in zip(routes['torch'], routes['jax']):
        np.testing.assert_array_equal(a, b)


def test_maverick_super_blocks_keep_the_reference_tree(carried):
    """``{'dense': [nb, moe_every - 1, ...], 'moe': [nb, ...]}``: two
    blocks of one dense layer and one MoE layer, expert stacks
    ``[nb, E, in, out]``, the router f32 ``[nb, d_model, E]``."""
    _, tc = _pair('maverick')
    tree, params = carried['maverick']
    shapes = jax.tree.map(lambda a: (a.shape, a.dtype.name), tree)
    port = build_model(tc).init(torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda t: (tuple(t.shape),
                                   str(t.dtype).removeprefix('torch.')),
                        port) == shapes
    layers = port['layers']
    assert layers['dense']['attn']['wq'].shape[:2] == (2, 1)
    assert 'mlp' in layers['dense'] and 'moe' not in layers['dense']
    assert layers['moe']['moe']['w_up'].shape == (2, 4, tc.d_model, tc.d_ff)
    assert layers['moe']['moe']['router'].dtype == torch.float32


@pytest.mark.parametrize('case', list(CASES))
def test_moe_teacher_forced_prefill_equals_forward_logits(carried, routes,
                                                          case):
    """Token-by-token prefill through the KV cache == the bulk forward, at
    ``capacity_factor = n_experts`` (no drops in the prefill group, as the
    decode capacity has none; ``tests/test_models.py`` does the same);
    each position takes the same expert in every layer on both paths."""
    _, tc = _pair(case)
    tc = dataclasses.replace(tc, capacity_factor=float(tc.n_experts))
    _, params = carried[case]
    model = build_model(tc)
    S = 12
    toks = torch.from_numpy(_tokens(tc, 2, S, seed=S))
    full, _ = model.logits(params, {'tokens': toks})
    bulk = [r.reshape(2, S) for r in routes['torch']]
    routes['torch'].clear()
    cache, step = model.prefill(params, model.init_cache(2, S, device='cpu'),
                                toks)
    assert cache['length'] == S
    n_moe = len(bulk)
    steps = np.stack(routes['torch']).reshape(S, n_moe, 2)
    for layer in range(n_moe):
        np.testing.assert_array_equal(steps[:, layer].T, bulk[layer])
    np.testing.assert_allclose(step.numpy(), full.numpy(), atol=3e-4,
                               rtol=2e-3)


@pytest.mark.parametrize('case', list(CASES))
def test_moe_prefill_cache_matches_reference(carried, case):
    """The cache after a prefill equals the reference's (K and V slots, in
    the super-blocks' sub-layer order for maverick), and so do the
    logits."""
    jc, tc = _pair(case)
    tree, params = carried[case]
    toks = _tokens(jc, 2, 9, seed=4)
    jm = j_build_model(jc)
    jcache, jlog = jm.prefill(tree, jm.init_cache(2, 9), jnp.asarray(toks))
    model = build_model(tc)
    cache, log = model.prefill(params, model.init_cache(2, 9, device='cpu'),
                               torch.from_numpy(toks))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-4)
    for key in ('k', 'v'):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-5)
    np.testing.assert_array_equal(cache['positions'].numpy(),
                                  np.asarray(jcache['positions']))


@pytest.mark.parametrize('case', list(CASES))
def test_moe_greedy_decode_matches_reference(carried, case):
    """A 10-token prompt, then 8 greedy tokens through ``serve_step``,
    against the reference's jitted ``ServeSetup.serve_step``."""
    jc, tc = _pair(case)
    tree, params = carried[case]
    B, P, G = 2, 10, 8
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


@pytest.mark.parametrize('impl', ['flash_jnp', 'pallas'])
@pytest.mark.parametrize('case', list(CASES))
def test_moe_prefill_step_matches_reference(carried, case, impl):
    jc, tc = _pair(case, impl)
    tree, params = carried[case]
    toks = _tokens(jc, 3, 20, seed=1)
    want = JServeSetup(j_build_model(jc)).prefill_step(
        tree, {'tokens': jnp.asarray(toks)})
    got = ServeSetup(build_model(tc)).prefill_step(
        params, {'tokens': torch.from_numpy(toks)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('arch', ['llama4-scout-17b-a16e',
                                  'llama4-maverick-400b-a17b'])
def test_moe_n_params_and_cache_shapes_match_reference(arch):
    """At full size, on meta tensors: the parameter count and every
    leaf's shape and dtype, and the decode cache of ``decode_32k``."""
    jm, tm = (j_build_model(jcfgs.get_config(arch)),
              build_model(tcfgs.get_config(arch)))
    assert tm.n_params() == jm.n_params()
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)
                                   .removeprefix('torch.')),
                        tm.param_shapes()) == \
        jax.tree.map(lambda a: (a.shape, jnp.dtype(a.dtype).name),
                     jm.param_shapes())
    shape = tcfgs.INPUT_SHAPES['decode_32k']
    (tc, _), (jc, _) = (ServeSetup(tm).decode_batch(shape),
                        JServeSetup(jm).decode_batch(
                            jcfgs.INPUT_SHAPES['decode_32k']))
    for key in ('k', 'v', 'positions'):
        assert tuple(tc[key].shape) == jc[key].shape, key

"""The port's dense model path against the JAX package on the CPU (the
MoE, SSM and hybrid families: ``tests/test_torch_moe.py``,
``tests/test_torch_ssm.py``): the
configurations, the converter, the attention functions and kernel 21's
plain version, ``forward_logits`` on both ``attn_impl`` paths and the
teacher-forced ``Model.prefill``, on the same seeded inputs and the
reference's params carried across.  The JAX side runs the Pallas kernel
in interpret mode, as the JAX package's own tests run it on the CPU.

Tolerances: the attention functions compute the same f32 arithmetic in
another order (atol 2e-5, ``tests/test_kernels.py``'s); a reduced f32
model adds two layers of such rounding (atol 1e-4); the decode-step
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
from repro.kernels.swa_attention import swa_attention as j_swa_attention
from repro.models import attention as j_attn
from repro.models import common as j_cm
from repro.models.model import build_model as j_build_model
from repro_torch import configs as tcfgs
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.kernels import backend
from repro_torch.kernels.swa_attention import swa_attention
from repro_torch.models import attention as t_attn
from repro_torch.models import common as t_cm
from repro_torch.models.model import build_model

DENSE = ('h2o-danube-3-4b', 'qwen3-1.7b', 'minitron-4b')
#: reduced configurations: danube with GQA (8 heads over 2 KV heads; its
#: reduced form has 8 KV heads) and window 8 < block 16, qwen3 (qk-norm,
#: no window), minitron (relu^2)
CASES = {'danube-gqa': ('h2o-danube-3-4b', dict(n_kv_heads=2)),
         'danube': ('h2o-danube-3-4b', {}),
         'qwen3': ('qwen3-1.7b', {}),
         'minitron': ('minitron-4b', {})}


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d['dtype'] = jnp.dtype(cfg.dtype).name if not isinstance(
        cfg.dtype, torch.dtype) else str(cfg.dtype).removeprefix('torch.')
    return d


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# -- configurations ----------------------------------------------------------

@pytest.mark.parametrize('arch', jcfgs.ARCH_IDS)
def test_config_matches_reference(arch):
    j, t = jcfgs.get_config(arch), tcfgs.get_config(arch)
    assert _fields(t) == _fields(j)
    assert (t.head_dim, t.padded_vocab) == (j.head_dim, j.padded_vocab)
    assert _fields(t.reduced()) == _fields(j.reduced())
    assert _fields(t.reduced(n_kv_heads=2, window=3)) == \
        _fields(j.reduced(n_kv_heads=2, window=3))


def test_registry_matches_reference():
    assert tcfgs.ARCH_IDS == jcfgs.ARCH_IDS
    assert tcfgs.LONG_CONTEXT_ARCHS == jcfgs.LONG_CONTEXT_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in tcfgs.INPUT_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jcfgs.INPUT_SHAPES.items()}
    for a in jcfgs.ARCH_IDS:
        for s in jcfgs.INPUT_SHAPES:
            assert tcfgs.shape_supported(a, s) == jcfgs.shape_supported(a, s)
    assert set(tcfgs.all_configs()) == set(jcfgs.all_configs())
    assert tcfgs.PAPER_TASKS == jcfgs.PAPER_TASKS
    with pytest.raises(KeyError, match='unknown arch'):
        tcfgs.get_config('llama-2')


@pytest.mark.parametrize('arch', DENSE + ('nemotron-4-340b',))
def test_n_params_match_reference_at_full_size(arch):
    """Counted on meta tensors: nothing is allocated."""
    assert build_model(tcfgs.get_config(arch)).n_params() == \
        j_build_model(jcfgs.get_config(arch)).n_params()


@pytest.mark.parametrize('arch,item', [
    ('llama4-scout-17b-a16e', 24), ('llama4-maverick-400b-a17b', 24),
    ('mamba2-130m', 25), ('zamba2-1.2b', 25), ('internvl2-26b', 26),
    ('whisper-medium', 26)])
def test_families_not_ported_name_their_item(arch, item):
    """The families of ROADMAP items 24 (MoE), 25 (SSM, hybrid) and 26
    (VLM, audio) build, and their full-size parameter count is the
    reference's (counted on meta tensors)."""
    assert build_model(tcfgs.get_config(arch)).n_params() == \
        j_build_model(jcfgs.get_config(arch)).n_params()


def test_experts_in_a_dense_config_name_their_item():
    """A dense configuration with experts builds MoE layers (item 24), as
    the reference's does: the same parameter count."""
    cfg = dataclasses.replace(tcfgs.get_config('h2o-danube-3-4b').reduced(),
                              n_experts=4)
    jcfg = dataclasses.replace(jcfgs.get_config('h2o-danube-3-4b').reduced(),
                               n_experts=4)
    assert 'moe' in build_model(cfg).param_shapes()['layers']
    assert build_model(cfg).n_params() == j_build_model(jcfg).n_params()


# -- params ------------------------------------------------------------------

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_converter_round_trips_nested_trees_bit_for_bit(dtype):
    cfg = jcfgs.get_config('qwen3-1.7b').reduced(dtype=getattr(jnp, dtype))
    tree = _np(j_build_model(cfg).init(jax.random.PRNGKey(1)))
    port = params_from_jax(tree, device='cpu')
    assert port['layers']['attn']['wq'].dtype == getattr(torch, dtype)
    assert port['layers']['attn']['q_norm'].dtype == torch.float32
    back = params_to_numpy(port)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        b = flat_b[path]
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert a.tobytes() == b.tobytes(), path


def test_init_matches_reference_tree_and_distribution():
    """Same keys, shapes and dtypes as the reference's init; dense weights
    drawn from a normal cut at +-2 sigma (sigma = fan_in^-0.5), the
    embedding at sigma = 1, norms at zero."""
    cfg = tcfgs.get_config('qwen3-1.7b').reduced(n_layers=3)
    port = build_model(cfg).init(torch.Generator().manual_seed(0))
    ref = _np(j_build_model(jcfgs.get_config('qwen3-1.7b').reduced(
        n_layers=3)).init(jax.random.PRNGKey(0)))
    shapes = jax.tree.map(lambda a: (a.shape, a.dtype.name), ref)
    assert jax.tree.map(lambda t: (tuple(t.shape),
                                   str(t.dtype).removeprefix('torch.')),
                        port) == shapes
    w = port['layers']['mlp']['w_up']            # [3, 256, 512]
    sigma = 256 ** -0.5
    assert w.abs().max() <= 2 * sigma
    # the std of a normal cut at 2 sigma is 0.8796 sigma
    assert abs(w.std().item() / sigma - 0.8796) < 0.01
    assert not torch.equal(w[0], w[1])            # layers drawn apart
    e = port['embed']
    assert e.abs().max() <= 2.0 and abs(e.std().item() - 0.8796) < 0.01
    assert torch.count_nonzero(port['layers']['ln1']) == 0


# -- primitives ----------------------------------------------------------------

def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
    scale = rng.normal(size=(32,)).astype(np.float32) * 0.1
    pos = np.arange(3, 8, dtype=np.int32)
    np.testing.assert_allclose(
        t_cm.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(j_cm.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        atol=1e-6)
    np.testing.assert_allclose(
        t_cm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        1e6).numpy(),
        np.asarray(j_cm.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)),
        atol=2e-5)
    xb = torch.from_numpy(x).bfloat16()
    assert t_cm.rms_norm(xb, torch.from_numpy(scale)).dtype == torch.bfloat16
    assert t_cm.apply_rope(xb, torch.from_numpy(pos)).dtype == torch.bfloat16


#: tests/test_kernels.py's shapes (B, S, H, KH, D, window, block_q, block_k)
SWA_SHAPES = [(1, 64, 2, 2, 16, None, 16, 16), (2, 100, 4, 2, 32, 17, 16, 16),
              (1, 33, 4, 1, 16, 8, 16, 16), (1, 128, 2, 2, 64, 32, 32, 32)]


def _qkv(B, S, H, KH, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, h, D)).astype(np.float32)
            for h in (H, KH, KH)]


@pytest.mark.parametrize('B,S,H,KH,D,win,bq,bk', SWA_SHAPES)
def test_swa_attention_plain_matches_reference_kernel(B, S, H, KH, D, win,
                                                      bq, bk):
    """Kernel 21's CPU path (the plain version) against the Pallas kernel
    in interpret mode."""
    q, k, v = _qkv(B, S, H, KH, D, seed=S)
    want = np.asarray(j_swa_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), window=win,
                                      block_q=bq, block_k=bk))
    backend.reset_launches()
    got = swa_attention(*map(torch.from_numpy, (q, k, v)), window=win,
                        block_q=bq, block_k=bk)
    assert backend.LAUNCHES['swa_attention'] == 0   # plain: no launch
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize('B,S,H,KH,D,win,bq,bk', SWA_SHAPES)
def test_swa_attention_spread_ref_scales_bf16_rounding(B, S, H, KH, D, win,
                                                       bq, bk):
    """``ref.swa_attention_spread_ref``, the scale of kernel 21's bf16
    gate, equals sqrt(sum_j w_ij^2 v_jd^2) from softmax weights computed
    in numpy; the bf16 kernel's rounding (each weight to bf16, then the
    output) stays within 2e-2 (|o| + spread), the gate's bound."""
    from repro_torch.kernels import ref
    q, k, v = _qkv(B, S, H, KH, D, seed=S)
    s = np.einsum('bqhgd,bkhd->bqhgk',
                  q.reshape(B, S, KH, H // KH, D) * D ** -0.5, k)
    i, j = np.arange(S)[:, None], np.arange(S)[None, :]
    band = (j <= i) & ((i - j < win) if win is not None else True)
    s = np.where(band[None, :, None, None, :], s, -np.inf)
    w = np.exp(s - s.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    spread = np.sqrt(np.einsum('bqhgk,bkhd->bqhgd', w ** 2,
                               v ** 2)).reshape(B, S, H, D)
    got = ref.swa_attention_spread_ref(*map(torch.from_numpy, (q, k, v)),
                                       window=win)
    np.testing.assert_allclose(got.numpy(), spread, rtol=1e-5, atol=1e-6)
    o = np.einsum('bqhgk,bkhd->bqhgd', w, v).reshape(B, S, H, D)
    w16 = torch.from_numpy(w).bfloat16().float().numpy()
    o16 = torch.from_numpy(np.einsum('bqhgk,bkhd->bqhgd', w16, v).reshape(
        B, S, H, D)).bfloat16().float().numpy()
    assert np.all(np.abs(o16 - o) <= 2e-2 * (np.abs(o) + spread) + 1e-6)


@pytest.mark.parametrize('B,S,H,KH,D,win,bq,bk', SWA_SHAPES)
def test_flash_and_ref_attention_match_reference(B, S, H, KH, D, win, bq,
                                                 bk):
    q, k, v = _qkv(B, S, H, KH, D, seed=S + 1)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    np.testing.assert_allclose(
        t_attn.flash_attention(tq, tk, tv, window=win, q_block=bq,
                               kv_block=bk).numpy(),
        np.asarray(j_attn.flash_attention(jq, jk, jv, window=win, q_block=bq,
                                          kv_block=bk)), atol=2e-5)
    np.testing.assert_allclose(
        t_attn.attention_ref(tq, tk, tv, window=win).numpy(),
        np.asarray(j_attn.attention_ref(jq, jk, jv, window=win)), atol=2e-5)
    # non-causal, with a valid-key count (the reference's decode caches)
    np.testing.assert_allclose(
        t_attn.flash_attention(tq, tk, tv, causal=False, q_block=bq,
                               kv_block=bk, kv_valid=S - 3).numpy(),
        np.asarray(j_attn.flash_attention(jq, jk, jv, causal=False,
                                          q_block=bq, kv_block=bk,
                                          kv_valid=S - 3)), atol=2e-5)


def test_flash_attention_bf16_matches_reference():
    """bf16 operands, f32 accumulation, probabilities rounded to bf16
    before the second product, on both sides."""
    q, k, v = (jnp.asarray(a, jnp.bfloat16)
               for a in _qkv(2, 48, 4, 2, 16, seed=3))
    want = j_attn.flash_attention(q, k, v, window=9, q_block=16, kv_block=16)
    got = t_attn.flash_attention(
        *(params_from_jax({'x': np.asarray(a)}, device='cpu')['x']
          for a in (q, k, v)), window=9, q_block=16, kv_block=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=1e-2)


@pytest.mark.parametrize('win', [None, 5])
def test_decode_attention_matches_reference(win):
    """One decode step against a ring-buffer cache: 8 slots holding
    positions 4..11 out of order, one slot empty (-1)."""
    B, S, H, KH, D = 2, 8, 4, 2, 32
    rng = np.random.default_rng(7)
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    kc = rng.normal(size=(B, S, KH, D)).astype(np.float32)
    vc = rng.normal(size=(B, S, KH, D)).astype(np.float32)
    pos = np.array([[8, 9, 10, -1, 4, 5, 6, 7]] * B, dtype=np.int32)
    want = j_attn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                   jnp.asarray(vc), 11, window=win,
                                   cache_positions=jnp.asarray(pos))
    got = t_attn.decode_attention(*map(torch.from_numpy, (q, kc, vc)), 11,
                                  window=win,
                                  cache_positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# -- the model -----------------------------------------------------------------

def _pair(case, impl='flash_jnp'):
    arch, kw = CASES[case]
    return (jcfgs.get_config(arch).reduced(attn_impl=impl, **kw),
            tcfgs.get_config(arch).reduced(attn_impl=impl, **kw))


@pytest.fixture(scope='module')
def carried():
    """case -> (reference params as numpy, the port's params), seeded."""
    out = {}
    for i, case in enumerate(CASES):
        jc, _ = _pair(case)
        tree = _np(j_build_model(jc).init(jax.random.PRNGKey(i)))
        out[case] = tree, params_from_jax(tree, device='cpu')
    return out


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize('impl', ['flash_jnp', 'pallas'])
@pytest.mark.parametrize('case', list(CASES))
def test_forward_logits_match_reference(carried, case, impl):
    jc, tc = _pair(case, impl)
    tree, params = carried[case]
    toks = _tokens(jc, 2, 24)
    want, _ = j_build_model(jc).logits(tree, {'tokens': jnp.asarray(toks)})
    backend.reset_launches()
    got, aux = build_model(tc).logits(params,
                                      {'tokens': torch.from_numpy(toks)})
    assert got.shape == (2, 24, tc.padded_vocab)
    assert float(aux['load_balance_loss']) == 0.0
    assert backend.LAUNCHES['swa_attention'] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize('case,S', [('danube-gqa', 12), ('danube-gqa', 24),
                                    ('qwen3', 12), ('minitron', 12)])
def test_prefill_equals_forward_logits(carried, case, S):
    """Token-by-token prefill through the KV cache == the bulk forward; at
    S = 24 through danube's window of 8 the cache is a ring of 8 slots."""
    _, tc = _pair(case)
    _, params = carried[case]
    model = build_model(tc)
    toks = torch.from_numpy(_tokens(tc, 2, S, seed=S))
    full, _ = model.logits(params, {'tokens': toks})
    cache = model.init_cache(2, S, device='cpu')
    slots = S if tc.window is None else min(S, tc.window)
    assert cache['k'].shape == (tc.n_layers, 2, slots, tc.n_kv_heads,
                                tc.head_dim)
    cache, step = model.prefill(params, cache, toks)
    assert cache['length'] == S
    if slots < S:   # the ring holds the last `slots` positions
        assert sorted(cache['positions'].tolist()) == list(range(S - slots,
                                                                 S))
    np.testing.assert_allclose(step.numpy(), full.numpy(), atol=3e-4,
                               rtol=2e-3)


def test_prefill_matches_reference_decode_path(carried):
    """The port's cache after a prefill equals the reference's: K and V
    slots, positions and length."""
    jc, tc = _pair('danube-gqa')
    tree, params = carried['danube-gqa']
    toks = _tokens(jc, 2, 11, seed=5)
    jm = j_build_model(jc)
    jcache, jlog = jm.prefill(tree, jm.init_cache(2, 11), jnp.asarray(toks))
    model = build_model(tc)
    cache, log = model.prefill(params, model.init_cache(2, 11, device='cpu'),
                               torch.from_numpy(toks))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog), atol=1e-4)
    for key in ('k', 'v'):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), atol=1e-5)
    np.testing.assert_array_equal(cache['positions'].numpy(),
                                  np.asarray(jcache['positions']))
    assert cache['length'] == int(jcache['length'])

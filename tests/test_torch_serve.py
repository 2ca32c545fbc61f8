"""The port's serving path against the JAX package on the CPU: greedy
decode through the KV cache, ``ServeSetup``'s steps and shapes, and
``launch.serve``'s ``run``/``main``, from the reference's params carried
across (reduced configurations, f32).

Token ids are compared exactly: the two packages' logits agree within
~1e-5 on these models, far inside the margins between the top two
logits of these seeded runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.launch.steps import ServeSetup as JServeSetup
from repro.models.model import build_model as j_build_model
from repro_torch import configs as tcfgs
from repro_torch.convert import params_from_jax
from repro_torch.kernels import backend
from repro_torch.launch import serve
from repro_torch.launch.steps import ServeSetup
from repro_torch.models.model import build_model

CASES = {'danube-gqa': ('h2o-danube-3-4b', dict(n_kv_heads=2)),
         'qwen3': ('qwen3-1.7b', {}),
         'minitron': ('minitron-4b', {})}


def _pair(case, impl='flash_jnp'):
    arch, kw = CASES[case]
    return (jcfgs.get_config(arch).reduced(attn_impl=impl, **kw),
            tcfgs.get_config(arch).reduced(attn_impl=impl, **kw))


@pytest.fixture(scope='module')
def carried():
    out = {}
    for i, case in enumerate(CASES):
        jc, _ = _pair(case)
        tree = jax.tree.map(np.asarray,
                            j_build_model(jc).init(jax.random.PRNGKey(10 + i)))
        out[case] = tree, params_from_jax(tree, device='cpu')
    return out


def _prompts(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize('case', list(CASES))
def test_greedy_decode_matches_reference(carried, case):
    """A 12-token prompt (longer than danube's window of 8), then 8 greedy
    tokens: the reference's ``ServeSetup.serve_step`` (jitted) against the
    port's, from the same params and prompts."""
    jc, tc = _pair(case)
    tree, params = carried[case]
    B, P, G = 2, 12, 8
    prompts = _prompts(jc, B, P, seed=P)

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
    assert cache['length'] == P + G - 1


@pytest.mark.parametrize('impl', ['flash_jnp', 'pallas'])
def test_prefill_step_matches_reference(carried, impl):
    jc, tc = _pair('danube-gqa', impl)
    tree, params = carried['danube-gqa']
    toks = _prompts(jc, 3, 20, seed=1)
    want = JServeSetup(j_build_model(jc)).prefill_step(
        tree, {'tokens': jnp.asarray(toks)})
    backend.reset_launches()
    got = ServeSetup(build_model(tc)).prefill_step(
        params, {'tokens': torch.from_numpy(toks)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert backend.LAUNCHES['swa_attention'] == 0   # the CPU: plain only


@pytest.mark.parametrize('shape', ['prefill_32k', 'decode_32k', 'long_500k'])
def test_step_inputs_match_reference_shapes(shape):
    """``prefill_batch``/``decode_batch`` at full width: the reference's
    shapes and dtypes, as meta tensors (nothing allocated)."""
    arch = 'h2o-danube-3-4b'
    jset = JServeSetup(j_build_model(jcfgs.get_config(arch)))
    tset = ServeSetup(build_model(tcfgs.get_config(arch)))
    ishape = tcfgs.INPUT_SHAPES[shape]
    jb, tb = jset.prefill_batch(jcfgs.INPUT_SHAPES[shape]), \
        tset.prefill_batch(ishape)
    assert tb['tokens'].device.type == 'meta'
    assert tuple(tb['tokens'].shape) == jb['tokens'].shape
    (jc, jt), (tc, tt) = jset.decode_batch(jcfgs.INPUT_SHAPES[shape]), \
        tset.decode_batch(ishape)
    assert tuple(tt.shape) == jt.shape
    for key in ('k', 'v', 'positions'):
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert str(tc[key].dtype).removeprefix('torch.') == \
            jnp.dtype(jc[key].dtype).name, key
    assert tc['length'] == ishape.seq_len - 1


def test_serve_run_on_the_cpu(capsys):
    """``run`` at reduced size: its tokens are the greedy decode of
    ``ServeSetup.serve_step`` on the params and prompts its seed names."""
    arch, B, P, G = 'h2o-danube-3-4b', 2, 10, 6
    toks = serve.run(arch, batch=B, prompt_len=P, gen=G, seed=3,
                     device='cpu')
    out = capsys.readouterr().out
    assert 'prefill: 2x10 tokens' in out and 'decode:  2x6 tokens' in out
    assert toks.shape == (B, G)

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


def test_serve_main_cli(capsys):
    serve.main(['--arch', 'qwen3-1.7b', '--batch', '1', '--prompt-len', '3',
                '--gen', '2', '--device', 'cpu'])
    assert 'decode:  1x2 tokens' in capsys.readouterr().out


def test_serve_refusals(monkeypatch, tmp_path):
    """``ckpt=`` serves a saved model (the seeded init saved and served
    gives the tokens of the seeded init), a missing checkpoint is refused,
    and so is a call without a card that does not ask for the CPU."""
    from repro_torch import checkpoint
    arch = 'h2o-danube-3-4b'
    model = build_model(tcfgs.get_config(arch).reduced())
    checkpoint.save(str(tmp_path / 'init'),
                    model.init(torch.Generator().manual_seed(4)))
    kw = dict(batch=1, prompt_len=3, gen=2, seed=4, device='cpu')
    assert torch.equal(serve.run(arch, ckpt=str(tmp_path / 'init'), **kw),
                       serve.run(arch, **kw))
    with pytest.raises(FileNotFoundError):
        serve.run(arch, ckpt=str(tmp_path / 'missing.npz'), **kw)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.run('h2o-danube-3-4b', batch=1, prompt_len=2, gen=1)
    model = build_model(tcfgs.get_config('h2o-danube-3-4b').reduced())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_cache(1, 4)

"""The port's federated LLM training path against the JAX package on the
CPU: ``SiloSetup.train_step``/``fedavg_train_step`` over rounds (reduced
f32 qwen3-1.7b and mamba2-130m), the in-place step against the
out-of-place ``protocol.safa_round``, ``train.run``'s history, the
autograd refusal of the kernel wrappers and the entry points'
refusals.  The reference's params are carried across
(``params_from_jax``).  ``Model.loss``, its gradient and the custom
backward passes: ``tests/test_torch_train_loss.py``; the optimizers:
``tests/test_torch_optim.py``.

Tolerances: the silo rounds' states and loss metric within atol 1e-5
after three rounds of SGD (lr 0.05, two local steps; each round's
gradients are the loss file's, within 1e-5); ``train.run``'s six-round
history within rtol 1e-4; the in-place step and the out-of-place
composition run the same operations, so equal bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.core import protocol as j_protocol
from repro.launch import train as j_train
from repro.launch.steps import SiloSetup as JSiloSetup
from repro.models.model import build_model as j_build_model
from repro_torch import configs as tcfgs
from repro_torch.convert import params_from_jax
from repro_torch.core import protocol
from repro_torch.data import make_lm_tokens
from repro_torch.launch import train
from repro_torch.launch.steps import ServeSetup, SiloSetup, row
from repro_torch.models.model import Model, build_model
from repro_torch.optim import tree_leaves
from torch_kernel_calls import kernel_calls

STATE_ATOL = 1e-5
HISTORY_RTOL = 1e-4

#: test_system.py's masks of a four-client round
MASKS = {'sync': [1, 1, 0, 1], 'picked': [1, 0, 0, 1],
         'undrafted': [0, 1, 0, 0], 'deprecated': [0, 0, 1, 0],
         'completed': [1, 1, 0, 1]}
WEIGHTS = [0.3, 0.3, 0.2, 0.2]


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


# -- (f)-(g) the silo step ----------------------------------------------------

def _round_meta(r):
    """Round r's masks: test_system.py's, rolled by r clients."""
    meta = {k: np.roll(np.array(v, bool), r) for k, v in MASKS.items()}
    meta['weights'] = np.array(WEIGHTS, np.float32)
    return meta


def _silo_pair(arch, C=4, local_steps=2, lr=0.05, seed=5):
    jc, tc = _pair(arch)
    tree, params = _carried(jc, seed)
    jsetup = JSiloSetup(j_build_model(jc), n_clients=C,
                        local_steps=local_steps, learning_rate=lr)
    tsetup = SiloSetup(build_model(tc), n_clients=C, local_steps=local_steps,
                       learning_rate=lr)
    jstate = {'global': tree,
              'local': j_protocol.broadcast_global(tree, C),
              'cache': j_protocol.broadcast_global(tree, C)}
    return jc, jsetup, jstate, tsetup, tsetup.init_state(params)


def _round_batches(cfg, r, C=4, b=2, S=16):
    _, jb, tb = _batch(cfg, (C, b), S, seed=10 + r)
    meta = _round_meta(r)
    jb['meta'] = {k: jnp.asarray(v) for k, v in meta.items()}
    tb['meta'] = {k: torch.from_numpy(v) for k, v in meta.items()}
    return jb, tb


@pytest.mark.parametrize('arch', ['qwen3-1.7b', 'mamba2-130m'])
def test_silo_train_step_matches_reference(arch):
    """Three SAFA rounds (test_system.py's masks, rolled a client a round,
    two local steps): global, local and cache within atol 1e-5 after
    every round, the loss metric within 1e-5, picked_frac equal."""
    jc, jsetup, jstate, tsetup, tstate = _silo_pair(arch)
    step = jax.jit(jsetup.train_step)
    for r in range(3):
        jb, tb = _round_batches(jc, r)
        jstate, jm = step(jstate, jb)
        tstate, tm = tsetup.train_step(tstate, tb)
        for part in ('global', 'local', 'cache'):
            _close(tstate[part], jstate[part], STATE_ATOL)
        np.testing.assert_allclose(float(tm['loss']), float(jm['loss']),
                                   atol=STATE_ATOL)
        assert float(tm['picked_frac']) == float(jm['picked_frac'])


def test_silo_fedavg_train_step_matches_reference():
    jc, jsetup, jstate, tsetup, tstate = _silo_pair('qwen3-1.7b',
                                                    local_steps=1)
    jb, tb = _round_batches(jc, 1)
    want, _ = jax.jit(jsetup.fedavg_train_step)(jstate, jb)
    got, metrics = tsetup.fedavg_train_step(tstate, tb)
    assert metrics == {}
    for part in ('global', 'local', 'cache'):
        _close(got[part], want[part], STATE_ATOL)


def test_silo_step_consumes_the_state_in_place():
    """The state's local and cache stacks are written in place and
    returned; the global is a new tree; init_state owns its stacks."""
    _, _, _, tsetup, tstate = _silo_pair('qwen3-1.7b', local_steps=1)
    local_ptr = tree_leaves(tstate['local'])[0].data_ptr()
    cache_ptr = tree_leaves(tstate['cache'])[0].data_ptr()
    g0 = tstate['global']
    assert len({t.data_ptr() for t in (tree_leaves(g0)[0],
                                       tree_leaves(tstate['local'])[0],
                                       tree_leaves(tstate['cache'])[0])}) == 3
    _, tb = _round_batches(tcfgs.get_config('qwen3-1.7b').reduced(), 0)
    new, _ = tsetup.train_step(tstate, tb)
    assert tree_leaves(new['local'])[0].data_ptr() == local_ptr
    assert tree_leaves(new['cache'])[0].data_ptr() == cache_ptr
    assert new['global'] is not g0


def test_safa_degenerates_to_fedavg():
    """The port's form of test_system.py's: three clients, all synced,
    picked and committed, equal weights, no crashes: the SAFA silo round
    equals the FedAvg silo round (atol 1e-5)."""
    cfg = tcfgs.get_config('qwen3-1.7b').reduced()
    model = build_model(cfg)
    C = 3
    setup = SiloSetup(model, n_clients=C, local_steps=1, learning_rate=0.05)
    g = model.init(0, device='cpu')
    tok = torch.randint(0, cfg.vocab_size, (C, 2, 16),
                        generator=torch.Generator().manual_seed(0))
    ones = torch.ones(C, dtype=torch.bool)
    batch = {'tokens': tok, 'labels': tok,
             'meta': {'sync': ones, 'picked': ones,
                      'undrafted': torch.zeros(C, dtype=torch.bool),
                      'deprecated': torch.zeros(C, dtype=torch.bool),
                      'completed': ones,
                      'weights': torch.full((C,), 1 / C)}}
    s1, _ = setup.train_step(setup.init_state(g), batch)
    s2, _ = setup.fedavg_train_step(setup.init_state(g), batch)
    for a, b in zip(tree_leaves(s1['global']), tree_leaves(s2['global'])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def _per_client_sgd(setup, batch):
    """``protocol.safa_round``'s local_train_fn: each client's SGD from
    its row of the base, one after another, stacked."""
    def train_fn(base):
        rows = [setup.train_client(row(base, k), setup.client(batch, k))[0]
                for k in range(setup.n_clients)]
        return jax.tree.map(lambda *r: torch.stack(r), *rows)
    return train_fn


@pytest.mark.parametrize('arch', ['mamba2-130m', 'qwen3-1.7b'])
def test_silo_round_matches_simulation_protocol(arch):
    """The port's form of test_system.py's: the in-place silo step equals
    the out-of-place composition ``protocol.safa_round`` (nested trees)
    with a per-client SGD local_train_fn, bit for bit on the CPU, for
    global, local and cache."""
    cfg = tcfgs.get_config(arch).reduced()
    model = build_model(cfg)
    C = 4
    setup = SiloSetup(model, n_clients=C, local_steps=1, learning_rate=0.05)
    g = model.init(1, device='cpu')
    state = setup.init_state(g)
    _, tb = _round_batches(cfg, 0)
    meta = tb['meta']
    g2, l2, c2 = protocol.safa_round(
        state['global'], state['local'], state['cache'],
        sync_mask=meta['sync'], completed=meta['completed'],
        picked=meta['picked'], undrafted=meta['undrafted'],
        deprecated=meta['deprecated'], weights=meta['weights'],
        local_train_fn=_per_client_sgd(setup, tb))
    s1, _ = setup.train_step(state, tb)
    for got, want in ((s1['global'], g2), (s1['local'], l2),
                      (s1['cache'], c2)):
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert torch.equal(a, b)


# -- (h) train.run -------------------------------------------------------------

def test_train_run_matches_reference_cli(monkeypatch, capsys):
    """``train.run`` against ``repro.launch.train.run`` for reduced
    qwen3-1.7b, 6 rounds, 4 clients, the reference's params (its
    ``PRNGKey(seed)`` init carried across): the same host schedule and
    batches, the loss history within rtol 1e-4."""
    kw = dict(rounds=6, n_clients=4, fraction=0.5, lag_tolerance=3,
              crash_prob=0.2, batch=2, seq=32, local_steps=2, lr=0.1, seed=0)
    want = j_train.run('qwen3-1.7b', **kw)
    jc = jcfgs.get_config('qwen3-1.7b').reduced()
    tree = _np(j_build_model(jc).init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(Model, 'init',
                        lambda self, seed=0, device='cuda':
                        params_from_jax(tree, device='cpu'))
    got = train.run('qwen3-1.7b', device='cpu', **kw)
    assert len(got) == 6
    np.testing.assert_allclose(got, want, rtol=HISTORY_RTOL)
    assert got[-1] < got[0]
    assert 'round    6 loss' in capsys.readouterr().out


def test_train_run_caps_the_token_teacher(monkeypatch):
    """Above ``TEACHER_VOCAB`` ids the token streams' Markov teacher runs
    over the first ``TEACHER_VOCAB`` of them (its [V, V] matrix would not
    fit a host at a published vocabulary); at or below it, over all of
    them, as the reference's."""
    seen = []

    def spy(**kw):
        seen.append(kw['vocab'])
        return make_lm_tokens(**kw)
    monkeypatch.setattr(train, 'make_lm_tokens', spy)
    kw = dict(rounds=1, n_clients=2, fraction=0.5, lag_tolerance=3,
              crash_prob=0.0, batch=2, seq=16, local_steps=1, lr=0.05,
              device='cpu')
    train.run('qwen3-1.7b', **kw)
    monkeypatch.setattr(train, 'TEACHER_VOCAB', 100)
    train.run('qwen3-1.7b', **kw)
    vocab = tcfgs.get_config('qwen3-1.7b').reduced().vocab_size
    assert seen == [vocab, 100] and vocab <= 4096


def test_train_main_on_the_cpu(capsys):
    train.main(['--device', 'cpu', '--arch', 'mamba2-130m', '--rounds', '3',
                '--batch', '2', '--seq', '16'])
    out = capsys.readouterr().out
    assert 'round    3 loss' in out and out.splitlines()[-1].startswith('done')


@pytest.mark.parametrize('arch', ['internvl2-26b', 'whisper-medium',
                                  'llama4-scout-17b-a16e'])
def test_train_run_other_families_on_the_cpu(arch):
    """The VLM (zero patch embeddings), audio (zero frame embeddings) and
    MoE families train through train.run: finite losses."""
    hist = train.run(arch, rounds=2, n_clients=2, fraction=0.5,
                     lag_tolerance=3, crash_prob=0.0, batch=2, seq=16,
                     local_steps=1, lr=0.05, device='cpu')
    assert len(hist) == 2 and np.all(np.isfinite(hist))


# -- (i) refusals -------------------------------------------------------------

def test_train_refusals(tmp_path):
    """``ckpt=`` saves the final global model with the reference's
    metadata, restorable onto ``param_shapes()``; without a card a call
    that does not ask for the CPU is refused."""
    from repro_torch import checkpoint
    kw = dict(rounds=1, n_clients=2, fraction=0.5, lag_tolerance=3,
              crash_prob=0.0, batch=2, seq=16, local_steps=1, lr=0.05)
    path = str(tmp_path / 'llm')
    train.run('qwen3-1.7b', ckpt=path, device='cpu', **kw)
    model = build_model(tcfgs.get_config('qwen3-1.7b').reduced())
    params, meta = checkpoint.restore(path, model.param_shapes())
    assert meta == {'arch': 'qwen3-1.7b', 'rounds': 1}
    assert all(torch.isfinite(v).all() for v in jax.tree.leaves(params))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='torch.cuda.is_available'):
            train.run('qwen3-1.7b', **kw)


def test_silo_setup_accepts_sharding_rules():
    """``rules=`` (a sharding profile) is accepted, as the reference's:
    an empty dict, each of ``sharding.PROFILES``."""
    from repro_torch import sharding as shd
    model = build_model(tcfgs.get_config('qwen3-1.7b').reduced())
    for rules in [{}] + list(shd.PROFILES.values()):
        assert SiloSetup(model, n_clients=2, rules=rules).rules is rules


def test_gradient_through_the_attention_kernel_raises_on_both_packages():
    """``attn_impl='pallas'`` cannot train: the reference's jax.grad
    through its Pallas kernel raises, and so does the port's loss under
    grad (the kernel wrapper refuses an operand that requires grad)."""
    jc, tc = _pair('qwen3-1.7b', attn_impl='pallas')
    tree, params = _carried(jc, 7)
    _, jb, tb = _batch(jc, (2,), 16)
    with pytest.raises(AssertionError):
        jax.grad(j_build_model(jc).loss)(tree, jb)
    p = jax.tree.map(lambda t: t.clone().requires_grad_(), params)
    with pytest.raises(RuntimeError, match='not differentiable'):
        build_model(tc).loss(p, tb)


@pytest.mark.parametrize('name', sorted(kernel_calls('cpu')))
def test_kernel_wrappers_refuse_grad(name):
    """Every wrapper raises on an operand that requires grad while grad
    is enabled (on the CPU, before its plain version runs), and runs on
    the same operands under no_grad."""
    call = kernel_calls('cpu')[name]
    with pytest.raises(RuntimeError, match='not differentiable'):
        call()
    with torch.no_grad():
        call()


def test_refusal_spares_the_serving_and_task2_paths():
    """Under torch.enable_grad(), with params that do not require grad:
    a serving prefill through kernel 21's wrapper and a Task 2 server
    step through the packed and int8 kernels' wrappers run and give what
    they give under no_grad."""
    cfg = tcfgs.get_config('qwen3-1.7b').reduced(attn_impl='pallas')
    model = build_model(cfg)
    params = model.init(0, device='cpu')
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    setup = ServeSetup(model)
    with torch.enable_grad():
        nxt = setup.prefill_step(params, {'tokens': tokens})
    with torch.no_grad():
        assert torch.equal(nxt, setup.prefill_step(params,
                                                   {'tokens': tokens}))

    from repro_torch.data.tasks import _cnn_init
    g = _cnn_init(torch.Generator().manual_seed(0))
    m = 4
    base = protocol.broadcast_global(g, m)
    gen = torch.Generator().manual_seed(1)
    trained = {k: v + 0.01 * torch.randn(v.shape, generator=gen)
               for k, v in base.items()}
    masks = {k: torch.tensor(v[:m], dtype=torch.bool)
             for k, v in MASKS.items() if k != 'sync'}
    weights = torch.tensor(WEIGHTS)
    for kw in (dict(use_kernel='packed'), dict(wire='int8')):
        outs = []
        for ctx in (torch.enable_grad, torch.no_grad):
            with ctx():
                cache = {k: v.clone() for k, v in base.items()}
                outs.append(protocol.safa_server_step(
                    base, trained, cache, g, weights=weights, **masks, **kw))
        for a, b in zip(jax.tree.leaves(outs[0]), jax.tree.leaves(outs[1])):
            assert torch.equal(a, b)


def test_silo_setup_describes_its_inputs_as_meta_tensors():
    cfg = tcfgs.get_config('internvl2-26b').reduced()
    jcfg = jcfgs.get_config('internvl2-26b').reduced()
    setup = SiloSetup(build_model(cfg), n_clients=3)
    shape = dataclasses.replace(tcfgs.INPUT_SHAPES['train_4k'], seq_len=32,
                                global_batch=8)
    got = setup.client_batch(shape)
    want = JSiloSetup(j_build_model(jcfg), n_clients=3).client_batch(
        dataclasses.replace(jcfgs.INPUT_SHAPES['train_4k'], seq_len=32,
                            global_batch=8))

    def meta(tree):
        return jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)
                                       .removeprefix('torch.')), tree)

    def sds(tree):
        return jax.tree.map(lambda s: (tuple(s.shape), s.dtype.name), tree)
    assert all(t.device.type == 'meta' for t in jax.tree.leaves(got))
    assert meta(got) == sds(want)
    state = setup.state_sds()
    assert meta(state) == sds(JSiloSetup(j_build_model(jcfg),
                                         n_clients=3).state_sds())

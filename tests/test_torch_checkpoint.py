"""Checkpoint and resume in the port against the JAX package on the CPU:
the generic npz layer (``repro_torch.checkpoint``) against
``repro.checkpoint``'s files, a stopped and resumed run or fleet sweep
against its uninterrupted twin in the reference's conformance
environment (``tests/conformance.py``: m = 5, 6 rounds, evaluated every
3), the run-state file's layout against the reference's, a resumed port
run against the reference's uninterrupted quickstart run, the History
dict, the refusals, and ``train.run(ckpt=)``/``serve.run(ckpt=)``.

Tolerances: a resumed run equals its uninterrupted run bit for bit
(final model, evals, records); files and restored leaves are compared bit
for bit (bf16 as int16); the cross-package quickstart runs within the
port's parity tolerances (eval losses rtol 1e-4, final model atol 1e-5
on f32 and 1e-4 on the int8 wire, as ``tests/test_torch_api.py`` holds
them).
"""
import dataclasses
import json

import conformance as C
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import checkpoint as jckpt
from repro.data import make_regression, partition
from repro.data import tasks as jtasks
from repro.fedsim import EnvSpec as JEnvSpec
from repro.launch import serve as j_serve
from repro.launch import train as j_train
from repro_torch import api as tapi
from repro_torch import checkpoint as tckpt
from repro_torch import configs as tcfgs
from repro_torch.data import tasks as ttasks
from repro_torch.fedsim import EnvSpec as TEnvSpec
from repro_torch.kernels import backend
from repro_torch.launch import serve, train
from repro_torch.launch.steps import ServeSetup
from repro_torch.models.model import build_model


@pytest.fixture(autouse=True)
def _zero_launches():
    backend.reset_launches()
    yield
    assert all(v == 0 for v in backend.LAUNCHES.values()), \
        'a wrapper launched a kernel on CPU tensors'


# ---------------------------------------------------------------------------
# (a) the generic layer
# ---------------------------------------------------------------------------

def _tree(dtype):
    g = torch.Generator().manual_seed(0)
    if dtype.is_floating_point:
        def leaf(*s):
            return torch.randn(s, generator=g).to(dtype)
    else:
        def leaf(*s):
            return torch.randint(-100, 100, s, generator=g).to(dtype)
    return {'a': leaf(3, 4), 'b': {'c': leaf(5), 'd': leaf()},
            'packed': (leaf(2, 3), leaf(7)), 'none': None}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _assert_bits_equal(a, b):
    if a is None or isinstance(a, (dict, tuple)):
        if a is None:
            assert b is None
            return
        items = a.items() if isinstance(a, dict) else enumerate(a)
        for k, v in items:
            _assert_bits_equal(v, b[k])
        return
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize('dtype', [torch.float32, torch.int32, torch.int64,
                                   torch.int8, torch.bfloat16],
                         ids=['f32', 'int32', 'int64', 'int8', 'bf16'])
def test_save_restore_round_trip(dtype, tmp_path):
    tree = _tree(dtype)
    tckpt.save(str(tmp_path / 'ck'), tree, {'step': 3})
    assert tckpt.exists(str(tmp_path / 'ck'))
    got, meta = tckpt.restore(str(tmp_path / 'ck.npz'), tree)
    assert meta == {'step': 3}
    _assert_bits_equal(tree, got)


def _mixed():
    return {'w': _tree(torch.float32)['a'], 'e': _tree(torch.bfloat16)['b'],
            'i': _tree(torch.int32)['packed']}


def _to_jax(tree):
    """The same tree as JAX arrays (bf16 leaves bit for bit)."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_jax(v) for v in tree)
    if tree.dtype == torch.bfloat16:
        return jax.lax.bitcast_convert_type(
            jnp.asarray(tree.view(torch.int16).numpy()), jnp.bfloat16)
    return jnp.asarray(tree.numpy())


def test_file_matches_the_references(tmp_path):
    """The port's file and the reference's ``save`` of the same tree hold
    the same keys, dtype descrs (``|V2`` for bf16) and bytes."""
    tree = _mixed()
    tckpt.save(str(tmp_path / 'port'), tree, {'k': 1})
    jckpt.save(str(tmp_path / 'ref'), _to_jax(tree), {'k': 1})
    port = np.load(tmp_path / 'port.npz')
    ref = np.load(tmp_path / 'ref.npz')
    assert port.files == ref.files
    for k in ref.files:
        assert port[k].dtype.str == ref[k].dtype.str, k
        assert port[k].shape == ref[k].shape, k
        assert port[k].tobytes() == ref[k].tobytes(), k
    assert port['e/c'].dtype.str == '|V2'


def test_each_package_restores_the_others_file(tmp_path):
    """The port restores the reference's f32 and bf16 files bit for bit;
    the reference restores the port's f32 file.  The reference cannot
    read its own bf16 file back (its numpy cast of ``|V2`` fails): the
    port's restore is the one that reads it."""
    tree = _mixed()
    jckpt.save(str(tmp_path / 'ref'), _to_jax(tree))
    got, _ = tckpt.restore(str(tmp_path / 'ref'), tree)
    _assert_bits_equal(tree, got)
    with pytest.raises(ValueError):
        jckpt.restore(str(tmp_path / 'ref'), _to_jax(tree))

    f32 = {'w': tree['w'], 'packed': tree['i']}
    tckpt.save(str(tmp_path / 'port'), f32, {'from': 'port'})
    back, meta = jckpt.restore(str(tmp_path / 'port'), _to_jax(f32))
    assert meta == {'from': 'port'}
    np.testing.assert_array_equal(np.asarray(back['w']), f32['w'].numpy())
    for a, b in zip(back['packed'], f32['packed']):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_restore_onto_meta_shapes_and_a_device(tmp_path):
    """``like`` may be ``meta`` tensors (``Model.param_shapes``): the
    leaves come back on ``device`` (the host without one), in ``like``'s
    dtypes; a bf16 model restores bit for bit."""
    cfg = tcfgs.get_config('qwen3-1.7b').reduced(dtype=torch.bfloat16)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1))
    tckpt.save(str(tmp_path / 'm'), params)
    for device in ('cpu', None):
        got, _ = tckpt.restore(str(tmp_path / 'm'), model.param_shapes(),
                               device=device)
        _assert_bits_equal(params, got)
        assert all(t.device.type == 'cpu'
                   for t in tckpt.flatten(got).values())


# ---------------------------------------------------------------------------
# (b) resume bit identity in the conformance environment
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def conf():
    """The conformance regression task in both packages (same data)."""
    x, y = make_regression()
    data = partition(x, y, C.fresh_env().partition_sizes, C.M, seed=1)
    return (jtasks.regression_task(data, lr=1e-3, epochs=3),
            ttasks.regression_task(data, lr=1e-3, epochs=3, device='cpu'))


def _t_env(seed=C.ENV_SEED):
    return TEnvSpec(seed=seed, **C.BASE_ENV)


def _port_run(tt, spec, *, checkpoint=None, max_segments=None, **ex):
    exp = tapi.Experiment(tt, _t_env(), spec,
                          tapi.ExecSpec(eval_every=C.EVAL_EVERY, **ex),
                          rounds=C.ROUNDS, device='cpu')
    return exp.compile().run(checkpoint=checkpoint,
                             max_segments=max_segments)


def _t_members(spec_name, env_seeds=(3, 4)):
    sp = tapi.spec(spec_name)
    kw = {f: getattr(sp, f) for f in ('fraction', 'lag_tolerance')
          if hasattr(sp, f)}
    return [tapi.SweepMember(env=_t_env(e), seed=s, **kw)
            for s, e in enumerate(env_seeds)]


def _port_sweep(tt, name, *, checkpoint=None, max_segments=None, **ex):
    exp = tapi.Experiment(tt, None, tapi.spec(name),
                          tapi.ExecSpec(eval_every=C.EVAL_EVERY, **ex),
                          rounds=C.ROUNDS, device='cpu')
    return exp.compile().run_sweep(_t_members(name), checkpoint=checkpoint,
                                   max_segments=max_segments)


def _assert_history_equal(a, b):
    assert sorted(a.final_global) == sorted(b.final_global)
    for k in a.final_global:
        assert torch.equal(a.final_global[k], b.final_global[k]), k
    assert a.evals() == b.evals()
    assert a.best_eval == b.best_eval
    assert [dataclasses.asdict(r) for r in a.records] == \
        [dataclasses.asdict(r) for r in b.records]


def _stop_and_resume(run, path):
    """The uninterrupted run, then one segment with a checkpoint and the
    rest from it on a fresh Experiment."""
    full = run()
    partial = run(checkpoint=path, max_segments=1)
    assert tckpt.exists(path)
    assert json.loads(str(np.load(path + '.npz')['__meta__']))[
        'seg_done'] == 1
    return full, partial, run(checkpoint=path)


PROTOCOL_NAMES = sorted(p.name for p in tapi.PROTOCOLS.values())


@pytest.mark.parametrize('engine', ['scan', 'loop'])
@pytest.mark.parametrize('name', PROTOCOL_NAMES)
def test_resume_bit_identity_every_protocol(conf, name, engine, tmp_path):
    _, tt = conf
    spec = tapi.spec(name)
    full, partial, resumed = _stop_and_resume(
        lambda **kw: _port_run(tt, spec, engine=engine, **kw),
        str(tmp_path / 'ck'))
    assert len(partial.evals()) == 1 and partial.final_global is not None
    _assert_history_equal(resumed, full)


SAFA_CELLS = {
    'dense-packed-int8': dict(use_kernel='packed', wire='int8'),
    'sparse': dict(schedule='sparse'),
    'sparse_delta': dict(schedule='sparse_delta'),
    'sparse_delta-packed': dict(schedule='sparse_delta', use_kernel='packed'),
    'sparse_tier': dict(schedule='sparse_tier'),
    'sparse_tier-packed': dict(schedule='sparse_tier', use_kernel='packed'),
    'sparse_tier-packed-int8': dict(schedule='sparse_tier',
                                    use_kernel='packed', wire='int8'),
    'sparse_tier-packed-loop': dict(schedule='sparse_tier',
                                    use_kernel='packed', engine='loop'),
}


@pytest.mark.parametrize('cell', list(SAFA_CELLS))
def test_resume_bit_identity_safa_schedules(conf, cell, tmp_path):
    _, tt = conf
    full, _, resumed = _stop_and_resume(
        lambda **kw: _port_run(tt, tapi.SafaSpec(), **SAFA_CELLS[cell], **kw),
        str(tmp_path / 'ck'))
    _assert_history_equal(resumed, full)


SWEEP_CELLS = {
    'dense': ('safa', {}),
    'fedavg-int8': ('fedavg', dict(wire='int8')),
    'sparse_delta-packed': ('safa', dict(schedule='sparse_delta',
                                         use_kernel='packed')),
    'sparse_tier': ('safa', dict(schedule='sparse_tier')),
    'sparse_tier-packed-int8': ('safa', dict(schedule='sparse_tier',
                                             use_kernel='packed',
                                             wire='int8')),
}


@pytest.mark.parametrize('cell', list(SWEEP_CELLS))
def test_sweep_resume_bit_identity(conf, cell, tmp_path):
    _, tt = conf
    name, ex = SWEEP_CELLS[cell]
    full, partial, resumed = _stop_and_resume(
        lambda **kw: _port_sweep(tt, name, **ex, **kw), str(tmp_path / 'ck'))
    assert [len(h.evals()) for h in partial] == [1, 1]
    for a, b in zip(resumed, full):
        _assert_history_equal(a, b)


# ---------------------------------------------------------------------------
# (c) the run-state file against the reference's
# ---------------------------------------------------------------------------

LAYOUT_CELLS = {
    'safa': ('safa', {}, False),
    'fedavg': ('fedavg', {}, False),
    'local': ('local', {}, False),
    'seafl-packed': ('seafl', dict(use_kernel='packed'), False),
    'sparse_delta': ('safa', dict(schedule='sparse_delta'), False),
    'sparse_delta-packed': ('safa', dict(schedule='sparse_delta',
                                         use_kernel='packed'), False),
    'fedavg-sparse_delta': ('fedavg', dict(schedule='sparse_delta'), False),
    'sparse_tier': ('safa', dict(schedule='sparse_tier'), False),
    'sparse_tier-packed-int8': ('safa', dict(schedule='sparse_tier',
                                             use_kernel='packed',
                                             wire='int8'), False),
    'fleet': ('safa', {}, True),
    'fleet-sparse_delta-packed': ('safa', dict(schedule='sparse_delta',
                                               use_kernel='packed'), True),
    'fleet-sparse_tier': ('safa', dict(schedule='sparse_tier'), True),
}


def _j_members(name, env_seeds=(3, 4)):
    sp = japi.spec(name)
    kw = {f: getattr(sp, f) for f in ('fraction', 'lag_tolerance')
          if hasattr(sp, f)}
    return [japi.SweepMember(env=JEnvSpec(seed=e, **C.BASE_ENV), seed=s,
                             **kw) for s, e in enumerate(env_seeds)]


@pytest.mark.parametrize('cell', list(LAYOUT_CELLS))
def test_run_file_layout_matches_the_reference(conf, cell, tmp_path):
    """One segment of the same Experiment in each package: the same npz
    keys, and each entry the same shape and dtype; the same metadata
    keys and timing records."""
    jt, tt = conf
    name, ex, sweep = LAYOUT_CELLS[cell]
    jp, tp = str(tmp_path / 'ref'), str(tmp_path / 'port')
    jexp = japi.Experiment(jt, None if sweep else C.fresh_env(),
                           japi.spec(name),
                           japi.ExecSpec(eval_every=C.EVAL_EVERY, **ex),
                           rounds=C.ROUNDS)
    if sweep:
        jexp.compile().run_sweep(_j_members(name), checkpoint=jp,
                                 max_segments=1)
        _port_sweep(tt, name, checkpoint=tp, max_segments=1, **ex)
    else:
        jexp.compile().run(checkpoint=jp, max_segments=1)
        _port_run(tt, tapi.spec(name), checkpoint=tp, max_segments=1, **ex)
    ref, port = np.load(jp + '.npz'), np.load(tp + '.npz')
    assert sorted(port.files) == sorted(ref.files)
    for k in ref.files:
        if k == '__meta__':
            continue
        assert port[k].shape == ref[k].shape, k
        assert port[k].dtype.str == ref[k].dtype.str, k
    jm, tm = (json.loads(str(f['__meta__'])) for f in (ref, port))
    assert sorted(jm) == sorted(tm) and jm['seg_done'] == tm['seg_done']
    for jh, th in zip(jm['histories'], tm['histories']):
        assert sorted(jh) == sorted(th)
        assert [dict(r, eval=None) for r in jh['records']] == \
            [dict(r, eval=None) for r in th['records']]


# ---------------------------------------------------------------------------
# (d) a resumed port run against the reference's uninterrupted run
# ---------------------------------------------------------------------------

QUICKSTART = dict(m=5, crash_prob=0.3, dataset_size=506, batch_size=5,
                  epochs=3, t_lim=830.0, seed=3)
Q_ROUNDS, Q_EVAL = 24, 6


@pytest.fixture(scope='module')
def quickstart():
    x, y = make_regression()
    env = JEnvSpec(**QUICKSTART).build()
    data = partition(x, y, env.partition_sizes, batch_size=5, seed=1)
    jt = jtasks.regression_task(data, lr=1e-3, epochs=3)
    tt = ttasks.regression_task(data, lr=1e-3, epochs=3, device='cpu')
    init = {k: np.array(v) for k, v in
            jt.init_global(jax.random.PRNGKey(0)).items()}
    return jt, tt, init


@pytest.mark.parametrize('wire,atol', [('f32', 1e-5), ('int8', 1e-4)])
def test_resumed_run_matches_the_reference(quickstart, wire, atol, tmp_path):
    jt, tt, init = quickstart
    ex = dict(eval_every=Q_EVAL, use_kernel='packed', wire=wire)
    want = japi.Experiment(jt, JEnvSpec(**QUICKSTART).build(),
                           japi.SafaSpec(), japi.ExecSpec(**ex),
                           rounds=Q_ROUNDS).compile().run()

    def port(**kw):
        return tapi.Experiment(tt, TEnvSpec(**QUICKSTART), tapi.SafaSpec(),
                               tapi.ExecSpec(**ex), rounds=Q_ROUNDS,
                               device='cpu', init_params=init
                               ).compile().run(**kw)
    path = str(tmp_path / 'ck')
    port(checkpoint=path, max_segments=2)
    got = port(checkpoint=path)
    assert [r for r, _ in got.evals()] == [r for r, _ in want.evals()]
    np.testing.assert_allclose([e['loss'] for _, e in got.evals()],
                               [e['loss'] for _, e in want.evals()],
                               rtol=1e-4)
    for k, v in want.final_global.items():
        np.testing.assert_allclose(got.final_global[k].numpy(),
                                   np.asarray(v), atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# (e) histories and refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', PROTOCOL_NAMES)
def test_history_dict_round_trips_through_json(conf, name):
    _, tt = conf
    h = _port_run(tt, tapi.spec(name))
    d = json.loads(json.dumps(h.to_dict()))
    h2 = tapi.History.from_dict(d)
    assert h2.protocol == h.protocol and h2.futility == h.futility
    assert h2.best_eval == h.best_eval
    assert [dataclasses.asdict(r) for r in h2.records] == \
        [dataclasses.asdict(r) for r in h.records]
    assert h2.evals() == h.evals()


def test_history_to_dict_takes_numpy_and_torch_scalars():
    rec = tapi.RoundRecord(round=np.int64(1), round_len=np.float32(2.5),
                           t_dist=0.0, eur=torch.tensor(0.5), sr=1.0,
                           vv=0.0, n_picked=np.int32(2), n_committed=2,
                           n_crashed=0, eval={'loss': np.float32(0.25)})
    h = tapi.History('safa', records=[rec], futility=np.float64(0.1),
                     best_eval={'loss': torch.tensor(0.25)})
    d = json.loads(json.dumps(h.to_dict()))
    assert d['records'][0]['round'] == 1 and d['best_eval'] == {'loss': 0.25}
    assert isinstance(rec.round, np.int64)      # the record is unchanged


def test_changed_spec_or_task_refuses_to_resume(conf, tmp_path):
    jt, tt = conf
    path = str(tmp_path / 'ck')
    _port_run(tt, tapi.SafaSpec(), checkpoint=path, max_segments=1)
    with pytest.raises(ValueError, match='fingerprint mismatch'):
        _port_run(tt, tapi.SafaSpec(lag_tolerance=2), checkpoint=path)
    other = ttasks.regression_task(tt.data, lr=2e-3, epochs=3, device='cpu')
    with pytest.raises(ValueError, match='fingerprint mismatch'):
        _port_run(other, tapi.SafaSpec(), checkpoint=path)
    with pytest.raises(ValueError, match='fingerprint mismatch'):
        _port_run(tt, tapi.SafaSpec(), checkpoint=path, wire='int8')
    # init_params is not part of the fingerprint: the carry replaces it
    init = {k: np.array(v) for k, v in
            jt.init_global(jax.random.PRNGKey(5)).items()}
    tapi.Experiment(tt, _t_env(), tapi.SafaSpec(),
                    tapi.ExecSpec(eval_every=C.EVAL_EVERY), rounds=C.ROUNDS,
                    device='cpu', init_params=init).compile().run(
                        checkpoint=path)


def test_sweep_fingerprint_covers_members(conf, tmp_path):
    _, tt = conf
    path = str(tmp_path / 'ck')
    _port_sweep(tt, 'safa', checkpoint=path, max_segments=1)
    exp = tapi.Experiment(tt, None, tapi.SafaSpec(),
                          tapi.ExecSpec(eval_every=C.EVAL_EVERY),
                          rounds=C.ROUNDS, device='cpu')
    with pytest.raises(ValueError, match='fingerprint mismatch'):
        exp.compile().run_sweep(_t_members('safa', env_seeds=(3, 5)),
                                checkpoint=path)


def test_sequential_sweep_refuses_a_checkpoint(conf, tmp_path):
    _, tt = conf
    with pytest.raises(ValueError, match="requires engine='fleet'"):
        _port_sweep(tt, 'safa', engine='sequential',
                    checkpoint=str(tmp_path / 'ck'))
    assert not tckpt.exists(str(tmp_path / 'ck'))


def test_a_finished_checkpoint_replays_nothing(conf, tmp_path, monkeypatch):
    """Resuming a run whose checkpoint holds every segment trains no
    round and returns the saved state and evals."""
    _, tt = conf
    path = str(tmp_path / 'ck')
    full = _port_run(tt, tapi.SafaSpec(), checkpoint=path)
    calls = []
    orig = tt.local_train
    monkeypatch.setattr(tt, 'local_train',
                        lambda *a: calls.append(1) or orig(*a))
    again = _port_run(tt, tapi.SafaSpec(), checkpoint=path)
    assert not calls
    _assert_history_equal(again, full)


# ---------------------------------------------------------------------------
# (f) the entry points
# ---------------------------------------------------------------------------

TRAIN_KW = dict(rounds=3, n_clients=2, fraction=0.5, lag_tolerance=3,
                crash_prob=0.0, batch=2, seq=16, local_steps=1, lr=0.05,
                seed=0)
ARCH = 'qwen3-1.7b'


def _greedy(model, params, prompts, gen):
    cache, logits = model.prefill(
        params, model.init_cache(prompts.shape[0], prompts.shape[1] + gen,
                                 device='cpu'), prompts)
    tok = logits[:, -1].argmax(-1)
    out = [tok]
    for _ in range(gen - 1):
        cache, tok = ServeSetup(model).serve_step(params, cache,
                                                  tok[:, None])
        out.append(tok)
    return torch.stack(out, 1)


def test_train_then_serve_round_trips(monkeypatch, tmp_path, capsys):
    saved = []
    real_save = tckpt.save
    monkeypatch.setattr(train.checkpoint, 'save',
                        lambda p, tree, meta: saved.append(tree)
                        or real_save(p, tree, meta))
    path = str(tmp_path / 'llm')
    train.run(ARCH, ckpt=path, device='cpu', **TRAIN_KW)
    assert f'checkpoint saved to {path}' in capsys.readouterr().out
    (trained,) = saved
    toks = serve.run(ARCH, batch=2, prompt_len=5, gen=4, ckpt=path + '.npz',
                     seed=1, device='cpu')
    out = capsys.readouterr().out
    assert "restored checkpoint {'arch': 'qwen3-1.7b', 'rounds': 3}" in out
    model = build_model(tcfgs.get_config(ARCH).reduced())
    restored, meta = tckpt.restore(path, model.param_shapes())
    assert meta == {'arch': ARCH, 'rounds': TRAIN_KW['rounds']}
    _assert_bits_equal(trained, restored)
    prompts = torch.randint(0, model.cfg.vocab_size, (2, 5),
                            generator=torch.Generator().manual_seed(1))
    assert torch.equal(toks, _greedy(model, restored, prompts, 4))


def test_serve_reads_the_references_checkpoint(monkeypatch, tmp_path):
    """``repro.launch.train --ckpt`` writes the file; the port's
    ``serve.run`` restores it and decodes the tokens that the reference's
    ``serve.run`` decodes on it from the same prompts."""
    path = str(tmp_path / 'ref')
    j_train.run(ARCH, ckpt=path, **TRAIN_KW)
    B, P, G, seed = 2, 6, 5, 2
    toks = serve.run(ARCH, batch=B, prompt_len=P, gen=G, ckpt=path,
                     seed=seed, device='cpu')
    vocab = tcfgs.get_config(ARCH).reduced().vocab_size
    prompts = torch.randint(0, vocab, (B, P),
                            generator=torch.Generator().manual_seed(seed))
    monkeypatch.setattr(jax.random, 'randint',
                        lambda *a, **k: jnp.asarray(prompts.numpy(),
                                                    jnp.int32))
    want = j_serve.run(ARCH, batch=B, prompt_len=P, gen=G, ckpt=path,
                       seed=seed)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(want))

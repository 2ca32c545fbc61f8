"""The fleet engine of the port (``CompiledRunner.run_sweep``) against the
JAX package's on the same members, and against itself run member by
member.

Tolerances:

* schedules are host numpy in both packages: masks, records and futility
  equal;
* the fleet kernels' plain versions against the JAX package's fleet
  kernels in interpret mode: caches and locals are selects and one
  multiply, so exact; new_global is a sum taken in another order, atol
  1e-6 (inputs drawn positive, so no sum cancels); scales rtol 1e-6 and q
  +-1 where a scale differs (the JAX package's own formulations disagree
  on some scales by one ulp);
* whole sweeps against the reference on the regression task, 12 rounds:
  per-member ``final_global`` atol 1e-5 on the f32 wire, and atol 1e-4
  against the reference's own int8 run on the int8 wire (its int8-vs-f32
  gap is ~5e-3, so a port that ran f32 would fail);
* inside the port on the CPU, fleet == sequential == a single ``run()``
  bit for bit on the regression task, with padding for per-member tasks;
  the CNN fleet tracks sequential within rtol 1e-5 / atol 1e-6, as the
  JAX package's own CNN fleet test holds it.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import federation as jfed
from repro.data import make_images, make_regression, partition
from repro.data import tasks as jtasks
from repro.fedsim import EnvSpec as JEnvSpec
from repro.fedsim import env_grid as j_env_grid
from repro.kernels.comm_quant import quantize_packed_fleet as j_quant_fleet
from repro.kernels.safa_aggregate import (
    safa_aggregate_packed_fleet as j_agg_fleet,
    safa_aggregate_packed_q8_fleet as j_q8_fleet)
from repro_torch import api as tapi
from repro_torch.core import federation as tfed
from repro_torch.data import tasks as ttasks
from repro_torch.fedsim import EnvSpec as TEnvSpec
from repro_torch.fedsim import env_grid as t_env_grid
from repro_torch.kernels import backend
from repro_torch.kernels import ops as tops
from repro_torch.kernels.comm_quant import (quantize_packed,
                                            quantize_packed_fleet)
from repro_torch.kernels.safa_aggregate import (
    safa_aggregate_fleet, safa_aggregate_packed,
    safa_aggregate_packed_fleet, safa_aggregate_packed_q8,
    safa_aggregate_packed_q8_fleet)

BASE = dict(m=5, crash_prob=0.3, dataset_size=506, batch_size=5, epochs=3,
            t_lim=830.0, seed=3)
HYPER = ((0.5, 5), (0.3, 2), (1.0, 10), (0.1, 1))
ROUNDS, EVAL_EVERY = 12, 6
CELLS = [dict(use_kernel=False), dict(use_kernel=True),
         dict(use_kernel='packed'), dict(wire='int8')]
CELL_IDS = ['plain', 'per_leaf', 'packed', 'int8']


@pytest.fixture(autouse=True)
def _zero_launches():
    backend.reset_launches()
    yield
    assert all(v == 0 for v in backend.LAUNCHES.values()), \
        'a wrapper launched a kernel on CPU tensors'


def _members(pkg, s=4):
    """S members sharing one client population: crash rate x crash stream,
    with cycling (fraction, tau); one init seed each."""
    spec = (JEnvSpec if pkg == 'jax' else TEnvSpec)(**BASE)
    grid = (j_env_grid if pkg == 'jax' else t_env_grid)(
        spec, crash_prob=(0.3, 0.7), draw_seed=tuple(range((s + 1) // 2)))
    cls = japi.SweepMember if pkg == 'jax' else tapi.SweepMember
    return [cls(env=e, fraction=f, lag_tolerance=tau, seed=i)
            for i, (e, (f, tau)) in enumerate(zip(grid[:s],
                                                  HYPER * s))]


@pytest.fixture(scope='module')
def reg():
    """The regression task in both packages, and the reference's init
    for any seed (numpy)."""
    x, y = make_regression()
    data = partition(x, y, JEnvSpec(**BASE).build().partition_sizes, 5,
                     seed=1)
    jt = jtasks.regression_task(data, lr=1e-3, epochs=3)
    tt = ttasks.regression_task(data, lr=1e-3, epochs=3, device='cpu')

    def init(seed):
        return {k: np.array(v) for k, v in
                jt.init_global(jax.random.PRNGKey(seed)).items()}
    return jt, tt, init


def _timing(records):
    return [dataclasses.asdict(dataclasses.replace(r, eval=None))
            for r in records]


def _port_sweep(task, members, init=None, **ex):
    exp = tapi.Experiment(task, None, tapi.SafaSpec(),
                          tapi.ExecSpec(eval_every=EVAL_EVERY, **ex),
                          rounds=ROUNDS, device='cpu', init_params=init)
    return exp.compile().run_sweep(members)


def _jax_sweep(task, members, **ex):
    exp = japi.Experiment(task, None, japi.SafaSpec(),
                          japi.ExecSpec(eval_every=EVAL_EVERY, **ex),
                          rounds=ROUNDS)
    return exp.compile().run_sweep(members)


def _assert_equal_tree(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# (a) the fleet schedule
# ---------------------------------------------------------------------------

def test_fleet_schedule_matches_reference():
    def built(pkg):
        return [dataclasses.replace(mem, env=mem.env.build())
                for mem in _members(pkg, 8)]
    js = jfed.precompute_fleet_schedule(built('jax'), rounds=20)
    ts = tfed.precompute_fleet_schedule(built('torch'), rounds=20)
    for k in tfed.FleetSchedule.MASKS:
        np.testing.assert_array_equal(getattr(ts, k), getattr(js, k),
                                      err_msg=k)
    np.testing.assert_array_equal(ts.futility, js.futility)
    assert ts.records == [[tfed.RoundRecord(**dataclasses.asdict(r))
                           for r in rs] for rs in js.records]


def test_fleet_schedule_equals_stacked_singles():
    members = [dataclasses.replace(mem, env=mem.env.build())
               for mem in _members('torch', 8)]
    fleet = tfed.precompute_fleet_schedule(members, rounds=20)
    singles = [tfed.precompute_safa_schedule(
        mem.env.build(), fraction=mem.fraction,
        lag_tolerance=mem.lag_tolerance, rounds=20)
        for mem in _members('torch', 8)]
    stacked = tfed.FleetSchedule.stack(singles)
    for k in tfed.FleetSchedule.MASKS:
        np.testing.assert_array_equal(getattr(fleet, k), getattr(stacked, k))
    np.testing.assert_array_equal(fleet.futility, stacked.futility)
    assert fleet.records == stacked.records
    one = fleet.member(3)
    assert one.records == singles[3].records
    assert one.futility == singles[3].futility


def test_fleet_schedule_on_device_and_segments():
    members = [dataclasses.replace(mem, env=mem.env.build())
               for mem in _members('torch')]
    fleet = tfed.precompute_fleet_schedule(members, rounds=7)
    assert fleet.size == 4 and fleet.rounds == 7
    dev = fleet.to_device('cpu')
    for mask in dev[:5]:
        assert mask.shape == (4, 7, 5) and mask.dtype == torch.bool
    assert dev.round_idx.shape == (4, 7)
    np.testing.assert_array_equal(dev.round_idx[2].numpy(), np.arange(1, 8))
    seg = dev.fleet_segment(2, 5)
    assert seg.picked.shape == (4, 3, 5)
    assert torch.equal(seg.picked, dev.picked[:, 2:5])
    np.testing.assert_array_equal(seg.round_idx[0].numpy(), [3, 4, 5])


def test_stack_rejects_mismatched_rounds():
    def single(rounds):
        return tfed.precompute_safa_schedule(
            TEnvSpec(**BASE).build(), fraction=0.5, lag_tolerance=5,
            rounds=rounds)
    with pytest.raises(ValueError, match='rounds'):
        tfed.FleetSchedule.stack([single(5), single(6)])


# ---------------------------------------------------------------------------
# (b) the fleet kernels' plain versions against the reference's kernels
# ---------------------------------------------------------------------------

S, M, N = 3, 5, 4096


def _fleet_inputs(seed=0):
    rng = np.random.default_rng(seed)
    a = {k: rng.uniform(0.5, 1.5, (S, M, N)).astype(np.float32)
         for k in ('cache', 'trained', 'base')}
    a['global_prev'] = rng.uniform(0.5, 1.5, (S, N)).astype(np.float32)
    a['weights'] = rng.dirichlet(np.ones(M), size=S).astype(np.float32)
    for k in ('picked', 'undrafted', 'deprecated', 'completed'):
        a[k] = rng.random((S, M)) < 0.5
    a['picked'][:, 0] = a['deprecated'][:, 1] = True
    return a


def _t(arr):
    return {k: torch.from_numpy(np.array(v)) for k, v in arr.items()}


AGG = ('cache', 'trained', 'global_prev', 'picked', 'undrafted',
       'deprecated', 'weights')
Q8 = ('base', 'cache', 'global_prev', 'picked', 'undrafted', 'deprecated',
      'completed', 'weights')


def test_aggregate_packed_fleet_matches_reference():
    a = _fleet_inputs()
    jg, jc = j_agg_fleet(*(a[k] for k in AGG))
    t = _t(a)
    cache = t['cache']
    tg, tc = safa_aggregate_packed_fleet(*(t[k] for k in AGG))
    assert tc is cache
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-6)


def test_quantize_packed_fleet_matches_reference():
    x = np.random.default_rng(2).normal(size=(S, M, N)).astype(np.float32)
    jq, js = (np.array(v) for v in j_quant_fleet(x))
    tq, ts = quantize_packed_fleet(torch.from_numpy(x))
    assert tq.shape == (S, M, N) and ts.shape == (S, M, N // 128)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-6)
    same = np.repeat(ts.numpy() == js, 128, axis=-1)
    np.testing.assert_array_equal(tq.numpy()[same], jq[same])
    assert np.abs(tq.numpy().astype(int) - jq.astype(int)).max() <= 1


def test_aggregate_q8_fleet_matches_reference():
    a = _fleet_inputs(seed=4)
    q, s = (np.array(v) for v in j_quant_fleet(a['trained']))
    jg, jc, jl = j_q8_fleet(q, s, *(a[k] for k in Q8))
    t = _t(a)
    cache = t['cache']
    tg, tc, tl = safa_aggregate_packed_q8_fleet(
        torch.from_numpy(q), torch.from_numpy(s), *(t[k] for k in Q8))
    assert tc is cache
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize('kernel', ['packed', 'per_leaf', 'q8', 'quantize'])
def test_fleet_wrapper_equals_single_run_per_member(kernel):
    """On the CPU each fleet wrapper gives every member, bit for bit, what
    the single-run wrapper gives on that member's slices."""
    a = _fleet_inputs(seed=5)
    t = _t(a)
    q, sc = quantize_packed_fleet(t['trained'])
    if kernel == 'quantize':
        for s in range(S):
            qs, ss = quantize_packed(t['trained'][s])
            assert torch.equal(q[s], qs) and torch.equal(sc[s], ss)
        return
    if kernel == 'per_leaf':
        got = safa_aggregate_fleet(*(t[k] for k in AGG))
    elif kernel == 'packed':
        got = safa_aggregate_packed_fleet(*(t[k].clone() for k in AGG))
    else:
        got = safa_aggregate_packed_q8_fleet(q, sc,
                                             *(t[k].clone() for k in Q8))
    for s in range(S):
        one = {k: v[s].clone() for k, v in t.items()}
        if kernel == 'q8':
            want = safa_aggregate_packed_q8(q[s], sc[s],
                                            *(one[k] for k in Q8))
        else:
            want = safa_aggregate_packed(*(one[k] for k in AGG))
        for g, w in zip(got, want):
            assert torch.equal(g[s], w)


def test_fleet_wrappers_check_rank_and_width():
    t = _t(_fleet_inputs())
    with pytest.raises(ValueError, match=r'\[S, m, N\]'):
        safa_aggregate_packed_fleet(*(t[k][0] for k in AGG))
    with pytest.raises(ValueError, match=r'\[m, N\]'):
        safa_aggregate_packed(*(t[k] for k in AGG))
    with pytest.raises(ValueError, match='rank-3'):
        quantize_packed_fleet(t['trained'][0])
    with pytest.raises(ValueError, match='PACK_TILE'):
        quantize_packed_fleet(t['trained'][..., :1000])


def test_tree_fleet_routes_match_per_member_trees():
    """The tree-level fleet routes (per leaf, packed, int8 wire) on a
    small model dict equal the single-run routes member by member."""
    rng = np.random.default_rng(6)
    shapes = {'b': (), 'k': (3, 5, 2), 'w': (40,)}

    def tree(lead):
        return {k: torch.from_numpy(
            rng.uniform(-1, 1, lead + v).astype(np.float32))
            for k, v in shapes.items()}
    cache, trained, base, g = tree((S, M)), tree((S, M)), tree((S, M)), \
        tree((S,))
    masks = {k: torch.from_numpy(rng.random((S, M)) < 0.5)
             for k in ('picked', 'undrafted', 'deprecated', 'completed')}
    w = torch.from_numpy(rng.dirichlet(np.ones(M), size=S).astype(np.float32))
    agg = dict(picked=masks['picked'], undrafted=masks['undrafted'],
               deprecated=masks['deprecated'], weights=w)
    spec = tops.pack_spec({k: v[0] for k, v in g.items()})
    back = tops.unpack_fleet(tops.pack_fleet(cache, spec), spec)
    _assert_equal_tree(back, cache)
    routes = [
        (tops.safa_aggregate_tree_fleet, tops.safa_aggregate_tree, False),
        (tops.safa_aggregate_tree_packed_fleet,
         tops.safa_aggregate_tree_packed, False),
        (tops.safa_compressed_update_fleet, tops.safa_compressed_update,
         True)]
    for fleet_fn, single_fn, wire in routes:
        if wire:
            got = fleet_fn(base, trained, cache, g, completed=masks[
                'completed'], **agg)
        else:
            got = fleet_fn(cache, trained, g, **agg)
        for s in range(S):
            one = {k: v[s] for k, v in agg.items()}
            b, t, c, gm = ({k: v[s] for k, v in x.items()}
                           for x in (base, trained, cache, g))
            want = single_fn(b, t, c, gm, completed=masks['completed'][s],
                             **one) if wire else single_fn(c, t, gm, **one)
            for gt, wt in zip(got, want):
                _assert_equal_tree({k: v[s] for k, v in gt.items()}, wt)


# ---------------------------------------------------------------------------
# (c) whole sweeps against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def sweeps(reg):
    """Memoised sweeps: sweeps(pkg, **exec) -> list of Histories."""
    jt, tt, init = reg
    memo = {}

    def run(pkg, **ex):
        key = (pkg, tuple(sorted(ex.items())))
        if key not in memo:
            memo[key] = _jax_sweep(jt, _members('jax'), **ex) \
                if pkg == 'jax' else \
                _port_sweep(tt, _members('torch'), init, **ex)
        return memo[key]
    return run


@pytest.mark.parametrize('ex', CELLS, ids=CELL_IDS)
def test_sweep_matches_reference(sweeps, ex):
    port, ref = sweeps('torch', **ex), sweeps('jax', **ex)
    atol = 1e-4 if ex.get('wire') == 'int8' else 1e-5
    assert len(port) == len(ref) == 4
    for p, r in zip(port, ref):
        assert _timing(p.records) == _timing(r.records)
        assert p.futility == r.futility
        assert [t for t, _ in p.evals()] == [6, 12]
        np.testing.assert_allclose([e['loss'] for _, e in p.evals()],
                                   [e['loss'] for _, e in r.evals()],
                                   rtol=1e-4)
        for k, v in r.final_global.items():
            np.testing.assert_allclose(p.final_global[k].numpy(),
                                       np.asarray(v), rtol=0, atol=atol,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# (d) inside the port: fleet == sequential == single run, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('ex', CELLS, ids=CELL_IDS)
def test_fleet_equals_sequential_and_single_runs(sweeps, reg, ex):
    _, tt, init = reg
    fleet = sweeps('torch', **ex)
    seq = _port_sweep(tt, _members('torch'), init, engine='sequential', **ex)
    for mem, f, q in zip(_members('torch'), fleet, seq):
        single = tapi.Experiment(
            tt, mem.env, tapi.SafaSpec(fraction=mem.fraction,
                                       lag_tolerance=mem.lag_tolerance),
            tapi.ExecSpec(eval_every=EVAL_EVERY, **ex), rounds=ROUNDS,
            seed=mem.seed, device='cpu', init_params=init).compile().run()
        for other in (q, single):
            _assert_equal_tree(f.final_global, other.final_global)
            assert f.evals() == other.evals()
            assert f.records == other.records
            assert f.futility == other.futility


def test_own_init_fleet_equals_sequential(reg):
    """Without init_params each member starts from the task's own init
    for its seed, once per distinct seed."""
    _, tt, _ = reg
    members = _members('torch')
    members[3] = dataclasses.replace(members[3], seed=0)
    g = tapi.init_fleet_global(tt, [m.seed for m in members])
    _assert_equal_tree({k: v[3] for k, v in g.items()},
                       tt.init_global(0))
    fleet = _port_sweep(tt, members, use_kernel='packed')
    seq = _port_sweep(tt, members, engine='sequential', use_kernel='packed')
    for f, q in zip(fleet, seq):
        _assert_equal_tree(f.final_global, q.final_global)
        assert f.evals() == q.evals()


# ---------------------------------------------------------------------------
# (e) per-member tasks (padded stacking)
# ---------------------------------------------------------------------------

def _per_member(pkg):
    """Two members on different client partitions (env seeds 3 and 4):
    different batch counts, so the padding is in use."""
    cls, mk = (JEnvSpec, jtasks) if pkg == 'jax' else (TEnvSpec, ttasks)
    specs = [cls(**{**BASE, 'seed': s}) for s in (3, 4)]
    x, y = make_regression()
    kw = {} if pkg == 'jax' else {'device': 'cpu'}
    tasks = [mk.regression_task(
        partition(x, y, sp.build().partition_sizes, 5, seed=1), lr=1e-3,
        epochs=3, **kw) for sp in specs]
    cls_m = japi.SweepMember if pkg == 'jax' else tapi.SweepMember
    members = [cls_m(env=sp, fraction=0.5, lag_tolerance=5, seed=i)
               for i, sp in enumerate(specs)]
    assert tasks[0]._x.shape != tasks[1]._x.shape
    spec_cls = japi.SweepSpec if pkg == 'jax' else tapi.SweepSpec
    return spec_cls(members=members, tasks=tasks)


def test_per_member_tasks_match_reference_and_sequential(reg):
    _, _, init = reg
    ref = japi.Experiment(None, None, japi.SafaSpec(),
                          japi.ExecSpec(eval_every=3), rounds=6
                          ).compile().run_sweep(_per_member('jax'))

    def port(engine):
        return tapi.Experiment(
            None, None, tapi.SafaSpec(),
            tapi.ExecSpec(engine=engine, eval_every=3), rounds=6,
            device='cpu', init_params=init
        ).compile().run_sweep(_per_member('torch'))
    fleet, seq = port('fleet'), port('sequential')
    for f, q, r in zip(fleet, seq, ref):
        _assert_equal_tree(f.final_global, q.final_global)
        assert f.evals() == q.evals()
        assert _timing(f.records) == _timing(r.records)
        for k, v in r.final_global.items():
            np.testing.assert_allclose(f.final_global[k].numpy(),
                                       np.asarray(v), rtol=0, atol=1e-5,
                                       err_msg=k)


def test_stack_tasks_validation(reg):
    _, tt, _ = reg
    x, y = make_regression()
    data = partition(x, y, TEnvSpec(**{**BASE, 'seed': 5}).build()
                     .partition_sizes, 5, seed=1)
    with pytest.raises(ValueError, match='epoch'):
        ttasks.stack_tasks([tt, ttasks.regression_task(
            data, lr=1e-3, epochs=2, device='cpu')])
    with pytest.raises(ValueError, match='lr'):
        ttasks.stack_tasks([tt, ttasks.regression_task(
            data, lr=1e-1, epochs=3, device='cpu')])
    with pytest.raises(ValueError, match='empty'):
        ttasks.stack_tasks([])


# ---------------------------------------------------------------------------
# (f) the CNN fleet tracks sequential
# ---------------------------------------------------------------------------

def test_cnn_fleet_tracks_sequential():
    base = TEnvSpec(m=4, crash_prob=0.3, dataset_size=64, batch_size=8,
                    epochs=1, t_lim=830.0, seed=3)
    x, y = make_images(n=64, seed=0)
    data = partition(x, y, base.build().partition_sizes, 8, seed=0)
    task = ttasks.cnn_task(data, lr=1e-3, epochs=1, device='cpu')

    def run(engine, **ex):
        members = [tapi.SweepMember(env=e, fraction=0.5, seed=i)
                   for i, e in enumerate(t_env_grid(base,
                                                    draw_seed=(0, 1)))]
        return tapi.Experiment(
            task, None, tapi.SafaSpec(),
            tapi.ExecSpec(engine=engine, eval_every=3, **ex), rounds=3,
            device='cpu').compile().run_sweep(members)
    for ex in (dict(use_kernel='packed'), dict(wire='int8')):
        for f, q in zip(run('fleet', **ex), run('sequential', **ex)):
            for k, v in q.final_global.items():
                np.testing.assert_allclose(f.final_global[k].numpy(),
                                           v.numpy(), rtol=1e-5, atol=1e-6,
                                           err_msg=k)


# ---------------------------------------------------------------------------
# (g) timing-only sweeps
# ---------------------------------------------------------------------------

def test_timing_only_sweep_matches_single_runs():
    hists = tapi.Experiment(None, None, tapi.SafaSpec(),
                            tapi.ExecSpec(numeric=False), rounds=15,
                            device='cpu').compile().run_sweep(
                                _members('torch'))
    for mem, h in zip(_members('torch'), hists):
        single = tapi.Experiment(
            None, mem.env, tapi.SafaSpec(fraction=mem.fraction,
                                         lag_tolerance=mem.lag_tolerance),
            tapi.ExecSpec(numeric=False), rounds=15,
            device='cpu').compile().run()
        assert h.records == single.records
        assert h.futility == single.futility
        assert h.final_global is None


def test_member_env_overrides():
    """Env-field overrides rewrite a declarative member env before it is
    built: crash_prob=0.7 by override equals an env built at 0.7."""
    over = [tapi.SweepMember(env=TEnvSpec(**BASE), seed=0,
                             overrides={'crash_prob': 0.7})]
    plain = [tapi.SweepMember(env=TEnvSpec(**{**BASE, 'crash_prob': 0.7}),
                              seed=0)]
    exp = tapi.Experiment(None, None, tapi.SafaSpec(),
                          tapi.ExecSpec(numeric=False), rounds=10,
                          device='cpu').compile()
    assert exp.run_sweep(over)[0].records == exp.run_sweep(plain)[0].records


# ---------------------------------------------------------------------------
# (h) validation
# ---------------------------------------------------------------------------

def _runner(task, **ex):
    return tapi.Experiment(task, None, tapi.SafaSpec(), tapi.ExecSpec(**ex),
                           rounds=2, device='cpu').compile()


def test_sweep_validation(reg):
    _, tt, _ = reg
    with pytest.raises(ValueError, match='empty'):
        _runner(tt).run_sweep([])
    bad = _members('torch', 2)
    bad[1] = tapi.SweepMember(env=TEnvSpec(**{**BASE, 'm': 7,
                                              'dataset_size': 700}))
    with pytest.raises(ValueError, match='client count'):
        _runner(tt).run_sweep(bad)
    with pytest.raises(ValueError, match='unknown engine'):
        _runner(tt, engine='warp')
    with pytest.raises(ValueError, match='"fleet" or "sequential"'):
        _runner(tt, engine='scan').run_sweep(_members('torch', 2))
    with pytest.raises(ValueError, match='"scan" or "loop"'):
        tapi.Experiment(tt, TEnvSpec(**BASE), tapi.SafaSpec(),
                        tapi.ExecSpec(engine='fleet'), rounds=2,
                        device='cpu').compile().run()
    with pytest.raises(ValueError, match='numeric sweep needs a Task'):
        _runner(None).run_sweep(_members('torch', 2))
    with pytest.raises(ValueError, match='task'):
        tapi.SweepSpec(members=_members('torch', 1), tasks=(tt, tt))


def test_member_override_messages(reg):
    _, tt, _ = reg
    safa_field = [tapi.SweepMember(env=TEnvSpec(**BASE),
                                   overrides={'scheme': 'seafl'})]
    with pytest.raises(ValueError, match="protocol 'safa' takes env-field "
                                         "overrides only"):
        _runner(tt).run_sweep(safa_field)
    built = [tapi.SweepMember(env=TEnvSpec(**BASE).build(),
                              overrides={'crash_prob': 0.5})]
    with pytest.raises(ValueError, match='declarative member env'):
        _runner(tt).run_sweep(built)


def _assert_resumes(run, path):
    """``run(checkpoint=, max_segments=)`` stopped after one segment and
    resumed ends bit for bit as ``run()``; returns the resumed result."""
    full = run()
    run(checkpoint=path, max_segments=1)
    resumed = run(checkpoint=path)
    for a, b in zip(resumed if isinstance(resumed, list) else [resumed],
                    full if isinstance(full, list) else [full]):
        assert a.evals() == b.evals()
        for k in b.final_global:
            assert torch.equal(a.final_global[k], b.final_global[k]), k
    return resumed


@pytest.mark.parametrize('case', ['checkpoint', 'sparse', 'sparse_tier',
                                  'comm_wire', 'quantize_uploads'])
def test_unported_sweep_cells_raise(reg, case, tmp_path):
    """The name dates from when these sweep cells were refused (ROADMAP
    items 7 and 13).  They run now: a checkpointed fleet sweep resumes
    bit for bit, and members derive their comm model from the wire.
    What stays refused is the reference's: a sweep checkpoint on the
    sequential engine, and a sweep of the per-leaf int8 reference."""
    _, tt, _ = reg
    path = str(tmp_path / 'sweep')
    wired = [tapi.SweepMember(env=TEnvSpec(**BASE), seed=0,
                              overrides={'comm': 'wire'}),
             tapi.SweepMember(env=TEnvSpec(**BASE), seed=1)]
    if case in ('checkpoint', 'sparse'):
        ex = dict(eval_every=1) if case == 'checkpoint' \
            else dict(eval_every=1, schedule='sparse_tier')
        _assert_resumes(lambda **kw: _runner(tt, **ex).run_sweep(
            _members('torch', 2), **kw), path)
        with pytest.raises(ValueError, match="requires engine='fleet'"):
            _runner(tt, engine='sequential', **ex).run_sweep(
                _members('torch', 2), checkpoint=str(tmp_path / 'seq'))
    elif case in ('sparse_tier', 'comm_wire'):
        ex = dict(schedule='sparse_tier', use_kernel='packed') \
            if case == 'sparse_tier' else {}
        hists = {}
        for engine, wire in (('fleet', 'f32'), ('sequential', 'int8'),
                             ('fleet', 'int8')):
            hists[engine, wire] = _runner(tt, engine=engine, wire=wire,
                                          **ex).run_sweep(wired)
            h_wire, h_static = hists[engine, wire]
            assert h_wire.records[0].round_len != \
                h_static.records[0].round_len
        # the int8 wire moves the wired member's comm time alone
        assert hists['sequential', 'int8'][0].records[0].round_len != \
            hists['fleet', 'f32'][0].records[0].round_len
        assert hists['sequential', 'int8'][1].records[0].round_len == \
            hists['fleet', 'f32'][1].records[0].round_len
    else:
        knob = tapi.Experiment(tt, TEnvSpec(**BASE),
                               tapi.SafaSpec(quantize_uploads=True),
                               tapi.ExecSpec(eval_every=1), rounds=2,
                               device='cpu')
        with pytest.raises(ValueError, match='single-run per-leaf'):
            knob.compile().run_sweep(_members('torch', 2), checkpoint=path)
        _assert_resumes(lambda **kw: tapi.Experiment(
            tt, TEnvSpec(**BASE).replace(comm='wire'),
            tapi.SafaSpec(quantize_uploads=True), tapi.ExecSpec(eval_every=1),
            rounds=2, device='cpu').compile().run(**kw), path)

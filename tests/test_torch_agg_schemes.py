"""The staleness-adaptive aggregation family in the port (SEAFL, CSAFL,
the folded FedAsync) against the JAX package on the same seeded inputs.

Tolerances, as for SAFA and the baselines (``test_torch_api.py``,
``test_torch_baselines.py``):

* host precomputes are numpy in both packages: masks, weight rows,
  records and futility equal, ``_fold_sequential`` too;
* the merge kernel's plain version against the JAX kernel (interpret
  mode) within rtol 1e-5 / atol 1e-6: the sum over clients is taken in
  another order;
* whole runs on the quickstart configuration: ``final_global`` within
  atol 1e-5 of the JAX run on the f32 wire, within atol 1e-4 of the JAX
  package's own int8 run on the int8 wire; eval losses within rtol 1e-4;
* inside the port on the CPU, scan == loop and fleet == sequential ==
  single, bit for bit;
* a folded FedAsync member against the port's sequential FedAsync run
  within rtol 2e-5 (atol 1e-7), the JAX package's own tolerance for the
  fold (``tests/test_agg_schemes.py``): the fold is the chain up to
  float rounding.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import agg_schemes as jagg
from repro.data import make_images, make_regression, partition
from repro.data import tasks as jtasks
from repro.fedsim import EnvSpec as JEnvSpec
from repro.fedsim import env_grid as j_env_grid
from repro.fedsim.traces import DayNight as JDayNight
from repro.kernels import ops as jops
from repro_torch import api as tapi
from repro_torch.core import agg_schemes as tagg
from repro_torch.core import protocol as tproto
from repro_torch.core import schedules as tsched
from repro_torch.data import tasks as ttasks
from repro_torch.fedsim import EnvSpec as TEnvSpec
from repro_torch.fedsim import env_grid as t_env_grid
from repro_torch.fedsim.traces import DayNight as TDayNight
from repro_torch.kernels import backend
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

QUICKSTART = dict(m=5, crash_prob=0.3, dataset_size=506, batch_size=5,
                  epochs=3, t_lim=830.0, seed=3)
TRACED = dict(QUICKSTART, m=8, dataset_size=800)
ROUNDS, EVAL_EVERY = 24, 6
SWEEP_ROUNDS = 8
FAMILY = ('seafl', 'csafl')
#: (protocol, exec fields) of every weighted-merge cell of ``run()``
CELLS = [('seafl', {}), ('seafl', {'use_kernel': 'packed'}),
         ('seafl', {'wire': 'int8'}),
         ('seafl', {'use_kernel': 'packed', 'wire': 'int8'}),
         ('csafl', {}), ('csafl', {'use_kernel': 'packed'}),
         ('csafl', {'wire': 'int8'})]
CELL_IDS = ['seafl', 'seafl-packed', 'seafl-int8', 'seafl-packed-int8',
            'csafl', 'csafl-packed', 'csafl-int8']


@pytest.fixture(autouse=True)
def _zero_launches():
    backend.reset_launches()
    yield
    assert all(v == 0 for v in backend.LAUNCHES.values()), \
        'a wrapper launched a kernel on CPU tensors'


@pytest.fixture(scope='module')
def reg():
    """The regression task in both packages, and the reference's init
    for any seed (numpy)."""
    x, y = make_regression()
    data = partition(x, y, JEnvSpec(**QUICKSTART).build().partition_sizes,
                     batch_size=5, seed=1)
    jt = jtasks.regression_task(data, lr=1e-3, epochs=3)
    tt = ttasks.regression_task(data, lr=1e-3, epochs=3, device='cpu')

    def init(seed):
        return {k: np.array(v) for k, v in
                jt.init_global(jax.random.PRNGKey(seed)).items()}
    return jt, tt, init


def _timing(records):
    return [dataclasses.asdict(dataclasses.replace(r, eval=None))
            for r in records]


def _assert_close(port_tree, ref_tree, atol, rtol=0.0):
    for k, v in ref_tree.items():
        np.testing.assert_allclose(port_tree[k].numpy(), np.asarray(v),
                                   rtol=rtol, atol=atol, err_msg=k)


def _assert_equal_tree(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _env(pkg, traced=False):
    spec = (JEnvSpec if pkg == 'jax' else TEnvSpec)(
        **(TRACED if traced else QUICKSTART))
    if traced:
        trace = (JDayNight if pkg == 'jax' else TDayNight)(
            period=4, night_bandwidth=0.3, night_speed=0.5)
        spec = spec.replace(traces=trace)
    return spec.build()


# ---------------------------------------------------------------------------
# (a) host precomputes
# ---------------------------------------------------------------------------

def _assert_schedule_equal(ts, js):
    np.testing.assert_array_equal(ts.committed, js.committed)
    np.testing.assert_array_equal(ts.wrow, js.wrow)
    assert _timing(ts.records) == _timing(js.records)
    assert ts.futility == js.futility


@pytest.mark.parametrize('traced', [False, True], ids=['static', 'traced'])
@pytest.mark.parametrize('fn', tagg.STALENESS_FNS)
@pytest.mark.parametrize('scheme', tagg.WEIGHTED_SCHEMES)
def test_weighted_schedule_matches_reference(scheme, fn, traced):
    kw = dict(rounds=30, scheme=scheme, alpha=0.7, staleness_fn=fn,
              staleness_exp=0.8, hinge_a=2.0, hinge_b=1)
    _assert_schedule_equal(
        tagg.precompute_weighted_schedule(_env('torch', traced), **kw),
        jagg.precompute_weighted_schedule(_env('jax', traced), **kw))


OPTIONS = {'seafl-loss': dict(scheme='seafl', use_loss=True, loss_coef=0.9),
           'csafl-k1': dict(scheme='csafl', clusters=1),
           'csafl-k2': dict(scheme='csafl', clusters=2),
           'csafl-k4': dict(scheme='csafl', clusters=4, alpha=1.0),
           'fedasync-alpha': dict(scheme='fedasync', alpha=0.35)}


@pytest.mark.parametrize('traced', [False, True], ids=['static', 'traced'])
@pytest.mark.parametrize('opt', sorted(OPTIONS))
def test_weighted_schedule_options_match_reference(opt, traced):
    """``use_loss`` and every cluster count, on both envs; each row is
    zero off the committed set and sums to at most alpha (SEAFL, CSAFL)
    or below 1 (the folded FedAsync: 1 - prod(1 - a))."""
    kw = dict(rounds=30, **OPTIONS[opt])
    ts = tagg.precompute_weighted_schedule(_env('torch', traced), **kw)
    _assert_schedule_equal(
        ts, jagg.precompute_weighted_schedule(_env('jax', traced), **kw))
    assert np.all(ts.wrow[~ts.committed] == 0)
    bound = 1.0 if kw['scheme'] == 'fedasync' else kw.get('alpha', 0.6)
    assert np.all(ts.wrow.sum(1) <= bound + 1e-12)


def test_unknown_scheme_refused_with_reference_message():
    msgs = []
    for pkg, agg in (('torch', tagg), ('jax', jagg)):
        with pytest.raises(ValueError) as e:
            agg.precompute_weighted_schedule(_env(pkg), rounds=3,
                                             scheme='gossip')
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize('m', [1, 2, 7, 40])
def test_fold_sequential_matches_reference(m):
    """The fold is numpy float64 in both packages: equal exactly, and its
    residual is the chain's product of (1 - a)."""
    rng = np.random.default_rng(m)
    a = np.where(rng.random(m) < 0.7, rng.random(m) * 0.9, 0.0)
    order = rng.permutation(m)
    got = tagg._fold_sequential(a, order)
    np.testing.assert_array_equal(got, jagg._fold_sequential(a, order))
    np.testing.assert_allclose(1.0 - got.sum(), np.prod(1.0 - a), rtol=0,
                               atol=1e-12)


def _members(pkg, s=4, traced=False):
    """S members over one client population (crash rate x crash stream),
    each with its own hyper columns and scheme: SEAFL, CSAFL with two
    clusters, the folded FedAsync, SEAFL with the loss term and the hinge
    discount."""
    spec = (JEnvSpec if pkg == 'jax' else TEnvSpec)(
        **(TRACED if traced else QUICKSTART))
    if traced:
        spec = spec.replace(traces=(JDayNight if pkg == 'jax' else TDayNight)(
            period=4, night_bandwidth=0.3, night_speed=0.5))
    grid = (j_env_grid if pkg == 'jax' else t_env_grid)(
        spec, crash_prob=(0.3, 0.7), draw_seed=(0, 1))
    cls = japi.SweepMember if pkg == 'jax' else tapi.SweepMember
    hyper = ((0.6, 0.5, None),
             (0.5, 0.8, {'scheme': 'csafl', 'clusters': 2}),
             (0.6, 0.5, {'scheme': 'fedasync'}),
             (0.9, 0.3, {'use_loss': True, 'staleness_fn': 'hinge',
                         'hinge_b': 1}))
    return [cls(env=e, seed=i, alpha=a, staleness_exp=x, overrides=ov)
            for i, (e, (a, x, ov)) in enumerate(zip(grid[:s], hyper))]


def _built(members):
    return [dataclasses.replace(mem, env=mem.env.build()) for mem in members]


@pytest.mark.parametrize('traced', [False, True], ids=['static', 'traced'])
def test_mixed_fleet_schedule_matches_reference_and_singles(traced):
    """The fleet precompute of a mixed-scheme sweep equals the JAX
    package's on the same members, and member s equals its own
    single-run precompute."""
    jfleet = japi.PROTOCOLS[japi.SeaflSpec].fleet_precompute(
        _built(_members('jax', traced=traced)), japi.SeaflSpec(), rounds=20)
    pdef = tapi.PROTOCOLS[tapi.SeaflSpec]
    tfleet = pdef.fleet_precompute(_built(_members('torch', traced=traced)),
                                   tapi.SeaflSpec(), rounds=20)
    assert isinstance(tfleet, tsched.WeightedFleetSchedule)
    for k in tfleet.MASKS:
        np.testing.assert_array_equal(getattr(tfleet, k), getattr(jfleet, k),
                                      err_msg=k)
    np.testing.assert_array_equal(tfleet.futility, jfleet.futility)
    assert [_timing(r) for r in tfleet.records] == \
        [_timing(r) for r in jfleet.records]
    for s, mem in enumerate(_members('torch', traced=traced)):
        single = tagg.precompute_weighted_schedule(
            mem.env.build(), rounds=20,
            **tagg.weighted_kwargs(tapi.SeaflSpec(), mem))
        one = tfleet.member(s)
        for k in tfleet.MASKS:
            np.testing.assert_array_equal(getattr(one, k),
                                          getattr(single, k), err_msg=k)
        assert one.records == single.records


@pytest.mark.parametrize('case', ['columns', 'scheme', 'unknown'])
def test_weighted_kwargs_match_reference(case):
    """Member columns win over the spec, an override switches the scheme,
    and an unknown key is refused with the reference's message."""
    ov = {'columns': None, 'scheme': {'scheme': 'fedasync', 'hinge_b': 2},
          'unknown': {'bogus': 1}}[case]
    out = []
    for api_ in (tapi, japi):
        mem = api_.SweepMember(env=None, alpha=0.3, staleness_exp=1.5,
                               overrides=ov)
        agg = tagg if api_ is tapi else jagg
        try:
            out.append(agg.weighted_kwargs(api_.CsaflSpec(clusters=3), mem))
        except ValueError as e:
            out.append(str(e))
    assert out[0] == out[1]
    if case == 'unknown':
        assert 'bogus' in out[0]


def test_weighted_schedule_on_device_and_segments():
    fleet = tsched.WeightedFleetSchedule.stack([
        tagg.precompute_weighted_schedule(_env('torch'), rounds=7,
                                          scheme=scheme)
        for scheme in tagg.WEIGHTED_SCHEMES])
    assert fleet.size == 3 and fleet.rounds == 7
    dev = fleet.to_device('cpu')
    assert isinstance(dev, tproto.WeightedSchedule)
    assert dev.wrow.dtype == torch.float32 and dev.wrow.shape == (3, 7, 5)
    assert dev.committed.dtype == torch.bool
    seg = dev.fleet_segment(2, 5)
    assert torch.equal(seg.wrow, dev.wrow[:, 2:5])
    np.testing.assert_array_equal(seg.round_idx[1].numpy(), [3, 4, 5])
    one = fleet.member(1).to_device('cpu').segment(1, 4)
    assert torch.equal(one.wrow, torch.as_tensor(fleet.wrow[1, 1:4],
                                                 dtype=torch.float32))
    np.testing.assert_array_equal(one.round_idx.numpy(), [2, 3, 4])


# ---------------------------------------------------------------------------
# (b) the merge kernel's plain version (kernel 10) against the JAX kernel
# ---------------------------------------------------------------------------

S, M, N = 3, 5, 4096


def _wrow(rng, lead, m, case):
    """Weight rows zero off a seeded commit mask and summing to 0.6;
    ``case`` 'zero' zeroes the whole row, 'one' keeps a single commit."""
    w = rng.random(lead + (m,)) * (rng.random(lead + (m,)) < 0.7)
    if case == 'zero':
        w[...] = 0.0
    elif case == 'one':
        w[...] = 0.0
        w[..., m // 2] = 0.6
    tot = w.sum(-1, keepdims=True)
    return np.where(tot > 0, 0.6 * w / np.where(tot > 0, tot, 1.0),
                    0.0).astype(np.float32)


@pytest.mark.parametrize('case', ['seeded', 'zero', 'one'])
@pytest.mark.parametrize('m,n', [(M, N), (300, 2048)])
def test_weighted_merge_packed_matches_reference(m, n, case):
    rng = np.random.default_rng(m + n)
    t = rng.normal(size=(m, n)).astype(np.float32)
    g = rng.normal(size=(n,)).astype(np.float32)
    w = _wrow(rng, (), m, case)
    want = np.array(jops.weighted_merge_packed(t, g, w))
    got = tops.weighted_merge_packed(*map(torch.from_numpy, (t, g, w)))
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    if case == 'zero':
        np.testing.assert_array_equal(got.numpy(), g)


def test_weighted_merge_packed_fleet_matches_reference_per_member():
    rng = np.random.default_rng(7)
    t = rng.normal(size=(S, M, N)).astype(np.float32)
    g = rng.normal(size=(S, N)).astype(np.float32)
    w = _wrow(rng, (S,), M, 'seeded')
    w[1] = 0.0                            # a member with no commit
    tt, tg, tw = map(torch.from_numpy, (t, g, w))
    got = tops.weighted_merge_packed_fleet(tt, tg, tw)
    assert got.shape == (S, N)
    torch.testing.assert_close(got, tref.weighted_merge_ref(tt, tg, tw),
                               rtol=0, atol=0)
    for s in range(S):
        want = np.array(jops.weighted_merge_packed(t[s], g[s], w[s]))
        np.testing.assert_allclose(got[s].numpy(), want, rtol=1e-5,
                                   atol=1e-6)
        assert torch.equal(got[s], tops.weighted_merge_packed(tt[s], tg[s],
                                                              tw[s]))


def _model(rng, lead=()):
    return {'b': rng.normal(size=lead + (13,)).astype(np.float32),
            'w': rng.normal(size=lead + (13, 70)).astype(np.float32)}


def test_weighted_merge_tree_matches_reference_and_fleet_per_member():
    """Pack -> merge -> unpack on a model dict: within rtol 1e-5 of the
    JAX package's tree merge, and the fleet form equal to the single form
    on every member."""
    rng = np.random.default_rng(8)
    trained, glob = _model(rng, (S, M)), _model(rng, (S,))
    w = _wrow(rng, (S,), M, 'seeded')
    ttr = {k: torch.from_numpy(v) for k, v in trained.items()}
    tgl = {k: torch.from_numpy(v) for k, v in glob.items()}
    fleet = tops.weighted_merge_tree_packed_fleet(ttr, tgl,
                                                  wrow=torch.from_numpy(w))
    for s in range(S):
        member = {k: v[s] for k, v in trained.items()}
        want = jops.weighted_merge_tree_packed(
            member, {k: v[s] for k, v in glob.items()}, wrow=w[s])
        got = tops.weighted_merge_tree_packed(
            {k: v[s] for k, v in ttr.items()},
            {k: v[s] for k, v in tgl.items()}, wrow=torch.from_numpy(w[s]))
        _assert_close(got, want, atol=1e-6, rtol=1e-5)
        _assert_equal_tree({k: v[s] for k, v in fleet.items()}, got)
        # the plain merge of the protocol takes another summation order
        plain = tproto.weighted_merge(
            {k: v[s] for k, v in tgl.items()},
            {k: v[s] for k, v in ttr.items()}, wrow=torch.from_numpy(w[s]))
        _assert_close(plain, want, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize('case', ['rank', 'fleet-rank', 'width'])
def test_weighted_merge_rejects_bad_operands(case):
    t, g, w = torch.zeros(M, N), torch.zeros(N), torch.zeros(M)
    with pytest.raises(ValueError, match={'rank': r'\[m, N\]',
                                          'fleet-rank': r'\[S, m, N\]',
                                          'width': 'PACK_TILE'}[case]):
        if case == 'rank':
            tops.weighted_merge_packed(t[None], g[None], w[None])
        elif case == 'fleet-rank':
            tops.weighted_merge_packed_fleet(t, g, w)
        else:
            tops.weighted_merge_packed(t[:, :1000], g[:1000], w)


# ---------------------------------------------------------------------------
# (c) whole runs against the reference, and scan == loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def runs(reg):
    """Memoised quickstart runs: runs(pkg, name, **exec) -> History."""
    jt, tt, init = reg
    memo = {}

    def run(pkg, name, **ex):
        key = (pkg, name, tuple(sorted(ex.items())))
        if key not in memo:
            if pkg == 'jax':
                exp = japi.Experiment(
                    jt, JEnvSpec(**QUICKSTART), japi.spec(name),
                    japi.ExecSpec(eval_every=EVAL_EVERY, **ex),
                    rounds=ROUNDS)
            else:
                exp = tapi.Experiment(
                    tt, TEnvSpec(**QUICKSTART), tapi.spec(name),
                    tapi.ExecSpec(eval_every=EVAL_EVERY, **ex),
                    rounds=ROUNDS, device='cpu', init_params=init(0))
            memo[key] = exp.compile().run()
        return memo[key]
    return run


@pytest.mark.parametrize('engine', ['scan', 'loop'])
@pytest.mark.parametrize('name,ex', CELLS, ids=CELL_IDS)
def test_run_matches_reference(runs, name, ex, engine):
    """f32 within atol 1e-5 of the JAX run (kernel or not: the JAX
    package's own packed and plain merges differ by float rounding);
    int8 within atol 1e-4 of the JAX int8 run; the same timing records
    and eval rounds."""
    port = runs('torch', name, engine=engine, **ex)
    ref = runs('jax', name, **ex)
    assert port.protocol == ref.protocol == name
    assert [r for r, _ in port.evals()] == [6, 12, 18, 24]
    assert _timing(port.records) == _timing(ref.records)
    assert port.futility == ref.futility
    np.testing.assert_allclose([e['loss'] for _, e in port.evals()],
                               [e['loss'] for _, e in ref.evals()],
                               rtol=1e-4)
    _assert_close(port.final_global, ref.final_global,
                  atol=1e-4 if ex.get('wire') == 'int8' else 1e-5)


@pytest.mark.parametrize('name', FAMILY)
def test_int8_is_not_f32(runs, name):
    """The int8 wire moves the model by more than the int8 tolerance, so
    the int8 parity above could not pass on an f32 run."""
    f32, q8 = runs('torch', name), runs('torch', name, wire='int8')
    gap = max((f32.final_global[k] - q8.final_global[k]).abs().max().item()
              for k in f32.final_global)
    assert gap > 1e-4


@pytest.mark.parametrize('name,ex', CELLS, ids=CELL_IDS)
def test_scan_equals_loop_bitwise(runs, name, ex):
    scan, loop = runs('torch', name, **ex), runs('torch', name,
                                                  engine='loop', **ex)
    assert [e for _, e in scan.evals()] == [e for _, e in loop.evals()]
    _assert_equal_tree(scan.final_global, loop.final_global)


def test_packed_merge_launches_no_kernel_on_the_cpu(runs):
    """On CPU tensors the packed route runs the plain version (the
    autouse fixture holds every launch counter at 0) and agrees with the
    plain merge within float rounding."""
    packed = runs('torch', 'csafl', use_kernel='packed')
    plain = runs('torch', 'csafl')
    for k, v in plain.final_global.items():
        torch.testing.assert_close(packed.final_global[k], v, rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize('name,ex', [('seafl', {'use_kernel': 'packed'}),
                                     ('csafl', {'wire': 'int8'})],
                         ids=['seafl-packed', 'csafl-int8'])
def test_cnn_through_api_matches_reference(name, ex):
    """Task 2's CNN at m = 4 for 2 rounds through both APIs."""
    spec = dict(m=4, crash_prob=0.3, dataset_size=96, batch_size=8, epochs=1,
                t_lim=5600.0, seed=0)
    x, y = make_images(n=96)
    data = partition(x, y, JEnvSpec(**spec).build().partition_sizes, 8)
    jt = jtasks.cnn_task(data, lr=1e-3, epochs=1)
    tt = ttasks.cnn_task(data, lr=1e-3, epochs=1, device='cpu')
    init = {k: np.array(v) for k, v in
            jt.init_global(jax.random.PRNGKey(0)).items()}
    ref = japi.Experiment(jt, JEnvSpec(**spec), japi.spec(name),
                          japi.ExecSpec(eval_every=1, **ex),
                          rounds=2).compile().run()
    port = tapi.Experiment(tt, TEnvSpec(**spec), tapi.spec(name),
                           tapi.ExecSpec(eval_every=1, **ex), rounds=2,
                           device='cpu', init_params=init).compile().run()
    np.testing.assert_allclose([e['loss'] for _, e in port.evals()],
                               [e['loss'] for _, e in ref.evals()],
                               rtol=1e-4)
    for k, v in ref.final_global.items():
        np.testing.assert_allclose(port.final_global[k].numpy(),
                                   np.asarray(v), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# (d) sweeps: against the reference, fleet == sequential == single, and
#     the folded FedAsync against the sequential FedAsync engine
# ---------------------------------------------------------------------------

def _port_sweep(tt, init, members, spec=None, **ex):
    return tapi.Experiment(
        tt, None, spec if spec is not None else tapi.SeaflSpec(),
        tapi.ExecSpec(eval_every=EVAL_EVERY, **ex), rounds=SWEEP_ROUNDS,
        device='cpu', init_params=init).compile().run_sweep(members)


SWEEP_CELLS = [{}, {'use_kernel': 'packed'}, {'wire': 'int8'}]
SWEEP_IDS = ['plain', 'packed', 'int8']


@pytest.mark.parametrize('ex', SWEEP_CELLS, ids=SWEEP_IDS)
def test_mixed_sweep_matches_reference(reg, ex):
    jt, tt, init = reg
    ref = japi.Experiment(
        jt, None, japi.SeaflSpec(),
        japi.ExecSpec(eval_every=EVAL_EVERY, **ex),
        rounds=SWEEP_ROUNDS).compile().run_sweep(_members('jax'))
    port = _port_sweep(tt, init, _members('torch'), **ex)
    for p, r in zip(port, ref):
        assert p.protocol == r.protocol == 'seafl'
        assert _timing(p.records) == _timing(r.records)
        _assert_close(p.final_global, r.final_global,
                      atol=1e-4 if ex.get('wire') == 'int8' else 1e-5)


def _single_spec(mem):
    """The single-run spec of a sweep member, where one exists (the
    folded FedAsync has none)."""
    ov = dict(mem.overrides or {})
    scheme = ov.pop('scheme', 'seafl')
    if scheme == 'fedasync':
        return None
    cls = tapi.CsaflSpec if scheme == 'csafl' else tapi.SeaflSpec
    return cls(alpha=mem.alpha, staleness_exp=mem.staleness_exp, **ov)


@pytest.mark.parametrize('ex', SWEEP_CELLS, ids=SWEEP_IDS)
def test_fleet_equals_sequential_equals_single(reg, ex):
    """A mixed-scheme fleet, member by member, bit for bit: the fleet
    engine, the sequential engine and a single ``run()`` of the member's
    spec (for the folded FedAsync member, a sweep of that member alone)."""
    _, tt, init = reg
    fleet = _port_sweep(tt, init, _members('torch'), **ex)
    seq = _port_sweep(tt, init, _members('torch'), engine='sequential', **ex)
    for s, mem in enumerate(_members('torch')):
        spec = _single_spec(mem)
        if spec is None:
            single, = _port_sweep(tt, init, [mem], **ex)
        else:
            single = tapi.Experiment(
                tt, mem.env, spec, tapi.ExecSpec(eval_every=EVAL_EVERY, **ex),
                rounds=SWEEP_ROUNDS, seed=mem.seed, device='cpu',
                init_params=init).compile().run()
        for h in (fleet[s], seq[s]):
            assert h.records == single.records
            _assert_equal_tree(h.final_global, single.final_global)


def test_folded_fedasync_matches_sequential_fedasync(reg):
    """A FedAsync member folded into the weighted engine reproduces the
    port's sequential arrival-ordered FedAsync merges to float tolerance,
    on the same events."""
    _, tt, init = reg
    seq = tapi.Experiment(tt, TEnvSpec(**QUICKSTART), tapi.FedAsyncSpec(),
                          tapi.ExecSpec(eval_every=EVAL_EVERY),
                          rounds=ROUNDS, device='cpu',
                          init_params=init).compile().run()
    mem = tapi.SweepMember(env=TEnvSpec(**QUICKSTART), seed=0, alpha=0.6,
                           staleness_exp=0.5,
                           overrides={'scheme': 'fedasync'})
    folded, = tapi.Experiment(
        tt, None, tapi.SeaflSpec(), tapi.ExecSpec(eval_every=EVAL_EVERY),
        rounds=ROUNDS, device='cpu', init_params=init).compile().run_sweep(
            [mem])
    assert _timing(folded.records) == _timing(seq.records)
    np.testing.assert_allclose([e['loss'] for _, e in folded.evals()],
                               [e['loss'] for _, e in seq.evals()],
                               rtol=2e-5)
    for k, v in seq.final_global.items():
        np.testing.assert_allclose(folded.final_global[k].numpy(), v.numpy(),
                                   rtol=2e-5, atol=1e-7, err_msg=k)


def test_per_member_tasks_fleet_equals_sequential():
    """A weighted sweep with per-member tasks (padded stacking): the
    fleet's train context rides through the weighted engine."""
    x, y = make_regression()
    specs = [TEnvSpec(**QUICKSTART), TEnvSpec(**{**QUICKSTART,
                                                  'dataset_size': 400})]
    tasks = tuple(ttasks.regression_task(
        partition(x, y, sp.build().partition_sizes, 5, seed=1), lr=1e-3,
        epochs=3, device='cpu') for sp in specs)
    members = [tapi.SweepMember(env=sp, seed=i,
                                overrides={'scheme': 'csafl'} if i else None)
               for i, sp in enumerate(specs)]

    def run(engine):
        return tapi.Experiment(
            None, None, tapi.SeaflSpec(),
            tapi.ExecSpec(engine=engine, eval_every=3,
                          use_kernel='packed'),
            rounds=6, device='cpu').compile().run_sweep(
                tapi.SweepSpec(members, tasks=tasks))
    for f, q in zip(run('fleet'), run('sequential')):
        _assert_equal_tree(f.final_global, q.final_global)


@pytest.mark.parametrize('name', FAMILY)
def test_timing_only_sweep_matches_reference_and_single_runs(name):
    hists = tapi.Experiment(None, None, tapi.spec(name),
                            tapi.ExecSpec(numeric=False), rounds=15,
                            device='cpu').compile().run_sweep(
                                _members('torch'))
    ref = japi.Experiment(None, None, japi.spec(name),
                          japi.ExecSpec(numeric=False),
                          rounds=15).compile().run_sweep(_members('jax'))
    for mem, h, r in zip(_members('torch'), hists, ref):
        assert h.protocol == name and h.final_global is None
        assert _timing(h.records) == _timing(r.records)
        assert h.futility == r.futility
        spec = _single_spec(mem)
        if spec is not None and name == 'seafl':
            single = tapi.Experiment(None, mem.env, spec,
                                     tapi.ExecSpec(numeric=False), rounds=15,
                                     seed=mem.seed, device='cpu').compile()
            assert h.records == single.run().records


# ---------------------------------------------------------------------------
# (e) registry, check_compat and the facade against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('name', FAMILY)
def test_registered_like_the_reference(name):
    port = next(p for p in tapi.PROTOCOLS.values() if p.name == name)
    ref = next(p for p in japi.PROTOCOLS.values() if p.name == name)
    assert port.spec_cls is getattr(tapi, ref.spec_cls.__name__)
    assert (port.supports_wire, port.supports_kernel, port.spec_overrides,
            port.uses_cache) == (True, 'packed', True, False) == \
        (ref.supports_wire, ref.supports_kernel, ref.spec_overrides,
         ref.uses_cache)
    assert port.sparse_forms == () and ref.sparse_precompute is None
    assert tapi.spec(name, alpha=0.5) == port.spec_cls(alpha=0.5)


#: (id, spec name, spec fields, exec fields) of each refusal
REFUSALS = [
    ('seafl-kernel-true', 'seafl', {}, dict(use_kernel=True)),
    ('csafl-kernel-true', 'csafl', {}, dict(use_kernel=True)),
    ('csafl-clusters-zero', 'csafl', dict(clusters=0), {}),
    ('seafl-alpha-above-one', 'seafl', dict(alpha=1.5), {}),
    ('csafl-hinge-a', 'csafl', dict(hinge_a=0.0), {}),
    ('seafl-staleness-fn', 'seafl', dict(staleness_fn='exp'), {}),
    ('seafl-sparse', 'seafl', {}, dict(schedule='sparse')),
    ('csafl-tier', 'csafl', {}, dict(schedule='sparse_tier')),
    ('seafl-wire-value', 'seafl', {}, dict(wire='int4')),
]


@pytest.mark.parametrize('name,fields,ex', [r[1:] for r in REFUSALS],
                         ids=[r[0] for r in REFUSALS])
def test_refusal_messages_equal_reference(name, fields, ex):
    msgs = []
    for api_ in (tapi, japi):
        with pytest.raises(ValueError) as e:
            api_.check_compat(api_.spec(name, **fields), api_.ExecSpec(**ex))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize('name,ex', [
    ('seafl', dict(use_kernel='packed', wire='int8')),
    ('csafl', dict(use_kernel='packed')), ('csafl', {})],
    ids=['seafl-packed-int8', 'csafl-packed', 'csafl'])
def test_valid_cells_pass(name, ex):
    assert tapi.check_compat(tapi.spec(name, clusters=5)
                             if name == 'csafl' else tapi.spec(name),
                             tapi.ExecSpec(**ex)).name == name


@pytest.mark.parametrize('export', [
    'CsaflSpec', 'SeaflSpec', 'WEIGHTED_SCHEMES', 'STALENESS_FNS',
    'precompute_weighted_schedule', 'staleness_discount',
    'init_fleet_global'])
def test_facade_exports(export):
    assert export in tapi.__all__ and hasattr(japi, export)
    got = getattr(tapi, export)
    if export in ('WEIGHTED_SCHEMES', 'STALENESS_FNS'):
        assert got == getattr(japi, export)
    elif export.endswith('Spec'):
        assert [(f.name, f.default) for f in dataclasses.fields(got)] == \
            [(f.name, f.default)
             for f in dataclasses.fields(getattr(japi, export))]
    else:
        assert callable(got)


@pytest.mark.parametrize('fn', tagg.STALENESS_FNS)
def test_staleness_discount_matches_reference(fn):
    dt = np.arange(0, 12, dtype=float)
    kw = dict(staleness_exp=0.7, hinge_a=0.3, hinge_b=2)
    np.testing.assert_array_equal(tapi.staleness_discount(dt, fn, **kw),
                                  japi.staleness_discount(dt, fn, **kw))

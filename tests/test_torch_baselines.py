"""The paper's baselines in the port (FedAvg, FedCS, fully-local,
FedAsync) against the JAX package on the same seeded inputs, and the
port's registry and ``check_compat`` against the JAX package's.

Tolerances, as for SAFA (``test_torch_api.py``, ``test_torch_fleet.py``):

* schedules are host numpy in both packages: masks, merge orders,
  alphas, records and futility equal;
* ``dequantize_packed`` is one f32 multiply per value: the port's plain
  version equals the JAX kernel (interpret mode) exactly;
* whole runs on the quickstart configuration: ``final_global`` within
  atol 1e-5 of the JAX run on the f32 wire; on the int8 wire within atol
  1e-4 of the JAX package's own int8 run (a one-ulp move of an int8 scale
  moves a model by ~4e-6, while int8 and f32 differ by ~5e-3);
* inside the port on the CPU, scan == loop and fleet == sequential ==
  a single ``run()`` per member, bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import agg_schemes as jagg
from repro.core import federation as jfed
from repro.data import make_images, make_regression, partition
from repro.data import tasks as jtasks
from repro.fedsim import EnvSpec as JEnvSpec
from repro.fedsim import env_grid as j_env_grid
from repro.fedsim.traces import DayNight as JDayNight
from repro.kernels import ops as jops
from repro.kernels.comm_quant import dequantize_packed as j_dequant
from repro.kernels.comm_quant import quantize_packed as j_quant
from repro_torch import api as tapi
from repro_torch.core import agg_schemes as tagg
from repro_torch.core import federation as tfed
from repro_torch.core import schedules as tsched
from repro_torch.data import tasks as ttasks
from repro_torch.fedsim import EnvSpec as TEnvSpec
from repro_torch.fedsim import env_grid as t_env_grid
from repro_torch.fedsim.traces import DayNight as TDayNight
from repro_torch.kernels import backend
from repro_torch.kernels import ops as tops
from repro_torch.kernels.comm_quant import (dequantize_packed,
                                            dequantize_packed_fleet,
                                            quantize_packed,
                                            quantize_packed_fleet)

QUICKSTART = dict(m=5, crash_prob=0.3, dataset_size=506, batch_size=5,
                  epochs=3, t_lim=830.0, seed=3)
ROUNDS, EVAL_EVERY = 24, 6
SWEEP_ROUNDS = 8
BASELINES = ('fedavg', 'fedcs', 'local', 'fedasync')
#: (protocol, exec fields) of every ported baseline cell
CELLS = [('fedavg', {}), ('fedavg', {'wire': 'int8'}), ('fedcs', {}),
         ('fedcs', {'wire': 'int8'}), ('local', {}), ('fedasync', {})]
CELL_IDS = ['fedavg', 'fedavg-int8', 'fedcs', 'fedcs-int8', 'local',
            'fedasync']


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


def _assert_close(port_tree, ref_tree, atol):
    for k, v in ref_tree.items():
        np.testing.assert_allclose(port_tree[k].numpy(), np.asarray(v),
                                   rtol=0, atol=atol, err_msg=k)


def _assert_equal_tree(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------
# (a) host schedules
# ---------------------------------------------------------------------------

TRACED = dict(QUICKSTART, m=8, dataset_size=800)


def _env(pkg, traced=False):
    spec = (JEnvSpec if pkg == 'jax' else TEnvSpec)(
        **(TRACED if traced else QUICKSTART))
    if traced:
        trace = (JDayNight if pkg == 'jax' else TDayNight)(
            period=4, night_bandwidth=0.3, night_speed=0.5)
        spec = spec.replace(traces=trace)
    return spec.build()


@pytest.mark.parametrize('traced', [False, True], ids=['static', 'traced'])
@pytest.mark.parametrize('fedcs,sampler', [(False, 'choice'),
                                           (False, 'topk'), (True, 'choice')],
                         ids=['fedavg-choice', 'fedavg-topk', 'fedcs'])
def test_sync_schedule_matches_reference(fedcs, sampler, traced):
    kw = dict(fraction=0.4, rounds=30, seed=2, fedcs=fedcs, sampler=sampler)
    js = jfed.precompute_sync_schedule(_env('jax', traced), **kw)
    ts = tfed.precompute_sync_schedule(_env('torch', traced), **kw)
    np.testing.assert_array_equal(ts.selected, js.selected)
    np.testing.assert_array_equal(ts.completed, js.completed)
    assert _timing(ts.records) == _timing(js.records)
    assert ts.futility == js.futility


@pytest.mark.parametrize('traced', [False, True], ids=['static', 'traced'])
def test_local_schedule_matches_reference(traced):
    kw = dict(fraction=0.4, rounds=30, seed=2)
    js = jfed.precompute_local_schedule(_env('jax', traced), **kw)
    ts = tfed.precompute_local_schedule(_env('torch', traced), **kw)
    np.testing.assert_array_equal(ts.completed, js.completed)
    assert _timing(ts.records) == _timing(js.records)
    assert ts.futility == js.futility


@pytest.mark.parametrize('fn', tagg.STALENESS_FNS)
def test_async_schedule_matches_reference(fn):
    kw = dict(rounds=30, alpha=0.7, staleness_fn=fn, staleness_exp=0.8,
              hinge_a=2.0, hinge_b=1)
    js = jagg.precompute_async_schedule(_env('jax', True), **kw)
    ts = tagg.precompute_async_schedule(_env('torch', True), **kw)
    for k in ('committed', 'order', 'alphas'):
        np.testing.assert_array_equal(getattr(ts, k), getattr(js, k),
                                      err_msg=k)
    assert _timing(ts.records) == _timing(js.records)
    assert ts.futility == js.futility
    assert tagg.STALENESS_FNS == japi.STALENESS_FNS == tapi.STALENESS_FNS


def _members(pkg, s=4, traced=False):
    """S members sharing one client population: crash rate x crash
    stream, each with its own fraction, FedAsync hypers and seed."""
    spec = (JEnvSpec if pkg == 'jax' else TEnvSpec)(
        **(TRACED if traced else QUICKSTART))
    if traced:
        spec = spec.replace(traces=(JDayNight if pkg == 'jax' else TDayNight)(
            period=4, night_bandwidth=0.3, night_speed=0.5))
    grid = (j_env_grid if pkg == 'jax' else t_env_grid)(
        spec, crash_prob=(0.3, 0.7), draw_seed=(0, 1))
    cls = japi.SweepMember if pkg == 'jax' else tapi.SweepMember
    hyper = ((0.5, 0.6, 0.5), (0.3, 0.3, 1.0), (1.0, 0.9, 0.2),
             (0.1, 0.6, 0.5))
    return [cls(env=e, fraction=f, seed=i, alpha=a, staleness_exp=x)
            for i, (e, (f, a, x)) in enumerate(zip(grid[:s], hyper))]


def _built(members):
    return [dataclasses.replace(mem, env=mem.env.build()) for mem in members]


@pytest.mark.parametrize('traced', [False, True], ids=['static', 'traced'])
@pytest.mark.parametrize('name', BASELINES)
def test_fleet_schedule_matches_reference_and_singles(name, traced):
    """Each protocol's fleet precompute equals the JAX package's on the
    same members, and member s equals its own single-run precompute."""
    jfleet = japi.PROTOCOLS[type(japi.spec(name))].fleet_precompute(
        _built(_members('jax', traced=traced)), japi.spec(name),
        rounds=20)
    pdef = tapi.PROTOCOLS[type(tapi.spec(name))]
    tfleet = pdef.fleet_precompute(_built(_members('torch', traced=traced)),
                                   tapi.spec(name), rounds=20)
    for k in tfleet.MASKS:
        np.testing.assert_array_equal(getattr(tfleet, k), getattr(jfleet, k),
                                      err_msg=k)
    np.testing.assert_array_equal(tfleet.futility, jfleet.futility)
    assert [_timing(r) for r in tfleet.records] == \
        [_timing(r) for r in jfleet.records]
    for s, mem in enumerate(_members('torch', traced=traced)):
        spec = _member_spec(name, mem)
        single = pdef.precompute(mem.env.build(), spec, rounds=20,
                                 seed=mem.seed)
        one = tfleet.member(s)
        for k in tfleet.MASKS:
            np.testing.assert_array_equal(getattr(one, k),
                                          getattr(single, k), err_msg=k)
        assert one.records == single.records
        assert one.futility == single.futility


def test_fleet_schedule_on_device_and_segments():
    fleet = tfed.precompute_sync_fleet_schedule(
        _built(_members('torch')), rounds=7, fedcs=False)
    assert fleet.size == 4 and fleet.rounds == 7
    dev = fleet.to_device('cpu')
    assert dev.selected.shape == (4, 7, 5) and dev.selected.dtype == torch.bool
    seg = dev.fleet_segment(2, 5)
    assert torch.equal(seg.completed, dev.completed[:, 2:5])
    np.testing.assert_array_equal(seg.round_idx[1].numpy(), [3, 4, 5])
    one = tsched.AsyncFleetSchedule.stack([
        tagg.precompute_async_schedule(_env('torch'), rounds=7)]).to_device(
            'cpu')
    assert one.alphas.dtype == torch.float32 and one.order.shape == (1, 7, 5)


# ---------------------------------------------------------------------------
# (b) the int8 wire's dequantisation (kernel 4) and round trip
# ---------------------------------------------------------------------------

S, M, N = 3, 5, 4096


def test_dequantize_packed_matches_reference():
    x = np.random.default_rng(0).normal(size=(M, N)).astype(np.float32)
    x[1, :128] = 0.0                      # an all-zero block
    q, s = (np.array(v) for v in j_quant(x))
    want = np.array(j_dequant(q, s))
    got = dequantize_packed(torch.from_numpy(q), torch.from_numpy(s))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dequantize_packed_fleet_matches_reference_per_member():
    x = np.random.default_rng(1).normal(size=(S, M, N)).astype(np.float32)
    tq, ts = quantize_packed_fleet(torch.from_numpy(x))
    got = dequantize_packed_fleet(tq, ts)
    assert got.shape == (S, M, N)
    for s in range(S):
        want = np.array(j_dequant(tq[s].numpy(), ts[s].numpy()))
        np.testing.assert_array_equal(got[s].numpy(), want)
        assert torch.equal(got[s], dequantize_packed(tq[s], ts[s]))


def test_dequantize_rejects_bad_operands():
    q = torch.zeros(M, N, dtype=torch.int8)
    s = torch.ones(M, N // 128)
    with pytest.raises(ValueError, match='rank-3'):
        dequantize_packed_fleet(q, s)
    with pytest.raises(ValueError, match='rank-2'):
        dequantize_packed(q[None], s[None])
    with pytest.raises(ValueError, match='PACK_TILE'):
        dequantize_packed(q[:, :1024], s[:, :8])


def _model(rng, lead=()):
    return {'b': rng.normal(size=lead + (13,)).astype(np.float32),
            'w': rng.normal(size=lead + (13, 70)).astype(np.float32)}


def test_wire_roundtrip_matches_reference():
    """pack -> quantise -> dequantise -> unpack: within one quantisation
    step of the JAX package's round trip (the two packages' scales may
    differ by an ulp, and q by one there), and exactly the port's own
    quantise-then-dequantise on the wire layout."""
    rng = np.random.default_rng(2)
    tree = _model(rng, (M,))
    want = jops.wire_roundtrip_packed(tree)
    got = tops.wire_roundtrip_packed({k: torch.from_numpy(v)
                                      for k, v in tree.items()})
    for k, v in tree.items():
        step = np.abs(v).max() / 127
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=step, err_msg=k)
        assert got[k].shape == v.shape
    spec = tops.wire_spec({k: torch.from_numpy(v[0]) for k, v in tree.items()})
    q, s = quantize_packed(tops.pack_stacked(
        {k: torch.from_numpy(v) for k, v in tree.items()}, spec))
    _assert_equal_tree(got, tops.unpack_stacked(dequantize_packed(q, s),
                                                spec))


def test_wire_roundtrip_fleet_equals_single_per_member():
    rng = np.random.default_rng(3)
    tree = {k: torch.from_numpy(v) for k, v in _model(rng, (S, M)).items()}
    glob = {k: v[:, 0] for k, v in tree.items()}
    got = tops.wire_roundtrip_packed_fleet(tree, glob)
    for s in range(S):
        one = tops.wire_roundtrip_packed({k: v[s] for k, v in tree.items()},
                                         like={k: v[s] for k, v in
                                               glob.items()})
        _assert_equal_tree({k: v[s] for k, v in got.items()}, one)


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
    """f32 within atol 1e-5 of the JAX run; int8 within atol 1e-4 of the
    JAX int8 run; the same timing records and eval rounds."""
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


@pytest.mark.parametrize('name', ['fedavg', 'fedcs'])
def test_int8_is_not_f32(runs, name):
    """The int8 wire changes the model by more than the int8 tolerance,
    so the int8 parity above could not pass on an f32 run."""
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


def test_local_aggregates_only_at_eval_points(runs):
    """Fully-local has no global between rounds: the history's global is
    the weighted mean of the local models at each eval stop, so its eval
    loss stays far above FedAvg's."""
    local, fedavg = runs('torch', 'local'), runs('torch', 'fedavg')
    assert local.best_eval['loss'] > 10 * fedavg.best_eval['loss']


@pytest.mark.parametrize('name,ex', [('fedavg', {'wire': 'int8'}),
                                     ('fedasync', {})],
                         ids=['fedavg-int8', 'fedasync'])
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
# (d) sweeps: against the reference, and fleet == sequential == single
# ---------------------------------------------------------------------------

def _member_spec(name, mem):
    """The single-run spec of a sweep member (its hyper columns)."""
    if name == 'fedasync':
        return tapi.FedAsyncSpec(alpha=mem.alpha,
                                 staleness_exp=mem.staleness_exp,
                                 **(mem.overrides or {}))
    return tapi.spec(name, fraction=mem.fraction)


def _port_sweep(tt, init, name, members, **ex):
    return tapi.Experiment(
        tt, None, tapi.spec(name),
        tapi.ExecSpec(eval_every=EVAL_EVERY, **ex), rounds=SWEEP_ROUNDS,
        device='cpu', init_params=init).compile().run_sweep(members)


@pytest.mark.parametrize('name,ex', CELLS, ids=CELL_IDS)
def test_sweep_matches_reference(reg, name, ex):
    jt, tt, init = reg
    ref = japi.Experiment(
        jt, None, japi.spec(name), japi.ExecSpec(eval_every=EVAL_EVERY, **ex),
        rounds=SWEEP_ROUNDS).compile().run_sweep(_members('jax'))
    port = _port_sweep(tt, init, name, _members('torch'), **ex)
    for p, r in zip(port, ref):
        assert _timing(p.records) == _timing(r.records)
        _assert_close(p.final_global, r.final_global,
                      atol=1e-4 if ex.get('wire') == 'int8' else 1e-5)


@pytest.mark.parametrize('name,ex', CELLS, ids=CELL_IDS)
def test_fleet_equals_sequential_equals_single(reg, name, ex):
    _, tt, init = reg
    fleet = _port_sweep(tt, init, name, _members('torch'), **ex)
    seq = _port_sweep(tt, init, name, _members('torch'),
                      engine='sequential', **ex)
    for s, mem in enumerate(_members('torch')):
        single = tapi.Experiment(
            tt, mem.env, _member_spec(name, mem),
            tapi.ExecSpec(eval_every=EVAL_EVERY, **ex), rounds=SWEEP_ROUNDS,
            seed=mem.seed, device='cpu', init_params=init).compile().run()
        for h in (fleet[s], seq[s]):
            assert h.records == single.records
            _assert_equal_tree(h.final_global, single.final_global)


def test_per_member_tasks_fleet_equals_sequential():
    """A baseline sweep with per-member tasks (padded stacking): the
    fleet's train context rides through the FedAvg engine."""
    x, y = make_regression()
    specs = [TEnvSpec(**QUICKSTART), TEnvSpec(**{**QUICKSTART,
                                                  'dataset_size': 400})]
    tasks = tuple(ttasks.regression_task(
        partition(x, y, sp.build().partition_sizes, 5, seed=1), lr=1e-3,
        epochs=3, device='cpu') for sp in specs)
    members = [tapi.SweepMember(env=sp, seed=i) for i, sp in enumerate(specs)]

    def run(engine):
        return tapi.Experiment(
            None, None, tapi.FedAvgSpec(),
            tapi.ExecSpec(engine=engine, eval_every=3, wire='int8'),
            rounds=6, device='cpu').compile().run_sweep(
                tapi.SweepSpec(members, tasks=tasks))
    for f, q in zip(run('fleet'), run('sequential')):
        _assert_equal_tree(f.final_global, q.final_global)


@pytest.mark.parametrize('name', BASELINES)
def test_timing_only_sweep_matches_single_runs(name):
    hists = tapi.Experiment(None, None, tapi.spec(name),
                            tapi.ExecSpec(numeric=False), rounds=15,
                            device='cpu').compile().run_sweep(
                                _members('torch'))
    for mem, h in zip(_members('torch'), hists):
        single = tapi.Experiment(
            None, mem.env, _member_spec(name, mem),
            tapi.ExecSpec(numeric=False), rounds=15, seed=mem.seed,
            device='cpu').compile().run()
        assert h.protocol == name
        assert h.records == single.records and h.futility == single.futility
        assert h.final_global is None


def test_fedasync_member_overrides(reg):
    """FedAsync takes protocol-field overrides per member (as the JAX
    package does): a member with ``staleness_fn='hinge'`` equals a single
    run of that spec; an unknown key is refused by the precompute, and
    FedAvg and SAFA refuse protocol-field overrides."""
    _, tt, init = reg
    mem = tapi.SweepMember(env=TEnvSpec(**QUICKSTART), seed=1, alpha=0.5,
                           overrides={'staleness_fn': 'hinge', 'hinge_b': 1,
                                      'crash_prob': 0.5})
    hist, = _port_sweep(tt, init, 'fedasync', [mem])
    single = tapi.Experiment(
        tt, TEnvSpec(**{**QUICKSTART, 'crash_prob': 0.5}),
        tapi.FedAsyncSpec(alpha=0.5, staleness_fn='hinge', hinge_b=1),
        tapi.ExecSpec(eval_every=EVAL_EVERY), rounds=SWEEP_ROUNDS, seed=1,
        device='cpu', init_params=init).compile().run()
    _assert_equal_tree(hist.final_global, single.final_global)
    bad = [dataclasses.replace(mem, overrides={'clusters': 2})]
    with pytest.raises(ValueError, match='unknown member override keys'):
        _port_sweep(tt, init, 'fedasync', bad)
    for name in ('fedavg', 'safa'):
        with pytest.raises(ValueError, match=f"protocol '{name}' takes "
                                             f"env-field overrides only"):
            _port_sweep(tt, init, name, [mem])


# ---------------------------------------------------------------------------
# (e) the registry and check_compat against the JAX package's
# ---------------------------------------------------------------------------

def test_registry_matches_reference_specs():
    """The port registers every protocol of the JAX package, under the
    same names, with the same spec fields, defaults and flags."""
    port = {p.name: p for p in tapi.PROTOCOLS.values()}
    ref = {p.name: p for p in japi.PROTOCOLS.values()}
    assert set(port) == set(ref)
    for name, pdef in port.items():
        fields = [(f.name, f.default)
                  for f in dataclasses.fields(pdef.spec_cls)]
        assert fields == [(f.name, f.default)
                          for f in dataclasses.fields(ref[name].spec_cls)]
        assert pdef.spec_cls.__name__ == ref[name].spec_cls.__name__
        for k in ('uses_cache', 'supports_wire', 'spec_overrides'):
            assert getattr(pdef, k) == getattr(ref[name], k), (name, k)
        assert pdef.supports_kernel == ref[name].supports_kernel, name
    assert [f.name for f in dataclasses.fields(tapi.SweepMember)] == \
        [f.name for f in dataclasses.fields(japi.SweepMember)]
    assert tapi.SweepMember(env=None) == tapi.SweepMember(
        env=None, **{f.name: f.default
                     for f in dataclasses.fields(japi.SweepMember)
                     if f.name != 'env'})


def _message(api, err, *args):
    with pytest.raises(err) as e:
        api.check_compat(*args)
    return str(e.value)


@pytest.mark.parametrize('name', ['local', 'fedasync'])
def test_int8_wire_refused_with_reference_message(name):
    port = _message(tapi, ValueError, tapi.spec(name),
                    tapi.ExecSpec(wire='int8'))
    ref = _message(japi, ValueError, japi.spec(name),
                   japi.ExecSpec(wire='int8'))
    head = f"protocol {name!r} has no upload-aggregate wire; wire='int8' " \
        f"applies to "
    assert port == ref == head + 'csafl/fedavg/fedcs/safa/seafl only'


@pytest.mark.parametrize('use_kernel', [True, 'packed'])
@pytest.mark.parametrize('name', BASELINES)
def test_use_kernel_refused_with_reference_message(name, use_kernel):
    port = _message(tapi, ValueError, tapi.spec(name),
                    tapi.ExecSpec(use_kernel=use_kernel))
    ref = _message(japi, ValueError, japi.spec(name),
                   japi.ExecSpec(use_kernel=use_kernel))
    head = f'protocol {name!r} has no fused aggregation kernel; ' \
        f'use_kernel applies to '
    assert port == ref == head + 'csafl/safa/seafl only'


def test_unknown_spec_type_refused_with_reference_message():
    @dataclasses.dataclass(frozen=True)
    class GossipSpec(tapi.ProtocolSpec):
        fanout: int = 3
    port = _message(tapi, TypeError, GossipSpec())
    ref = _message(japi, TypeError, GossipSpec())
    assert port == ref == (
        "unregistered protocol spec 'GossipSpec'; known specs: "
        "['CsaflSpec', 'FedAsyncSpec', 'FedAvgSpec', 'FedCSSpec', "
        "'LocalSpec', 'SafaSpec', 'SeaflSpec'] (register new ones via "
        "api.register)")
    # a spec of the JAX package is foreign to the port's registry
    assert 'unregistered' in _message(tapi, TypeError, japi.FedAvgSpec())


@pytest.mark.parametrize('spec,ex', [
    (tapi.FedAsyncSpec(staleness_fn='cubic'), tapi.ExecSpec()),
    (tapi.FedAsyncSpec(alpha=0.0), tapi.ExecSpec()),
    (tapi.FedAsyncSpec(hinge_a=0.0), tapi.ExecSpec()),
    (tapi.FedAvgSpec(sampler='reservoir'), tapi.ExecSpec()),
    (tapi.LocalSpec(), tapi.ExecSpec(schedule='sparse')),
    (tapi.FedAvgSpec(), tapi.ExecSpec(schedule='sparse_tier')),
], ids=['staleness_fn', 'alpha', 'hinge_a', 'sampler', 'local-sparse',
        'fedavg-tier'])
def test_invalid_baseline_cells_raise_reference_value_error(spec, ex):
    jspec = getattr(japi, type(spec).__name__)(**dataclasses.asdict(spec))
    jex = japi.ExecSpec(**dataclasses.asdict(ex))
    assert _message(tapi, ValueError, spec, ex) == \
        _message(japi, ValueError, jspec, jex)


def test_spec_by_name():
    assert tapi.spec('fedcs', fraction=0.2) == tapi.FedCSSpec(fraction=0.2)
    assert tapi.spec('seafl', alpha=0.5) == tapi.SeaflSpec(alpha=0.5)
    with pytest.raises(ValueError, match='unknown proto'):
        tapi.spec('gossip')
    with pytest.raises(ValueError, match='already registered'):
        tapi.register(tapi.PROTOCOLS[tapi.SafaSpec])


# ---------------------------------------------------------------------------
# (f) the deprecated federation shims
# ---------------------------------------------------------------------------

SHIM_KW = {'safa': dict(fraction=0.5, lag_tolerance=5),
           'fedavg': dict(fraction=0.5), 'fedcs': dict(fraction=0.5),
           'local': dict(fraction=0.5),
           'fedasync': dict(alpha=0.5, staleness_exp=0.7)}


@pytest.mark.parametrize('name', sorted(SHIM_KW))
def test_deprecated_shim_equals_spec_spelling(reg, name):
    _, tt, _ = reg
    with pytest.warns(DeprecationWarning,
                      match=rf'federation\.run_{name}\(\) is deprecated'):
        shim = tfed.RUNNERS[name](tt, TEnvSpec(**QUICKSTART), rounds=6,
                                  eval_every=3, seed=1, device='cpu',
                                  **SHIM_KW[name])
    want = tapi.Experiment(tt, TEnvSpec(**QUICKSTART),
                           tapi.spec(name, **SHIM_KW[name]),
                           tapi.ExecSpec(eval_every=3), rounds=6, seed=1,
                           device='cpu').compile().run()
    assert shim.protocol == name and shim.records == want.records
    _assert_equal_tree(shim.final_global, want.final_global)
    assert tfed.PROTOCOLS is tfed.RUNNERS


def test_deprecated_sweep_shim_equals_spec_spelling(reg):
    _, tt, _ = reg
    with pytest.warns(DeprecationWarning, match=r'run_sweep\(\)'):
        shim = tfed.run_sweep(tt, _members('torch', 2), rounds=6,
                              proto='fedavg', eval_every=3, wire='int8',
                              use_kernel='packed', device='cpu')
    want = tapi.Experiment(tt, None, tapi.FedAvgSpec(),
                           tapi.ExecSpec(eval_every=3, wire='int8'),
                           rounds=6, device='cpu').compile().run_sweep(
                               _members('torch', 2))
    for a, b in zip(shim, want):
        _assert_equal_tree(a.final_global, b.final_global)


def test_legacy_fedasync_precompute_matches_reference():
    js = jfed.precompute_fedasync_schedule(_env('jax'), rounds=20, alpha=0.4,
                                           staleness_exp=0.9)
    ts = tfed.precompute_fedasync_schedule(_env('torch'), rounds=20,
                                           alpha=0.4, staleness_exp=0.9)
    for k in ('committed', 'order', 'alphas'):
        np.testing.assert_array_equal(getattr(ts, k), getattr(js, k))
    assert _timing(ts.records) == _timing(js.records)

"""The slice as a whole: the quickstart configuration through
``repro.api.Experiment`` and ``repro_torch.api.Experiment`` on fresh envs
from one ``EnvSpec``, the port starting from the reference's init.

Tolerances: schedules are host numpy in both packages and must be equal.
Model numbers drift apart by summation order over 24 rounds: eval losses
rtol 1e-4, final_global atol 1e-5 on the f32 wire.  On the int8 wire the
port is held to the reference's int8 within atol 1e-4: a one-ulp move of
every int8 scale moves the reference's final_global by ~4e-6, while its
own int8-vs-f32 gap is ~5e-3, so a port that ran f32 would fail.
Inside the port, the scan and loop engines agree bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.data import make_images, make_regression, partition
from repro.data import tasks as jtasks
from repro.fedsim import EnvSpec as JEnvSpec
from repro_torch import api as tapi
from repro_torch.core import api as tcore
from repro_torch.data import tasks as ttasks
from repro_torch.fedsim import EnvSpec as TEnvSpec
from repro_torch.kernels import backend

QUICKSTART = dict(m=5, crash_prob=0.3, dataset_size=506, batch_size=5,
                  epochs=3, t_lim=830.0, seed=3)
ROUNDS, EVAL_EVERY = 24, 6
SAFA = dict(fraction=0.5, lag_tolerance=5)


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


def _jax_exp(jt, **ex):
    return japi.Experiment(jt, JEnvSpec(**QUICKSTART).build(),
                           japi.SafaSpec(**SAFA),
                           japi.ExecSpec(eval_every=EVAL_EVERY, **ex),
                           rounds=ROUNDS)


def _port_exp(tt, init, **ex):
    return tapi.Experiment(tt, TEnvSpec(**QUICKSTART).build(),
                           tapi.SafaSpec(**SAFA),
                           tapi.ExecSpec(eval_every=EVAL_EVERY, **ex),
                           rounds=ROUNDS, device='cpu', init_params=init)


@pytest.fixture(scope='module')
def runs(quickstart):
    """Memoised runs: runs(pkg, **exec) -> History."""
    jt, tt, init = quickstart
    memo = {}

    def run(pkg, **ex):
        key = (pkg, tuple(sorted(ex.items())))
        if key not in memo:
            exp = _jax_exp(jt, **ex) if pkg == 'jax' \
                else _port_exp(tt, init, **ex)
            memo[key] = exp.compile().run()
        return memo[key]
    return run


def _timing(records):
    """Round records without their evals (those are model numbers)."""
    return [dataclasses.asdict(dataclasses.replace(r, eval=None))
            for r in records]


def _losses(hist):
    return np.array([e['loss'] for _, e in hist.evals()])


def _assert_final_close(port, ref, atol):
    for k, v in ref.final_global.items():
        np.testing.assert_allclose(port.final_global[k].numpy(),
                                   np.asarray(v), rtol=0, atol=atol,
                                   err_msg=k)


def test_schedule_matches_reference(quickstart):
    jt, tt, init = quickstart
    js = _jax_exp(jt).precompute()
    ts = _port_exp(tt, init).precompute()
    for f in ('sync', 'committed', 'picked', 'undrafted', 'deprecated'):
        np.testing.assert_array_equal(getattr(ts, f), getattr(js, f),
                                      err_msg=f)
    assert _timing(ts.records) == _timing(js.records)
    assert ts.futility == js.futility


@pytest.mark.parametrize('use_kernel', [False, True, 'packed'])
def test_f32_matches_reference(runs, use_kernel):
    port = runs('torch', use_kernel=use_kernel)
    ref = runs('jax', use_kernel=use_kernel)
    assert [r for r, _ in port.evals()] == [6, 12, 18, 24]
    np.testing.assert_allclose(_losses(port), _losses(ref), rtol=1e-4)
    _assert_final_close(port, ref, atol=1e-5)
    assert _timing(port.records) == _timing(ref.records)


def test_int8_matches_reference_int8(runs):
    port, ref = runs('torch', wire='int8'), runs('jax', wire='int8')
    np.testing.assert_allclose(_losses(port), _losses(ref), rtol=1e-4)
    _assert_final_close(port, ref, atol=1e-4)


@pytest.mark.parametrize('ex', [dict(use_kernel='packed'), dict(wire='int8')],
                         ids=['packed', 'int8'])
def test_scan_equals_loop_bitwise(runs, ex):
    scan = runs('torch', **ex)
    loop = runs('torch', engine='loop', **ex)
    assert [e for _, e in scan.evals()] == [e for _, e in loop.evals()]
    for k, v in scan.final_global.items():
        assert torch.equal(v, loop.final_global[k]), k


def test_cnn_through_api_matches_reference():
    """Task 2's CNN at m = 4 for 2 rounds through both APIs."""
    spec = dict(m=4, crash_prob=0.3, dataset_size=96, batch_size=8, epochs=1,
                t_lim=5600.0, seed=0)
    x, y = make_images(n=96)
    data = partition(x, y, JEnvSpec(**spec).build().partition_sizes, 8)
    jt = jtasks.cnn_task(data, lr=1e-3, epochs=1)
    tt = ttasks.cnn_task(data, lr=1e-3, epochs=1, device='cpu')
    init = {k: np.array(v) for k, v in
            jt.init_global(jax.random.PRNGKey(0)).items()}
    ex = dict(use_kernel='packed', eval_every=1)
    ref = japi.Experiment(jt, JEnvSpec(**spec), japi.SafaSpec(fraction=0.5),
                          japi.ExecSpec(**ex), rounds=2).compile().run()
    port = tapi.Experiment(tt, TEnvSpec(**spec), tapi.SafaSpec(fraction=0.5),
                           tapi.ExecSpec(**ex), rounds=2, device='cpu',
                           init_params=init).compile().run()
    np.testing.assert_allclose(_losses(port), _losses(ref), rtol=1e-4)
    for k, v in ref.final_global.items():
        np.testing.assert_allclose(port.final_global[k].numpy(),
                                   np.asarray(v), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_own_init_trains(quickstart):
    _, tt, _ = quickstart
    backend.reset_launches()
    hist = tapi.Experiment(tt, TEnvSpec(**QUICKSTART), tapi.SafaSpec(**SAFA),
                           tapi.ExecSpec(eval_every=4), rounds=8,
                           device='cpu').compile().run()
    first = tt.evaluate(tt.init_global(0))['loss']
    assert np.all(np.isfinite(_losses(hist)))
    assert _losses(hist)[-1] < first
    assert all(v == 0 for v in backend.LAUNCHES.values())


# The ids date from when these cells were refused (the sparse schedules,
# the lag tier, then the wire-derived comm model, ROADMAP item 13); they
# now name cells that run: a lag-tier run's or sweep's env, a per-leaf int8
# reference run's and a sparse FedAvg sweep's, each with comm='wire'.
@pytest.mark.parametrize('spec,ex,env', [
    (tapi.SafaSpec(),
     tapi.ExecSpec(engine='sequential', schedule='sparse_tier'),
     TEnvSpec(**QUICKSTART).replace(comm='wire')),
    (tapi.SafaSpec(),
     tapi.ExecSpec(engine='fleet', schedule='sparse_tier',
                   use_kernel='packed'),
     TEnvSpec(**QUICKSTART).replace(comm='wire')),
    (tapi.SafaSpec(), tapi.ExecSpec(schedule='sparse_tier', wire='int8'),
     TEnvSpec(**QUICKSTART).replace(comm='wire')),
    (tapi.SafaSpec(),
     tapi.ExecSpec(engine='fleet', schedule='sparse_tier', wire='int8'),
     TEnvSpec(**QUICKSTART).replace(comm='wire')),
    (tapi.SafaSpec(quantize_uploads=True), tapi.ExecSpec(engine='loop'),
     TEnvSpec(**QUICKSTART).replace(comm='wire')),
    (tapi.FedAvgSpec(), tapi.ExecSpec(engine='fleet', schedule='sparse'),
     TEnvSpec(**QUICKSTART).replace(comm='wire')),
], ids=['sparse', 'sparse_delta', 'sparse_tier', 'fleet', 'quantize_uploads',
        'fedavg'])
def test_unported_cells_raise(quickstart, spec, ex, env):
    """``check_compat`` accepts each cell; the Experiment measures its
    task's model on the cell's wire before the precompute, and refuses
    the wire-derived env without a task, with the reference's
    ValueError."""
    _, tt, _ = quickstart
    assert tapi.check_compat(spec, ex, env=env) is tapi.PROTOCOLS[type(spec)]
    exp = tapi.Experiment(tt, env, spec, dataclasses.replace(
        ex, numeric=False), rounds=4, device='cpu')
    assert exp.env._wire_mb == tcore._wire_mb_of(tt, ex.wire)
    assert len(exp.precompute().records) == 4
    with pytest.raises(ValueError, match='no Task to measure'):
        tapi.Experiment(None, env, spec, ex, rounds=4, device='cpu')


def test_invalid_cells_raise_value_error():
    for ex in (tapi.ExecSpec(wire='fp16'), tapi.ExecSpec(engine='warp'),
               tapi.ExecSpec(use_kernel='fused'),
               tapi.ExecSpec(schedule='ragged')):
        with pytest.raises(ValueError):
            tapi.check_compat(tapi.SafaSpec(), ex)


def test_unported_runner_options_raise(quickstart, tmp_path):
    """The name dates from when ``checkpoint=`` was refused (ROADMAP
    item 7).  A run and a sweep stopped after one segment and resumed
    from their checkpoints end bit for bit as uninterrupted ones."""
    jt, tt, init = quickstart
    full = _port_exp(tt, init).compile().run()
    path = str(tmp_path / 'run')
    part = _port_exp(tt, init).compile().run(checkpoint=path, max_segments=1)
    assert len(part.evals()) == 1
    got = _port_exp(tt, init).compile().run(checkpoint=path)
    assert got.evals() == full.evals()
    for k in full.final_global:
        assert torch.equal(got.final_global[k], full.final_global[k]), k

    def sweep(**kw):
        return _port_exp(tt, init).compile().run_sweep(
            [tapi.SweepMember(env=TEnvSpec(**QUICKSTART))], **kw)
    full, = sweep()
    sweep(checkpoint=str(tmp_path / 'sweep'), max_segments=2)
    got, = sweep(checkpoint=str(tmp_path / 'sweep'))
    assert got.evals() == full.evals()
    for k in full.final_global:
        assert torch.equal(got.final_global[k], full.final_global[k]), k


def test_experiment_defaults_to_cuda(quickstart, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    _, tt, _ = quickstart
    with pytest.raises(RuntimeError, match='cuda'):
        tapi.Experiment(tt, TEnvSpec(**QUICKSTART), tapi.SafaSpec(),
                        rounds=2)

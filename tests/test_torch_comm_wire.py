"""Wire-derived comm (``EnvSpec(comm='wire')``) in the port against the
JAX package on the CPU: the measured uplink and downlink megabytes of a
task's model on both wires, the host precompute of a ``comm='wire'`` run
and of sweep members that override ``comm``, and the refusal when there
is no Task to measure.

Tolerances: none.  The bytes follow from the model's shapes alone, and
the schedules are host numpy in both packages, so both are compared
exactly.
"""
import dataclasses

import numpy as np
import pytest

from repro import api as japi
from repro.core import api as japi_core
from repro.data import make_images, make_regression, partition
from repro.data import tasks as jtasks
from repro.fedsim import EnvSpec as JEnvSpec
from repro_torch import api as tapi
from repro_torch.core import api as tapi_core
from repro_torch.data import tasks as ttasks
from repro_torch.fedsim import EnvSpec as TEnvSpec
from repro_torch.kernels import backend

ENV = dict(m=8, crash_prob=0.3, dataset_size=96, batch_size=8, epochs=1,
           t_lim=400.0, seed=3, comm='wire')
ROUNDS = 6


@pytest.fixture(autouse=True)
def _zero_launches():
    backend.reset_launches()
    yield
    assert all(v == 0 for v in backend.LAUNCHES.values()), \
        'a wrapper launched a kernel on CPU tensors'


@pytest.fixture(scope='module')
def tasks():
    """The Task 2 CNN and the regression task, each in both packages."""
    sizes = JEnvSpec(**ENV).build().partition_sizes
    x, y = make_images(n=96)
    img = partition(x, y, sizes, 8)
    x, y = make_regression()
    reg = partition(x, y, sizes, 8, seed=1)
    return {'cnn': (jtasks.cnn_task(img, lr=1e-3, epochs=1),
                    ttasks.cnn_task(img, lr=1e-3, epochs=1, device='cpu')),
            'regression': (jtasks.regression_task(reg, lr=1e-3, epochs=1),
                           ttasks.regression_task(reg, lr=1e-3, epochs=1,
                                                  device='cpu'))}


@pytest.mark.parametrize('wire', ['f32', 'int8'])
@pytest.mark.parametrize('task', ['cnn', 'regression'])
def test_wire_mb_matches_the_reference(tasks, task, wire):
    jt, tt = tasks[task]
    got = tapi_core._wire_mb_of(tt, wire)
    assert got == japi_core._wire_mb_of(jt, wire)
    assert tapi_core._wire_mb_of(tt, wire) is got        # memoised
    if task == 'cnn':
        up_f32, down = tapi_core._wire_mb_of(tt, 'f32')
        n = sum(v.numel() for v in tt.init_global(0).values())
        assert down == up_f32 == n * 4 / 1e6
        if wire == 'int8':
            assert got[0] < up_f32 / 3


def _records(hist):
    return [dataclasses.asdict(dataclasses.replace(r, eval=None))
            for r in hist.records]


SCHEDULES = ['dense', 'sparse', 'sparse_tier']


@pytest.mark.parametrize('schedule', SCHEDULES)
@pytest.mark.parametrize('wire', ['f32', 'int8'])
def test_wire_run_precompute_matches_the_reference(tasks, wire, schedule):
    """A ``comm='wire'`` run's host records equal the reference's exactly,
    and differ from the static comm model's."""
    jt, tt = tasks['cnn']
    ex = dict(wire=wire, schedule=schedule, numeric=False)
    want = japi.Experiment(jt, JEnvSpec(**ENV), japi.SafaSpec(),
                           japi.ExecSpec(**ex), rounds=ROUNDS).compile().run()
    got = tapi.Experiment(tt, TEnvSpec(**ENV), tapi.SafaSpec(),
                          tapi.ExecSpec(**ex), rounds=ROUNDS,
                          device='cpu').compile().run()
    assert _records(got) == _records(want)
    assert got.futility == want.futility
    static = tapi.Experiment(tt, TEnvSpec(**dict(ENV, comm='static')),
                             tapi.SafaSpec(), tapi.ExecSpec(**ex),
                             rounds=ROUNDS, device='cpu').compile().run()
    assert [r['round_len'] for r in _records(static)] != \
        [r['round_len'] for r in _records(got)]


@pytest.mark.parametrize('name', ['safa', 'fedavg', 'seafl'])
@pytest.mark.parametrize('engine', ['fleet', 'sequential'])
def test_wire_sweep_members_match_the_reference(tasks, name, engine):
    """Sweep members with ``overrides={'comm': 'wire'}`` (beside a static
    one) precompute the reference's records exactly."""
    jt, tt = tasks['cnn']
    ex = dict(wire='int8', engine=engine, numeric=False)
    static = dict(ENV, comm='static')

    def members(api, spec_cls):
        return [api.SweepMember(env=spec_cls(**static), seed=0,
                                overrides={'comm': 'wire'}),
                api.SweepMember(env=spec_cls(**static), seed=1),
                api.SweepMember(env=spec_cls(**dict(static, seed=4)), seed=2,
                                overrides={'comm': 'wire',
                                           'crash_prob': 0.5})]
    want = japi.Experiment(jt, None, japi.spec(name), japi.ExecSpec(**ex),
                           rounds=ROUNDS).compile().run_sweep(
                               members(japi, JEnvSpec))
    got = tapi.Experiment(tt, None, tapi.spec(name), tapi.ExecSpec(**ex),
                          rounds=ROUNDS, device='cpu').compile().run_sweep(
                              members(tapi, TEnvSpec))
    for g, w in zip(got, want):
        assert _records(g) == _records(w)
        assert g.futility == w.futility
    assert _records(got[0]) != _records(got[1])


def test_wire_comm_trains(tasks):
    """A numeric ``comm='wire'`` run trains as the static one does: only
    the host timing changes, so the models are equal bit for bit."""
    _, tt = tasks['regression']
    env = dict(ENV, crash_prob=0.0, t_lim=1e9)
    hists = [tapi.Experiment(tt, TEnvSpec(**dict(env, comm=c)),
                             tapi.SafaSpec(), tapi.ExecSpec(eval_every=3),
                             rounds=ROUNDS, device='cpu').compile().run()
             for c in ('wire', 'static')]
    for k, v in hists[0].final_global.items():
        assert np.array_equal(v.numpy(), hists[1].final_global[k].numpy())
    assert hists[0].records[0].round_len != hists[1].records[0].round_len


def test_wire_comm_needs_a_task():
    msg = "this run has no Task to measure"
    with pytest.raises(ValueError, match=msg):
        tapi.Experiment(None, TEnvSpec(**ENV), tapi.SafaSpec(),
                        tapi.ExecSpec(numeric=False), rounds=2,
                        device='cpu')
    with pytest.raises(ValueError, match=msg):
        japi.Experiment(None, JEnvSpec(**ENV), japi.SafaSpec(),
                        japi.ExecSpec(numeric=False), rounds=2)
    runner = tapi.Experiment(None, None, tapi.SafaSpec(),
                             tapi.ExecSpec(numeric=False), rounds=2,
                             device='cpu').compile()
    with pytest.raises(ValueError, match=msg):
        runner.run_sweep([tapi.SweepMember(
            env=TEnvSpec(**dict(ENV, comm='static')),
            overrides={'comm': 'wire'})])

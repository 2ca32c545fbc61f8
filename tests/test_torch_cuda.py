"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small shapes, including a client count above the kernels'
shared-memory chunk of 256.  Needs an NVIDIA GPU (marker ``cuda``; skips
without one).  The file imports no JAX, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: caches, locals, q, scales and dequantised values are
selects, one multiply or one IEEE division, so they match exactly;
new_global (of Eq. 6-8 and of the weighted merge) and the rows kernels'
new_agg are sums taken in another order, held to rtol 1e-5 / atol 1e-6;
gathered and scattered rows and the rows kernels' c2 and local rows are
copies and selects, equal exactly, and so is the whole value buffer the
tier kernels write in place, its scratch row included.  A fleet kernel
runs the single-run kernel's code on each member's slices, so it must
equal the single-run kernel bit for bit on every member.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import backend, ref
from repro_torch.kernels.comm_quant import (dequantize, dequantize_packed,
                                            dequantize_packed_fleet,
                                            dequantize_rows, quantize,
                                            quantize_packed,
                                            quantize_packed_fleet,
                                            quantize_rows)
from repro_torch.kernels.rows import (gather_rows, gather_rows_fleet,
                                     scatter_rows, scatter_rows_fleet)
from repro_torch.kernels.safa_aggregate import (
    safa_aggregate, safa_aggregate_fleet, safa_aggregate_packed,
    safa_aggregate_packed_fleet, safa_aggregate_packed_q8,
    safa_aggregate_packed_q8_fleet, safa_aggregate_packed_q8_rows,
    safa_aggregate_packed_q8_rows_fleet, safa_aggregate_packed_q8_tier_rows,
    safa_aggregate_packed_q8_tier_rows_fleet, safa_aggregate_packed_rows,
    safa_aggregate_packed_rows_fleet, safa_aggregate_packed_tier_rows,
    safa_aggregate_packed_tier_rows_fleet)
from repro_torch.kernels.weighted_merge import (weighted_merge_packed,
                                                weighted_merge_packed_fleet)
from torch_kernel_calls import kernel_calls

pytestmark = pytest.mark.cuda

SHAPES = [(5, 4096), (100, 2048), (300, 2048)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU (torch.cuda.is_available() is '
                    'False)')
    backend.reset_launches()
    return torch.device('cuda')


def _inputs(m, n, dev, seed=0, lead=()):
    """Seeded kernel operands; ``lead=(S,)`` gives a fleet's."""
    rng = np.random.default_rng(seed)
    t = {k: torch.as_tensor(rng.normal(size=lead + shape).astype(np.float32),
                            device=dev)
         for k, shape in (('cache', (m, n)), ('trained', (m, n)),
                          ('base', (m, n)), ('global_prev', (n,)))}
    t['weights'] = torch.as_tensor(rng.dirichlet(np.ones(m), size=lead),
                                   dtype=torch.float32, device=dev)
    for k in ('picked', 'undrafted', 'deprecated', 'completed'):
        t[k] = torch.as_tensor(rng.random(lead + (m,)) < 0.4, device=dev)
    return t


AGG = ('trained', 'global_prev', 'picked', 'undrafted', 'deprecated',
       'weights')


@pytest.mark.parametrize('m,n', SHAPES)
def test_aggregate_packed_matches_plain(dev, m, n):
    t = _inputs(m, n, dev)
    want_g, want_c = ref.safa_aggregate_ref(t['cache'], *(t[k] for k in AGG))
    cache = t['cache'].clone()
    got_g, got_c = safa_aggregate_packed(cache, *(t[k] for k in AGG))
    torch.cuda.synchronize()
    assert got_c is cache
    assert torch.equal(got_c, want_c)
    torch.testing.assert_close(got_g, want_g, rtol=1e-5, atol=1e-6)
    assert backend.LAUNCHES['safa_aggregate_packed'] == 1


@pytest.mark.parametrize('m,n', [(5, 1000), (300, 3000)])
def test_aggregate_per_leaf_matches_plain(dev, m, n):
    t = _inputs(m, n, dev, seed=1)
    want_g, want_c = ref.safa_aggregate_ref(t['cache'], *(t[k] for k in AGG))
    got_g, got_c = safa_aggregate(t['cache'], *(t[k] for k in AGG))
    torch.cuda.synchronize()
    assert torch.equal(got_c, want_c)
    torch.testing.assert_close(got_g, want_g, rtol=1e-5, atol=1e-6)
    assert backend.LAUNCHES['safa_aggregate'] == 1


@pytest.mark.parametrize('m,n', SHAPES)
def test_quantize_packed_matches_plain(dev, m, n):
    x = _inputs(m, n, dev, seed=2)['trained'] * 3
    x[0, :128] = 0.0                      # an all-zero block: scale 1e-30/127
    want_q, want_s = ref.quantize_packed_ref(x)
    got_q, got_s = quantize_packed(x)
    torch.cuda.synchronize()
    assert torch.equal(got_q, want_q)
    assert torch.equal(got_s, want_s)
    assert backend.LAUNCHES['quantize_packed'] == 1


@pytest.mark.parametrize('m,n', SHAPES)
def test_aggregate_q8_matches_plain(dev, m, n):
    t = _inputs(m, n, dev, seed=3)
    q, s = ref.quantize_packed_ref(t['trained'])
    args = ('global_prev', 'picked', 'undrafted', 'deprecated', 'completed',
            'weights')
    want = ref.safa_aggregate_q8_ref(q, s, t['base'], t['cache'],
                                     *(t[k] for k in args))
    cache = t['cache'].clone()
    got = safa_aggregate_packed_q8(q, s, t['base'], cache,
                                   *(t[k] for k in args))
    torch.cuda.synchronize()
    assert got[1] is cache
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    assert backend.LAUNCHES['safa_aggregate_packed_q8'] == 1


FLEET_SHAPES = [(2, 5, 4096), (3, 300, 2048)]   # (S, m, N)
Q8_ARGS = ('global_prev', 'picked', 'undrafted', 'deprecated', 'completed',
           'weights')


def _member(t, s):
    return {k: v[s].clone() for k, v in t.items()}


@pytest.mark.parametrize('s,m,n', FLEET_SHAPES)
def test_aggregate_packed_fleet_matches_plain_and_single_run(dev, s, m, n):
    t = _inputs(m, n, dev, seed=4, lead=(s,))
    want_g, want_c = ref.safa_aggregate_ref(t['cache'], *(t[k] for k in AGG))
    cache = t['cache'].clone()
    got_g, got_c = safa_aggregate_packed_fleet(cache, *(t[k] for k in AGG))
    torch.cuda.synchronize()
    assert got_c is cache
    assert torch.equal(got_c, want_c)
    torch.testing.assert_close(got_g, want_g, rtol=1e-5, atol=1e-6)
    for i in range(s):
        one = _member(t, i)
        g1, c1 = safa_aggregate_packed(one['cache'], *(one[k] for k in AGG))
        assert torch.equal(got_g[i], g1) and torch.equal(got_c[i], c1)
    assert backend.LAUNCHES['safa_aggregate_packed_fleet'] == 1
    assert backend.LAUNCHES['safa_aggregate_packed'] == s


@pytest.mark.parametrize('s,m,n', [(2, 5, 1000), (3, 300, 3000)])
def test_aggregate_fleet_per_leaf_matches_single_run(dev, s, m, n):
    t = _inputs(m, n, dev, seed=5, lead=(s,))
    got_g, got_c = safa_aggregate_fleet(t['cache'], *(t[k] for k in AGG))
    torch.cuda.synchronize()
    want_g, want_c = ref.safa_aggregate_ref(t['cache'], *(t[k] for k in AGG))
    assert torch.equal(got_c, want_c)
    torch.testing.assert_close(got_g, want_g, rtol=1e-5, atol=1e-6)
    for i in range(s):
        one = _member(t, i)
        g1, c1 = safa_aggregate(one['cache'], *(one[k] for k in AGG))
        assert torch.equal(got_g[i], g1) and torch.equal(got_c[i], c1)
    assert backend.LAUNCHES['safa_aggregate_fleet'] == 1


@pytest.mark.parametrize('s,m,n', FLEET_SHAPES)
def test_quantize_packed_fleet_matches_plain_and_single_run(dev, s, m, n):
    x = _inputs(m, n, dev, seed=6, lead=(s,))['trained'] * 3
    x[1, 0, :128] = 0.0
    want_q, want_s = ref.quantize_packed_ref(x)
    got_q, got_s = quantize_packed_fleet(x)
    torch.cuda.synchronize()
    assert torch.equal(got_q, want_q) and torch.equal(got_s, want_s)
    for i in range(s):
        q1, s1 = quantize_packed(x[i].contiguous())
        assert torch.equal(got_q[i], q1) and torch.equal(got_s[i], s1)
    assert backend.LAUNCHES['quantize_packed_fleet'] == 1


@pytest.mark.parametrize('s,m,n', FLEET_SHAPES)
def test_aggregate_q8_fleet_matches_plain_and_single_run(dev, s, m, n):
    t = _inputs(m, n, dev, seed=7, lead=(s,))
    q, sc = ref.quantize_packed_ref(t['trained'])
    want = ref.safa_aggregate_q8_ref(q, sc, t['base'], t['cache'],
                                     *(t[k] for k in Q8_ARGS))
    cache = t['cache'].clone()
    got = safa_aggregate_packed_q8_fleet(q, sc, t['base'], cache,
                                         *(t[k] for k in Q8_ARGS))
    torch.cuda.synchronize()
    assert got[1] is cache
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    for i in range(s):
        one = _member(t, i)
        single = safa_aggregate_packed_q8(q[i].contiguous(),
                                          sc[i].contiguous(), one['base'],
                                          one['cache'],
                                          *(one[k] for k in Q8_ARGS))
        for a, b in zip(got, single):
            assert torch.equal(a[i], b)
    assert backend.LAUNCHES['safa_aggregate_packed_q8_fleet'] == 1


@pytest.mark.parametrize('m,n', SHAPES)
def test_dequantize_packed_matches_plain(dev, m, n):
    x = _inputs(m, n, dev, seed=8)['trained'] * 3
    x[0, :128] = 0.0
    q, s = ref.quantize_packed_ref(x)
    got = dequantize_packed(q, s)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert torch.equal(got, ref.dequantize_packed_ref(q, s))
    assert backend.LAUNCHES['dequantize_packed'] == 1


@pytest.mark.parametrize('s,m,n', FLEET_SHAPES)
def test_dequantize_packed_fleet_matches_plain_and_single_run(dev, s, m, n):
    x = _inputs(m, n, dev, seed=9, lead=(s,))['trained'] * 3
    q, sc = ref.quantize_packed_ref(x)
    got = dequantize_packed_fleet(q, sc)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.dequantize_packed_ref(q, sc))
    for i in range(s):
        assert torch.equal(got[i], dequantize_packed(q[i].contiguous(),
                                                     sc[i].contiguous()))
    assert backend.LAUNCHES['dequantize_packed_fleet'] == 1


SWEEP_CELLS = {
    # exec fields -> {fleet-engine launch counter: launches per round}
    'packed': (dict(use_kernel='packed'),
               {'safa_aggregate_packed_fleet': 1}),
    'per_leaf': (dict(use_kernel=True), {'safa_aggregate_fleet': 2}),
    'int8': (dict(wire='int8'), {'quantize_packed_fleet': 1,
                                 'safa_aggregate_packed_q8_fleet': 1}),
    'plain': (dict(use_kernel=False), {}),
}


def _regression(spec):
    from repro_torch.data import make_regression, partition
    from repro_torch.data.tasks import regression_task
    x, y = make_regression()
    return regression_task(partition(x, y,
                                     spec.build().partition_sizes, 5,
                                     seed=1), lr=1e-3, epochs=3)


@pytest.mark.parametrize('cell', sorted(SWEEP_CELLS))
def test_run_sweep_on_the_card(dev, cell):
    """``run_sweep`` on the card, both engines: the fleet launches each of
    its fleet kernels once per round for all members (per leaf: once per
    leaf, the regression model has two) and no single-run kernel; the
    sequential engine launches the single-run kernels once per member.
    Fleet and sequential train the same replicas in batches of other
    sizes, so they are held to atol 1e-5, not bit for bit."""
    from repro_torch import api
    from repro_torch.fedsim import EnvSpec
    spec = EnvSpec(m=5, crash_prob=0.3, dataset_size=506, batch_size=5,
                   epochs=3, t_lim=830.0, seed=3)
    task = _regression(spec)
    members = [api.SweepMember(env=spec, seed=s,
                               overrides={'crash_prob': cr, 'draw_seed': s})
               for s, cr in enumerate((0.1, 0.3, 0.5))]
    ex, per_round = SWEEP_CELLS[cell]
    rounds = 4
    hists = {}
    for engine in ('fleet', 'sequential'):
        backend.reset_launches()
        hists[engine] = api.Experiment(
            task, None, api.SafaSpec(),
            api.ExecSpec(engine=engine, eval_every=2, **ex),
            rounds=rounds).compile().run_sweep(members)
        torch.cuda.synchronize()
        counts = {k: v for k, v in backend.LAUNCHES.items() if v}
        if engine == 'fleet':
            assert counts == {k: n * rounds for k, n in per_round.items()}
        else:
            assert counts == {k.replace('_fleet', ''): n * rounds * 3
                              for k, n in per_round.items()}
    def timing(records):
        return [dataclasses.replace(r, eval=None) for r in records]
    for f, q in zip(hists['fleet'], hists['sequential']):
        assert timing(f.records) == timing(q.records)
        for k, v in q.final_global.items():
            assert v.is_cuda
            torch.testing.assert_close(f.final_global[k], v, rtol=0,
                                       atol=1e-5)


#: baseline cell -> (protocol name, exec fields, launches per round of the
#: single-run kernels; the fleet launches the ``*_fleet`` ones)
BASELINE_CELLS = {
    'fedavg': ('fedavg', {}, {}),
    'fedavg-int8': ('fedavg', dict(wire='int8'),
                    {'quantize_packed': 1, 'dequantize_packed': 1}),
    'fedcs': ('fedcs', {}, {}),
    'fedcs-int8': ('fedcs', dict(wire='int8'),
                   {'quantize_packed': 1, 'dequantize_packed': 1}),
    'local': ('local', {}, {}),
    'fedasync': ('fedasync', {}, {}),
}


@pytest.mark.parametrize('cell', sorted(BASELINE_CELLS))
def test_baseline_run_and_sweep_on_the_card(dev, cell):
    """Each baseline on the card through ``run()`` (scan and loop) and
    ``run_sweep()`` (fleet and sequential): the int8 wire launches its two
    kernels once per round (the fleet their fleet forms, for all members
    at once); scan equals loop bit for bit (the same calls in the same
    order); fleet and sequential train the same replicas in batches of
    other sizes, so they are held to atol 1e-5."""
    from repro_torch import api
    from repro_torch.fedsim import EnvSpec
    spec = EnvSpec(m=5, crash_prob=0.3, dataset_size=506, batch_size=5,
                   epochs=3, t_lim=830.0, seed=3)
    task = _regression(spec)
    name, ex, per_round = BASELINE_CELLS[cell]
    rounds = 4
    runs = {}
    for engine in ('scan', 'loop'):
        backend.reset_launches()
        runs[engine] = api.Experiment(
            task, spec, api.spec(name),
            api.ExecSpec(engine=engine, eval_every=2, **ex),
            rounds=rounds).compile().run()
        torch.cuda.synchronize()
        assert {k: v for k, v in backend.LAUNCHES.items() if v} == \
            {k: n * rounds for k, n in per_round.items()}
    for k, v in runs['scan'].final_global.items():
        assert v.is_cuda and torch.equal(v, runs['loop'].final_global[k])
    losses = [e['loss'] for _, e in runs['scan'].evals()]
    assert all(np.isfinite(losses))
    members = [api.SweepMember(env=spec, seed=s,
                               overrides={'crash_prob': cr, 'draw_seed': s})
               for s, cr in enumerate((0.1, 0.3, 0.5))]
    hists = {}
    for engine in ('fleet', 'sequential'):
        backend.reset_launches()
        hists[engine] = api.Experiment(
            task, None, api.spec(name),
            api.ExecSpec(engine=engine, eval_every=2, **ex),
            rounds=rounds).compile().run_sweep(members)
        torch.cuda.synchronize()
        counts = {k: v for k, v in backend.LAUNCHES.items() if v}
        if engine == 'fleet':
            assert counts == {k + '_fleet': n * rounds
                              for k, n in per_round.items()}
        else:
            assert counts == {k: n * rounds * 3 for k, n in per_round.items()}
    for f, q in zip(hists['fleet'], hists['sequential']):
        for k, v in q.final_global.items():
            torch.testing.assert_close(f.final_global[k], v, rtol=0,
                                       atol=1e-5)


def test_operand_on_another_device_raises(dev):
    t = _inputs(4, 2048, dev)
    with pytest.raises(ValueError, match='weights'):
        safa_aggregate_packed(t['cache'], t['trained'], t['global_prev'],
                              t['picked'], t['undrafted'], t['deprecated'],
                              t['weights'].cpu())
    assert backend.LAUNCHES['safa_aggregate_packed'] == 0


# ---------------------------------------------------------------------------
# The weighted merge (kernel 10) and the staleness-adaptive family
# ---------------------------------------------------------------------------

def _merge_inputs(m, n, dev, seed, lead=(), case='seeded'):
    """Uploads, global and weight rows zero off a seeded commit mask that
    sum to 0.6; ``case`` 'zero' zeroes every weight, 'one' keeps a single
    commit."""
    rng = np.random.default_rng(seed)
    w = rng.random(lead + (m,)) * (rng.random(lead + (m,)) < 0.7)
    if case != 'seeded':
        w[...] = 0.0
        if case == 'one':
            w[..., m // 3] = 1.0
    tot = w.sum(-1, keepdims=True)
    w = np.where(tot > 0, 0.6 * w / np.where(tot > 0, tot, 1.0), 0.0)
    return (torch.as_tensor(rng.normal(size=lead + (m, n)).astype(np.float32),
                            device=dev),
            torch.as_tensor(rng.normal(size=lead + (n,)).astype(np.float32),
                            device=dev),
            torch.as_tensor(w, dtype=torch.float32, device=dev))


@pytest.mark.parametrize('case', ['seeded', 'zero', 'one'])
@pytest.mark.parametrize('m,n', [(5, 4096), (100, 4096), (300, 2048)])
def test_weighted_merge_packed_matches_plain(dev, m, n, case):
    t, g, w = _merge_inputs(m, n, dev, seed=m + n, case=case)
    got = weighted_merge_packed(t, g, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.weighted_merge_ref(t, g, w),
                               rtol=1e-5, atol=1e-6)
    if case == 'zero':
        assert torch.equal(got, g)
    assert backend.LAUNCHES['weighted_merge_packed'] == 1


@pytest.mark.parametrize('s,m,n', [(2, 5, 4096), (4, 100, 4096),
                                   (3, 300, 2048)])
def test_weighted_merge_packed_fleet_matches_plain_and_single_run(dev, s, m,
                                                                  n):
    t, g, w = _merge_inputs(m, n, dev, seed=s + m, lead=(s,))
    w[0] = 0.0                            # a member with no commit
    got = weighted_merge_packed_fleet(t, g, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.weighted_merge_ref(t, g, w),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(got[0], g[0])
    for i in range(s):
        assert torch.equal(got[i], weighted_merge_packed(
            t[i].contiguous(), g[i].contiguous(), w[i].contiguous()))
    assert backend.LAUNCHES['weighted_merge_packed_fleet'] == 1


@pytest.mark.parametrize('case', ['device', 'dtype', 'width', 'contiguity'])
def test_weighted_merge_refuses_bad_operands(dev, case):
    t, g, w = _merge_inputs(4, 2048, dev, seed=0)
    err, args = {
        'device': (ValueError, (t, g, w.cpu())),
        'dtype': (TypeError, (t.double(), g, w)),
        'width': (ValueError, (t[:, :1000].contiguous(), g[:1000], w)),
        'contiguity': (ValueError, (t.t().contiguous().t(), g, w)),
    }[case]
    with pytest.raises(err):
        weighted_merge_packed(*args)
    assert backend.LAUNCHES['weighted_merge_packed'] == 0


#: weighted cell -> (protocol name, exec fields, launches per round of the
#: single-run kernels; the fleet launches the ``*_fleet`` ones)
WEIGHTED_CELLS = {
    'seafl-packed': ('seafl', dict(use_kernel='packed'),
                     {'weighted_merge_packed': 1}),
    'seafl-int8': ('seafl', dict(use_kernel='packed', wire='int8'),
                   {'weighted_merge_packed': 1, 'quantize_packed': 1,
                    'dequantize_packed': 1}),
    'seafl-plain': ('seafl', {}, {}),
    'csafl-packed': ('csafl', dict(use_kernel='packed'),
                     {'weighted_merge_packed': 1}),
    'csafl-int8': ('csafl', dict(wire='int8'),
                   {'quantize_packed': 1, 'dequantize_packed': 1}),
    'csafl-plain': ('csafl', {}, {}),
}


@pytest.mark.parametrize('cell', sorted(WEIGHTED_CELLS))
def test_weighted_run_and_sweep_on_the_card(dev, cell):
    """SEAFL and CSAFL on the card through ``run()`` (scan and loop) and a
    mixed-scheme ``run_sweep()`` (fleet and sequential): each kernel
    launches once per round (the fleet's forms once per round for all
    members); scan equals loop bit for bit; fleet and sequential train
    the same replicas in batches of other sizes, so they are held to atol
    1e-5."""
    from repro_torch import api
    from repro_torch.fedsim import EnvSpec
    spec = EnvSpec(m=5, crash_prob=0.3, dataset_size=506, batch_size=5,
                   epochs=3, t_lim=830.0, seed=3)
    task = _regression(spec)
    name, ex, per_round = WEIGHTED_CELLS[cell]
    rounds = 4
    runs = {}
    for engine in ('scan', 'loop'):
        backend.reset_launches()
        runs[engine] = api.Experiment(
            task, spec, api.spec(name),
            api.ExecSpec(engine=engine, eval_every=2, **ex),
            rounds=rounds).compile().run()
        torch.cuda.synchronize()
        assert {k: v for k, v in backend.LAUNCHES.items() if v} == \
            {k: n * rounds for k, n in per_round.items()}
    for k, v in runs['scan'].final_global.items():
        assert v.is_cuda and torch.equal(v, runs['loop'].final_global[k])
    assert all(np.isfinite([e['loss'] for _, e in runs['scan'].evals()]))
    members = [api.SweepMember(env=spec, seed=s, overrides=dict(
        {'crash_prob': cr, 'draw_seed': s}, **ov))
        for s, (cr, ov) in enumerate(((0.1, {}), (0.3, {'scheme': 'csafl'}),
                                      (0.5, {'scheme': 'fedasync'})))]
    hists = {}
    for engine in ('fleet', 'sequential'):
        backend.reset_launches()
        hists[engine] = api.Experiment(
            task, None, api.spec(name),
            api.ExecSpec(engine=engine, eval_every=2, **ex),
            rounds=rounds).compile().run_sweep(members)
        torch.cuda.synchronize()
        counts = {k: v for k, v in backend.LAUNCHES.items() if v}
        if engine == 'fleet':
            assert counts == {k + '_fleet': n * rounds
                              for k, n in per_round.items()}
        else:
            assert counts == {k: n * rounds * 3 for k, n in per_round.items()}
    for f, q in zip(hists['fleet'], hists['sequential']):
        for k, v in q.final_global.items():
            torch.testing.assert_close(f.final_global[k], v, rtol=0,
                                       atol=1e-5)


# ---------------------------------------------------------------------------
# The sparse schedules: row gather/scatter (kernels 11, 12) and the rows
# aggregations (kernels 15, 16)
# ---------------------------------------------------------------------------

#: (R, K, N): R = m + 1 buffer rows with the scratch row last; K slots.
#: N = 6144 is no multiple of the gather's 4096-float run, and m = 300
#: with K = 300 takes more slots than one 256-slot chunk
ROWS_SHAPES = [(14, 7, 4096), (1001, 124, 2048), (301, 300, 6144)]


def _rows_case(r, k, n, dev, seed):
    """Seeded rows operands: distinct sorted rows then sentinel slots (r -
    1), as a sparse schedule emits them, every role combination among the
    real slots, and weights that are data shares as the env's are (summing
    to 1 over the real slots, 0 at the sentinels)."""
    rng = np.random.default_rng(seed)
    real = max(1, k - 3)
    rows = np.full(k, r - 1, np.int32)
    rows[:real] = np.sort(rng.choice(r - 1, real, replace=False))
    roles = np.zeros(k, np.uint8)
    roles[:real] = rng.integers(0, 32, real)
    w = np.zeros(k)
    w[:real] = rng.dirichlet(np.ones(real))
    t = {'rows': torch.as_tensor(rows, device=dev),
         'roles': torch.as_tensor(roles, device=dev),
         'w': torch.as_tensor(w, dtype=torch.float32, device=dev)}
    for name, shape in (('cache', (r, n)), ('trained', (k, n)),
                        ('base', (k, n)), ('global_prev', (n,)),
                        ('agg', (n,))):
        t[name] = torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                                  device=dev)
    return t


@pytest.mark.parametrize('r,k,n', ROWS_SHAPES)
def test_gather_rows_matches_plain(dev, r, k, n):
    t = _rows_case(r, k, n, dev, 0)
    rows = t['rows'].clone()
    rows[0] = rows[1]                         # a duplicate source row
    rows[-1] = -5                             # out of range: the scratch row
    got = gather_rows(t['cache'], rows)
    again = gather_rows(t['cache'], rows)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.gather_rows_ref(t['cache'], rows))
    assert torch.equal(got, again)
    assert torch.equal(got[-1], t['cache'][-1])
    assert backend.LAUNCHES['gather_rows'] == 2


@pytest.mark.parametrize('r,k,n', ROWS_SHAPES)
def test_scatter_rows_matches_plain(dev, r, k, n):
    """In place, the last slot winning on duplicate rows, the same bits on
    every launch."""
    t = _rows_case(r, k, n, dev, 1)
    rows = t['rows'].clone()
    rows[1] = rows[0]                         # slot 1 overwrites slot 0
    rows[-2] = r + 3                          # out of range: the scratch row
    vals = t['trained']
    want = ref.scatter_rows_ref(t['cache'].clone(), rows, vals)
    outs = []
    for _ in range(2):
        buf = t['cache'].clone()
        out = scatter_rows(buf, rows, vals)
        torch.cuda.synchronize()
        assert out is buf
        outs.append(out)
    assert torch.equal(outs[0], want) and torch.equal(outs[1], want)
    assert torch.equal(outs[0][rows[0].long()], vals[1])
    assert torch.equal(outs[0][-1], vals[-1])  # the last sentinel slot
    assert backend.LAUNCHES['scatter_rows'] == 2


@pytest.mark.parametrize('r,k,n', ROWS_SHAPES)
def test_rows_aggregate_matches_plain(dev, r, k, n):
    t = _rows_case(r, k, n, dev, 2)
    t['rows'][-1] = r + 3                     # a sentinel out of range
    args = (t['cache'], t['trained'], t['global_prev'], t['agg'], t['rows'],
            t['roles'], t['w'])
    want = ref.safa_aggregate_rows_ref(*args)
    got = safa_aggregate_packed_rows(*args)
    again = safa_aggregate_packed_rows(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[2], want[2])
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert backend.LAUNCHES['safa_aggregate_packed_rows'] == 2


@pytest.mark.parametrize('r,k,n', ROWS_SHAPES)
def test_q8_rows_aggregate_matches_plain(dev, r, k, n):
    t = _rows_case(r, k, n, dev, 3)
    t['rows'][-1] = -1                        # a sentinel out of range
    q, s = ref.quantize_packed_ref(t['trained'])
    args = (q, s, t['base'], t['cache'], t['global_prev'], t['agg'],
            t['rows'], t['roles'], t['w'])
    want = ref.safa_aggregate_q8_rows_ref(*args)
    got = safa_aggregate_packed_q8_rows(*args)
    again = safa_aggregate_packed_q8_rows(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert backend.LAUNCHES['safa_aggregate_packed_q8_rows'] == 2


def test_rows_kernels_refuse_bad_operands(dev):
    t = _rows_case(14, 7, 2048, dev, 4)
    with pytest.raises(TypeError, match='rows'):
        gather_rows(t['cache'], t['rows'].long())
    with pytest.raises(TypeError, match='roles'):
        safa_aggregate_packed_rows(t['cache'], t['trained'],
                                   t['global_prev'], t['agg'], t['rows'],
                                   t['roles'].int(), t['w'])
    with pytest.raises(ValueError, match='w_rows'):
        safa_aggregate_packed_rows(t['cache'], t['trained'],
                                   t['global_prev'], t['agg'], t['rows'],
                                   t['roles'], t['w'].cpu())
    assert all(v == 0 for v in backend.LAUNCHES.values())


#: sparse cell -> (protocol name, exec fields, launches per round)
SPARSE_CELLS = {
    'safa-sparse-packed': ('safa', dict(schedule='sparse',
                                        use_kernel='packed'),
                           {'safa_aggregate_packed': 1}),
    'safa-sparse-int8': ('safa', dict(schedule='sparse', wire='int8'),
                         {'quantize_packed': 1,
                          'safa_aggregate_packed_q8': 1}),
    'safa-delta': ('safa', dict(schedule='sparse_delta'), {}),
    'safa-delta-packed': ('safa', dict(schedule='sparse_delta',
                                       use_kernel='packed'),
                          {'gather_rows': 1, 'safa_aggregate_packed_rows': 1,
                           'scatter_rows': 2}),
    'safa-delta-packed-int8': ('safa', dict(schedule='sparse_delta',
                                            use_kernel='packed',
                                            wire='int8'),
                               {'gather_rows': 1, 'quantize_packed': 1,
                                'safa_aggregate_packed_q8_rows': 1,
                                'scatter_rows': 2}),
    'fedavg-sparse': ('fedavg', dict(schedule='sparse'), {}),
    'fedavg-delta-int8': ('fedavg', dict(schedule='sparse_delta',
                                         wire='int8'),
                          {'quantize_packed': 1, 'dequantize_packed': 1}),
    'fedcs-delta': ('fedcs', dict(schedule='sparse_delta'), {}),
}


@pytest.mark.parametrize('cell', sorted(SPARSE_CELLS))
def test_sparse_run_on_the_card(dev, cell):
    """Sparse single runs on the card through ``run()`` (scan and loop):
    each kernel launches as often per round as the cell says; scan equals
    loop bit for bit; the run ends within atol 1e-5 of the same cell's
    dense run (1e-4 on the int8 wire: the dense int8 run quantises the
    same uploads)."""
    from repro_torch import api
    from repro_torch.fedsim import EnvSpec
    spec = EnvSpec(m=24, crash_prob=0.3, dataset_size=480, batch_size=10,
                   epochs=1, t_lim=200.0, seed=3)
    task = _regression(spec)
    name, ex, per_round = SPARSE_CELLS[cell]
    rounds = 6
    runs = {}
    for engine in ('scan', 'loop'):
        backend.reset_launches()
        runs[engine] = api.Experiment(
            task, spec, api.spec(name, fraction=0.3),
            api.ExecSpec(engine=engine, eval_every=3, **ex),
            rounds=rounds).compile().run()
        torch.cuda.synchronize()
        assert {k: v for k, v in backend.LAUNCHES.items() if v} == \
            {k: n * rounds for k, n in per_round.items()}
    for k, v in runs['scan'].final_global.items():
        assert v.is_cuda and torch.equal(v, runs['loop'].final_global[k])
    assert all(np.isfinite([e['loss'] for _, e in runs['scan'].evals()]))
    dense = api.Experiment(task, spec, api.spec(name, fraction=0.3),
                           api.ExecSpec(eval_every=3, **dict(
                               ex, schedule='dense')),
                           rounds=rounds).compile().run()
    atol = 1e-4 if ex.get('wire') == 'int8' else 1e-5
    for k, v in dense.final_global.items():
        torch.testing.assert_close(runs['scan'].final_global[k], v, rtol=0,
                                   atol=atol)


# ---------------------------------------------------------------------------
# Sparse sweeps: the S-axis row gather/scatter (kernels 13, 14) and rows
# aggregations (kernels 17, 18)
# ---------------------------------------------------------------------------

ROWS_FLEET_SHAPES = [(3, 14, 7, 4096), (3, 1001, 124, 2048),
                     (3, 301, 300, 6144)]


def _rows_fleet_case(s, r, k, n, dev, seed):
    """S members' seeded rows operands (``_rows_case`` per member, each
    with its own rows, roles and weights), stacked; member 0 has a
    duplicate real row, member 1 rows outside [0, R)."""
    cases = [_rows_case(r, k, n, dev, seed + 10 * i) for i in range(s)]
    t = {name: torch.stack([c[name] for c in cases]) for name in cases[0]}
    t['rows'][0, 1] = t['rows'][0, 0]
    t['rows'][1, 0], t['rows'][1, -1] = -1, r + 7
    return t


def _per_member(got, single, s):
    """Fleet outputs ``got`` equal the single-run kernel's on every
    member's slices (``single(i)``), bit for bit."""
    for i in range(s):
        want = single(i)
        for g, w in zip(got, want):
            assert torch.equal(g[i], w), i


@pytest.mark.parametrize('s,r,k,n', ROWS_FLEET_SHAPES)
def test_gather_rows_fleet_matches_plain_and_single_run(dev, s, r, k, n):
    t = _rows_fleet_case(s, r, k, n, dev, 0)
    got = gather_rows_fleet(t['cache'], t['rows'])
    again = gather_rows_fleet(t['cache'], t['rows'])
    torch.cuda.synchronize()
    assert torch.equal(got, ref.gather_rows_ref(t['cache'], t['rows']))
    assert torch.equal(got, again)
    assert torch.equal(got[1, 0], t['cache'][1, -1])
    assert backend.LAUNCHES['gather_rows_fleet'] == 2
    _per_member((got,), lambda i: (gather_rows(t['cache'][i],
                                               t['rows'][i]),), s)


@pytest.mark.parametrize('s,r,k,n', ROWS_FLEET_SHAPES)
def test_scatter_rows_fleet_matches_plain_and_single_run(dev, s, r, k, n):
    t = _rows_fleet_case(s, r, k, n, dev, 1)
    want = ref.scatter_rows_ref(t['cache'].clone(), t['rows'], t['trained'])
    outs = []
    for _ in range(2):
        buf = t['cache'].clone()
        out = scatter_rows_fleet(buf, t['rows'], t['trained'])
        torch.cuda.synchronize()
        assert out is buf
        outs.append(out)
    assert torch.equal(outs[0], want) and torch.equal(outs[1], want)
    assert torch.equal(outs[0][0, t['rows'][0, 0].long()], t['trained'][0, 1])
    assert backend.LAUNCHES['scatter_rows_fleet'] == 2
    _per_member((outs[0],), lambda i: (scatter_rows(
        t['cache'][i].clone(), t['rows'][i], t['trained'][i]),), s)


@pytest.mark.parametrize('s,r,k,n', ROWS_FLEET_SHAPES)
def test_rows_aggregate_fleet_matches_plain_and_single_run(dev, s, r, k, n):
    t = _rows_fleet_case(s, r, k, n, dev, 2)
    args = (t['cache'], t['trained'], t['global_prev'], t['agg'], t['rows'],
            t['roles'], t['w'])
    want = ref.safa_aggregate_rows_ref(*args)
    got = safa_aggregate_packed_rows_fleet(*args)
    again = safa_aggregate_packed_rows_fleet(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[2], want[2])
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert backend.LAUNCHES['safa_aggregate_packed_rows_fleet'] == 2
    _per_member(got, lambda i: safa_aggregate_packed_rows(
        *(a[i] for a in args)), s)


@pytest.mark.parametrize('s,r,k,n', ROWS_FLEET_SHAPES)
def test_q8_rows_aggregate_fleet_matches_plain_and_single_run(dev, s, r, k,
                                                              n):
    t = _rows_fleet_case(s, r, k, n, dev, 3)
    q, sc = ref.quantize_packed_ref(t['trained'])
    args = (q, sc, t['base'], t['cache'], t['global_prev'], t['agg'],
            t['rows'], t['roles'], t['w'])
    want = ref.safa_aggregate_q8_rows_ref(*args)
    got = safa_aggregate_packed_q8_rows_fleet(*args)
    again = safa_aggregate_packed_q8_rows_fleet(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert backend.LAUNCHES['safa_aggregate_packed_q8_rows_fleet'] == 2
    _per_member(got, lambda i: safa_aggregate_packed_q8_rows(
        *(a[i] for a in args)), s)


def test_fleet_rows_kernels_refuse_bad_operands(dev):
    t = _rows_fleet_case(2, 14, 7, 2048, dev, 4)
    with pytest.raises(ValueError, match=r'\[S, R, N\]'):
        gather_rows_fleet(t['cache'][0], t['rows'][0])
    with pytest.raises(TypeError, match='rows'):
        scatter_rows_fleet(t['cache'], t['rows'].long(), t['trained'])
    with pytest.raises(ValueError, match='agg'):
        safa_aggregate_packed_rows_fleet(
            t['cache'], t['trained'], t['global_prev'], t['agg'][0],
            t['rows'], t['roles'], t['w'])
    assert all(v == 0 for v in backend.LAUNCHES.values())


@pytest.mark.parametrize('cell', sorted(SPARSE_CELLS))
def test_sparse_sweep_on_the_card(dev, cell):
    """Two-round sparse sweeps on the card, both engines: the fleet
    launches each kernel's fleet form as often per round as the cell's
    single run launches the single-run kernel, the sequential engine the
    single-run kernels once per member; fleet and sequential train in
    batches of other sizes, so they are held to atol 1e-5 (1e-4 on the
    int8 wire), not bit for bit."""
    from repro_torch import api
    from repro_torch.fedsim import EnvSpec
    spec = EnvSpec(m=24, crash_prob=0.3, dataset_size=480, batch_size=10,
                   epochs=1, t_lim=200.0, seed=3)
    task = _regression(spec)
    name, ex, per_round = SPARSE_CELLS[cell]
    members = [api.SweepMember(env=spec, fraction=f, seed=i,
                               overrides={'crash_prob': cr})
               for i, (f, cr) in enumerate(((0.3, 0.1), (0.2, 0.5),
                                            (0.4, 0.3)))]
    rounds = 2
    hists = {}
    for engine in ('fleet', 'sequential'):
        backend.reset_launches()
        hists[engine] = api.Experiment(
            task, None, api.spec(name),
            api.ExecSpec(engine=engine, eval_every=1, **ex),
            rounds=rounds).compile().run_sweep(members)
        torch.cuda.synchronize()
        counts = {k: v for k, v in backend.LAUNCHES.items() if v}
        if engine == 'fleet':
            assert counts == {k + '_fleet': n * rounds
                              for k, n in per_round.items()}
        else:
            assert counts == {k: n * rounds * len(members)
                              for k, n in per_round.items()}
    atol = 1e-4 if ex.get('wire') == 'int8' else 1e-5
    for f, q in zip(hists['fleet'], hists['sequential']):
        assert all(np.isfinite([e['loss'] for _, e in f.evals()]))
        for k, v in q.final_global.items():
            assert v.is_cuda
            torch.testing.assert_close(f.final_global[k], v, rtol=0,
                                       atol=atol)


# ---------------------------------------------------------------------------
# The lag tier: the tier-rows kernels (19, 20) and their S-axis forms
# ---------------------------------------------------------------------------

#: (R = capacity + 1 buffer rows, K slots, N): a small buffer, the m = 1000
#: quota-bounded shape, and more slots than one 256-slot chunk
TIER_SHAPES = [(10, 8, 4096), (123, 124, 2048), (301, 300, 6144)]


def _tier_case(r, k, n, dev, seed):
    """Seeded tier operands laid out as a tier schedule lays out a round:
    the real slots read rows of the lower half of the buffer (repeats
    allowed) and write distinct rows of the upper half or the scratch row
    r - 1 (several slots, so the last must win it); slots without a
    cache role read the scratch row; three sentinel slots (role 0, weight
    0) read and write the scratch row; the weights are data shares."""
    rng = np.random.default_rng(seed)
    cap = r - 1
    real = max(2, k - 3)
    live = cap // 2
    roles = np.zeros(k, np.uint8)
    roles[:real] = rng.integers(1, 32, real)
    srcs = np.full(k, cap, np.int32)
    dsts = np.full(k, cap, np.int32)
    reads = (roles[:real] & (4 | 8 | 16)) != 0
    srcs[:real] = np.where(reads, rng.integers(0, max(live, 1), real), cap)
    n_w = min(real // 2, cap - live)
    who = rng.choice(real, n_w, replace=False)
    dsts[who] = live + rng.choice(cap - live, n_w, replace=False)
    w = np.zeros(k)
    w[:real] = rng.dirichlet(np.ones(real))
    t = {'srcs': torch.as_tensor(srcs, device=dev),
         'dsts': torch.as_tensor(dsts, device=dev),
         'roles': torch.as_tensor(roles, device=dev),
         'w': torch.as_tensor(w, dtype=torch.float32, device=dev)}
    for name, shape in (('buf', (r, n)), ('trained', (k, n)),
                        ('base', (k, n)), ('global_prev', (n,)),
                        ('agg', (n,))):
        t[name] = torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                                  device=dev)
    assert int((dsts == cap).sum()) >= 2
    return t


def _tier_args(t, kernel, buf):
    if kernel == 'tier':
        return (buf, t['trained'], t['global_prev'], t['agg'], t['srcs'],
                t['dsts'], t['roles'], t['w'])
    q, sc = ref.quantize_packed_ref(t['trained'])
    return (q, sc, t['base'], buf, t['global_prev'], t['agg'], t['srcs'],
            t['dsts'], t['roles'], t['w'])


TIER_KERNELS = {
    'tier': (safa_aggregate_packed_tier_rows,
             safa_aggregate_packed_tier_rows_fleet,
             ref.safa_aggregate_tier_rows_ref),
    'q8_tier': (safa_aggregate_packed_q8_tier_rows,
                safa_aggregate_packed_q8_tier_rows_fleet,
                ref.safa_aggregate_q8_tier_rows_ref)}


@pytest.mark.parametrize('kernel', sorted(TIER_KERNELS))
@pytest.mark.parametrize('r,k,n', TIER_SHAPES)
def test_tier_rows_match_plain(dev, kernel, r, k, n):
    """In place, the whole buffer (scratch row included) bit for bit the
    plain version's, the same bits on every launch; new_global and
    new_agg within rtol 1e-5 / atol 1e-6."""
    single, _, plain = TIER_KERNELS[kernel]
    t = _tier_case(r, k, n, dev, 7)
    want = plain(*_tier_args(t, kernel, t['buf'].clone()))
    outs = []
    for _ in range(2):
        buf = t['buf'].clone()
        got = single(*_tier_args(t, kernel, buf))
        torch.cuda.synchronize()
        assert got[2] is buf
        outs.append(got)
    for got in outs:
        assert torch.equal(got[2], want[2])
        for g, w in zip(got[:2], want[:2]):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert backend.LAUNCHES['safa_aggregate_packed_' + kernel + '_rows'] == 2


@pytest.mark.parametrize('kernel', sorted(TIER_KERNELS))
@pytest.mark.parametrize('r,k,n', TIER_SHAPES)
def test_tier_rows_fleet_match_plain_and_single_run(dev, kernel, r, k, n):
    single, fleet, plain = TIER_KERNELS[kernel]
    cases = [_tier_case(r, k, n, dev, 20 + i) for i in range(3)]
    t = {name: torch.stack([c[name] for c in cases]) for name in cases[0]}
    want = plain(*_tier_args(t, kernel, t['buf'].clone()))
    buf = t['buf'].clone()
    got = fleet(*_tier_args(t, kernel, buf))
    torch.cuda.synchronize()
    assert got[2] is buf
    assert torch.equal(got[2], want[2])
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    args = _tier_args(t, kernel, t['buf'])
    for i in range(3):
        one = single(*(a[i].clone() if a is t['buf'] else a[i]
                       for a in args))
        for g, w in zip(got, one):
            assert torch.equal(g[i], w), i
    assert backend.LAUNCHES[
        'safa_aggregate_packed_' + kernel + '_rows_fleet'] == 1


def test_tier_kernels_refuse_bad_operands(dev):
    t = _tier_case(10, 8, 2048, dev, 8)
    with pytest.raises(TypeError, match='dsts'):
        safa_aggregate_packed_tier_rows(
            t['buf'], t['trained'], t['global_prev'], t['agg'], t['srcs'],
            t['dsts'].long(), t['roles'], t['w'])
    with pytest.raises(TypeError, match='srcs'):
        safa_aggregate_packed_tier_rows(
            t['buf'], t['trained'], t['global_prev'], t['agg'],
            t['srcs'].long(), t['dsts'], t['roles'], t['w'])
    with pytest.raises(ValueError, match='trained_rows'):
        safa_aggregate_packed_tier_rows(
            t['buf'], t['trained'][:4], t['global_prev'], t['agg'],
            t['srcs'], t['dsts'], t['roles'], t['w'])
    with pytest.raises(ValueError, match=r'buf \[S, R, N\]'):
        safa_aggregate_packed_tier_rows_fleet(
            t['buf'], t['trained'], t['global_prev'], t['agg'], t['srcs'],
            t['dsts'], t['roles'], t['w'])
    with pytest.raises(ValueError, match='contiguous'):
        safa_aggregate_packed_tier_rows(
            t['buf'].t().contiguous().t(), t['trained'], t['global_prev'],
            t['agg'], t['srcs'], t['dsts'], t['roles'], t['w'])
    assert all(v == 0 for v in backend.LAUNCHES.values())


#: tier cell -> (exec fields, launches per round of a single run; a fleet
#: launches the ``*_fleet`` forms as often)
TIER_CELLS = {
    'plain': ({}, {}),
    'plain-int8': (dict(wire='int8'), {'quantize_packed': 1,
                                       'dequantize_packed': 1}),
    'packed': (dict(use_kernel='packed'),
               {'gather_rows': 1, 'safa_aggregate_packed_tier_rows': 1}),
    'packed-int8': (dict(use_kernel='packed', wire='int8'),
                    {'gather_rows': 1, 'quantize_packed': 1,
                     'safa_aggregate_packed_q8_tier_rows': 1}),
}


def _tier_spec():
    from repro_torch.fedsim import EnvSpec
    return EnvSpec(m=24, crash_prob=0.3, dataset_size=480, batch_size=10,
                   epochs=1, t_lim=200.0, seed=3)


@pytest.mark.parametrize('cell', sorted(TIER_CELLS))
def test_tier_run_on_the_card(dev, cell):
    """Lag-tier runs on the card through ``run()`` (scan and loop): each
    kernel launches as often per round as the cell says; scan equals loop
    bit for bit; the run ends within atol 1e-5 of the same cell's
    ``'sparse_delta'`` run (1e-4 on the int8 wire)."""
    from repro_torch import api
    spec = _tier_spec()
    task = _regression(spec)
    ex, per_round = TIER_CELLS[cell]
    rounds = 6
    runs = {}
    for engine in ('scan', 'loop'):
        backend.reset_launches()
        runs[engine] = api.Experiment(
            task, spec, api.SafaSpec(fraction=0.3, lag_tolerance=2),
            api.ExecSpec(engine=engine, eval_every=3, schedule='sparse_tier',
                         **ex), rounds=rounds).compile().run()
        torch.cuda.synchronize()
        assert {k: v for k, v in backend.LAUNCHES.items() if v} == \
            {k: n * rounds for k, n in per_round.items()}
    for k, v in runs['scan'].final_global.items():
        assert v.is_cuda and torch.equal(v, runs['loop'].final_global[k])
    assert all(np.isfinite([e['loss'] for _, e in runs['scan'].evals()]))
    delta = api.Experiment(task, spec,
                           api.SafaSpec(fraction=0.3, lag_tolerance=2),
                           api.ExecSpec(eval_every=3, schedule='sparse_delta',
                                        **ex), rounds=rounds).compile().run()
    atol = 1e-4 if ex.get('wire') == 'int8' else 1e-5
    for k, v in delta.final_global.items():
        torch.testing.assert_close(runs['scan'].final_global[k], v, rtol=0,
                                   atol=atol)


@pytest.mark.parametrize('cell', sorted(TIER_CELLS))
def test_tier_sweep_on_the_card(dev, cell):
    """Two-round lag-tier sweeps on the card, both engines: the fleet
    launches each kernel's fleet form as often per round as the cell's
    single run launches the single-run kernel, the sequential engine the
    single-run kernels once per member; the two train in batches of
    other sizes, so they are held to atol 1e-5 (1e-4 on the int8 wire)."""
    from repro_torch import api
    spec = _tier_spec()
    task = _regression(spec)
    ex, per_round = TIER_CELLS[cell]
    members = [api.SweepMember(env=spec, fraction=f, lag_tolerance=tau,
                               seed=i, overrides={'crash_prob': cr})
               for i, (f, cr, tau) in enumerate(((0.3, 0.1, 3),
                                                 (0.2, 0.5, 2),
                                                 (0.4, 0.3, 4)))]
    rounds = 2
    hists = {}
    for engine in ('fleet', 'sequential'):
        backend.reset_launches()
        hists[engine] = api.Experiment(
            task, None, api.SafaSpec(),
            api.ExecSpec(engine=engine, eval_every=1, schedule='sparse_tier',
                         **ex), rounds=rounds).compile().run_sweep(members)
        torch.cuda.synchronize()
        counts = {k: v for k, v in backend.LAUNCHES.items() if v}
        if engine == 'fleet':
            assert counts == {k + '_fleet': n * rounds
                              for k, n in per_round.items()}
        else:
            assert counts == {k: n * rounds * len(members)
                              for k, n in per_round.items()}
    atol = 1e-4 if ex.get('wire') == 'int8' else 1e-5
    for f, q in zip(hists['fleet'], hists['sequential']):
        assert all(np.isfinite([e['loss'] for _, e in f.evals()]))
        for k, v in q.final_global.items():
            assert v.is_cuda
            torch.testing.assert_close(f.final_global[k], v, rtol=0,
                                       atol=atol)


# ---------------------------------------------------------------------------
# Kernel 20's ring (a persistent block streams slot segments of 1,024
# columns through a 6-stage shared-memory ring; slots staged 512 at a time)
# ---------------------------------------------------------------------------

#: case -> (R buffer rows, K slots, N, layout): one slot; K not a multiple
#: of the ring's depth; past the 256-slot chunk of the register-tiled
#: kernel and past the ring's 512-slot staging chunk; one pack tile; the
#: main path's width at its K; every c2 aimed at the scratch row (round
#: 2's shape); slots sharing non-scratch destinations; every slot that
#: needs a trained row without an upload (base rows)
RING_CASES = {
    'k1': (10, 1, 4096, 'mixed'),
    'k13': (20, 13, 4096, 'mixed'),
    'k300': (301, 300, 2048, 'mixed'),
    'k700': (701, 700, 2048, 'mixed'),
    'n2048': (123, 124, 2048, 'mixed'),
    'n342016': (123, 124, 342_016, 'mixed'),
    'all-scratch': (123, 124, 6144, 'scratch'),
    'dup-dst': (40, 60, 4096, 'dup'),
    'base-rows': (40, 60, 4096, 'base'),
}


def _ring_case(r, k, n, dev, seed, layout, real=None):
    """Seeded kernel 20 operands laid out as a tier round: ``real`` slots
    (all K unless given) read rows of the lower half of the buffer
    (repeats allowed; the scratch row where no role reads the cache) and
    write as ``layout`` says: 'mixed' distinct rows of the upper half for
    half of them and the scratch row for the rest, 'scratch' the scratch
    row all, 'dup' two or three upper rows shared by all, 'base' as
    'mixed' with every slot picked or undrafted and none committed.  The
    slots past ``real`` are sentinels (role 0, weight 0, the scratch row),
    as a fleet pads a narrower member."""
    rng = np.random.default_rng(seed)
    cap = r - 1
    real = k if real is None else real
    live = max(cap // 2, 1)
    roles = np.zeros(k, np.uint8)
    if layout == 'base':
        roles[:real] = rng.choice(np.array([4, 5, 8, 9, 12, 20, 24],
                                           np.uint8), real)
    else:
        roles[:real] = rng.integers(1, 32, real)
    srcs = np.full(k, cap, np.int32)
    dsts = np.full(k, cap, np.int32)
    reads = (roles[:real] & (4 | 8 | 16)) != 0
    srcs[:real] = np.where(reads, rng.integers(0, live, real), cap)
    if layout == 'dup':
        dsts[:real] = live + rng.integers(0, min(3, cap - live), real)
    elif layout != 'scratch':
        n_w = min(real // 2, cap - live)
        who = rng.choice(real, n_w, replace=False)
        dsts[who] = live + rng.choice(cap - live, n_w, replace=False)
    w = np.zeros(k)
    w[:real] = rng.dirichlet(np.ones(real))
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = {'srcs': torch.as_tensor(srcs, device=dev),
         'dsts': torch.as_tensor(dsts, device=dev),
         'roles': torch.as_tensor(roles, device=dev),
         'w': torch.as_tensor(w, dtype=torch.float32, device=dev)}
    for name, shape in (('buf', (r, n)), ('trained', (k, n)),
                        ('base', (k, n)), ('global_prev', (n,)),
                        ('agg', (n,))):
        t[name] = torch.randn(shape, generator=gen, device=dev)
    return t


def _assert_tier_launches_match(got, want):
    """Each launch's buffer bit for bit the plain version's, its vectors
    within rtol 1e-5 / atol 1e-6, and every launch the same bits."""
    for g in got:
        assert torch.equal(g[2], want[2])
        for a, b in zip(g[:2], want[:2]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(*got))


@pytest.mark.parametrize('case', sorted(RING_CASES))
def test_q8_tier_ring_matches_plain(dev, case):
    r, k, n, layout = RING_CASES[case]
    t = _ring_case(r, k, n, dev, 11, layout)
    want = ref.safa_aggregate_q8_tier_rows_ref(
        *_tier_args(t, 'q8_tier', t['buf'].clone()))
    got = []
    for _ in range(2):
        buf = t['buf'].clone()
        got.append(safa_aggregate_packed_q8_tier_rows(
            *_tier_args(t, 'q8_tier', buf)))
        torch.cuda.synchronize()
        assert got[-1][2] is buf
    _assert_tier_launches_match(got, want)
    assert backend.LAUNCHES['safa_aggregate_packed_q8_tier_rows'] == 2


@pytest.mark.parametrize('case', sorted(RING_CASES))
def test_q8_tier_ring_fleet_matches_plain_and_single_run(dev, case):
    """The S-axis form on members of different real K, each padded with
    sentinel slots to the launch's K: against the plain version, twice,
    and each member bit for bit its single launch."""
    r, k, n, layout = RING_CASES[case]
    reals = [k, max(1, k // 2), max(1, k - 7)][:2 if n > 100_000 else 3]
    cases = [_ring_case(r, k, n, dev, 30 + i, layout, real)
             for i, real in enumerate(reals)]
    t = {name: torch.stack([c[name] for c in cases]) for name in cases[0]}
    want = ref.safa_aggregate_q8_tier_rows_ref(
        *_tier_args(t, 'q8_tier', t['buf'].clone()))
    got = [safa_aggregate_packed_q8_tier_rows_fleet(
        *_tier_args(t, 'q8_tier', t['buf'].clone())) for _ in range(2)]
    torch.cuda.synchronize()
    _assert_tier_launches_match(got, want)
    args = _tier_args(t, 'q8_tier', t['buf'])
    for i in range(len(reals)):
        one = safa_aggregate_packed_q8_tier_rows(
            *(a[i].clone() if a is t['buf'] else a[i] for a in args))
        for g, w in zip(got[0], one):
            assert torch.equal(g[i], w), i
    assert backend.LAUNCHES[
        'safa_aggregate_packed_q8_tier_rows_fleet'] == 2


def test_q8_tier_ring_refuses_misaligned_operands(dev):
    """The bulk copies need 16-byte-aligned rows: a q whose data starts 4
    bytes past an aligned address is refused at launch, and nothing is
    written."""
    t = _ring_case(10, 8, 2048, dev, 12, 'mixed')
    q, sc = ref.quantize_packed_ref(t['trained'])
    q_off = torch.empty(q.numel() + 16, dtype=torch.int8, device=dev)
    q_off = q_off[4:4 + q.numel()].view(q.shape)
    q_off.copy_(q)
    buf = t['buf'].clone()
    with pytest.raises(RuntimeError, match='cudaError_t'):
        safa_aggregate_packed_q8_tier_rows(
            q_off, sc, t['base'], buf, t['global_prev'], t['agg'],
            t['srcs'], t['dsts'], t['roles'], t['w'])
    torch.cuda.synchronize()
    assert torch.equal(buf, t['buf'])


# ---------------------------------------------------------------------------
# The gather on a bulk-copy ring (kernels 11 and 13): its edge cases
# ---------------------------------------------------------------------------

def _gather_grid(s, k, n):
    """The gather's launch for s members of k slots of width n:
    (blocks, bytes a block) from ``gather_rows_grid``."""
    import ctypes
    lib, _ = backend.load_library()
    out = (ctypes.c_longlong * 6)()
    assert lib.gather_rows_grid(s, k, n, out) == 0
    return out[4], out[5]


def _gather_rows_of(case, r, k, rng):
    """[k] int32 slot rows of an R-row buffer as ``case`` lays them out."""
    if case == 'one-row':
        return np.full(k, r // 2, np.int32)
    if case == 'out-of-range':
        return rng.choice(np.array([-7, -1, r, r + 1, 2**31 - 1], np.int32),
                          k)
    return rng.integers(0, r, k).astype(np.int32)


#: case -> (R, K, N, row layout): one short segment; every slot on one
#: row; every slot outside [0, R) (the scratch row); more slots than the
#: launch has blocks; the main path's width, with a ragged last segment
GATHER_CASES = {'k1-n2048': (5, 1, 2048, 'seeded'),
                'one-row': (40, 50, 4096, 'one-row'),
                'out-of-range': (30, 40, 6144, 'out-of-range'),
                'k-over-blocks': (2100, 2000, 2048, 'seeded'),
                'n342016': (20, 9, 342_016, 'seeded')}


@pytest.mark.parametrize('case', sorted(GATHER_CASES))
def test_gather_ring_edge_cases_match_plain(dev, case):
    """Kernel 11 at the ring's edge cases equals ``gather_rows_ref`` bit
    for bit on two launches, one launch a call."""
    r, k, n, layout = GATHER_CASES[case]
    rng = np.random.default_rng(40)
    buf = torch.as_tensor(rng.normal(size=(r, n)).astype(np.float32),
                          device=dev)
    rows = torch.as_tensor(_gather_rows_of(layout, r, k, rng), device=dev)
    if case == 'k-over-blocks':
        assert k > _gather_grid(1, k, n)[0]
    want = ref.gather_rows_ref(buf, rows)
    for i in range(2):
        got = gather_rows(buf, rows)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert backend.LAUNCHES['gather_rows'] == i + 1
    if layout == 'out-of-range':
        assert all(torch.equal(g, buf[-1]) for g in got)


#: case -> (S, R, K, N, members' real K): a fleet of one and of four with
#: ragged K (each member padded with sentinel slots, row R - 1, to the
#: launch's K); four members whose byte offsets pass 2**31 in buf
#: (S R N 4 = 2.19e9) and in out (S K N 4 = 2.19e9)
GATHER_FLEET_CASES = {'s1-ragged': (1, 30, 20, 6144, [13]),
                      's4-ragged': (4, 101, 94, 8192, [94, 61, 30, 1]),
                      'past-2gb': (4, 401, 400, 342_016, [400, 399, 1, 250])}


@pytest.mark.parametrize('case', sorted(GATHER_FLEET_CASES))
def test_gather_ring_fleet_edge_cases_match_plain(dev, case):
    """Kernel 13 equals ``gather_rows_ref`` bit for bit on two launches
    (one launch a call) and, member by member, the single-run kernel."""
    s, r, k, n, reals = GATHER_FLEET_CASES[case]
    rng = np.random.default_rng(41)
    gen = torch.Generator(device=dev).manual_seed(41)
    buf = torch.randn((s, r, n), generator=gen, device=dev)
    h = np.full((s, k), r - 1, np.int32)
    for i, real in enumerate(reals):
        h[i, :real] = rng.integers(0, r, real)
    h[-1, 0] = r - 2                         # the last member's last rows
    rows = torch.as_tensor(h, device=dev)
    want = ref.gather_rows_ref(buf, rows)
    for i in range(2):
        got = gather_rows_fleet(buf, rows)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert backend.LAUNCHES['gather_rows_fleet'] == i + 1
    del want
    if case == 'past-2gb':
        assert buf.numel() * 4 > 2**31 and got.numel() * 4 > 2**31
        assert torch.equal(got[-1, 0], buf[-1, r - 2])
        assert torch.equal(got[-1, -1], buf[-1, r - 1])
    for i in range(s):
        assert torch.equal(got[i], gather_rows(buf[i], rows[i])), i


@pytest.mark.parametrize('n', [4, 12, 1020])
def test_gather_ring_wraps_on_rows_narrower_than_a_stage(dev, n):
    """Below the wrapper's widths (the C entry takes any n that is a
    multiple of 4), a block's run spans more items than the ring has
    stages, so the ring wraps: still ``gather_rows_ref`` bit for bit."""
    rng = np.random.default_rng(42)
    r, k = 300, 5000
    buf = torch.as_tensor(rng.normal(size=(r, n)).astype(np.float32),
                          device=dev)
    rows = torch.as_tensor(rng.integers(-2, r + 2, k).astype(np.int32),
                           device=dev)
    out = torch.empty((k, n), device=dev)
    backend.call('gather_rows_f32', dev, buf.data_ptr(), rows.data_ptr(),
                  out.data_ptr(), r, k, n)
    torch.cuda.synchronize()
    assert torch.equal(out, ref.gather_rows_ref(buf, rows))


def test_gather_ring_refuses_misaligned_buffer(dev):
    """The bulk copies need 16-byte-aligned rows: a buf whose data starts
    4 bytes past an aligned address is refused at launch."""
    flat = torch.randn(10 * 2048 + 4, device=dev)
    buf = flat[1:1 + 10 * 2048].view(10, 2048)
    rows = torch.arange(4, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match='cudaError_t'):
        gather_rows(buf, rows)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The per-leaf int8 reference: kernels 5 and 6 and quantize_uploads=True
# ---------------------------------------------------------------------------

#: leaf sizes: the block edges and the CNN's largest leaf (f1)
LEAF_SIZES = [1, 10, 13, 127, 128, 129, 2047, 2048, 2049, 313_600]


@pytest.mark.parametrize('n', LEAF_SIZES)
def test_quantize_rows_match_plain(dev, n):
    """Kernels 5 and 6 on row views of a [3, n] stack, as the per-leaf
    path hands them: any n, base addresses 4-byte aligned only (row k
    starts at byte 4 n k), the first block all zero (scale 1e-30 / 127)."""
    rng = np.random.default_rng(n)
    x = torch.as_tensor(rng.normal(size=(3, n)).astype(np.float32) * 3,
                        device=dev)
    x[0, :128] = 0.0
    for k in range(3):
        row = x[k]
        want_q, want_s = ref.quantize_ref(row)
        q, s = quantize(row)
        got = dequantize(want_q, want_s, n=n)
        torch.cuda.synchronize()
        assert torch.equal(q, want_q)
        assert torch.equal(s, want_s)
        assert torch.equal(got, ref.dequantize_ref(want_q, want_s, n))
    assert backend.LAUNCHES['quantize'] == 3
    assert backend.LAUNCHES['dequantize'] == 3


def test_quantize_kernels_refuse_bad_operands(dev):
    x = torch.ones(300, device=dev)
    with pytest.raises(TypeError, match='float32'):
        quantize(x.double())
    with pytest.raises(ValueError, match='contiguous'):
        quantize(torch.ones(300, 2, device=dev)[:, 0])
    q, s = quantize(x)
    with pytest.raises(ValueError, match='mixed devices'):
        dequantize(q, s.cpu(), n=300)
    assert backend.LAUNCHES['quantize'] == 1
    assert backend.LAUNCHES['dequantize'] == 0


def test_quantize_uploads_run_on_the_card(dev):
    """``SafaSpec(quantize_uploads=True)`` through ``run()`` on the card:
    two launches per leaf per client per round (the regression model has
    two leaves), and with ``use_kernel='packed'`` the ``wire='int8'``
    run's numbers bit for bit on both engines."""
    from repro_torch import api
    from repro_torch.fedsim import EnvSpec
    spec = EnvSpec(m=5, crash_prob=0.3, dataset_size=506, batch_size=5,
                   epochs=3, t_lim=830.0, seed=3)
    task = _regression(spec)
    rounds = 4
    hists = {}
    for name, sp, ex, want in (
            ('wire', api.SafaSpec(), dict(wire='int8'),
             {'quantize_packed': rounds, 'safa_aggregate_packed_q8': rounds}),
            ('scan', api.SafaSpec(quantize_uploads=True),
             dict(use_kernel='packed'),
             {'quantize': rounds * 5 * 2, 'dequantize': rounds * 5 * 2,
              'safa_aggregate_packed': rounds}),
            ('loop', api.SafaSpec(quantize_uploads=True),
             dict(use_kernel='packed', engine='loop'),
             {'quantize': rounds * 5 * 2, 'dequantize': rounds * 5 * 2,
              'safa_aggregate_packed': rounds})):
        backend.reset_launches()
        hists[name] = api.Experiment(task, spec, sp,
                                     api.ExecSpec(eval_every=2, **ex),
                                     rounds=rounds).compile().run()
        torch.cuda.synchronize()
        assert {k: v for k, v in backend.LAUNCHES.items() if v} == want
    for name in ('scan', 'loop'):
        assert hists[name].evals() == hists['wire'].evals()
        for k, v in hists['wire'].final_global.items():
            assert torch.equal(hists[name].final_global[k], v), (name, k)


#: the Task 2 CNN's leaf sizes in sorted-key order (b1, b2, c1, c2, f1,
#: fb1, f2, fb2), then odd widths around the 128-value block
ROWS_LEAF_SIZES = (20, 50, 500, 25_000, 313_600, 128, 1280, 10,
                   1, 13, 127, 129, 2049)


@pytest.mark.parametrize('n', ROWS_LEAF_SIZES)
def test_rows_entry_matches_flat_kernel_on_every_row(dev, n):
    """The rows entries on a [100, n] stack (one leaf of the per-leaf
    path at m = 100): every row bit for bit the flat kernel's launch on
    it and the plain version; each call counts m launches."""
    m = 100
    rng = np.random.default_rng(n + 1)
    x = torch.as_tensor(rng.normal(size=(m, n)).astype(np.float32) * 3,
                        device=dev)
    x[0, :128] = 0.0
    q, s = quantize_rows(x)
    assert backend.LAUNCHES['quantize'] == m
    back = dequantize_rows(q, s, n=n)
    assert backend.LAUNCHES['dequantize'] == m
    want_q, want_s = ref.quantize_ref(x)
    torch.cuda.synchronize()
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    assert torch.equal(back, ref.dequantize_ref(want_q, want_s, n))
    for k in range(m):
        fq, fs = quantize(x[k])
        assert torch.equal(q[k], fq) and torch.equal(s[k], fs), k
        assert torch.equal(back[k], dequantize(fq, fs, n=n)), k
    assert backend.LAUNCHES['quantize'] == 2 * m
    assert backend.LAUNCHES['dequantize'] == 2 * m


class _FailingRows:
    """The loaded library, with the rows entries returning
    cudaErrorInvalidConfiguration (9) as a refused launch would."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        if name in ('quantize_rows_f32', 'dequantize_rows_f32'):
            return lambda *args: 9
        return getattr(self._lib, name)


def test_rows_entry_launch_error_is_raised(dev, monkeypatch):
    """A non-zero cudaError_t from the rows entries raises, and the
    wrappers count no launch: the C entries refuse m = 0 and n = 0 before
    launching, and a wrapper whose entry fails raises too."""
    x = torch.ones(3, 300, device=dev)
    q = torch.empty(3, 300, dtype=torch.int8, device=dev)
    s = torch.empty(3, 3, device=dev)
    for entry, ptrs in (
            ('quantize_rows_f32', (x.data_ptr(), q.data_ptr(), s.data_ptr())),
            ('dequantize_rows_f32',
             (q.data_ptr(), s.data_ptr(), x.data_ptr()))):
        for m, n in ((0, 300), (3, 0)):
            with pytest.raises(RuntimeError, match=f'{entry} failed'):
                backend.call(entry, dev, *ptrs, m, n)
    lib, _ = backend.load_library()
    monkeypatch.setattr(backend, '_lib', _FailingRows(lib))
    with pytest.raises(RuntimeError, match='cudaError_t 9'):
        quantize_rows(x)
    with pytest.raises(RuntimeError, match='cudaError_t 9'):
        dequantize_rows(q, s, n=300)
    assert not any(backend.LAUNCHES.values())



# -- kernel 21: sliding-window attention, and the model path through it ------

#: (B, S, H, KH, D, window): the JAX package's test shapes, ragged S, one
#: KV head, every head_dim the dense models use (16-128, 120 for
#: h2o-danube-3-4b), D = 8 and 256 (the kernel's range), S = 1; then the
#: bf16 kernel's edges: S around its 64-row warpgroups, 128-row blocks
#: and 128-key tiles (64 keys above D 128) at windows 1, 64 and 128, B 2
#: with H == KH, D padded (8, 136) and the widest accumulator (256), a
#: window past S
SWA_SHAPES = [(1, 64, 2, 2, 16, None), (2, 100, 4, 2, 32, 17),
              (1, 33, 4, 1, 16, 8), (1, 128, 2, 2, 64, 32),
              (1, 100, 4, 1, 128, None), (2, 300, 8, 2, 120, 50),
              (1, 70, 2, 1, 256, 33), (1, 1, 4, 2, 64, None),
              (1, 200, 4, 4, 8, 1), (1, 129, 4, 2, 120, 4096)] + [
    (1, S, 4, 2, 120, win) for S in (63, 64, 65, 127, 128, 129)
    for win in (1, 64, 128)] + [
    (2, 130, 4, 4, 120, 100), (2, 257, 2, 2, 64, None),
    (1, 150, 4, 2, 8, None), (1, 150, 4, 2, 16, 64),
    (1, 150, 4, 2, 136, 70), (1, 300, 2, 1, 256, None),
    (1, 2048, 4, 2, 120, 4096)]


#: the bf16 kernel's bound, elementwise: |out - plain| <= BF16_RTOL
#: (|plain| + spread) + BF16_ATOL, inside the JAX package's flat 3e-2.  The
#: spread (``ref.swa_attention_spread_ref``) scales the error of P rounded
#: to bf16, |plain| that of o rounded.  A long band's outputs are small
#: (|o| ~ spread ~ sqrt(e / keys)), so the flat bound alone would pass a
#: kernel tens of percent off
BF16_RTOL, BF16_ATOL = 2e-2, 1e-4


def _assert_bf16_close(out, want, q, k, v, window):
    torch.testing.assert_close(out.float(), want, atol=3e-2, rtol=0)
    bound = ref.swa_attention_spread_ref(q, k, v, window=window)
    bound = BF16_RTOL * (want.abs() + bound) + BF16_ATOL
    ratio = ((out.float() - want).abs() / bound).max().item()
    assert ratio <= 1, f'worst error / bf16 bound {ratio:.3f}'


def _swa_inputs(dev, B, S, H, KH, D, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=(B, S, h, D)).astype(np.float32),
                            device=dev) for h in (H, KH, KH)]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('B,S,H,KH,D,win', SWA_SHAPES)
def test_swa_attention_matches_plain(dev, B, S, H, KH, D, win, dtype):
    """f32 within 2e-5, bf16 within 3e-2 of the plain version computed in
    f32 from the same bf16 inputs (the JAX package's tolerances); bf16
    also within ``BF16_RTOL`` of each plain output and its spread, plus
    ``BF16_ATOL``."""
    from repro_torch.kernels.swa_attention import swa_attention
    dt = getattr(torch, dtype)
    q, k, v = (t.to(dt) for t in _swa_inputs(dev, B, S, H, KH, D, seed=S))
    out = swa_attention(q, k, v, window=win)
    want = ref.swa_attention_ref(q.float(), k.float(), v.float(), window=win)
    torch.cuda.synchronize()
    assert out.dtype == dt and out.shape == q.shape
    if dt == torch.float32:
        torch.testing.assert_close(out, want, atol=2e-5, rtol=0)
    else:
        _assert_bf16_close(out, want, q, k, v, win)
    assert backend.LAUNCHES['swa_attention'] == 1
    again = swa_attention(q, k, v, window=win)
    assert torch.equal(again, out)


def test_swa_attention_bf16_finite_where_first_tile_holds_no_key(dev):
    """Window 64 at S 512, in the block of query rows 256-383 (warpgroup 0
    rows 256-319, warpgroup 1 rows 320-383), whose band starts at key 193.
    At D 120 the kernel walks 128-key tiles: warpgroup 0's first, keys
    128-255, holds none of row 319's keys (its band starts at 256).  At
    D 256 it walks 64-key tiles: warpgroup 0's first, keys 192-255, holds
    none of row 319's, and warpgroup 1's first, keys 256-319, none of row
    383's.  Such a row adds exp(0) per masked key, which its next tile
    rescales to 0.  The bf16 output stays finite and within the bf16
    bound of the plain version, with scores four times the unit scale's."""
    from repro_torch.kernels.swa_attention import swa_attention
    for D in (120, 256):
        q, k, v = (t.bfloat16() for t in _swa_inputs(dev, 1, 512, 4, 2, D,
                                                      seed=7))
        q, k = q * 2, k * 2
        out = swa_attention(q, k, v, window=64)
        want = ref.swa_attention_ref(q.float(), k.float(), v.float(),
                                     window=64)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all(), D
        _assert_bf16_close(out, want, q, k, v, 64)


def test_swa_attention_bf16_refuses_misaligned(dev):
    """The bf16 kernel loads rows with TMA: a base pointer that is not
    16-byte aligned raises, and nothing is copied or launched."""
    from repro_torch.kernels.swa_attention import swa_attention
    q, k, v = (t.bfloat16() for t in _swa_inputs(dev, 1, 16, 4, 2, 16))
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device=dev)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match='16-byte'):
        swa_attention(shifted, k, v)
    assert backend.LAUNCHES['swa_attention'] == 0


def test_swa_attention_refuses_bad_operands(dev):
    from repro_torch.kernels.swa_attention import swa_attention
    q, k, v = _swa_inputs(dev, 1, 16, 4, 2, 16)
    with pytest.raises(ValueError, match='head_dim'):
        swa_attention(q[..., :12], k[..., :12], v[..., :12])
    with pytest.raises(ValueError, match='contiguous'):
        swa_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        swa_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match='window'):
        swa_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match='H % KH'):
        swa_attention(q[:, :, :3], k, v)
    assert backend.LAUNCHES['swa_attention'] == 0


def test_full_depth_model_kernel_path_equals_plain(dev):
    """h2o-danube-3-4b at full depth (24 layers) and reduced width, GQA
    (8 heads over 2 KV heads), window 8: ``prefill_step`` through kernel 21
    launches it once per layer and gives the ``'flash_jnp'`` path's next
    tokens; its logits agree within 1e-4 (f32)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import ServeSetup
    from repro_torch.models.model import build_model
    cfg = get_config('h2o-danube-3-4b').reduced(n_layers=24, n_kv_heads=2)
    plain = build_model(cfg)
    kern = build_model(dataclasses.replace(cfg, attn_impl='pallas'))
    params = plain.init(torch.Generator(device=dev).manual_seed(0))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 100)), device=dev)
    batch = {'tokens': tokens}
    nxt = ServeSetup(kern).prefill_step(params, batch)
    torch.cuda.synchronize()
    assert backend.LAUNCHES['swa_attention'] == cfg.n_layers
    assert torch.equal(nxt, ServeSetup(plain).prefill_step(params, batch))
    torch.testing.assert_close(kern.logits(params, batch)[0],
                               plain.logits(params, batch)[0], atol=1e-4,
                               rtol=0)


#: the reduced MoE, SSM and hybrid models (f32), as the CPU parity tests
#: build them: scout, maverick with two super-blocks, mamba2, zamba2 with
#: three groups (two applications of its shared attention block)
FAMILY_CASES = {'scout': ('llama4-scout-17b-a16e', {}),
                'maverick': ('llama4-maverick-400b-a17b', dict(n_layers=4)),
                'mamba2': ('mamba2-130m', {}),
                'zamba2': ('zamba2-1.2b', dict(n_layers=5))}


def _family(case, impl='flash_jnp'):
    """(model config, its params on the CPU, its params on the card)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    arch, kw = FAMILY_CASES[case]
    cfg = get_config(arch).reduced(attn_impl=impl, **kw)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    return cfg, params, _to(params, torch.device('cuda'))


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


@pytest.fixture
def moe_routes(monkeypatch):
    """Each ``apply_moe`` call's top-1 expert per token, on the host."""
    from repro_torch.models import moe
    seen, apply = [], moe.apply_moe

    def wrap(p, x, **kw):
        seen.append(moe.route(p, x.reshape(-1, x.shape[-1]))[0].cpu())
        return apply(p, x, **kw)
    monkeypatch.setattr(moe, 'apply_moe', wrap)
    return seen


@pytest.mark.parametrize('impl', ['flash_jnp', 'pallas'])
@pytest.mark.parametrize('case', sorted(FAMILY_CASES))
def test_family_forward_logits_on_the_card_equal_the_cpu(dev, moe_routes,
                                                         case, impl):
    """``forward_logits`` of the reduced model in f32 on the card against
    the same model on the CPU: logits within 1e-4 (f32 products in
    another order), every MoE layer's routes equal; with ``'pallas'`` on
    the card kernel 21 launches once per attention application."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model import build_model
    cfg, host, card = _family(case, impl)
    model = build_model(cfg)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 40)))
    want, want_aux = model.logits(host, {'tokens': tokens})
    host_routes = list(moe_routes)
    moe_routes.clear()
    backend.reset_launches()
    got, aux = model.logits(card, {'tokens': tokens.to(dev)})
    torch.cuda.synchronize()
    n_attn = (0 if cfg.family == 'ssm' else len(tfm.hybrid_groups(cfg)) - 1
              if cfg.family == 'hybrid' else cfg.n_layers)
    assert backend.LAUNCHES['swa_attention'] == (
        n_attn if impl == 'pallas' else 0)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
    assert set(aux) == set(want_aux)
    for key in aux:
        torch.testing.assert_close(aux[key].cpu(), want_aux[key], atol=1e-5,
                                   rtol=0)
    assert len(moe_routes) == len(host_routes)
    for a, b in zip(moe_routes, host_routes):
        assert torch.equal(a, b)


@pytest.mark.parametrize('case', sorted(FAMILY_CASES))
def test_family_decode_on_the_card_equals_the_cpu(dev, case):
    """A 12-token prefill through the caches (KV, conv, SSM) and 4 greedy
    ``serve_step``s on the card against the CPU: the prefill's logits and
    every cache within 1e-4, the same tokens."""
    from repro_torch.launch.steps import ServeSetup
    from repro_torch.models.model import build_model
    cfg, host, card = _family(case)
    model = build_model(cfg)
    setup = ServeSetup(model)
    prompts = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)))
    out = {}
    for where, params, d in (('cpu', host, torch.device('cpu')),
                             ('cuda', card, dev)):
        cache, logits = model.prefill(params, model.init_cache(2, 16,
                                                               device=d),
                                      prompts.to(d))
        tok = logits[:, -1].argmax(-1)
        toks = [tok]
        for _ in range(4):
            cache, tok = setup.serve_step(params, cache, tok[:, None])
            toks.append(tok)
        out[where] = (logits.cpu(), _to({k: v for k, v in cache.items()
                                         if k != 'length'},
                                        torch.device('cpu')),
                      torch.stack(toks, 1).cpu())
    torch.testing.assert_close(out['cuda'][0], out['cpu'][0], atol=1e-4,
                               rtol=0)
    for key, v in out['cpu'][1].items():
        torch.testing.assert_close(out['cuda'][1][key], v, atol=1e-4,
                                   rtol=0)
    assert torch.equal(out['cuda'][2], out['cpu'][2])


#: kernel 21 at the head shapes of the MoE and hybrid families, at S 2048:
#: llama4-scout (40 query heads over 8 KV heads of 128) and zamba2-1.2b's
#: shared block (32 over 32 of 64), no window
FAMILY_SWA_SHAPES = [(1, 2048, 40, 8, 128, None), (1, 2048, 32, 32, 64, None),
                     (2, 300, 40, 8, 128, None)]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('B,S,H,KH,D,win', FAMILY_SWA_SHAPES)
def test_swa_attention_at_family_shapes_matches_plain(dev, B, S, H, KH, D,
                                                      win, dtype):
    """As ``test_swa_attention_matches_plain``: f32 within 2e-5, bf16 within
    3e-2 and the elementwise bf16 bound."""
    _swa_matches_plain(dev, B, S, H, KH, D, win, dtype)


def _swa_matches_plain(dev, B, S, H, KH, D, win, dtype):
    from repro_torch.kernels.swa_attention import swa_attention
    dt = getattr(torch, dtype)
    q, k, v = (t.to(dt) for t in _swa_inputs(dev, B, S, H, KH, D, seed=S))
    out = swa_attention(q, k, v, window=win)
    want = ref.swa_attention_ref(q.float(), k.float(), v.float(), window=win)
    torch.cuda.synchronize()
    assert out.dtype == dt and out.shape == q.shape
    if dt == torch.float32:
        torch.testing.assert_close(out, want, atol=2e-5, rtol=0)
    else:
        _assert_bf16_close(out, want, q, k, v, win)
    assert backend.LAUNCHES['swa_attention'] == 1


#: kernel 21 at the VLM's and the audio decoder's head shapes, at a few
#: hundred rows: internvl2-26b's 48 query heads over 8 KV heads of 128 (6
#: a KV head, at 264 = 256 patches + 8 tokens and a ragged 300), and
#: whisper-medium's 16 over 16 of 64; no window
VLM_AUDIO_SWA_SHAPES = [(1, 264, 48, 8, 128, None), (1, 300, 48, 8, 128, None),
                        (2, 300, 16, 16, 64, None)]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('B,S,H,KH,D,win', VLM_AUDIO_SWA_SHAPES)
def test_swa_attention_at_vlm_audio_shapes_matches_plain(dev, B, S, H, KH, D,
                                                         win, dtype):
    """As ``test_swa_attention_matches_plain``: f32 within 2e-5, bf16 within
    3e-2 and the elementwise bf16 bound."""
    _swa_matches_plain(dev, B, S, H, KH, D, win, dtype)


def _vlm_audio(arch, impl='flash_jnp'):
    """(reduced model config, its params on the CPU, on the card)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config(arch).reduced(attn_impl=impl)
    params = build_model(cfg).init(torch.Generator().manual_seed(0))
    return cfg, params, _to(params, torch.device('cuda'))


def _vlm_audio_batch(cfg, B, S, seed=0):
    """Seeded tokens and 0.1 N(0, 1) patch or frame embeddings (CPU)."""
    rng = np.random.default_rng(seed)
    batch = {'tokens': torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (B, S)))}
    key, n = (('patch_embeds', cfg.n_patches) if cfg.family == 'vlm'
              else ('frame_embeds', cfg.enc_seq))
    batch[key] = torch.as_tensor(
        0.1 * rng.normal(size=(B, n, cfg.d_model)), dtype=torch.float32)
    return batch


@pytest.mark.parametrize('arch', ['internvl2-26b', 'whisper-medium'])
def test_vlm_audio_forward_logits_kernel_path_equals_plain(dev, arch):
    """Reduced internvl2-26b and whisper-medium (f32) on the card:
    ``'pallas'`` launches kernel 21 once per causal self-attention layer
    (whisper's encoder and cross-attention take the plain path) and its
    logits are within 1e-4 of ``'flash_jnp'``'s on the card, which are
    within 1e-4 of the CPU's."""
    import dataclasses

    from repro_torch.models.model import build_model
    cfg, host, card = _vlm_audio(arch)
    plain = build_model(cfg)
    kern = build_model(dataclasses.replace(cfg, attn_impl='pallas'))
    batch = _vlm_audio_batch(cfg, 2, 100)
    on_card = {k: v.to(dev) for k, v in batch.items()}
    want, _ = plain.logits(host, batch)
    got_plain, _ = plain.logits(card, on_card)
    backend.reset_launches()
    got, _ = kern.logits(card, on_card)
    torch.cuda.synchronize()
    assert backend.LAUNCHES['swa_attention'] == cfg.n_layers
    assert got.shape == (2, 100, cfg.padded_vocab)
    torch.testing.assert_close(got, got_plain, atol=1e-4, rtol=0)
    torch.testing.assert_close(got_plain.cpu(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize('arch', ['internvl2-26b', 'whisper-medium'])
def test_vlm_audio_decode_on_the_card_equals_the_cpu(dev, arch):
    """A 12-token prefill through the caches and 4 greedy ``serve_step``s
    on the card against the CPU (whisper's cross caches filled from the
    encoder's output): the prefill's logits and every cache within 1e-4,
    the same tokens."""
    from repro_torch.launch.steps import ServeSetup
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model import build_model
    cfg, host, card = _vlm_audio(arch)
    model = build_model(cfg)
    setup = ServeSetup(model)
    batch = _vlm_audio_batch(cfg, 2, 12, seed=1)
    out = {}
    for where, params, d in (('cpu', host, torch.device('cpu')),
                             ('cuda', card, dev)):
        cache = model.init_cache(2, 16, device=d)
        if cfg.family == 'audio':
            enc = tfm.encode(params, batch['frame_embeds'].to(d), cfg)
            for i in range(cfg.n_layers):
                layer = tfm.layer_slice(params['dec_layers'], i)
                cache['xk'][i], cache['xv'][i] = tfm.project_enc_kv(
                    layer['xattn'], enc, cfg)
        cache, logits = model.prefill(params, cache,
                                      batch['tokens'].to(d))
        tok = logits[:, -1].argmax(-1)
        toks = [tok]
        for _ in range(4):
            cache, tok = setup.serve_step(params, cache, tok[:, None])
            toks.append(tok)
        out[where] = (logits.cpu(), _to({k: v for k, v in cache.items()
                                         if k != 'length'},
                                        torch.device('cpu')),
                      torch.stack(toks, 1).cpu())
    torch.testing.assert_close(out['cuda'][0], out['cpu'][0], atol=1e-4,
                               rtol=0)
    for key, v in out['cpu'][1].items():
        torch.testing.assert_close(out['cuda'][1][key], v, atol=1e-4,
                                   rtol=0)
    assert torch.equal(out['cuda'][2], out['cpu'][2])


# -- federated LLM training ------------------------------------------------------
#
# Reduced f32 models (TF32 off, PyTorch's default): the card's loss and
# gradients against the CPU's within the CPU suite's bounds against the
# reference (loss 1e-5, gradient leaves atol 1e-5 + rtol 1e-4), a silo
# round's state and loss within atol 1e-5; the in-place silo step and the
# out-of-place composition run the same operations on one device, so they
# are equal bit for bit.

TRAIN_MASKS = {'sync': [1, 1, 0, 1], 'picked': [1, 0, 0, 1],
               'undrafted': [0, 1, 0, 0], 'deprecated': [0, 0, 1, 0],
               'completed': [1, 1, 0, 1]}


def _train_batch(cfg, lead, S, d, seed=0, meta=False):
    g = torch.Generator().manual_seed(seed)
    batch = {k: torch.randint(0, cfg.vocab_size, lead + (S,), generator=g,
                              dtype=torch.int32)
             for k in ('tokens', 'labels')}
    if cfg.family == 'vlm':
        batch['patch_embeds'] = 0.1 * torch.randn(
            lead + (cfg.n_patches, cfg.d_model), generator=g)
    if cfg.family == 'audio':
        batch['frame_embeds'] = 0.1 * torch.randn(
            lead + (cfg.enc_seq, cfg.d_model), generator=g)
    batch = {k: v.to(d) for k, v in batch.items()}
    if meta:
        batch['meta'] = {k: torch.tensor(v, dtype=torch.bool, device=d)
                         for k, v in TRAIN_MASKS.items()}
        batch['meta']['weights'] = torch.tensor([0.3, 0.3, 0.2, 0.2],
                                                device=d)
    return batch


@pytest.mark.parametrize('arch', ['qwen3-1.7b', 'mamba2-130m',
                                  'llama4-scout-17b-a16e', 'zamba2-1.2b',
                                  'internvl2-26b', 'whisper-medium'])
def test_train_loss_and_grads_on_the_card_match_the_cpu(dev, arch):
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.optim import tree_leaves, tree_map

    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    host = model.init(0, device='cpu')
    out = {}
    for d in (torch.device('cpu'), dev):
        p = tree_map(lambda t: t.to(d).requires_grad_(), host)
        loss = model.loss(p, _train_batch(cfg, (2,), 16, d))
        grads = torch.autograd.grad(loss, tree_leaves(p), allow_unused=True,
                                    materialize_grads=True)
        out[d.type] = (loss.detach().cpu(), [g.cpu() for g in grads])
    torch.testing.assert_close(out['cuda'][0], out['cpu'][0], atol=1e-5,
                               rtol=0)
    for a, b in zip(out['cuda'][1], out['cpu'][1]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-4)
    assert sum(backend.LAUNCHES.values()) == 0


@pytest.mark.parametrize('arch', ['qwen3-1.7b', 'mamba2-130m'])
def test_silo_train_step_on_the_card_matches_the_cpu(dev, arch):
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import SiloSetup
    from repro_torch.models.model import build_model
    from repro_torch.optim import tree_leaves

    cfg = get_config(arch).reduced()
    setup = SiloSetup(build_model(cfg), n_clients=4, local_steps=2,
                      learning_rate=0.05)
    host = setup.model.init(0, device='cpu')
    out = {}
    for d in (torch.device('cpu'), dev):
        state, m = setup.train_step(setup.init_state(_to(host, d)),
                                    _train_batch(cfg, (4, 2), 16, d,
                                                 meta=True))
        out[d.type] = (m['loss'].cpu(), [t.cpu() for part in
                                         ('global', 'local', 'cache')
                                         for t in tree_leaves(state[part])])
    torch.testing.assert_close(out['cuda'][0], out['cpu'][0], atol=1e-5,
                               rtol=0)
    for a, b in zip(out['cuda'][1], out['cpu'][1]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


def test_in_place_silo_step_equals_out_of_place_on_the_card(dev):
    from repro_torch.configs import get_config
    from repro_torch.core import protocol
    from repro_torch.launch.steps import SiloSetup, row
    from repro_torch.models.model import build_model
    from repro_torch.optim import tree_leaves, tree_map

    cfg = get_config('qwen3-1.7b').reduced()
    setup = SiloSetup(build_model(cfg), n_clients=4, local_steps=2,
                      learning_rate=0.05)
    state = setup.init_state(setup.model.init(1, device=dev))
    batch = _train_batch(cfg, (4, 2), 16, dev, seed=1, meta=True)
    meta = batch['meta']

    def per_client(base):
        rows = [setup.train_client(row(base, k), setup.client(batch, k))[0]
                for k in range(4)]
        return tree_map(lambda *r: torch.stack(r), *rows)
    want = protocol.safa_round(
        state['global'], state['local'], state['cache'],
        sync_mask=meta['sync'], completed=meta['completed'],
        picked=meta['picked'], undrafted=meta['undrafted'],
        deprecated=meta['deprecated'], weights=meta['weights'],
        local_train_fn=per_client)
    got, _ = setup.train_step(state, batch)
    for part, ref_tree in zip(('global', 'local', 'cache'), want):
        for a, b in zip(tree_leaves(got[part]), tree_leaves(ref_tree)):
            assert torch.equal(a, b), part


@pytest.mark.parametrize('name', sorted(kernel_calls('cpu')))
def test_kernel_wrappers_refuse_grad_on_the_card(dev, name):
    """A CUDA operand that requires grad: the wrapper raises before it
    launches (no launch counted)."""
    with pytest.raises(RuntimeError, match='not differentiable'):
        kernel_calls(dev)[name]()
    assert sum(backend.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# Kernel 20 under repetition, and the contract checker on the card
# ---------------------------------------------------------------------------

#: N of the stress check: the Task 2 CNN's int8 wire width
STRESS_N = 342_016


def _scale_tier(m, seed=0):
    """Round 1 and 2's lag-tier schedule of the quota-bounded environment
    the smoke script's tier phase runs, and its weights."""
    from repro_torch.fedsim import scale
    return (scale.scale_schedule(2, seed, 'sparse_tier', m=m),
            scale.scale_spec(seed, m).build().weights)


@pytest.mark.parametrize('shape', ['m1000', 'fleet', 'm10000'])
@pytest.mark.parametrize('t', [0, 1])
def test_q8_tier_kernel_repeated_equals_plain_every_launch(dev, shape, t):
    """Kernel 20 (its S-axis form for the fleet) launched 200 times at a
    round of the smoke script's tier shapes, each launch on a fresh copy
    of one buffer: every launch's buffer bit for bit the plain version's,
    its sums the first launch's bits, those within rtol 1e-5 / atol 1e-6
    of the plain version's.  A ring stage released to the next bulk copy
    before its reads landed shows as a launch that differs."""
    from repro_torch.core import protocol
    from repro_torch.core.schedules import TierFleetSchedule
    if shape == 'fleet':
        parts = [_scale_tier(1000, seed=i) for i in range(4)]
        sched = TierFleetSchedule.from_members([p[0] for p in parts])
        w = np.stack([p[1] for p in parts])
        wrapper = safa_aggregate_packed_q8_tier_rows_fleet
    else:
        sched, w = _scale_tier(1000 if shape == 'm1000' else 10_000)
        wrapper = safa_aggregate_packed_q8_tier_rows
    lead = (4,) if shape == 'fleet' else ()

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    idx = put(sched.idx[..., t, :])
    m4 = (put(sched.cache_src[..., t, :]), put(sched.cache_dst[..., t, :]),
          put(sched.roles[..., t, :]),
          protocol._slot_weights(idx, torch.as_tensor(
              w, dtype=torch.float32, device=dev)))
    k = idx.shape[-1]
    gen = torch.Generator(device=dev).manual_seed(5 + t)

    def normal(*s):
        return torch.randn(s, generator=gen, device=dev)

    buf0 = normal(*lead, sched.capacity + 1, STRESS_N)
    q, scales = ref.quantize_packed_ref(normal(*lead, k, STRESS_N))
    base, glob, agg = (normal(*lead, k, STRESS_N), normal(*lead, STRESS_N),
                       normal(*lead, STRESS_N))
    want = ref.safa_aggregate_q8_tier_rows_ref(q, scales, base, buf0.clone(),
                                               glob, agg, *m4)
    buf = torch.empty_like(buf0)
    bad = torch.zeros(2, dtype=torch.int64, device=dev)
    first = None
    for _ in range(200):
        buf.copy_(buf0)
        ng, na, out = wrapper(q, scales, base, buf, glob, agg, *m4)
        assert out is buf
        bad[0] += (buf != want[2]).any()
        if first is None:
            first = (ng, na)
        else:
            bad[1] += (ng != first[0]).any() | (na != first[1]).any()
    assert bad.tolist() == [0, 0]
    for g, w_ in zip(first, want[:2]):
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-6)
    key = 'safa_aggregate_packed_q8_tier_rows' + ('_fleet' if lead else '')
    assert backend.LAUNCHES[key] == 200


#: a handful of cells: the compressed round on both engines, the rows and
#: tier kernels, the weighted merge, and a cell without a kernel
ANALYSIS_CELLS = ('safa[scan/dense/int8/kernel=packed]',
                  'safa[fleet/dense/int8/kernel=packed]',
                  'safa[scan/sparse_delta/int8/kernel=packed]',
                  'safa[fleet/sparse_tier/int8/kernel=packed]',
                  'seafl[scan/dense/int8/kernel=packed]',
                  'fedavg[fleet/sparse/int8/kernel=False]',
                  'local[scan/dense/f32/kernel=False]')


def test_contract_checker_clean_on_the_card(dev):
    """``repro_torch.analysis`` on the card over a handful of cells: every
    rule ok (each segment under the sync debug mode), and each segment's
    change of ``LAUNCHES`` equal to the budget for its rounds."""
    from repro_torch import analysis
    from repro_torch.analysis import launch_checks
    cells = [c for c in analysis.iter_cells()
             if c.label in ANALYSIS_CELLS]
    assert len(cells) == len(ANALYSIS_CELLS)
    rep = analysis.check_cells(cells=cells, device='cuda')
    assert rep.ok, '\n'.join(map(str, rep.failures))
    assert rep.rules() == {'T001', 'T002', 'T003', 'T004', 'T005', 'T006'}
    for cell in cells:
        run = launch_checks.run_cell(cell, 'cuda')
        budget = cell.pdef.dispatch_budget(cell.ex)
        assert [s.launches for s in run.segments] == \
            [budget * launch_checks.SEG] * 2, cell.label

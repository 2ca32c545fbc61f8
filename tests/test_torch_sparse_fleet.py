"""Sparse sweeps in the port (``run_sweep`` on ``schedule='sparse'`` and
``'sparse_delta'`` for SAFA, FedAvg and FedCS, both engines) against the
JAX package on the same seeded members, with the JAX kernels in interpret
mode as its own tests run them.

Tolerances:

* host schedules are numpy in both packages: the fleet-major ``idx``,
  ``roles`` and ``capacities``, every member's ragged schedule, records
  and futility equal;
* the fleet kernels' plain versions (kernels 13, 14, 17, 18) against the
  JAX package's ``*_fleet`` kernels: gathered and scattered rows, c2 and
  local rows are copies and selects, equal exactly; new_global and
  new_agg are sums taken in another order, atol 1e-6; each fleet wrapper
  equals its single-run wrapper member by member, bit for bit;
* whole sweeps (regression task, m = 24, 3 members of different
  active-set widths, 8 rounds): per-member ``final_global`` within atol
  1e-5 of the JAX sweep on the f32 wire and 1e-4 of the JAX package's own
  int8 sweep on the int8 wire, evals within rtol 1e-4, records and
  futility equal;
* inside the port: sequential == each member's single ``run()`` bit for
  bit; fleet == single bit for bit, except a ``'sparse_delta'`` member
  narrower than the fleet, held to atol 1e-6 (``PADDED_WIDTH_ATOL`` says
  why); ``'sparse'`` fleet == dense fleet bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import federation as jfed
from repro.data import make_regression, partition
from repro.data import tasks as jtasks
from repro.fedsim import EnvSpec as JEnvSpec
from repro.kernels import ops as jops
from repro.kernels.comm_quant import quantize_packed as j_quantize
from repro_torch import api as tapi
from repro_torch.core import api as tcore
from repro_torch.core import federation as tfed
from repro_torch.core import protocol as tproto
from repro_torch.core import schedules as tsched
from repro_torch.data import tasks as ttasks
from repro_torch.fedsim import EnvSpec as TEnvSpec
from repro_torch.kernels import backend
from repro_torch.kernels import ops as tops

ENV = dict(m=24, crash_prob=0.3, dataset_size=480, batch_size=10, epochs=1,
           t_lim=200.0, seed=3)
#: (fraction, crash probability, lag tolerance) of each member: the
#: fractions give the members different active-set widths
MEMBERS = ((0.3, 0.1, 3), (0.2, 0.5, 2), (0.4, 0.3, 4))
ROUNDS, EVAL_EVERY = 8, 4


@pytest.fixture(autouse=True)
def _zero_launches():
    backend.reset_launches()
    yield
    assert all(v == 0 for v in backend.LAUNCHES.values()), \
        'a wrapper launched a kernel on CPU tensors'


def _members(pkg):
    env_cls, mem_cls = ((JEnvSpec, japi.SweepMember) if pkg == 'jax'
                        else (TEnvSpec, tapi.SweepMember))
    return [mem_cls(env=env_cls(**ENV), fraction=f, lag_tolerance=tau,
                    seed=s, overrides={'crash_prob': cr})
            for s, (f, cr, tau) in enumerate(MEMBERS)]


def _built(pkg):
    """The members with their overrides applied and envs built, as the
    fleet precomputes take them."""
    out = []
    for mem in _members(pkg):
        env = mem.env.replace(**mem.overrides).build()
        out.append(dataclasses.replace(mem, env=env, overrides=None))
    return out


def _timing(records):
    return [dataclasses.asdict(dataclasses.replace(r, eval=None))
            for r in records]


# ---------------------------------------------------------------------------
# (a) the fleet-major sparse schedules
# ---------------------------------------------------------------------------

def _fleet_precompute(pkg, name, sampler='choice', rounds=20):
    fed = jfed if pkg == 'jax' else tfed
    members = _built(pkg)
    if name == 'safa':
        return fed.precompute_fleet_schedule(members, rounds=rounds)
    return fed.precompute_sync_fleet_schedule(
        members, rounds=rounds, fedcs=name == 'fedcs', sampler=sampler)


PROTOS = [('safa', 'choice'), ('fedavg', 'choice'), ('fedavg', 'topk'),
          ('fedcs', 'choice')]
PROTO_IDS = ['safa', 'fedavg-choice', 'fedavg-topk', 'fedcs']


@pytest.mark.parametrize('name,sampler', PROTOS, ids=PROTO_IDS)
def test_fleet_to_sparse_matches_reference(name, sampler):
    jf = _fleet_precompute('jax', name, sampler).to_sparse()
    tf = _fleet_precompute('torch', name, sampler).to_sparse()
    want_cls = tsched.SparseFleetSchedule if name == 'safa' \
        else tsched.SparseSyncFleetSchedule
    assert type(tf) is want_cls
    np.testing.assert_array_equal(tf.idx, jf.idx)
    np.testing.assert_array_equal(tf.roles, jf.roles)
    np.testing.assert_array_equal(tf.capacities, jf.capacities)
    np.testing.assert_array_equal(tf.futility, jf.futility)
    assert (tf.m, tf.size, tf.rounds, tf.capacity, tf.nbytes) == \
        (jf.m, jf.size, jf.rounds, jf.capacity, jf.nbytes)
    assert len(set(tf.capacities.tolist())) > 1, \
        'the members should differ in active-set width'
    for s in range(tf.size):
        tm, jm = tf.member(s), jf.member(s)
        np.testing.assert_array_equal(tm.idx, jm.idx)
        np.testing.assert_array_equal(tm.roles, jm.roles)
        assert tm.capacity == tf.capacities[s]
        assert _timing(tm.records) == _timing(jm.records)
        assert tm.futility == jm.futility


@pytest.mark.parametrize('name,sampler', PROTOS, ids=PROTO_IDS)
def test_fleet_member_equals_its_own_sparse_precompute(name, sampler):
    """``member(s)`` is the ragged schedule member s's own single-run
    precompute gives; the padded slots are sentinel no-ops."""
    fleet = _fleet_precompute('torch', name, sampler).to_sparse()
    for s, mem in enumerate(_built('torch')):
        env = TEnvSpec(**ENV).replace(crash_prob=MEMBERS[s][1]).build()
        if name == 'safa':
            own = tfed.precompute_safa_schedule(
                env, fraction=mem.fraction, lag_tolerance=mem.lag_tolerance,
                rounds=20, form='sparse')
        else:
            own = tfed.precompute_sync_schedule(
                env, fraction=mem.fraction, rounds=20, seed=mem.seed,
                fedcs=name == 'fedcs', sampler=sampler, form='sparse')
        got = fleet.member(s)
        np.testing.assert_array_equal(got.idx, own.idx)
        np.testing.assert_array_equal(got.roles, own.roles)
        cap = own.capacity
        assert np.all(fleet.idx[s, :, cap:] == ENV['m'])
        assert np.all(fleet.roles[s, :, cap:] == 0)


def test_from_members_capacity_and_errors_match_reference():
    tf = _fleet_precompute('torch', 'safa').to_sparse()
    jf = _fleet_precompute('jax', 'safa').to_sparse()
    tm = [tf.member(s) for s in range(tf.size)]
    jm = [jf.member(s) for s in range(jf.size)]
    wide = tsched.SparseFleetSchedule.from_members(tm, capacity=40)
    jwide = type(jf).from_members(jm, capacity=40)
    assert wide.capacity == 40
    np.testing.assert_array_equal(wide.idx, jwide.idx)
    np.testing.assert_array_equal(wide.member(1).idx, tm[1].idx)
    with pytest.raises(ValueError) as port:
        tsched.SparseFleetSchedule.from_members(tm, capacity=2)
    with pytest.raises(ValueError) as ref:
        type(jwide).from_members(jm, capacity=2)
    assert str(port.value) == str(ref.value)
    short = tfed.precompute_safa_schedule(
        TEnvSpec(**ENV).build(), fraction=0.3, lag_tolerance=3, rounds=5,
        form='sparse')
    with pytest.raises(ValueError, match=r'share \(m, rounds\)'):
        tsched.SparseFleetSchedule.from_members([tm[0], short])


def test_sparse_fleet_on_device_and_segments():
    fleet = _fleet_precompute('torch', 'safa').to_sparse()
    dev = fleet.to_device('cpu')
    assert isinstance(dev, tproto.SparseRoundSchedule)
    s, rounds, k = fleet.idx.shape
    assert dev.idx.shape == (s, rounds, k) and dev.idx.dtype == torch.int32
    assert dev.roles.dtype == torch.uint8
    assert dev.round_idx.shape == (s, rounds)
    seg = dev.fleet_segment(3, 7)
    np.testing.assert_array_equal(seg.idx.numpy(), fleet.idx[:, 3:7])
    np.testing.assert_array_equal(seg.round_idx[1].numpy(), np.arange(4, 8))
    sync = _fleet_precompute('torch', 'fedcs').to_sparse().to_device('cpu')
    assert isinstance(sync, tproto.SparseSyncSchedule)
    assert sync.fleet_segment(0, 2).roles.shape[:2] == (s, 2)


# ---------------------------------------------------------------------------
# (b) kernels 13, 14, 17, 18: plain versions against the JAX kernels
# ---------------------------------------------------------------------------

S, M, N, K, TILE = 3, 13, 4096, 7, 256


def _fleet_rows_inputs(seed):
    """Per member: a duplicate real row (slot 1 repeats slot 0's) and
    sentinel slots, each member with its own rows, roles and weights."""
    rng = np.random.default_rng(seed)
    rows = np.stack([np.concatenate([
        [r0, r0], rng.choice([i for i in range(M) if i != r0], 3,
                             replace=False), [M, M]]).astype(np.int32)
        for r0 in rng.integers(0, M, S)])
    roles = np.stack([np.array([6, 2 | 8, 7, 16 | 1, 0, 0, 0], np.uint8)
                      [rng.permutation(K)] for _ in range(S)])
    roles[rows == M] = 0
    a = dict(cache=rng.standard_normal((S, M + 1, N)).astype(np.float32),
             trained=rng.standard_normal((S, K, N)).astype(np.float32),
             base=rng.standard_normal((S, K, N)).astype(np.float32),
             gprev=rng.standard_normal((S, N)).astype(np.float32),
             agg=rng.standard_normal((S, N)).astype(np.float32),
             rows=rows, roles=roles)
    a['w'] = np.where(rows < M, rng.random((S, K)), 0.0).astype(np.float32)
    return a


def _bits(roles, bit):
    return (roles & bit) != 0


def _j(*arrs):
    return [jax.numpy.asarray(x) for x in arrs]


def _t(*arrs):
    return [torch.from_numpy(np.array(x)) for x in arrs]


def test_gather_rows_fleet_matches_reference():
    a = _fleet_rows_inputs(0)
    got = tops.gather_rows_fleet(*_t(a['cache'], a['rows']))
    want = jops.gather_rows_fleet(*_j(a['cache'], a['rows']), tile=TILE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scatter_rows_fleet_matches_reference():
    a = _fleet_rows_inputs(1)
    buf, rows, vals = _t(a['cache'], a['rows'], a['trained'])
    out = tops.scatter_rows_fleet(buf, rows, vals)
    assert out is buf
    want = np.asarray(jops.scatter_rows_fleet(
        *_j(a['cache'], a['rows'], a['trained']), tile=TILE))
    np.testing.assert_array_equal(out.numpy(), want)
    for s in range(S):                  # the later slot wins the shared row
        assert np.array_equal(want[s, a['rows'][s, 0]], a['trained'][s, 1])


def test_fleet_rows_outside_the_buffer_go_to_each_members_scratch_row():
    a = _fleet_rows_inputs(2)
    buf, rows = _t(a['cache'], a['rows'])
    rows[0, 2], rows[1, 3] = M + 1 + 7, -1
    got = tops.gather_rows_fleet(buf, rows)
    assert torch.equal(got[0, 2], buf[0, M]) and \
        torch.equal(got[1, 3], buf[1, M])
    vals = torch.arange(S * K, dtype=torch.float32)[:, None] \
        .expand(S * K, N).reshape(S, K, N).contiguous()
    before = buf.clone()
    tops.scatter_rows_fleet(buf, rows, vals)
    assert torch.equal(buf[0, M], vals[0, 6])    # the last slot at row M
    assert torch.equal(buf[1, M], vals[1, 6])
    assert torch.equal(buf[2, :M][rows[2, 5:].long().clamp(max=M - 1)],
                       before[2, :M][rows[2, 5:].long().clamp(max=M - 1)])


@pytest.mark.parametrize('seed', [0, 3])
def test_rows_aggregate_fleet_matches_reference(seed):
    a = _fleet_rows_inputs(seed)
    r = a['roles']
    ng, na, c2 = tops.safa_aggregate_packed_rows_fleet(
        *_t(a['cache'], a['trained'], a['gprev'], a['agg'], a['rows'], r,
            a['w']))
    jg, ja, jc2 = jops.safa_aggregate_packed_rows_fleet(
        *_j(a['cache'], a['trained'], a['gprev'], a['agg'], a['rows'],
            _bits(r, 4), _bits(r, 8), _bits(r, 16), a['w']), tile=TILE)
    np.testing.assert_array_equal(c2.numpy(), np.asarray(jc2))
    np.testing.assert_allclose(ng.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(na.numpy(), np.asarray(ja), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize('seed', [0, 3])
def test_q8_rows_aggregate_fleet_matches_reference(seed):
    a = _fleet_rows_inputs(seed)
    r = a['roles']
    q, sc = (np.array(v) for v in j_quantize(
        jax.numpy.asarray(a['trained'].reshape(S * K, N))))
    q, sc = q.reshape(S, K, N), sc.reshape(S, K, -1)
    ng, na, c2, loc = tops.safa_aggregate_packed_q8_rows_fleet(
        *_t(q, sc, a['base'], a['cache'], a['gprev'], a['agg'], a['rows'],
            r, a['w']))
    jg, ja, jc2, jl = jops.safa_aggregate_packed_q8_rows_fleet(
        *_j(q, sc, a['base'], a['cache'], a['gprev'], a['agg'], a['rows'],
            _bits(r, 4), _bits(r, 8), _bits(r, 16), _bits(r, 2), a['w']),
        tile=TILE)
    np.testing.assert_array_equal(c2.numpy(), np.asarray(jc2))
    np.testing.assert_array_equal(loc.numpy(), np.asarray(jl))
    np.testing.assert_allclose(ng.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(na.numpy(), np.asarray(ja), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize('kernel', ['gather', 'scatter', 'rows', 'q8_rows'])
def test_fleet_row_wrappers_equal_single_run_per_member(kernel):
    """On the CPU each fleet wrapper gives every member, bit for bit, what
    the single-run wrapper gives on that member's slices."""
    a = _fleet_rows_inputs(5)
    cache, trained, base, g, agg, rows, roles, w = _t(
        a['cache'], a['trained'], a['base'], a['gprev'], a['agg'],
        a['rows'], a['roles'], a['w'])
    q, sc = tops.quantize_packed_fleet(trained)
    if kernel == 'gather':
        got = (tops.gather_rows_fleet(cache, rows),)
    elif kernel == 'scatter':
        got = (tops.scatter_rows_fleet(cache.clone(), rows, trained),)
    elif kernel == 'rows':
        got = tops.safa_aggregate_packed_rows_fleet(cache, trained, g, agg,
                                                    rows, roles, w)
    else:
        got = tops.safa_aggregate_packed_q8_rows_fleet(q, sc, base, cache, g,
                                                       agg, rows, roles, w)
    for s in range(S):
        if kernel == 'gather':
            want = (tops.gather_rows(cache[s], rows[s]),)
        elif kernel == 'scatter':
            want = (tops.scatter_rows(cache[s].clone(), rows[s],
                                      trained[s]),)
        elif kernel == 'rows':
            want = tops.safa_aggregate_packed_rows(
                cache[s], trained[s], g[s], agg[s], rows[s], roles[s], w[s])
        else:
            want = tops.safa_aggregate_packed_q8_rows(
                q[s], sc[s], base[s], cache[s], g[s], agg[s], rows[s],
                roles[s], w[s])
        for x, y in zip(got, want):
            assert torch.equal(x[s], y), (kernel, s)


def test_fleet_row_wrappers_check_ranks():
    a = _fleet_rows_inputs(6)
    cache, trained, rows = _t(a['cache'], a['trained'], a['rows'])
    with pytest.raises(ValueError, match=r'\[S, R, N\]'):
        tops.gather_rows_fleet(cache[0], rows[0])
    with pytest.raises(ValueError, match=r'\[R, N\]'):
        tops.gather_rows(cache, rows)
    with pytest.raises(ValueError, match='S=3, K=7'):
        tops.scatter_rows_fleet(cache, rows, trained[:, :2])
    with pytest.raises(ValueError, match=r'cache \[S, R, N\]'):
        tops.safa_aggregate_packed_rows_fleet(
            *_t(a['cache'][0], a['trained'][0], a['gprev'][0], a['agg'][0],
                a['rows'][0], a['roles'][0], a['w'][0]))


# ---------------------------------------------------------------------------
# (c) the sparse algebra on a member axis
# ---------------------------------------------------------------------------

def test_fleet_row_helpers_equal_member_helpers():
    """scatter_masks, tree_gather, tree_scatter, _slot_weights and
    init_aggregate on a fleet's [S, K] slots equal the single-run helpers
    member by member; every member's sentinel lands in its own scratch
    row."""
    rng = np.random.default_rng(7)
    m = 6
    tree = {'w': torch.from_numpy(rng.standard_normal((S, m, 4))
                                  .astype(np.float32)),
            'b': torch.from_numpy(rng.standard_normal((S, m))
                                  .astype(np.float32))}
    idx = torch.tensor([[1, 4, m], [0, m, m], [5, 2, 3]], dtype=torch.int32)
    roles = torch.tensor([[3, 6, 0], [1, 0, 0], [2, 16, 9]],
                         dtype=torch.uint8)
    weights = torch.from_numpy(rng.dirichlet(np.ones(m), size=S)
                               .astype(np.float32))
    rows = {k: -torch.ones((S, 3) + v.shape[2:]) for k, v in tree.items()}
    masks = tproto.scatter_masks(idx, roles, m, (1, 2, 4, 8, 16))
    assert all(g_.is_contiguous() for g_ in masks)   # as the kernels take
    gathered = tproto.tree_gather(tree, idx)
    scattered = tproto.tree_scatter(tree, idx, rows)
    w = tproto._slot_weights(idx, weights)
    agg = tproto.init_aggregate(tree, weights)
    for s in range(S):
        one = {k: v[s] for k, v in tree.items()}
        want = tproto.scatter_masks(idx[s], roles[s], m, (1, 2, 4, 8, 16))
        for g_, w_ in zip(masks, want):
            assert torch.equal(g_[s], w_)
        for k in tree:
            assert torch.equal(gathered[k][s],
                               tproto.tree_gather(one, idx[s])[k])
            assert torch.equal(scattered[k][s], tproto.tree_scatter(
                one, idx[s], {n: r[s] for n, r in rows.items()})[k])
            assert torch.equal(agg[k][s],
                               tproto.init_aggregate(one, weights[s])[k])
        assert torch.equal(w[s], tproto._slot_weights(idx[s], weights[s]))
    assert scattered['w'].shape == (S, m, 4)
    assert torch.equal(scattered['w'][1, 1:], tree['w'][1, 1:])


def test_rows_train_fleet_equals_member_rows_train(reg):
    """``local_train_rows_fleet`` trains member s's replica k on client
    rows[s, k], as ``local_train_rows`` does for member s alone (the
    regression task trains a replica whatever the batch, so bit for bit);
    sentinel rows clamp and stay finite."""
    _, tt, _ = reg
    m = tt._x.shape[0]
    gen = torch.Generator().manual_seed(0)
    g = tt.init_global(0)
    rows = torch.tensor([[0, 5, m], [3, m, m], [m - 1, 2, 7]],
                        dtype=torch.int32)
    params = {k: v[None, None] + 0.01 * torch.randn((3, 3) + v.shape,
                                                    generator=gen)
              for k, v in g.items()}
    got = tt.local_train_rows_fleet(params, rows, 1)
    for s in range(3):
        want = tt.local_train_rows({k: v[s] for k, v in params.items()},
                                   rows[s], 1)
        for k in g:
            assert got[k].shape == params[k].shape
            assert torch.equal(got[k][s], want[k]), (s, k)
            assert torch.isfinite(got[k][s]).all()


# ---------------------------------------------------------------------------
# (d) whole sparse sweeps against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def reg():
    x, y = make_regression()
    data = partition(x, y, JEnvSpec(**ENV).build().partition_sizes, 5,
                     seed=1)
    jt = jtasks.regression_task(data, lr=1e-3, epochs=3)
    tt = ttasks.regression_task(data, lr=1e-3, epochs=3, device='cpu')

    def init(seed):
        return {k: np.array(v) for k, v in
                jt.init_global(jax.random.PRNGKey(seed)).items()}
    return jt, tt, init


#: cell id -> (protocol name, spec fields, exec fields): every sweep cell
#: the single runs take
CELLS = {
    'safa-sparse': ('safa', {}, dict(schedule='sparse')),
    'safa-sparse-kernel': ('safa', {}, dict(schedule='sparse',
                                            use_kernel=True)),
    'safa-sparse-packed': ('safa', {}, dict(schedule='sparse',
                                            use_kernel='packed')),
    'safa-sparse-int8': ('safa', {}, dict(schedule='sparse', wire='int8')),
    'safa-delta': ('safa', {}, dict(schedule='sparse_delta')),
    'safa-delta-int8': ('safa', {}, dict(schedule='sparse_delta',
                                         wire='int8')),
    'safa-delta-packed': ('safa', {}, dict(schedule='sparse_delta',
                                           use_kernel='packed')),
    'safa-delta-packed-int8': ('safa', {}, dict(schedule='sparse_delta',
                                                use_kernel='packed',
                                                wire='int8')),
}
for _name, _kw in (('fedavg', {}), ('fedavg-topk', {'sampler': 'topk'}),
                   ('fedcs', {})):
    for _sched, _tag in (('sparse', 'sparse'), ('sparse_delta', 'delta')):
        for _wire in ('f32', 'int8'):
            CELLS[f'{_name}-{_tag}' + ('-int8' if _wire == 'int8' else '')] = (
                _name.split('-')[0], _kw, dict(schedule=_sched, wire=_wire))


@pytest.fixture(scope='module')
def sweeps(reg):
    """Memoised sweeps: sweeps(pkg, cell, engine, schedule=None) -> list
    of Histories (``schedule`` overrides the cell's, e.g. 'dense')."""
    jt, tt, init = reg
    memo = {}

    def sweep(pkg, cell, engine, schedule=None):
        key = (pkg, cell, engine, schedule)
        if key not in memo:
            name, kw, ex = CELLS[cell]
            ex = dict(ex, engine=engine, eval_every=EVAL_EVERY)
            if schedule is not None:
                ex['schedule'] = schedule
            if pkg == 'jax':
                exp = japi.Experiment(jt, None, japi.spec(name, **kw),
                                      japi.ExecSpec(**ex), rounds=ROUNDS)
            else:
                exp = tapi.Experiment(tt, None, tapi.spec(name, **kw),
                                      tapi.ExecSpec(**ex), rounds=ROUNDS,
                                      device='cpu', init_params=init)
            memo[key] = exp.compile().run_sweep(_members(pkg))
        return memo[key]
    return sweep


def _losses(hist):
    return [e['loss'] for _, e in hist.evals()]


@pytest.mark.parametrize('engine', ['fleet', 'sequential'])
@pytest.mark.parametrize('cell', sorted(CELLS))
def test_sweep_matches_reference(sweeps, cell, engine):
    refs, ports = sweeps('jax', cell, engine), sweeps('torch', cell, engine)
    atol = 1e-4 if CELLS[cell][2].get('wire') == 'int8' else 1e-5
    assert len(ports) == len(refs) == len(MEMBERS)
    for s, (ref, port) in enumerate(zip(refs, ports)):
        assert _timing(port.records) == _timing(ref.records)
        assert port.futility == ref.futility
        for k, v in ref.final_global.items():
            np.testing.assert_allclose(port.final_global[k].numpy(),
                                       np.asarray(v), rtol=0, atol=atol,
                                       err_msg=f'member {s} {k}')
        np.testing.assert_allclose(_losses(port), _losses(ref), rtol=1e-4)


def _single(reg, cell, s):
    """Member s's own single ``run()`` of the cell."""
    _, tt, init = reg
    name, kw, ex = CELLS[cell]
    mem = _members('torch')[s]
    sp = tapi.spec(name, **kw)
    fields = {f.name for f in dataclasses.fields(sp)}
    sp = dataclasses.replace(sp, fraction=mem.fraction, **(
        {'lag_tolerance': mem.lag_tolerance} if 'lag_tolerance' in fields
        else {}))
    return tapi.Experiment(
        tt, mem.env.replace(**mem.overrides), sp,
        tapi.ExecSpec(eval_every=EVAL_EVERY, **ex), rounds=ROUNDS,
        seed=mem.seed, device='cpu', init_params=init).compile().run()


#: A fleet member narrower than the fleet (its own K below the fleet's)
#: is re-padded with sentinel slots, which add exact zeros; but on a
#: ``'sparse_delta'`` schedule the aggregation sums over the slot axis
#: (the running aggregate's deltas, FedAvg/FedCS's weight normaliser and
#: weighted sum) with torch's CPU reduction, whose grouping depends on
#: the axis length, so such a member may sum in another grouping than its
#: ragged run and differ in the last bits of a round.  Held to atol 1e-6
#: over the 8 rounds; every other member, and every ``'sparse'`` cell
#: (whose server step sums over all m clients, as dense), bit for bit.
PADDED_WIDTH_ATOL = 1e-6


@pytest.mark.parametrize('cell', sorted(CELLS))
def test_fleet_equals_sequential_equals_single(reg, sweeps, cell):
    fleet = sweeps('torch', cell, 'fleet')
    seq = sweeps('torch', cell, 'sequential')
    name, kw, ex = CELLS[cell]
    caps = _fleet_precompute('torch', name, kw.get('sampler', 'choice'),
                             rounds=ROUNDS).to_sparse().capacities
    for s in range(len(MEMBERS)):
        single = _single(reg, cell, s)
        assert _losses(seq[s]) == _losses(single)
        narrow = ex['schedule'] == 'sparse_delta' and caps[s] < caps.max()
        for k, v in single.final_global.items():
            assert torch.equal(seq[s].final_global[k], v), (s, k)
            if narrow:
                torch.testing.assert_close(fleet[s].final_global[k], v,
                                           rtol=0, atol=PADDED_WIDTH_ATOL)
            else:
                assert torch.equal(fleet[s].final_global[k], v), (s, k)
        if not narrow:
            assert _losses(fleet[s]) == _losses(single)


@pytest.mark.parametrize('cell', sorted(c for c in CELLS
                                        if CELLS[c][2]['schedule'] ==
                                        'sparse'))
def test_sparse_fleet_equals_dense_fleet(sweeps, cell):
    sparse = sweeps('torch', cell, 'fleet')
    dense = sweeps('torch', cell, 'fleet', schedule='dense')
    for a, b in zip(sparse, dense):
        assert _timing(a.records) == _timing(b.records)
        for k, v in b.final_global.items():
            assert torch.equal(a.final_global[k], v), k


def test_packed_fleet_state_is_pack_buffers(reg, monkeypatch):
    """A SAFA sparse_delta 'packed' fleet carries [S, m + 1, N] local and
    cache buffers, written in place round after round, and launches the
    fleet forms only (on the CPU: none at all)."""
    _, tt, init = reg
    seen = []
    round_fn = tproto.safa_round_sparse_delta_packed

    def spy(gbuf, lbuf, cbuf, abuf, **kw):
        out = round_fn(gbuf, lbuf, cbuf, abuf, **kw)
        seen.append((lbuf.data_ptr(), cbuf.data_ptr(), out[1].data_ptr(),
                     out[2].data_ptr(), tuple(lbuf.shape),
                     tuple(gbuf.shape), tuple(kw['idx'].shape)))
        return out
    monkeypatch.setattr(tproto, 'safa_round_sparse_delta_packed', spy)
    hists = tapi.Experiment(tt, None, tapi.SafaSpec(),
                            tapi.ExecSpec(schedule='sparse_delta',
                                          use_kernel='packed', eval_every=4),
                            rounds=ROUNDS, device='cpu',
                            init_params=init).compile().run_sweep(
        _members('torch'))
    assert len(seen) == ROUNDS
    assert all(a == c and b == d for a, b, c, d, *_ in seen)
    assert len({(a, b) for a, b, *_ in seen}) == 1
    assert seen[0][4] == (len(MEMBERS), ENV['m'] + 1, 2048)
    assert seen[0][5] == (len(MEMBERS), 2048)
    assert seen[0][6][0] == len(MEMBERS)
    assert all(sorted(h.final_global) == ['b', 'w'] for h in hists)


def test_stateless_fleet_carry_holds_no_local_stack(reg, monkeypatch):
    """FedAvg/FedCS sparse_delta sweeps carry the global models alone, on
    both engines."""
    _, tt, init = reg
    states = []
    init_state = tcore._init_state

    def spy(*args, **kwargs):
        st = init_state(*args, **kwargs)
        states.append(st)
        return st
    monkeypatch.setattr(tcore, '_init_state', spy)
    for engine in ('fleet', 'sequential'):
        tapi.Experiment(tt, None, tapi.FedCSSpec(),
                        tapi.ExecSpec(engine=engine, schedule='sparse_delta',
                                      eval_every=EVAL_EVERY),
                        rounds=ROUNDS, device='cpu',
                        init_params=init).compile().run_sweep(
            _members('torch'))
    assert len(states) == 1 + len(MEMBERS)
    assert all(st.local_w is None and st.cache is None for st in states)


# ---------------------------------------------------------------------------
# (e) what stays refused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('schedule', ['sparse', 'sparse_delta'])
def test_per_member_task_sparse_sweep_raises_reference_error(reg, schedule):
    jt, tt, _ = reg
    x, y = make_regression()
    other = partition(x, y, JEnvSpec(**ENV).build().partition_sizes, 5,
                      seed=2)
    tt2 = ttasks.regression_task(other, lr=1e-3, epochs=3, device='cpu')
    jt2 = jtasks.regression_task(other, lr=1e-3, epochs=3)
    port = tapi.Experiment(None, None, tapi.SafaSpec(),
                           tapi.ExecSpec(schedule=schedule), rounds=2,
                           device='cpu').compile()
    ref = japi.Experiment(None, None, japi.SafaSpec(),
                          japi.ExecSpec(schedule=schedule),
                          rounds=2).compile()
    with pytest.raises(ValueError) as got:
        port.run_sweep(tapi.SweepSpec(members=_members('torch')[:2],
                                      tasks=(tt, tt2)))
    with pytest.raises(ValueError) as want:
        ref.run_sweep(japi.SweepSpec(members=_members('jax')[:2],
                                     tasks=(jt, jt2)))
    assert str(got.value) == str(want.value)
    assert 'rows-train contract' in str(got.value)


@pytest.mark.parametrize('engine', ['fleet', 'sequential'])
def test_sparse_tier_sweeps_still_name_item_12(reg, engine, tmp_path):
    """The name dates from when lag-tier sweeps were refused under ROADMAP
    item 12.  They are ported: a timing-only tier sweep gives the sparse
    sweep's records; a tier sweep's checkpoint resumes bit for bit on the
    fleet engine and is refused on the sequential one, as the
    reference's; members derive their comm model from the wire."""
    _, tt, _ = reg

    def runner(**ex):
        return tapi.Experiment(tt, None, tapi.SafaSpec(),
                               tapi.ExecSpec(engine=engine,
                                             schedule='sparse_tier',
                                             eval_every=1, **ex),
                               rounds=2, device='cpu').compile()
    path = str(tmp_path / 'sweep')
    if engine == 'sequential':
        with pytest.raises(ValueError, match="requires engine='fleet'"):
            runner().run_sweep(_members('torch'), checkpoint=path)
    else:
        full = runner().run_sweep(_members('torch'))
        runner().run_sweep(_members('torch'), checkpoint=path,
                           max_segments=1)
        for a, b in zip(runner().run_sweep(_members('torch'),
                                           checkpoint=path), full):
            assert a.evals() == b.evals()
            for k in b.final_global:
                assert torch.equal(a.final_global[k], b.final_global[k])
    wired = [dataclasses.replace(mem, overrides={'comm': 'wire'})
             for mem in _members('torch')]
    timed = runner(numeric=False, wire='int8')
    for a, b in zip(timed.run_sweep(wired),
                    timed.run_sweep(_members('torch'))):
        assert [r.round_len for r in a.records] != \
            [r.round_len for r in b.records]
    timing = [tapi.Experiment(None, None, tapi.SafaSpec(),
                              tapi.ExecSpec(engine=engine, schedule=s,
                                            numeric=False),
                              rounds=ROUNDS, device='cpu').compile()
              .run_sweep(_members('torch'))
              for s in ('sparse_tier', 'sparse')]
    for a, b in zip(*timing):
        assert _timing(a.records) == _timing(b.records)
        assert a.futility == b.futility


def test_timing_only_sparse_sweep_matches_dense_records():
    for name in ('safa', 'fedavg'):
        hists = [tapi.Experiment(None, None, tapi.spec(name),
                                 tapi.ExecSpec(schedule=s, numeric=False),
                                 rounds=ROUNDS, device='cpu').compile()
                 .run_sweep(_members('torch'))
                 for s in ('dense', 'sparse', 'sparse_delta')]
        for a, b, c in zip(*hists):
            assert _timing(a.records) == _timing(b.records) == \
                _timing(c.records)
            assert a.futility == b.futility == c.futility

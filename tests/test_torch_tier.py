"""SAFA's lag-tier schedule in the port (``schedule='sparse_tier'``, runs
and sweeps) against the JAX package on the same seeded inputs, with the
JAX kernels in interpret mode as its own tests run them.

Tolerances:

* host schedules are numpy in both packages: every field of a
  ``TierSchedule`` and of a ``TierFleetSchedule`` (slot maps, capacity,
  the stored-value counts, records, futility) equal;
* the tier kernels' plain versions (kernels 19 and 20) against the JAX
  package's interpret-mode kernels: the buffer's live rows are copies and
  selects, equal exactly; new_global and new_agg are sums taken in
  another order, atol 1e-6.  The scratch row is not compared with the
  JAX kernels (their aliased write order there is the TPU's), but is held
  to its definition: the last scratch-writing slot's c2.  Each S-axis
  form equals its single-run form member by member, bit for bit;
* whole runs and sweeps (regression task, m = 24, from the reference's
  init): ``final_global`` within atol 1e-5 of the JAX run on the f32
  wire and within atol 1e-4 of the JAX package's own int8 run on the int8
  wire, as ``test_torch_api.py`` holds the dense path; records and
  futility equal;
* inside the port: scan == loop and fleet == sequential bit for bit; the
  tier within atol 1e-5 of the port's own ``'sparse_delta'`` run (the
  same slot math over other storage, another summation order).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import federation as jfed
from repro.core import schedules as jsched
from repro.data import make_regression, partition
from repro.data import tasks as jtasks
from repro.fedsim import EnvSpec as JEnvSpec
from repro.fedsim.traces import DayNight as JDayNight
from repro.kernels import ops as jops
from repro.kernels.comm_quant import quantize_packed as j_quantize
from repro_torch import api as tapi
from repro_torch.core import federation as tfed
from repro_torch.core import protocol as tproto
from repro_torch.core import schedules as tsched
from repro_torch.data import tasks as ttasks
from repro_torch.fedsim import EnvSpec as TEnvSpec
from repro_torch.fedsim.traces import DayNight as TDayNight
from repro_torch.kernels import backend
from repro_torch.kernels import ops as tops

ENV = dict(m=24, crash_prob=0.3, dataset_size=480, batch_size=10, epochs=1,
           t_lim=200.0, seed=3)
#: (fraction, crash probability, lag tolerance) of each sweep member: the
#: members differ in active-set width and in slot capacity
MEMBERS = ((0.3, 0.1, 3), (0.2, 0.5, 2), (0.4, 0.3, 4))
ROUNDS, EVAL_EVERY = 8, 4
SAFA = dict(fraction=0.3, lag_tolerance=2)
TIER_FIELDS = ('idx', 'roles', 'base_src', 'cache_src', 'cache_dst',
               'global_dst')


@pytest.fixture(autouse=True)
def _zero_launches():
    backend.reset_launches()
    yield
    assert all(v == 0 for v in backend.LAUNCHES.values()), \
        'a wrapper launched a kernel on CPU tensors'


def _spec(pkg, traced=False, **kw):
    spec = (JEnvSpec if pkg == 'jax' else TEnvSpec)(**dict(ENV, **kw))
    if traced:
        trace = (JDayNight if pkg == 'jax' else TDayNight)(
            period=4, night_bandwidth=0.3, night_speed=0.5)
        spec = spec.replace(traces=trace)
    return spec


def _timing(records):
    return [dataclasses.asdict(dataclasses.replace(r, eval=None))
            for r in records]


def _same_tier(got, want):
    for f in TIER_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ('m', 'rounds', 'width', 'capacity', 'versions_stored',
              'commits_stored', 'nbytes'):
        assert np.all(getattr(got, f) == getattr(want, f)), f


# ---------------------------------------------------------------------------
# (a) host schedules
# ---------------------------------------------------------------------------

#: environment id -> (env fields, traced, lag tolerance, fraction)
ENVS = {
    'static': ({}, False, 2, 0.3),
    'traced': ({}, True, 3, 0.3),
    'crash0': ({'crash_prob': 0.0}, False, 5, 0.3),
    'crash0.9': ({'crash_prob': 0.9}, False, 2, 0.5),
    'tau0': ({}, False, 0, 0.3),
    'tau30': ({}, False, 30, 0.2),
}


def _tier_pair(env_id, rounds=20):
    kw, traced, tau, frac = ENVS[env_id]
    out = []
    for pkg, fed in (('jax', jfed), ('torch', tfed)):
        out.append(fed.precompute_safa_schedule(
            _spec(pkg, traced, **kw).build(), fraction=frac,
            lag_tolerance=tau, rounds=rounds, form='sparse_tier'))
    return out


@pytest.mark.parametrize('env_id', sorted(ENVS))
def test_tier_schedule_matches_reference(env_id):
    js, ts = _tier_pair(env_id)
    assert isinstance(ts, tsched.TierSchedule)
    _same_tier(ts, js)
    assert ts.scratch == js.scratch == ts.capacity
    assert _timing(ts.records) == _timing(js.records)
    assert ts.futility == js.futility


@pytest.mark.parametrize('env_id', sorted(ENVS))
def test_tier_form_equals_dense_to_tier(env_id):
    """One event stream, three encodings: the tier precompute equals the
    dense precompute's ``to_tier()`` in the port and in the JAX package,
    and its ``to_sparse()`` equals the sparse precompute."""
    kw, traced, tau, frac = ENVS[env_id]
    args = dict(fraction=frac, lag_tolerance=tau, rounds=20)
    tier = tfed.precompute_safa_schedule(
        _spec('torch', traced, **kw).build(), form='sparse_tier', **args)
    dense = tfed.precompute_safa_schedule(
        _spec('torch', traced, **kw).build(), **args)
    sparse = tfed.precompute_safa_schedule(
        _spec('torch', traced, **kw).build(), form='sparse', **args)
    jdense = jfed.precompute_safa_schedule(
        _spec('jax', traced, **kw).build(), **args)
    _same_tier(dense.to_tier(), tier)
    _same_tier(dense.to_tier(), jdense.to_tier())
    np.testing.assert_array_equal(tier.to_sparse().idx, sparse.idx)
    np.testing.assert_array_equal(tier.to_sparse().roles, sparse.roles)
    back = tier.to_dense()
    np.testing.assert_array_equal(back.sync[1:], dense.sync[1:])
    for f in ('committed', 'picked', 'undrafted', 'deprecated'):
        np.testing.assert_array_equal(getattr(back, f), getattr(dense, f))


def test_tier_capacity_error_matches_reference():
    args = dict(fraction=0.5, lag_tolerance=2, rounds=6)
    dense = tfed.precompute_safa_schedule(_spec('torch').build(), **args)
    jdense = jfed.precompute_safa_schedule(_spec('jax').build(), **args)
    with pytest.raises(ValueError) as port:
        dense.to_tier(capacity=1)
    with pytest.raises(ValueError) as ref:
        jdense.to_tier(capacity=1)
    assert str(port.value) == str(ref.value)
    wide = dense.to_tier(capacity=30)
    assert wide.width == 30
    _same_tier(wide, jdense.to_tier(capacity=30))


def _slot_invariant(s):
    """Every slot map stays in the buffer; within a round the written
    slots (cache_dst and global_dst, scratch apart) are distinct and
    disjoint from the read slots (base_src, cache_src)."""
    scr = s.scratch
    for f in ('base_src', 'cache_src', 'cache_dst', 'global_dst'):
        a = getattr(s, f)
        assert a.min() >= 0 and a.max() <= scr, f
    for t in range(s.rounds):
        reads = (set(s.base_src[t].tolist())
                 | set(s.cache_src[t].tolist())) - {scr}
        writes = [d for d in s.cache_dst[t].tolist() if d != scr]
        if s.global_dst[t] != scr:
            writes.append(int(s.global_dst[t]))
        assert len(writes) == len(set(writes)), t
        assert not set(writes) & reads, t
        # sentinel slots read and write nothing but the scratch slot
        pad = s.idx[t] == s.m
        assert np.all(s.roles[t][pad] == 0)
        for f in ('base_src', 'cache_src', 'cache_dst'):
            assert np.all(getattr(s, f)[t][pad] == scr)


@pytest.mark.parametrize('env_id', sorted(ENVS))
def test_tier_slot_invariant(env_id):
    _slot_invariant(_tier_pair(env_id)[1])


def _built(pkg, members=MEMBERS):
    env_cls = JEnvSpec if pkg == 'jax' else TEnvSpec
    mem_cls = japi.SweepMember if pkg == 'jax' else tapi.SweepMember
    return [mem_cls(env=env_cls(**dict(ENV, crash_prob=cr)).build(),
                    fraction=f, lag_tolerance=tau, seed=s)
            for s, (f, cr, tau) in enumerate(members)]


def test_tier_fleet_matches_reference():
    """``FleetSchedule.to_tier`` on members of different widths and
    capacities: every field equal to the JAX package's; ``member(s)`` is
    member s in fleet slot space at the fleet's width."""
    jf = jfed.precompute_fleet_schedule(_built('jax'), rounds=20).to_tier()
    tf = tfed.precompute_fleet_schedule(_built('torch'), rounds=20).to_tier()
    assert isinstance(tf, tsched.TierFleetSchedule)
    for f in TIER_FIELDS + ('capacities', 'widths', 'versions_stored',
                            'commits_stored', 'futility'):
        np.testing.assert_array_equal(getattr(tf, f), getattr(jf, f),
                                      err_msg=f)
    for f in ('m', 'size', 'rounds', 'width', 'capacity', 'nbytes'):
        assert getattr(tf, f) == getattr(jf, f), f
    assert len(set(tf.capacities.tolist())) > 1
    assert len(set(tf.widths.tolist())) > 1
    for s in range(tf.size):
        tm, jm = tf.member(s), jf.member(s)
        _same_tier(tm, jm)
        assert tm.width == tf.width and tm.capacity == tf.capacity
        assert _timing(tm.records) == _timing(jm.records)
        assert tm.futility == jm.futility
        _slot_invariant(tm)


def test_tier_fleet_member_is_its_own_schedule_remapped():
    """Member s of the fleet is its own tier precompute, padded with
    sentinel slots to the fleet's width and with its scratch slot moved
    to the fleet's."""
    tf = tfed.precompute_fleet_schedule(_built('torch'), rounds=20).to_tier()
    for s, (f, cr, tau) in enumerate(MEMBERS):
        own = tfed.precompute_safa_schedule(
            TEnvSpec(**dict(ENV, crash_prob=cr)).build(), fraction=f,
            lag_tolerance=tau, rounds=20, form='sparse_tier')
        got = tf.member(s)
        w, cap = own.width, own.capacity
        np.testing.assert_array_equal(got.idx[:, :w], own.idx)
        assert np.all(got.idx[:, w:] == ENV['m'])
        for fld in ('base_src', 'cache_src', 'cache_dst'):
            a = getattr(got, fld)
            np.testing.assert_array_equal(
                a[:, :w], np.where(getattr(own, fld) == cap, tf.capacity,
                                   getattr(own, fld)))
            assert np.all(a[:, w:] == tf.capacity)


def test_tier_fleet_from_members_errors_match_reference():
    tf = tfed.precompute_fleet_schedule(_built('torch'), rounds=20).to_tier()
    jf = jfed.precompute_fleet_schedule(_built('jax'), rounds=20).to_tier()
    tm = [tfed.precompute_safa_schedule(
        TEnvSpec(**dict(ENV, crash_prob=cr)).build(), fraction=f,
        lag_tolerance=tau, rounds=20, form='sparse_tier')
        for f, cr, tau in MEMBERS]
    jm = [jfed.precompute_safa_schedule(
        JEnvSpec(**dict(ENV, crash_prob=cr)).build(), fraction=f,
        lag_tolerance=tau, rounds=20, form='sparse_tier')
        for f, cr, tau in MEMBERS]
    wide = tsched.TierFleetSchedule.from_members(tm, capacity=tf.width + 3)
    jwide = jsched.TierFleetSchedule.from_members(jm, capacity=jf.width + 3)
    for f in TIER_FIELDS:
        np.testing.assert_array_equal(getattr(wide, f), getattr(jwide, f))
    with pytest.raises(ValueError) as port:
        tsched.TierFleetSchedule.from_members(tm, capacity=2)
    with pytest.raises(ValueError) as ref:
        jsched.TierFleetSchedule.from_members(jm, capacity=2)
    assert str(port.value) == str(ref.value)
    short = tfed.precompute_safa_schedule(
        TEnvSpec(**ENV).build(), fraction=0.3, lag_tolerance=3, rounds=5,
        form='sparse_tier')
    with pytest.raises(ValueError, match=r'share \(m, rounds\)'):
        tsched.TierFleetSchedule.from_members([tm[0], short])


def test_tier_schedules_on_device_and_segments():
    tier = _tier_pair('static')[1]
    dev = tier.to_device('cpu')
    assert isinstance(dev, tproto.TierRoundSchedule)
    assert all(getattr(dev, f).dtype == torch.int32 for f in
               ('idx', 'base_src', 'cache_src', 'cache_dst', 'global_dst'))
    assert dev.roles.dtype == torch.uint8
    seg = dev.segment(3, 7)
    for f in TIER_FIELDS:
        np.testing.assert_array_equal(getattr(seg, f).numpy(),
                                      getattr(tier, f)[3:7])
    np.testing.assert_array_equal(seg.round_idx.numpy(), np.arange(4, 8))
    fleet = tfed.precompute_fleet_schedule(_built('torch'),
                                           rounds=20).to_tier()
    fdev = fleet.to_device('cpu')
    assert fdev.idx.shape == (fleet.size, 20, fleet.width)
    assert fdev.global_dst.shape == fdev.round_idx.shape == (fleet.size, 20)
    fseg = fdev.fleet_segment(5, 9)
    np.testing.assert_array_equal(fseg.cache_dst.numpy(),
                                  fleet.cache_dst[:, 5:9])
    np.testing.assert_array_equal(fseg.round_idx[2].numpy(), np.arange(6, 10))


# ---------------------------------------------------------------------------
# (b) kernels 19 and 20: the plain versions against the JAX kernels
# ---------------------------------------------------------------------------

S, C, K, N, TILE = 3, 9, 8, 4096, 256
SCRATCH = C
#: one round's slots, as a tier schedule lays them out: (roles, src, dst).
#: Written slots (5, 6, 7) are never read; the scratch slot is read by the
#: sync-only and sentinel slots and written by every slot whose value is
#: never read again, the last of them winning.
SLOTS = ((6, 0, 5),                   # picked, committed
         (10, 1, 6),                  # undrafted, committed
         (17, 2, SCRATCH),            # deprecated, synced
         (7, 0, SCRATCH),             # picked, committed, synced
         (1, SCRATCH, SCRATCH),       # synced only
         (26, 3, 7),                  # undrafted, deprecated, committed
         (0, SCRATCH, SCRATCH),       # sentinel
         (0, SCRATCH, SCRATCH))       # sentinel


def _tier_inputs(seed, order=None):
    """One member's operands; ``order`` permutes the slots (the slot
    invariant holds in any order).  The weights are data shares, as the
    env's are: they sum to 1 over the real slots and are 0 at the
    sentinels."""
    rng = np.random.default_rng(seed)
    order = np.arange(K) if order is None else np.asarray(order)
    roles, srcs, dsts = (np.array([SLOTS[i][f] for i in order])
                         for f in range(3))
    w = np.zeros(K)
    w[roles != 0] = rng.dirichlet(np.ones(int((roles != 0).sum())))
    return dict(
        buf=rng.standard_normal((C + 1, N)).astype(np.float32),
        trained=rng.standard_normal((K, N)).astype(np.float32),
        base=rng.standard_normal((K, N)).astype(np.float32),
        gprev=rng.standard_normal(N).astype(np.float32),
        agg=rng.standard_normal(N).astype(np.float32),
        srcs=srcs.astype(np.int32), dsts=dsts.astype(np.int32),
        roles=roles.astype(np.uint8), w=w.astype(np.float32))


def _bits(roles, bit):
    return (roles & bit) != 0


def _j(*arrs):
    return [jax.numpy.asarray(x) for x in arrs]


def _t(*arrs):
    return [torch.from_numpy(np.array(x)) for x in arrs]


def _last_scratch_c2(a, c2_of):
    """The scratch row the plain version leaves: the c2 of the last slot
    that writes the scratch slot."""
    last = int(np.flatnonzero(a['dsts'] == SCRATCH)[-1])
    return c2_of(last)


def _c2(a, tr, j):
    """Slot j's c2 by Eq. 6 and 8 (numpy)."""
    r = int(a['roles'][j])
    c0 = a['buf'][a['srcs'][j]]
    c1 = tr[j] if r & 4 else (a['gprev'] if r & 16 else c0)
    return tr[j] if r & 8 else c1


# the slot orders the kernel tests run: the schedule's, and one where a
# slot of a never-read value writes the scratch slot last
ORDERS = {'schedule': None, 'commit-last': [6, 7, 0, 1, 2, 4, 5, 3]}


@pytest.mark.parametrize('order', sorted(ORDERS))
@pytest.mark.parametrize('seed', [0, 3])
def test_tier_rows_matches_reference(seed, order):
    a = _tier_inputs(seed, ORDERS[order])
    r = a['roles']
    buf = _t(a['buf'])[0]
    ng, na, out = tops.safa_aggregate_packed_tier_rows(
        buf, *_t(a['trained'], a['gprev'], a['agg'], a['srcs'], a['dsts'],
                 r, a['w']))
    assert out is buf
    jg, ja, jbuf = jops.safa_aggregate_packed_tier_rows(
        *_j(a['buf'], a['trained'], a['gprev'], a['agg'], a['srcs'],
            a['dsts'], _bits(r, 4), _bits(r, 8), _bits(r, 16), a['w']),
        tile=TILE)
    np.testing.assert_array_equal(out[:C].numpy(), np.asarray(jbuf)[:C])
    np.testing.assert_array_equal(
        out[C].numpy(), _last_scratch_c2(a, lambda j: _c2(a, a['trained'],
                                                           j)))
    np.testing.assert_allclose(ng.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    np.testing.assert_allclose(na.numpy(), np.asarray(ja), rtol=0, atol=1e-6)


@pytest.mark.parametrize('order', sorted(ORDERS))
@pytest.mark.parametrize('seed', [0, 3])
def test_q8_tier_rows_matches_reference(seed, order):
    a = _tier_inputs(seed, ORDERS[order])
    r = a['roles']
    q, sc = (np.array(v) for v in j_quantize(jax.numpy.asarray(a['trained'])))
    buf = _t(a['buf'])[0]
    ng, na, out = tops.safa_aggregate_packed_q8_tier_rows(
        *_t(q, sc, a['base']), buf,
        *_t(a['gprev'], a['agg'], a['srcs'], a['dsts'], r, a['w']))
    assert out is buf
    jg, ja, jbuf = jops.safa_aggregate_packed_q8_tier_rows(
        *_j(q, sc, a['base'], a['buf'], a['gprev'], a['agg'], a['srcs'],
            a['dsts'], _bits(r, 4), _bits(r, 8), _bits(r, 16), _bits(r, 2),
            a['w']), tile=TILE)
    np.testing.assert_array_equal(out[:C].numpy(), np.asarray(jbuf)[:C])
    deq = (q.astype(np.float32).reshape(K, -1, 128)
           * sc[:, :, None]).reshape(K, N)
    tr = np.where(_bits(r, 2)[:, None], deq, a['base'])
    np.testing.assert_array_equal(
        out[C].numpy(), _last_scratch_c2(a, lambda j: _c2(a, tr, j)))
    np.testing.assert_allclose(ng.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    np.testing.assert_allclose(na.numpy(), np.asarray(ja), rtol=0, atol=1e-6)


def _fleet_inputs(seed):
    """S members, each with its own values and its own slot order."""
    rng = np.random.default_rng(seed)
    members = [_tier_inputs(seed + 10 * s, rng.permutation(K))
               for s in range(S)]
    return {k: np.stack([m_[k] for m_ in members]) for k in members[0]}


@pytest.mark.parametrize('kernel', ['tier', 'q8_tier'])
def test_tier_fleet_matches_reference_per_member(kernel):
    """The S-axis forms (the JAX package vmaps the single kernel): member
    s against the JAX kernel on member s's slices, and against the port's
    single-run wrapper bit for bit."""
    a = _fleet_inputs(4)
    r = a['roles']
    q, sc = (np.array(v) for v in j_quantize(
        jax.numpy.asarray(a['trained'].reshape(S * K, N))))
    q, sc = q.reshape(S, K, N), sc.reshape(S, K, -1)
    buf = _t(a['buf'])[0]
    if kernel == 'tier':
        got = tops.safa_aggregate_packed_tier_rows_fleet(
            buf, *_t(a['trained'], a['gprev'], a['agg'], a['srcs'],
                     a['dsts'], r, a['w']))
    else:
        got = tops.safa_aggregate_packed_q8_tier_rows_fleet(
            *_t(q, sc, a['base']), buf,
            *_t(a['gprev'], a['agg'], a['srcs'], a['dsts'], r, a['w']))
    assert got[2] is buf
    for s in range(S):
        one = [x[s] for x in _t(a['buf'], a['trained'], a['gprev'], a['agg'],
                                a['srcs'], a['dsts'], r, a['w'], q, sc,
                                a['base'])]
        if kernel == 'tier':
            want = tops.safa_aggregate_packed_tier_rows(*one[:8])
            ref = jops.safa_aggregate_packed_tier_rows(
                *_j(a['buf'][s], a['trained'][s], a['gprev'][s],
                    a['agg'][s], a['srcs'][s], a['dsts'][s],
                    _bits(r[s], 4), _bits(r[s], 8), _bits(r[s], 16),
                    a['w'][s]), tile=TILE)
        else:
            want = tops.safa_aggregate_packed_q8_tier_rows(
                one[8], one[9], one[10], one[0], *one[2:8])
            ref = jops.safa_aggregate_packed_q8_tier_rows(
                *_j(q[s], sc[s], a['base'][s], a['buf'][s], a['gprev'][s],
                    a['agg'][s], a['srcs'][s], a['dsts'][s],
                    _bits(r[s], 4), _bits(r[s], 8), _bits(r[s], 16),
                    _bits(r[s], 2), a['w'][s]), tile=TILE)
        for x, y in zip(got, want):
            assert torch.equal(x[s], y), s
        np.testing.assert_array_equal(got[2][s, :C].numpy(),
                                      np.asarray(ref[2])[:C])
        for x, y in zip(got[:2], ref[:2]):
            np.testing.assert_allclose(x[s].numpy(), np.asarray(y), rtol=0,
                                       atol=1e-6)


def test_tier_kernels_check_ranks():
    a = _tier_inputs(6)
    buf, trained, g, agg, srcs, dsts, roles, w = _t(
        a['buf'], a['trained'], a['gprev'], a['agg'], a['srcs'], a['dsts'],
        a['roles'], a['w'])
    with pytest.raises(ValueError, match=r'buf \[S, R, N\] and srcs'):
        tops.safa_aggregate_packed_tier_rows_fleet(buf, trained, g, agg,
                                                   srcs, dsts, roles, w)
    with pytest.raises(ValueError, match=r'buf \[R, N\] and srcs \[K\]'):
        tops.safa_aggregate_packed_tier_rows(buf[None], trained, g, agg,
                                             srcs, dsts, roles, w)
    with pytest.raises(ValueError, match='PACK_TILE|multiple'):
        tops.safa_aggregate_packed_tier_rows(buf[:, :100], trained, g, agg,
                                             srcs, dsts, roles, w)


# ---------------------------------------------------------------------------
# (c) whole runs against the JAX package
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


#: cell id -> exec fields (every one on schedule='sparse_tier')
CELLS = {'plain': {}, 'plain-int8': dict(wire='int8'),
         'packed': dict(use_kernel='packed'),
         'packed-int8': dict(use_kernel='packed', wire='int8')}


@pytest.fixture(scope='module')
def runs(reg):
    """Memoised runs: runs(pkg, cell, engine, schedule='sparse_tier',
    traced=False) -> History."""
    jt, tt, init = reg
    memo = {}

    def run(pkg, cell, engine, schedule='sparse_tier', traced=False):
        key = (pkg, cell, engine, schedule, traced)
        if key not in memo:
            ex = dict(CELLS[cell], schedule=schedule, engine=engine,
                      eval_every=EVAL_EVERY)
            spec = _spec(pkg, traced)
            if pkg == 'jax':
                exp = japi.Experiment(jt, spec, japi.SafaSpec(**SAFA),
                                      japi.ExecSpec(**ex), rounds=ROUNDS)
            else:
                exp = tapi.Experiment(tt, spec, tapi.SafaSpec(**SAFA),
                                      tapi.ExecSpec(**ex), rounds=ROUNDS,
                                      device='cpu', init_params=init(0))
            memo[key] = exp.compile().run()
        return memo[key]
    return run


def _losses(hist):
    return [e['loss'] for _, e in hist.evals()]


def _close(a, b, atol, what=''):
    for k, v in b.items():
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(v), rtol=0,
                                   atol=atol, err_msg=f'{what} {k}')


def _equal(a, b):
    for k, v in b.items():
        assert torch.equal(a[k], v), k


@pytest.mark.parametrize('engine', ['scan', 'loop'])
@pytest.mark.parametrize('cell', sorted(CELLS))
def test_run_matches_reference(runs, cell, engine):
    ref, port = runs('jax', cell, engine), runs('torch', cell, engine)
    assert _timing(port.records) == _timing(ref.records)
    assert port.futility == ref.futility
    atol = 1e-4 if CELLS[cell].get('wire') == 'int8' else 1e-5
    _close(port.final_global, ref.final_global, atol)
    np.testing.assert_allclose(_losses(port), _losses(ref), rtol=1e-4)


@pytest.mark.parametrize('cell', ['plain', 'packed-int8'])
def test_traced_run_matches_reference(runs, cell):
    ref = runs('jax', cell, 'scan', traced=True)
    port = runs('torch', cell, 'scan', traced=True)
    assert _timing(port.records) == _timing(ref.records)
    atol = 1e-4 if CELLS[cell].get('wire') == 'int8' else 1e-5
    _close(port.final_global, ref.final_global, atol)


@pytest.mark.parametrize('cell', sorted(CELLS))
def test_scan_equals_loop_bitwise(runs, cell):
    scan, loop = runs('torch', cell, 'scan'), runs('torch', cell, 'loop')
    _equal(scan.final_global, loop.final_global)
    assert _losses(scan) == _losses(loop)


@pytest.mark.parametrize('cell', sorted(CELLS))
def test_tier_close_to_sparse_delta(runs, cell):
    """The tier and the port's own ``'sparse_delta'`` run the same slot
    math on the same events, over other storage: within 1e-5 (int8: the
    same uploads, 1e-4 as the int8 wire's rounding allows)."""
    tier = runs('torch', cell, 'scan')
    delta = runs('torch', cell, 'scan', schedule='sparse_delta')
    atol = 1e-4 if CELLS[cell].get('wire') == 'int8' else 1e-5
    _close(tier.final_global, delta.final_global, atol)


def test_tier_carry_holds_no_client_stack(reg, monkeypatch):
    """A tier run never forms an [m, ...] stack: its carry is the global,
    the [capacity + 1, ...] value buffer (a contiguous copy the rounds
    write in place) and the running aggregate; packed, three pack
    buffers."""
    _, tt, init = reg
    seen = []
    engine = tproto.safa_run_scan_sparse_tier

    def spy(global_w, buf, agg, *args, **kw):
        seen.append((buf, agg))
        return engine(global_w, buf, agg, *args, **kw)
    monkeypatch.setattr(tproto, 'safa_run_scan_sparse_tier', spy)
    exp = tapi.Experiment(tt, _spec('torch'), tapi.SafaSpec(**SAFA),
                          tapi.ExecSpec(schedule='sparse_tier'),
                          rounds=ROUNDS, device='cpu', init_params=init(0))
    cap = exp.precompute().capacity
    exp.compile().run()
    assert seen
    for buf, agg in seen:
        for k, b in buf.items():
            assert b.shape[0] == cap + 1 and b.is_contiguous()
            assert agg[k].shape == b.shape[1:]
    packed = []
    engine_p = tproto.safa_run_scan_sparse_tier_packed

    def spy_p(gbuf, tbuf, abuf, *args, **kw):
        packed.append((gbuf.shape, tbuf.shape, abuf.shape))
        return engine_p(gbuf, tbuf, abuf, *args, **kw)
    monkeypatch.setattr(tproto, 'safa_run_scan_sparse_tier_packed', spy_p)
    tapi.Experiment(tt, _spec('torch'), tapi.SafaSpec(**SAFA),
                    tapi.ExecSpec(schedule='sparse_tier', use_kernel='packed'),
                    rounds=ROUNDS, device='cpu',
                    init_params=init(0)).compile().run()
    n = packed[0][0][0]
    assert packed and all(p == ((n,), (cap + 1, n), (n,)) for p in packed)


# ---------------------------------------------------------------------------
# (d) sweeps against the JAX package
# ---------------------------------------------------------------------------

def _members(pkg):
    env_cls = JEnvSpec if pkg == 'jax' else TEnvSpec
    mem_cls = japi.SweepMember if pkg == 'jax' else tapi.SweepMember
    return [mem_cls(env=env_cls(**ENV), fraction=f, lag_tolerance=tau,
                    seed=s, overrides={'crash_prob': cr})
            for s, (f, cr, tau) in enumerate(MEMBERS)]


@pytest.fixture(scope='module')
def sweeps(reg):
    """Memoised sweeps: sweeps(pkg, cell, engine) -> list of Histories."""
    jt, tt, init = reg
    memo = {}

    def sweep(pkg, cell, engine):
        key = (pkg, cell, engine)
        if key not in memo:
            ex = dict(CELLS[cell], schedule='sparse_tier', engine=engine,
                      eval_every=EVAL_EVERY)
            if pkg == 'jax':
                exp = japi.Experiment(jt, None, japi.SafaSpec(),
                                      japi.ExecSpec(**ex), rounds=ROUNDS)
            else:
                exp = tapi.Experiment(tt, None, tapi.SafaSpec(),
                                      tapi.ExecSpec(**ex), rounds=ROUNDS,
                                      device='cpu', init_params=init)
            memo[key] = exp.compile().run_sweep(_members(pkg))
        return memo[key]
    return sweep


@pytest.mark.parametrize('engine', ['fleet', 'sequential'])
@pytest.mark.parametrize('cell', sorted(CELLS))
def test_sweep_matches_reference(sweeps, cell, engine):
    refs, ports = sweeps('jax', cell, engine), sweeps('torch', cell, engine)
    atol = 1e-4 if CELLS[cell].get('wire') == 'int8' else 1e-5
    assert len(ports) == len(refs) == len(MEMBERS)
    for s, (ref, port) in enumerate(zip(refs, ports)):
        assert _timing(port.records) == _timing(ref.records)
        assert port.futility == ref.futility
        _close(port.final_global, ref.final_global, atol, f'member {s}')
        np.testing.assert_allclose(_losses(port), _losses(ref), rtol=1e-4)


@pytest.mark.parametrize('cell', sorted(CELLS))
def test_fleet_equals_sequential_bitwise(sweeps, cell):
    """The sequential engine replays each member at the fleet's width and
    capacity, so fleet and sequential run one program: the same bits."""
    for f, q in zip(sweeps('torch', cell, 'fleet'),
                    sweeps('torch', cell, 'sequential')):
        _equal(f.final_global, q.final_global)
        assert _losses(f) == _losses(q)

"""The sparse active-set schedules in the port (``schedule='sparse'`` and
``'sparse_delta'`` for SAFA, FedAvg and FedCS single runs) against the
JAX package on the same seeded inputs, with the JAX kernels in interpret
mode as its own tests run them.

Tolerances:

* host schedules are numpy in both packages: ``idx``, ``roles``, records
  and futility equal;
* ``gather_rows``/``scatter_rows`` copy values: the plain versions equal
  the JAX kernels exactly; the rows aggregations' c2 and local rows are
  selects and one multiply, equal exactly, while new_global and new_agg
  are sums taken in another order, held to rtol 1e-5.  The plain versions
  follow the kernels' formula, new_agg = agg + sum w (c2 - c0), as the
  JAX kernels do (not the tree path's two-step agg1 + sum w (c2 - c1));
* whole runs (regression task, m = 24, crash 0.3, from the reference's
  init): ``final_global`` within atol 1e-5 of the JAX run on the f32
  wire and within atol 1e-4 of the JAX package's own int8 run on the
  int8 wire, as ``test_torch_api.py`` holds the dense path;
* inside the port: scan == loop bit for bit; ``'sparse'`` == dense bit
  for bit (the regression task trains a row as the dense pass does);
  ``'sparse_delta'`` within atol 1e-5 of dense (another summation order).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import federation as jfed
from repro.core import protocol as jproto
from repro.core import schedules as jsched
from repro.data import make_images, make_regression, make_svm, partition
from repro.data import tasks as jtasks
from repro.fedsim import EnvSpec as JEnvSpec
from repro.fedsim.traces import DayNight as JDayNight
from repro.kernels import ops as jops
from repro.kernels.comm_quant import quantize_packed as j_quantize
from repro_torch import api as tapi
from repro_torch.core import api as tcore
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
ROUNDS, EVAL_EVERY = 12, 4


@pytest.fixture(autouse=True)
def _zero_launches():
    backend.reset_launches()
    yield
    assert all(v == 0 for v in backend.LAUNCHES.values()), \
        'a wrapper launched a kernel on CPU tensors'


def _env(pkg, traced=False, **kw):
    spec = (JEnvSpec if pkg == 'jax' else TEnvSpec)(**dict(ENV, **kw))
    if traced:
        trace = (JDayNight if pkg == 'jax' else TDayNight)(
            period=4, night_bandwidth=0.3, night_speed=0.5)
        spec = spec.replace(traces=trace)
    return spec.build()


def _timing(records):
    return [dataclasses.asdict(dataclasses.replace(r, eval=None))
            for r in records]


# ---------------------------------------------------------------------------
# (a) host schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('traced', [False, True], ids=['static', 'traced'])
@pytest.mark.parametrize('lag', [2, 5])
def test_safa_sparse_schedule_matches_reference(lag, traced):
    kw = dict(fraction=0.3, lag_tolerance=lag, rounds=30, form='sparse')
    js = jfed.precompute_safa_schedule(_env('jax', traced), **kw)
    ts = tfed.precompute_safa_schedule(_env('torch', traced), **kw)
    assert isinstance(ts, tsched.SparseSchedule)
    assert ts.idx.dtype == np.int32 and ts.roles.dtype == np.uint8
    np.testing.assert_array_equal(ts.idx, js.idx)
    np.testing.assert_array_equal(ts.roles, js.roles)
    assert (ts.m, ts.rounds, ts.capacity, ts.nbytes) == \
        (js.m, js.rounds, js.capacity, js.nbytes)
    assert _timing(ts.records) == _timing(js.records)
    assert ts.futility == js.futility


@pytest.mark.parametrize('traced', [False, True], ids=['static', 'traced'])
@pytest.mark.parametrize('fedcs,sampler', [(False, 'choice'),
                                           (False, 'topk'), (True, 'choice')],
                         ids=['fedavg-choice', 'fedavg-topk', 'fedcs'])
def test_sync_sparse_schedule_matches_reference(fedcs, sampler, traced):
    kw = dict(fraction=0.3, rounds=30, seed=2, fedcs=fedcs, sampler=sampler,
              form='sparse')
    js = jfed.precompute_sync_schedule(_env('jax', traced), **kw)
    ts = tfed.precompute_sync_schedule(_env('torch', traced), **kw)
    assert isinstance(ts, tsched.SparseSyncSchedule)
    np.testing.assert_array_equal(ts.idx, js.idx)
    np.testing.assert_array_equal(ts.roles, js.roles)
    assert (ts.capacity, ts.nbytes) == (js.capacity, js.nbytes)
    assert _timing(ts.records) == _timing(js.records)
    assert ts.futility == js.futility


def test_safa_to_sparse_round_trip():
    """dense.to_sparse() equals the sparse precompute and the JAX
    package's to_sparse(); to_dense() gives back every mask, except round
    1's sync mask, whose sync-only clients are left out."""
    kw = dict(fraction=0.3, lag_tolerance=3, rounds=20)
    dense = tfed.precompute_safa_schedule(_env('torch'), **kw)
    sparse = tfed.precompute_safa_schedule(_env('torch'), form='sparse',
                                           **kw)
    via = dense.to_sparse()
    np.testing.assert_array_equal(via.idx, sparse.idx)
    np.testing.assert_array_equal(via.roles, sparse.roles)
    jvia = jfed.precompute_safa_schedule(_env('jax'), **kw).to_sparse()
    np.testing.assert_array_equal(via.idx, jvia.idx)
    np.testing.assert_array_equal(via.roles, jvia.roles)
    back = sparse.to_dense()
    for k in ('committed', 'picked', 'undrafted', 'deprecated'):
        np.testing.assert_array_equal(getattr(back, k), getattr(dense, k))
    np.testing.assert_array_equal(back.sync[1:], dense.sync[1:])
    assert back.sync[0].sum() < dense.sync[0].sum() == ENV['m']
    assert back.records is dense.records or \
        _timing(back.records) == _timing(dense.records)


@pytest.mark.parametrize('fedcs', [False, True], ids=['fedavg', 'fedcs'])
def test_sync_to_sparse_round_trip(fedcs):
    kw = dict(fraction=0.3, rounds=20, seed=1, fedcs=fedcs)
    dense = tfed.precompute_sync_schedule(_env('torch'), **kw)
    sparse = tfed.precompute_sync_schedule(_env('torch'), form='sparse', **kw)
    via = dense.to_sparse()
    np.testing.assert_array_equal(via.idx, sparse.idx)
    np.testing.assert_array_equal(via.roles, sparse.roles)
    jvia = jfed.precompute_sync_schedule(_env('jax'), **kw).to_sparse()
    np.testing.assert_array_equal(via.idx, jvia.idx)
    np.testing.assert_array_equal(via.roles, jvia.roles)
    back = sparse.to_dense()
    np.testing.assert_array_equal(back.selected, dense.selected)
    np.testing.assert_array_equal(back.completed & back.selected,
                                  dense.completed & dense.selected)


def test_bootstrap_elision_matches_reference():
    rng = np.random.default_rng(0)
    m = 40
    masks = [rng.random(m) < p for p in (1.0, 0.2, 0.1, 0.15, 0.05)]
    masks[1] &= masks[0]               # committed within the population
    masks[2] &= masks[1]               # picked implies committed
    for boot in (False, True):
        ti, tr = tsched.safa_sparse_row(*masks, bootstrap=boot)
        ji, jr = jsched.safa_sparse_row(*masks, bootstrap=boot)
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tr, jr)
        assert ti.dtype == np.int32 and tr.dtype == np.uint8
    full, _ = tsched.safa_sparse_row(*masks, bootstrap=False)
    elided, roles = tsched.safa_sparse_row(*masks, bootstrap=True)
    assert len(full) == m and len(elided) < m
    assert np.all(roles != tproto.ROLE_SYNC)


def test_capacity_error_matches_reference():
    rows = [(np.arange(3, dtype=np.int32), np.ones(3, np.uint8)),
            (np.arange(5, dtype=np.int32), np.ones(5, np.uint8))]
    with pytest.raises(ValueError) as port:
        tsched.pack_sparse_rows(rows, 10, capacity=4)
    with pytest.raises(ValueError) as ref:
        jsched.pack_sparse_rows(rows, 10, capacity=4)
    assert str(port.value) == str(ref.value)
    assert 'capacity 4 < active-set size 5 at round 1' in str(port.value)
    idx, roles = tsched.pack_sparse_rows(rows, 10, capacity=6)
    assert idx.shape == (2, 6) and np.all(idx[0, 3:] == 10)
    assert np.all(roles[1, 5:] == 0)


def test_sparse_tier_form_stays_unported(tmp_path):
    """The name dates from before the lag tier was ported.  The tier form
    is now the host precompute's third form (a ``TierSchedule`` whose
    event stream is the sparse one); its checkpoint is ported too (a
    numeric run without a task is refused before any file is written),
    and an unknown form is still refused."""
    tier = tfed.precompute_safa_schedule(_env('torch'), fraction=0.3,
                                         lag_tolerance=3, rounds=4,
                                         form='sparse_tier')
    sparse = tfed.precompute_safa_schedule(_env('torch'), fraction=0.3,
                                           lag_tolerance=3, rounds=4,
                                           form='sparse')
    assert isinstance(tier, tsched.TierSchedule)
    np.testing.assert_array_equal(tier.idx, sparse.idx)
    np.testing.assert_array_equal(tier.roles, sparse.roles)
    exp = tapi.Experiment(None, TEnvSpec(**ENV), tapi.SafaSpec(),
                          tapi.ExecSpec(schedule='sparse_tier'), rounds=4,
                          device='cpu')
    with pytest.raises(ValueError, match='numeric run needs a Task'):
        exp.compile().run(checkpoint=str(tmp_path / 'tier'))
    assert not (tmp_path / 'tier.npz').exists()
    with pytest.raises(ValueError, match='unknown form'):
        tfed.precompute_safa_schedule(_env('torch'), fraction=0.3,
                                      lag_tolerance=3, rounds=4,
                                      form='ragged')


def test_to_device_and_segments():
    sched = tfed.precompute_safa_schedule(_env('torch'), fraction=0.3,
                                          lag_tolerance=3, rounds=10,
                                          form='sparse')
    dev = sched.to_device('cpu')
    assert isinstance(dev, tproto.SparseRoundSchedule)
    assert dev.idx.dtype == torch.int32 and dev.roles.dtype == torch.uint8
    seg = dev.segment(3, 7)
    np.testing.assert_array_equal(seg.idx.numpy(), sched.idx[3:7])
    np.testing.assert_array_equal(seg.round_idx.numpy(), np.arange(4, 8))
    sync = tfed.precompute_sync_schedule(_env('torch'), fraction=0.3,
                                         rounds=10, seed=0, fedcs=False,
                                         form='sparse').to_device('cpu')
    assert isinstance(sync, tproto.SparseSyncSchedule)
    assert sync.segment(0, 2).roles.shape == (2, sync.roles.shape[1])


def test_scatter_masks_equal_the_dense_masks():
    kw = dict(fraction=0.3, lag_tolerance=3, rounds=10)
    dense = tfed.precompute_safa_schedule(_env('torch'), **kw)
    sparse = tfed.precompute_safa_schedule(_env('torch'), form='sparse',
                                           **kw)
    bits = (tproto.ROLE_COMMITTED, tproto.ROLE_PICKED,
            tproto.ROLE_UNDRAFTED, tproto.ROLE_DEPRECATED, tproto.ROLE_SYNC)
    for t in range(1, 10):
        got = tproto.scatter_masks(torch.as_tensor(sparse.idx[t]),
                                   torch.as_tensor(sparse.roles[t]),
                                   ENV['m'], bits)
        want = (dense.committed[t], dense.picked[t], dense.undrafted[t],
                dense.deprecated[t], dense.sync[t])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)


def test_row_helpers_clamp_and_drop_sentinels():
    m = 5
    tree = {'w': torch.arange(m * 3, dtype=torch.float32).reshape(m, 3)}
    idx = torch.tensor([1, 4, m, m], dtype=torch.int32)
    got = tproto.tree_gather(tree, idx)['w']
    assert torch.equal(got[:2], tree['w'][[1, 4]])
    assert torch.equal(got[2:], tree['w'][[m - 1, m - 1]])   # clamped
    rows = {'w': -torch.ones(4, 3)}
    out = tproto.tree_scatter(tree, idx, rows)['w']
    want = tree['w'].clone()
    want[[1, 4]] = -1.0
    assert torch.equal(out, want) and out.shape == (m, 3)
    assert torch.equal(tree['w'][1], torch.tensor([3.0, 4.0, 5.0]))
    w = tproto._slot_weights(idx, torch.full((m,), 0.2))
    assert torch.equal(w, torch.tensor([0.2, 0.2, 0.0, 0.0]))


# ---------------------------------------------------------------------------
# (b) the rows kernels' plain versions against the JAX kernels (interpret)
# ---------------------------------------------------------------------------

def _rows_inputs(seed, m=13, n=4096, k=7):
    rng = np.random.default_rng(seed)
    arr = dict(
        cache=rng.standard_normal((m + 1, n)).astype(np.float32),
        trained=rng.standard_normal((k, n)).astype(np.float32),
        base=rng.standard_normal((k, n)).astype(np.float32),
        gprev=rng.standard_normal(n).astype(np.float32),
        agg=rng.standard_normal(n).astype(np.float32),
        rows=np.array([1, 5, 7, 2, 9, m, m][:k], np.int32),
        roles=np.array([6, 2 | 8, 7, 16 | 1, 0, 0, 0][:k], np.uint8),
    )
    arr['w'] = np.where(arr['rows'] < m, rng.random(k), 0.0).astype(
        np.float32)
    return arr


def _bits(roles, bit):
    return (roles & bit) != 0


def test_gather_rows_matches_reference():
    a = _rows_inputs(0)
    rows = np.array([3, 9, 3, 13, 0], np.int32)      # duplicate, sentinel
    got = tops.gather_rows(torch.from_numpy(a['cache']),
                           torch.from_numpy(rows))
    want = jops.gather_rows(jax.numpy.asarray(a['cache']),
                            jax.numpy.asarray(rows))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scatter_rows_matches_reference():
    a = _rows_inputs(1)
    rows = np.array([3, 9, 3, 13, 13, 0], np.int32)  # duplicates, sentinels
    vals = np.random.default_rng(5).standard_normal(
        (len(rows), a['cache'].shape[1])).astype(np.float32)
    buf = torch.from_numpy(a['cache'].copy())
    out = tops.scatter_rows(buf, torch.from_numpy(rows),
                            torch.from_numpy(vals))
    assert out is buf
    want = jops.scatter_rows(jax.numpy.asarray(a['cache']),
                             jax.numpy.asarray(rows),
                             jax.numpy.asarray(vals))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    assert np.array_equal(out.numpy()[3], vals[2])          # last slot wins
    assert np.array_equal(out.numpy()[13], vals[4])


def test_row_indices_outside_the_buffer_go_to_the_scratch_row():
    a = _rows_inputs(2)
    buf = torch.from_numpy(a['cache'].copy())
    rows = torch.tensor([-1, 40, 2], dtype=torch.int32)
    got = tops.gather_rows(buf, rows)
    assert torch.equal(got[0], buf[-1]) and torch.equal(got[1], buf[-1])
    vals = torch.full((3, buf.shape[1]), 7.0)
    before = buf.clone()
    tops.scatter_rows(buf, rows, vals)
    assert torch.equal(buf[-1], vals[1]) and torch.equal(buf[2], vals[2])
    assert torch.equal(buf[:2], before[:2])


def _j(*arrs):
    return [jax.numpy.asarray(x) for x in arrs]


@pytest.mark.parametrize('seed', [0, 3])
def test_rows_aggregate_matches_reference(seed):
    a = _rows_inputs(seed)
    r = a['roles']
    ng, na, c2 = tops.safa_aggregate_packed_rows(
        *map(torch.from_numpy, (a['cache'], a['trained'], a['gprev'],
                                a['agg'], a['rows'], r, a['w'])))
    jg, ja, jc2 = jops.safa_aggregate_packed_rows(
        *_j(a['cache'], a['trained'], a['gprev'], a['agg'], a['rows'],
            _bits(r, 4), _bits(r, 8), _bits(r, 16), a['w']))
    np.testing.assert_array_equal(c2.numpy(), np.asarray(jc2))
    np.testing.assert_allclose(ng.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(na.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize('seed', [0, 3])
def test_q8_rows_aggregate_matches_reference(seed):
    a = _rows_inputs(seed)
    r = a['roles']
    q, s = j_quantize(jax.numpy.asarray(a['trained']))
    q, s = np.array(q), np.array(s)
    ng, na, c2, loc = tops.safa_aggregate_packed_q8_rows(
        *map(torch.from_numpy, (q, s, a['base'], a['cache'], a['gprev'],
                                a['agg'], a['rows'], r, a['w'])))
    jg, ja, jc2, jl = jops.safa_aggregate_packed_q8_rows(
        *_j(q, s, a['base'], a['cache'], a['gprev'], a['agg'], a['rows'],
            _bits(r, 4), _bits(r, 8), _bits(r, 16), _bits(r, 2), a['w']))
    np.testing.assert_array_equal(c2.numpy(), np.asarray(jc2))
    np.testing.assert_array_equal(loc.numpy(), np.asarray(jl))
    np.testing.assert_allclose(ng.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(na.numpy(), np.asarray(ja), rtol=1e-5,
                               atol=1e-6)


def test_rows_wrappers_refuse_a_bad_width():
    buf = torch.zeros((4, 300))
    with pytest.raises(ValueError, match='PACK_TILE'):
        tops.gather_rows(buf, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match='vals shape'):
        tops.scatter_rows(torch.zeros((4, 2048)),
                          torch.zeros(2, dtype=torch.int32),
                          torch.zeros((3, 2048)))


# ---------------------------------------------------------------------------
# (c) the rows-train contract
# ---------------------------------------------------------------------------

def _tasks(kind):
    env = _env('torch')
    if kind == 'regression':
        x, y = make_regression()
        data = partition(x, y, env.partition_sizes, 5, seed=1)
        return (jtasks.regression_task(data, lr=1e-3, epochs=2),
                ttasks.regression_task(data, lr=1e-3, epochs=2,
                                       device='cpu'))
    if kind == 'svm':
        x, y = make_svm(n=2000)
        data = partition(x, y, env.partition_sizes, 10, seed=1)
        return (jtasks.svm_task(data, epochs=2),
                ttasks.svm_task(data, epochs=2, device='cpu'))
    spec = TEnvSpec(m=5, crash_prob=0.3, dataset_size=120, batch_size=8,
                    epochs=1, t_lim=5600.0, seed=0)
    x, y = make_images(n=120, seed=0)
    data = partition(x, y, spec.build().partition_sizes, 8, seed=0)
    return (jtasks.cnn_task(data, lr=1e-3, epochs=1),
            ttasks.cnn_task(data, lr=1e-3, epochs=1, device='cpu'))


@pytest.mark.parametrize('kind', ['regression', 'svm', 'cnn'])
def test_rows_train_matches_dense_rows(kind):
    """A trained row equals its dense counterpart: exactly for the
    regression and SVM tasks; the CNN's replicas train as grouped
    convolutions whose CPU algorithm depends on the group count (K or m),
    so there a row is held to atol 1e-6.  Sentinel rows train on the last
    client's data and stay finite.  Against the reference's rows-train
    the tolerances of ``test_torch_tasks.py`` hold (the CNN's: rtol 1e-4 /
    atol 1e-5, the convolutions summing in another order)."""
    jt, tt = _tasks(kind)
    m = tt._x.shape[0]
    gen = torch.Generator().manual_seed(0)
    g = tt.init_global(0)
    stacked = {k: v[None] + 0.01 * torch.randn((m,) + v.shape, generator=gen)
               for k, v in g.items()}
    full = tt.local_train(stacked, 1)
    rows = torch.tensor([0, 2, 3, m - 1, m], dtype=torch.int32)
    part = tt.local_train_rows(tproto.tree_gather(stacked, rows), rows, 1)
    for k in full:
        want = full[k][rows[:4].long()]
        if kind == 'cnn':
            torch.testing.assert_close(part[k][:4], want, rtol=0, atol=1e-6)
        else:
            assert torch.equal(part[k][:4], want), k
        assert torch.isfinite(part[k][4]).all()
    # and the reference's rows-train on the same replicas
    jrows = jax.numpy.asarray(rows.numpy())
    jpart = jt.local_train_rows(
        {k: jax.numpy.asarray(v.numpy())
         for k, v in tproto.tree_gather(stacked, rows).items()}, jrows, 1)
    rtol, atol = (1e-4, 1e-5) if kind == 'cnn' else (1e-5, 1e-6)
    for k, v in jpart.items():
        np.testing.assert_allclose(part[k][:4].numpy(), np.asarray(v)[:4],
                                   rtol=rtol, atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# (d) whole runs against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def reg():
    x, y = make_regression()
    data = partition(x, y, _env('jax').partition_sizes, 5, seed=1)
    jt = jtasks.regression_task(data, lr=1e-3, epochs=3)
    tt = ttasks.regression_task(data, lr=1e-3, epochs=3, device='cpu')
    init = {k: np.array(v) for k, v in
            jt.init_global(jax.random.PRNGKey(0)).items()}
    return jt, tt, init


#: cell id -> (protocol name, spec fields, exec fields)
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
PROTO_KW = {'safa': dict(fraction=0.3, lag_tolerance=3),
            'fedavg': dict(fraction=0.3), 'fedcs': dict(fraction=0.3)}


@pytest.fixture(scope='module')
def runs(reg):
    """Memoised runs: runs(pkg, cell, engine, schedule=None) -> History
    (``schedule`` overrides the cell's, e.g. 'dense' for its dense
    twin)."""
    jt, tt, init = reg
    memo = {}

    def run(pkg, cell, engine, schedule=None):
        key = (pkg, cell, engine, schedule)
        if key not in memo:
            name, kw, ex = CELLS[cell]
            ex = dict(ex, engine=engine, eval_every=EVAL_EVERY)
            if schedule is not None:
                ex['schedule'] = schedule
            kw = dict(PROTO_KW[name], **kw)
            if pkg == 'jax':
                exp = japi.Experiment(jt, _env('jax'), japi.spec(name, **kw),
                                      japi.ExecSpec(**ex), rounds=ROUNDS)
            else:
                exp = tapi.Experiment(tt, _env('torch'),
                                      tapi.spec(name, **kw),
                                      tapi.ExecSpec(**ex), rounds=ROUNDS,
                                      device='cpu', init_params=init)
            memo[key] = exp.compile().run()
        return memo[key]
    return run


def _losses(hist):
    return [e['loss'] for _, e in hist.evals()]


@pytest.mark.parametrize('engine', ['scan', 'loop'])
@pytest.mark.parametrize('cell', sorted(CELLS))
def test_run_matches_reference(runs, cell, engine):
    ref, port = runs('jax', cell, engine), runs('torch', cell, engine)
    assert _timing(port.records) == _timing(ref.records)
    assert port.futility == ref.futility
    atol = 1e-4 if CELLS[cell][2].get('wire') == 'int8' else 1e-5
    for k, v in ref.final_global.items():
        np.testing.assert_allclose(port.final_global[k].numpy(),
                                   np.asarray(v), rtol=0, atol=atol,
                                   err_msg=k)
    np.testing.assert_allclose(_losses(port), _losses(ref), rtol=1e-4)


@pytest.mark.parametrize('cell', sorted(CELLS))
def test_scan_equals_loop(runs, cell):
    scan, loop = runs('torch', cell, 'scan'), runs('torch', cell, 'loop')
    for k, v in scan.final_global.items():
        assert torch.equal(v, loop.final_global[k]), k
    assert _losses(scan) == _losses(loop)


@pytest.mark.parametrize('cell', sorted(CELLS))
def test_sparse_matches_dense(runs, cell):
    """'sparse' equals the port's dense run bit for bit; 'sparse_delta'
    sums in another order, within atol 1e-5."""
    sparse = runs('torch', cell, 'scan')
    dense = runs('torch', cell, 'scan', schedule='dense')
    assert _timing(sparse.records) == _timing(dense.records)
    for k, v in dense.final_global.items():
        if CELLS[cell][2]['schedule'] == 'sparse':
            assert torch.equal(sparse.final_global[k], v), k
        else:
            torch.testing.assert_close(sparse.final_global[k], v, rtol=0,
                                       atol=1e-5)


def test_stateless_carry_holds_no_local_stack(reg, monkeypatch):
    """FedAvg/FedCS sparse_delta carry the global model alone: the state
    the run builds has no local (or cache) stack, and the sparse_delta
    engine is handed the global model alone."""
    _, tt, init = reg
    states, calls = [], []
    init_state = tcore._init_state

    def spy(*args, **kwargs):
        st = init_state(*args, **kwargs)
        states.append(st)
        return st
    engine = tproto.fedavg_run_scan_sparse_delta

    def spy_engine(global_w, *args, **kwargs):
        calls.append(global_w)
        return engine(global_w, *args, **kwargs)
    monkeypatch.setattr(tcore, '_init_state', spy)
    monkeypatch.setattr(tproto, 'fedavg_run_scan_sparse_delta', spy_engine)
    for name in ('fedavg', 'fedcs'):
        tapi.Experiment(tt, _env('torch'), tapi.spec(name, fraction=0.3),
                        tapi.ExecSpec(schedule='sparse_delta',
                                      eval_every=EVAL_EVERY),
                        rounds=ROUNDS, device='cpu',
                        init_params=init).compile().run()
    assert len(states) == 2
    assert all(st.local_w is None and st.cache is None for st in states)
    assert len(calls) == 2 * (ROUNDS // EVAL_EVERY)


def test_packed_delta_state_is_pack_buffers(reg, monkeypatch):
    """SAFA sparse_delta 'packed' carries [m + 1, N] local and cache pack
    buffers, written in place round after round, and no trees."""
    _, tt, init = reg
    seen = []
    round_fn = tproto.safa_round_sparse_delta_packed

    def spy(gbuf, lbuf, cbuf, abuf, **kw):
        out = round_fn(gbuf, lbuf, cbuf, abuf, **kw)
        seen.append((lbuf.data_ptr(), cbuf.data_ptr(),
                     out[1].data_ptr(), out[2].data_ptr(),
                     tuple(lbuf.shape)))
        return out
    monkeypatch.setattr(tproto, 'safa_round_sparse_delta_packed', spy)
    hist = tapi.Experiment(tt, _env('torch'), tapi.spec('safa', fraction=0.3),
                           tapi.ExecSpec(schedule='sparse_delta',
                                         use_kernel='packed', eval_every=6),
                           rounds=ROUNDS, device='cpu',
                           init_params=init).compile().run()
    assert len(seen) == ROUNDS
    assert all(a == c and b == d for a, b, c, d, _ in seen)
    assert len({(a, b) for a, b, *_ in seen}) == 1
    assert seen[0][4] == (ENV['m'] + 1, 2048)
    assert sorted(hist.final_global) == ['b', 'w']


# ---------------------------------------------------------------------------
# (e) check_compat: the JAX package's errors, and the cells left unported
# ---------------------------------------------------------------------------

#: (id, protocol name, spec fields, exec fields) of each refusal
REFUSALS = [
    ('delta-kernel-true', 'safa', {}, dict(schedule='sparse_delta',
                                           use_kernel=True)),
    ('tier-kernel-true', 'safa', {}, dict(schedule='sparse_tier',
                                          use_kernel=True)),
    ('sparse-quantize-uploads', 'safa', dict(quantize_uploads=True),
     dict(schedule='sparse')),
    ('local-sparse', 'local', {}, dict(schedule='sparse')),
    ('fedasync-delta', 'fedasync', {}, dict(schedule='sparse_delta')),
    ('seafl-sparse', 'seafl', {}, dict(schedule='sparse')),
    ('csafl-delta', 'csafl', {}, dict(schedule='sparse_delta')),
    ('fedavg-tier', 'fedavg', {}, dict(schedule='sparse_tier')),
    ('fedcs-tier', 'fedcs', {}, dict(schedule='sparse_tier')),
    ('fedavg-kernel', 'fedavg', {}, dict(schedule='sparse',
                                         use_kernel='packed')),
]


@pytest.mark.parametrize('name,fields,ex', [r[1:] for r in REFUSALS],
                         ids=[r[0] for r in REFUSALS])
def test_refusals_match_reference(name, fields, ex):
    with pytest.raises(ValueError) as port:
        tapi.check_compat(tapi.spec(name, **fields), tapi.ExecSpec(**ex))
    with pytest.raises(ValueError) as ref:
        japi.check_compat(japi.spec(name, **fields), japi.ExecSpec(**ex))
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize('engine', ['fleet', 'sequential'])
@pytest.mark.parametrize('schedule', ['sparse', 'sparse_delta'])
@pytest.mark.parametrize('name', ['safa', 'fedavg', 'fedcs'])
def test_sparse_sweeps_name_item_22(name, schedule, engine):
    """ROADMAP item 22, sparse sweeps, is ported: the port admits every
    sparse sweep cell the JAX package admits, with every wire and the
    kernel routes of the single runs."""
    kernels = {'safa': (False, True, 'packed') if schedule == 'sparse'
               else (False, 'packed')}.get(name, (False,))
    for wire in ('f32', 'int8'):
        for use_kernel in kernels:
            kw = dict(engine=engine, schedule=schedule, wire=wire,
                      use_kernel=use_kernel)
            assert tapi.check_compat(tapi.spec(name),
                                     tapi.ExecSpec(**kw)).name == name
            japi.check_compat(japi.spec(name), japi.ExecSpec(**kw))


@pytest.mark.parametrize('schedule', ['sparse', 'sparse_delta'])
def test_run_sweep_refuses_sparse_schedules(reg, schedule):
    """A sparse sweep needs the rows-train contract of a shared task: with
    per-member tasks (padded stacking) it raises the JAX package's
    ValueError; with a shared task it runs."""
    jt, tt, _ = reg
    runner = tapi.Experiment(tt, None, tapi.SafaSpec(),
                             tapi.ExecSpec(schedule=schedule), rounds=2,
                             device='cpu').compile()
    other = ttasks.regression_task(tt.data, lr=5e-4, epochs=3, device='cpu')
    with pytest.raises(ValueError, match='rows-train contract') as port:
        runner.run_sweep(tapi.SweepSpec(
            members=[tapi.SweepMember(env=TEnvSpec(**ENV))] * 2,
            tasks=(tt, other)))
    ref = japi.Experiment(jt, None, japi.SafaSpec(),
                          japi.ExecSpec(schedule=schedule),
                          rounds=2).compile()
    jother = jtasks.regression_task(jt.data, lr=5e-4, epochs=3)
    with pytest.raises(ValueError) as want:
        ref.run_sweep(japi.SweepSpec(
            members=[japi.SweepMember(env=JEnvSpec(**ENV))] * 2,
            tasks=(jt, jother)))
    assert str(port.value) == str(want.value)
    hists = runner.run_sweep([tapi.SweepMember(env=TEnvSpec(**ENV))])
    assert len(hists) == 1 and hists[0].final_global is not None


@pytest.mark.parametrize('name', ['safa', 'fedavg', 'fedcs'])
@pytest.mark.parametrize('schedule', ['sparse', 'sparse_delta'])
def test_sparse_run_cells_admitted(name, schedule):
    for engine in (None, 'scan', 'loop'):
        pdef = tapi.check_compat(tapi.spec(name),
                                 tapi.ExecSpec(engine=engine,
                                               schedule=schedule))
        assert pdef.sparse_precompute is not None
    assert tapi.check_compat(tapi.spec(name), tapi.ExecSpec(
        schedule=schedule, wire='int8')).name == name


def test_timing_only_sparse_run_matches_dense_records():
    for name in ('safa', 'fedavg'):
        hists = [tapi.Experiment(None, _env('torch'), tapi.spec(name),
                                 tapi.ExecSpec(schedule=s, numeric=False),
                                 rounds=ROUNDS, device='cpu').compile().run()
                 for s in ('dense', 'sparse', 'sparse_delta')]
        assert _timing(hists[0].records) == _timing(hists[1].records) == \
            _timing(hists[2].records)
        assert hists[0].futility == hists[1].futility


def test_role_bits_match_reference():
    for n in ('ROLE_SYNC', 'ROLE_COMMITTED', 'ROLE_PICKED', 'ROLE_UNDRAFTED',
              'ROLE_DEPRECATED', 'SROLE_SELECTED', 'SROLE_COMPLETED'):
        assert getattr(tproto, n) == getattr(jproto, n)
    roles = torch.tensor([0, 3, 16, 31], dtype=torch.uint8)
    assert tproto.has_role(roles, tproto.ROLE_COMMITTED).tolist() == \
        [False, True, False, True]

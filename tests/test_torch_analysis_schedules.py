"""The port's schedule pass (``repro_torch.analysis``, rules SCH001-006)
against the JAX package's ``repro.analysis``: the same findings on every
distinct (protocol, engine, schedule) cell of the registry, on host
precomputes equal field by field, and every rule firing on a corrupted
schedule as the reference's fires on the same corruption."""
import copy
import dataclasses

import numpy as np
import pytest

from repro import analysis as janalysis
from repro import fedsim as jfedsim
from repro.analysis import jaxpr_checks
from repro.core import agg_schemes as jagg
from repro.core import federation as jfed
from repro_torch import analysis, fedsim
from repro_torch.analysis import launch_checks
from repro_torch.core import agg_schemes, federation, protocol

ROUNDS = 8
ENV = dict(m=5, crash_prob=0.3, dataset_size=506, batch_size=5, epochs=3,
           t_lim=830.0)


def _key(cell):
    return f'{cell.pdef.name}[{cell.ex.engine}/{cell.ex.schedule}]'


def _distinct(cells):
    out = {}
    for cell in cells:
        out.setdefault(_key(cell), cell)
    return out


KEYS = list(_distinct(launch_checks.iter_cells()))


def _same(a, b, path='') -> None:
    """Field-by-field equality of a port schedule and the reference's."""
    if dataclasses.is_dataclass(a):
        fa = [f.name for f in dataclasses.fields(a)]
        fb = [f.name for f in dataclasses.fields(b)]
        assert fa == fb, (path, fa, fb)
        for name in fa:
            _same(getattr(a, name), getattr(b, name), f'{path}.{name}')
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a, b), path
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f'{path}[{i}]')
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _same(a[k], b[k], f'{path}[{k!r}]')
    else:
        assert a == b or (a != a and b != b), (path, a, b)


def test_findings_equal_the_references():
    port = analysis.check_schedules()
    ref = janalysis.check_schedules()
    assert port.ok and ref.ok, '\n'.join(map(str, port.failures))
    assert sorted((f.rule, f.subject, f.ok) for f in port.findings) == \
        sorted((f.rule, f.subject, f.ok) for f in ref.findings)
    assert {'SCH001', 'SCH002', 'SCH003', 'SCH004', 'SCH005',
            'SCH006'} <= port.rules()


@pytest.mark.parametrize('key', KEYS)
def test_precompute_equals_the_references(key):
    cell = _distinct(launch_checks.iter_cells())[key]
    jcell = _distinct(jaxpr_checks.iter_cells())[key]
    _same(launch_checks.precompute_cell(cell),
          jaxpr_checks.precompute_cell(jcell))


# ---------------------------------------------------------------------------
# Mutations: each rule fires on a corrupted schedule, in both packages
# ---------------------------------------------------------------------------

def _safa_pair(form='dense'):
    """The same SAFA schedule from both packages (fresh envs)."""
    kw = dict(fraction=0.5, lag_tolerance=2, rounds=ROUNDS, form=form)
    return (federation.precompute_safa_schedule(
                fedsim.EnvSpec(seed=3, **ENV).build(), **kw),
            jfed.precompute_safa_schedule(
                jfedsim.EnvSpec(seed=3, **ENV).build(), **kw))


def _failed(sched, **kw):
    return {f.rule for f in analysis.verify_schedule(sched, **kw).failures}


def _ref_failed(sched, **kw):
    return {f.rule for f in janalysis.verify_schedule(sched, **kw).failures}


def test_clean_pair_passes():
    for form in ('dense', 'sparse', 'sparse_tier'):
        port, ref = _safa_pair(form)
        assert not _failed(port, lag_tolerance=2)
        assert not _ref_failed(ref, lag_tolerance=2)


def test_sch001_corrupted_tier_map_fires():
    for sched, failed in zip(_safa_pair('sparse_tier'),
                             (_failed, _ref_failed)):
        t, j = next(
            (t, j) for t in range(ROUNDS) for j in range(sched.width)
            if sched.global_dst[t] != sched.scratch
            and sched.idx[t, j] < sched.m
            and sched.cache_src[t, j] != sched.scratch)
        # the round's global write now also feeds a cache read
        sched.cache_src[t, j] = sched.global_dst[t]
        assert 'SCH001' in failed(sched)


def test_sch002_inflated_capacity_fires():
    for sched, failed in zip(_safa_pair('sparse_tier'),
                             (_failed, _ref_failed)):
        sched = copy.deepcopy(sched)
        old = sched.scratch
        sched.capacity += 1             # claim one dead row
        for arr in (sched.base_src, sched.cache_src, sched.cache_dst):
            arr[arr == old] = sched.scratch
        sched.global_dst[sched.global_dst == old] = sched.scratch
        assert 'SCH002' in failed(sched)


def test_sch003_sentinel_with_a_role_fires():
    for sched, failed in zip(_safa_pair('sparse'), (_failed, _ref_failed)):
        t = next(t for t in range(ROUNDS) if (sched.idx[t] >= sched.m).any())
        sched.roles[t, -1] = protocol.ROLE_PICKED
        assert 'SCH003' in failed(sched)


def test_sch004_lag_above_tau_fires():
    for sched, verify in zip(_safa_pair(), (analysis.verify_schedule,
                                            janalysis.verify_schedule)):
        # never sync, never commit: the versions pin at 0 and the lag grows
        for mask in (sched.sync, sched.committed, sched.picked,
                     sched.undrafted, sched.deprecated):
            mask[:] = False
        rep = verify(sched, lag_tolerance=2)
        assert 'SCH004' in {f.rule for f in rep.failures}
        assert any('staleness' in f.detail for f in rep.failures)


def test_sch004_role_subset_violation_fires():
    for sched, failed in zip(_safa_pair(), (_failed, _ref_failed)):
        t, k = next((t, k) for t in range(ROUNDS) for k in range(ENV['m'])
                    if not sched.committed[t, k])
        sched.picked[t, k] = True       # picked but never committed
        assert 'SCH004' in failed(sched)


def test_sch005_negative_weight_row_fires():
    scheds = (agg_schemes.precompute_weighted_schedule(
                  fedsim.EnvSpec(seed=3, **ENV).build(), rounds=ROUNDS,
                  scheme='seafl'),
              jagg.precompute_weighted_schedule(
                  jfedsim.EnvSpec(seed=3, **ENV).build(), rounds=ROUNDS,
                  scheme='seafl'))
    _same(scheds[0], scheds[1])
    for sched, failed in zip(scheds, (_failed, _ref_failed)):
        t, k = next((t, k) for t in range(ROUNDS) for k in range(ENV['m'])
                    if sched.committed[t, k])
        sched.wrow[t, k] = -0.1
        assert 'SCH005' in failed(sched)


def test_sch005_async_order_not_a_permutation_fires():
    sched = federation.precompute_fedasync_schedule(
        fedsim.EnvSpec(seed=3, **ENV).build(), rounds=ROUNDS)
    assert not _failed(sched)
    sched.order[0, 0] = sched.order[0, 1]
    assert 'SCH005' in _failed(sched)


def test_sch006_unsorted_indices_fire():
    for sched, failed in zip(_safa_pair('sparse'), (_failed, _ref_failed)):
        t = next(t for t in range(ROUNDS)
                 if (sched.idx[t] < sched.m).sum() >= 2)
        sched.idx[t, [0, 1]] = sched.idx[t, [1, 0]]
        assert 'SCH006' in failed(sched)


def test_tier_fleet_capacity_is_the_members_peak():
    cell = next(c for c in launch_checks.iter_cells({'safa'})
                if c.ex.engine == 'fleet' and c.ex.schedule == 'sparse_tier')
    fleet = launch_checks.precompute_cell(cell)
    assert not _failed(fleet)
    fleet = copy.deepcopy(fleet)
    fleet.capacity += 1
    assert 'SCH002' in _failed(fleet)


def test_unsupported_schedule_type_raises():
    with pytest.raises(TypeError, match='unsupported schedule type'):
        analysis.verify_schedule(object())


def test_raise_if_failed_names_every_rule():
    sched, _ = _safa_pair('sparse')
    t = next(t for t in range(ROUNDS) if (sched.idx[t] >= sched.m).any())
    sched.roles[t, -1] = protocol.ROLE_PICKED
    with pytest.raises(analysis.AnalysisError, match='SCH003'):
        analysis.verify_schedule(sched).raise_if_failed()


@pytest.mark.parametrize('form', ['sparse', 'sparse_tier'])
def test_scale_schedule_equals_the_references_and_is_clean(form):
    """The quota-bounded schedule the card's rows and tier kernels are
    held at (``fedsim.scale``, m = 1000) equals the JAX package's
    precompute on the same environment field by field, and the schedule
    pass finds it clean."""
    from repro_torch.fedsim import scale
    spec = scale.scale_spec(0, 1000)
    fields = {f.name: getattr(spec, f.name)
              for f in dataclasses.fields(spec)}
    jenv = jfedsim.EnvSpec(**fields).build()
    port = scale.scale_schedule(2, 0, form, m=1000)
    ref = jfed.precompute_safa_schedule(jenv, fraction=50 / 1000,
                                        lag_tolerance=20, rounds=2,
                                        form=form)
    _same(port, ref)
    assert not _failed(port, lag_tolerance=20)

"""The port's launch pass (``repro_torch.analysis.launch_checks``, rules
T001-T006) on the CPU: the JAX package's 84 admitted cells, its launch
budgets cell for cell, every cell clean, and every rule firing on a
broken registration or segment."""
import dataclasses

import pytest
import torch

from repro.analysis import jaxpr_checks
from repro_torch import api
from repro_torch.analysis import launch_checks
from repro_torch.kernels import safa_aggregate

RULES = ('T001', 'T002', 'T003', 'T004', 'T005', 'T006')
CELLS = launch_checks.iter_cells()
LABELS = [c.label for c in CELLS]


def test_cells_are_the_references():
    assert LABELS == [c.label for c in jaxpr_checks.iter_cells()]
    counts = {}
    for c in CELLS:
        counts[c.pdef.name] = counts.get(c.pdef.name, 0) + 1
    assert counts == {'safa': 40, 'fedavg': 12, 'fedcs': 12, 'seafl': 8,
                      'csafl': 8, 'local': 2, 'fedasync': 2}
    assert (launch_checks.TINY_ENV, launch_checks.ENV_SEED,
            launch_checks.FLEET_SIZE, launch_checks.SEG,
            launch_checks.ROUNDS) == (
        jaxpr_checks.TINY_ENV, jaxpr_checks.ENV_SEED,
        jaxpr_checks.FLEET_SIZE, jaxpr_checks.SEG, jaxpr_checks.ROUNDS)


@pytest.mark.parametrize('label', LABELS)
def test_dispatch_budget_equals_the_references(label):
    cell = CELLS[LABELS.index(label)]
    jcell = jaxpr_checks.iter_cells()[LABELS.index(label)]
    assert jcell.label == label
    assert cell.pdef.dispatch_budget(cell.ex) == \
        jcell.pdef.dispatch_budget(jcell.ex)


@pytest.fixture(scope='module')
def report():
    return launch_checks.check_cells(device='cpu')


@pytest.mark.parametrize('rule', RULES)
def test_every_cell_is_clean_on_the_cpu(report, rule):
    found = report.by_rule(rule)
    assert len(found) == len(CELLS)
    assert {f.subject for f in found} == set(LABELS)
    bad = [f for f in found if not f.ok]
    assert not bad, '\n'.join(map(str, bad))


def test_budgets_are_measured(report):
    """Every budgeted cell's T001 reads its measured count."""
    for f in report.by_rule('T001'):
        cell = CELLS[LABELS.index(f.subject)]
        budget = cell.pdef.dispatch_budget(cell.ex)
        if budget is None:
            assert 'no budget declared' in f.detail
        else:
            assert f'{budget:g} kernel calls/round' in f.detail


# ---------------------------------------------------------------------------
# Mutations: each rule fires
# ---------------------------------------------------------------------------

def _cell(proto=api.SafaSpec, segment=None, **exec_kw):
    pdef = api.PROTOCOLS[proto]
    if segment is not None:
        pdef = dataclasses.replace(pdef, segment=segment(pdef.segment))
    kw = dict(engine='scan', schedule='dense', wire='f32', use_kernel=False,
              eval_every=launch_checks.SEG)
    kw.update(exec_kw)
    return launch_checks.Cell(pdef, proto(), api.ExecSpec(**kw))


def _failures(cell, rule):
    rep = launch_checks.check_cells(cells=[cell], device='cpu')
    return [f for f in rep.failures if f.rule == rule]


def test_clean_cell_passes():
    rep = launch_checks.check_cells(
        cells=[_cell(wire='int8', use_kernel='packed')], device='cpu')
    assert rep.ok and rep.rules() == set(RULES)


def test_t001_wrong_budget_fires():
    cell = _cell(wire='int8', use_kernel='packed')
    cell = dataclasses.replace(cell, pdef=dataclasses.replace(
        cell.pdef, dispatch_budget=lambda ex: 99))
    bad = _failures(cell, 'T001')
    assert bad and 'budget 99' in bad[0].detail


def test_t002_cloned_in_place_state_fires():
    def cloning(segment):
        def seg(st, *a):
            segment(st, *a)
            st.packed = tuple(t.clone() for t in st.packed)
        return seg
    cell = _cell(segment=cloning, schedule='sparse_tier',
                 use_kernel='packed')
    bad = _failures(cell, 'T002')
    assert bad and 'packed/1' in bad[0].detail


def test_t003_unlisted_in_place_write_fires(monkeypatch):
    monkeypatch.setitem(safa_aggregate.ALIAS_CONTRACTS,
                        'safa_aggregate_packed', ((),))
    bad = _failures(_cell(use_kernel='packed'), 'T003')
    assert bad and "wrote ['cache'] in place" in bad[0].detail


def test_t003_missing_claim_fires():
    cell = _cell(use_kernel='packed')
    cell = dataclasses.replace(cell, pdef=dataclasses.replace(
        cell.pdef, alias_claims=lambda ex: {'scatter_rows': ('buf',)}))
    bad = _failures(cell, 'T003')
    assert bad and 'never called' in bad[0].detail


def test_t004_f64_promotion_fires():
    def promoting(segment):
        def seg(st, *a):
            segment(st, *a)
            st.global_w = {k: v.double().float()
                           for k, v in st.global_w.items()}
        return seg
    bad = _failures(_cell(segment=promoting), 'T004')
    assert bad and 'float64' in bad[0].detail


def test_t005_item_in_a_round_fires():
    def syncing(segment):
        def seg(st, seg_, weights, train_fn, ex, ctx):
            def train(*a, **k):
                float(weights.sum())        # .item() every round
                return train_fn(*a, **k)
            segment(st, seg_, weights, train, ex, ctx)
        return seg
    bad = _failures(_cell(segment=syncing), 'T005')
    assert bad and '_local_scalar_dense' in bad[0].detail


def test_t006_second_segment_that_differs_fires():
    calls = []

    def drifting(segment):
        def seg(st, seg_, weights, *a):
            calls.append(1)
            if len(calls) == 2:
                weights = weights + 0.0     # one extra op
            segment(st, seg_, weights, *a)
        return seg
    bad = _failures(_cell(segment=drifting), 'T006')
    assert bad and 'differ at op 0' in bad[0].detail


def test_run_cell_watches_both_segments():
    run = launch_checks.run_cell(_cell(engine='fleet', wire='int8',
                                       use_kernel='packed'), 'cpu')
    assert [s.rounds for s in run.segments] == [2, 2]
    assert [[c.wrapper for c in s.calls] for s in run.segments] == \
        [['quantize_packed_fleet', 'safa_aggregate_packed_q8_fleet'] * 2] * 2
    assert all(c.returned == {'cache'} for s in run.segments
               for c in s.calls if c.wrapper.startswith('safa'))
    assert run.device == torch.device('cpu')


def _carries_in_place(cell) -> bool:
    ex = cell.ex
    return cell.pdef.name == 'safa' and (
        ex.schedule == 'sparse_tier'
        or (ex.schedule == 'sparse_delta' and ex.use_kernel == 'packed'))


def test_vacuous_findings_are_not_applicable(report):
    """T002 is not applicable exactly on the cells whose state names no
    in-place buffer, T003 exactly on those with no claim and no kernel
    call; such a finding counts apart from the passes."""
    na = {rule: {f.subject for f in report.by_rule(rule)
                 if not f.applicable} for rule in RULES}
    assert na['T002'] == {c.label for c in CELLS if not _carries_in_place(c)}
    assert na['T003'] == {
        c.label for c in CELLS
        if not c.pdef.alias_claims or not c.pdef.alias_claims(c.ex)
        if c.pdef.dispatch_budget(c.ex) == 0}
    assert not na['T001'] and not na['T004'] and not na['T006']
    for rule in ('T002', 'T003'):
        ok, n_na, failed = report.counts(rule)
        assert (ok, n_na, failed) == (len(CELLS) - len(na[rule]),
                                      len(na[rule]), 0)
    assert str(next(f for f in report.by_rule('T002')
                    if not f.applicable)).startswith('n/a  T002')


@pytest.mark.skipif(torch.cuda.is_available(), reason='a card is present')
def test_run_cell_runs_on_the_card_by_default():
    with pytest.raises(RuntimeError, match="device='cuda' requested"):
        launch_checks.run_cell(_cell())

"""The port's conventions pass (``repro_torch.analysis.conventions``:
REP002, REP003, REP005, REP006) and the ``python -m
repro_torch.analysis`` command: clean on the tree, every rule firing on
a small seeded tree, the command's exit codes, and the JAX package's own
conventions pass still clean with the port's files present."""
import dataclasses
import json
import textwrap

import pytest
import torch

from repro.analysis.conventions import check_conventions as ref_conventions
from repro_torch import analysis, api
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis.conventions import (check_conventions,
                                              kernel_wrappers)
from repro_torch.kernels import backend

BACKEND = '''
LAUNCHES = {'copy_rows': 0}
_SIGNATURES = {'copy_rows_f32': (1, 2)}
'''
KERNEL = '''
from repro_torch.kernels import backend

ALIAS_CONTRACTS = {'copy_rows': ((),)}


def _copy(key, x):
    backend.call('copy_rows_f32', x.device)
    backend.LAUNCHES[key] += 1
    return x


def copy_rows(x):
    return _copy('copy_rows', x)
'''
CU = '''
__global__ void copy_rows_kernel(float* x) {}

extern "C" {

int copy_rows_f32(float* x, void* stream) {
  copy_rows_kernel<<<1, 1>>>(x);
  return 0;
}

}  // extern "C"
'''


def fixture_root(tmp_path, files=None):
    """A small tree the pass can walk: one clean kernel module, its
    backend rows and its C entry, plus the seeded ``files``."""
    base = {
        'src/repro_torch/core/protocol.py': '',
        'src/repro_torch/kernels/backend.py': BACKEND,
        'src/repro_torch/kernels/copy.py': KERNEL,
        'src/repro_torch/csrc/copy.cu': CU,
        'tests/test_torch_ok.py': '',
    }
    base.update(files or {})
    for rel, text in base.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return tmp_path


def failed(root, rule):
    return [f for f in check_conventions(root).failures if f.rule == rule]


def test_the_tree_is_clean():
    rep = check_conventions()
    assert rep.ok, '\n'.join(map(str, rep.failures))
    assert rep.rules() == {'REP002', 'REP003', 'REP005', 'REP006'}


def test_the_references_pass_is_clean_with_the_ports_files():
    rep = ref_conventions()
    assert rep.ok, '\n'.join(map(str, rep.failures))


def test_fixture_tree_is_clean(tmp_path):
    rep = check_conventions(fixture_root(tmp_path))
    assert rep.ok, '\n'.join(map(str, rep.failures))


def test_wrappers_are_the_launch_counters():
    wrappers = kernel_wrappers()
    assert {key for _, key in wrappers.values()} == set(backend.LAUNCHES)
    assert wrappers['quantize_rows'] == ('repro_torch.kernels.comm_quant',
                                         'quantize')
    assert wrappers['safa_aggregate_packed_q8_tier_rows'][1] == \
        'safa_aggregate_packed_q8_tier_rows'


def test_rep002_np_random_and_float64_fire(tmp_path):
    root = fixture_root(tmp_path, {
        'src/repro_torch/core/protocol.py': '''
            import numpy as np
            noise = np.random.rand(3)
        ''',
        'src/repro_torch/kernels/bad.py': '''
            import torch
            ACC = torch.float64
        ''',
    })
    bad = failed(root, 'REP002')
    assert any('np.random' in f.detail for f in bad)
    assert any('float64' in f.detail for f in bad)


def test_rep003_unfrozen_spec_fires(tmp_path):
    @dataclasses.dataclass          # not frozen
    class MeltedSpec:
        fraction: float = 0.5

    pdef = dataclasses.replace(api.PROTOCOLS[api.SafaSpec], name='melted',
                               spec_cls=MeltedSpec)
    api.register(pdef)
    try:
        rep = check_conventions(fixture_root(tmp_path))
        assert any(f.rule == 'REP003' and f.subject == 'MeltedSpec'
                   for f in rep.failures)
    finally:
        from repro_torch.core import api as core_api
        del core_api.PROTOCOLS[MeltedSpec]
        del core_api._BY_NAME['melted']


def test_rep005_c_entry_without_signature_fires(tmp_path):
    root = fixture_root(tmp_path, {'src/repro_torch/csrc/extra.cu': '''
        extern "C" {
        int rogue_f32(float* x, void* stream) { return 0; }
        }  // extern "C"
    '''})
    bad = failed(root, 'REP005')
    assert any('rogue_f32' in f.detail and '_SIGNATURES' in f.detail
               for f in bad)


def test_rep005_signature_without_c_entry_fires(tmp_path):
    root = fixture_root(tmp_path, {
        'src/repro_torch/kernels/backend.py': BACKEND.replace(
            "(1, 2)}", "(1, 2), 'ghost_f32': (1,)}")})
    bad = failed(root, 'REP005')
    assert any("'ghost_f32' names no extern" in f.detail for f in bad)


def test_rep005_key_bumped_by_two_wrappers_fires(tmp_path):
    root = fixture_root(tmp_path, {
        'src/repro_torch/kernels/copy.py': KERNEL + '''

def copy_more(x):
    return _copy('copy_rows', x)
'''})
    bad = failed(root, 'REP005')
    assert any("bumped by ['copy_more', 'copy_rows']" in f.detail
               for f in bad)


def test_rep005_row_loop_may_share_its_wrappers_key(tmp_path):
    root = fixture_root(tmp_path, {
        'src/repro_torch/kernels/copy.py': KERNEL.replace(
            "'copy_rows': ((),)}", "'copy_rows': ((),), "
            "'copy_rows_rows': ((),)}") + '''

def copy_rows_rows(x):
    backend.LAUNCHES['copy_rows'] += x.shape[0]
    return x
'''})
    assert not failed(root, 'REP005')


def test_rep005_undeclared_and_unbumped_keys_fire(tmp_path):
    root = fixture_root(tmp_path, {
        'src/repro_torch/kernels/backend.py': BACKEND.replace(
            "{'copy_rows': 0}", "{'copy_rows': 0, 'idle': 0}"),
        'src/repro_torch/kernels/copy.py': KERNEL.replace(
            "return _copy('copy_rows', x)", "return _copy('copy_row', x)"),
    })
    details = [f.detail for f in failed(root, 'REP005')]
    assert any("LAUNCHES['copy_row']" in d for d in details)
    assert any("no wrapper" in d for d in details)


def test_rep005_wrapper_missing_from_inventory_fires(tmp_path):
    root = fixture_root(tmp_path, {
        'src/repro_torch/kernels/copy.py': KERNEL.replace(
            "ALIAS_CONTRACTS = {'copy_rows': ((),)}",
            "ALIAS_CONTRACTS = {'copy_cols': ((),)}")})
    details = [f.detail for f in failed(root, 'REP005')]
    assert any("wrappers ['copy_rows'] missing" in d for d in details)
    assert any("names ['copy_cols']" in d for d in details)


def test_rep006_reused_built_env_fires(tmp_path):
    root = fixture_root(tmp_path, {
        'tests/test_torch_reuse.py': '''
            from repro_torch import api, fedsim

            def sweep_twice(runner):
                env = fedsim.EnvSpec(m=5).build()
                a = runner.run_sweep([api.SweepMember(env=env)])
                b = runner.run_sweep([api.SweepMember(env=env)])
                return a, b
        ''',
    })
    bad = failed(root, 'REP006')
    assert bad and 'single-shot' in bad[0].detail


# ---------------------------------------------------------------------------
# The command
# ---------------------------------------------------------------------------

def test_command_exits_0_when_clean(tmp_path, capsys):
    out = tmp_path / 'ANALYSIS.json'
    assert cli.main(['--protocol', 'local', '--device', 'cpu',
                     '--json', str(out)]) == 0
    text = capsys.readouterr().out
    assert 'T001: 2 ok, 0 not applicable, 0 failed' in text
    assert 'T002: 0 ok, 2 not applicable, 0 failed' in text
    assert 'PASS' in text
    data = json.loads(out.read_text())
    assert data['ok'] and {'T006', 'SCH004', 'REP005'} <= set(data['rules'])
    assert data['not_applicable'] >= 2


def test_command_exits_1_on_a_failed_finding(monkeypatch, capsys):
    pdef = api.PROTOCOLS[api.LocalSpec]
    monkeypatch.setitem(api.PROTOCOLS, api.LocalSpec, dataclasses.replace(
        pdef, dispatch_budget=lambda ex: 7))
    assert cli.main(['--protocol', 'local', '--device', 'cpu']) == 1
    assert 'FAIL T001 local[scan/dense/f32/kernel=False]' in \
        capsys.readouterr().out


def test_command_refuses_an_unknown_protocol():
    with pytest.raises(SystemExit) as e:
        cli.main(['--protocol', 'nope', '--device', 'cpu'])
    assert e.value.code == 2


@pytest.mark.skipif(torch.cuda.is_available(), reason='a card is present')
def test_command_runs_on_the_card_by_default():
    with pytest.raises(RuntimeError, match="device='cuda' requested"):
        cli.main(['--all'])
    with pytest.raises(RuntimeError, match="device='cuda' requested"):
        analysis.run_all()

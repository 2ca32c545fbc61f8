"""The port's dry run on the CPU: its analytic FLOPs and HBM bytes, active
and total parameters and model FLOPs against the JAX package's for all
33 (architecture, input shape) cells on both production meshes; the
roofline at H100 constants with no collective term; ``lower_one``
tracing every cell of every reduced configuration, and qwen3-1.7b's
three shapes at full size, on the ``meta`` device; the memory sizes
``PERF.md`` works from; the CLI.
"""
import dataclasses
import json
import os

import pytest

from repro import configs as jcfgs
from repro.launch import analytic as j_analytic
from repro.launch import mesh as j_mesh
from repro.launch import roofline as j_rf
from repro.models.model import build_model as j_build_model
from repro_torch import configs as tcfgs
from repro_torch.configs import INPUT_SHAPES, InputShape
from repro_torch.launch import analytic, dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline as rf
from repro_torch.models.model import build_model

# the reference's dryrun module sets XLA_FLAGS (512 host devices) when it
# is imported; keep that from the other tests of this process
_xla_flags = os.environ.get('XLA_FLAGS')
from repro.launch import dryrun as j_dryrun  # noqa: E402

if _xla_flags is None:
    os.environ.pop('XLA_FLAGS', None)
else:
    os.environ['XLA_FLAGS'] = _xla_flags

CELLS = [(a, s) for a in jcfgs.ARCH_IDS for s in jcfgs.INPUT_SHAPES
         if jcfgs.shape_supported(a, s)]
GiB = 2 ** 30


def test_cells_are_the_reference():
    assert len(CELLS) == 33
    assert [(a, s) for a in tcfgs.ARCH_IDS for s in INPUT_SHAPES
            if tcfgs.shape_supported(a, s)] == CELLS


@pytest.mark.parametrize('arch', jcfgs.ARCH_IDS)
def test_analytic_terms_match_reference(arch):
    """For every shape of ``arch`` on both production meshes: flops,
    HBM bytes (the mesh's client count), n_params, active params and
    model FLOPs equal the reference's."""
    jc, tc = jcfgs.get_config(arch), tcfgs.get_config(arch)
    jm, tm = j_build_model(jc), build_model(tc)
    assert tm.n_params() == jm.n_params()
    n_act = dryrun.active_params(tc, tm)
    assert n_act == j_dryrun.active_params(jc, jm)
    for name, shape in INPUT_SHAPES.items():
        if not tcfgs.shape_supported(arch, name):
            continue
        for multi_pod, sizes, names in ((False, (16, 16), ('data', 'model')),
                                        (True, (2, 16, 16),
                                         ('pod', 'data', 'model'))):
            n_cl = (j_mesh.n_clients(_abstract(sizes, names))
                    if shape.kind == 'train' else 1)
            assert n_cl == (mesh_lib.n_clients(mesh_lib.make_production_mesh(
                multi_pod=multi_pod)) if shape.kind == 'train' else 1)
            kw = dict(kind=shape.kind, batch=shape.global_batch,
                      seq=shape.seq_len)
            assert analytic.flops_estimate(tc, n_active=n_act, **kw) == \
                j_analytic.flops_estimate(jc, n_active=n_act, **kw)
            assert analytic.bytes_estimate(
                tc, n_params=tm.n_params(), n_clients=n_cl, **kw) == \
                j_analytic.bytes_estimate(jc, n_params=jm.n_params(),
                                          n_clients=n_cl, **kw)
            tokens = shape.global_batch * (shape.seq_len if shape.kind !=
                                           'decode' else 1)
            assert rf.model_flops_estimate(n_act, tokens, shape.kind) == \
                j_rf.model_flops_estimate(n_act, tokens, shape.kind)


def _abstract(sizes, names):
    from jax.sharding import AbstractMesh
    return AbstractMesh(sizes, names)


def test_roofline_is_the_h100s_with_no_collective_term():
    assert (rf.PEAK_FLOPS_BF16, rf.HBM_BW, rf.HBM_BYTES) == \
        (989e12, 3.35e12, 80e9)
    r = rf.Roofline(flops=989e12 * 4, hbm_bytes=3.35e12 * 2, chips=2,
                    model_flops=989e12)
    d = r.as_dict()
    assert set(d) == set(j_rf.Roofline(1.0, 1.0, 1.0, 1).as_dict())
    assert (d['t_compute_s'], d['t_memory_s']) == (2.0, 1.0)
    assert d['coll_bytes'] is None and d['t_collective_s'] is None
    assert d['bottleneck'] == 'compute' and d['useful_ratio'] == 0.25
    assert rf.Roofline(1.0, 3.35e12, chips=1).bottleneck == 'memory'


def _reduced(arch):
    return dataclasses.asdict(tcfgs.get_config(arch).reduced())


def _small(shape):
    """A cell's shape cut for a reduced configuration: 32 tokens, and a
    batch of two sequences a client on the production mesh (C = 16 or
    32)."""
    return InputShape(shape.name, 32, 64 if shape.kind == 'train' else 2,
                      shape.kind)


@pytest.mark.parametrize('multi_pod', [False, True])
def test_every_reduced_cell_traces_on_meta(multi_pod):
    """``lower_one`` traces each of the 33 cells' steps for the reduced
    configuration on ``meta``, its row's terms the reference's analytic
    ones for that configuration and shape."""
    for arch, name in CELLS:
        shape = _small(INPUT_SHAPES[name])
        extra = _reduced(arch)
        row = dryrun.lower_one(arch, shape, multi_pod=multi_pod,
                               extra_cfg=extra)
        jc = jcfgs.get_config(arch).reduced()
        jm = j_build_model(jc)
        n_act = j_dryrun.active_params(jc, jm)
        chips = 512 if multi_pod else 256
        n_cl = (32 if multi_pod else 16) if shape.kind == 'train' else 1
        kw = dict(kind=shape.kind, batch=shape.global_batch,
                  seq=shape.seq_len)
        assert row['n_params'] == jm.n_params()
        assert row['active_params'] == n_act
        assert row['flops'] == j_analytic.flops_estimate(jc, n_active=n_act,
                                                         **kw)
        assert row['hbm_bytes'] == j_analytic.bytes_estimate(
            jc, n_params=jm.n_params(), n_clients=n_cl, **kw)
        assert row['chips'] == chips and row['mesh'] == (
            'pod=2xdata=16xmodel=16' if multi_pod else 'data=16xmodel=16')
        assert row['t_compute_s'] == row['flops'] / (chips * 989e12)
        assert row['arg_bytes'] <= row['whole_arg_bytes']
        assert row['fits_one_card'] == (row['whole_arg_bytes'] <= 80e9)


@pytest.mark.parametrize('name', ['train_4k', 'prefill_32k', 'decode_32k'])
def test_qwen3_full_size_cells_trace_on_meta(name):
    """qwen3-1.7b at full width and depth: the step traces on ``meta`` at
    the published shape; the row's bytes are the trees' (bf16 params,
    f32 norms), its specs cut the arguments on 256 chips."""
    row = dryrun.lower_one('qwen3-1.7b', name)
    assert row['n_params'] == 2_032_264_192
    assert row['param_bytes'] == 4_064_776_192
    assert row['trace_s'] > 0 and row['chips'] == 256
    assert 0 < row['arg_bytes'] < row['whole_arg_bytes']
    if name == 'train_4k':
        assert row['state_bytes'] == 33 * row['param_bytes']
        assert not row['fits_one_card']
    if name == 'prefill_32k':
        assert row['fits_one_card'] and row['bottleneck'] == 'compute'
    if name == 'decode_32k':
        # k and v [28, 128, 32768, 8, 128] bf16, positions [32768] int32
        assert row['cache_bytes'] == 28 * 2 * 128 * 32768 * 8 * 128 * 2 \
            + 32768 * 4
        assert row['bottleneck'] == 'memory'


def test_memory_sizes_of_the_card_runs():
    """The sizes PERF.md section 4 gives: llama4-scout's bf16 params 200.7
    GiB at 48 layers and 36.7 GiB at 8, llama4-maverick's 740.8 GiB,
    qwen3-1.7b's silo state at C = 4 (9 copies) 34.07 GiB."""
    def gib(row, key):
        return round(row[key] / GiB, 2)
    dec = 'decode_32k'
    assert gib(dryrun.lower_one('llama4-scout-17b-a16e', dec),
               'param_bytes') == 200.75
    assert gib(dryrun.lower_one('llama4-scout-17b-a16e', dec,
                                extra_cfg={'n_layers': 8}),
               'param_bytes') == 36.67
    assert gib(dryrun.lower_one('llama4-maverick-400b-a17b', dec),
               'param_bytes') == 740.79
    one = mesh_lib.Mesh((1, 1), ('data', 'model'))
    row = dryrun.lower_one('qwen3-1.7b', InputShape('round', 64, 16, 'train'),
                           mesh=one, n_clients=4, local_steps=2)
    assert gib(row, 'state_bytes') == 34.07
    assert row['state_bytes'] == 9 * row['param_bytes']
    assert row['arg_bytes'] == row['whole_arg_bytes'] and row['chips'] == 1


def test_cli(tmp_path, capsys, monkeypatch):
    """One cell through ``main``: a JSON row on stdout and in ``--out``;
    ``--skip-existing`` skips it; a cell that raises prints FAIL to
    stderr and exits 1."""
    out = tmp_path / 'rows.jsonl'
    argv = ['--arch', 'mamba2-130m', '--shape', 'long_500k', '--out',
            str(out)]
    dryrun.main(argv)
    row = json.loads(capsys.readouterr().out.strip())
    assert row['arch'] == 'mamba2-130m' and row['kind'] == 'decode'
    assert row['mesh'] == 'data=16xmodel=16' and row['step'] == 'serve'
    assert json.loads(out.read_text()) == row
    dryrun.main(argv + ['--skip-existing'])
    assert capsys.readouterr().out == ''

    def broken(*a, **k):
        raise RuntimeError('no trace')
    monkeypatch.setattr(dryrun, 'lower_one', broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(['--arch', 'mamba2-130m', '--shape', 'decode_32k'])
    assert e.value.code == 1
    assert 'FAIL mamba2-130m decode_32k' in capsys.readouterr().err

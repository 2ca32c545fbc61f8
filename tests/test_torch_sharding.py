"""The port's sharding specs against the JAX package on the CPU: the rules
and profiles, ``spec_for`` on the reference's own cases
(``tests/test_substrate.py``), every leaf of every configuration at full
size (params, the silo state at C = 16, the decode cache, the train and
prefill batches) under every profile on 1x1, 16x16 and 2x16x16 meshes
(the reference's on ``jax.sharding.AbstractMesh``), the step setups'
sharding methods, the meshes, and the FSDP profile's silo rounds: bit for
bit the port's unsharded rounds, and within ``STATE_ATOL`` of the
reference's step jitted with its shardings on the local mesh.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JP

from repro import configs as jcfgs
from repro import sharding as jshd
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.models.model import build_model as j_build_model
from repro_torch import configs as tcfgs
from repro_torch import sharding as shd
from repro_torch.configs import INPUT_SHAPES, InputShape
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models.model import build_model
from repro_torch.optim import tree_leaves
from test_torch_train import STATE_ATOL, _close, _round_batches, _silo_pair

#: (sizes, axis names) of the meshes the specs are held on
MESHES = (((1, 1), ('data', 'model')), ((16, 16), ('data', 'model')),
          ((2, 16, 16), ('pod', 'data', 'model')))
#: every rule set: the sharding profiles and the serving profiles
RULES = {**{f'shd.{k}': v for k, v in shd.PROFILES.items()},
         **{f'serve.{k}': v for k, v in steps.SERVE_PROFILES.items()}}
J_RULES = {**{f'shd.{k}': v for k, v in jshd.PROFILES.items()},
           **{f'serve.{k}': v for k, v in jsteps.SERVE_PROFILES.items()}}
C = 16


def _j_specs(tree):
    """A reference tree of specs or shardings, as spec tuples in its
    (sorted-key) leaf order."""
    return [tuple(getattr(p, 'spec', p)) for p in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, (JP, jax.sharding.Sharding)))]


def _t_specs(tree):
    return [tuple(p) for p in tree_leaves(tree)]


def test_rules_and_profiles_are_the_reference():
    assert shd.DEFAULT_RULES == jshd.DEFAULT_RULES
    assert shd.FSDP_RULES == jshd.FSDP_RULES
    assert shd.FSDP_MULTIPOD_RULES == jshd.FSDP_MULTIPOD_RULES
    assert RULES == J_RULES
    assert shd.PROFILES['fsdp'] is shd.FSDP_RULES
    assert steps.SERVE_RULES == jsteps.SERVE_RULES
    assert steps.SERVE_SPLITKV_RULES == jsteps.SERVE_SPLITKV_RULES


# -- tests/test_substrate.py's four cases, on the port's 1x1 mesh -------------

def _mesh11():
    return mesh_lib.Mesh((1, 1), ('data', 'model'))


def test_spec_drops_nondivisible():
    assert shd.spec_for(('vocab', 'embed'), (256, 64), _mesh11()) == \
        shd.PartitionSpec('model')
    assert shd.spec_for((None, 'mlp'), (4, 63), _mesh11()) == \
        shd.PartitionSpec(None, 'model')


def test_missing_axis_dropped():
    assert shd.spec_for(('clients', None), (8, 3), _mesh11()) == \
        shd.PartitionSpec('data')


def test_no_axis_reuse():
    assert shd.spec_for(('mlp', 'vocab'), (16, 256), _mesh11()) == \
        shd.PartitionSpec('model')


def test_constrain_noop_without_mesh():
    x = torch.ones(4, 4)
    assert shd.constrain(x, None, 'batch', None) is x
    assert shd.constrain(x, _mesh11(), 'batch', None) is x
    with shd.activation_sharding(_mesh11(), shd.FSDP_RULES):
        assert shd.constrain_act(x, 'local_batch', None) is x
        assert shd._ACT_CTX == (_mesh11(), shd.FSDP_RULES)
    assert shd._ACT_CTX is None


@pytest.mark.parametrize('sizes,names', MESHES)
@pytest.mark.parametrize('rules', sorted(RULES))
def test_spec_for_matches_reference_on_shrinking_cases(sizes, names, rules):
    """Candidate axes shrink until they divide (2x16 = 32, 16, 2, 1 and
    odd sizes), an axis is never reused, absent axes drop, unknown and
    ``None`` names replicate, trailing ``None``s are trimmed."""
    amesh = AbstractMesh(sizes, names)
    mesh = mesh_lib.Mesh(sizes, names)
    names_ = sorted(set(RULES[rules]) | {'kv_seq', 'unknown'})
    rng = np.random.default_rng(len(names_))
    for dims in (1, 2, 3, 4):
        for _ in range(60):
            axes = tuple(rng.choice(names_ + [None], size=dims).tolist())
            shape = tuple(int(d) for d in rng.choice(
                [1, 2, 3, 8, 16, 31, 32, 48, 64, 96, 512], size=dims))
            want = jshd.spec_for(axes, shape, amesh, J_RULES[rules])
            got = shd.spec_for(axes, shape, mesh, RULES[rules])
            assert tuple(got) == tuple(want), (axes, shape)


# -- every leaf of every configuration at full size ------------------------------

def _trees(arch):
    """{name: (reference axes, reference shapes, port axes, port tensors)}
    for the params, the silo state at C = 16, the decode_32k cache and
    tokens, the train_4k and prefill_32k batches."""
    jm = j_build_model(jcfgs.get_config(arch))
    tm = build_model(tcfgs.get_config(arch))
    js, ts = jsteps.SiloSetup(jm, n_clients=C), steps.SiloSetup(tm,
                                                                n_clients=C)
    jv, tv = jsteps.ServeSetup(jm), steps.ServeSetup(tm)
    jc, jt = jv.decode_batch(jcfgs.INPUT_SHAPES['decode_32k'])
    tc, tt = tv.decode_batch(INPUT_SHAPES['decode_32k'])
    return {
        'params': (jm.param_axes(), jm.param_shapes(), tm.param_axes(),
                   tm.param_shapes()),
        'state': (js.state_axes(), js.state_sds(), ts.state_axes(),
                  ts.state_sds()),
        'cache': (jsteps.cache_axes(jm.cfg), jc,
                  steps.cache_axes(tm.cfg), tc),
        'decode_tokens': (('batch', None), jt, ('batch', None), tt),
        'train_batch': (jsteps.batch_axes_train(jm.cfg),
                        js.client_batch(jcfgs.INPUT_SHAPES['train_4k']),
                        steps.batch_axes_train(tm.cfg),
                        ts.client_batch(INPUT_SHAPES['train_4k'])),
        'prefill_batch': (
            jv.prefill_axes(),
            jv.prefill_batch(jcfgs.INPUT_SHAPES['prefill_32k']),
            tv.prefill_axes(),
            tv.prefill_batch(INPUT_SHAPES['prefill_32k'])),
    }


def _shapes_agree(j_sds, t_tree):
    if isinstance(t_tree, dict):
        assert sorted(t_tree) == sorted(j_sds)
        for k in t_tree:
            _shapes_agree(j_sds[k], t_tree[k])
    else:
        assert shd.shape_of(t_tree) == tuple(j_sds.shape)


@pytest.mark.parametrize('arch', jcfgs.ARCH_IDS)
def test_every_leaf_spec_matches_reference(arch):
    """The axes trees equal the reference's (``Model.param_axes`` leaf for
    leaf), the shapes too, and every leaf's spec equals the reference's
    ``tree_specs`` on 1x1, 16x16 and 2x16x16 under every profile."""
    trees = _trees(arch)
    for name, (j_ax, j_sds, t_ax, t_tree) in trees.items():
        assert t_ax == j_ax, name
        _shapes_agree(j_sds, t_tree)
        for sizes, names in MESHES:
            amesh = AbstractMesh(sizes, names)
            mesh = mesh_lib.Mesh(sizes, names)
            for rules in RULES:
                if name == 'decode_tokens':
                    want = [tuple(jshd.spec_for(j_ax, j_sds.shape, amesh,
                                                J_RULES[rules]))]
                    got = [tuple(shd.spec_for(t_ax, t_tree.shape, mesh,
                                              RULES[rules]))]
                else:
                    want = _j_specs(jshd.tree_specs(j_ax, j_sds, amesh,
                                                    J_RULES[rules]))
                    got = _t_specs(shd.tree_specs(t_ax, t_tree, mesh,
                                                  RULES[rules]))
                assert got == want, (name, sizes, rules)


@pytest.mark.parametrize('arch', jcfgs.ARCH_IDS)
def test_step_shardings_match_reference(arch):
    """``SiloSetup.shardings`` (FSDP on two pods), ``ServeSetup``'s
    ``param_shardings`` (the DEFAULT rules even with ``serve_rules``),
    ``prefill_shardings`` and ``decode_shardings`` (split-KV) give the
    reference's specs, each sharding on its mesh."""
    sizes, names = MESHES[2]
    amesh, mesh = AbstractMesh(sizes, names), mesh_lib.Mesh(sizes, names)
    jm = j_build_model(jcfgs.get_config(arch))
    tm = build_model(tcfgs.get_config(arch))
    rules = shd.FSDP_MULTIPOD_RULES
    shape = INPUT_SHAPES['train_4k']
    want = jsteps.SiloSetup(jm, n_clients=C, rules=jshd.FSDP_MULTIPOD_RULES
                            ).shardings(amesh, shape)
    got = steps.SiloSetup(tm, n_clients=C, rules=rules).shardings(mesh,
                                                                  shape)
    for w, g in zip(want, got):
        assert _t_specs(tree_map_spec(g)) == _j_specs(w)
        assert all(s.mesh is mesh for s in _leaves_of(g))
    jv = jsteps.ServeSetup(jm, serve_rules=jsteps.SERVE_SPLITKV_RULES)
    tv = steps.ServeSetup(tm, serve_rules=steps.SERVE_SPLITKV_RULES)
    assert _t_specs(tree_map_spec(tv.param_shardings(mesh))) == \
        _j_specs(jv.param_shardings(amesh))
    assert _t_specs(tree_map_spec(tv.param_shardings(mesh))) == \
        _t_specs(shd.tree_specs(tm.param_axes(), tm.param_shapes(), mesh))
    pre = INPUT_SHAPES['prefill_32k']
    assert _t_specs(tree_map_spec(tv.prefill_shardings(mesh, pre))) == \
        _j_specs(jv.prefill_shardings(amesh, pre))
    dec = INPUT_SHAPES['decode_32k']
    (jc, jt), (tc, tt) = (jv.decode_shardings(amesh, dec),
                          tv.decode_shardings(mesh, dec))
    assert _t_specs(tree_map_spec(tc)) == _j_specs(jc)
    assert tuple(tt.spec) == tuple(jt.spec)


def _leaves_of(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves_of(v)]
    return [tree]


def tree_map_spec(tree):
    if isinstance(tree, dict):
        return {k: tree_map_spec(v) for k, v in tree.items()}
    return tree.spec


# -- meshes -------------------------------------------------------------------

def test_meshes_match_reference():
    for multi_pod, (sizes, names) in ((False, MESHES[1]), (True, MESHES[2])):
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
        amesh = AbstractMesh(sizes, names)
        assert mesh.axis_names == amesh.axis_names
        assert mesh.shape == dict(amesh.shape)
        assert mesh.size == amesh.size
        assert mesh_lib.describe(mesh) == jmesh.describe(amesh)
        for axes in (('pod', 'data'), ('data',), ('model',)):
            assert mesh_lib.n_clients(mesh, axes) == \
                jmesh.n_clients(amesh, axes)
    local = mesh_lib.make_local_mesh(device='cpu')
    assert local == mesh_lib.Mesh((1, 1), ('data', 'model'))
    assert mesh_lib.describe(local) == 'data=1xmodel=1'
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='torch.cuda.is_available'):
            mesh_lib.make_local_mesh()


# -- the FSDP profile's silo rounds ----------------------------------------------

def test_fsdp_silo_rounds_match_unsharded_and_reference(monkeypatch):
    """Three rounds of reduced qwen3-1.7b under ``FSDP_RULES`` (the mesh
    set by ``shardings``): the port's bit for bit its ``rules=None``
    rounds, and within ``STATE_ATOL`` of the reference's step jitted with
    ``in_shardings=setup.shardings(mesh, shape)`` on ``make_local_mesh()``'s
    mesh (with Auto axes).  The layer bodies run inside the profile's
    activation context."""
    jc, jsetup, jstate, plain, pstate = _silo_pair('qwen3-1.7b')
    jsetup.rules = jshd.FSDP_RULES
    shape = InputShape('round', 16, 4 * 2, 'train')
    local = jmesh.make_local_mesh()
    # the same mesh with Auto axes: this jax's make_mesh makes Explicit
    # ones, which the reference's with_sharding_constraint refuses
    jm = jax.make_mesh(local.axis_sizes, local.axis_names,
                       axis_types=(jax.sharding.AxisType.Auto,)
                       * len(local.axis_names))
    with jm:
        jstep = jax.jit(jsetup.train_step,
                        in_shardings=jsetup.shardings(jm, shape))
    _, _, _, fsdp, fstate = _silo_pair('qwen3-1.7b')
    fsdp.rules = shd.FSDP_RULES
    mesh = mesh_lib.make_local_mesh(device='cpu')
    fsdp.shardings(mesh, shape)
    seen = []

    def spy(x, *axes):
        seen.append(shd._ACT_CTX)
        return x
    monkeypatch.setattr(shd, 'constrain_act', spy)
    for r in range(3):
        jb, tb = _round_batches(jc, r)
        with jm:
            jstate, jmet = jstep(jstate, jb)
        pstate, pmet = plain.train_step(pstate, tb)
        n_plain = len(seen)
        fstate, fmet = fsdp.train_step(fstate, tb)
        for part in ('global', 'local', 'cache'):
            for a, b in zip(tree_leaves(fstate[part]),
                            tree_leaves(pstate[part])):
                assert torch.equal(a, b), part
            _close(fstate[part], jstate[part], STATE_ATOL)
        assert torch.equal(fmet['loss'], pmet['loss'])
        np.testing.assert_allclose(float(fmet['loss']), float(jmet['loss']),
                                   atol=STATE_ATOL)
        assert n_plain and all(c is None for c in seen[:n_plain])
        assert len(seen) > n_plain and all(
            c[0] is mesh and c[1] is shd.FSDP_RULES for c in seen[n_plain:])
        seen.clear()


def test_silo_setup_accepts_every_profile():
    """``rules=`` is accepted for every profile; only ``FSDP_RULES`` by
    identity (not an equal copy) pins the activations, as in the
    reference; its weight gather is a constraint, the same tensors."""
    model = build_model(tcfgs.get_config('qwen3-1.7b').reduced())
    mesh = mesh_lib.make_local_mesh(device='cpu')
    state = steps.SiloSetup(model, n_clients=2).init_state(
        model.init(0, device='cpu'))
    for rules in list(shd.PROFILES.values()) + [dict(shd.FSDP_RULES)]:
        setup = steps.SiloSetup(model, n_clients=2, rules=rules)
        assert not isinstance(setup._activation_context(),
                              shd.activation_sharding)
        setup.shardings(mesh, InputShape('t', 8, 4, 'train'))
        pinned = isinstance(setup._activation_context(),
                            shd.activation_sharding)
        assert pinned == (rules is shd.FSDP_RULES)
        got = setup._maybe_gather_weights(state['local'])
        assert all(a is b for a, b in zip(tree_leaves(got),
                                          tree_leaves(state['local'])))

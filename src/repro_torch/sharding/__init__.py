"""Logical-axis sharding rules (MaxText-style), as data.

Parameters, states, caches and batches carry *logical* axis names
(``Model.param_axes``, ``launch.steps.cache_axes``, ...); a rule set
maps each name to the mesh axes it prefers.  ``spec_for`` turns one
array's names and shape into a ``PartitionSpec``, dropping axes that are
absent from the mesh, already used by another dimension, or that do not
divide the dimension, so one rule set serves a 1x1 mesh, the 16x16
production mesh and the 2x16x16 multi-pod mesh (``launch.mesh``).

The rules, profiles and ``spec_for`` are the reference's, letter for
letter.  The port runs on one card (several cards are ROADMAP item 20),
so a spec is data that nothing lays out: ``tree_shardings`` pairs it with
its mesh, and ``constrain``/``constrain_act`` return their input
unchanged, as the reference's do without a mesh.
"""
from __future__ import annotations

import math
from typing import NamedTuple

# logical axis -> preferred mesh axes (first that fits wins, in order)
DEFAULT_RULES = {
    'clients': ('pod', 'data'),     # FL silo mode: client dim over pod+data
    'batch': ('pod', 'data'),       # serving / plain training
    'local_batch': (),              # per-client batch: unsharded
    'vocab': ('model',),
    'mlp': ('model',),
    'qkv': ('model',),
    'kv': ('model',),
    'experts': ('model',),
    'ssm_inner': ('model',),
    'heads': ('model',),
    'embed': (),
    'embed_out': (),
    'layers': (),
    'seq': (),
}

# FSDP-style weight sharding on the model axis: weights shard on their
# d_model (row) dim and are gathered per layer; activations stay local to
# each client slice.  Experts keep expert-parallel sharding.
FSDP_RULES = {
    'clients': ('pod', 'data'),
    'batch': ('pod', 'data'),
    'vocab': ('model',),            # embed/unembed stay vocab-sharded
    'mlp': (),
    'qkv': (),
    'kv': (),
    'experts': ('model',),
    'ssm_inner': (),
    'heads': (),
    'embed': ('model',),            # shard the d_model row dim instead
    'embed_out': (),
    'layers': (),
    'seq': (),
    'local_batch': ('model',),      # ZeRO-3 style: per-client batch is
                                    # data-parallel across the client's
                                    # model-axis slice; weights gathered
}

# Multi-pod variant: clients on `data` only (C = 16), so each client spans
# pod x model = 32 chips; the per-client batch stays divisible by the
# model axis and the seq dim shards over `pod`.
FSDP_MULTIPOD_RULES = dict(FSDP_RULES, clients=('data',), seq=('pod',))

PROFILES = {'tp': DEFAULT_RULES, 'fsdp': FSDP_RULES,
            'fsdp_mp': FSDP_MULTIPOD_RULES}


class PartitionSpec(tuple):
    """One entry per leading dimension of an array: ``None`` (replicated),
    a mesh axis name, or a tuple of names (the product of their sizes
    splits the dimension).  Trailing ``None``s are left out."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f'PartitionSpec{tuple.__repr__(self)}'


class NamedSharding(NamedTuple):
    """A spec on its mesh."""

    mesh: object
    spec: PartitionSpec


def _axes_in_mesh(mesh, names):
    return tuple(n for n in names if n in mesh.axis_names)


def spec_for(logical_axes, shape, mesh, rules=None) -> PartitionSpec:
    """The ``PartitionSpec`` of one array given its logical axes, its shape
    and a mesh (anything with ``axis_names`` and a ``shape`` mapping of
    axis sizes)."""
    rules = rules or DEFAULT_RULES
    used = set()
    entries = []
    for dim, name in zip(shape, logical_axes):
        if name is None or name not in rules:
            entries.append(None)
            continue
        cand = _axes_in_mesh(mesh, rules[name])
        cand = tuple(a for a in cand if a not in used)
        # shrink until the product of axis sizes divides the dim
        while cand and dim % math.prod(mesh.shape[a] for a in cand):
            cand = cand[:-1]
        if not cand:
            entries.append(None)
        elif len(cand) == 1:
            entries.append(cand[0])
            used.add(cand[0])
        else:
            entries.append(cand)
            used.update(cand)
    while entries and entries[-1] is None:
        entries.pop()
    return PartitionSpec(*entries)


def is_axes(x) -> bool:
    """A leaf of a logical-axes tree: a tuple of names and ``None``s."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def shape_of(x) -> tuple:
    """A leaf's shape: a tensor's, or ``()`` for a host scalar (the port's
    ``cache['length']`` is a Python int)."""
    return tuple(x.shape) if hasattr(x, 'shape') else ()


def tree_map_axes(fn, axes_tree, *trees):
    """``fn(axes, leaf, ...)`` over an axes tree (nested dicts whose leaves
    are axes tuples) and trees of the same structure."""
    if is_axes(axes_tree):
        return fn(axes_tree, *trees)
    if trees and set(axes_tree) != set(trees[0]):
        raise ValueError(f'axes tree keys {sorted(axes_tree)} differ from '
                         f'the tree\'s {sorted(trees[0])}')
    return {k: tree_map_axes(fn, a, *(t[k] for t in trees))
            for k, a in axes_tree.items()}


def tree_specs(axes_tree, shapes_tree, mesh, rules=None):
    """(logical-axes tree, tree of tensors) -> ``PartitionSpec`` tree."""
    return tree_map_axes(lambda a, s: spec_for(a, shape_of(s), mesh, rules),
                         axes_tree, shapes_tree)


def tree_shardings(axes_tree, shapes_tree, mesh, rules=None):
    """(logical-axes tree, tree of tensors) -> ``NamedSharding`` tree."""
    return tree_map_axes(
        lambda a, s: NamedSharding(mesh, spec_for(a, shape_of(s), mesh,
                                                  rules)),
        axes_tree, shapes_tree)


def shard_count(spec, mesh) -> int:
    """Into how many pieces ``spec`` splits an array on ``mesh``."""
    n = 1
    for entry in spec:
        for a in (() if entry is None else
                  (entry,) if isinstance(entry, str) else entry):
            n *= mesh.shape[a]
    return n


def constrain(x, mesh, *logical_axes, rules=None):  # noqa: ARG001
    """The reference's ``with_sharding_constraint`` by logical axes: on one
    card there is nothing to lay out, so ``x`` itself."""
    return x


# ---------------------------------------------------------------------------
# Activation sharding context: the step functions enter it with (mesh, rules)
# around the layer loop, and model code calls ``constrain_act`` on the
# residual stream, as in the reference.  On one card the constraint
# changes nothing.
# ---------------------------------------------------------------------------

_ACT_CTX = None  # (mesh, rules) or None


class activation_sharding:
    def __init__(self, mesh, rules):
        self.ctx = (mesh, rules)

    def __enter__(self):
        global _ACT_CTX
        self._prev = _ACT_CTX
        _ACT_CTX = self.ctx

    def __exit__(self, *exc):
        global _ACT_CTX
        _ACT_CTX = self._prev


def constrain_act(x, *logical_axes):  # noqa: ARG001
    """Pin the residual stream's layout inside the layer loop; ``x`` itself
    on one card."""
    return x

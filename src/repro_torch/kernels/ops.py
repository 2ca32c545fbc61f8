"""Model-level wrappers around the kernels: the pack layout and the
tree-level aggregation and int8-wire server steps.

A model is a flat dict of tensors.  It flattens in sorted-key order, as
``jax.tree_util`` flattens the JAX package's dicts, so that both packages
lay a model out identically: leaf order fixes every pack offset, and
under the int8 wire every quantisation block and scale.

Two tree-level aggregation paths:

* ``safa_aggregate_tree``        — one kernel launch per leaf;
* ``safa_aggregate_tree_packed`` — the model flattened once into a single
  [m, n_padded] buffer, so Eq. 6-8 runs as exactly one launch per round
  whatever the model's depth.

``safa_compressed_update`` is the int8 wire's server step: two launches
per round (``quantize_packed``, then ``safa_aggregate_packed_q8``).
``wire_roundtrip_packed`` is the int8 wire of the protocols without a
fused int8 aggregation kernel (FedAvg, FedCS, the weighted-merge family):
two launches per round (``quantize_packed``, then ``dequantize_packed``).
``quantize_tree``/``dequantize_tree`` are the int8 wire leaf by leaf
(``quantize``/``dequantize``: one launch per leaf each), the per-leaf
reference ``SafaSpec(quantize_uploads=True)`` is written over.
``weighted_merge_tree_packed`` is the weighted-merge family's server
merge: the model packed once, one ``weighted_merge_packed`` launch.
The sparse schedules' packed engine works on the pack buffers directly,
with ``gather_rows``/``scatter_rows`` and the rows aggregation kernels
(the lag tier's with the tier-rows kernels), and their fleet forms
(re-exported here, as the JAX package's ``ops`` holds them).

Each has a fleet form (``*_fleet``) over S independent servers: stacked
models carry [S, m, ...] leaves and globals [S, ...], and each form
launches its fleet kernel once for all S members (``pack_fleet`` lays
the [S, m, ...] stacks out as [S, m, n_padded] buffers).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.comm_quant import (PACK_TILE, QBLOCK, dequantize,
                                            dequantize_packed,
                                            dequantize_packed_fleet,
                                            quantize, quantize_packed,
                                            quantize_packed_fleet)
from repro_torch.kernels.rows import (gather_rows, gather_rows_fleet,
                                     scatter_rows, scatter_rows_fleet)
from repro_torch.kernels.safa_aggregate import (
    safa_aggregate, safa_aggregate_fleet, safa_aggregate_packed,
    safa_aggregate_packed_fleet, safa_aggregate_packed_q8,
    safa_aggregate_packed_q8_fleet, safa_aggregate_packed_q8_rows,
    safa_aggregate_packed_q8_rows_fleet,
    safa_aggregate_packed_q8_tier_rows,
    safa_aggregate_packed_q8_tier_rows_fleet, safa_aggregate_packed_rows,
    safa_aggregate_packed_rows_fleet, safa_aggregate_packed_tier_rows,
    safa_aggregate_packed_tier_rows_fleet)
from repro_torch.kernels.weighted_merge import (weighted_merge_packed,
                                                weighted_merge_packed_fleet)

__all__ = ['PackSpec', 'comm_bytes', 'dequantize_tree', 'gather_rows',
           'gather_rows_fleet', 'pack_fleet', 'pack_global', 'pack_spec',
           'pack_stacked', 'quantize_tree',
           'safa_aggregate_packed_q8_rows',
           'safa_aggregate_packed_q8_rows_fleet',
           'safa_aggregate_packed_q8_tier_rows',
           'safa_aggregate_packed_q8_tier_rows_fleet',
           'safa_aggregate_packed_rows', 'safa_aggregate_packed_rows_fleet',
           'safa_aggregate_packed_tier_rows',
           'safa_aggregate_packed_tier_rows_fleet',
           'safa_aggregate_tree', 'safa_aggregate_tree_fleet',
           'safa_aggregate_tree_packed', 'safa_aggregate_tree_packed_fleet',
           'safa_compressed_update', 'safa_compressed_update_fleet',
           'scatter_rows', 'scatter_rows_fleet', 'tree_keys', 'unpack_fleet',
           'unpack_global', 'unpack_stacked',
           'weighted_merge_packed', 'weighted_merge_packed_fleet',
           'weighted_merge_tree_packed', 'weighted_merge_tree_packed_fleet',
           'wire_roundtrip_packed', 'wire_roundtrip_packed_fleet',
           'wire_spec']


def tree_keys(tree: dict) -> tuple:
    """Leaf order of a model dict: sorted keys, as ``jax.tree_util``."""
    return tuple(sorted(tree))


def safa_aggregate_tree(cache, trained, global_prev, *, picked, undrafted,
                        deprecated, weights):
    """Eq. 6-8 leaf by leaf over stacked model dicts ([m, ...] leaves).
    Returns (new_global, new_cache)."""
    new_global, new_cache = {}, {}
    for k in tree_keys(global_prev):
        c, t, g = cache[k], trained[k], global_prev[k]
        m = c.shape[0]
        ng, nc = safa_aggregate(
            c.reshape(m, -1), t.reshape(m, -1), g.reshape(-1).to(c.dtype),
            picked, undrafted, deprecated, weights)
        new_global[k] = ng.reshape(g.shape).to(g.dtype)
        new_cache[k] = nc.reshape(c.shape)
    return new_global, new_cache


def safa_aggregate_tree_fleet(cache, trained, global_prev, *, picked,
                              undrafted, deprecated, weights):
    """Fleet form of ``safa_aggregate_tree``: [S, m, ...] stacks, [S, ...]
    globals, [S, m] masks and weights; one fleet launch per leaf, into a
    fresh output.  Returns (new_global, new_cache)."""
    new_global, new_cache = {}, {}
    for k in tree_keys(global_prev):
        c, t, g = cache[k], trained[k], global_prev[k]
        s, m = c.shape[:2]
        ng, nc = safa_aggregate_fleet(
            c.reshape(s, m, -1), t.reshape(s, m, -1),
            g.reshape(s, -1).to(c.dtype), picked, undrafted, deprecated,
            weights)
        new_global[k] = ng.reshape(g.shape).to(g.dtype)
        new_cache[k] = nc.reshape(c.shape)
    return new_global, new_cache


# ---------------------------------------------------------------------------
# Packed layout: whole model as one [*, n_padded] buffer
# ---------------------------------------------------------------------------

class PackSpec(NamedTuple):
    """Static layout of a model dict inside a flat pack buffer.

    ``offsets[i]:offsets[i] + sizes[i]`` holds leaf ``keys[i]`` (global
    shapes, without the clients dim); each leaf's slot is zero-padded up to
    the next leaf's offset (slots exceed sizes only under ``align > 1``);
    ``n_padded`` is the laid-out total rounded up to a ``pad_to`` multiple."""
    keys: tuple
    shapes: tuple
    dtypes: tuple
    sizes: tuple
    offsets: tuple
    n_total: int
    n_padded: int

    def slot(self, i: int) -> int:
        """Width of leaf i's slot (its size plus alignment padding)."""
        nxt = self.offsets[i + 1] if i + 1 < len(self.offsets) \
            else self.n_total
        return nxt - self.offsets[i]


def pack_spec(global_tree: dict, *, pad_to: int = PACK_TILE,
              align: int = 1) -> PackSpec:
    """Build the layout from a global (unstacked) model dict.  ``align > 1``
    rounds every leaf's slot up to an ``align`` multiple; ``pad_to`` must
    be a multiple of ``align`` so the tile padding is whole blocks."""
    if pad_to < 1 or align < 1:
        raise ValueError(
            f'pack_spec needs pad_to >= 1 and align >= 1, got '
            f'pad_to={pad_to}, align={align}')
    if pad_to % align:
        raise ValueError(
            f'pad_to={pad_to} is not a multiple of align={align}: the tile '
            'padding must consist of whole alignment blocks (pick pad_to as '
            'a multiple of align, or drop the alignment)')
    keys = tree_keys(global_tree)
    leaves = [global_tree[k] for k in keys]
    sizes = tuple(int(l.numel()) for l in leaves)
    offsets, off = [], 0
    for s in sizes:
        offsets.append(off)
        off += s + ((-s) % align)
    return PackSpec(keys=keys, shapes=tuple(tuple(l.shape) for l in leaves),
                    dtypes=tuple(l.dtype for l in leaves), sizes=sizes,
                    offsets=tuple(offsets), n_total=off,
                    n_padded=off + ((-off) % pad_to))


def wire_spec(global_tree: dict, *, pad_to: int = PACK_TILE) -> PackSpec:
    """The int8 wire's layout: QBLOCK-aligned leaf slots, so every
    quantisation block lies inside one leaf of one client row."""
    return pack_spec(global_tree, pad_to=pad_to, align=QBLOCK)


def _pack(tree: dict, lead: tuple, spec: PackSpec, dtype):
    flat = []
    for i, (k, size) in enumerate(zip(spec.keys, spec.sizes)):
        x = tree[k].to(dtype).reshape(lead + (-1,))
        gap = spec.slot(i) - size
        flat.append(F.pad(x, (0, gap)) if gap else x)
    pad = spec.n_padded - spec.n_total
    if pad:
        flat.append(flat[0].new_zeros(lead + (pad,)))
    return torch.cat(flat, dim=-1)


def pack_stacked(tree: dict, spec: PackSpec, *, dtype=torch.float32):
    """Stacked model dict ([m, ...] leaves) -> [m, n_padded] buffer."""
    m = tree[spec.keys[0]].shape[0]
    return _pack(tree, (m,), spec, dtype)


def pack_global(tree: dict, spec: PackSpec, *, dtype=torch.float32):
    """Global model dict -> [n_padded] buffer."""
    return _pack(tree, (), spec, dtype)


def pack_fleet(tree: dict, spec: PackSpec, *, dtype=torch.float32):
    """Fleet-stacked model dict ([S, m, ...] leaves) -> [S, m, n_padded]
    buffer.  Fleet globals ([S, ...] leaves) pack with ``pack_stacked``:
    their leading axis is S instead of m."""
    return _pack(tree, tuple(tree[spec.keys[0]].shape[:2]), spec, dtype)


def _unpack(buf, spec: PackSpec, lead: tuple) -> dict:
    return {k: buf[..., off:off + size].reshape(lead + shape).to(dt)
            for k, shape, dt, size, off in zip(spec.keys, spec.shapes,
                                               spec.dtypes, spec.sizes,
                                               spec.offsets)}


def unpack_stacked(buf, spec: PackSpec) -> dict:
    """[m, n_padded] buffer -> stacked model dict (views into ``buf``)."""
    return _unpack(buf, spec, (buf.shape[0],))


def unpack_global(buf, spec: PackSpec) -> dict:
    """[n_padded] buffer -> global model dict (views into ``buf``)."""
    return _unpack(buf, spec, ())


def unpack_fleet(buf, spec: PackSpec) -> dict:
    """[S, m, n_padded] buffer -> fleet-stacked model dict (views)."""
    return _unpack(buf, spec, tuple(buf.shape[:2]))


def _member_spec(global_prev: dict, spec, layout) -> PackSpec:
    """A fleet's pack layout: one member's (``[0]`` of every leaf)."""
    if spec is not None:
        return spec
    return layout({k: v[0] for k, v in global_prev.items()})


def _require_f32(spec: PackSpec):
    bad = [str(d) for d in spec.dtypes if d != torch.float32]
    if bad:
        raise TypeError(
            f'packed aggregation requires float32 leaves, got {bad}; use '
            'the leaf-wise safa_aggregate_tree for mixed/low-precision '
            'models')


def safa_aggregate_tree_packed(cache, trained, global_prev, *, picked,
                               undrafted, deprecated, weights,
                               spec: PackSpec = None):
    """Eq. 6-8 over a whole model dict in one launch: pack the three
    operands, run ``safa_aggregate_packed`` once (the fresh cache pack is
    overwritten in place), unpack.  Float32 models only.
    Returns (new_global, new_cache)."""
    if spec is None:
        spec = pack_spec(global_prev)
    _require_f32(spec)
    pc = pack_stacked(cache, spec)
    pt = pack_stacked(trained, spec)
    pg = pack_global(global_prev, spec)
    ng, nc = safa_aggregate_packed(pc, pt, pg, picked, undrafted, deprecated,
                                   weights)
    return unpack_global(ng, spec), unpack_stacked(nc, spec)


def safa_aggregate_tree_packed_fleet(cache, trained, global_prev, *, picked,
                                     undrafted, deprecated, weights,
                                     spec: PackSpec = None):
    """Fleet form of ``safa_aggregate_tree_packed``: [S, m, ...] stacks,
    [S, ...] globals, [S, m] masks and weights; all S servers' Eq. 6-8 in
    one launch of ``safa_aggregate_packed_fleet``.  ``spec`` is one
    member's layout.  Returns (new_global, new_cache)."""
    spec = _member_spec(global_prev, spec, pack_spec)
    _require_f32(spec)
    pc = pack_fleet(cache, spec)
    pt = pack_fleet(trained, spec)
    pg = pack_stacked(global_prev, spec)            # [S, n_padded]
    ng, nc = safa_aggregate_packed_fleet(pc, pt, pg, picked, undrafted,
                                         deprecated, weights)
    return unpack_stacked(ng, spec), unpack_fleet(nc, spec)


# ---------------------------------------------------------------------------
# Weighted merge: the staleness-adaptive family's server step, one launch
# ---------------------------------------------------------------------------

def weighted_merge_tree_packed(trained, global_prev, *, wrow,
                               spec: PackSpec = None):
    """The weighted merge over a whole model dict in one launch: pack the
    trained stack ([m, ...] leaves) and the global, run
    ``weighted_merge_packed`` once, unpack the new global.  ``spec`` may
    be precomputed by callers that merge every round (the layout depends
    on the model alone).  Float32 models only."""
    if spec is None:
        spec = pack_spec(global_prev)
    _require_f32(spec)
    pt = pack_stacked(trained, spec)
    pg = pack_global(global_prev, spec)
    return unpack_global(weighted_merge_packed(pt, pg, wrow), spec)


def weighted_merge_tree_packed_fleet(trained, global_prev, *, wrow,
                                     spec: PackSpec = None):
    """Fleet form of ``weighted_merge_tree_packed``: [S, m, ...] stacks,
    [S, ...] globals, [S, m] weight rows; all S merges in one launch of
    ``weighted_merge_packed_fleet``.  ``spec`` is one member's layout."""
    spec = _member_spec(global_prev, spec, pack_spec)
    _require_f32(spec)
    pt = pack_fleet(trained, spec)
    pg = pack_stacked(global_prev, spec)            # [S, n_padded]
    return unpack_stacked(weighted_merge_packed_fleet(pt, pg, wrow), spec)


# ---------------------------------------------------------------------------
# Compressed wire path: packed int8 uplink in 2 launches
# ---------------------------------------------------------------------------

def safa_compressed_update(base, trained, cache, global_prev, *, picked,
                           undrafted, deprecated, completed, weights,
                           spec: PackSpec = None):
    """One SAFA server step on the int8 wire: ``quantize_packed`` on the
    QBLOCK-aligned pack of the uploads, then ``safa_aggregate_packed_q8``,
    which dequantises in registers, takes the base model for clients that
    did not complete, and applies Eq. 6-8 with the cache pack written in
    place.  Exactly two launches for any model depth.
    Returns (new_global, new_local, new_cache) model dicts."""
    if spec is None:
        spec = wire_spec(global_prev)
    _require_f32(spec)
    q, scales = quantize_packed(pack_stacked(trained, spec))
    ng, nc, nl = safa_aggregate_packed_q8(
        q, scales, pack_stacked(base, spec), pack_stacked(cache, spec),
        pack_global(global_prev, spec), picked, undrafted, deprecated,
        completed, weights)
    return (unpack_global(ng, spec), unpack_stacked(nl, spec),
            unpack_stacked(nc, spec))


def safa_compressed_update_fleet(base, trained, cache, global_prev, *,
                                 picked, undrafted, deprecated, completed,
                                 weights, spec: PackSpec = None):
    """Fleet form of ``safa_compressed_update``: ``quantize_packed_fleet``
    on the [S, m, N] upload pack, then one ``safa_aggregate_packed_q8_fleet``
    launch: two launches per round for the whole fleet.  ``spec`` is one
    member's wire layout.  Returns (new_global, new_local, new_cache)."""
    spec = _member_spec(global_prev, spec, wire_spec)
    _require_f32(spec)
    q, scales = quantize_packed_fleet(pack_fleet(trained, spec))
    ng, nc, nl = safa_aggregate_packed_q8_fleet(
        q, scales, pack_fleet(base, spec), pack_fleet(cache, spec),
        pack_stacked(global_prev, spec), picked, undrafted, deprecated,
        completed, weights)
    return (unpack_stacked(ng, spec), unpack_fleet(nl, spec),
            unpack_fleet(nc, spec))


def wire_roundtrip_packed(tree, spec: PackSpec = None, *, like=None):
    """The int8 wire for a whole stacked model dict ([m, ...] leaves) in
    two launches: pack -> ``quantize_packed`` -> ``dequantize_packed`` ->
    unpack, so the server sees exactly what a compressed transfer
    delivers.  ``like`` (a global model dict) fixes the layout; it
    defaults to the first client's row of ``tree``."""
    if spec is None:
        spec = wire_spec(like if like is not None
                         else {k: v[0] for k, v in tree.items()})
    _require_f32(spec)
    q, scales = quantize_packed(pack_stacked(tree, spec))
    return unpack_stacked(dequantize_packed(q, scales), spec)


def wire_roundtrip_packed_fleet(tree, like, spec: PackSpec = None):
    """Fleet form of ``wire_roundtrip_packed``: [S, m, ...] stacks, every
    member's uploads through ``quantize_packed_fleet`` and
    ``dequantize_packed_fleet``, two launches for the whole fleet.  The
    layout is one member's global's (``like``: the fleet's [S, ...]
    globals)."""
    spec = _member_spec(like, spec, wire_spec)
    _require_f32(spec)
    q, scales = quantize_packed_fleet(pack_fleet(tree, spec))
    return unpack_fleet(dequantize_packed_fleet(q, scales), spec)


def quantize_tree(tree: dict) -> dict:
    """Quantise every leaf on its own, flattened, in sorted-key order:
    key -> (q, scales), two tensors per leaf (for communication-compressed
    uploads)."""
    return {k: quantize(tree[k].reshape(-1)) for k in tree_keys(tree)}


def dequantize_tree(qtree: dict, like: dict) -> dict:
    """Inverse of ``quantize_tree``: each leaf back to ``like``'s shape and
    dtype."""
    return {k: dequantize(*qtree[k], n=like[k].numel())
            .reshape(like[k].shape).to(like[k].dtype)
            for k in tree_keys(like)}


def comm_bytes(tree: dict, quantized: bool, *, layout: str = 'tree') -> int:
    """Bytes on the wire for one model transfer.  ``layout='tree'`` counts
    the leaves as shipped one by one (per-leaf scale ceilings, no padding);
    ``layout='packed'`` counts the packed wire buffers, padding and the
    full scale rows included."""
    if layout not in ('tree', 'packed'):
        raise ValueError(
            f"unknown layout {layout!r} (want 'tree' or 'packed')")
    leaves = [tree[k] for k in tree_keys(tree)]
    if layout == 'packed':
        spec = wire_spec(tree) if quantized else pack_spec(tree)
        if not quantized:
            return 4 * spec.n_padded
        return spec.n_padded + 4 * (spec.n_padded // QBLOCK)
    n = sum(l.numel() for l in leaves)
    if not quantized:
        return sum(l.numel() * l.element_size() for l in leaves)
    return n + 4 * sum(-(-l.numel() // QBLOCK) for l in leaves)

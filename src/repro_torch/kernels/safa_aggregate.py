"""Fused SAFA discriminative aggregation (Eq. 6 + 7 + 8).

The server step is memory-bound: the three-step composition reads the m
cache entries three times and writes two intermediate copies, while the
fused kernel reads each row of cache and trained at most once, and only
where the masks need it, and writes the new global once and the new cache
only where it changes.  Parameters are flattened to [m, N] (m = clients).

Three entry points, each a CUDA kernel (``csrc/safa_aggregate.cu``) on
CUDA tensors and its plain version (``kernels.ref``) on CPU tensors:

* ``safa_aggregate`` — one [m, N] matrix, padded to ``PACK_TILE`` and written
  into a fresh new-cache output (the per-leaf ``use_kernel=True`` path);
* ``safa_aggregate_packed`` — a pre-padded pack buffer holding the whole
  model, one launch per round, the new cache written over the cache
  argument in place (the returned new_cache *is* ``cache``);
* ``safa_aggregate_packed_q8`` — the int8 wire: the trained operand
  arrives as (q, scales) and is dequantised in registers; the cache is
  written in place and the post-wire trained matrix comes back as
  new_local.

Each has a fleet form (``*_fleet``) for S independent servers in one
launch: every operand gains a leading member axis ([S, m, N] rows, [S, N]
globals, [S, m] masks and weights), and member s's results are bit for
bit the single-run launch's on member s's slices.

The sparse schedules' ``sparse_delta`` engine aggregates the K active rows
alone (``csrc/safa_rows.cu``): ``safa_aggregate_packed_rows`` and its int8
form ``safa_aggregate_packed_q8_rows`` read the K cache rows by index and
return the new global, the new running aggregate and the K new cache rows
(and the int8 form the K local rows), for the engine to scatter back.
Their fleet forms (``*_rows_fleet``) take a leading member axis on every
operand (cache [S, R, N], slot rows [S, K, N], vectors [S, N], slots
[S, K]) and launch once for all S members.

SAFA's lag tier carries one [C + 1, N] value buffer instead of the cache
stack: ``safa_aggregate_packed_tier_rows`` and its int8 form
``safa_aggregate_packed_q8_tier_rows`` read each slot's cache row through
one slot map (``srcs``) and write its new cache row through another
(``dsts``) into the same buffer, in place; their fleet forms
(``*_tier_rows_fleet``) take the leading member axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import backend, ref
from repro_torch.kernels.comm_quant import PACK_TILE, QBLOCK, _check_packed

#: In-place inventory (format: ``comm_quant.ALIAS_CONTRACTS``): the
#: packed routes write the new cache over ``cache``, the tier forms their
#: new cache rows into ``buf``; the per-leaf route and the rows forms
#: write fresh outputs (the engines scatter the rows back).
ALIAS_CONTRACTS = {
    'safa_aggregate': ((),),
    'safa_aggregate_fleet': ((),),
    'safa_aggregate_packed': (('cache',),),
    'safa_aggregate_packed_fleet': (('cache',),),
    'safa_aggregate_packed_q8': (('cache',),),
    'safa_aggregate_packed_q8_fleet': (('cache',),),
    'safa_aggregate_packed_rows': ((),),
    'safa_aggregate_packed_rows_fleet': ((),),
    'safa_aggregate_packed_q8_rows': ((),),
    'safa_aggregate_packed_q8_rows_fleet': ((),),
    'safa_aggregate_packed_tier_rows': (('buf',),),
    'safa_aggregate_packed_tier_rows_fleet': (('buf',),),
    'safa_aggregate_packed_q8_tier_rows': (('buf',),),
    'safa_aggregate_packed_q8_tier_rows_fleet': (('buf',),),
}


def _lead(x, fleet: bool) -> tuple:
    """The member axis of a kernel operand: (S,) for a fleet, () for one
    run; raises on the wrong rank."""
    want = 3 if fleet else 2
    if x.ndim != want:
        raise ValueError(
            f'expected {"[S, m, N]" if fleet else "[m, N]"} rows, got shape '
            f'{tuple(x.shape)}')
    return tuple(x.shape[:1]) if fleet else ()


def _check_column_operands(lead: tuple, m: int, n: int, device, global_prev,
                           weights, **masks):
    backend.check_operand(global_prev, 'global_prev', torch.float32,
                          lead + (n,), device)
    backend.check_operand(weights, 'weights', torch.float32, lead + (m,),
                          device)
    for name, mask in masks.items():
        backend.check_operand(mask, name, torch.bool, lead + (m,), device)


def _launch(cache, trained, global_prev, picked, undrafted, deprecated,
            weights, new_cache, fleet: bool):
    """One launch of the f32 kernel over [(S,) m, N] operands
    (N % 4 == 0)."""
    lead = _lead(cache, fleet)
    m, n = cache.shape[-2:]
    dev = cache.device
    backend.check_operand(cache, 'cache', torch.float32, lead + (m, n), dev)
    backend.check_operand(trained, 'trained', torch.float32, lead + (m, n),
                          dev)
    backend.check_operand(new_cache, 'new_cache', torch.float32,
                          lead + (m, n), dev)
    _check_column_operands(lead, m, n, dev, global_prev, weights,
                           picked=picked, undrafted=undrafted,
                           deprecated=deprecated)
    new_global = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    backend.call('safa_aggregate_fleet_f32' if fleet else 'safa_aggregate_f32',
                 dev, cache.data_ptr(), trained.data_ptr(),
                 global_prev.data_ptr(), picked.data_ptr(),
                 undrafted.data_ptr(), deprecated.data_ptr(),
                 weights.data_ptr(), new_global.data_ptr(),
                 new_cache.data_ptr(), *lead, m, n)
    return new_global


def _fresh(key: str, fleet: bool, cache, trained, global_prev, picked,
           undrafted, deprecated, weights):
    """The per-leaf route: pad the rows to ``PACK_TILE`` and launch into a
    fresh new-cache output."""
    if not backend.is_cuda(cache, trained, global_prev):
        _lead(cache, fleet)
        return ref.safa_aggregate_ref(cache, trained, global_prev, picked,
                                      undrafted, deprecated, weights)
    n = cache.shape[-1]
    pad = (-n) % PACK_TILE
    cache_p = F.pad(cache, (0, pad)).contiguous()
    trained_p = F.pad(trained, (0, pad)).contiguous()
    global_p = F.pad(global_prev, (0, pad)).contiguous()
    new_cache = torch.empty_like(cache_p)
    new_global = _launch(cache_p, trained_p, global_p, picked, undrafted,
                         deprecated, weights, new_cache, fleet)
    backend.LAUNCHES[key] += 1
    return new_global[..., :n], new_cache[..., :n]


def _in_place(key: str, fleet: bool, cache, trained, global_prev, picked,
              undrafted, deprecated, weights):
    """The packed route: the new cache written over ``cache``."""
    _check_packed(cache.shape[-1])
    if not backend.is_cuda(cache, trained, global_prev):
        _lead(cache, fleet)
        ng, nc = ref.safa_aggregate_ref(cache, trained, global_prev, picked,
                                        undrafted, deprecated, weights)
        cache.copy_(nc)      # same in-place contract as the kernel
        return ng, cache
    new_global = _launch(cache, trained, global_prev, picked, undrafted,
                         deprecated, weights, cache, fleet)
    backend.LAUNCHES[key] += 1
    return new_global, cache


def safa_aggregate(cache, trained, global_prev, picked, undrafted, deprecated,
                   weights):
    """cache/trained: [m, N]; global_prev: [N]; masks: [m] bool;
    weights: [m] f32.  Returns (new_global [N], new_cache [m, N]) with the
    new cache in a fresh tensor."""
    return _fresh('safa_aggregate', False, cache, trained, global_prev,
                  picked, undrafted, deprecated, weights)


def safa_aggregate_fleet(cache, trained, global_prev, picked, undrafted,
                         deprecated, weights):
    """Fleet form of ``safa_aggregate`` (the per-leaf route of a sweep):
    cache/trained: [S, m, N]; global_prev: [S, N]; masks and weights:
    [S, m].  One launch for all S members.  Returns (new_global [S, N],
    new_cache [S, m, N]) with the new cache in a fresh tensor."""
    return _fresh('safa_aggregate_fleet', True, cache, trained, global_prev,
                  picked, undrafted, deprecated, weights)


def safa_aggregate_packed(cache, trained, global_prev, picked, undrafted,
                          deprecated, weights):
    """Whole-model variant on pre-padded pack buffers (cache/trained:
    [m, N], global_prev: [N], N % PACK_TILE == 0).  One launch for any
    model depth; the new cache is written over ``cache`` in place and
    ``cache`` itself is returned.  Returns (new_global [N], new_cache
    [m, N])."""
    return _in_place('safa_aggregate_packed', False, cache, trained,
                     global_prev, picked, undrafted, deprecated, weights)


def safa_aggregate_packed_fleet(cache, trained, global_prev, picked,
                                undrafted, deprecated, weights):
    """Fleet form of ``safa_aggregate_packed``: cache/trained [S, m, N]
    pack buffers (N % PACK_TILE == 0); global_prev [S, N]; masks and
    weights [S, m].  One launch runs Eq. 6-8 for all S servers, the
    [S, m, N] cache written in place and returned.  Returns
    (new_global [S, N], new_cache [S, m, N])."""
    return _in_place('safa_aggregate_packed_fleet', True, cache, trained,
                     global_prev, picked, undrafted, deprecated, weights)


def _q8(key: str, fleet: bool, q, scales, base, cache, global_prev, picked,
        undrafted, deprecated, completed, weights):
    lead = _lead(cache, fleet)
    m, n = cache.shape[-2:]
    _check_packed(n)
    if not backend.is_cuda(q, scales, base, cache, global_prev):
        ng, nc, nl = ref.safa_aggregate_q8_ref(
            q, scales, base, cache, global_prev, picked, undrafted,
            deprecated, completed, weights)
        cache.copy_(nc)
        return ng, cache, nl
    dev = cache.device
    rows = lead + (m, n)
    backend.check_operand(q, 'q', torch.int8, rows, dev)
    backend.check_operand(scales, 'scales', torch.float32,
                          lead + (m, n // QBLOCK), dev)
    backend.check_operand(base, 'base', torch.float32, rows, dev)
    backend.check_operand(cache, 'cache', torch.float32, rows, dev)
    _check_column_operands(lead, m, n, dev, global_prev, weights,
                           picked=picked, undrafted=undrafted,
                           deprecated=deprecated, completed=completed)
    new_global = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    new_local = torch.empty_like(cache)
    backend.call('safa_aggregate_q8_fleet_f32' if fleet
                 else 'safa_aggregate_q8_f32', dev, q.data_ptr(),
                 scales.data_ptr(), base.data_ptr(), cache.data_ptr(),
                 global_prev.data_ptr(), picked.data_ptr(),
                 undrafted.data_ptr(), deprecated.data_ptr(),
                 completed.data_ptr(), weights.data_ptr(),
                 new_global.data_ptr(), new_local.data_ptr(),
                 *lead, m, n)
    backend.LAUNCHES[key] += 1
    return new_global, cache, new_local


def safa_aggregate_packed_q8(q, scales, base, cache, global_prev, picked,
                             undrafted, deprecated, completed, weights):
    """Fused int8-wire Eq. 6-8: dequantise + aggregate in one launch.

    q: [m, N] int8; scales: [m, N / QBLOCK] f32 (``quantize_packed`` of a
    QBLOCK-aligned pack); base/cache: [m, N] f32 (N % PACK_TILE == 0);
    global_prev: [N]; picked/undrafted/deprecated/completed: [m] bool;
    weights: [m] f32.  The new cache is written over ``cache`` in place.
    Returns (new_global [N], new_cache [m, N], new_local [m, N])."""
    return _q8('safa_aggregate_packed_q8', False, q, scales, base, cache,
               global_prev, picked, undrafted, deprecated, completed, weights)


def safa_aggregate_packed_q8_fleet(q, scales, base, cache, global_prev,
                                   picked, undrafted, deprecated, completed,
                                   weights):
    """Fleet form of ``safa_aggregate_packed_q8``: q/base/cache
    [S, m, N]; scales [S, m, N / QBLOCK]; global_prev [S, N]; masks and
    weights [S, m].  S compressed server steps in one launch, the cache
    written in place.  Returns (new_global [S, N], new_cache [S, m, N],
    new_local [S, m, N])."""
    return _q8('safa_aggregate_packed_q8_fleet', True, q, scales, base,
               cache, global_prev, picked, undrafted, deprecated, completed,
               weights)


# ---------------------------------------------------------------------------
# The sparse schedules' rows forms: Eq. 6-8 on K indexed cache rows
# ---------------------------------------------------------------------------

def _rows_lead(fleet: bool, cache, rows, names=('cache', 'rows')) -> tuple:
    """The member axis of a rows launch: (S,) for a fleet, () for one run;
    raises on the wrong ranks or a width the kernels do not take.
    ``names`` name the buffer and slot operands in the message."""
    want = 2 + fleet
    if cache.ndim != want or rows.ndim != want - 1:
        b, i = names
        form = (f'{b} [S, R, N] and {i} [S, K]' if fleet
                else f'{b} [R, N] and {i} [K]')
        raise ValueError(f'expected {form}, got shapes '
                         f'{tuple(cache.shape)} and {tuple(rows.shape)}')
    _check_packed(cache.shape[-1])
    return tuple(cache.shape[:1]) if fleet else ()


def _check_rows_operands(fleet: bool, cache, rows, roles, w_rows,
                         global_prev, agg, names=('cache', 'rows')):
    """(lead, r, k, n) of a rows launch, with the operands every rows
    kernel shares checked."""
    lead = _rows_lead(fleet, cache, rows, names)
    (r, n), k = cache.shape[-2:], rows.shape[-1]
    dev = cache.device
    backend.check_operand(cache, names[0], torch.float32, lead + (r, n), dev)
    backend.check_operand(rows, names[1], torch.int32, lead + (k,), dev)
    backend.check_operand(roles, 'roles', torch.uint8, lead + (k,), dev)
    backend.check_operand(w_rows, 'w_rows', torch.float32, lead + (k,), dev)
    backend.check_operand(global_prev, 'global_prev', torch.float32,
                          lead + (n,), dev)
    backend.check_operand(agg, 'agg', torch.float32, lead + (n,), dev)
    return lead, r, k, n


def _rows(key: str, entry: str, fleet: bool, cache, trained_rows,
          global_prev, agg, rows, roles, w_rows):
    if not backend.is_cuda(cache, trained_rows, global_prev, agg):
        _rows_lead(fleet, cache, rows)
        return ref.safa_aggregate_rows_ref(cache, trained_rows, global_prev,
                                           agg, rows, roles, w_rows)
    lead, r, k, n = _check_rows_operands(fleet, cache, rows, roles, w_rows,
                                         global_prev, agg)
    dev = cache.device
    backend.check_operand(trained_rows, 'trained_rows', torch.float32,
                          lead + (k, n), dev)
    new_global = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    new_agg = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    c2 = torch.empty(lead + (k, n), dtype=torch.float32, device=dev)
    backend.call(entry, dev, cache.data_ptr(), trained_rows.data_ptr(),
                 global_prev.data_ptr(), agg.data_ptr(), rows.data_ptr(),
                 roles.data_ptr(), w_rows.data_ptr(), new_global.data_ptr(),
                 new_agg.data_ptr(), c2.data_ptr(), *lead, r, k, n)
    backend.LAUNCHES[key] += 1
    return new_global, new_agg, c2


def _q8_rows(key: str, entry: str, fleet: bool, q_rows, scales_rows,
             base_rows, cache, global_prev, agg, rows, roles, w_rows):
    if not backend.is_cuda(q_rows, scales_rows, base_rows, cache,
                           global_prev, agg):
        _rows_lead(fleet, cache, rows)
        return ref.safa_aggregate_q8_rows_ref(q_rows, scales_rows,
                                              base_rows, cache, global_prev,
                                              agg, rows, roles, w_rows)
    lead, r, k, n = _check_rows_operands(fleet, cache, rows, roles, w_rows,
                                         global_prev, agg)
    dev = cache.device
    backend.check_operand(q_rows, 'q_rows', torch.int8, lead + (k, n), dev)
    backend.check_operand(scales_rows, 'scales_rows', torch.float32,
                          lead + (k, n // QBLOCK), dev)
    backend.check_operand(base_rows, 'base_rows', torch.float32,
                          lead + (k, n), dev)
    new_global = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    new_agg = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    c2 = torch.empty(lead + (k, n), dtype=torch.float32, device=dev)
    local = torch.empty(lead + (k, n), dtype=torch.float32, device=dev)
    backend.call(entry, dev, q_rows.data_ptr(), scales_rows.data_ptr(),
                 base_rows.data_ptr(), cache.data_ptr(),
                 global_prev.data_ptr(), agg.data_ptr(), rows.data_ptr(),
                 roles.data_ptr(), w_rows.data_ptr(), new_global.data_ptr(),
                 new_agg.data_ptr(), c2.data_ptr(), local.data_ptr(), *lead,
                 r, k, n)
    backend.LAUNCHES[key] += 1
    return new_global, new_agg, c2, local


def safa_aggregate_packed_rows(cache, trained_rows, global_prev, agg, rows,
                               roles, w_rows):
    """Eq. 6-8 on the K active rows, one launch.

    cache: [R, N] f32 pack buffer (R = m + 1 with the trailing scratch row
    the sentinel slots read); trained_rows: [K, N] f32 (the committed
    slots' uploads, base rows elsewhere); global_prev, agg: [N] f32 (agg =
    the running Eq. 7 sum); rows: [K] int32; roles: [K] uint8 of
    ``protocol.ROLE_*`` bits; w_rows: [K] f32 (0 at sentinel slots).
    Returns (new_global [N], new_agg [N], c2 [K, N]), new_global = agg +
    sum w (c1 - c0) and new_agg = agg + sum w (c2 - c0); the caller
    scatters c2 back into the cache."""
    return _rows('safa_aggregate_packed_rows', 'safa_aggregate_rows_f32',
                 False, cache, trained_rows, global_prev, agg, rows, roles,
                 w_rows)


def safa_aggregate_packed_rows_fleet(cache, trained_rows, global_prev, agg,
                                     rows, roles, w_rows):
    """Fleet form of ``safa_aggregate_packed_rows``: cache [S, R, N],
    trained_rows [S, K, N], global_prev/agg [S, N], rows/roles/w_rows
    [S, K]; S servers' Eq. 6-8 in one launch.  Returns (new_global
    [S, N], new_agg [S, N], c2 [S, K, N])."""
    return _rows('safa_aggregate_packed_rows_fleet',
                 'safa_aggregate_rows_fleet_f32', True, cache, trained_rows,
                 global_prev, agg, rows, roles, w_rows)


def safa_aggregate_packed_q8_rows(q_rows, scales_rows, base_rows, cache,
                                  global_prev, agg, rows, roles, w_rows):
    """The int8 wire's form of ``safa_aggregate_packed_rows``: the K
    slots' uploads arrive as q_rows [K, N] int8 and scales_rows
    [K, N / QBLOCK] f32 and are dequantised in registers; slots that did
    not commit (no ``ROLE_COMMITTED`` bit) take base_rows [K, N] instead.
    Returns (new_global [N], new_agg [N], c2 [K, N], local [K, N]), local
    being each slot's trained row (its new local model)."""
    return _q8_rows('safa_aggregate_packed_q8_rows',
                    'safa_aggregate_q8_rows_f32', False, q_rows, scales_rows,
                    base_rows, cache, global_prev, agg, rows, roles, w_rows)


def safa_aggregate_packed_q8_rows_fleet(q_rows, scales_rows, base_rows,
                                        cache, global_prev, agg, rows, roles,
                                        w_rows):
    """Fleet form of ``safa_aggregate_packed_q8_rows``: q_rows [S, K, N]
    int8, scales_rows [S, K, N / QBLOCK], base_rows [S, K, N], cache
    [S, R, N], global_prev/agg [S, N], rows/roles/w_rows [S, K]; one
    launch.  Returns (new_global [S, N], new_agg [S, N], c2 [S, K, N],
    local [S, K, N])."""
    return _q8_rows('safa_aggregate_packed_q8_rows_fleet',
                    'safa_aggregate_q8_rows_fleet_f32', True, q_rows,
                    scales_rows, base_rows, cache, global_prev, agg, rows,
                    roles, w_rows)


# ---------------------------------------------------------------------------
# The lag tier's forms: Eq. 6-8 through slot maps, the buffer in place
# ---------------------------------------------------------------------------

_TIER = ('buf', 'srcs')


def _tier(key: str, entry: str, fleet: bool, buf, trained_rows,
          global_prev, agg, srcs, dsts, roles, w_rows):
    if not backend.is_cuda(buf, trained_rows, global_prev, agg):
        _rows_lead(fleet, buf, srcs, _TIER)
        return ref.safa_aggregate_tier_rows_ref(buf, trained_rows,
                                                global_prev, agg, srcs, dsts,
                                                roles, w_rows)
    lead, r, k, n = _check_rows_operands(fleet, buf, srcs, roles, w_rows,
                                         global_prev, agg, _TIER)
    dev = buf.device
    backend.check_operand(dsts, 'dsts', torch.int32, lead + (k,), dev)
    backend.check_operand(trained_rows, 'trained_rows', torch.float32,
                          lead + (k, n), dev)
    new_global = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    new_agg = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    backend.call(entry, dev, buf.data_ptr(), trained_rows.data_ptr(),
                 global_prev.data_ptr(), agg.data_ptr(), srcs.data_ptr(),
                 dsts.data_ptr(), roles.data_ptr(), w_rows.data_ptr(),
                 new_global.data_ptr(), new_agg.data_ptr(), *lead, r, k, n)
    backend.LAUNCHES[key] += 1
    return new_global, new_agg, buf


def _q8_tier(key: str, entry: str, fleet: bool, q_rows, scales_rows,
             base_rows, buf, global_prev, agg, srcs, dsts, roles, w_rows):
    if not backend.is_cuda(q_rows, scales_rows, base_rows, buf, global_prev,
                           agg):
        _rows_lead(fleet, buf, srcs, _TIER)
        return ref.safa_aggregate_q8_tier_rows_ref(
            q_rows, scales_rows, base_rows, buf, global_prev, agg, srcs,
            dsts, roles, w_rows)
    lead, r, k, n = _check_rows_operands(fleet, buf, srcs, roles, w_rows,
                                         global_prev, agg, _TIER)
    dev = buf.device
    backend.check_operand(dsts, 'dsts', torch.int32, lead + (k,), dev)
    backend.check_operand(q_rows, 'q_rows', torch.int8, lead + (k, n), dev)
    backend.check_operand(scales_rows, 'scales_rows', torch.float32,
                          lead + (k, n // QBLOCK), dev)
    backend.check_operand(base_rows, 'base_rows', torch.float32,
                          lead + (k, n), dev)
    new_global = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    new_agg = torch.empty(lead + (n,), dtype=torch.float32, device=dev)
    backend.call(entry, dev, q_rows.data_ptr(), scales_rows.data_ptr(),
                 base_rows.data_ptr(), buf.data_ptr(),
                 global_prev.data_ptr(), agg.data_ptr(), srcs.data_ptr(),
                 dsts.data_ptr(), roles.data_ptr(), w_rows.data_ptr(),
                 new_global.data_ptr(), new_agg.data_ptr(), *lead, r, k, n)
    backend.LAUNCHES[key] += 1
    return new_global, new_agg, buf


def safa_aggregate_packed_tier_rows(buf, trained_rows, global_prev, agg,
                                    srcs, dsts, roles, w_rows):
    """Eq. 6-8 through the lag tier's slot maps, the cache write-back in
    place, one launch.

    buf: [C + 1, N] f32 tier value buffer (its last row the scratch
    slot); trained_rows: [K, N] f32 (the committed slots' uploads, base
    rows elsewhere; not overlapping buf); global_prev, agg: [N] f32;
    srcs/dsts: [K] int32 buffer rows each slot reads its cache row c0 from
    and writes its c2 to; roles: [K] uint8 ``protocol.ROLE_*`` bits;
    w_rows: [K] f32.  Every slot reads before any slot writes, and the
    last slot wins a shared destination, so the buffer comes out as
    ``ref.safa_aggregate_tier_rows_ref`` leaves it; within a round the
    schedule keeps the rows read apart from those written (the scratch row
    apart), which the kernel relies on and does not check.  Returns
    (new_global [N], new_agg [N], buf)."""
    return _tier('safa_aggregate_packed_tier_rows',
                 'safa_aggregate_tier_rows_f32', False, buf, trained_rows,
                 global_prev, agg, srcs, dsts, roles, w_rows)


def safa_aggregate_packed_tier_rows_fleet(buf, trained_rows, global_prev,
                                          agg, srcs, dsts, roles, w_rows):
    """Fleet form of ``safa_aggregate_packed_tier_rows``: buf
    [S, C + 1, N], trained_rows [S, K, N], global_prev/agg [S, N],
    srcs/dsts/roles/w_rows [S, K]; S servers in one launch, each member's
    buffer written in place.  Returns (new_global [S, N], new_agg [S, N],
    buf)."""
    return _tier('safa_aggregate_packed_tier_rows_fleet',
                 'safa_aggregate_tier_rows_fleet_f32', True, buf,
                 trained_rows, global_prev, agg, srcs, dsts, roles, w_rows)


def safa_aggregate_packed_q8_tier_rows(q_rows, scales_rows, base_rows, buf,
                                       global_prev, agg, srcs, dsts, roles,
                                       w_rows):
    """The int8 wire's form of ``safa_aggregate_packed_tier_rows``: the K
    slots' uploads arrive as q_rows [K, N] int8 and scales_rows
    [K, N / QBLOCK] f32 and are dequantised in registers; slots that did
    not commit take base_rows [K, N].  No local output.  Returns
    (new_global [N], new_agg [N], buf)."""
    return _q8_tier('safa_aggregate_packed_q8_tier_rows',
                    'safa_aggregate_q8_tier_rows_f32', False, q_rows,
                    scales_rows, base_rows, buf, global_prev, agg, srcs,
                    dsts, roles, w_rows)


def safa_aggregate_packed_q8_tier_rows_fleet(q_rows, scales_rows, base_rows,
                                             buf, global_prev, agg, srcs,
                                             dsts, roles, w_rows):
    """Fleet form of ``safa_aggregate_packed_q8_tier_rows``: q_rows
    [S, K, N] int8, scales_rows [S, K, N / QBLOCK], base_rows [S, K, N],
    buf [S, C + 1, N], global_prev/agg [S, N], srcs/dsts/roles/w_rows
    [S, K]; one launch.  Returns (new_global [S, N], new_agg [S, N],
    buf)."""
    return _q8_tier('safa_aggregate_packed_q8_tier_rows_fleet',
                    'safa_aggregate_q8_tier_rows_fleet_f32', True, q_rows,
                    scales_rows, base_rows, buf, global_prev, agg, srcs,
                    dsts, roles, w_rows)

"""SAFA numeric protocol algebra (Eq. 3, 6, 7, 8) on stacked client models,
the rounds of the paper's baselines (FedAvg/FedCS, fully-local,
FedAsync), and the weighted-merge round of the staleness-adaptive family
(SEAFL, CSAFL, folded FedAsync).

Models are dicts of tensors, flat (the paper's tasks) or nested (the
LLMs of silo mode, which use ``masked_select``, ``broadcast_global``,
``distribute``, ``aggregate`` and the SAFA and FedAvg rounds); a stacked
model carries a leading clients dim of size m.  The server's cache (one
entry per client) and the bypass are masked updates: picked entries
overwrite pre-aggregation (Eq. 6), undrafted entries overwrite
post-aggregation (Eq. 8).

A fleet of S independent runs carries one more leading axis: masks and
weights [S, m], stacked models [S, m, ...], globals [S, ...].  The algebra
reads the axes from the masks (``mask.ndim`` is 1 for a run, 2 for a
fleet), so one round body serves both, and a fleet member's numbers are
the single run's.

``safa_run_scan`` replays a device-resident segment of precomputed round
masks, ``safa_round`` is one round of it; each baseline has the same
pair (``fedavg_run_scan``/``fedavg_round``, ``local_run_scan``/
``local_only_round``, ``fedasync_run_scan``/``fedasync_round``,
``weighted_run_scan``/``weighted_round``).  A scan
engine takes a run's segment ([k, m] masks, [k] round indices) or a
fleet's ([S, k, m], [S, k]); on a fleet's it runs one round of all S
members at a time, the work of the JAX package's ``*_run_fleet``.  The
functions on masks (``classify_versions``) work on numpy arrays and on
tensors alike: the host event process in ``core.federation`` calls them
on numpy.

The sparse active-set schedules (the last section) have engines of their
own for SAFA and FedAvg/FedCS (``*_run_scan_sparse``,
``*_run_scan_sparse_delta``, ``safa_run_scan_sparse_delta_packed``).
They too take a run's segment ([k, K] slot indices) or a fleet's
([S, k, K], every member re-padded to the fleet's widest active set), and
read the member axis from the indices: ``idx.ndim`` is 1 in a run's
round, 2 in a fleet's.  SAFA's lag-tier engines
(``safa_run_scan_sparse_tier[_packed]``) replace the [m, ...] stacks with
one bounded value buffer driven by host slot maps, on a run's segment or
a fleet's alike.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


def _bmask(mask, leaf):
    """Broadcast a [m] (or fleet [S, m]) client mask against a [m, ...]
    (or [S, m, ...]) leaf."""
    return mask.reshape(mask.shape + (1,) * (leaf.ndim - mask.ndim))


def masked_select(mask, a: dict, b: dict) -> dict:
    """Per-client where: leaf = mask ? a : b  (mask: [(S,) m] bool)."""
    return {k: masked_select(mask, v, b[k]) if isinstance(v, dict)
            else torch.where(_bmask(mask, v), v, b[k]) for k, v in a.items()}


def broadcast_global(global_tree: dict, m: int, *, fleet: bool = False
                     ) -> dict:
    """Tile the global model across the clients dim (views, no copy):
    [...] -> [m, ...], or for a fleet [S, ...] -> [S, m, ...]."""
    def tile(g):
        if isinstance(g, dict):
            return {k: tile(v) for k, v in g.items()}
        if fleet:
            return g[:, None].expand((g.shape[0], m) + tuple(g.shape[1:]))
        return g[None].expand((m,) + tuple(g.shape))
    return tile(global_tree)


def _tile(global_tree: dict, mask) -> dict:
    """``broadcast_global`` to the client axes of ``mask``."""
    return broadcast_global(global_tree, mask.shape[-1],
                            fleet=mask.ndim == 2)


# ---------------------------------------------------------------------------
# Eq. 3 — lag-tolerant distribution
# ---------------------------------------------------------------------------

def distribute(global_w: dict, local_w: dict, sync_mask) -> dict:
    """sync_mask[k] True => client k (up-to-date or deprecated) takes the
    latest global model; tolerable clients keep their local model."""
    return masked_select(sync_mask, _tile(global_w, sync_mask), local_w)


def classify_versions(versions, global_version, lag_tolerance,
                      committed_prev=None):
    """Client states at round start.

    versions[k] = version of the base model client k currently holds.
    up-to-date:  committed last round (their base will be the new global);
    deprecated:  staleness >= lag_tolerance (Eq. 3: v < t - tau);
    tolerable:   in between.
    """
    staleness = global_version - versions
    if committed_prev is None:
        up_to_date = staleness <= 0
    else:
        up_to_date = committed_prev
    deprecated = (~up_to_date) & (staleness >= lag_tolerance)
    tolerable = (~up_to_date) & (~deprecated)
    return up_to_date, deprecated, tolerable


# ---------------------------------------------------------------------------
# Eq. 6/7/8 — three-step discriminative aggregation
# ---------------------------------------------------------------------------

def pre_agg_cache_update(cache, trained, global_prev, picked, deprecated):
    """Eq. 6.  picked -> trained update; deprecated (and not picked) ->
    previous global; otherwise keep the existing entry."""
    out = masked_select(deprecated & ~picked, _tile(global_prev, picked),
                        cache)
    return masked_select(picked, trained, out)


def aggregate(cache: dict, weights) -> dict:
    """Eq. 7: w(t) = sum_k (n_k / n) * cache_k.  weights: [m] (or a
    fleet's [S, m]), each row summing to 1."""
    axis = weights.ndim - 1             # the clients axis

    def red(leaf):
        if isinstance(leaf, dict):
            return {k: red(v) for k, v in leaf.items()}
        w = _bmask(weights, leaf).float()
        return torch.sum(leaf.float() * w, dim=axis).to(leaf.dtype)
    return red(cache)


def post_agg_cache_update(cache, trained, undrafted):
    """Eq. 8: undrafted updates enter the cache for the *next* round."""
    return masked_select(undrafted, trained, cache)


def discriminative_aggregation(cache, trained, global_prev, *, picked,
                               undrafted, deprecated, weights,
                               use_kernel=False):
    """The full three-step aggregation; returns (new_global, new_cache).

    ``use_kernel=True`` launches the fused kernel once per leaf;
    ``'packed'`` flattens the model into one buffer and launches once.  On
    a fleet ([S, m] masks) each launch is the fleet kernel's, for all S
    members at once."""
    if use_kernel not in (False, True, 'packed'):
        raise ValueError(
            f'unknown use_kernel {use_kernel!r} (want False, True, or '
            f'"packed")')
    if use_kernel:
        from repro_torch.kernels import ops as kops
        fleet = picked.ndim == 2
        if use_kernel == 'packed':
            agg = kops.safa_aggregate_tree_packed_fleet if fleet \
                else kops.safa_aggregate_tree_packed
        else:
            agg = kops.safa_aggregate_tree_fleet if fleet \
                else kops.safa_aggregate_tree
        return agg(cache, trained, global_prev, picked=picked,
                   undrafted=undrafted, deprecated=deprecated,
                   weights=weights)
    cache1 = pre_agg_cache_update(cache, trained, global_prev, picked,
                                  deprecated)
    new_global = aggregate(cache1, weights)
    return new_global, post_agg_cache_update(cache1, trained, undrafted)


# ---------------------------------------------------------------------------
# One full numeric SAFA round, generic over a local-train fn
# ---------------------------------------------------------------------------

def check_wire(wire: str):
    if wire not in ('f32', 'int8'):
        raise ValueError(f"unknown wire {wire!r} (want 'f32' or 'int8')")


def safa_server_step(base, trained, cache, global_w, *, completed, picked,
                     undrafted, deprecated, weights, use_kernel=False,
                     wire='f32'):
    """Everything the SAFA server does after local training: the wire
    transfer, the Eq. 6-8 aggregation and the local sync; for one run or
    a fleet ([S, m] masks).  Returns (new_global, new_local, new_cache)."""
    if wire == 'int8':
        from repro_torch.kernels import ops as kops
        update = kops.safa_compressed_update_fleet if picked.ndim == 2 \
            else kops.safa_compressed_update
        return update(
            base, trained, cache, global_w, picked=picked,
            undrafted=undrafted, deprecated=deprecated, completed=completed,
            weights=weights)
    # crashed clients make no visible progress this round
    trained = masked_select(completed, trained, base)
    new_global, new_cache = discriminative_aggregation(
        cache, trained, global_w, picked=picked, undrafted=undrafted,
        deprecated=deprecated, weights=weights, use_kernel=use_kernel)
    # committed clients now hold their own trained model locally
    return new_global, masked_select(completed, trained, base), new_cache


def safa_round(global_w, local_w, cache, *, sync_mask, completed, picked,
               undrafted, deprecated, weights, local_train_fn, train_args=(),
               use_kernel=False, wire: str = 'f32'):
    """Run one SAFA round.  ``local_train_fn(stacked_params, *train_args)``
    returns the stacked trained params (it batches over the clients dim).
    ``wire='int8'`` runs the compressed wire (``use_kernel`` is then
    ignored: the fused int8 kernel is the aggregation).
    Returns (new_global, new_local, new_cache)."""
    check_wire(wire)
    base = distribute(global_w, local_w, sync_mask)
    trained = local_train_fn(base, *train_args)
    return safa_server_step(
        base, trained, cache, global_w, completed=completed, picked=picked,
        undrafted=undrafted, deprecated=deprecated, weights=weights,
        use_kernel=use_kernel, wire=wire)


# ---------------------------------------------------------------------------
# Multi-round engine over precomputed schedules
# ---------------------------------------------------------------------------

def _segment(self, start: int, stop: int):
    """Rounds [start, stop) of a run's [rounds, ...] schedule, as views."""
    return type(self)(*(a[start:stop] for a in self))


def _fleet_segment(self, start: int, stop: int):
    """Rounds [start, stop) of a fleet's [S, rounds, ...] schedule (the
    rounds axis is axis 1), as views."""
    return type(self)(*(a[:, start:stop] for a in self))


class RoundSchedule(NamedTuple):
    """SAFA per-round masks, stacked [k, m] on the device (plus the round
    indices [k]), so a whole run crosses host->device in one transfer.  A
    fleet's are [S, k, m] (round indices [S, k])."""
    sync: Any
    completed: Any
    picked: Any
    undrafted: Any
    deprecated: Any
    round_idx: Any
    segment = _segment
    fleet_segment = _fleet_segment


class SyncSchedule(NamedTuple):
    """FedAvg/FedCS per-round masks, stacked [k, m] (a fleet's [S, k, m]):
    ``completed`` is the survivor mask; the round intersects it with
    ``selected``."""
    selected: Any
    completed: Any
    round_idx: Any
    segment = _segment
    fleet_segment = _fleet_segment


class LocalSchedule(NamedTuple):
    """Fully-local per-round masks, stacked [k, m] (a fleet's [S, k, m]):
    ``completed`` is selected & survived, the only mask the round needs."""
    completed: Any
    round_idx: Any
    segment = _segment
    fleet_segment = _fleet_segment


class AsyncSchedule(NamedTuple):
    """FedAsync per-round merge schedule, stacked [k, m] (a fleet's
    [S, k, m]): the commit mask, the arrival-order merge permutation and
    the staleness-scaled mixing weights (0 for non-commits)."""
    committed: Any
    order: Any
    alphas: Any
    round_idx: Any
    segment = _segment
    fleet_segment = _fleet_segment


class WeightedSchedule(NamedTuple):
    """Weighted-merge per-round schedule, stacked [k, m] (a fleet's
    [S, k, m]): the commit mask and the precomputed per-client merge
    weights (0 for non-commits)."""
    committed: Any
    wrow: Any
    round_idx: Any
    segment = _segment
    fleet_segment = _fleet_segment


def _rounds(schedule, train_ctx=None):
    """(row, train_args) for every round of a device-resident segment.  A
    fleet's segment (told apart by its [S, k] round indices) is made
    round-major first, so that each round's [S, m] masks are one
    contiguous block, as the kernels take them.  ``train_ctx`` (a
    per-member-task fleet's data) rides along as the extra train
    argument."""
    if schedule.round_idx.ndim == 2:
        schedule = type(schedule)(*(a.transpose(0, 1).contiguous()
                                    for a in schedule))
    extra = () if train_ctx is None else (train_ctx,)
    for i in range(schedule.round_idx.shape[0]):
        row = type(schedule)(*(a[i] for a in schedule))
        yield row, (row.round_idx,) + extra


def safa_run_scan(global_w, local_w, cache, schedule: RoundSchedule, weights,
                  *, local_train_fn, use_kernel=False, wire='f32',
                  train_ctx=None):
    """Run the SAFA rounds of a segment of the device-resident schedule.
    Each round is the same ``safa_round`` the per-round loop engine calls,
    on rows of the resident masks, so the two engines agree bit for bit.
    ``round_idx`` rides along as a device scalar, like the JAX scan's
    traced index.

    On a fleet's segment (masks [S, k, m], round indices [S, k], weights
    [S, m], stacked models [S, m, ...], globals [S, ...]) each round is one
    ``safa_round`` on the whole fleet: one ``local_train_fn(base
    [S, m, ...], round_idx [S], *extra)`` call for all S * m client
    replicas, and one launch of each server kernel for all S members;
    member s's numbers are those of its own single run.
    Returns (new_global, new_local, new_cache)."""
    for r, args in _rounds(schedule, train_ctx):
        global_w, local_w, cache = safa_round(
            global_w, local_w, cache, sync_mask=r.sync,
            completed=r.completed, picked=r.picked, undrafted=r.undrafted,
            deprecated=r.deprecated, weights=weights,
            local_train_fn=local_train_fn, train_args=args,
            use_kernel=use_kernel, wire=wire)
    return global_w, local_w, cache


def fedavg_run_scan(global_w, local_w, schedule: SyncSchedule, weights, *,
                    local_train_fn, wire='f32', train_ctx=None):
    """FedAvg/FedCS counterpart of ``safa_run_scan``, for a run's segment
    or a fleet's.  ``wire='int8'`` round-trips the uploads through the
    packed int8 wire (two launches per round, for the whole fleet on a
    fleet).  Returns (new_global, new_local)."""
    for r, args in _rounds(schedule, train_ctx):
        global_w, local_w = fedavg_round(
            global_w, local_w, selected=r.selected, completed=r.completed,
            weights=weights, local_train_fn=local_train_fn, train_args=args,
            wire=wire)
    return global_w, local_w


def local_run_scan(local_w, schedule: LocalSchedule, *, local_train_fn,
                   train_ctx=None):
    """Fully-local counterpart of ``safa_run_scan``: train + survivor
    masking, no global model in the carry (the caller aggregates at eval
    points).  Returns the new local stack."""
    for r, args in _rounds(schedule, train_ctx):
        local_w = local_only_round(local_w, completed=r.completed,
                                   local_train_fn=local_train_fn,
                                   train_args=args)
    return local_w


def fedasync_run_scan(global_w, local_w, schedule: AsyncSchedule, *,
                      local_train_fn, train_ctx=None):
    """FedAsync counterpart of ``safa_run_scan``: each round's
    arrival-ordered server merges replay the schedule's precomputed merge
    order and mixing weights (``fedasync_merge``).
    Returns (new_global, new_local)."""
    for r, args in _rounds(schedule, train_ctx):
        global_w, local_w = fedasync_round(
            global_w, local_w, committed=r.committed, order=r.order,
            alphas=r.alphas, local_train_fn=local_train_fn, train_args=args)
    return global_w, local_w


def weighted_run_scan(global_w, local_w, schedule: WeightedSchedule, *,
                      local_train_fn, use_kernel=False, wire='f32',
                      train_ctx=None):
    """Weighted-merge counterpart of ``safa_run_scan``, for a run's
    segment or a fleet's: the whole aggregation scheme lives in the
    schedule's weight rows, so every scheme of the staleness-adaptive
    family (and, on a fleet, any mix of them across members) replays
    through this one engine.  Under ``use_kernel='packed'`` each round
    launches the merge kernel once (its fleet form for all S members).
    Returns (new_global, new_local)."""
    for r, args in _rounds(schedule, train_ctx):
        global_w, local_w = weighted_round(
            global_w, local_w, committed=r.committed, wrow=r.wrow,
            local_train_fn=local_train_fn, train_args=args,
            use_kernel=use_kernel, wire=wire)
    return global_w, local_w


# ---------------------------------------------------------------------------
# Baseline numeric rounds
# ---------------------------------------------------------------------------

def fedavg_round(global_w, local_w, *, selected, completed, weights,
                 local_train_fn, train_args=(), wire: str = 'f32'):
    """FedAvg: selected clients sync + train; aggregate over the selected
    clients that committed (renormalised weights); everyone else idles.
    ``wire='int8'`` ships the uploads through the packed int8 wire
    (``ops.wire_roundtrip_packed``: one quantise and one dequantise launch
    for the whole stacked model), so the server aggregates what a
    compressed transfer delivers.  Returns (new_global, new_local)."""
    check_wire(wire)
    base = distribute(global_w, local_w, selected)
    trained = local_train_fn(base, *train_args)
    return fedavg_server_step(base, trained, global_w, selected=selected,
                              completed=completed, weights=weights, wire=wire)


def fedavg_server_step(base, trained, global_w, *, selected, completed,
                       weights, wire: str = 'f32'):
    """FedAvg's server math after local training: the wire transfer, the
    aggregation over the selected clients that committed (weights
    renormalised over them; the global stays when none did) and the local
    sync; for one run or a fleet ([S, m] masks).
    Returns (new_global, new_local)."""
    if wire == 'int8':
        from repro_torch.kernels import ops as kops
        trained = kops.wire_roundtrip_packed_fleet(trained, global_w) \
            if selected.ndim == 2 \
            else kops.wire_roundtrip_packed(trained, like=global_w)
    ok = selected & completed
    axis = ok.ndim - 1                  # the clients axis
    wsum = torch.clamp_min(torch.sum(weights * ok, dim=axis, keepdim=True),
                           1e-12)
    eff_w = torch.where(ok, weights, 0.0) / wsum
    any_ok = torch.sum(ok, dim=axis) > 0

    def red(t, g):
        if isinstance(g, dict):
            return {k: red(t[k], v) for k, v in g.items()}
        agg = torch.sum(t.float() * _bmask(eff_w, t).float(), dim=axis)
        return torch.where(_bmask(any_ok, agg), agg, g.float()).to(g.dtype)

    new_global = red(trained, global_w)
    return new_global, masked_select(ok, trained, base)


def local_only_round(local_w, *, completed, local_train_fn, train_args=()):
    """Fully-local baseline: train, never aggregate."""
    trained = local_train_fn(local_w, *train_args)
    return masked_select(completed, trained, local_w)


def fedasync_merge(global_w, trained, *, order, alphas):
    """FedAsync (Xie et al.) server: merge the updates one by one in
    arrival order with staleness-scaled mixing,

        w <- (1 - alpha_k) w + alpha_k w'_k

    trained: stacked [(S,) m, ...]; order: [(S,) m] arrival permutation;
    alphas: [(S,) m] mixing weight per client (0 for non-commits).  The m
    merges run in sequence, as in the JAX package (never folded into one
    weighted sum: that is another float result).  Returns the post-merge
    global model."""
    fleet = order.ndim == 2
    if fleet:
        members = torch.arange(order.shape[0], device=order.device)[:, None]
        ordered = {k: v[members, order] for k, v in trained.items()}
        a_ord = torch.gather(alphas, 1, order).float()
    else:
        ordered = {k: v[order] for k, v in trained.items()}
        a_ord = alphas[order].float()
    new_global = {}
    for k, g in global_w.items():
        for j in range(order.shape[-1]):
            a = _bmask(a_ord[:, j], g) if fleet else a_ord[j]
            upd = ordered[k][:, j] if fleet else ordered[k][j]
            g = ((1.0 - a) * g.float() + a * upd.float()).to(g.dtype)
        new_global[k] = g
    return new_global


def fedasync_round(global_w, local_w, *, committed, order, alphas,
                   local_train_fn, train_args=()):
    """One FedAsync round: every client trains, crashed or late clients
    are masked out, the server merges the arrivals one by one
    (``fedasync_merge``), and committed clients pull the fresh global
    model.  Returns (new_global, new_local)."""
    trained = local_train_fn(local_w, *train_args)
    trained = masked_select(committed, trained, local_w)
    new_global = fedasync_merge(global_w, trained, order=order, alphas=alphas)
    return new_global, masked_select(committed, _tile(new_global, committed),
                                     local_w)


# ---------------------------------------------------------------------------
# Weighted-merge engine: the staleness-adaptive aggregation family
# ---------------------------------------------------------------------------
#
# SEAFL-style adaptive weighting, CSAFL-style per-cluster semi-async
# aggregation and (through an exact host-side fold of the sequential merge
# recursion) the FedAsync s(dt) discount family all lower to one schedule
# representation: a precomputed [rounds, m] weight row ``wrow`` with
#
#     new_global = (1 - sum(wrow)) * global + sum_k wrow[k] * trained_k
#
# The row is zero off the committed set, so one round body replays every
# scheme of the family.  Cluster structure (CSAFL) folds in host-side:
# wrow[k] = alpha_g * what_k, alpha_g being cluster g's mixing
# coefficient and what_k the intra-cluster weight, so the kernel computes
# the masked per-cluster sub-aggregates through the weight operand.

def weighted_merge(global_w, trained, *, wrow, use_kernel=False):
    """One-shot weighted server merge:

        w <- (1 - sum_k wrow_k) w + sum_k wrow_k w'_k

    trained: stacked [(S,) m, ...]; wrow: [(S,) m] f32 effective merge
    weight per client (0 for non-commits; each row sums to <= 1).
    ``use_kernel='packed'`` packs the model and launches the merge kernel
    once (``ops.weighted_merge_tree_packed``, or its fleet form on [S, m]
    rows).  Returns the post-merge global model."""
    if use_kernel == 'packed':
        from repro_torch.kernels import ops as kops
        merge = kops.weighted_merge_tree_packed_fleet if wrow.ndim == 2 \
            else kops.weighted_merge_tree_packed
        return merge(trained, global_w, wrow=wrow)
    axis = wrow.ndim - 1                # the clients axis
    w = wrow.float()
    residual = 1.0 - torch.sum(w, dim=axis)

    def mix(g, t):
        agg = torch.sum(t.float() * _bmask(w, t), dim=axis)
        return (_bmask(residual, agg) * g.float() + agg).to(g.dtype)
    return {k: mix(g, trained[k]) for k, g in global_w.items()}


def weighted_server_step(trained, global_w, *, committed, wrow,
                         use_kernel=False, wire: str = 'f32'):
    """The weighted-merge server's work after local training, for one run
    or a fleet ([S, m] masks): ``wire='int8'`` round-trips the uploads
    through the packed int8 wire (``ops.wire_roundtrip_packed``: two
    launches) so the server merges what a compressed transfer delivers,
    then the one-shot merge, then committed clients pull the fresh
    global.  Non-commits never upload: they keep their un-quantised rows
    of ``trained``.  Returns (new_global, new_local)."""
    uploads = trained
    if wire == 'int8':
        from repro_torch.kernels import ops as kops
        uploads = kops.wire_roundtrip_packed_fleet(trained, global_w) \
            if committed.ndim == 2 \
            else kops.wire_roundtrip_packed(trained, like=global_w)
    new_global = weighted_merge(global_w, uploads, wrow=wrow,
                                use_kernel=use_kernel)
    return new_global, masked_select(committed, _tile(new_global, committed),
                                     trained)


def weighted_round(global_w, local_w, *, committed, wrow, local_train_fn,
                   train_args=(), use_kernel=False, wire: str = 'f32'):
    """One weighted-merge round: every client trains from its local model,
    crashed or late clients are masked out, the server applies the
    precomputed weight row in one merge (``weighted_server_step``), and
    committed clients pull the fresh global model; non-commits keep
    their stale copy, which is what makes the precomputed staleness
    meaningful.  Returns (new_global, new_local)."""
    check_wire(wire)
    trained = local_train_fn(local_w, *train_args)
    trained = masked_select(committed, trained, local_w)
    return weighted_server_step(trained, global_w, committed=committed,
                                wrow=wrow, use_kernel=use_kernel, wire=wire)


# ---------------------------------------------------------------------------
# Sparse active-set schedules: train and aggregate only the K active rows
# ---------------------------------------------------------------------------
#
# A sparse schedule (``schedules.SparseSchedule``/``SparseSyncSchedule``)
# names each round's active clients, [k, K] int32 indices padded with the
# sentinel m, and a uint8 role bitmask per slot.  Two execution modes
# consume it:
#
#   * 'sparse' (exact): train only the K active rows, scatter them into the
#     dense stacks, then run the dense server step (``safa_server_step``/
#     ``fedavg_server_step``) unchanged, kernels included.  Local training,
#     the dominant cost, drops from m replicas to K; the carried state
#     stays [m, N].
#   * 'sparse_delta': keep a running aggregate ``agg = sum_k w_k cache_k``
#     and update it from the K active rows only, O(K N) per round; for the
#     stateless protocols (FedAvg/FedCS) no [m, N] buffer exists at all.
#     Equal to dense up to float summation order.
#
# Sentinel slots (idx == m) carry no role and no weight.  The JAX package
# leans on jit's out-of-range rules there (gathers clamp, scatters with
# mode='drop' drop); torch indexing would raise or read past the end, so
# the helpers below clamp gathers and redirect scatters explicitly.
#
# A fleet's round carries [S, K] slots, [S, m] weights and [S, m, ...]
# stacks: the helpers gather and scatter at (member, row) and reduce over
# the slot axis, so one round body serves a run and a fleet, and member
# s's numbers are those of its own run.  The JAX package vmaps the
# single-run round instead.

# SAFA per-slot role bits (a slot may carry several: picked implies
# committed, deprecated clients are also synced, ...)
ROLE_SYNC = 1
ROLE_COMMITTED = 2
ROLE_PICKED = 4
ROLE_UNDRAFTED = 8
ROLE_DEPRECATED = 16

# synchronous-protocol (FedAvg/FedCS) role bits
SROLE_SELECTED = 1
SROLE_COMPLETED = 2


class SparseRoundSchedule(NamedTuple):
    """SAFA sparse per-round schedule: ``idx`` [k, K] int32 active-set row
    indices (sentinel m pads unused slots), ``roles`` [k, K] uint8 ROLE_*
    bitmasks, ``round_idx`` [k]; a fleet's [S, k, K] and [S, k]."""
    idx: Any
    roles: Any
    round_idx: Any
    segment = _segment
    fleet_segment = _fleet_segment


class SparseSyncSchedule(NamedTuple):
    """FedAvg/FedCS sparse per-round schedule: ``idx`` [k, K] int32
    selected row indices (sentinel m), ``roles`` [k, K] uint8 SROLE_*
    bitmasks, ``round_idx`` [k]; a fleet's [S, k, K] and [S, k]."""
    idx: Any
    roles: Any
    round_idx: Any
    segment = _segment
    fleet_segment = _fleet_segment


def has_role(roles, bit):
    """Per-slot bool mask for one ROLE_*/SROLE_* bit."""
    return (roles & bit) != 0


def _at(idx):
    """The member index for advanced indexing at a round's slots: () for a
    run's [K] slots, (arange(S)[:, None],) for a fleet's [S, K]."""
    if idx.ndim == 1:
        return ()
    return (torch.arange(idx.shape[0], device=idx.device)[:, None],)


def scatter_masks(idx, roles, m: int, bits):
    """Dense [(S,) m] bool masks from one round's (idx, roles), one per
    bit in ``bits``, equal to the dense precompute's masks.  Sentinel
    slots (idx == m) write into a scratch entry that is cut off (a
    fleet's masks are then copied out contiguous, as the kernels take
    them)."""
    lead = tuple(idx.shape[:-1])
    out = []
    for b in bits:
        mask = torch.zeros(lead + (m + 1,), dtype=torch.bool,
                           device=idx.device)
        mask[_at(idx) + (idx.long(),)] = has_role(roles, b)
        out.append(mask[..., :m].contiguous())
    return tuple(out)


def _clamp_rows(idx, m: int):
    """Gather indices with the sentinel m clamped to the last real row, as
    jit clamps them in the JAX package; gathered sentinel rows are
    garbage by contract and the role bits mask them."""
    return idx.clamp(max=m - 1).long()


def tree_gather(tree: dict, idx) -> dict:
    """Rows ``idx`` of every [(S,) m, ...] leaf (sentinels clamped):
    [(S,) K, ...] leaves."""
    axis = idx.ndim - 1                 # the clients axis
    return {k: a[_at(idx) + (_clamp_rows(idx, a.shape[axis]),)]
            for k, a in tree.items()}


def tree_scatter(tree: dict, idx, rows: dict) -> dict:
    """``tree`` with its rows ``idx`` replaced by ``rows`` [(S,) K, ...],
    in a new tree (the input may be a broadcast view); sentinel slots
    (idx == m) land in a scratch row, one per member, that is cut off, as
    the JAX package's ``mode='drop'`` drops them."""
    axis = idx.ndim - 1
    out = {}
    for k, a in tree.items():
        m = a.shape[axis]
        buf = torch.cat([a, a.narrow(axis, 0, 1)], dim=axis)  # [(S,) m+1,..]
        buf[_at(idx) + (idx.long(),)] = rows[k].to(a.dtype)
        out[k] = buf.narrow(axis, 0, m)
    return out


def _slot_weights(idx, weights):
    """Aggregation weight per slot, 0 at sentinel slots ([(S,) K] from
    [(S,) m] weights)."""
    m = weights.shape[-1]
    return torch.where(idx < m, weights[_at(idx) + (_clamp_rows(idx, m),)],
                       0.0).float()


def init_aggregate(cache: dict, weights) -> dict:
    """The running aggregate carried by the sparse_delta engines:
    ``agg = sum_k w_k cache_k`` as f32 global-shaped leaves ([(S,) ...]),
    computed once at run start from the dense cache."""
    axis = weights.ndim - 1             # the clients axis

    def red(leaf):
        return torch.sum(leaf.float() * _bmask(weights, leaf).float(),
                         dim=axis)
    return {k: red(v) for k, v in cache.items()}


def _delta(a, new, old, w):
    """a + sum_slots w (new - old), in f32 (w: [(S,) K] slot weights)."""
    return a + torch.sum((new.float() - old.float()) * _bmask(w, new),
                         dim=w.ndim - 1)


def safa_round_sparse(global_w, local_w, cache, *, idx, roles, weights,
                      local_train_fn, train_args=(), use_kernel=False,
                      wire: str = 'f32'):
    """One SAFA round from a sparse schedule, equal to ``safa_round`` on
    the dense masks that (idx, roles) encode.  Only the K active rows are
    trained (``local_train_fn(base_rows, rows, *train_args)``, the
    rows-train contract of ``Task.local_train_rows``); the trained rows
    are scattered over the dense base stack and the dense server step
    runs unchanged; on a fleet's round ([S, K] slots) the rows-train
    contract takes [S, K, ...] replicas and [S, K] rows
    (``Task.local_train_rows_fleet``).
    Returns (new_global, new_local, new_cache)."""
    check_wire(wire)
    m = weights.shape[-1]
    sync_mask, completed, picked, undrafted, deprecated = scatter_masks(
        idx, roles, m, (ROLE_SYNC, ROLE_COMMITTED, ROLE_PICKED,
                        ROLE_UNDRAFTED, ROLE_DEPRECATED))
    base = distribute(global_w, local_w, sync_mask)
    trained_rows = local_train_fn(tree_gather(base, idx), idx, *train_args)
    trained = tree_scatter(base, idx, trained_rows)
    return safa_server_step(
        base, trained, cache, global_w, completed=completed, picked=picked,
        undrafted=undrafted, deprecated=deprecated, weights=weights,
        use_kernel=use_kernel, wire=wire)


def safa_round_sparse_delta(global_w, local_w, cache, agg, *, idx, roles,
                            weights, local_train_fn, train_args=(),
                            wire: str = 'f32'):
    """One SAFA round as deltas on the carried running aggregate
    ``agg = sum_k w_k cache_k``:

        new_global = agg + sum_slots w (c1 - c_old)      (Eq. 6 + 7)
        new_agg    = new_global + sum_slots w (c2 - c1)  (Eq. 8)

    Only the active cache and local rows are gathered and trained, and
    only they change.  Equal to the dense round up to float summation
    order.  Returns (new_global, new_local, new_cache, new_agg)."""
    check_wire(wire)
    new_global, new_agg, trained_rows, c2_rows = _delta_slots(
        global_w, agg, tree_gather(local_w, idx), tree_gather(cache, idx),
        idx=idx, roles=roles, weights=weights,
        local_train_fn=local_train_fn, train_args=train_args, wire=wire)
    return (new_global, tree_scatter(local_w, idx, trained_rows),
            tree_scatter(cache, idx, c2_rows), new_agg)


def _delta_slots(global_w, agg, stale_rows, c_rows, *, idx, roles, weights,
                 local_train_fn, train_args, wire):
    """The slot math the ``'sparse_delta'`` and lag-tier rounds share, on
    the K slots' gathered rows: the base rows (the global where the slot
    syncs, ``stale_rows`` elsewhere) are trained, then Eq. 6-8 move the
    running aggregate by the slots' rows alone.  ``c_rows`` are the slots'
    cache rows.  Returns (new_global, new_agg, trained_rows, c2_rows)."""
    fleet = idx.ndim == 2
    sync_r = has_role(roles, ROLE_SYNC)
    com_r = has_role(roles, ROLE_COMMITTED)
    pick_r = has_role(roles, ROLE_PICKED)
    und_r = has_role(roles, ROLE_UNDRAFTED)
    dep_r = has_role(roles, ROLE_DEPRECATED)
    g_rows = broadcast_global(global_w, idx.shape[-1], fleet=fleet)
    base_rows = masked_select(sync_r, g_rows, stale_rows)
    trained_rows = local_train_fn(base_rows, idx, *train_args)
    if wire == 'int8':
        trained_rows = _wire_roundtrip(trained_rows, global_w, fleet)
    trained_rows = masked_select(com_r, trained_rows, base_rows)
    w_rows = _slot_weights(idx, weights)
    # Eq. 6 on the active rows only
    c1_rows = masked_select(dep_r & ~pick_r, g_rows, c_rows)
    c1_rows = masked_select(pick_r, trained_rows, c1_rows)
    # Eq. 7: the weighted sum moves by the rows that changed
    agg1 = {n: _delta(a, c1_rows[n], c_rows[n], w_rows)
            for n, a in agg.items()}
    new_global = {n: agg1[n].to(g.dtype) for n, g in global_w.items()}
    # Eq. 8: undrafted arrivals enter the cache for the next round
    c2_rows = masked_select(und_r, trained_rows, c1_rows)
    new_agg = {n: _delta(a, c2_rows[n], c1_rows[n], w_rows)
               for n, a in agg1.items()}
    return new_global, new_agg, trained_rows, c2_rows


def fedavg_round_sparse(global_w, local_w, *, idx, roles, weights,
                        local_train_fn, train_args=(), wire: str = 'f32'):
    """FedAvg/FedCS round from a sparse schedule, equal to
    ``fedavg_round``: train the selected rows only, scatter, then run the
    dense server step.  Returns (new_global, new_local)."""
    check_wire(wire)
    m = weights.shape[-1]
    selected, completed = scatter_masks(idx, roles, m,
                                        (SROLE_SELECTED, SROLE_COMPLETED))
    base = distribute(global_w, local_w, selected)
    trained_rows = local_train_fn(tree_gather(base, idx), idx, *train_args)
    trained = tree_scatter(base, idx, trained_rows)
    return fedavg_server_step(base, trained, global_w, selected=selected,
                              completed=completed, weights=weights, wire=wire)


def fedavg_round_sparse_delta(global_w, *, idx, roles, weights,
                              local_train_fn, train_args=(),
                              wire: str = 'f32'):
    """Stateless FedAvg/FedCS round: selected clients always sync to the
    global model and a client's local model never feeds back into the
    aggregate (its next selection overwrites it), so no [m, N] local
    stack exists: the global model is the whole carry.  Equal to the dense
    round up to float summation order; on a fleet's round, each member's
    weights are normalised over its own slots.  Returns new_global."""
    check_wire(wire)
    fleet = idx.ndim == 2
    axis = idx.ndim - 1                 # the slot axis
    com_r = has_role(roles, SROLE_COMPLETED) & (idx < weights.shape[-1])
    base_rows = broadcast_global(global_w, idx.shape[-1], fleet=fleet)
    trained_rows = local_train_fn(base_rows, idx, *train_args)
    if wire == 'int8':
        trained_rows = _wire_roundtrip(trained_rows, global_w, fleet)
    w_rows = torch.where(com_r, _slot_weights(idx, weights), 0.0)
    eff_w = w_rows / torch.clamp_min(
        torch.sum(w_rows, dim=axis, keepdim=True), 1e-12)
    any_ok = torch.sum(com_r, dim=axis) > 0

    def red(t, g):
        agg = torch.sum(t.float() * _bmask(eff_w, t), dim=axis)
        return torch.where(_bmask(any_ok, agg), agg,
                           g.float()).to(g.dtype)
    return {n: red(trained_rows[n], g) for n, g in global_w.items()}


def _wire_roundtrip(rows: dict, global_w: dict, fleet: bool) -> dict:
    """The K slots' uploads ([(S,) K, ...] leaves) through the packed int8
    wire: two launches, for the whole fleet on a fleet."""
    from repro_torch.kernels import ops as kops
    if fleet:
        return kops.wire_roundtrip_packed_fleet(rows, global_w)
    return kops.wire_roundtrip_packed(rows, like=global_w)


def safa_run_scan_sparse(global_w, local_w, cache,
                         schedule: SparseRoundSchedule, weights, *,
                         local_train_fn, use_kernel=False, wire='f32'):
    """Sparse-schedule counterpart of ``safa_run_scan``, for a run's
    segment or a fleet's: equal to the dense engine on the masks the
    schedule encodes, local training over the K active rows (a fleet's:
    one call over all S * K).  ``local_train_fn`` follows the rows-train
    contract.  Returns (new_global, new_local, new_cache)."""
    for r, args in _rounds(schedule):
        global_w, local_w, cache = safa_round_sparse(
            global_w, local_w, cache, idx=r.idx, roles=r.roles,
            weights=weights, local_train_fn=local_train_fn, train_args=args,
            use_kernel=use_kernel, wire=wire)
    return global_w, local_w, cache


def safa_run_scan_sparse_delta(global_w, local_w, cache, agg,
                               schedule: SparseRoundSchedule, weights, *,
                               local_train_fn, wire='f32'):
    """O(K N)-per-round SAFA engine over a run's segment or a fleet's:
    carries (global, local, cache, agg) with ``agg = init_aggregate(cache,
    weights)`` at run start.  Returns (new_global, new_local, new_cache,
    new_agg)."""
    for r, args in _rounds(schedule):
        global_w, local_w, cache, agg = safa_round_sparse_delta(
            global_w, local_w, cache, agg, idx=r.idx, roles=r.roles,
            weights=weights, local_train_fn=local_train_fn, train_args=args,
            wire=wire)
    return global_w, local_w, cache, agg


def fedavg_run_scan_sparse(global_w, local_w, schedule: SparseSyncSchedule,
                           weights, *, local_train_fn, wire='f32'):
    """Sparse-schedule counterpart of ``fedavg_run_scan`` (a run's segment
    or a fleet's; equal to the dense engine, training the selected rows
    only).  Returns (new_global, new_local)."""
    for r, args in _rounds(schedule):
        global_w, local_w = fedavg_round_sparse(
            global_w, local_w, idx=r.idx, roles=r.roles, weights=weights,
            local_train_fn=local_train_fn, train_args=args, wire=wire)
    return global_w, local_w


def fedavg_run_scan_sparse_delta(global_w, schedule: SparseSyncSchedule,
                                 weights, *, local_train_fn, wire='f32'):
    """Stateless FedAvg/FedCS engine over a run's segment or a fleet's: the
    global model is the whole carry, so device memory is O(N + K N) a
    member, whatever m.  Returns new_global."""
    for r, args in _rounds(schedule):
        global_w = fedavg_round_sparse_delta(
            global_w, idx=r.idx, roles=r.roles, weights=weights,
            local_train_fn=local_train_fn, train_args=args, wire=wire)
    return global_w


# -- packed sparse-delta engine: rows kernels on resident pack buffers ------

def safa_round_sparse_delta_packed(gbuf, lbuf, cbuf, abuf, *, idx, roles,
                                   weights, local_train_fn, train_args=(),
                                   spec, wire: str = 'f32'):
    """One O(K N) SAFA round on pack buffers, the aggregation fused.

    gbuf [N] f32 global pack; lbuf/cbuf [m+1, N] local and cache packs
    (the trailing scratch row absorbs the sentinel slots); abuf [N] f32
    running aggregate.  The active rows go ``gather_rows`` (kernel 11) ->
    unpack -> rows-train -> repack -> one ``safa_aggregate_packed_rows``
    launch (kernel 15: Eq. 6-8 and both delta sums) -> two
    ``scatter_rows`` launches (kernel 12) that write the cache and local
    rows back into ``cbuf`` and ``lbuf`` in place: the carried buffers are
    updated, not copied.  Under ``wire='int8'`` the repacked rows are
    block-quantised (``quantize_packed``, kernel 2) and the q8 rows kernel
    (kernel 16) dequantises them in registers; ``spec`` is then the
    QBLOCK-aligned ``wire_spec``.  Four launches a round on f32, five on
    int8.  Equal to ``safa_round_sparse_delta`` up to summation order.

    A fleet's round ([S, K] slots) carries gbuf/abuf [S, N] and lbuf/cbuf
    [S, m+1, N], each member with its own scratch row, and launches the
    fleet forms once each for all S members: ``gather_rows_fleet``
    (kernel 13), ``safa_aggregate_packed_rows_fleet`` or its int8 form
    after ``quantize_packed_fleet`` (kernels 17, 18, 8) and
    ``scatter_rows_fleet`` twice (kernel 14).
    Returns (gbuf', lbuf, cbuf, abuf')."""
    check_wire(wire)
    from repro_torch.kernels import ops as kops
    fleet = idx.ndim == 2
    if fleet:
        gather, scatter = kops.gather_rows_fleet, kops.scatter_rows_fleet
        quantize = kops.quantize_packed_fleet
        rows_agg = kops.safa_aggregate_packed_rows_fleet
        q8_rows_agg = kops.safa_aggregate_packed_q8_rows_fleet
        pack, unpack = kops.pack_fleet, kops.unpack_fleet
    else:
        gather, scatter = kops.gather_rows, kops.scatter_rows
        quantize = kops.quantize_packed
        rows_agg = kops.safa_aggregate_packed_rows
        q8_rows_agg = kops.safa_aggregate_packed_q8_rows
        pack, unpack = kops.pack_stacked, kops.unpack_stacked
    w_rows = _slot_weights(idx, weights)
    l_rows = gather(lbuf, idx)
    base_rows = torch.where(has_role(roles, ROLE_SYNC)[..., None],
                            gbuf[..., None, :], l_rows)
    trained = pack(local_train_fn(unpack(base_rows, spec), idx, *train_args),
                   spec)
    if wire == 'int8':
        q, scales = quantize(trained)
        ng, na, c2_rows, local_rows = q8_rows_agg(
            q, scales, base_rows, cbuf, gbuf, abuf, idx, roles, w_rows)
    else:
        local_rows = torch.where(
            has_role(roles, ROLE_COMMITTED)[..., None], trained, base_rows)
        ng, na, c2_rows = rows_agg(cbuf, local_rows, gbuf, abuf, idx, roles,
                                   w_rows)
    scatter(cbuf, idx, c2_rows)
    scatter(lbuf, idx, local_rows)
    return ng, lbuf, cbuf, na


def safa_run_scan_sparse_delta_packed(gbuf, lbuf, cbuf, abuf,
                                      schedule: SparseRoundSchedule,
                                      weights, *, local_train_fn, spec,
                                      wire='f32'):
    """Packed-buffer counterpart of ``safa_run_scan_sparse_delta``: the
    carry is (global [N], local [m+1, N], cache [m+1, N], agg [N]) pack
    buffers (a fleet's: [S, N] and [S, m+1, N]), the local and cache
    buffers updated in place; ``spec`` is one member's pack layout
    (``ops.wire_spec`` under ``wire='int8'``, ``ops.pack_spec``
    otherwise).  Returns (gbuf, lbuf, cbuf, abuf)."""
    for r, args in _rounds(schedule):
        gbuf, lbuf, cbuf, abuf = safa_round_sparse_delta_packed(
            gbuf, lbuf, cbuf, abuf, idx=r.idx, roles=r.roles,
            weights=weights, local_train_fn=local_train_fn, train_args=args,
            spec=spec, wire=wire)
    return gbuf, lbuf, cbuf, abuf


# -- lag-tier engine: a version ring and an active slab, no [m, N] stacks --
#
# SAFA's lag-tolerant distribution (Eq. 2-3) bounds every client's lag by
# tau, and a committed client is force-synced the next round it appears,
# so a trained local row is never read back and every base model a round
# reads is a global version snapshot (at most tau + 2 live at once); the
# cache rows are such snapshots or commit rows of recently active clients.
# The tier round therefore carries one value buffer ``buf`` of
# ``capacity + 1`` rows (capacity = the peak number of live distinct rows,
# O(tau + quota); the last row is scratch) and replays the host's slot
# maps (``schedules.TierSchedule``): it gathers bases at ``base_src`` and
# caches at ``cache_src``, runs the ``'sparse_delta'`` slot math, writes
# the new cache rows to ``cache_dst`` and the round's global to
# ``global_dst``.  Within a round the written slots are disjoint from the
# read slots, scratch apart, which lets the tier kernels write the buffer
# in place.  Memory: O((tau + quota) N), whatever m.  The slot maps index
# the buffer directly (its scratch row is slot ``capacity``): the sentinel
# of the ``[m + 1, N]`` sparse buffers plays no part.

class TierRoundSchedule(NamedTuple):
    """SAFA lag-tier per-round schedule: ``idx``/``roles`` as in
    ``SparseRoundSchedule``, the slot maps ``base_src``, ``cache_src``,
    ``cache_dst`` [k, K] int32 and ``global_dst`` [k] int32, and
    ``round_idx`` [k]; a fleet's [S, k, K], [S, k] and [S, k]."""
    idx: Any
    roles: Any
    base_src: Any
    cache_src: Any
    cache_dst: Any
    global_dst: Any
    round_idx: Any
    segment = _segment
    fleet_segment = _fleet_segment


def _write_global(buf, global_dst, g) -> None:
    """Write the round's global ``g`` ([(S,) N]) into the buffer's row
    ``global_dst`` ([] for a run, [S] for a fleet), in place: one row per
    member."""
    if global_dst.ndim == 1:
        members = torch.arange(global_dst.shape[0], device=buf.device)
        buf[members, global_dst.long()] = g.to(buf.dtype)
    else:
        # a [1] index, not a 0-d one: indexing by a 0-d tensor reads it
        # back to the host
        buf.index_copy_(0, global_dst.long().reshape(1),
                        g.to(buf.dtype)[None])


def safa_round_sparse_tier(global_w, buf, agg, *, idx, roles, base_src,
                           cache_src, cache_dst, global_dst, weights,
                           local_train_fn, train_args=(), wire: str = 'f32'):
    """One SAFA round in O((tau + quota) N) through the lag-tier value
    buffer: the slot math of ``safa_round_sparse_delta`` on rows gathered
    through the slot maps instead of per-client stacks, so the two agree
    wherever both run.  ``buf`` (contiguous [(S,) capacity + 1, ...]
    leaves) is written in place, the new cache rows last-wins in slot
    order as the tier kernels write them.
    Returns (new_global, buf, new_agg)."""
    check_wire(wire)
    from repro_torch.kernels import ref
    new_global, new_agg, _, c2_rows = _delta_slots(
        global_w, agg, tree_gather(buf, base_src), tree_gather(buf, cache_src),
        idx=idx, roles=roles, weights=weights, local_train_fn=local_train_fn,
        train_args=train_args, wire=wire)
    lead = tuple(idx.shape[:-1])
    for n, b in buf.items():
        rows = b.view(lead + (b.shape[len(lead)], -1))
        ref.scatter_rows_ref(rows, cache_dst,
                             c2_rows[n].reshape(tuple(cache_dst.shape) + (-1,)))
        _write_global(rows, global_dst, new_global[n].reshape(lead + (-1,)))
    return new_global, buf, new_agg


def safa_run_scan_sparse_tier(global_w, buf, agg,
                              schedule: TierRoundSchedule, weights, *,
                              local_train_fn, wire='f32'):
    """Lag-tier SAFA engine over a run's segment or a fleet's: carries
    (global, value buffer, agg), the buffer's every row the initial global
    and ``agg = global * sum(weights)`` at run start (every cache row
    starts as the initial global).  No [m, N] stack exists anywhere.
    Returns (new_global, buf, new_agg)."""
    for r, args in _rounds(schedule):
        global_w, buf, agg = safa_round_sparse_tier(
            global_w, buf, agg, idx=r.idx, roles=r.roles,
            base_src=r.base_src, cache_src=r.cache_src,
            cache_dst=r.cache_dst, global_dst=r.global_dst, weights=weights,
            local_train_fn=local_train_fn, train_args=args, wire=wire)
    return global_w, buf, agg


def safa_round_sparse_tier_packed(gbuf, tbuf, abuf, *, idx, roles, base_src,
                                  cache_src, cache_dst, global_dst, weights,
                                  local_train_fn, train_args=(), spec,
                                  wire: str = 'f32'):
    """One lag-tier round on pack buffers: gbuf [N] f32 global pack, tbuf
    [capacity + 1, N] value buffer, abuf [N] f32 running aggregate.

    The base rows go ``gather_rows`` (kernel 11) -> unpack -> rows-train
    -> repack -> one ``safa_aggregate_packed_tier_rows`` launch (kernel
    19: Eq. 6-8, both delta sums and the ``cache_dst`` write-back, in
    place in ``tbuf``); under ``wire='int8'`` the repacked rows are
    block-quantised (``quantize_packed``, kernel 2) and kernel 20
    dequantises them in registers.  The round's global then goes into row
    ``global_dst`` by an indexed copy, one row.  Two launches a round on
    f32, three on int8.  A fleet's round ([S, K] slots, gbuf/abuf [S, N],
    tbuf [S, capacity + 1, N]) launches the fleet forms once each for all
    S members (kernels 13, 8 and the S-axis forms of 19 and 20).
    Returns (gbuf', tbuf, abuf')."""
    check_wire(wire)
    from repro_torch.kernels import ops as kops
    if idx.ndim == 2:
        gather, quantize = kops.gather_rows_fleet, kops.quantize_packed_fleet
        tier = kops.safa_aggregate_packed_tier_rows_fleet
        q8_tier = kops.safa_aggregate_packed_q8_tier_rows_fleet
        pack, unpack = kops.pack_fleet, kops.unpack_fleet
    else:
        gather, quantize = kops.gather_rows, kops.quantize_packed
        tier = kops.safa_aggregate_packed_tier_rows
        q8_tier = kops.safa_aggregate_packed_q8_tier_rows
        pack, unpack = kops.pack_stacked, kops.unpack_stacked
    w_rows = _slot_weights(idx, weights)
    base_rows = torch.where(has_role(roles, ROLE_SYNC)[..., None],
                            gbuf[..., None, :], gather(tbuf, base_src))
    trained = pack(local_train_fn(unpack(base_rows, spec), idx, *train_args),
                   spec)
    if wire == 'int8':
        q, scales = quantize(trained)
        ng, na, tbuf = q8_tier(q, scales, base_rows, tbuf, gbuf, abuf,
                               cache_src, cache_dst, roles, w_rows)
    else:
        local_rows = torch.where(
            has_role(roles, ROLE_COMMITTED)[..., None], trained, base_rows)
        ng, na, tbuf = tier(tbuf, local_rows, gbuf, abuf, cache_src,
                            cache_dst, roles, w_rows)
    _write_global(tbuf, global_dst, ng)
    return ng, tbuf, na


def safa_run_scan_sparse_tier_packed(gbuf, tbuf, abuf,
                                     schedule: TierRoundSchedule, weights,
                                     *, local_train_fn, spec, wire='f32'):
    """Packed counterpart of ``safa_run_scan_sparse_tier``: the carry is
    three pack buffers, O((tau + quota) N) bytes (a fleet's: [S, N] and
    [S, capacity + 1, N]), the value buffer written in place; ``spec`` is
    one member's pack layout.  Returns (gbuf, tbuf, abuf)."""
    for r, args in _rounds(schedule):
        gbuf, tbuf, abuf = safa_round_sparse_tier_packed(
            gbuf, tbuf, abuf, idx=r.idx, roles=r.roles, base_src=r.base_src,
            cache_src=r.cache_src, cache_dst=r.cache_dst,
            global_dst=r.global_dst, weights=weights,
            local_train_fn=local_train_fn, train_args=args, spec=spec,
            wire=wire)
    return gbuf, tbuf, abuf

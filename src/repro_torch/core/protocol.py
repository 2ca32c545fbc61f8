"""SAFA numeric protocol algebra (Eq. 3, 6, 7, 8) on stacked client models.

Models are flat dicts of tensors; a stacked model carries a leading
clients dim of size m.  The server's cache (one entry per client) and the
bypass are masked updates: picked entries overwrite pre-aggregation
(Eq. 6), undrafted entries overwrite post-aggregation (Eq. 8).

A fleet of S independent runs carries one more leading axis: masks and
weights [S, m], stacked models [S, m, ...], globals [S, ...].  The algebra
reads the axes from the masks (``mask.ndim`` is 1 for a run, 2 for a
fleet), so one round body serves both, and a fleet member's numbers are
the single run's.

``safa_run_scan`` replays a device-resident segment of precomputed round
masks; ``safa_round`` is one round of it; ``safa_run_fleet`` runs a
fleet's segment, one round of all S members at a time.  The functions on
masks (``classify_versions``) work on numpy arrays and on tensors alike:
the host event process in ``core.federation`` calls them on numpy.
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
    return {k: torch.where(_bmask(mask, a[k]), a[k], b[k]) for k in a}


def broadcast_global(global_tree: dict, m: int, *, fleet: bool = False
                     ) -> dict:
    """Tile the global model across the clients dim (views, no copy):
    [...] -> [m, ...], or for a fleet [S, ...] -> [S, m, ...]."""
    if fleet:
        return {k: g[:, None].expand((g.shape[0], m) + tuple(g.shape[1:]))
                for k, g in global_tree.items()}
    return {k: g[None].expand((m,) + tuple(g.shape))
            for k, g in global_tree.items()}


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
        w = _bmask(weights, leaf).float()
        return torch.sum(leaf.float() * w, dim=axis).to(leaf.dtype)
    return {k: red(v) for k, v in cache.items()}


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

    def segment(self, start: int, stop: int) -> 'RoundSchedule':
        """Rounds [start, stop) as views of the resident schedule."""
        return RoundSchedule(*(a[start:stop] for a in self))

    def fleet_segment(self, start: int, stop: int) -> 'RoundSchedule':
        """Rounds [start, stop) of a fleet's [S, rounds, ...] schedule
        (the rounds axis is axis 1), as views."""
        return RoundSchedule(*(a[:, start:stop] for a in self))


def safa_run_scan(global_w, local_w, cache, schedule: RoundSchedule, weights,
                  *, local_train_fn, use_kernel=False, wire='f32'):
    """Run ``k = len(schedule.round_idx)`` SAFA rounds over a segment of
    the device-resident schedule.  Each round is the same ``safa_round``
    the per-round loop engine calls, on rows of the resident masks, so the
    two engines agree bit for bit.  ``round_idx`` rides along as a device
    scalar, like the JAX scan's traced index.
    Returns (new_global, new_local, new_cache)."""
    for i in range(schedule.round_idx.shape[0]):
        global_w, local_w, cache = safa_round(
            global_w, local_w, cache, sync_mask=schedule.sync[i],
            completed=schedule.completed[i], picked=schedule.picked[i],
            undrafted=schedule.undrafted[i],
            deprecated=schedule.deprecated[i], weights=weights,
            local_train_fn=local_train_fn,
            train_args=(schedule.round_idx[i],), use_kernel=use_kernel,
            wire=wire)
    return global_w, local_w, cache


def safa_run_fleet(global_w, local_w, cache, schedule: RoundSchedule, weights,
                   *, local_train_fn, use_kernel=False, wire='f32',
                   train_ctx=None):
    """Run S independent SAFA simulations over a segment of a fleet's
    device-resident schedule: masks [S, k, m], round indices [S, k],
    weights [S, m], stacked models [S, m, ...] and globals [S, ...].

    Each round is one ``safa_round`` on the whole fleet: one
    ``local_train_fn(base [S, m, ...], round_idx [S], *extra)`` call for
    all S * m client replicas, and one launch of each server kernel for
    all S members.  ``train_ctx`` (a per-member-task fleet's data) rides
    along as the extra train argument.  Member s's numbers are those of
    ``safa_run_scan`` on its own schedule.
    Returns (new_global, new_local, new_cache), each fleet-stacked."""
    # round-major [k, S, ...] so that each round's [S, m] masks are one
    # contiguous block, as the kernels take them
    rounds = RoundSchedule(*(a.transpose(0, 1).contiguous()
                             for a in schedule))
    extra = () if train_ctx is None else (train_ctx,)
    for i in range(rounds.round_idx.shape[0]):
        global_w, local_w, cache = safa_round(
            global_w, local_w, cache, sync_mask=rounds.sync[i],
            completed=rounds.completed[i], picked=rounds.picked[i],
            undrafted=rounds.undrafted[i], deprecated=rounds.deprecated[i],
            weights=weights, local_train_fn=local_train_fn,
            train_args=(rounds.round_idx[i],) + extra,
            use_kernel=use_kernel, wire=wire)
    return global_w, local_w, cache

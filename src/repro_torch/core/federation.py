"""The event processes of SAFA and the synchronous baselines on the host.

The protocol state machines (versions, commit flags, pending straggler
progress, selections) run in numpy: they drive the event simulator for
timing and crash draws and precompute a whole run as a [rounds, m] mask
schedule, because the event process never looks at model weights.
FedAsync's event pass lives in ``repro_torch.core.agg_schemes``.
Execution lives in ``repro_torch.core.protocol``; ``repro_torch.core.api``
wires specs, schedules and engines together.  The legacy free functions
(``run_safa`` & co., ``run_sweep``) are ``DeprecationWarning`` shims over
``repro_torch.api``, as in the JAX package.
"""
from __future__ import annotations

import sys
import warnings
from typing import Optional

import numpy as np

from repro_torch.core import protocol, schedules, selection
from repro_torch.core.schedules import (FleetSchedule, LocalSchedule,
                                        RoundRecord, SafaSchedule,
                                        SweepMember, SyncFleetSchedule,
                                        SyncSchedule)
from repro_torch.fedsim import Env
from repro_torch.kernels.comm_quant import dequantize_rows, quantize_rows

__all__ = ['FleetSchedule', 'LocalSchedule', 'PROTOCOLS', 'RUNNERS',
           'SweepMember', 'SyncFleetSchedule', 'SyncSchedule', 'Task',
           'precompute_fedasync_schedule', 'precompute_fleet_schedule',
           'precompute_local_schedule', 'precompute_safa_schedule',
           'precompute_sync_fleet_schedule', 'precompute_sync_schedule',
           'run_fedasync', 'run_fedavg', 'run_fedcs', 'run_local',
           'run_safa', 'run_sweep']


class Task:
    """A federated learning task: model init/train/eval, model-agnostic for
    the protocol layer.  ``local_train(stacked_params, round_idx)`` trains
    every client replica for E epochs (batched over the clients dim).

    ``round_idx`` is a Python int under ``engine='loop'`` and a 0-dim
    device tensor under the default ``'scan'`` engine; implementations
    must not branch on it.

    A task that a fleet sweep shares also implements
    ``local_train_fleet(fleet_params, round_idx)``: every member's client
    replicas ([S, m, ...] leaves) in one call, round_idx [S]; and, for a
    sweep on a sparse schedule, ``local_train_rows_fleet(params_rows,
    rows, round_idx)``: [S, K, ...] replicas of the clients ``rows``
    [S, K]."""

    #: the device the task's data lives on and its params are made on
    device = None

    def init_global(self, seed: int) -> dict:
        raise NotImplementedError

    def local_train(self, stacked_params: dict, round_idx) -> dict:
        raise NotImplementedError

    def local_train_rows(self, params_rows: dict, rows, round_idx) -> dict:
        """Sparse-schedule training: train only the K client replicas in
        ``params_rows`` ([K, ...] leaves), whose client ids are ``rows``
        ([K] int32 on the task's device; sentinel ids m are garbage rows
        whose output the engine discards).  Row for row, the same step
        ``local_train`` runs for those clients."""
        raise NotImplementedError(
            f'{type(self).__name__} does not implement local_train_rows; '
            f'sparse schedules need the rows-train contract')

    def local_train_rows_fleet(self, params_rows: dict, rows,
                               round_idx) -> dict:
        """``local_train_rows`` for a fleet: [S, K, ...] replicas, member
        s's replica k on client ``rows[s, k]``'s data."""
        raise NotImplementedError(
            f'{type(self).__name__} does not implement '
            f'local_train_rows_fleet; sparse sweeps need the rows-train '
            f'contract for a fleet')

    def evaluate(self, global_params: dict) -> dict:
        raise NotImplementedError


def _masked_var(values: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Population variance of ``values`` over ``mask`` along the last axis
    (0.0 where the mask is empty), as masked sums."""
    n = mask.sum(axis=-1)
    denom = np.maximum(n, 1)
    mean = np.sum(np.where(mask, values, 0), axis=-1) / denom
    dev = np.where(mask, (values - mean[..., None]) ** 2, 0.0)
    return np.where(n > 0, np.sum(dev, axis=-1) / denom, 0.0)


def _capped_round_len(arrival: np.ndarray, mask: np.ndarray,
                      t_lim: float) -> float:
    """Deadline-capped max arrival over ``mask``, ignoring non-finite
    entries; returns ``t_lim`` when nothing finite remains (e.g. every
    client crashed, arrival all inf) so inf never leaks into a
    RoundRecord."""
    live = arrival[mask]
    live = live[np.isfinite(live)]
    return min(t_lim, float(live.max())) if live.size else t_lim


def _sync_round_common(env, selected: np.ndarray, crashed: np.ndarray,
                       cfrac: np.ndarray, t_up: np.ndarray,
                       t_down: np.ndarray, full_tt: np.ndarray):
    """Shared FedAvg/FedCS timing: server waits for every selected client;
    a crash is detected when the client drops (at its partial-progress
    point), so the round ends at max(finish/drop times), capped at T_lim.

    ``t_up``/``t_down``/``full_tt`` are the round's [m] timing rows
    (``Env.round_timing``); with constant traces ``t_down + t_up`` equals
    the legacy ``2 * t_updown`` bitwise."""
    t_dist = env.t_dist(int(selected.sum()))
    finish = t_dist + (t_down + t_up) + full_tt
    drop = t_dist + t_down + cfrac * full_tt
    per_client = np.where(crashed, drop, finish)
    if selected.any():
        round_len = float(np.max(per_client[selected]))
    else:
        round_len = t_dist
    return min(env.t_lim, round_len), t_dist


def _sync_rounds_common(selected, crashed, cfrac, full_tt, *, t_lim,
                        t_up, t_down, msize, server_bw):
    """``_sync_round_common`` vectorised over stacked leading axes.

    selected/crashed/cfrac: [..., m] (e.g. [rounds, m] or [S, rounds, m]);
    the timing arrays must already broadcast against those shapes (for a
    fleet: full_tt/t_up/t_down [S, rounds, m] — or [S, 1, m] when no
    member carries traces — and msize/server_bw/t_lim [S, 1]).
    Bit-identical per round to the scalar helper: the masked max equals
    the compressed max, and every arithmetic expression keeps the scalar
    path's evaluation order ((t_down + t_up) == 2 * t_updown bitwise for
    constant traces).  Returns (round_len [...], t_dist [...])."""
    t_dist = selected.sum(axis=-1) * msize * 8.0 / server_bw
    finish = t_dist[..., None] + (t_down + t_up) + full_tt
    drop = t_dist[..., None] + t_down + cfrac * full_tt
    per_client = np.where(crashed, drop, finish)
    live_max = np.max(np.where(selected, per_client, -np.inf), axis=-1)
    round_len = np.where(selected.any(axis=-1), live_max, t_dist)
    return np.minimum(t_lim, round_len), t_dist


def precompute_safa_schedule(env: Env, *, fraction: float,
                             lag_tolerance: int, rounds: int,
                             form: str = 'dense'):
    """Run the SAFA timing/event state machine (Eq. 3 version bookkeeping,
    crash draws, CFCFM selection) for all rounds in one numpy host pass
    and return the dense [rounds, m] mask schedule with its records.
    Consumes ``env``'s rng exactly as the JAX package's precompute does,
    so both packages see the same events from the same ``EnvSpec``.

    ``form='sparse'`` returns a ``SparseSchedule`` instead: the same loop
    (same draws, selection and records), each round storing only its
    active set's (idx, roles), so host memory is O(m + rounds K); it
    equals ``precompute(form='dense').to_sparse()``.

    ``form='sparse_tier'`` also records each active client's base version
    (the ``v`` counter this loop keeps) and lowers the event stream to a
    ``TierSchedule``: the sparse rows plus the slot maps that let the
    engines carry one O(lag_tolerance + quota)-row value buffer instead of
    [m, N] local and cache stacks.  It equals
    ``precompute(form='dense').to_tier()``."""
    if form not in ('dense', 'sparse', 'sparse_tier'):
        raise ValueError(f"unknown form {form!r} (want 'dense', 'sparse', "
                         f"or 'sparse_tier')")
    m = env.m
    v = np.zeros(m, dtype=int)             # base-model versions
    committed_prev = np.ones(m, bool)      # round 1: everyone holds w(0)
    picked_prev = np.zeros(m, bool)
    pending = np.zeros(m)                  # straggler partial progress
    tim = env.round_timing(rounds)         # [rounds, m] trace/wire-aware
    work = env.n_batches * env.epochs      # per-round work units
    wasted = 0.0
    performed = 0.0
    crashed_all, cfrac_all = env.draw_rounds(rounds)
    masks = {k: np.zeros((rounds, m), bool)
             for k in ('sync', 'committed', 'picked', 'undrafted',
                       'deprecated')} if form == 'dense' else None
    sparse_rows = []
    base_v_rows = []
    records = []

    for t in range(1, rounds + 1):
        gv = t - 1
        up, dep, _ = protocol.classify_versions(v, gv, lag_tolerance,
                                                committed_prev)
        sync = up | dep
        # forced sync discards any pending straggler progress (futility)
        wasted += float(np.sum(np.where(sync, pending * work, 0.0)))
        pending[sync] = 0.0
        v[sync] = gv

        crashed, cfrac = crashed_all[t - 1], cfrac_all[t - 1]
        remaining = 1.0 - pending
        t_train = remaining * tim.full_tt[t - 1]
        t_dist = env.t_dist(int(sync.sum()))
        # every live client uploads; sync'd ones first download the global
        arrival = t_dist + (tim.t_up[t - 1] + sync * tim.t_down[t - 1]) \
            + t_train
        completed = ~crashed
        arrival = np.where(completed, arrival, np.inf)
        performed += float(np.sum(np.where(completed, remaining,
                                           cfrac * remaining) * work))
        base_versions = v.copy()

        sel = selection.cfcfm(arrival, completed, picked_prev, fraction,
                              env.t_lim)
        pending = np.where(crashed,
                           np.minimum(pending + cfrac * remaining, 0.999),
                           pending)
        pending[sel.committed] = 0.0
        v[sel.committed] = t

        if form == 'dense':
            i = t - 1
            masks['sync'][i] = sync
            masks['committed'][i] = sel.committed
            masks['picked'][i] = sel.picked
            masks['undrafted'][i] = sel.undrafted
            masks['deprecated'][i] = dep
        else:
            row = schedules.safa_sparse_row(
                sync, sel.committed, sel.picked, sel.undrafted, dep,
                bootstrap=(t == 1))
            sparse_rows.append(row)
            if form == 'sparse_tier':
                base_v_rows.append(base_versions[row[0]])

        records.append(RoundRecord(
            round=t,
            round_len=min(env.t_lim, sel.quota_met_time),
            t_dist=t_dist,
            eur=float(sel.picked.sum()) / m,
            sr=float(sync.sum()) / m,
            vv=float(_masked_var(base_versions, sel.committed)),
            n_picked=int(sel.picked.sum()),
            n_committed=int(sel.committed.sum()),
            n_crashed=int(crashed.sum()),
        ))
        committed_prev = sel.committed.copy()
        picked_prev = sel.picked.copy()

    futility = wasted / max(performed, 1e-9)
    if form == 'sparse_tier':
        return schedules.build_tier_schedule(m, sparse_rows, base_v_rows,
                                             records, futility)
    if form == 'sparse':
        idx, roles = schedules.pack_sparse_rows(sparse_rows, m)
        return schedules.SparseSchedule(m=m, idx=idx, roles=roles,
                                        records=records, futility=futility)
    return SafaSchedule(records=records, futility=futility, **masks)


# ---------------------------------------------------------------------------
# Fleet precompute: batched multi-seed / multi-config sweeps
# ---------------------------------------------------------------------------

def precompute_fleet_schedule(members, *, rounds: int) -> FleetSchedule:
    """Run S SAFA event state machines in one fleet-major host pass.

    Bit-identical to stacking S independent ``precompute_safa_schedule``
    calls, and to the JAX package's fleet precompute on the same members:
    each member's crash and straggler draws come from its own env rng,
    consumed exactly as a standalone precompute would, while the version
    bookkeeping and CFCFM selection run vectorised on [S, m] arrays
    (``selection.cfcfm_batch``)."""
    s_count = len(members)
    envs = [mem.env for mem in members]
    m = envs[0].m
    if any(e.m != m for e in envs):
        raise ValueError('fleet members must share the client count m')
    fraction = np.array([mem.fraction for mem in members], float)
    quota = np.maximum(1, np.rint(fraction * m).astype(int))
    lag = np.array([mem.lag_tolerance for mem in members])[:, None]
    t_lim = np.array([e.t_lim for e in envs])
    msize = np.array([e._dist_mb() for e in envs])
    server_bw = np.array([e.server_bw_mbps for e in envs])
    tims = [e.round_timing(rounds) for e in envs]
    work = np.stack([e.n_batches * e.epochs for e in envs])
    draws = [e.draw_rounds(rounds) for e in envs]
    crashed_all = np.stack([d[0] for d in draws])     # [S, rounds, m]
    cfrac_all = np.stack([d[1] for d in draws])

    v = np.zeros((s_count, m), dtype=int)
    committed_prev = np.ones((s_count, m), bool)
    picked_prev = np.zeros((s_count, m), bool)
    pending = np.zeros((s_count, m))
    wasted = np.zeros(s_count)
    performed = np.zeros(s_count)
    masks = {k: np.zeros((s_count, rounds, m), bool)
             for k in FleetSchedule.MASKS}
    # per-round [S] / [S, m] intermediates; the record stats vectorise
    # over rounds after the loop
    t_dist_l, quota_met_l, base_v_l = [], [], []

    for t in range(1, rounds + 1):
        gv = t - 1
        staleness = gv - v
        dep = ~committed_prev & (staleness >= lag)
        sync = committed_prev | dep
        wasted += np.sum(np.where(sync, pending * work, 0.0), axis=-1)
        pending = np.where(sync, 0.0, pending)
        v = np.where(sync, gv, v)

        crashed, cfrac = crashed_all[:, t - 1], cfrac_all[:, t - 1]
        remaining = 1.0 - pending
        t_up_r = np.stack([tt.t_up[t - 1] for tt in tims])
        t_down_r = np.stack([tt.t_down[t - 1] for tt in tims])
        t_train = remaining * np.stack([tt.full_tt[t - 1] for tt in tims])
        t_dist = sync.sum(axis=-1) * msize * 8.0 / server_bw
        arrival = t_dist[:, None] + (t_up_r + sync * t_down_r) \
            + t_train
        completed = ~crashed
        arrival = np.where(completed, arrival, np.inf)
        performed += np.sum(np.where(completed, remaining,
                                     cfrac * remaining) * work, axis=-1)
        base_versions = v.copy()

        sel = selection.cfcfm_batch(arrival, completed, picked_prev,
                                    fraction, t_lim, quota=quota)
        pending = np.where(crashed,
                           np.minimum(pending + cfrac * remaining, 0.999),
                           pending)
        pending = np.where(sel.committed, 0.0, pending)
        v = np.where(sel.committed, t, v)

        i = t - 1
        masks['sync'][:, i] = sync
        masks['committed'][:, i] = sel.committed
        masks['picked'][:, i] = sel.picked
        masks['undrafted'][:, i] = sel.undrafted
        masks['deprecated'][:, i] = dep
        t_dist_l.append(t_dist)
        quota_met_l.append(sel.quota_met_time)
        base_v_l.append(base_versions)
        committed_prev = sel.committed
        picked_prev = sel.picked

    # convert the stat arrays to Python scalars in bulk (.tolist())
    t_dist_a = np.stack(t_dist_l, axis=1).tolist()            # [S][rounds]
    round_len = np.minimum(t_lim[:, None],
                           np.stack(quota_met_l, axis=1)).tolist()
    n_picked = masks['picked'].sum(axis=-1).tolist()
    n_committed = masks['committed'].sum(axis=-1).tolist()
    n_crashed = crashed_all.sum(axis=-1).tolist()
    n_sync = masks['sync'].sum(axis=-1).tolist()
    vv = _masked_var(np.stack(base_v_l, axis=1),
                     masks['committed']).tolist()
    records = [[RoundRecord(
        round=i + 1,
        round_len=round_len[s][i],
        t_dist=t_dist_a[s][i],
        eur=n_picked[s][i] / m,
        sr=n_sync[s][i] / m,
        vv=vv[s][i],
        n_picked=n_picked[s][i],
        n_committed=n_committed[s][i],
        n_crashed=n_crashed[s][i],
    ) for i in range(rounds)] for s in range(s_count)]
    return FleetSchedule(records=records,
                         futility=wasted / np.maximum(performed, 1e-9),
                         **masks)


def precompute_sync_schedule(env: Env, *, fraction: float, rounds: int,
                             seed: int, fedcs: bool, form: str = 'dense',
                             sampler: str = 'choice'):
    """Host pass for the synchronous baselines (selection + crash draws).

    ``sampler`` picks the FedAvg selection stream: 'choice' is the legacy
    per-round ``Generator.choice`` draw; 'topk' is the vectorised
    without-replacement sampler (``selection.fedavg_select_topk``) whose
    bulk-uniform stream scales to large m.  FedCS selection is
    deterministic and ignores it.  Consumes ``env``'s rng and the
    selection rng (``seed + 1``) exactly as the JAX package's precompute
    does.  ``form='sparse'`` returns a ``SparseSyncSchedule`` (the same
    loop, compact per-round storage), equal to the dense precompute's
    ``.to_sparse()``."""
    if form not in ('dense', 'sparse'):
        raise ValueError(f"unknown form {form!r} (want 'dense' or 'sparse')")
    m = env.m
    rng = np.random.default_rng(seed + 1)
    tim = env.round_timing(rounds)         # [rounds, m] trace/wire-aware
    work = env.n_batches * env.epochs
    wasted = 0.0
    performed = 0.0
    crashed_all, cfrac_all = env.draw_rounds(rounds)
    sel_idx_all = None
    if not fedcs and sampler == 'topk':
        # one bulk uniform draw for all rounds (row t == round t's draw)
        sel_idx_all = selection.fedavg_select_topk(rng, m, fraction, rounds)
    elif sampler not in ('choice', 'topk'):
        raise ValueError(
            f"unknown sampler {sampler!r} (want 'choice' or 'topk')")
    dense = form == 'dense'
    selected_s = np.zeros((rounds, m), bool) if dense else None
    completed_s = np.zeros((rounds, m), bool) if dense else None
    sparse_rows = []
    records = []

    for t in range(1, rounds + 1):
        t_up, t_down = tim.t_up[t - 1], tim.t_down[t - 1]
        full_tt = tim.full_tt[t - 1]
        if fedcs:
            # per-round estimate: traces move the FedCS pick round to round
            est = (t_down + t_up) + full_tt
            sel = selection.fedcs_select(est, fraction, env.t_lim)
        elif sel_idx_all is not None:
            sel = np.zeros(m, bool)
            sel[sel_idx_all[t - 1]] = True
        else:
            sel = selection.fedavg_select(rng, m, fraction)
        crashed, cfrac = crashed_all[t - 1], cfrac_all[t - 1]
        round_len, t_dist = _sync_round_common(env, sel, crashed, cfrac,
                                               t_up, t_down, full_tt)
        # clients that cannot make the deadline are reckoned crashed (§III-B)
        too_slow = (t_dist + (t_down + t_up) + full_tt) > env.t_lim
        crashed = crashed | too_slow
        completed = sel & ~crashed
        performed += float(np.sum(np.where(sel, np.where(crashed, cfrac, 1.0),
                                       0.0) * work))
        wasted += float(np.sum((sel & crashed) * cfrac * work))

        if dense:
            selected_s[t - 1] = sel
            completed_s[t - 1] = ~crashed
        else:
            sparse_rows.append(schedules.sync_sparse_row(sel, ~crashed))
        records.append(RoundRecord(
            round=t, round_len=round_len, t_dist=t_dist,
            eur=float(completed.sum()) / m,
            sr=float(sel.sum()) / m, vv=0.0,
            n_picked=int(completed.sum()), n_committed=int(completed.sum()),
            n_crashed=int(crashed.sum())))

    futility = wasted / max(performed, 1e-9)
    if not dense:
        idx, roles = schedules.pack_sparse_rows(sparse_rows, m)
        return schedules.SparseSyncSchedule(m=m, idx=idx, roles=roles,
                                            records=records,
                                            futility=futility)
    return SyncSchedule(selected=selected_s, completed=completed_s,
                        records=records, futility=futility)


def precompute_local_schedule(env: Env, *, fraction: float, rounds: int,
                              seed: int) -> LocalSchedule:
    """Host pass for the fully-local baseline (selection + crash draws).

    Consumes the selection rng (``seed + 2``) and the env's crash stream
    exactly as the per-round reference loop does: the two are independent
    generators, so bulk-drawing each preserves both streams."""
    m = env.m
    rng = np.random.default_rng(seed + 2)
    tim = env.round_timing(rounds)         # [rounds, m] trace/wire-aware
    crashed_all, cfrac_all = env.draw_rounds(rounds)
    selected = selection.fedavg_select_batch([rng], m, fraction, rounds)[0]
    completed = selected & ~crashed_all
    round_len, _ = _sync_rounds_common(
        selected, crashed_all, cfrac_all, tim.full_tt, t_lim=env.t_lim,
        t_up=tim.t_up, t_down=tim.t_down, msize=env._dist_mb(),
        server_bw=env.server_bw_mbps)
    round_len = round_len.tolist()
    n_committed = completed.sum(axis=-1).tolist()
    n_crashed = crashed_all.sum(axis=-1).tolist()
    records = [RoundRecord(round=i + 1, round_len=round_len[i], t_dist=0.0,
                           eur=0.0, sr=0.0, vv=0.0, n_picked=0,
                           n_committed=n_committed[i],
                           n_crashed=n_crashed[i])
               for i in range(rounds)]
    return LocalSchedule(completed=completed, records=records, futility=0.0)


def precompute_sync_fleet_schedule(members, *, rounds: int, fedcs: bool,
                                   sampler: str = 'choice'
                                   ) -> SyncFleetSchedule:
    """FedAvg/FedCS host pass for a whole fleet in one [S, rounds, m] sweep.

    Bit-identical to stacking S ``precompute_sync_schedule`` calls
    (regression-tested) with the per-member Python state loop eliminated:
    FedCS selection is one ``selection.fedcs_select_batch`` rank
    comparison (when no member carries traces the time estimates are
    round-invariant and one [S, m] selection broadcasts over rounds; with
    traces the rounds axis folds into the batch axis — one
    [S*rounds, m] call), FedAvg selections consume each
    member's own rng stream (``selection.fedavg_select_batch``), and the
    timing/crash algebra plus record stats vectorise over the full
    [S, rounds, m] block.  Synchronous protocols carry no cross-round
    state, so there is no per-round loop either — the futility
    accumulators use ``np.cumsum`` to keep the scalar path's sequential
    round-by-round addition order."""
    s_count = len(members)
    envs = [mem.env for mem in members]
    m = envs[0].m
    if any(e.m != m for e in envs):
        raise ValueError('fleet members must share the client count m')
    fraction = np.array([mem.fraction for mem in members], float)
    t_lim = np.array([e.t_lim for e in envs])
    msize = np.array([e._dist_mb() for e in envs])
    server_bw = np.array([e.server_bw_mbps for e in envs])
    work = np.stack([e.n_batches * e.epochs for e in envs])     # [S, m]
    draws = [e.draw_rounds(rounds) for e in envs]
    crashed_all = np.stack([d[0] for d in draws])           # [S, rounds, m]
    cfrac_all = np.stack([d[1] for d in draws])

    tims = [e.round_timing(rounds) for e in envs]
    if any(e.has_traces for e in envs):
        # time-varying timing: full [S, rounds, m] stacks, and FedCS picks
        # per round (estimates move round to round)
        t_up = np.stack([tt.t_up for tt in tims])
        t_down = np.stack([tt.t_down for tt in tims])
        full_tt = np.stack([tt.full_tt for tt in tims])
        if fedcs:
            est = ((t_down + t_up) + full_tt).reshape(s_count * rounds, m)
            sel = selection.fedcs_select_batch(
                est, np.repeat(fraction, rounds), np.repeat(t_lim, rounds))
            selected = sel.reshape(s_count, rounds, m)
    else:
        # round-invariant timing: [S, 1, m] row-0 views broadcast over
        # rounds (legacy memory shape), one FedCS selection for all rounds
        t_up = np.stack([tt.t_up[0] for tt in tims])[:, None]
        t_down = np.stack([tt.t_down[0] for tt in tims])[:, None]
        full_tt = np.stack([tt.full_tt[0] for tt in tims])[:, None]
        if fedcs:
            est = (t_down[:, 0] + t_up[:, 0]) + full_tt[:, 0]   # [S, m]
            sel = selection.fedcs_select_batch(est, fraction, t_lim)
            selected = np.broadcast_to(sel[:, None],
                                       (s_count, rounds, m)).copy()
    if not fedcs:
        rngs = [np.random.default_rng(mem.seed + 1) for mem in members]
        selected = selection.fedavg_select_batch(rngs, m, fraction, rounds,
                                                 sampler=sampler)

    round_len, t_dist = _sync_rounds_common(
        selected, crashed_all, cfrac_all, full_tt,
        t_lim=t_lim[:, None], t_up=t_up, t_down=t_down,
        msize=msize[:, None], server_bw=server_bw[:, None])
    # clients that cannot make the deadline are reckoned crashed (§III-B)
    too_slow = (t_dist[..., None] + (t_down + t_up)
                + full_tt) > t_lim[:, None, None]
    crashed = crashed_all | too_slow
    completed = selected & ~crashed
    performed = np.sum(np.where(selected, np.where(crashed, cfrac_all, 1.0),
                                0.0) * work[:, None], axis=-1)  # [S, rounds]
    wasted = np.sum((selected & crashed) * cfrac_all * work[:, None], axis=-1)
    performed_tot = np.cumsum(performed, axis=1)[:, -1]
    wasted_tot = np.cumsum(wasted, axis=1)[:, -1]

    round_len_l = round_len.tolist()
    t_dist_l = t_dist.tolist()
    n_completed = completed.sum(axis=-1).tolist()
    n_sel = selected.sum(axis=-1).tolist()
    n_crashed = crashed.sum(axis=-1).tolist()
    records = [[RoundRecord(
        round=i + 1, round_len=round_len_l[s][i], t_dist=t_dist_l[s][i],
        eur=n_completed[s][i] / m,
        sr=n_sel[s][i] / m, vv=0.0,
        n_picked=n_completed[s][i], n_committed=n_completed[s][i],
        n_crashed=n_crashed[s][i],
    ) for i in range(rounds)] for s in range(s_count)]
    return SyncFleetSchedule(
        selected=selected, completed=~crashed, records=records,
        futility=wasted_tot / np.maximum(performed_tot, 1e-9))


def precompute_fedasync_schedule(env: Env, *, rounds: int,
                                 alpha: float = 0.6,
                                 staleness_exp: float = 0.5):
    """The legacy FedAsync precompute: ``agg_schemes.
    precompute_async_schedule`` with its default poly discount, which
    emits the legacy schedule bit for bit."""
    from repro_torch.core import agg_schemes
    return agg_schemes.precompute_async_schedule(
        env, rounds=rounds, alpha=alpha, staleness_exp=staleness_exp)


# ---------------------------------------------------------------------------
# Legacy runner shims (DeprecationWarning; the spec spellings bit for bit)
# ---------------------------------------------------------------------------

def _quantized_train_fn(base_fn):
    """int8-compressed uplink, per-leaf REFERENCE path (kernels 5 and 6):
    each client quantises each leaf of its own update on its own, exactly
    what a real compressed transfer carries, at 2 launches per leaf per
    client (2 m L a round).  This is the bit-identity ground truth for
    the packed wire (``wire='int8'``), which ships the same numbers in 2
    launches a round, so the rows are not batched into fewer launches:
    every client row keeps its own launch.  Only the host's loop over the
    rows moved into C: a leaf is one ``quantize_rows`` and one
    ``dequantize_rows`` call, which launch the flat kernels once per row.

    PyTorch runs eagerly and nothing retraces, so unlike the JAX
    package's this wrapper is not memoised: a fresh closure per run costs
    nothing."""
    def train_fn(stacked, *args):
        trained = base_fn(stacked, *args)

        def per_leaf(x):
            flat = x.reshape(x.shape[0], -1)
            return dequantize_rows(*quantize_rows(flat),
                                   n=flat.shape[1]).reshape(x.shape)

        return {k: per_leaf(v) for k, v in trained.items()}

    return train_fn


def _deprecated(name: str, spelling: str):
    # attribute the warning to the first frame outside this module, so
    # run_fedcs -> run_fedavg chains still point at the user's call site
    level, frame = 3, sys._getframe(2)
    while frame is not None and frame.f_globals.get('__name__') == __name__:
        level += 1
        frame = frame.f_back
    warnings.warn(
        f'federation.{name}() is deprecated; spell it as {spelling} '
        f'(repro_torch.api)', DeprecationWarning, stacklevel=level)


def run_safa(task: Optional[Task], env, *, fraction: float,
             lag_tolerance: int, rounds: int, eval_every: int = 10,
             numeric: bool = True, use_kernel=False,
             quantize_uploads: bool = False, seed: int = 0,
             engine: str = 'scan', wire: str = 'f32', device='cuda'):
    """Deprecated shim over ``api.Experiment(..., SafaSpec(...))``."""
    _deprecated('run_safa', 'Experiment(task, env, SafaSpec(...), '
                'ExecSpec(...)).compile().run()')
    from repro_torch.core import api
    return api.Experiment(
        task, env,
        api.SafaSpec(fraction=fraction, lag_tolerance=lag_tolerance,
                     quantize_uploads=quantize_uploads),
        api.ExecSpec(engine=engine, wire=wire, use_kernel=use_kernel,
                     eval_every=eval_every, numeric=numeric),
        rounds=rounds, seed=seed, device=device).compile().run()


def run_fedavg(task: Optional[Task], env, *, fraction: float, rounds: int,
               eval_every: int = 10, numeric: bool = True, seed: int = 0,
               fedcs: bool = False, engine: str = 'scan', wire: str = 'f32',
               device='cuda'):
    """Deprecated shim over ``api.Experiment(..., FedAvgSpec/FedCSSpec)``."""
    _deprecated('run_fedcs' if fedcs else 'run_fedavg',
                'Experiment(task, env, FedCSSpec(...) if fedcs else '
                'FedAvgSpec(...), ExecSpec(...)).compile().run()')
    from repro_torch.core import api
    spec_cls = api.FedCSSpec if fedcs else api.FedAvgSpec
    return api.Experiment(
        task, env, spec_cls(fraction=fraction),
        api.ExecSpec(engine=engine, wire=wire, eval_every=eval_every,
                     numeric=numeric),
        rounds=rounds, seed=seed, device=device).compile().run()


def run_fedcs(task, env, **kw):
    return run_fedavg(task, env, fedcs=True, **kw)


def run_local(task: Optional[Task], env, *, fraction: float, rounds: int,
              eval_every: int = 10, numeric: bool = True, seed: int = 0,
              engine: str = 'scan', wire: str = 'f32', use_kernel=False,
              device='cuda'):
    """Deprecated shim over ``api.Experiment(..., LocalSpec(...))``.
    ``wire``/``use_kernel`` are accepted for signature parity and refused
    by ``api.check_compat`` with the message every surface uses."""
    _deprecated('run_local', 'Experiment(task, env, LocalSpec(...), '
                'ExecSpec(...)).compile().run()')
    from repro_torch.core import api
    return api.Experiment(
        task, env, api.LocalSpec(fraction=fraction),
        api.ExecSpec(engine=engine, wire=wire, use_kernel=use_kernel,
                     eval_every=eval_every, numeric=numeric),
        rounds=rounds, seed=seed, device=device).compile().run()


def run_fedasync(task: Optional[Task], env, *, fraction: float = 1.0,
                 rounds: int = 100, eval_every: int = 10,
                 numeric: bool = True, alpha: float = 0.6,
                 staleness_exp: float = 0.5, seed: int = 0,
                 engine: str = 'scan', wire: str = 'f32', use_kernel=False,
                 device='cuda'):
    """Deprecated shim over ``api.Experiment(..., FedAsyncSpec(...))``.
    ``fraction`` is ignored (fully asynchronous); ``wire``/``use_kernel``
    are refused by ``api.check_compat``."""
    del fraction
    _deprecated('run_fedasync', 'Experiment(task, env, FedAsyncSpec(...), '
                'ExecSpec(...)).compile().run()')
    from repro_torch.core import api
    return api.Experiment(
        task, env, api.FedAsyncSpec(alpha=alpha, staleness_exp=staleness_exp),
        api.ExecSpec(engine=engine, wire=wire, use_kernel=use_kernel,
                     eval_every=eval_every, numeric=numeric),
        rounds=rounds, seed=seed, device=device).compile().run()


def run_sweep(task, members, *, rounds: int, proto: str = 'safa',
              eval_every: int = 10, numeric: bool = True, use_kernel=False,
              engine: str = 'fleet', wire: str = 'f32', device='cuda'):
    """Deprecated shim over ``api.CompiledRunner.run_sweep``: S =
    len(members) simulations of one protocol as a fleet, one ``History``
    per member.  ``task`` may be a list of per-member Tasks (the
    ``api.SweepSpec(members, tasks=...)`` spelling).  ``use_kernel``
    applies to SAFA alone and is ignored for the other protocols, as in
    the JAX package."""
    _deprecated('run_sweep', 'Experiment(task, env, spec, ExecSpec(...))'
                '.compile().run_sweep(members)')
    from repro_torch.core import api
    if isinstance(task, (list, tuple)):
        sweep = api.SweepSpec(members=tuple(members), tasks=tuple(task))
        task = None
    else:
        sweep = list(members)
    return api.Experiment(
        task, members[0].env if members else None, api.spec(proto),
        api.ExecSpec(engine=engine, wire=wire,
                     use_kernel=use_kernel if proto == 'safa' else False,
                     eval_every=eval_every, numeric=numeric),
        rounds=rounds, device=device).compile().run_sweep(sweep)


RUNNERS = {
    'safa': run_safa,
    'fedavg': run_fedavg,
    'fedcs': run_fedcs,
    'local': run_local,
    'fedasync': run_fedasync,
}

# Backwards-compatible alias (pre-unification name); the registry keyed
# by spec type is ``repro_torch.api.PROTOCOLS``.
PROTOCOLS = RUNNERS

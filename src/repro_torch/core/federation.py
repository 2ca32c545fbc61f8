"""The SAFA event process on the host.

The protocol state machine (versions, commit flags, pending straggler
progress) runs in numpy: it drives the event simulator for timing and
crash draws and precomputes a whole run as a [rounds, m] mask schedule,
because the event process never looks at model weights.  Execution lives
in ``repro_torch.core.protocol``; ``repro_torch.core.api`` wires specs,
schedules and engines together.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import protocol, selection
from repro_torch.core.schedules import (FleetSchedule, RoundRecord,
                                        SafaSchedule, SweepMember)
from repro_torch.fedsim import Env

__all__ = ['FleetSchedule', 'SweepMember', 'Task',
           'precompute_fleet_schedule', 'precompute_safa_schedule']


class Task:
    """A federated learning task: model init/train/eval, model-agnostic for
    the protocol layer.  ``local_train(stacked_params, round_idx)`` trains
    every client replica for E epochs (batched over the clients dim).

    ``round_idx`` is a Python int under ``engine='loop'`` and a 0-dim
    device tensor under the default ``'scan'`` engine; implementations
    must not branch on it.

    A task that a fleet sweep shares also implements
    ``local_train_fleet(fleet_params, round_idx)``: every member's client
    replicas ([S, m, ...] leaves) in one call, round_idx [S]."""

    #: the device the task's data lives on and its params are made on
    device = None

    def init_global(self, seed: int) -> dict:
        raise NotImplementedError

    def local_train(self, stacked_params: dict, round_idx) -> dict:
        raise NotImplementedError

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


def precompute_safa_schedule(env: Env, *, fraction: float,
                             lag_tolerance: int, rounds: int,
                             form: str = 'dense') -> SafaSchedule:
    """Run the SAFA timing/event state machine (Eq. 3 version bookkeeping,
    crash draws, CFCFM selection) for all rounds in one numpy host pass
    and return the dense [rounds, m] mask schedule with its records.
    Consumes ``env``'s rng exactly as the JAX package's precompute does,
    so both packages see the same events from the same ``EnvSpec``."""
    if form in ('sparse', 'sparse_tier'):
        raise NotImplementedError(
            f"form={form!r} is not ported yet (ROADMAP queue 1, items 11-12: "
            f"sparse and lag-tier schedules); use form='dense'")
    if form != 'dense':
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
                       'deprecated')}
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

        i = t - 1
        masks['sync'][i] = sync
        masks['committed'][i] = sel.committed
        masks['picked'][i] = sel.picked
        masks['undrafted'][i] = sel.undrafted
        masks['deprecated'][i] = dep

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

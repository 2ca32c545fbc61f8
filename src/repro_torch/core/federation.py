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
from repro_torch.core.schedules import RoundRecord, SafaSchedule
from repro_torch.fedsim import Env

__all__ = ['Task', 'precompute_safa_schedule']


class Task:
    """A federated learning task: model init/train/eval, model-agnostic for
    the protocol layer.  ``local_train(stacked_params, round_idx)`` trains
    every client replica for E epochs (batched over the clients dim).

    ``round_idx`` is a Python int under ``engine='loop'`` and a 0-dim
    device tensor under the default ``'scan'`` engine; implementations
    must not branch on it."""

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

"""Client selection policies (server-side orchestration; numpy).

CFCFM (Algorithm 1) — Compensatory First-Come-First-Merge: the server picks
arriving updates until the quota C*m is met, giving priority to clients that
were NOT picked in the previous round; leftover quota is filled from the
remaining arrivals in arrival order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def quota_of(fraction: float, m: int) -> int:
    """The C*m selection quota shared by every policy: at least one
    client, round-half-to-even (Python ``round`` == ``np.rint``, which the
    batched selectors rely on for row identity)."""
    return max(1, int(round(fraction * m)))


@dataclasses.dataclass
class SelectionResult:
    picked: np.ndarray       # [m] bool — P(t)
    undrafted: np.ndarray    # [m] bool — Q(t): committed but not picked
    committed: np.ndarray    # [m] bool — W(t): finished & arrived by deadline
    quota_met_time: float    # arrival time of the quota-filling update (or deadline)


def cfcfm(arrival: np.ndarray, completed: np.ndarray, picked_prev: np.ndarray,
          fraction: float, deadline: float) -> SelectionResult:
    """arrival: [m] float arrival times (inf for crashed); completed: [m]
    bool (finished training); picked_prev: [m] bool = P(t-1)."""
    m = arrival.shape[0]
    quota = quota_of(fraction, m)
    committed = completed & (arrival <= deadline)
    picked = np.zeros(m, bool)

    # Phase 1: priority clients (not picked last round), in arrival order.
    prio = committed & ~picked_prev
    order = np.argsort(np.where(prio, arrival, np.inf), kind='stable')
    take = order[:quota][prio[order[:quota]]]
    picked[take] = True

    # Phase 2: fill remaining quota from the rest (picked last round).
    short = quota - picked.sum()
    if short > 0:
        rest = committed & ~picked
        order2 = np.argsort(np.where(rest, arrival, np.inf), kind='stable')
        take2 = order2[:short][rest[order2[:short]]]
        picked[take2] = True

    undrafted = committed & ~picked
    if short <= 0 and picked.any():
        # quota filled by priority arrivals: round closes at the quota-th one
        quota_met = float(np.max(arrival[picked]))
    elif committed.any():
        # the server waits for all live clients (crashes are detectable),
        # then tops the quota up from the remaining arrivals
        quota_met = float(np.max(arrival[committed]))
    else:
        quota_met = deadline
    return SelectionResult(picked, undrafted, committed, min(quota_met, deadline))


@dataclasses.dataclass
class BatchSelectionResult:
    """Fleet-batched ``SelectionResult``: [S, m] masks, [S] times."""
    picked: np.ndarray
    undrafted: np.ndarray
    committed: np.ndarray
    quota_met_time: np.ndarray


def cfcfm_batch(arrival: np.ndarray, completed: np.ndarray,
                picked_prev: np.ndarray, fraction: np.ndarray,
                deadline: np.ndarray, *,
                quota: Optional[np.ndarray] = None) -> BatchSelectionResult:
    """CFCFM for a whole fleet in one vectorised pass.

    arrival/completed/picked_prev: [S, m]; fraction/deadline: [S] (or
    scalars).  Row s is bit-identical to ``cfcfm(arrival[s], ...)`` — the
    fleet schedule precompute relies on this (regression-tested).  The
    per-member "take arrivals in order up to quota" scan becomes a rank
    comparison: a client is picked in phase 1 iff it is eligible and its
    stable arrival rank among eligible clients beats the quota.

    ``quota`` (the [S] int result of ``max(1, round(fraction * m))``) may
    be precomputed by per-round callers; it only depends on the fractions.
    """
    s, m = arrival.shape
    deadline = np.broadcast_to(np.asarray(deadline, float), (s,))
    if quota is None:
        fraction = np.broadcast_to(np.asarray(fraction, float), (s,))
        # np.rint rounds half-to-even exactly like the scalar path's round()
        quota = np.maximum(1, np.rint(fraction * m).astype(int))
    committed = completed & (arrival <= deadline[:, None])

    def rank(eligible):
        """Stable arrival rank (ineligible clients rank last)."""
        order = np.argsort(np.where(eligible, arrival, np.inf), axis=-1,
                           kind='stable')
        return np.argsort(order, axis=-1, kind='stable')  # inverse perm

    # Phase 1: priority clients (not picked last round), in arrival order.
    prio = committed & ~picked_prev
    picked = prio & (rank(prio) < quota[:, None])
    # Phase 2: fill remaining quota from the rest (picked last round).
    short = quota - picked.sum(axis=-1)
    rest = committed & ~picked
    picked = picked | (rest & (rank(rest) < short[:, None]))

    undrafted = committed & ~picked
    picked_max = np.max(np.where(picked, arrival, -np.inf), axis=-1)
    committed_max = np.max(np.where(committed, arrival, -np.inf), axis=-1)
    quota_met = np.where(
        (short <= 0) & picked.any(axis=-1), picked_max,
        np.where(committed.any(axis=-1), committed_max, deadline))
    return BatchSelectionResult(picked, undrafted, committed,
                                np.minimum(quota_met, deadline))


def fedavg_select(rng: np.random.Generator, m: int, fraction: float) -> np.ndarray:
    """Random pre-training selection (FedAvg)."""
    quota = quota_of(fraction, m)
    sel = np.zeros(m, bool)
    sel[rng.choice(m, size=quota, replace=False)] = True
    return sel


def fedavg_select_topk(rng: np.random.Generator, m: int, fraction: float,
                       rounds: int = 1) -> np.ndarray:
    """Vectorised without-replacement uniform selection: [rounds, quota]
    sorted client indices.

    One bulk ``rng.random((rounds, m))`` draw; per round the quota clients
    with the smallest uniforms win — distributionally a uniform
    without-replacement sample, with no per-round ``Generator.choice``
    loop.  This is the sparse stream contract (``sampler='topk'``): it
    emits index lists directly, so sparse schedules never materialise a
    [rounds, m] mask.  The draw order is row-major, so chunking over
    rounds consumes the stream identically — which is how this is
    implemented: rounds are drawn in bounded chunks so peak host memory
    is O(chunk * m), not O(rounds * m), at million-client populations."""
    quota = quota_of(fraction, m)
    chunk = max(1, min(rounds, int(4e6) // max(m, 1) + 1))
    out = np.empty((rounds, quota), np.int32)
    for lo in range(0, rounds, chunk):
        u = rng.random((min(chunk, rounds - lo), m))
        idx = np.argpartition(u, quota - 1, axis=-1)[:, :quota]
        out[lo:lo + len(u)] = np.sort(idx, axis=-1)
    return out


def fedavg_select_batch(rngs, m: int, fraction, rounds: int = 1,
                        sampler: str = 'choice') -> np.ndarray:
    """FedAvg selections for a whole fleet: [S, rounds, m] bool.

    ``rngs`` is one ``np.random.Generator`` per member; ``fraction`` is [S]
    (or a scalar).

    ``sampler='choice'`` (default, legacy stream): row (s, t) is
    bit-identical to the t-th sequential ``fedavg_select(rngs[s], m,
    fraction[s])`` call — the without-replacement draw has no batched
    Generator form that consumes the stream the same way, so the per-round
    ``choice()`` calls stay the generator's own; only the quota computation
    and the mask scatter are batched.

    ``sampler='topk'`` scatters ``fedavg_select_topk`` rows instead: one
    bulk uniform draw per member, no per-round loop — the fast path for
    large populations (its stream differs from 'choice' by design).
    """
    if sampler not in ('choice', 'topk'):
        raise ValueError(
            f"unknown sampler {sampler!r} (want 'choice' or 'topk')")
    s = len(rngs)
    fraction = np.broadcast_to(np.asarray(fraction, float), (s,))
    # np.rint rounds half-to-even exactly like the scalar path's round()
    quota = np.maximum(1, np.rint(fraction * m).astype(int))
    sel = np.zeros((s, rounds, m), bool)
    rows = np.arange(rounds)
    for i, rng in enumerate(rngs):
        if sampler == 'topk':
            idx = fedavg_select_topk(rng, m, float(fraction[i]), rounds)
        else:
            idx = np.stack([rng.choice(m, size=quota[i], replace=False)
                            for _ in range(rounds)])
        sel[i, rows[:, None], idx] = True
    return sel


def fedcs_select(est_round_time: np.ndarray, fraction: float,
                 deadline: float) -> np.ndarray:
    """FedCS (Nishio & Yonetani): the server estimates each client's round
    time and greedily admits the fastest clients that fit the deadline, up
    to the C*m quota."""
    m = est_round_time.shape[0]
    quota = quota_of(fraction, m)
    order = np.argsort(est_round_time, kind='stable')
    sel = np.zeros(m, bool)
    n = 0
    for k in order:
        if n >= quota:
            break
        if est_round_time[k] <= deadline:
            sel[k] = True
            n += 1
    if n == 0:  # degenerate: admit the single fastest client
        sel[order[0]] = True
    return sel


def cluster_by_profile(profile: np.ndarray, clusters: int) -> np.ndarray:
    """CSAFL-style host-side client clustering: [m] int labels in
    [0, clusters) from a per-client timing/crash profile (e.g.
    ``FLEnv.full_train_time()`` — slow clients land together, so each
    cluster's semi-async sub-aggregation mixes updates of similar
    staleness).

    Quantile bucketing on the stable profile rank: label k holds the
    clients between the k/clusters and (k+1)/clusters rank quantiles, so
    clusters are balanced to within one client and the labels are a
    partition by construction (deterministic, no iterative k-means
    state).  ``clusters`` is capped at m; with ``clusters=1`` every
    client shares one group and the scheme degenerates to plain adaptive
    weighting."""
    m = profile.shape[0]
    if clusters < 1:
        raise ValueError(f'clusters must be >= 1, got {clusters}')
    k = min(int(clusters), m)
    order = np.argsort(profile, kind='stable')
    rank = np.argsort(order, kind='stable')     # inverse perm
    return (rank * k) // m


def fedcs_select_batch(est_round_time: np.ndarray, fraction,
                       deadline) -> np.ndarray:
    """FedCS for a whole fleet in one vectorised pass: [S, m] bool.

    est_round_time: [S, m]; fraction/deadline: [S] (or scalars).  Row s is
    bit-identical to ``fedcs_select(est_round_time[s], ...)`` — the scalar
    greedy "admit fastest fitting clients until quota" loop becomes a rank
    comparison: a client is admitted iff it fits the deadline and its
    stable speed rank among fitting clients beats the quota.
    """
    s, m = est_round_time.shape
    fraction = np.broadcast_to(np.asarray(fraction, float), (s,))
    deadline = np.broadcast_to(np.asarray(deadline, float), (s,))
    quota = np.maximum(1, np.rint(fraction * m).astype(int))
    fits = est_round_time <= deadline[:, None]
    order = np.argsort(np.where(fits, est_round_time, np.inf), axis=-1,
                       kind='stable')
    rank = np.argsort(order, axis=-1, kind='stable')  # inverse perm
    sel = fits & (rank < quota[:, None])
    # degenerate: nothing fits the deadline -> admit the single fastest
    none = ~fits.any(axis=-1)
    fastest = np.argsort(est_round_time, axis=-1, kind='stable')[:, 0]
    sel[none, fastest[none]] = True
    return sel

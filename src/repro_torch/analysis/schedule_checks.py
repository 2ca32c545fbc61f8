"""Static schedule verifier: prove the invariants the kernels assume.

The aliased tier kernels, the sentinel-slot no-op contract, and the
weighted-merge residual all rest on *schedule* properties that the
engines never re-check at runtime.  ``verify_schedule`` proves them on
any schedule instance — including ones users build from their own
traces/EnvSpecs — by independent recomputation (the lifetime/liveness
replay here shares no code with ``build_tier_schedule``'s allocator).

Rules
-----

* **SCH001** — tier read/write slot disjointness: per round, every
  written buffer slot (``cache_dst`` != scratch, ``global_dst``) is
  distinct from every other write and from every read slot
  (``base_src``/``cache_src``).  This is exactly the property that lets
  ``safa_aggregate_packed_*_tier_rows`` alias the ``[capacity+1, N]``
  buffer in place.
* **SCH002** — capacity == peak live rows: replaying value lifetimes
  from the slot maps alone (a write opens an interval, the last read
  closes it) must reproduce ``capacity`` exactly — the first-fit
  allocator's promise that the buffer is minimal, with no dead rows and
  no slot written twice without an intervening read.
* **SCH003** — sentinel slots are inert: ``idx == m`` slots carry zero
  roles and scratch-only slot maps, active slots carry nonzero roles,
  and padding is a contiguous suffix (the kernels rely on sentinel rows
  writing only to scratch).
* **SCH004** — lag <= tau everywhere (Eq. 3): replaying the version
  counters of the dense masks, no client's model may lag the global
  version by more than ``lag_tolerance`` after distribution, and
  deprecated clients must be force-synced; picked/undrafted must be
  committed subsets.
* **SCH005** — weight rows: ``wrow >= 0``, zero off the committed set,
  and each row sums to at most ``alpha`` (+1 ulp slack) so the merge's
  residual global weight stays non-negative.  FedAsync alphas obey the
  same bounds per merge, and merge orders are permutations.
* **SCH006** — sparse active-set indices sorted strictly ascending
  (unique) per round, all within ``[0, m)``.

Fleet-major stacks are verified member-by-member through their
``member(s)`` accessors; the tier fleet additionally proves that the
shared fleet capacity is the max of the members' peak live counts.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import protocol, schedules

from .report import Report

__all__ = ['verify_schedule']

_EPS = 1e-6


def verify_schedule(sched, *, lag_tolerance=None, alpha=None,
                    subject=None) -> Report:
    """Prove every applicable invariant of ``sched``; returns a
    :class:`~repro_torch.analysis.report.Report` (``.raise_if_failed()`` for
    assert-style use).  ``lag_tolerance`` enables the SCH004 lag bound on
    dense SAFA schedules; ``alpha`` tightens the SCH005 row-sum bound
    (defaults to 1.0, the hard residual-non-negativity bound)."""
    rep = Report()
    name = subject if subject is not None else type(sched).__name__
    if isinstance(sched, schedules.SafaSchedule):
        _check_safa_masks(rep, name, sched, lag_tolerance)
    elif isinstance(sched, (schedules.SparseSchedule,
                            schedules.SparseSyncSchedule)):
        _check_sparse(rep, name, sched)
    elif isinstance(sched, schedules.TierSchedule):
        _check_sparse(rep, name, sched)
        _check_tier(rep, name, sched, exact_capacity=True)
    elif isinstance(sched, schedules.TierFleetSchedule):
        peaks = []
        for s in range(sched.size):
            mem = sched.member(s)
            mname = f'{name}[member={s}]'
            _check_sparse(rep, mname, mem)
            # fleet members share the fleet-max capacity; each member's
            # own peak may be smaller
            peaks.append(_check_tier(rep, mname, mem, exact_capacity=False))
        peak = max(peaks)
        rep.add('SCH002', name, peak == sched.capacity,
                f'fleet capacity {sched.capacity} vs max member peak '
                f'live rows {peak}')
    elif isinstance(sched, schedules.WeightedSchedule):
        _check_weighted(rep, name, sched, alpha)
    elif isinstance(sched, schedules.FedasyncSchedule):
        _check_async(rep, name, sched)
    elif isinstance(sched, (schedules.SyncSchedule, schedules.LocalSchedule)):
        _check_bool_masks(rep, name, sched)
    elif isinstance(sched, (schedules.FleetSchedule,
                            schedules.SyncFleetSchedule,
                            schedules.LocalFleetSchedule,
                            schedules.AsyncFleetSchedule,
                            schedules.WeightedFleetSchedule,
                            schedules.SparseFleetSchedule,
                            schedules.SparseSyncFleetSchedule)):
        for s in range(sched.size):
            rep.extend(verify_schedule(sched.member(s),
                                       lag_tolerance=lag_tolerance,
                                       alpha=alpha,
                                       subject=f'{name}[member={s}]'))
    else:
        raise TypeError(
            f'verify_schedule: unsupported schedule type '
            f'{type(sched).__name__}')
    return rep


# ---------------------------------------------------------------------------
# Dense SAFA masks (SCH004)
# ---------------------------------------------------------------------------

def _check_safa_masks(rep: Report, name: str, sched, lag_tolerance) -> None:
    sync, committed = sched.sync, sched.committed
    picked, undrafted = sched.picked, sched.undrafted
    deprecated = sched.deprecated
    rounds, m = sync.shape
    ok_sets = True
    detail = ''
    for t in range(rounds):
        if not (committed[t] | ~picked[t]).all() \
                or not (committed[t] | ~undrafted[t]).all():
            ok_sets, detail = False, f'picked/undrafted not ⊆ committed ' \
                f'at round {t + 1}'
            break
        if (picked[t] & undrafted[t]).any():
            ok_sets, detail = False, f'picked ∩ undrafted nonempty at ' \
                f'round {t + 1}'
            break
        if not (sync[t] | ~deprecated[t]).all():
            ok_sets, detail = False, f'deprecated client not synced at ' \
                f'round {t + 1} (Eq. 3 forces stale clients to sync)'
            break
    rep.add('SCH004', name, ok_sets,
            detail or f'role-subset structure holds over {rounds} rounds')
    if lag_tolerance is None:
        return
    tau = int(lag_tolerance)
    v = np.zeros(m, np.int64)
    worst = 0
    for t in range(rounds):
        v[sync[t]] = t
        worst = max(worst, int((t - v).max()))
        v[committed[t]] = t + 1
    rep.add('SCH004', f'{name}[lag]', worst <= tau,
            f'max post-distribution staleness {worst} vs tau={tau}')


def _check_bool_masks(rep: Report, name: str, sched) -> None:
    """Sync/local schedules carry plain bool masks; the only static
    contract is shape/dtype sanity (kept so the registry pass emits a
    row for every protocol rather than silently skipping)."""
    masks = [getattr(sched, f) for f in ('selected', 'completed')
             if hasattr(sched, f)]
    ok = all(a.dtype == np.bool_ and a.ndim == 2 for a in masks)
    rep.add('SCH004', name, ok,
            f'{len(masks)} boolean [rounds, m] mask(s)')


# ---------------------------------------------------------------------------
# Sparse active sets (SCH003 + SCH006)
# ---------------------------------------------------------------------------

def _check_sparse(rep: Report, name: str, sched) -> None:
    idx, roles, m = sched.idx, sched.roles, sched.m
    rounds = idx.shape[0]
    ok_sorted = ok_inert = True
    d_sorted = d_inert = ''
    for t in range(rounds):
        valid = idx[t] < m
        act = idx[t][valid]
        if (idx[t] > m).any() or (idx[t] < 0).any():
            ok_sorted, d_sorted = False, \
                f'index out of [0, m] at round {t + 1}'
            break
        if act.size and not (np.diff(act) > 0).all():
            ok_sorted, d_sorted = False, \
                f'active indices not strictly ascending at round {t + 1}'
            break
        if valid.any() and not valid[:valid.sum()].all():
            ok_inert, d_inert = False, \
                f'sentinel slot before an active slot at round {t + 1}'
            break
        if (roles[t][~valid] != 0).any():
            ok_inert, d_inert = False, \
                f'sentinel slot carries nonzero role at round {t + 1}'
            break
        if (roles[t][valid] == 0).any():
            ok_inert, d_inert = False, \
                f'active slot carries zero role at round {t + 1}'
            break
    rep.add('SCH006', name, ok_sorted,
            d_sorted or f'active sets sorted/unique over {rounds} rounds')
    rep.add('SCH003', name, ok_inert,
            d_inert or 'sentinel slots inert (zero roles, contiguous '
            'suffix)')


# ---------------------------------------------------------------------------
# Tier slot maps (SCH001 + SCH002 + SCH003 on the maps)
# ---------------------------------------------------------------------------

def _check_tier(rep: Report, name: str, sched, *,
                exact_capacity: bool) -> int:
    """Prove the tier slot maps safe for in-place aliasing and minimal in
    capacity.  Returns the independently recomputed peak live count."""
    idx, roles = sched.idx, sched.roles
    base_src, cache_src = sched.base_src, sched.cache_src
    cache_dst, global_dst = sched.cache_dst, sched.global_dst
    scratch, m = sched.scratch, sched.m
    rounds, width = idx.shape
    r_c, r_s = protocol.ROLE_COMMITTED, protocol.ROLE_SYNC

    ok_disjoint = ok_inert = True
    d_disjoint = d_inert = ''
    reads_by_round, writes_by_round = [], []
    for t in range(rounds):
        valid = idx[t] < m
        reads = set(base_src[t][valid]) | set(cache_src[t][valid])
        reads.discard(scratch)
        writes = [int(s) for s in cache_dst[t][valid] if s != scratch]
        if global_dst[t] != scratch:
            writes.append(int(global_dst[t]))
        if len(writes) != len(set(writes)) and ok_disjoint:
            ok_disjoint, d_disjoint = False, \
                f'two writes share a slot at round {t + 1}'
        clash = reads & set(writes)
        if clash and ok_disjoint:
            ok_disjoint, d_disjoint = False, \
                f'slot {sorted(clash)[0]} both read and written at ' \
                f'round {t + 1} (in-place aliasing would clobber it)'
        sentinel_maps = np.concatenate(
            [base_src[t][~valid], cache_src[t][~valid],
             cache_dst[t][~valid]])
        if (sentinel_maps != scratch).any() and ok_inert:
            ok_inert, d_inert = False, \
                f'sentinel slot maps to a live row at round {t + 1}'
        # a synced committed slot reads no base (its base IS the fresh
        # global); a pure-sync slot touches no buffer row at all
        commit_only = valid & ((roles[t] & r_c) != 0) \
            & ((roles[t] & r_s) == 0)
        if (base_src[t][valid & ~commit_only] != scratch).any() \
                and ok_inert:
            ok_inert, d_inert = False, \
                f'non-commit slot reads a base row at round {t + 1}'
        reads_by_round.append(reads)
        writes_by_round.append(set(writes))

    rep.add('SCH001', name, ok_disjoint,
            d_disjoint or f'read/write slot sets disjoint over {rounds} '
            f'rounds (capacity {sched.capacity})')
    rep.add('SCH003', f'{name}[maps]', ok_inert,
            d_inert or 'sentinel slots map to scratch only')

    peak, ok_cap, d_cap = _replay_lifetimes(
        sched.capacity, reads_by_round, writes_by_round)
    if exact_capacity:
        ok = ok_cap and peak == sched.capacity
        rep.add('SCH002', name, ok,
                d_cap or f'capacity {sched.capacity} == recomputed peak '
                f'live rows {peak}')
    elif not ok_cap:
        rep.add('SCH002', name, False, d_cap)
    return peak


def _replay_lifetimes(capacity: int, reads_by_round, writes_by_round):
    """Recompute peak concurrently-live rows from the slot maps alone.

    A write opens a value interval; the last read of that slot before its
    next write closes it.  Rows live before any write are init state
    (interval open from round 0).  A slot is occupied from its write
    round through its last read round inclusive — the allocator frees it
    only the round after — so the peak is the max closed-interval
    overlap.  Also flags dead writes (a written row never read back):
    the allocator never emits them, and their presence means capacity is
    not minimal."""
    rounds = len(reads_by_round)
    intervals = []      # (write_round, last_read_round)
    open_at: dict = {}  # slot -> write round of the live value
    last_read: dict = {}
    init_slots = set()
    for t in range(rounds):
        for s in reads_by_round[t]:
            if s not in open_at and s not in init_slots:
                init_slots.add(s)
                open_at[s] = 0
            last_read[s] = t
        for s in writes_by_round[t]:
            if s in open_at:
                lr = last_read.get(s)
                if lr is None or lr < open_at[s]:
                    return 0, False, \
                        f'slot {s} written at round {t + 1} but its ' \
                        f'previous value was never read (dead row)'
                intervals.append((open_at[s], lr))
            open_at[s] = t
            last_read.pop(s, None)
    for s, w in open_at.items():
        lr = last_read.get(s)
        if lr is None:
            if s in init_slots:
                continue    # init rows may go unread (empty schedules)
            return 0, False, \
                f'slot {s} written at round {w + 1} and never read'
        intervals.append((w, lr))
    if not intervals:
        return 0, True, ''
    peak = 0
    for t in range(rounds):
        live = sum(1 for (w, lr) in intervals if w <= t <= lr)
        peak = max(peak, live)
    if peak > capacity:
        return peak, False, \
            f'{peak} rows live at once but capacity is {capacity}'
    return peak, True, ''


# ---------------------------------------------------------------------------
# Weight rows (SCH005)
# ---------------------------------------------------------------------------

def _check_weighted(rep: Report, name: str, sched, alpha) -> None:
    bound = 1.0 if alpha is None else float(alpha)
    wrow, committed = np.asarray(sched.wrow), sched.committed
    ok, detail = True, ''
    if (wrow < 0).any():
        ok, detail = False, 'negative merge weight'
    elif (wrow[~committed] != 0).any():
        ok, detail = False, 'nonzero weight off the committed set'
    else:
        sums = wrow.sum(axis=1)
        worst = float(sums.max()) if sums.size else 0.0
        if worst > bound + _EPS:
            ok, detail = False, \
                f'row sum {worst:.6f} exceeds alpha={bound} (residual ' \
                f'global weight would go negative)'
        else:
            detail = f'rows >= 0, max row sum {worst:.6f} <= {bound}'
    rep.add('SCH005', name, ok, detail)


def _check_async(rep: Report, name: str, sched) -> None:
    alphas, committed = np.asarray(sched.alphas), sched.committed
    order = np.asarray(sched.order)
    m = alphas.shape[1]
    ok, detail = True, ''
    if (alphas < 0).any() or (alphas > 1 + _EPS).any():
        ok, detail = False, 'merge alpha outside [0, 1]'
    elif (alphas[~committed] != 0).any():
        ok, detail = False, 'nonzero alpha off the committed set'
    elif any(not np.array_equal(np.sort(order[t]), np.arange(m))
             for t in range(order.shape[0])):
        ok, detail = False, 'merge order is not a permutation'
    else:
        detail = f'alphas in [0, 1], orders are permutations of {m}'
    rep.add('SCH005', name, ok, detail)

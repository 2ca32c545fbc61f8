"""FedAsync's event pass with a pluggable staleness discount.

The FedAsync family (Xie et al.) mixes each arriving update into the
global model with weight alpha * s(staleness).  On the host that reduces
to per-round [rounds, m] alpha tensors, merge orders and commit masks
(``precompute_async_schedule``), which the FedAsync engine of
``repro_torch.core.protocol`` replays in arrival order.

* ``staleness_discount`` — s(dt) for every name in ``STALENESS_FNS``;
  ``'poly'`` reproduces the legacy schedule bit for bit.
* ``async_kwargs`` — the precompute's arguments from a ``FedAsyncSpec``
  and, in a sweep, a ``SweepMember`` (its ``alpha``/``staleness_exp``
  columns and protocol-field ``overrides`` win).

The weighted-merge family of the JAX package (SEAFL, CSAFL, the folded
FedAsync) is ROADMAP queue 1, item 10.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import federation, schedules
from repro_torch.core.schedules import RoundRecord

__all__ = ['STALENESS_FNS', 'async_kwargs', 'precompute_async_schedule',
           'staleness_discount']

#: staleness-discount functions s(dt) of the FedAsync family (Xie et al.):
#: ``'constant'`` -> 1; ``'hinge'`` -> 1 if dt <= b else 1/(a*(dt-b)),
#: clamped to (0, 1]; ``'poly'`` -> (1+dt)^(-a).  The discount scales the
#: base mixing weight alpha, so every variant replays through the same
#: precomputed per-round alpha tensors.
STALENESS_FNS = ('constant', 'hinge', 'poly')


def staleness_discount(staleness, fn: str = 'poly', *,
                       staleness_exp: float = 0.5, hinge_a: float = 10.0,
                       hinge_b: int = 4) -> np.ndarray:
    """Elementwise staleness discount s(dt) in (0, 1] (host numpy).

    ``'constant'`` -> 1; ``'poly'`` -> (1+dt)^(-staleness_exp);
    ``'hinge'`` -> 1 while dt <= hinge_b, then 1/(hinge_a*(dt-hinge_b)),
    clamped to 1 so the discount never *amplifies* an update (the raw
    hinge exceeds 1 for dt just past the knee when hinge_a < 1/(dt-b))."""
    s = np.asarray(staleness, dtype=float)
    if fn == 'constant':
        return np.ones_like(s)
    if fn == 'poly':
        return (1.0 + s) ** (-staleness_exp)
    if fn == 'hinge':
        with np.errstate(divide='ignore'):
            tail = 1.0 / (hinge_a * (s - hinge_b))
        return np.where(s <= hinge_b, 1.0, np.minimum(1.0, tail))
    raise ValueError(
        f'unknown staleness_fn {fn!r} (want one of {STALENESS_FNS})')


def _apply_member(kw: dict, mem) -> dict:
    """Member hyper columns, then ``mem.overrides``, on top of the spec
    defaults.  Unknown override keys are rejected here, at precompute
    time, so a mistyped sweep fails before any device work."""
    kw['alpha'] = mem.alpha
    kw['staleness_exp'] = mem.staleness_exp
    if mem.overrides:
        unknown = sorted(set(mem.overrides) - set(kw))
        if unknown:
            raise ValueError(
                f'unknown member override keys {unknown}; this precompute '
                f'takes {sorted(kw)}')
        kw.update(mem.overrides)
    return kw


def async_kwargs(sp, mem=None) -> dict:
    """``precompute_async_schedule`` kwargs from a ``FedAsyncSpec`` (and
    optionally a ``SweepMember`` whose hyper columns/overrides win)."""
    kw = dict(alpha=sp.alpha, staleness_exp=sp.staleness_exp,
              staleness_fn=sp.staleness_fn, hinge_a=sp.hinge_a,
              hinge_b=sp.hinge_b)
    return kw if mem is None else _apply_member(kw, mem)


def precompute_async_schedule(env, *, rounds: int, alpha: float = 0.6,
                              staleness_fn: str = 'poly',
                              staleness_exp: float = 0.5,
                              hinge_a: float = 10.0, hinge_b: int = 4
                              ) -> schedules.FedasyncSchedule:
    """FedAsync event pass with a pluggable staleness discount: a
    global-version counter and per-client staleness, crash draws in bulk
    from the env's rng (the JAX package's stream), and the per-commit
    mixing weight ``alpha * s(staleness)``.  With ``staleness_fn='poly'``
    the weight is the legacy ``alpha * (1 + dt) ** -staleness_exp``, the
    same float expression."""
    m = env.m
    tim = env.round_timing(rounds)        # [rounds, m] trace/wire-aware
    crashed_all, _ = env.draw_rounds(rounds)
    t_dist_m = env.t_dist(m)
    versions = np.zeros(m, dtype=float)   # global version at last pull
    global_version = 0
    committed_s = np.zeros((rounds, m), bool)
    order_s = np.zeros((rounds, m), np.int64)
    alphas_s = np.zeros((rounds, m))
    records = []

    for t in range(1, rounds + 1):
        crashed = crashed_all[t - 1]
        arrival_base = t_dist_m \
            + (tim.t_down[t - 1] + tim.t_up[t - 1]) + tim.full_tt[t - 1]
        arrival = np.where(~crashed, arrival_base, np.inf)
        too_slow = arrival > env.t_lim
        committed = ~crashed & ~too_slow
        staleness = np.maximum(0.0, global_version - versions)
        i = t - 1
        committed_s[i] = committed
        order_s[i] = np.argsort(arrival, kind='stable')
        disc = staleness_discount(staleness, staleness_fn,
                                  staleness_exp=staleness_exp,
                                  hinge_a=hinge_a, hinge_b=hinge_b)
        alphas_s[i] = np.where(committed, alpha * disc, 0.0)
        global_version += int(committed.sum())
        versions[committed] = global_version
        records.append(_async_record(t, arrival, committed, crashed,
                                     staleness, env))

    return schedules.FedasyncSchedule(committed=committed_s, order=order_s,
                                      alphas=alphas_s, records=records,
                                      futility=0.0)


def _async_record(t, arrival, committed, crashed, staleness,
                  env) -> RoundRecord:
    """The per-round timing record every merge-per-arrival scheme shares
    (identical to the legacy FedAsync precompute's)."""
    return RoundRecord(
        round=t,
        round_len=federation._capped_round_len(arrival, committed, env.t_lim),
        t_dist=env.t_dist(int(committed.sum())),
        eur=float(committed.sum()) / arrival.shape[0],
        sr=1.0,  # every client syncs every round: max downlink pressure
        vv=float(np.var(staleness[committed])) if committed.any() else 0.0,
        n_picked=int(committed.sum()),
        n_committed=int(committed.sum()),
        n_crashed=int(crashed.sum()))

"""The staleness-adaptive aggregation family: discount functions, the
host precomputes, and the SEAFL/CSAFL protocol specs.

Every scheme of the family reduces, on the host, to per-round merge
weights: either the [rounds, m] alpha tensors and merge orders of
FedAsync's sequential engine (``precompute_async_schedule``), or the
one-shot weight rows of the weighted-merge engine
(``precompute_weighted_schedule``), which ``repro_torch.core.protocol``
replays as ``(1 - sum(wrow)) * global + sum_k wrow[k] * trained_k``.
``repro_torch.core.api`` registers the protocols.

* **FedAsync discounts** (Xie et al., ``FedAsyncSpec.staleness_fn``):
  s(dt) in ``STALENESS_FNS`` scales the base alpha per commit;
  ``'poly'`` reproduces the legacy schedule bit for bit.
* **SEAFL-style adaptive weights** (``SeaflSpec``): one merge per round,
  each committed client weighted by its data share x staleness discount
  (optionally x a loss-term proxy), normalised over the committed set and
  scaled by alpha.
* **CSAFL-style clustered semi-async** (``CsaflSpec``): clients are
  clustered host-side by timing profile (``selection.cluster_by_profile``
  on ``Env.full_train_time()``); each cluster sub-aggregates its commits
  by data share x per-client discount, and the cluster blends into the
  global model under its own rounds-since-last-merge discount.  The
  cluster masks lower to ordinary weight rows, so the packed merge kernel
  computes the per-cluster sub-aggregates as masked sub-sums of one
  launch.
* **Folded FedAsync** (``scheme='fedasync'`` via ``SweepMember.overrides``):
  the sequential arrival-ordered merge chain folded into closed-form
  effective weights (suffix products in float64), so a FedAsync member can
  ride in the same weighted fleet as SEAFL/CSAFL members.

``async_kwargs`` and ``weighted_kwargs`` give each precompute's arguments
from a spec and, in a sweep, a ``SweepMember`` (its ``alpha``/
``staleness_exp`` columns and protocol-field ``overrides`` win).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import federation, schedules, selection
from repro_torch.core.schedules import ProtocolSpec, RoundRecord

__all__ = [
    'CsaflSpec', 'STALENESS_FNS', 'SeaflSpec', 'WEIGHTED_SCHEMES',
    'async_kwargs', 'precompute_async_schedule',
    'precompute_weighted_schedule', 'staleness_discount',
    'weighted_dispatch_budget', 'weighted_kwargs',
]

#: staleness-discount functions s(dt) of the FedAsync family (Xie et al.):
#: ``'constant'`` -> 1; ``'hinge'`` -> 1 if dt <= b else 1/(a*(dt-b)),
#: clamped to (0, 1]; ``'poly'`` -> (1+dt)^(-a).  The discount scales the
#: base mixing weight alpha, so every variant replays through the same
#: precomputed per-round alpha tensors.
STALENESS_FNS = ('constant', 'hinge', 'poly')

#: weight-row schemes of ``precompute_weighted_schedule``.  The scheme is
#: data, not code: members of one fleet sweep may mix schemes via
#: ``SweepMember.overrides={'scheme': ...}``.
WEIGHTED_SCHEMES = ('seafl', 'csafl', 'fedasync')


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


def weighted_kwargs(sp, mem=None) -> dict:
    """``precompute_weighted_schedule`` kwargs from a ``SeaflSpec`` /
    ``CsaflSpec`` (and optionally a ``SweepMember``).  ``overrides`` may
    switch ``scheme`` per member, to ``'fedasync'`` too, whose sequential
    merge folds into weight rows, so one fleet runs the whole family."""
    kw = dict(scheme='csafl' if isinstance(sp, CsaflSpec) else 'seafl',
              alpha=sp.alpha, staleness_fn=sp.staleness_fn,
              staleness_exp=sp.staleness_exp, hinge_a=sp.hinge_a,
              hinge_b=sp.hinge_b,
              use_loss=getattr(sp, 'use_loss', False),
              loss_coef=getattr(sp, 'loss_coef', 0.5),
              clusters=getattr(sp, 'clusters', 1))
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


def _fold_sequential(a: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Closed-form weights of the arrival-ordered sequential merge chain
    G := (1-a_k) G + a_k T_k: eff[k] = a_k * prod over later merges of
    (1 - a_l), computed as float64 suffix products.  The residual global
    weight 1 - sum(eff) equals prod(1 - a) by telescoping, so the fold is
    the chain up to float rounding (close to the sequential engine, not
    bit for bit)."""
    m = a.shape[0]
    a_ord = a[order].astype(np.float64)
    suffix = np.ones(m, dtype=np.float64)
    if m > 1:
        suffix[:-1] = np.cumprod((1.0 - a_ord)[::-1])[::-1][1:]
    eff = np.zeros(m, dtype=np.float64)
    eff[order] = a_ord * suffix
    return eff


def precompute_weighted_schedule(env, *, rounds: int, scheme: str = 'seafl',
                                 alpha: float = 0.6,
                                 staleness_fn: str = 'poly',
                                 staleness_exp: float = 0.5,
                                 hinge_a: float = 10.0, hinge_b: int = 4,
                                 use_loss: bool = False,
                                 loss_coef: float = 0.5,
                                 clusters: int = 1
                                 ) -> schedules.WeightedSchedule:
    """One host pass emitting [rounds, m] one-shot merge weight rows.

    The event process (crash draws, arrivals, commits, version/staleness
    bookkeeping) is FedAsync's, so staleness means the same thing across
    the family; the scheme only decides how a round's commits turn into
    ``wrow``:

    * ``'seafl'``: wrow = alpha * normalise(data_w * s(staleness)
      [* (1 + loss_coef/(1 + commits))]) over the committed set.  The
      optional loss term uses the commit-count deficit as a
      model-independent proxy for the under-trained-client loss signal
      (clients that merged rarely get boosted), so the precompute needs
      no model weights.
    * ``'csafl'``: clients are bucketed by ``cluster_by_profile``; within
      cluster g the commits sub-aggregate by data_w * s(staleness), and
      the cluster merges at weight alpha * s(rounds since g last merged)
      * W_g (its total data share).  Rows sum to <= alpha by construction
      (sum_g W_g = 1, discounts <= 1).
    * ``'fedasync'``: the per-arrival chain folded via
      ``_fold_sequential``: FedAsync as a member of the weighted fleet.

    Every row is zero off the committed set and sums to at most alpha
    <= 1 (the folded FedAsync's to 1 - prod(1 - a) < 1), so the merge's
    residual global weight stays non-negative."""
    if scheme not in WEIGHTED_SCHEMES:
        raise ValueError(
            f'unknown scheme {scheme!r} (want one of {WEIGHTED_SCHEMES})')
    m = env.m
    # CSAFL clusters on the *base* training profile (round-invariant, so
    # cluster membership is stable even under traces); arrivals use the
    # per-round trace/wire-aware timing
    full_tt = env.full_train_time()
    tim = env.round_timing(rounds)
    crashed_all, _ = env.draw_rounds(rounds)
    t_dist_m = env.t_dist(m)
    data_w = np.asarray(env.weights, dtype=float)
    versions = np.zeros(m, dtype=float)
    global_version = 0
    commits = np.zeros(m, dtype=float)        # seafl loss-proxy counter
    labels = selection.cluster_by_profile(full_tt, clusters)
    k = int(labels.max()) + 1
    cluster_w = np.bincount(labels, weights=data_w, minlength=k)
    last_merge = np.zeros(k, dtype=float)     # csafl per-cluster bookkeeping
    committed_s = np.zeros((rounds, m), bool)
    wrow_s = np.zeros((rounds, m))
    records = []

    def disc_of(x):
        return staleness_discount(x, staleness_fn,
                                  staleness_exp=staleness_exp,
                                  hinge_a=hinge_a, hinge_b=hinge_b)

    for t in range(1, rounds + 1):
        crashed = crashed_all[t - 1]
        arrival_base = t_dist_m \
            + (tim.t_down[t - 1] + tim.t_up[t - 1]) + tim.full_tt[t - 1]
        arrival = np.where(~crashed, arrival_base, np.inf)
        too_slow = arrival > env.t_lim
        committed = ~crashed & ~too_slow
        staleness = np.maximum(0.0, global_version - versions)
        disc = disc_of(staleness)
        i = t - 1
        committed_s[i] = committed

        if scheme == 'fedasync':
            a = np.where(committed, alpha * disc, 0.0)
            wrow_s[i] = _fold_sequential(a, np.argsort(arrival, kind='stable'))
        elif scheme == 'seafl':
            base = data_w * disc
            if use_loss:
                base = base * (1.0 + loss_coef / (1.0 + commits))
            base = np.where(committed, base, 0.0)
            tot = base.sum()
            if tot > 0:
                wrow_s[i] = alpha * base / tot
        else:  # csafl
            base = np.where(committed, data_w * disc, 0.0)
            intra_tot = np.bincount(labels, weights=base, minlength=k)
            cdisc = disc_of(np.maximum(0.0, (t - 1) - last_merge))
            scale = np.where(intra_tot > 0,
                             alpha * cdisc * cluster_w
                             / np.where(intra_tot > 0, intra_tot, 1.0), 0.0)
            wrow_s[i] = base * scale[labels]
            merged = np.unique(labels[committed])
            last_merge[merged] = t

        commits += committed
        global_version += int(committed.sum())
        versions[committed] = global_version
        records.append(_async_record(t, arrival, committed, crashed,
                                     staleness, env))

    return schedules.WeightedSchedule(committed=committed_s, wrow=wrow_s,
                                      records=records, futility=0.0)


def weighted_dispatch_budget(ex) -> int:
    """Kernel launches of one weighted-merge round (a fleet's: for all S
    members), the registry's ``dispatch_budget`` of SEAFL and CSAFL
    (``repro_torch.analysis`` rule T001): one merge on the packed path,
    plus the int8 wire's round trip (quantise and dequantise) when
    compressed."""
    merge = 1 if ex.use_kernel == 'packed' else 0
    return merge + (2 if ex.wire == 'int8' else 0)


# ---------------------------------------------------------------------------
# Protocol specs (registered in ``repro_torch.core.api``)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SeaflSpec(ProtocolSpec):
    """SEAFL-style adaptive weighted aggregation: one merge per round,
    committed clients weighted by data share x staleness discount,
    normalised over the committed set and scaled by ``alpha`` (the
    residual 1 - alpha stays on the previous global model).

    ``use_loss=True`` adds the loss-term boost 1 + loss_coef/(1 +
    commits), a model-independent proxy that favours clients whose
    updates rarely landed (see ``precompute_weighted_schedule``)."""
    alpha: float = 0.6
    staleness_fn: str = 'poly'
    staleness_exp: float = 0.5
    hinge_a: float = 10.0
    hinge_b: int = 4
    use_loss: bool = False
    loss_coef: float = 0.5


@dataclasses.dataclass(frozen=True)
class CsaflSpec(ProtocolSpec):
    """CSAFL-style clustered semi-async aggregation: clients are grouped
    host-side by timing profile (quantile buckets of
    ``Env.full_train_time()``), each cluster sub-aggregates its own
    commits, and clusters blend into the global model under their own
    rounds-since-last-merge discount.  ``clusters=1`` degenerates to
    plain adaptive weighting."""
    clusters: int = 2
    alpha: float = 0.6
    staleness_fn: str = 'poly'
    staleness_exp: float = 0.5
    hinge_a: float = 10.0
    hinge_b: int = 4

"""Client environment simulator (paper §IV-A) behind a declarative spec.

Reproduces the paper's experimental environment model:
  * local data sizes  n_k ~ N(mu, 0.3 mu), mu = n/m      (data imbalance)
  * client performance s_k ~ Exp(lambda=1) batches/sec   (heterogeneity)
  * independent crash probability cr per client per round (unreliability)
  * timing model Eq. 17-19: T_train = |B_k| E / s_k; up/down-link at
    1.40 Mbps per client; server distribution at ``server_bw_mbps``.

The declarative surface is :class:`EnvSpec` — a frozen dataclass
mirroring the protocol specs of ``repro_torch.api`` — whose ``.build()``
realizes an :class:`Env` (partitions, perf draws, rng streams, trace
arrays).  Two fields go beyond the paper's static model:

* ``traces`` — a ``repro_torch.fedsim.traces.TraceSpec`` giving per-round
  per-client availability / bandwidth / compute-speed multipliers
  (day/night cycles, Markov churn, device-class grids, replayed arrays).
  Constant all-ones traces are bit-identical to ``traces=None``.
* ``comm='wire'`` — derive the comm times from the *actual wire bytes*
  of the experiment's model under the active ``ExecSpec.wire``
  (``ops.comm_bytes``), instead of the static ``model_size_mb``.  The
  compressed int8 wire then genuinely shortens rounds and shifts
  CFCFM/FedCS selections — protocol outcomes, not just host throughput.

SAFA-specific realism: a crashed client keeps its partial progress
(``pending``) and *resumes* next round — that is the paper's straggler;
synchronous protocols discard partial progress on re-selection.

``FLEnv`` is the deprecated ad-hoc constructor, kept as a shim over
``EnvSpec(...).build()`` and golden-tested bit-identical to it.
"""
from __future__ import annotations

import dataclasses
import itertools
import warnings
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.fedsim.traces import (  # noqa: F401  (re-exported surface)
    ConstantTrace,
    DayNight,
    DeviceClass,
    DeviceClasses,
    MarkovChurn,
    Replay,
    TraceSpec,
    Traces,
)

__all__ = [
    'ConstantTrace', 'DayNight', 'DeviceClass', 'DeviceClasses', 'Env',
    'EnvSpec', 'FLEnv', 'MarkovChurn', 'Replay', 'RoundTiming', 'TraceSpec',
    'Traces', 'env_grid', 'validate_env_spec',
]

#: valid values of ``EnvSpec.comm``
COMM_MODES = ('static', 'wire')


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """Declarative environment spec: crash / timing / trace fields only.

    ``build()`` realizes it into an :class:`Env`; every build draws fresh
    partition/perf/round-draw streams from ``seed`` (and ``draw_seed``),
    so a spec passed to several experiments (or sweep members) replays
    the same population and event stream in each — specs are values,
    environments are consumables."""
    m: int                      # number of clients
    crash_prob: float           # cr
    dataset_size: int           # n
    batch_size: int             # B
    epochs: int                 # E
    t_lim: float                # round deadline (seconds)
    model_size_mb: float = 10.0
    client_bw_mbps: float = 1.40
    server_bw_mbps: float = 198.0   # ~0.404 s per model copy (paper tables)
    lambda_perf: float = 1.0
    seed: int = 0
    # Separate stream for the per-round crash draws.  ``None`` keeps the
    # seed's single-stream behaviour (round draws continue the partition/
    # perf stream); an int re-seeds only the round draws, so a multi-seed
    # fleet shares one population (same partitions, same task data) while
    # each member sees an independent crash/straggler history.
    draw_seed: Optional[int] = None
    #: per-round heterogeneity traces (see ``repro_torch.fedsim.traces``);
    #: ``None`` == the paper's static model.
    traces: Optional[TraceSpec] = None
    #: comm-time source: ``'static'`` uses ``model_size_mb``; ``'wire'``
    #: derives the up/downlink megabytes from the experiment model's
    #: actual wire bytes under the active ``ExecSpec.wire`` (the api
    #: layer injects them via ``Env.set_wire_mb`` before precompute).
    comm: str = 'static'

    def build(self) -> 'Env':
        """Realize the spec (validates fields, draws the population)."""
        return Env(self)

    def replace(self, **changes) -> 'EnvSpec':
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class RoundTiming:
    """Per-round per-client timing components, each ``[rounds, m]``:
    ``t_up``/``t_down`` model upload/download seconds, ``full_tt`` the
    full local training time.  Traceless environments return O(1)-memory
    broadcast views."""
    t_up: np.ndarray
    t_down: np.ndarray
    full_tt: np.ndarray


def validate_env_spec(spec: EnvSpec) -> None:
    """Field validation shared by ``EnvSpec.build`` and the api layer's
    ``check_compat`` (golden messages)."""
    if spec.m < 1:
        raise ValueError(f'm must be >= 1, got {spec.m}')
    if not 0.0 <= spec.crash_prob <= 1.0:
        raise ValueError(
            f'crash_prob must be in [0, 1], got {spec.crash_prob}')
    if spec.comm not in COMM_MODES:
        raise ValueError(
            f"unknown comm {spec.comm!r} (want 'static' or 'wire')")
    if spec.traces is not None and not isinstance(spec.traces, TraceSpec):
        raise TypeError(
            f'traces must be a fedsim TraceSpec (ConstantTrace/DayNight/'
            f'MarkovChurn/DeviceClasses/Replay), got '
            f'{type(spec.traces).__name__!r}')


class Env:
    """A realized environment: the spec's config fields as attributes,
    plus the drawn population (``partition_sizes``, ``perf``) and the
    round-draw rng.  Build from a spec (``EnvSpec(...).build()``).

    The rng stream is consumed by ``draw_rounds``/``draw_round`` exactly
    as the historical ``FLEnv`` consumed it — traces modulate the crash
    *threshold* the same uniforms are compared against, never the draws
    themselves, so constant traces reproduce the legacy schedules bit for
    bit."""

    def __init__(self, spec: EnvSpec):
        self._init_from_spec(spec)

    def _init_from_spec(self, spec: EnvSpec) -> None:
        validate_env_spec(spec)
        self.spec = spec
        for f in dataclasses.fields(spec):
            setattr(self, f.name, getattr(spec, f.name))
        rng = np.random.default_rng(self.seed)
        mu = self.dataset_size / self.m
        sizes = np.maximum(rng.normal(mu, 0.3 * mu, self.m), 1.0)
        self.partition_sizes = np.round(sizes).astype(int)
        self.n_batches = np.maximum(
            1, -(-self.partition_sizes // self.batch_size))
        # performance: batches per second, Exp(lambda); floor to avoid /0
        self.perf = np.maximum(
            rng.exponential(1.0 / self.lambda_perf, self.m), 1e-3)
        self._rng = rng if self.draw_seed is None \
            else np.random.default_rng(self.draw_seed)
        self._traces_cache = None       # (rounds, Traces)
        self._wire_mb = None            # (up_mb, down_mb) under comm='wire'
        self._draws_consumed = False    # set by draw_rounds (single-shot)

    # -- per-client constants -------------------------------------------------
    @property
    def weights(self) -> np.ndarray:
        """Aggregation weights n_k / n (Eq. 7)."""
        return self.partition_sizes / self.partition_sizes.sum()

    @property
    def has_traces(self) -> bool:
        return self.traces is not None

    @property
    def t_updown(self) -> float:
        """Static model upload-or-download time per client (Eq. 17 terms).
        Trace-aware precomputes use ``round_timing`` instead."""
        return self.model_size_mb * 8.0 / self.client_bw_mbps

    def t_dist(self, n_copies):
        """Server-side distribution overhead (Eq. 19).

        ``n_copies`` may be an int or an ndarray of per-round copy counts —
        the schedule precomputes call this with whole [rounds] (or
        [S, rounds]) count tensors at once."""
        return n_copies * self._dist_mb() * 8.0 / self.server_bw_mbps

    def full_train_time(self) -> np.ndarray:
        """T_train per client (Eq. 18), before any speed trace."""
        return self.n_batches * self.epochs / self.perf

    # -- wire-derived comm ------------------------------------------------------
    def set_wire_mb(self, up_mb: float, down_mb: float) -> None:
        """Install the wire-derived transfer sizes (``comm='wire'``): the
        api layer measures the experiment model's actual bytes under the
        active ``ExecSpec.wire`` (``ops.comm_bytes``) and injects them
        here before the schedule precompute runs."""
        self._wire_mb = (float(up_mb), float(down_mb))

    def _comm_mb(self):
        if self._wire_mb is not None:
            return self._wire_mb
        return self.model_size_mb, self.model_size_mb

    def _dist_mb(self) -> float:
        # server distribution ships the (uncompressed) global model
        return self._comm_mb()[1]

    # -- traces ---------------------------------------------------------------
    def round_traces(self, rounds: int) -> Optional[Traces]:
        """The realized ``[rounds, m]`` trace bundle (``None`` without
        traces).  Cached per ``rounds``; realization is deterministic in
        the trace spec's own seed and never touches the env rng."""
        if self.traces is None:
            return None
        if self._traces_cache is None or self._traces_cache[0] != rounds:
            self._traces_cache = (rounds,
                                  self.traces.realize(rounds, self.m))
        return self._traces_cache[1]

    def round_timing(self, rounds: int) -> RoundTiming:
        """Per-round timing components, trace- and wire-aware.

        Without traces the arrays are broadcast views of the static
        scalars, elementwise bit-equal to the legacy ``t_updown`` /
        ``full_train_time()`` expressions — which is what keeps the
        array-driven precomputes bit-identical to the historical scalar
        ones (regression-tested)."""
        up_mb, down_mb = self._comm_mb()
        base_tt = self.full_train_time()
        shape = (rounds, self.m)
        tr = self.round_traces(rounds)
        if tr is None:
            return RoundTiming(
                t_up=np.broadcast_to(
                    np.float64(up_mb * 8.0 / self.client_bw_mbps), shape),
                t_down=np.broadcast_to(
                    np.float64(down_mb * 8.0 / self.client_bw_mbps), shape),
                full_tt=np.broadcast_to(base_tt, shape))
        bw = self.client_bw_mbps * tr.bandwidth
        return RoundTiming(t_up=up_mb * 8.0 / bw,
                           t_down=down_mb * 8.0 / bw,
                           full_tt=base_tt / tr.speed)

    def _crash_threshold(self, rounds: int):
        """Per-round crash threshold the uniform draws are compared
        against.  ``availability == 1`` must keep the *exact*
        ``crash_prob`` float (``1 - (1 - cr)`` re-rounds), hence the
        where-guard; ``availability == 0`` gives threshold 1.0 — certain
        crash, since draws lie in [0, 1)."""
        tr = self.round_traces(rounds)
        if tr is None:
            return self.crash_prob
        a = tr.availability
        return np.where(a >= 1.0, self.crash_prob,
                        1.0 - a * (1.0 - self.crash_prob))

    # -- per-round draws -------------------------------------------------------
    def draw_round(self):
        """Returns (crashed [m] bool, crash_frac [m] in (0,1)) — crash_frac
        is the fraction of this round's work done before the crash.

        Legacy single-round form: it has no round index, so it uses the
        static ``crash_prob`` (traces apply through ``draw_rounds``)."""
        crashed = self._rng.random(self.m) < self.crash_prob
        crash_frac = self._rng.random(self.m)
        return crashed, crash_frac

    def draw_rounds(self, rounds: int):
        """Vectorised multi-round draw: (crashed [rounds, m] bool,
        crash_frac [rounds, m]).

        Consumes the generator stream in exactly the order ``rounds``
        sequential ``draw_round`` calls would (crash draw then frac draw per
        round), so schedule precompute reproduces the loop-driven event
        process bit for bit.  Availability traces raise the comparison
        threshold without touching the uniforms, so constant traces keep
        the legacy masks exactly.

        Single-shot per built env: a second call would silently continue
        the generator stream, so the "same" experiment replayed on a
        reused env gets different crash masks than a fresh one — a
        classic source of unreproducible sweeps.  Reuse raises; build a
        fresh env per experiment (or hand the declarative ``EnvSpec`` to
        the api layer, which builds one for you)."""
        if self._draws_consumed:
            raise RuntimeError(
                'env rng already consumed: draw_rounds() was called once '
                'before on this built Env, so a second schedule precompute '
                'would continue the generator stream and diverge from a '
                'fresh environment. Build a fresh env per experiment — '
                'EnvSpec(...).build() — or pass the EnvSpec itself to '
                'api.Experiment / api.SweepMember (the api layer builds '
                'each run its own env).')
        self._draws_consumed = True
        u = self._rng.random((rounds, 2, self.m))
        return u[:, 0, :] < self._crash_threshold(rounds), u[:, 1, :]


@dataclasses.dataclass
class FLEnv(Env):
    """Deprecated ad-hoc constructor — a shim over ``EnvSpec(...).build()``
    (bit-identical, regression-tested).  Spell new code as::

        env = EnvSpec(m=5, crash_prob=0.3, ...).build()

    or pass the ``EnvSpec`` itself to ``api.Experiment`` /
    ``api.SweepMember`` (the api layer builds it)."""
    m: int
    crash_prob: float
    dataset_size: int
    batch_size: int
    epochs: int
    t_lim: float
    model_size_mb: float = 10.0
    client_bw_mbps: float = 1.40
    server_bw_mbps: float = 198.0
    lambda_perf: float = 1.0
    seed: int = 0
    draw_seed: Optional[int] = None

    def __post_init__(self):
        warnings.warn(
            'fedsim.FLEnv is deprecated; spell it as '
            'fedsim.EnvSpec(...).build() (or pass the EnvSpec to '
            'api.Experiment / api.SweepMember — see docs/ARCHITECTURE.md, '
            '"Environment & traces")',
            DeprecationWarning, stacklevel=3)
        self._init_from_spec(EnvSpec(**{
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(FLEnv)}))


def env_grid(base: Union[dict, EnvSpec], **axes: Sequence) -> list:
    """Cartesian grid of environment specs for fleet sweeps.

    ``base`` is the shared ``EnvSpec`` (or a dict of its kwargs); each
    keyword argument names a spec field and a sequence of values, e.g.::

        env_grid(EnvSpec(m=5, crash_prob=0.3, dataset_size=506,
                         batch_size=5, epochs=3, t_lim=830.0, seed=3),
                 crash_prob=(0.3, 0.7), draw_seed=range(4))

    yields 8 environments sweeping crash rate x rng stream.  Axes vary in
    row-major order (last axis fastest), so the member index of a config
    is predictable.  Keep ``seed``/``m``/``dataset_size`` in ``base``
    when the fleet must share one client population (a shared Task needs
    shared partitions).

    An ``EnvSpec`` base returns ``EnvSpec``s (declarative — hand them to
    ``api.SweepMember``, which builds each member a fresh env); a dict
    base returns *built* ``Env``s, matching the historical FLEnv-list
    behaviour."""
    if isinstance(base, EnvSpec):
        specs = [base.replace(**dict(zip(axes, combo)))
                 for combo in itertools.product(*axes.values())]
        return specs
    keys = list(axes)
    envs = []
    for combo in itertools.product(*(axes[k] for k in keys)):
        kw = dict(base)
        kw.update(zip(keys, combo))
        envs.append(EnvSpec(**kw).build())
    return envs

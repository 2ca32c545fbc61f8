"""Trace-driven device heterogeneity: declarative trace specs realized as
``[rounds, m]`` availability / bandwidth / compute-speed arrays.

A :class:`TraceSpec` describes how a fleet's conditions vary over time;
``realize(rounds, m)`` expands it into a :class:`Traces` bundle of three
``[rounds, m]`` arrays the environment folds into its per-round crash
thresholds and timing draws (``Env.draw_rounds`` / ``Env.round_timing``):

* ``availability`` in [0, 1] — scales a client's survival probability.
  1.0 keeps the env's base ``crash_prob``; 0.0 means certainly crashed
  that round (the effective crash probability is
  ``1 - availability * (1 - crash_prob)``).
* ``bandwidth`` > 0 — multiplies ``client_bw_mbps`` (0.5 == half speed).
* ``speed`` > 0 — multiplies the client's training rate (``perf``).

All generators are deterministic functions of their own ``seed`` field:
realizing a trace never touches the env rng, so adding (or re-realizing)
traces cannot perturb the crash/straggler draw stream.  A constant trace
of all-ones is the identity — schedules under it are bit-identical to the
traceless environment (regression-tested).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np

__all__ = [
    'ConstantTrace', 'DayNight', 'DeviceClass', 'DeviceClasses',
    'MarkovChurn', 'Replay', 'TraceSpec', 'Traces',
]


@dataclasses.dataclass(frozen=True)
class Traces:
    """A realized trace bundle: three ``[rounds, m]`` float arrays (the
    constant generators return broadcast views, so an all-constant bundle
    costs O(1) memory at any scale)."""
    availability: np.ndarray
    bandwidth: np.ndarray
    speed: np.ndarray


def _bundle(rounds: int, m: int, availability, bandwidth, speed) -> Traces:
    """Broadcast-to-shape + range validation shared by every generator."""
    shape = (rounds, m)
    out = []
    for name, arr in (('availability', availability),
                      ('bandwidth', bandwidth), ('speed', speed)):
        a = np.broadcast_to(np.asarray(arr, dtype=float), shape)
        if name == 'availability':
            if a.min() < 0.0 or a.max() > 1.0:
                raise ValueError(
                    f'availability trace must lie in [0, 1], got range '
                    f'[{a.min()}, {a.max()}]')
        elif a.min() <= 0.0:
            raise ValueError(
                f'{name} trace must be > 0 (it scales a rate), got min '
                f'{a.min()}')
        out.append(a)
    return Traces(*out)


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Base class for declarative trace specs.  Frozen and hashable like
    the protocol specs; ``realize(rounds, m)`` is a pure function of the
    spec fields (generators seed their own rng)."""

    def realize(self, rounds: int, m: int) -> Traces:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ConstantTrace(TraceSpec):
    """Round-invariant conditions.  The all-defaults spelling is the
    identity trace: schedules under it are bit-identical to
    ``traces=None`` (the golden EnvSpec-vs-FLEnv contract)."""
    availability: float = 1.0
    bandwidth: float = 1.0
    speed: float = 1.0

    def realize(self, rounds: int, m: int) -> Traces:
        return _bundle(rounds, m, self.availability, self.bandwidth,
                       self.speed)


@dataclasses.dataclass(frozen=True)
class DayNight(TraceSpec):
    """Diurnal cycle: each client is 'day' for ``day_fraction`` of every
    ``period`` rounds and 'night' otherwise, with night-time availability
    / bandwidth / speed scaled down.  ``spread=True`` gives every client
    its own phase offset (timezones), drawn once from ``seed``."""
    period: int = 24
    day_fraction: float = 0.5
    night_availability: float = 0.25
    night_bandwidth: float = 1.0
    night_speed: float = 1.0
    spread: bool = True
    seed: int = 0

    def realize(self, rounds: int, m: int) -> Traces:
        if self.period < 1:
            raise ValueError(f'period must be >= 1, got {self.period}')
        if not 0.0 <= self.day_fraction <= 1.0:
            raise ValueError(
                f'day_fraction must be in [0, 1], got {self.day_fraction}')
        phase = np.random.default_rng(self.seed).integers(
            0, self.period, m) if self.spread else np.zeros(m, dtype=int)
        t = np.arange(rounds)[:, None]
        day = ((t + phase[None, :]) % self.period) \
            < self.day_fraction * self.period
        return _bundle(
            rounds, m,
            np.where(day, 1.0, self.night_availability),
            np.where(day, 1.0, self.night_bandwidth),
            np.where(day, 1.0, self.night_speed))


@dataclasses.dataclass(frozen=True)
class MarkovChurn(TraceSpec):
    """On/off churn: a two-state Markov chain per client.  An online
    client goes offline with probability ``p_off`` each round; an offline
    one returns with probability ``p_on``.  ``start_online`` is the
    fraction of clients online at round 0 (the first ``round(m * f)``
    ids, deterministically).  Offline rounds have availability 0 — the
    client certainly crashes (it is simply not there)."""
    p_off: float = 0.1
    p_on: float = 0.5
    start_online: float = 1.0
    seed: int = 0

    def realize(self, rounds: int, m: int) -> Traces:
        for name in ('p_off', 'p_on', 'start_online'):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f'{name} must be in [0, 1], got {v}')
        rng = np.random.default_rng(self.seed)
        u = rng.random((rounds, m))
        on = np.arange(m) < int(round(self.start_online * m))
        avail = np.zeros((rounds, m))
        for t in range(rounds):
            avail[t] = on
            on = np.where(on, u[t] >= self.p_off, u[t] < self.p_on)
        return _bundle(rounds, m, avail, 1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class DeviceClass:
    """One device tier of a heterogeneous fleet: multipliers applied to a
    member client's bandwidth, training speed, and availability."""
    name: str
    speed: float = 1.0
    bandwidth: float = 1.0
    availability: float = 1.0


@dataclasses.dataclass(frozen=True)
class DeviceClasses(TraceSpec):
    """Device-class grid: every client belongs to one :class:`DeviceClass`
    and inherits its multipliers for the whole run.  ``mix`` gives the
    class proportions (uniform when ``None``); assignment is blocked —
    client ids are split into contiguous runs sized by largest-remainder
    rounding of ``mix * m`` — so the layout is deterministic and a member
    override changing only ``mix`` shifts class boundaries predictably."""
    classes: Tuple[DeviceClass, ...]
    mix: Optional[Tuple[float, ...]] = None

    def assignments(self, m: int) -> np.ndarray:
        """[m] int class index per client (blocked largest-remainder)."""
        k = len(self.classes)
        if k == 0:
            raise ValueError('DeviceClasses needs at least one class')
        mix = np.full(k, 1.0 / k) if self.mix is None \
            else np.asarray(self.mix, dtype=float)
        if mix.shape != (k,) or mix.min() < 0 or mix.sum() <= 0:
            raise ValueError(
                f'mix must be {k} non-negative fractions, got {self.mix}')
        mix = mix / mix.sum()
        exact = mix * m
        counts = np.floor(exact).astype(int)
        rem = m - counts.sum()
        if rem:  # largest fractional remainders get the leftover clients
            counts[np.argsort(-(exact - counts), kind='stable')[:rem]] += 1
        return np.repeat(np.arange(k), counts)

    def realize(self, rounds: int, m: int) -> Traces:
        lab = self.assignments(m)
        col = lambda f: np.array([f(c) for c in self.classes])[lab]  # noqa: E731
        return _bundle(rounds, m,
                       col(lambda c: c.availability)[None, :],
                       col(lambda c: c.bandwidth)[None, :],
                       col(lambda c: c.speed)[None, :])


@dataclasses.dataclass(frozen=True, eq=False)
class Replay(TraceSpec):
    """Replay user-supplied trace arrays (e.g. measured fleet telemetry).
    Each field is broadcastable to ``[rounds, m]`` — scalars, ``[m]``
    per-client rows, or full ``[rounds, m]`` arrays; ``None`` means the
    neutral constant.  Compared by identity (``eq=False``): array fields
    have no useful value equality."""
    availability: Optional[Any] = None
    bandwidth: Optional[Any] = None
    speed: Optional[Any] = None

    def realize(self, rounds: int, m: int) -> Traces:
        def pick(v):
            return 1.0 if v is None else v
        try:
            return _bundle(rounds, m, pick(self.availability),
                           pick(self.bandwidth), pick(self.speed))
        except ValueError as e:
            if 'broadcast' in str(e):
                raise ValueError(
                    f'Replay traces must broadcast to [rounds={rounds}, '
                    f'm={m}]; got shapes '
                    f'{[np.shape(pick(v)) for v in (self.availability, self.bandwidth, self.speed)]}') \
                    from e
            raise

"""Schedule and result containers for the federation layer: per-round
records, run histories, sweep members, and the precomputed dense SAFA
mask schedules (one run's, and a fleet's stacked member-major) that the
engines replay.  The state machines that produce the schedules live in
``repro_torch.core.federation``; the engines that consume them in
``repro_torch.core.protocol``."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import protocol


@dataclasses.dataclass
class RoundRecord:
    round: int
    round_len: float
    t_dist: float
    eur: float
    sr: float
    vv: float
    n_picked: int
    n_committed: int
    n_crashed: int
    eval: Optional[dict] = None


@dataclasses.dataclass
class History:
    protocol: str
    records: list = dataclasses.field(default_factory=list)
    futility: float = 0.0
    best_eval: Optional[dict] = None
    final_global: Any = None

    def mean(self, field: str) -> float:
        return float(np.mean([getattr(r, field) for r in self.records]))

    def evals(self):
        return [(r.round, r.eval) for r in self.records if r.eval is not None]


@dataclasses.dataclass
class SweepMember:
    """One simulation in a fleet sweep: its own environment and SAFA
    hyper-parameters.  All members of a sweep share the client count
    ``m``; they share the Task too unless the sweep carries per-member
    Tasks (``api.SweepSpec(tasks=...)``, padded stacking)."""
    #: the member's environment: an ``fedsim.EnvSpec`` (declarative: the
    #: sweep builds each member a fresh env, and ``overrides`` may then
    #: rewrite env fields) or a built ``Env``
    env: Any
    fraction: float = 0.5
    lag_tolerance: int = 5
    seed: int = 0               # numeric-init seed
    #: ``EnvSpec`` field overrides (``crash_prob``, ``traces``,
    #: ``draw_seed``, ...) applied to the member's declarative env at sweep
    #: resolution; SAFA takes no protocol-field overrides.  ``None`` == no
    #: overrides.
    overrides: Optional[dict] = None


@dataclasses.dataclass
class SafaSchedule:
    """Precomputed SAFA event process: [rounds, m] bool mask schedules plus
    the timing records they imply.  Independent of model weights."""
    sync: np.ndarray
    committed: np.ndarray
    picked: np.ndarray
    undrafted: np.ndarray
    deprecated: np.ndarray
    records: list
    futility: float

    @property
    def rounds(self) -> int:
        return self.sync.shape[0]

    def to_device(self, device) -> protocol.RoundSchedule:
        """One host->device hop for the whole run."""
        def put(a):
            return torch.as_tensor(a, device=device)
        return protocol.RoundSchedule(
            sync=put(self.sync), completed=put(self.committed),
            picked=put(self.picked), undrafted=put(self.undrafted),
            deprecated=put(self.deprecated),
            round_idx=torch.arange(1, self.rounds + 1, dtype=torch.int32,
                                   device=device))


# ---------------------------------------------------------------------------
# Fleet-major stacking: [S, rounds, m] schedules for batched sweeps
# ---------------------------------------------------------------------------

class _FleetStack:
    """Fleet-major stacking of single-run schedules.  Subclasses set
    ``MASKS`` (the [S, rounds, m] field names, the first one fixing the
    shapes) and ``_MEMBER_CLS`` (the single-run schedule type)."""
    MASKS: tuple = ()
    _MEMBER_CLS = None

    @property
    def size(self) -> int:
        return getattr(self, self.MASKS[0]).shape[0]

    @property
    def rounds(self) -> int:
        return getattr(self, self.MASKS[0]).shape[1]

    @classmethod
    def stack(cls, members: list):
        """Stack S single-run schedules (all with the same rounds and m)."""
        if len({getattr(s, cls.MASKS[0]).shape for s in members}) != 1:
            raise ValueError('fleet members must share (rounds, m)')
        return cls(**{k: np.stack([getattr(s, k) for s in members])
                      for k in cls.MASKS},
                   records=[s.records for s in members],
                   futility=np.array([s.futility for s in members]))

    def member(self, s: int):
        """Member s's schedule, identical to its own precompute."""
        return self._MEMBER_CLS(
            **{k: getattr(self, k)[s] for k in self.MASKS},
            records=self.records[s], futility=float(self.futility[s]))

    def _round_idx(self, device) -> torch.Tensor:
        """[S, rounds] per-member round indices for ``to_device``."""
        return torch.arange(1, self.rounds + 1, dtype=torch.int32,
                            device=device).expand(self.size, self.rounds)


@dataclasses.dataclass
class FleetSchedule(_FleetStack):
    """S independent SAFA event processes stacked fleet-major.

    Mask arrays are [S, rounds, m]; ``records[s]`` / ``futility[s]`` hold
    member s's timing records and futility ratio, exactly as
    ``precompute_safa_schedule`` produces them."""
    sync: np.ndarray
    committed: np.ndarray
    picked: np.ndarray
    undrafted: np.ndarray
    deprecated: np.ndarray
    records: list
    futility: np.ndarray

    MASKS = ('sync', 'committed', 'picked', 'undrafted', 'deprecated')
    _MEMBER_CLS = SafaSchedule

    def to_device(self, device) -> protocol.RoundSchedule:
        """One host->device hop for the whole fleet: [S, rounds, m] masks
        and [S, rounds] round indices (``RoundSchedule.fleet_segment``
        cuts it into eval segments)."""
        def put(a):
            return torch.as_tensor(a, device=device)
        return protocol.RoundSchedule(
            sync=put(self.sync), completed=put(self.committed),
            picked=put(self.picked), undrafted=put(self.undrafted),
            deprecated=put(self.deprecated),
            round_idx=self._round_idx(device))

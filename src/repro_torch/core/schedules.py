"""Schedule and result containers for the federation layer: per-round
records, run histories and the precomputed dense SAFA mask schedule that
the engines replay.  The state machine that produces the schedule lives in
``repro_torch.core.federation``; the engines that consume it in
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

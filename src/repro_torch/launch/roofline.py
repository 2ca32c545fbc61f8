"""Roofline terms of a dry-run cell on NVIDIA H100 SXM cards.

    compute = FLOPs      / (chips * peak bf16 FLOP/s)
    memory  = HBM bytes  / (chips * HBM bytes/s)

The FLOPs and bytes are the analytic estimates (``analytic``).  The
constants are one H100 SXM's, from NVIDIA's data sheet: 989 TFLOP/s
dense bf16 on the tensor cores, 3.35 TB/s of HBM3, 80 GB of it.  The
port has no compiled program whose collectives could be counted (the
reference parses them from XLA's HLO), and it runs on one card, so a
row has no collective term: ``coll_bytes`` and ``t_collective_s`` are
``None``, and the bottleneck is compute or memory.  Collectives come
with several cards (ROADMAP item 20).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# H100 SXM per-card constants (NVIDIA data sheet)
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12                # B/s
HBM_BYTES = 80e9                # B


@dataclasses.dataclass
class Roofline:
    flops: float                # total FLOPs (whole step, all chips)
    hbm_bytes: float            # total bytes accessed
    chips: int
    model_flops: float = 0.0    # 6*N*D useful-FLOPs estimate

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS_BF16)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def bottleneck(self) -> str:
        return 'compute' if self.t_compute >= self.t_memory else 'memory'

    @property
    def useful_ratio(self) -> Optional[float]:
        if self.model_flops and self.flops:
            return self.model_flops / self.flops
        return None

    def as_dict(self) -> dict:
        return {
            'flops': self.flops, 'hbm_bytes': self.hbm_bytes,
            'coll_bytes': None, 'chips': self.chips,
            't_compute_s': self.t_compute, 't_memory_s': self.t_memory,
            't_collective_s': None,
            'bottleneck': self.bottleneck,
            'model_flops': self.model_flops,
            'useful_ratio': self.useful_ratio,
        }


def model_flops_estimate(n_active_params: int, tokens: int,
                         kind: str) -> float:
    """MODEL_FLOPS = 6 * N * D for training, 2 * N * D for inference
    (N = active params for MoE)."""
    mult = 6.0 if kind == 'train' else 2.0
    return mult * n_active_params * tokens

"""Holistic protocol metrics (Eq. 4, 5, 9, 10)."""
from __future__ import annotations

import numpy as np


def eur_measured(picked: np.ndarray, crashed: np.ndarray) -> float:
    """Eq. 4: |P - P∩K| / |M|."""
    m = picked.shape[0]
    return float((picked & ~crashed).sum()) / m


def eur_theory_safa(C: float, R: float) -> float:
    """Eq. 5: post-training selection EUR."""
    return 1 - R if C >= 1 - R else C


def eur_theory_fedavg(C: float, R: float) -> float:
    """§III-B: selection-ahead-of-training EUR = C (1 - |K|/|M|)."""
    return C * (1 - R)


def sync_ratio(sync_counts, m: int, rounds: int) -> float:
    """Eq. 9, accumulated per-round sync counts."""
    return float(np.sum(sync_counts)) / (rounds * m)


def version_variance(version_lists) -> float:
    """Eq. 10: mean over rounds of var(V_t)."""
    vs = [np.var(v) for v in version_lists if len(v)]
    return float(np.mean(vs)) if vs else 0.0

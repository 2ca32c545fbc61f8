"""The quota-bounded environment of the JAX package's scale benchmark
(``benchmarks/scale.py``, ``make_scale_env``) with the Task 2 data,
batch and epochs, and SAFA's schedules on it: the environment whose
sparse and lag-tier schedules give the rows and tier kernels their
shapes at m = 1000 and m = 10,000."""
from __future__ import annotations

import numpy as np

from repro_torch.fedsim import EnvSpec

__all__ = ['scale_schedule', 'scale_spec']


def scale_spec(seed: int = 0, m: int = 1000, quota: int = 50) -> EnvSpec:
    """m clients, crash 0, communication negligible, t_lim pinned at the
    2.5 x ``quota``-th fastest client of the env of ``seed``, so that
    SAFA's active set stays near 2.5 x quota whatever m."""
    from repro_torch.configs import PAPER_TASKS
    cfg = PAPER_TASKS['task2_cnn']
    spec = EnvSpec(m=m, crash_prob=0.0,
                   dataset_size=cfg['dataset_size'],
                   batch_size=cfg['batch_size'], epochs=cfg['epochs'],
                   t_lim=1e9, seed=seed, model_size_mb=1e-3)
    env = spec.build()
    base = env.t_updown + env.full_train_time()
    k = min(m - 1, int(round(2.5 * quota)))
    return spec.replace(t_lim=float(np.partition(base, k)[k]))


def scale_schedule(rounds: int, seed: int = 0, form: str = 'sparse',
                   m: int = 1000, quota: int = 50):
    """SAFA's sparse (or lag-tier) schedule on ``scale_spec(seed, m,
    quota)``: fraction quota / m, lag tolerance 10 x rounds, as the JAX
    package's scale benchmark sets them."""
    from repro_torch.core import federation
    return federation.precompute_safa_schedule(
        scale_spec(seed, m, quota).build(), fraction=quota / m,
        lag_tolerance=10 * rounds, rounds=rounds, form=form)

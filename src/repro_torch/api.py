"""Public experiment API of the port, the single entry point for running
protocols: a spec (``SafaSpec``, ``FedAvgSpec``, ``FedCSSpec``,
``LocalSpec``, ``FedAsyncSpec``, ``SeaflSpec``, ``CsaflSpec``) +
``ExecSpec`` -> ``Experiment(...).compile().run()`` / ``.run_sweep()``.
The implementation lives in ``repro_torch.core.api``; the
staleness-adaptive aggregation family's specs and precomputes in
``repro_torch.core.agg_schemes``."""
from repro_torch.core import api as _impl
from repro_torch.core.agg_schemes import (  # noqa: F401
    WEIGHTED_SCHEMES, CsaflSpec, SeaflSpec, precompute_weighted_schedule,
    staleness_discount)
from repro_torch.core.api import *  # noqa: F401,F403

__all__ = list(_impl.__all__) + [
    'CsaflSpec', 'SeaflSpec', 'WEIGHTED_SCHEMES',
    'precompute_weighted_schedule', 'staleness_discount',
]

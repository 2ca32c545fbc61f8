"""Public experiment API of the port — the single entry point for running
SAFA: ``SafaSpec`` + ``ExecSpec`` -> ``Experiment(...).compile().run()``.
The implementation lives in ``repro_torch.core.api``."""
from repro_torch.core import api as _impl
from repro_torch.core.api import *  # noqa: F401,F403

__all__ = list(_impl.__all__)

"""Carry model weights between the JAX package and the port.

Both packages hold a model as a dict of arrays with the same keys, shapes
and layouts (HWIO convolutions, [in, out] dense weights), so conversion is
a copy of each leaf."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device


def params_from_jax(tree, device='cuda') -> dict:
    """A dict of array-likes (numpy, or JAX arrays already fetched to the
    host) -> the port's params on ``device``, dtypes kept."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v)).to(dev) for k, v in tree.items()}


def params_to_numpy(params: dict) -> dict:
    """The port's params -> a dict of numpy arrays on the host."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}

"""Carry model weights between the JAX package and the port.

Both packages hold a model as a (possibly nested) dict of arrays with the
same keys, shapes and layouts (HWIO convolutions, [in, out] dense weights,
layers stacked on a leading [L, ...] axis), so conversion is a copy of
each leaf.  bf16 leaves cross as their 16-bit patterns: numpy holds a JAX
bf16 array as an ``ml_dtypes.bfloat16`` array, which ``torch.as_tensor``
refuses, so the bits go across as int16 and are viewed as
``torch.bfloat16`` (and back), and a round trip is bit for bit."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device


def _to_torch(v, dev: torch.device) -> torch.Tensor:
    a = np.array(v)
    if a.dtype.name == 'bfloat16':
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.as_tensor(a).to(dev)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bf16 type; needed only for bf16 leaves
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree, device='cuda') -> dict:
    """A (nested) dict of array-likes (numpy, or JAX arrays already
    fetched to the host) -> the port's params on ``device``, dtypes
    kept."""
    dev = resolve_device(device)

    def conv(t):
        return {k: conv(v) if isinstance(v, dict) else _to_torch(v, dev)
                for k, v in t.items()}
    return conv(tree)


def params_to_numpy(params: dict) -> dict:
    """The port's (nested) params -> the same tree of numpy arrays on the
    host."""
    return {k: params_to_numpy(v) if isinstance(v, dict) else _to_numpy(v)
            for k, v in params.items()}

"""Optimizers as pure transforms of parameter dicts.

Clients in the paper use plain mini-batch SGD (Algorithm 2)."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]  # (grads, state, params) -> (new_params, new_state)


def sgd(lr: float) -> Optimizer:
    def init(params):
        del params
        return ()

    def update(grads, state, params):
        del state
        return {k: p - lr * grads[k].to(p.dtype) for k, p in params.items()}, ()

    return Optimizer(init, update)

"""Optimizers as pure transforms of parameter trees (nested dicts of
tensors), with the reference's arithmetic and dtypes.

Clients in the paper use plain mini-batch SGD (Algorithm 2); AdamW is
provided for the LLM-scale silo-mode examples."""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]  # (grads, state, params) -> (new_params, new_state)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


def tree_leaves(tree) -> list:
    """The leaves in sorted-key order (the reference's flattening)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += tree_leaves(v) if isinstance(v, dict) else [v]
    return out


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params):
        if momentum == 0.0:
            return tree_map(lambda p, g: p - lr * g.to(p.dtype), params,
                            grads), ()
        vel = tree_map(lambda v, g: momentum * v + g, state, grads)
        new = tree_map(lambda p, v: p - lr * v.to(p.dtype), params, vel)
        return new, vel

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        first = tree_leaves(params)[0]
        return {'mu': tree_map(zeros, params), 'nu': tree_map(zeros, params),
                'count': torch.zeros((), dtype=torch.int32,
                                     device=first.device)}

    def update(grads, state, params):
        count = state['count'] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state['mu'], grads)
        nu = tree_map(lambda n, g: b2 * n + (1 - b2) * torch.square(g.float()),
                      state['nu'], grads)
        c1 = 1 - b1 ** count.float()
        c2 = 1 - b2 ** count.float()

        def step(p, m, n):
            upd = (m / c1) / (torch.sqrt(n / c2) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.float()
            return (p.float() - lr * upd).to(p.dtype)

        new = tree_map(step, params, mu, nu)
        return new, {'mu': mu, 'nu': nu, 'count': count}

    return Optimizer(init, update)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so their global L2 norm is at most ``max_norm``, that
    norm before scaling); the norm sums the leaves in f32 in sorted-key
    order."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)))
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm

"""Public model facade: build once from a ModelConfig, use everywhere."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.models import common as cm
from repro_torch.models import decode as dec
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # -- parameters --------------------------------------------------------
    def init(self, seed=0, device='cuda'):
        """Concrete parameters from ``seed`` (an int, drawn by a generator
        on ``device``) or from a ``torch.Generator`` (on its own device).
        At full width keep the generator on the card: every tensor is
        drawn where it lives."""
        if isinstance(seed, torch.Generator):
            generator = seed
        else:
            generator = torch.Generator(device=resolve_device(device))
            generator.manual_seed(int(seed))
        return tfm.init_params(generator, self.cfg)

    def param_axes(self):
        """The tree of each parameter's logical axis names, the
        reference's (stacked layers lead with ``'layers'``); no storage,
        no compute."""
        return tfm.init_params(cm.AXES, self.cfg)

    def param_shapes(self):
        """The param tree as ``meta`` tensors (no storage, no compute)."""
        return tfm.init_params(None, self.cfg)

    def n_params(self) -> int:
        def count(tree):
            return sum(count(v) if isinstance(v, dict) else math.prod(v.shape)
                       for v in tree.values())
        return count(self.param_shapes())

    # -- forward ------------------------------------------------------------
    def loss(self, params, batch):
        """The training loss (``transformer.loss_fn``): a 0-d f32 tensor,
        differentiable in ``params`` with ``attn_impl='flash_jnp'``."""
        return tfm.loss_fn(params, batch, self.cfg)

    def logits(self, params, batch):
        return tfm.forward_logits(params, batch, self.cfg)

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, length: int = 0,
                   device='cuda'):
        return dec.init_cache(self.cfg, batch, max_len, length, device)

    def decode_step(self, params, cache, tokens):
        return dec.decode_step(params, cache, tokens, self.cfg)

    def prefill(self, params, cache, tokens):
        return dec.prefill(params, cache, tokens, self.cfg)


def build_model(cfg: ModelConfig) -> Model:
    """The model of ``cfg``: any of the reference's families (dense, MoE,
    SSM, hybrid, VLM, audio); raises ``ValueError`` for another."""
    tfm.check_family(cfg)
    return Model(cfg)

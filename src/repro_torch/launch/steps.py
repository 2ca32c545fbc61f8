"""Serving steps of the global (aggregated) model.

``ServeSetup`` is the reference's, without the shardings (the port runs
on one card): ``prefill_step`` is the bulk prefill through
``forward_logits`` (with ``attn_impl='pallas'`` it launches kernel 21 once
per causal attention layer, or application of the hybrid family's shared
block; the audio encoder's and the cross-attention take the plain path),
``serve_step`` one decode step against the model's caches.  The
``*_batch`` methods describe their inputs as ``meta`` tensors, as the
reference's give ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.model import Model


@dataclasses.dataclass
class ServeSetup:
    model: Model

    def prefill_batch(self, shape):
        """{'tokens': [global_batch, seq_len] int32} for ``shape`` (an
        ``InputShape``), as meta tensors; the VLM adds 'patch_embeds'
        [global_batch, n_patches, d_model], audio 'frame_embeds'
        [global_batch, enc_seq, d_model], both f32."""
        cfg = self.model.cfg
        B = shape.global_batch
        batch = {'tokens': torch.empty((B, shape.seq_len), dtype=torch.int32,
                                       device='meta')}
        extra = {'vlm': ('patch_embeds', cfg.n_patches),
                 'audio': ('frame_embeds', cfg.enc_seq)}.get(cfg.family)
        if extra:
            batch[extra[0]] = torch.empty((B, extra[1], cfg.d_model),
                                          dtype=torch.float32, device='meta')
        return batch

    def prefill_step(self, params, batch):
        """Next token of every row: argmax of the last position's logits."""
        logits, _ = self.model.logits(params, batch)
        return logits[:, -1].argmax(-1)

    def decode_batch(self, shape):
        """(cache, tokens) for one decode step with a full seq_len cache
        (audio: and its zero cross caches), as meta tensors."""
        B, S = shape.global_batch, shape.seq_len
        cache = self.model.init_cache(B, S, length=S - 1, device='meta')
        return cache, torch.empty((B, 1), dtype=torch.int32, device='meta')

    def serve_step(self, params, cache, tokens):
        """One decode step (the cache updated in place); returns (cache,
        next token [B])."""
        cache, logits = self.model.decode_step(params, cache, tokens)
        return cache, logits.argmax(-1)

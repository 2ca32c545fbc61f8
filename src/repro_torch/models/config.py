"""Model configuration shared by all assigned architecture families.

A copy of the JAX package's ``ModelConfig``, field for field and with the
same defaults, except ``dtype``, which is a ``torch.dtype``.

``attn_impl`` keeps the reference's two values, so that a configuration
compares equal across the packages:

* ``'flash_jnp'``: the plain blocked online-softmax path
  (``models.attention.flash_attention``);
* ``'pallas'``: the port's hand-written CUDA kernel 21
  (``kernels.swa_attention.swa_attention``, ``csrc/swa_attention.cu``) on
  CUDA tensors, its plain version on CPU tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int = 0                  # 0 for attention-free (ssm)
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    mlp_kind: str = 'swiglu'          # swiglu | relu2 | gelu
    qk_norm: bool = False
    window: Optional[int] = None      # sliding-window attention size
    rope_theta: float = 10000.0
    # MoE
    n_experts: int = 0
    capacity_factor: float = 1.25
    moe_shared_expert: bool = True
    moe_every: int = 1                # llama4-maverick: MoE every 2nd layer
    # SSM / hybrid
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    attn_every: int = 0               # hybrid: shared attn block every k ssm layers
    # encoder-decoder (audio)
    enc_layers: int = 0
    enc_seq: int = 1500               # stubbed frame-embedding length
    # vlm
    n_patches: int = 0                # stubbed patch-embedding count
    # numerics / structure
    dtype: Any = torch.bfloat16
    remat: bool = True
    vocab_pad_multiple: int = 256
    # attention blocking for the flash path
    q_block: int = 512
    kv_block: int = 512
    attn_impl: str = 'flash_jnp'      # flash_jnp | pallas (CUDA kernel 21)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return int(-(-self.vocab_size // m) * m)

    def reduced(self, **overrides) -> 'ModelConfig':
        """Smoke-test variant of the same family: 2 layers, tiny dims."""
        small = dict(
            n_layers=2,
            d_model=min(self.d_model, 256),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_chunk=16 if self.ssm_state else 128,
            enc_layers=2 if self.enc_layers else 0,
            enc_seq=8 if self.enc_layers else self.enc_seq,
            n_patches=4 if self.n_patches else 0,
            attn_every=2 if self.attn_every else 0,
            window=min(self.window, 8) if self.window else None,
            dtype=torch.float32,
            remat=False,
            vocab_pad_multiple=64,
            q_block=16,
            kv_block=16,
        )
        if self.n_heads:
            d_model = small['d_model']
            hd = 32
            small['n_heads'] = max(1, d_model // hd)
            small['n_kv_heads'] = max(1, min(self.n_kv_heads, small['n_heads']))
            # keep GQA ratio valid
            while small['n_heads'] % small['n_kv_heads']:
                small['n_kv_heads'] -= 1
        else:
            small['n_heads'] = 0
            small['n_kv_heads'] = 0
        small['ssm_headdim'] = 32 if self.ssm_state else self.ssm_headdim
        small.update(overrides)
        return dataclasses.replace(self, **small)

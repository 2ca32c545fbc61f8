"""internvl2-26b [vlm] — InternViT + InternLM2 [arXiv:2404.16821].
48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.

The InternViT-6B vision tower is STUBBED per the assignment carve-out:
``input_specs`` provides precomputed patch embeddings [B, n_patches, d_model]
which the language backbone consumes through a learned projector
(early fusion: patches prepended to the token sequence).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id='internvl2-26b',
    family='vlm',
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,      # padded to 92672 internally (vocab_pad_multiple)
    mlp_kind='swiglu',
    n_patches=256,
)

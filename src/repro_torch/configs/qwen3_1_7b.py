"""qwen3-1.7b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B].
28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id='qwen3-1.7b',
    family='dense',
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab_size=151936,
    mlp_kind='swiglu',
    qk_norm=True,
    rope_theta=1000000.0,
)

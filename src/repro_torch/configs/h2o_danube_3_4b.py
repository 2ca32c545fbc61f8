"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention
[arXiv:2401.16818].  24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id='h2o-danube-3-4b',
    family='dense',
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    mlp_kind='swiglu',
    window=4096,          # sliding-window attention (mistral-style)
    rope_theta=10000.0,
)

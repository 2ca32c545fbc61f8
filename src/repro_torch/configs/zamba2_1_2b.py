"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].  38L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=32000,
ssm_state=64.  The shared transformer block (attention + MLP with *shared
weights*) is applied every 6 Mamba2 layers.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id='zamba2-1.2b',
    family='hybrid',
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    mlp_kind='swiglu',
    ssm_state=64,
    ssm_headdim=64,
    attn_every=6,
)

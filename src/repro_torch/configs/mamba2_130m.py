"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060].
24L d_model=768 (attention-free) vocab=50280, ssm_state=128.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id='mamba2-130m',
    family='ssm',
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_chunk=128,
)

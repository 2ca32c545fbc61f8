"""llama4-scout-17b-a16e [moe] — 16 experts, top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1 +
shared expert.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id='llama4-scout-17b-a16e',
    family='moe',
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    mlp_kind='swiglu',
    n_experts=16,
    moe_shared_expert=True,
)

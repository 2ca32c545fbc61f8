"""nemotron-4-340b [dense] — GQA, squared-ReLU [arXiv:2402.16819].
96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id='nemotron-4-340b',
    family='dense',
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    mlp_kind='relu2',
)

"""whisper-medium [audio] — encoder-decoder, conv frontend stubbed
[arXiv:2212.04356].  24L(enc) + 24L(dec) d_model=1024 16H (kv=16) d_ff=4096
vocab=51865.

The mel-spectrogram + conv feature extractor is STUBBED per the assignment
carve-out: ``input_specs`` provides precomputed frame embeddings
[B, enc_seq=1500, d_model] consumed by the transformer encoder.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id='whisper-medium',
    family='audio',
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    mlp_kind='gelu',
    enc_layers=24,
    enc_seq=1500,
)

"""Gemma-7B [dense]: GeGLU, head_dim=256.

28L d_model=3072 16H (kv=16, MHA) d_ff=24576 vocab=256000
[arXiv:2403.08295; hf]
"""
from repro_torch.configs.base import ArchConfig, _shrink

CONFIG = ArchConfig(
    name="gemma_7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24_576, vocab_size=256_000,
    act="geglu", norm="rmsnorm", rope_theta=10_000.0, tie_embeddings=True,
)


def reduced() -> ArchConfig:
    return _shrink(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                   head_dim=16, d_ff=256, vocab_size=256)

"""Qwen2.5-3B [dense]: GQA with QKV bias.

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936
[hf:Qwen/Qwen2.5-0.5B family; hf]
"""
from repro_torch.configs.base import ArchConfig, _shrink

CONFIG = ArchConfig(
    name="qwen2_5_3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11_008, vocab_size=151_936,
    qkv_bias=True, act="swiglu", norm="rmsnorm", rope_theta=1_000_000.0,
    tie_embeddings=True,
)


def reduced() -> ArchConfig:
    return _shrink(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=256, vocab_size=256)

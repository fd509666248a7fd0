"""Qwen2-7B [dense]: GQA with QKV bias.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 [arXiv:2407.10671; hf]
"""
from repro_torch.configs.base import ArchConfig, _shrink

CONFIG = ArchConfig(
    name="qwen2_7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18_944, vocab_size=152_064,
    qkv_bias=True, act="swiglu", norm="rmsnorm", rope_theta=1_000_000.0,
)


def reduced() -> ArchConfig:
    return _shrink(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=256, vocab_size=256)

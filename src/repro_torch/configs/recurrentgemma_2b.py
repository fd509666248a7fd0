"""RecurrentGemma-2B [hybrid]: RG-LRU + local attention, 1:2 pattern.

26L d_model=2560 10H (GQA kv=1, MQA) d_ff=7680 vocab=256000
[arXiv:2402.19427; hf]. head_dim=256, GeGLU, window 2048.
26 layers = 8 x (rglru, rglru, local_attn) + 2 rglru (see DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig, RGLRUConfig, _shrink

CONFIG = ArchConfig(
    name="recurrentgemma_2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256_000,
    act="geglu", norm="rmsnorm", rope_theta=10_000.0,
    tie_embeddings=True, attn_kind="local",
    rglru=RGLRUConfig(lru_width=2560, d_conv=4, window=2048),
)


def reduced() -> ArchConfig:
    return _shrink(CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv_heads=1,
                   head_dim=16, d_ff=192, vocab_size=256,
                   rglru=RGLRUConfig(lru_width=64, d_conv=4, window=32))

"""Mamba2-780m [ssm]: SSD (state-space duality), attention-free.

48L d_model=1536 vocab=50280 ssm_state=128 [arXiv:2405.21060; unverified].
d_inner = 2*d = 3072, head_dim 64 -> 48 SSD heads, conv width 4, chunk 256.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, _shrink

CONFIG = ArchConfig(
    name="mamba2_780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=48, n_kv_heads=48,
    d_ff=0, vocab_size=50_280, pos="none", norm="rmsnorm",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256),
)


def reduced() -> ArchConfig:
    return _shrink(CONFIG, n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
                   vocab_size=256,
                   ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                                 chunk_size=32))

"""MusicGen-Medium [audio]: decoder-only LM over EnCodec tokens.

48L d_model=1536 24H (kv=24, i.e. MHA) d_ff=6144 vocab=2048
[arXiv:2306.05284; hf]. Non-gated GELU FFN (4x), sinusoidal positions,
LayerNorm. The EnCodec frontend is a stub: input_specs() provides token ids
(precomputed frame tokens); the 4-codebook interleaving of the real system is
collapsed to a single stream (backbone-only per assignment).
"""
from repro_torch.configs.base import ArchConfig, _shrink

CONFIG = ArchConfig(
    name="musicgen_medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=2048,
    act="gelu", norm="layernorm", pos="sinusoidal",
    qkv_bias=False, frontend="audio_tokens",
)


def reduced() -> ArchConfig:
    return _shrink(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                   d_ff=256, vocab_size=128)

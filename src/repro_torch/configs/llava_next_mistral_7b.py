"""LLaVA-NeXT (Mistral-7B backbone) [vlm]: anyres tiling frontend stub.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].
The vision tower is a STUB per assignment: input_specs() provides precomputed
patch embeddings (n_patch_tokens per image, anyres base tile 576 patches)
that are prepended to the token embeddings.
"""
from repro_torch.configs.base import ArchConfig, _shrink

CONFIG = ArchConfig(
    name="llava_next_mistral_7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14_336, vocab_size=32_000,
    act="swiglu", norm="rmsnorm", rope_theta=1_000_000.0,
    frontend="vision_patches", n_patch_tokens=576,
)


def reduced() -> ArchConfig:
    return _shrink(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=256, vocab_size=256, n_patch_tokens=8)

"""Llama-3 405B [dense]: GQA, 128k vocab.

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256
[arXiv:2407.21783; unverified]. FSDP + bf16 optimizer moments are required to
fit 256 x 16GB chips (see EXPERIMENTS.md §Dry-run memory table).
"""
from repro_torch.configs.base import ArchConfig, _shrink

CONFIG = ArchConfig(
    name="llama3_405b", family="dense",
    n_layers=126, d_model=16_384, n_heads=128, n_kv_heads=8,
    d_ff=53_248, vocab_size=128_256,
    act="swiglu", norm="rmsnorm", rope_theta=500_000.0,
    fsdp=True, opt_dtype="bfloat16",
    seq_parallel=True,   # §Perf Cell E1: shards the remat-checkpoint stack
)


def reduced() -> ArchConfig:
    return _shrink(CONFIG, n_layers=2, d_model=128, n_heads=8, n_kv_heads=2,
                   d_ff=384, vocab_size=512, fsdp=False, opt_dtype="float32")

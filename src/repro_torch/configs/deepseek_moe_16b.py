"""DeepSeekMoE-16B [moe]: fine-grained experts, 2 shared + 64 routed top-6.

28L d_model=2048 16H (kv=16, MHA) d_ff_expert=1408 vocab=102400
[arXiv:2401.06066; hf]. Layer 0 is dense (d_ff=10944).
MoE dispatch uses HiAER-style two-phase address-event routing (DESIGN §4).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, _shrink

CONFIG = ArchConfig(
    name="deepseek_moe_16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10_944, vocab_size=102_400,
    act="swiglu", norm="rmsnorm", rope_theta=10_000.0,
    moe=MoEConfig(n_routed=64, n_shared=2, top_k=6, d_ff_expert=1408,
                  first_k_dense=1, d_ff_dense=10_944,
                  capacity_factor=1.5),     # §Perf hillclimb #2
    remat_policy="dots",                    # §Perf hillclimb #2
)


def reduced() -> ArchConfig:
    return _shrink(CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                   d_ff=256, vocab_size=256,
                   moe=MoEConfig(n_routed=8, n_shared=1, top_k=2,
                                 d_ff_expert=64, first_k_dense=1,
                                 d_ff_dense=256,
                                 # dropless at test scale so decode-vs-
                                 # teacher-forcing parity is exact
                                 capacity_factor=8.0))

"""DeepSeek-V2 236B [moe]: MLA (kv_lora=512), 2 shared + 160 routed top-6.

60L d_model=5120 128H d_ff_expert=1536 vocab=102400 [arXiv:2405.04434; hf].
First layer dense (d_ff=12288). MLA decode uses the absorbed compressed-KV
form (cache = c_kv 512 + k_rope 64 per token).
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, _shrink

CONFIG = ArchConfig(
    name="deepseek_v2_236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12_288, vocab_size=102_400,
    act="swiglu", norm="rmsnorm", rope_theta=10_000.0, attn_kind="mla",
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_routed=160, n_shared=2, top_k=6, d_ff_expert=1536,
                  first_k_dense=1, d_ff_dense=12_288),
    fsdp=True, opt_dtype="bfloat16",
)


def reduced() -> ArchConfig:
    return _shrink(CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                   d_ff=256, vocab_size=256, fsdp=False, opt_dtype="float32",
                   mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                                 qk_nope_head_dim=16, qk_rope_head_dim=8,
                                 v_head_dim=16),
                   moe=MoEConfig(n_routed=8, n_shared=1, top_k=2,
                                 d_ff_expert=64, first_k_dense=1,
                                 d_ff_dense=256, capacity_factor=8.0))

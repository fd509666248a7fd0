"""Config system: architecture configs, input shapes, registry — the
port's copy of `repro/configs/base.py` (dataclass data only, so the port
imports nothing of `repro`).

Every assigned architecture is a selectable config (``--arch <id>``); each
config file instantiates :class:`ArchConfig` with the exact published
hyperparameters and provides ``reduced()`` for CPU smoke tests.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_routed: int = 0            # routed experts
    n_shared: int = 0            # shared (always-on) experts
    top_k: int = 0
    d_ff_expert: int = 0         # per-expert FFN width (fine-grained)
    first_k_dense: int = 0       # leading dense layers (DeepSeek style)
    d_ff_dense: int = 0          # width of those dense layers
    capacity_factor: float = 2.0
    router_aux_weight: float = 0.001
    hierarchical_a2a: bool = False   # HiAER two-phase dispatch (beyond-paper opt)


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma / Griffin recurrent block."""
    lru_width: int = 2560
    d_conv: int = 4
    window: int = 2048           # local attention window
    pattern: Tuple[str, ...] = ("rglru", "rglru", "local_attn")
    gate_block: int = 256        # Griffin gates are block-diagonal


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    act: str = "swiglu"          # swiglu | geglu | gelu (non-gated)
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    rope_theta: float = 500_000.0
    pos: str = "rope"            # rope | sinusoidal | none
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # modality frontend stubs ([audio]/[vlm]): extra embedded inputs
    frontend: Optional[str] = None       # "audio_tokens" | "vision_patches"
    n_patch_tokens: int = 0              # vlm: precomputed patch embeds per image
    # --- distribution policy (tuned per arch; see launch/sharding.py) ---
    fsdp: bool = False           # shard params over data axis too (ZeRO-3)
    opt_dtype: str = "float32"   # optimizer moment dtype ("bfloat16" for 405B)
    remat: bool = True
    scan_layers: bool = True
    loss_chunk: int = 512        # seq chunk for vocab-sharded CE loss
    # attention flavor: full | local | mla ; long_500k eligibility derives
    # from sub-quadratic state (ssm/rglru/local) only.
    attn_kind: str = "full"
    # seq-layout attention impl: 'shardmap' (explicit sequence-parallel —
    # adopted default after §Perf hillclimb #1: 13x compute / 15x HBM
    # reduction) or 'gspmd' (constraint-driven baseline, kept selectable)
    attn_impl: str = "shardmap"
    # residual stream sharded over 'model' on the seq axis (sequence
    # parallelism; §Perf MoE hillclimb)
    seq_parallel: bool = False
    # remat policy: 'full' (recompute everything) or 'dots' (save dot
    # outputs — trades HBM for fewer bwd recompute collectives)
    remat_policy: str = "full"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks), for roofline."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        hd = self.resolved_head_dim
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            per_layer = d * (2 * d_in + 2 * s.d_state * (d_in // s.head_dim if False else 1)) \
                + 2 * d_in * d  # in/out proj dominate
            per_layer = d * d_in * 2 + d_in * d + d_in * (2 * s.d_state)
        else:
            q = self.n_heads * hd
            kv = self.n_kv_heads * hd
            if self.mla is not None:
                m = self.mla
                attn = (d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                        + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                        + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                        + self.n_heads * m.v_head_dim * d)
            else:
                attn = d * q + 2 * d * kv + q * d
            gated = self.act in ("swiglu", "geglu")
            ff_mult = 3 if gated else 2
            if self.moe is not None:
                mo = self.moe
                ff_moe = (mo.n_routed + mo.n_shared) * ff_mult * d * mo.d_ff_expert + d * mo.n_routed
                ff_dense = ff_mult * d * (mo.d_ff_dense or self.d_ff)
                per_layer = attn + ff_moe
                return emb + mo.first_k_dense * (attn + ff_dense) + (L - mo.first_k_dense) * per_layer
            per_layer = attn + ff_mult * d * self.d_ff
        return emb + L * per_layer

    def n_active_params(self) -> int:
        """Active params per token (MoE: shared + top_k experts only)."""
        if self.moe is None:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        mo = self.moe
        hd = self.resolved_head_dim
        gated = self.act in ("swiglu", "geglu")
        ff_mult = 3 if gated else 2
        if self.mla is not None:
            m = self.mla
            attn = (d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
        else:
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        act_ff = (mo.top_k + mo.n_shared) * ff_mult * d * mo.d_ff_expert + d * mo.n_routed
        dense_ff = ff_mult * d * (mo.d_ff_dense or self.d_ff)
        return emb + mo.first_k_dense * (attn + dense_ff) + (L - mo.first_k_dense) * (attn + act_ff)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str        # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k":    ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k":  ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k":   ShapeSpec("long_500k", "decode", 524_288, 1),
}

ARCH_IDS = [
    "musicgen_medium", "recurrentgemma_2b", "qwen2_7b", "llama3_405b",
    "qwen2_5_3b", "gemma_7b", "deepseek_moe_16b", "deepseek_v2_236b",
    "llava_next_mistral_7b", "mamba2_780m",
]
EXTRA_ARCH_IDS = ["hiaer_snn_40b"]  # the paper's own full-scale config


def get_arch(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def get_reduced(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.reduced()


def cells(arch_id: str):
    """The (arch, shape) cells this arch runs; long_500k only sub-quadratic."""
    cfg = get_arch(arch_id)
    out = []
    for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        if s == "long_500k" and not cfg.sub_quadratic:
            continue
        out.append(SHAPES[s])
    return out


def _shrink(cfg: ArchConfig, **over) -> ArchConfig:
    return replace(cfg, **over)

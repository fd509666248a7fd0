"""LM assembly, dense and MoE families — the port of the dense and MoE
paths of `repro/models/lm.py`.

The model is an `nn.Module` (`LM`) with the JAX parameter tree's names:
`embed`, `final_norm`, and the layers by segment, each block with
`ln1`, `attn`, `ln2` and an `mlp` or a `moe`. A dense config has one
segment, `blocks.<i>`; an MoE config has two, JAX's `dense_blocks.<i>`
(`first_k_dense` blocks with an MLP of width `moe.d_ff_dense or d_ff`)
then `blocks.<i>` (the MoE blocks). The backbone is a Python loop over
each segment's layers where JAX scans it; caches keep JAX's
layer-stacked layout, {segment: {"k", "v": (L, B, T, KV, hd)}}.

Entry points: `init_params`, `loss_fn` (the training loss, ce + the MoE
router's aux loss, with each block rematerialized when `cfg.remat`
holds: JAX's `jax.checkpoint` per block, and for `remat_policy` "dots"
the outputs of mm, bmm and addmm saved, after JAX's
`dots_with_no_batch_dims_saveable`),
`init_cache`, `prefill` and `decode_step`. They run on the card unless
the caller asks for the CPU (`device="cpu"`, or a model already there).
MLA, SSM, hybrid and frontend configs raise NotImplementedError; they
are ROADMAP item 10's later slices.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (MLP, Embed, Norm, chunked_ce_loss,
                                       embed_lookup, unembed)


def check_supported(cfg) -> None:
    """Raise for the families the port does not run yet."""
    if cfg.mla is not None or cfg.attn_kind == "mla":
        what = "MLA attention"
    elif cfg.family == "ssm":
        what = "the SSM (Mamba-2) family"
    elif cfg.family == "hybrid":
        what = "the hybrid (RG-LRU + local attention) family"
    elif cfg.frontend is not None:
        what = f"the {cfg.frontend} frontend"
    else:
        return
    raise NotImplementedError(
        f"{cfg.name}: {what} is not ported yet; repro_torch runs the dense "
        f"and MoE families (ROADMAP item 10, the LM stack, ports the rest "
        f"in later slices)")


class Block(nn.Module):
    """Pre-norm residual block: attention, then the MLP or, with
    `use_moe`, the MoE layer (JAX's `init_block` for kind "attn")."""

    def __init__(self, cfg, gen: torch.Generator, dtype, use_moe=False):
        super().__init__()
        dev = gen.device
        self.ln1 = Norm(cfg.d_model, dtype, cfg.norm, device=dev)
        self.attn = attn.GQA(cfg, gen, dtype)
        self.ln2 = Norm(cfg.d_model, dtype, cfg.norm, device=dev)
        if use_moe:
            self.moe = moe_mod.MoE(cfg, gen, dtype)
        else:
            d_ff = cfg.d_ff if cfg.moe is None else (cfg.moe.d_ff_dense
                                                     or cfg.d_ff)
            self.mlp = MLP(cfg, d_ff, gen, dtype)


def segment_layers(cfg) -> Dict[str, int]:
    """The layer count of each segment, in the order the backbone runs
    them: {"blocks": n_layers}, or for MoE {"dense_blocks":
    first_k_dense, "blocks": n_layers - first_k_dense}."""
    if cfg.moe is None:
        return {"blocks": cfg.n_layers}
    kd = cfg.moe.first_k_dense
    return {"dense_blocks": kd, "blocks": cfg.n_layers - kd}


class LM(nn.Module):
    def __init__(self, cfg, gen: torch.Generator, dtype):
        super().__init__()
        check_supported(cfg)
        self.embed = Embed(cfg, gen, dtype)
        self.final_norm = Norm(cfg.d_model, dtype, cfg.norm,
                               device=gen.device)
        for name, n in segment_layers(cfg).items():
            use_moe = cfg.moe is not None and name == "blocks"
            setattr(self, name, nn.ModuleList(
                Block(cfg, gen, dtype, use_moe) for _ in range(n)))


def init_params(cfg, seed: int = 0, dtype=torch.bfloat16, device=None):
    """An LM with weights drawn from a torch.Generator seeded with
    `seed` on `device` (the card unless "cpu" is asked for): JAX's
    scales, not its bits, in `dtype` but for the MoE routers (fp32).
    The same seed on one device gives the same weights; `.to(device)`
    moves a model to another."""
    gen = torch.Generator(device=resolve(device))
    gen.manual_seed(seed)
    return LM(cfg, gen, dtype)


def block_apply(p, x, cfg, positions, cache=None, cache_pos=None):
    """Returns (x, kv, aux): aux is the MoE layer's router loss, None
    for a block with an MLP."""
    h = p.ln1(x)
    y, kv = attn.gqa_apply(p.attn, h, cfg, positions, cache=cache,
                           cache_pos=cache_pos)
    x = x + y
    h = p.ln2(x)
    if hasattr(p, "moe"):
        y, aux = moe_mod.moe_apply(p.moe, h, cfg)
        return x + y, kv, aux
    return x + p.mlp(h), kv, None


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_kwargs(cfg) -> Dict[str, Any]:
    """`checkpoint`'s arguments for cfg.remat_policy: "dots" keeps the
    matmuls' outputs and recomputes the rest, "full" recomputes all."""
    if cfg.remat_policy == "dots":
        return {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, _save_dots)}
    return {}


def backbone(params, cfg, batch, positions=None, caches=None,
             cache_pos=None, with_cache=False, remat=None):
    """Returns (h, aux, caches): aux the sum of the MoE layers' router
    losses (a zero for the dense family). Decode passes `caches` and
    `cache_pos` and gets them back, updated in place; a full-sequence
    pass with `with_cache` gets each segment's {"k", "v"} stacked over
    its layers; otherwise caches is None. With `remat` (default
    `cfg.remat`) and grad enabled, each block runs under
    `torch.utils.checkpoint` (`_remat_kwargs`) and is recomputed in the
    backward."""
    remat = cfg.remat if remat is None else remat
    remat = remat and torch.is_grad_enabled() and caches is None \
        and not with_cache
    tokens = batch["tokens"]
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    h = embed_lookup(params.embed, tokens)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    new = {}
    for name in segment_layers(cfg):
        ks, vs = [], []
        for i, blk in enumerate(getattr(params, name)):
            if remat:
                h, a = checkpoint(lambda x, blk=blk: block_apply(
                    blk, x, cfg, positions)[::2], h, use_reentrant=False,
                    **_remat_kwargs(cfg))
            else:
                cl = None
                if caches is not None:
                    cl = {"k": caches[name]["k"][i],
                          "v": caches[name]["v"][i]}
                h, kv, a = block_apply(blk, h, cfg, positions, cache=cl,
                                       cache_pos=cache_pos)
                ks.append(kv["k"])
                vs.append(kv["v"])
            if a is not None:
                aux = aux + a
        if with_cache and caches is None:
            new[name] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    h = params.final_norm(h)
    if caches is None and with_cache:
        caches = new
    return h, aux, caches


def loss_fn(params, cfg, batch):
    """The training loss of batch["tokens"] (B, S): next-token cross
    entropy (labels are the tokens rolled by one, the last position
    masked, times batch["loss_mask"] when given) through
    `chunked_ce_loss`. Returns (ce + aux, {"ce", "aux"}); aux, the MoE
    layers' router loss, is 0 for the dense family."""
    check_supported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    h, aux, _ = backbone(params, cfg, batch)
    labels = torch.roll(tokens, -1, dims=1)
    mask = torch.ones((B, S), dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    if "loss_mask" in batch:
        mask = mask * batch["loss_mask"]
    ce = chunked_ce_loss(params.embed, h, labels, mask, cfg)
    return ce + aux, {"ce": ce, "aux": aux}


def init_cache(cfg, batch_size, max_len, dtype=torch.bfloat16, device=None):
    """Zero K/V caches, {segment: {"k", "v": (L, B, max_len, KV, hd)}}."""
    check_supported(cfg)
    layer = attn.gqa_cache_shape(cfg, batch_size, max_len, dtype,
                                 device=resolve(device))
    return {name: {n: t.expand((L,) + t.shape).contiguous()
                   for n, t in layer.items()}
            for name, L in segment_layers(cfg).items()}


@torch.no_grad()
def prefill(params, cfg, batch) -> tuple:
    """Full-sequence forward of batch["tokens"] (B, S); returns (the last
    token's fp32 logits over the padded vocab, caches). The caches'
    sequence length is S (extend them before decoding further)."""
    check_supported(cfg)
    h, _, caches = backbone(params, cfg, batch, with_cache=True)
    logits = unembed(params.embed, h[:, -1], cfg)
    return logits.float(), caches


@torch.no_grad()
def decode_step(params, cfg, token, cache: Dict[str, Any], cache_pos: int):
    """token (B, 1) integer tensor; cache from init_cache(cfg, B,
    max_len), updated in place and returned; cache_pos = the number of
    tokens already in the cache. Returns (fp32 logits (B, Vp), cache)."""
    check_supported(cfg)
    cache_pos = int(cache_pos)
    positions = cache_pos + torch.arange(1, device=token.device)
    h, _, cache = backbone(params, cfg, {"tokens": token},
                           positions=positions, caches=cache,
                           cache_pos=cache_pos)
    logits = unembed(params.embed, h[:, -1], cfg)
    return logits.float(), cache

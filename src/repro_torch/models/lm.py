"""LM assembly, dense family — the port of the dense path of
`repro/models/lm.py`.

The model is an `nn.Module` (`LM`) with the JAX parameter tree's names:
`embed`, `final_norm`, and `blocks.<i>` for each layer, each block with
`ln1`, `attn`, `ln2`, `mlp`. The backbone is a Python loop over the
layers where JAX scans a layer-stacked segment; caches keep JAX's
layer-stacked layout, {"blocks": {"k", "v": (L, B, T, KV, hd)}}.

Entry points: `init_params`, `loss_fn` (the training loss, with each
block rematerialized when `cfg.remat` holds, JAX's `jax.checkpoint` per
block), `init_cache`, `prefill` and `decode_step`. They run on the card
unless the caller asks for the CPU (`device="cpu"`, or a model already
there). MoE, MLA, SSM, hybrid and frontend configs raise
NotImplementedError; they are ROADMAP item 10's later slices.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve
from repro_torch.models import attention as attn
from repro_torch.models.layers import (MLP, Embed, Norm, chunked_ce_loss,
                                       embed_lookup, unembed)


def check_supported(cfg) -> None:
    """Raise for the families the port does not run yet."""
    if cfg.moe is not None:
        what = "MoE"
    elif cfg.mla is not None or cfg.attn_kind == "mla":
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
        f"family (ROADMAP item 10, the LM stack, ports the rest in later "
        f"slices)")


class Block(nn.Module):
    """Pre-norm residual block: attention, then the MLP (JAX's
    `init_block` for kind "attn")."""

    def __init__(self, cfg, gen: torch.Generator, dtype):
        super().__init__()
        dev = gen.device
        self.ln1 = Norm(cfg.d_model, dtype, cfg.norm, device=dev)
        self.attn = attn.GQA(cfg, gen, dtype)
        self.ln2 = Norm(cfg.d_model, dtype, cfg.norm, device=dev)
        self.mlp = MLP(cfg, cfg.d_ff, gen, dtype)


class LM(nn.Module):
    def __init__(self, cfg, gen: torch.Generator, dtype):
        super().__init__()
        check_supported(cfg)
        self.embed = Embed(cfg, gen, dtype)
        self.final_norm = Norm(cfg.d_model, dtype, cfg.norm,
                               device=gen.device)
        self.blocks = nn.ModuleList(Block(cfg, gen, dtype)
                                    for _ in range(cfg.n_layers))


def init_params(cfg, seed: int = 0, dtype=torch.bfloat16, device=None):
    """A dense LM with weights drawn from a torch.Generator seeded with
    `seed` on `device` (the card unless "cpu" is asked for): JAX's
    scales, not its bits. The same seed on one device gives the same
    weights; `.to(device)` moves a model to another."""
    gen = torch.Generator(device=resolve(device))
    gen.manual_seed(seed)
    return LM(cfg, gen, dtype)


def block_apply(p, x, cfg, positions, cache=None, cache_pos=None):
    h = p.ln1(x)
    y, kv = attn.gqa_apply(p.attn, h, cfg, positions, cache=cache,
                           cache_pos=cache_pos)
    x = x + y
    return x + p.mlp(p.ln2(x)), kv


def backbone(params, cfg, batch, positions=None, caches=None,
             cache_pos=None, with_cache=False, remat=None):
    """Returns (h, caches). Decode passes `caches` and `cache_pos` and
    gets them back, updated in place; a full-sequence pass with
    `with_cache` gets its {"blocks": {"k", "v"}} stacked over the
    layers; otherwise caches is None. With `remat` (default
    `cfg.remat`) and grad enabled, each block runs under
    `torch.utils.checkpoint` and is recomputed in the backward."""
    remat = cfg.remat if remat is None else remat
    remat = remat and torch.is_grad_enabled() and caches is None \
        and not with_cache
    tokens = batch["tokens"]
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    h = embed_lookup(params.embed, tokens)
    ks, vs = [], []
    for i, blk in enumerate(params.blocks):
        if remat:
            h = checkpoint(lambda x, blk=blk: block_apply(
                blk, x, cfg, positions)[0], h, use_reentrant=False)
            continue
        cl = None
        if caches is not None:
            cl = {"k": caches["blocks"]["k"][i],
                  "v": caches["blocks"]["v"][i]}
        h, kv = block_apply(blk, h, cfg, positions, cache=cl,
                            cache_pos=cache_pos)
        ks.append(kv["k"])
        vs.append(kv["v"])
    h = params.final_norm(h)
    if caches is None and with_cache:
        caches = {"blocks": {"k": torch.stack(ks), "v": torch.stack(vs)}}
    return h, caches


def loss_fn(params, cfg, batch):
    """The training loss of batch["tokens"] (B, S): next-token cross
    entropy (labels are the tokens rolled by one, the last position
    masked, times batch["loss_mask"] when given) through
    `chunked_ce_loss`. Returns (ce + aux, {"ce", "aux"}); aux, the MoE
    router loss, is 0 for the dense family."""
    check_supported(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    h, _ = backbone(params, cfg, batch)
    labels = torch.roll(tokens, -1, dims=1)
    mask = torch.ones((B, S), dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    if "loss_mask" in batch:
        mask = mask * batch["loss_mask"]
    ce = chunked_ce_loss(params.embed, h, labels, mask, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return ce + aux, {"ce": ce, "aux": aux}


def init_cache(cfg, batch_size, max_len, dtype=torch.bfloat16, device=None):
    check_supported(cfg)
    layer = attn.gqa_cache_shape(cfg, batch_size, max_len, dtype,
                                 device=resolve(device))
    return {"blocks": {n: t.expand((cfg.n_layers,) + t.shape).contiguous()
                       for n, t in layer.items()}}


@torch.no_grad()
def prefill(params, cfg, batch) -> tuple:
    """Full-sequence forward of batch["tokens"] (B, S); returns (the last
    token's fp32 logits over the padded vocab, caches). The caches'
    sequence length is S (extend them before decoding further)."""
    check_supported(cfg)
    h, caches = backbone(params, cfg, batch, with_cache=True)
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
    h, cache = backbone(params, cfg, {"tokens": token}, positions=positions,
                        caches=cache, cache_pos=cache_pos)
    logits = unembed(params.embed, h[:, -1], cfg)
    return logits.float(), cache

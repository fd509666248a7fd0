"""LM assembly, dense, MoE, SSM and hybrid families — the port of
`repro/models/lm.py` but for MLA and the frontends.

The model is an `nn.Module` (`LM`) with the JAX parameter tree's names:
`embed`, `final_norm`, and the layers by segment (`segment_layers`), the
layer index after the segment name:
  * dense: `blocks.<i>`, each block `ln1`, `attn`, `ln2`, `mlp`;
  * MoE: JAX's `dense_blocks.<i>` (`first_k_dense` blocks with an MLP of
    width `moe.d_ff_dense or d_ff`) then `blocks.<i>` (`moe` in place of
    `mlp`);
  * SSM (Mamba-2): `blocks.<i>`, each norm + mixer only: `ln1`, `ssm`;
  * hybrid (RecurrentGemma): `groups.<i>.{rec1, rec2, attn}` for the
    n_layers // 3 (rglru, rglru, local_attn) groups, then `tail.<i>`
    for the rglru layers left over; an rglru block is `ln1`, `rec`,
    `ln2`, `mlp`, a local_attn block GQA over `cfg.rglru.window` keys.
The backbone is a Python loop over each segment's layers where JAX scans
it; caches keep JAX's layer-stacked layout: {segment: {"k", "v": (L, B,
T, KV, hd)}}, {"blocks": {"conv", "ssd"}} for the SSM family and
{"groups": {"rec1": {"conv", "h"}, "rec2": ..., "attn": {"k", "v"}},
"tail": {"conv", "h"}} for the hybrid, each leaf stacked over its
segment's layers.

Entry points: `init_params`, `loss_fn` (the training loss, ce + the MoE
router's aux loss, with each layer of a segment rematerialized when
`cfg.remat` holds: JAX's `jax.checkpoint` per block, per hybrid group
and per tail block, and for `remat_policy` "dots" the outputs of mm, bmm
and addmm saved, after JAX's `dots_with_no_batch_dims_saveable`),
`init_cache`, `prefill` and `decode_step`. They run on the card unless
the caller asks for the CPU (`device="cpu"`, or a model already there).
MLA and frontend configs raise NotImplementedError; they are ROADMAP
item 10's later slices.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (MLP, Embed, Norm, chunked_ce_loss,
                                       embed_lookup, unembed)


def check_supported(cfg) -> None:
    """Raise for the families the port does not run yet."""
    if cfg.mla is not None or cfg.attn_kind == "mla":
        what = "MLA attention"
    elif cfg.frontend is not None:
        what = f"the {cfg.frontend} frontend"
    else:
        return
    raise NotImplementedError(
        f"{cfg.name}: {what} is not ported yet; repro_torch runs the dense, "
        f"MoE, SSM and hybrid families (ROADMAP item 10, the LM stack, "
        f"ports the rest in later slices)")


def _mix_kind(cfg) -> str:
    return "ssm" if cfg.family == "ssm" else "attn"


class Block(nn.Module):
    """One pre-norm residual block of `kind` (JAX's `init_block`): "attn"
    and "local_attn" (GQA), "rglru" (`rec`), each followed by `ln2` and
    the MLP or, with `use_moe`, the MoE layer; "ssm" is `ln1` and the
    mixer only."""

    def __init__(self, cfg, gen: torch.Generator, dtype, kind="attn",
                 use_moe=False):
        super().__init__()
        dev = gen.device
        self.ln1 = Norm(cfg.d_model, dtype, cfg.norm, device=dev)
        if kind == "ssm":
            self.ssm = ssm_mod.SSM(cfg, gen, dtype)
            return
        if kind == "rglru":
            self.rec = rglru_mod.RGLRU(cfg, gen, dtype)
        else:
            self.attn = attn.GQA(cfg, gen, dtype)
        self.ln2 = Norm(cfg.d_model, dtype, cfg.norm, device=dev)
        if use_moe:
            self.moe = moe_mod.MoE(cfg, gen, dtype)
        else:
            d_ff = cfg.d_ff if cfg.moe is None else (cfg.moe.d_ff_dense
                                                     or cfg.d_ff)
            self.mlp = MLP(cfg, d_ff, gen, dtype)


class Group(nn.Module):
    """One hybrid group: `rec1`, `rec2` (rglru) and `attn` (local
    attention) blocks."""

    def __init__(self, cfg, gen: torch.Generator, dtype):
        super().__init__()
        self.rec1 = Block(cfg, gen, dtype, "rglru")
        self.rec2 = Block(cfg, gen, dtype, "rglru")
        self.attn = Block(cfg, gen, dtype, "local_attn")


_GROUP = (("rec1", "rglru"), ("rec2", "rglru"), ("attn", "local_attn"))


def segment_layers(cfg) -> Dict[str, int]:
    """The layer count of each segment, in the order the backbone runs
    them: {"blocks": n_layers}; for MoE {"dense_blocks": first_k_dense,
    "blocks": n_layers - first_k_dense}; for the hybrid {"groups":
    n_layers // 3, "tail": the rest} (no "tail" when none is left)."""
    if cfg.family == "hybrid":
        g = len(cfg.rglru.pattern)
        n_groups = cfg.n_layers // g
        n_tail = cfg.n_layers - n_groups * g
        return {"groups": n_groups, **({"tail": n_tail} if n_tail else {})}
    if cfg.moe is None:
        return {"blocks": cfg.n_layers}
    kd = cfg.moe.first_k_dense
    return {"dense_blocks": kd, "blocks": cfg.n_layers - kd}


def layer_blocks(cfg, segment: str) -> Tuple[Tuple[Any, str], ...]:
    """The blocks of one layer of `segment`: (name in the layer, or None
    for a layer that is one block; kind)."""
    if cfg.family == "hybrid":
        return _GROUP if segment == "groups" else ((None, "rglru"),)
    return ((None, _mix_kind(cfg)),)


class LM(nn.Module):
    def __init__(self, cfg, gen: torch.Generator, dtype):
        super().__init__()
        check_supported(cfg)
        self.embed = Embed(cfg, gen, dtype)
        self.final_norm = Norm(cfg.d_model, dtype, cfg.norm,
                               device=gen.device)
        for name, n in segment_layers(cfg).items():
            if name == "groups":
                layers = (Group(cfg, gen, dtype) for _ in range(n))
            else:
                kind = layer_blocks(cfg, name)[0][1]
                use_moe = cfg.moe is not None and name == "blocks"
                layers = (Block(cfg, gen, dtype, kind, use_moe)
                          for _ in range(n))
            setattr(self, name, nn.ModuleList(layers))


def init_params(cfg, seed: int = 0, dtype=torch.bfloat16, device=None):
    """An LM with weights drawn from a torch.Generator seeded with
    `seed` on `device` (the card unless "cpu" is asked for): JAX's
    scales, not its bits, in `dtype` but for the MoE routers and the
    SSM's and RG-LRU's decay parameters (fp32). The same seed on one
    device gives the same weights; `.to(device)` moves a model to
    another."""
    gen = torch.Generator(device=resolve(device))
    gen.manual_seed(seed)
    return LM(cfg, gen, dtype)


def block_apply(p, x, cfg, positions, cache=None, cache_pos=None,
                kind="attn", with_cache=False):
    """Returns (x, cache, aux): aux is the MoE layer's router loss, None
    for other blocks. cache is the block's new cache (decode: updated in
    place for attention, a new state for the recurrent kinds); for a
    pass over a sequence the attention's {k, v} and, with `with_cache`,
    the recurrent kinds' final state; None otherwise."""
    h = p.ln1(x)
    if kind in ("ssm", "rglru") and cache is None and with_cache:
        # a prefill starts from a zero state, as JAX's from init_cache's
        cache = _layer_cache(cfg, kind, x.shape[0], 0, x.dtype, x.device)
    if kind == "ssm":
        y, new = ssm_mod.ssm_apply(p.ssm, h, cfg, cache=cache)
        return x + y, new, None
    if kind == "rglru":
        y, new = rglru_mod.rglru_apply(p.rec, h, cfg, cache=cache)
    else:
        window = cfg.rglru.window if kind == "local_attn" else None
        y, new = attn.gqa_apply(p.attn, h, cfg, positions, window=window,
                                cache=cache, cache_pos=cache_pos)
    x = x + y
    h = p.ln2(x)
    if hasattr(p, "moe"):
        y, aux = moe_mod.moe_apply(p.moe, h, cfg)
        return x + y, new, aux
    return x + p.mlp(h), new, None


def layer_apply(layer, x, cfg, blocks, positions, cache=None,
                cache_pos=None, with_cache=False):
    """One layer of a segment: its `blocks` (`layer_blocks`) in order.
    Returns (x, cache, aux) as `block_apply`, cache and aux gathered
    over the blocks (cache by block name for a group)."""
    aux, new = None, {}
    for name, kind in blocks:
        blk = layer if name is None else getattr(layer, name)
        cl = cache if cache is None or name is None else cache[name]
        x, nc, a = block_apply(blk, x, cfg, positions, cl, cache_pos, kind,
                               with_cache)
        new[name] = nc
        if a is not None:
            aux = a if aux is None else aux + a
    return x, (new[None] if None in new else new), aux


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


def _index(tree, i):
    """Layer i's views of a layer-stacked cache tree."""
    if isinstance(tree, dict):
        return {n: _index(t, i) for n, t in tree.items()}
    return tree[i]


def _write(dst, src) -> None:
    """Copy a layer's new cache into its views of the stacked cache
    (leaves already updated in place are left as they are)."""
    if isinstance(dst, dict):
        for n in dst:
            _write(dst[n], src[n])
    elif src is not dst:
        dst.copy_(src)


def _stack(trees):
    """The layers' caches stacked into one tree, leaves (L, ...)."""
    if isinstance(trees[0], dict):
        return {n: _stack([t[n] for t in trees]) for n in trees[0]}
    return torch.stack(trees)


def backbone(params, cfg, batch, positions=None, caches=None,
             cache_pos=None, with_cache=False, remat=None):
    """Returns (h, aux, caches): aux the sum of the MoE layers' router
    losses (a zero for the other families). Decode passes `caches` and
    `cache_pos` and gets them back, updated in place; a full-sequence
    pass with `with_cache` gets each segment's cache stacked over its
    layers (K/V, or the recurrent layers' final state); otherwise caches
    is None. With `remat` (default `cfg.remat`) and grad enabled, each
    layer of a segment (a block, or a hybrid group) runs under
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
        blocks = layer_blocks(cfg, name)
        layers = []
        for i, layer in enumerate(getattr(params, name)):
            if remat:
                h, a = checkpoint(
                    lambda x, layer=layer, blocks=blocks: layer_apply(
                        layer, x, cfg, blocks, positions)[::2], h,
                    use_reentrant=False, **_remat_kwargs(cfg))
            else:
                cl = None if caches is None else _index(caches[name], i)
                h, nc, a = layer_apply(layer, h, cfg, blocks, positions, cl,
                                       cache_pos, with_cache)
                if cl is not None:
                    _write(cl, nc)
                elif with_cache:
                    layers.append(nc)
            if a is not None:
                aux = aux + a
        if layers:
            new[name] = _stack(layers)
    h = params.final_norm(h)
    if caches is None and with_cache:
        caches = new
    return h, aux, caches


def loss_fn(params, cfg, batch):
    """The training loss of batch["tokens"] (B, S): next-token cross
    entropy (labels are the tokens rolled by one, the last position
    masked, times batch["loss_mask"] when given) through
    `chunked_ce_loss`. Returns (ce + aux, {"ce", "aux"}); aux, the MoE
    layers' router loss, is 0 for the other families."""
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


def _layer_cache(cfg, kind, batch_size, max_len, dtype, device):
    if kind == "ssm":
        return ssm_mod.ssm_cache_shape(cfg, batch_size, dtype, device)
    if kind == "rglru":
        return rglru_mod.rglru_cache_shape(cfg, batch_size, dtype, device)
    window = cfg.rglru.window if kind == "local_attn" else None
    return attn.gqa_cache_shape(cfg, batch_size, max_len, dtype, device,
                                window=window)


def init_cache(cfg, batch_size, max_len, dtype=torch.bfloat16, device=None):
    """Zero caches in JAX's layer-stacked layout (module docstring): K/V
    (L, B, max_len, KV, hd), a windowed layer's ring (L, B, min(window,
    max_len), KV, hd), the recurrent layers' states (L, B, ...)."""
    check_supported(cfg)
    dev = resolve(device)
    out = {}
    for name, L in segment_layers(cfg).items():
        tree = {n: _layer_cache(cfg, kind, batch_size, max_len, dtype, dev)
                for n, kind in layer_blocks(cfg, name)}
        tree = tree[None] if None in tree else tree
        out[name] = _expand(tree, L)
    return out


def _expand(tree, L):
    if isinstance(tree, dict):
        return {n: _expand(t, L) for n, t in tree.items()}
    return tree.expand((L,) + tree.shape).contiguous()


@torch.no_grad()
def prefill(params, cfg, batch) -> tuple:
    """Full-sequence forward of batch["tokens"] (B, S); returns (the last
    token's fp32 logits over the padded vocab, caches). The caches'
    sequence length is S (extend them before decoding further); a
    windowed layer's holds the last min(window, S) positions."""
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

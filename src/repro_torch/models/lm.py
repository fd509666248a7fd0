"""LM assembly, every family of the registry — the port of
`repro/models/lm.py`.

The model is an `nn.Module` (`LM`) with the JAX parameter tree's names:
`embed`, `final_norm`, and the layers by segment (`segment_layers`), the
layer index after the segment name:
  * dense, audio (MusicGen) and VLM (LLaVA-NeXT): `blocks.<i>`, each
    block `ln1`, `attn`, `ln2`, `mlp`;
  * MoE: JAX's `dense_blocks.<i>` (`first_k_dense` blocks with an MLP of
    width `moe.d_ff_dense or d_ff`) then `blocks.<i>` (`moe` in place of
    `mlp`); DeepSeek-V2's `attn` is MLA (`attn_kind` "mla": `w_dq`,
    `w_uq`, `w_dkv`, `w_uk`, `w_uv`, `w_o`, `q_norm`, `kv_norm`);
  * SSM (Mamba-2): `blocks.<i>`, each norm + mixer only: `ln1`, `ssm`;
  * hybrid (RecurrentGemma): `groups.<i>.{rec1, rec2, attn}` for the
    n_layers // 3 (rglru, rglru, local_attn) groups, then `tail.<i>`
    for the rglru layers left over; an rglru block is `ln1`, `rec`,
    `ln2`, `mlp`, a local_attn block GQA over `cfg.rglru.window` keys.
The backbone is a Python loop over each segment's layers where JAX scans
it; caches keep JAX's layer-stacked layout: {segment: {"k", "v": (L, B,
T, KV, hd)}}, MLA's compressed {segment: {"c_kv": (L, B, T, kv_lora),
"k_rope": (L, B, T, rope)}}, {"blocks": {"conv", "ssd"}} for the SSM
family and {"groups": {"rec1": {"conv", "h"}, "rec2": ..., "attn": {"k",
"v"}}, "tail": {"conv", "h"}} for the hybrid, each leaf stacked over its
segment's layers.

The frontends are JAX's stubs (`_embed_input`): a `vision_patches`
config (LLaVA-NeXT) takes batch["patch_embeds"] (B, n_patch_tokens, d),
cast and put before the token embeddings, so that positions run over
n_patch_tokens + S and the loss reads the text positions only; an
`audio_tokens` config (MusicGen) takes token ids, with sinusoidal
positions added to the embeddings (`cfg.pos`). Neither JAX's launchers
nor the port's feed patches: the serving and training CLIs run on
tokens.

Entry points: `init_params`, `loss_fn` (the training loss, ce + the MoE
router's aux loss, with each layer of a segment rematerialized when
`cfg.remat` holds: JAX's `jax.checkpoint` per block, per hybrid group
and per tail block, and for `remat_policy` "dots" the outputs of mm, bmm
and addmm saved, after JAX's `dots_with_no_batch_dims_saveable`),
`init_cache`, `prefill` and `decode_step`. They run on the card unless
the caller asks for the CPU (`device="cpu"`, or a model already there).
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
from repro_torch.models.layers import (MLP, Embed, Norm,  # noqa: F401
                                       chunked_ce_loss, chunked_ce_sums,
                                       embed_lookup, sinusoidal_positions,
                                       unembed)


def _mix_kind(cfg) -> str:
    if cfg.family == "ssm":
        return "ssm"
    return "mla" if cfg.attn_kind == "mla" else "attn"


class Block(nn.Module):
    """One pre-norm residual block of `kind` (JAX's `init_block`): "attn"
    and "local_attn" (GQA), "mla", "rglru" (`rec`), each followed by
    `ln2` and the MLP or, with `use_moe`, the MoE layer; "ssm" is `ln1`
    and the mixer only."""

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
        elif kind == "mla":
            self.attn = attn.MLA(cfg, gen, dtype)
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
    elif kind == "mla":
        y, new = attn.mla_apply(p.attn, h, cfg, positions, cache=cache,
                                cache_pos=cache_pos)
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


def _n_patch(cfg, batch) -> int:
    """The patch positions before the text: cfg.n_patch_tokens when a
    vision_patches config is given batch["patch_embeds"], else 0."""
    return cfg.n_patch_tokens if cfg.frontend == "vision_patches" \
        and "patch_embeds" in batch else 0


def _embed_input(params, cfg, batch, positions):
    """The token embeddings, after the patch embeddings (cast to their
    dtype) when `_n_patch` has any, plus the sinusoidal positions for a
    `pos` "sinusoidal" config: JAX's `_embed_input`."""
    h = embed_lookup(params.embed, batch["tokens"])
    if _n_patch(cfg, batch):
        h = torch.cat([batch["patch_embeds"].to(h.dtype), h], dim=1)
    if cfg.pos == "sinusoidal":
        h = h + sinusoidal_positions(positions, cfg.d_model).to(h.dtype)
    return h


def backbone(params, cfg, batch, positions=None, caches=None,
             cache_pos=None, with_cache=False, remat=None):
    """Returns (h, aux, caches): h over the patch positions (when
    `_n_patch` has any) then the tokens', at positions 0.. unless given;
    aux the sum of the MoE layers' router losses (a zero for the other
    families). Decode passes `caches` and `cache_pos` and gets them
    back, updated in place; a full-sequence pass with `with_cache` gets
    each segment's cache stacked over its layers (K/V, MLA's {c_kv,
    k_rope}, or the recurrent layers' final state); otherwise caches is
    None. With `remat` (default `cfg.remat`) and grad enabled, each
    layer of a segment (a block, or a hybrid group) runs under
    `torch.utils.checkpoint` (`_remat_kwargs`) and is recomputed in the
    backward."""
    remat = cfg.remat if remat is None else remat
    remat = remat and torch.is_grad_enabled() and caches is None \
        and not with_cache
    tokens = batch["tokens"]
    if positions is None:
        positions = torch.arange(tokens.shape[1] + _n_patch(cfg, batch),
                                 device=tokens.device)
    h = _embed_input(params, cfg, batch, positions)
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
    masked, times batch["loss_mask"] when given) over the text positions
    only (after any patches), from `loss_terms`. Returns (ce + aux,
    {"ce", "aux"}); aux, the MoE layers' router loss, is 0 for the other
    families."""
    tot, cnt, aux = loss_terms(params, cfg, batch)
    ce = tot / cnt.clamp(min=1.0)
    return ce + aux, {"ce": ce, "aux": aux}


def loss_terms(params, cfg, batch):
    """(the masked cross entropy summed over the batch's tokens, the
    count of tokens it covers, aux) as fp32 scalars, through
    `chunked_ce_sums`: what a data-parallel step adds over the ranks."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    h, aux, _ = backbone(params, cfg, batch)
    h = h[:, h.shape[1] - S:]
    labels = torch.roll(tokens, -1, dims=1)
    mask = torch.ones((B, S), dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    if "loss_mask" in batch:
        mask = mask * batch["loss_mask"]
    tot, cnt = chunked_ce_sums(params.embed, h, labels, mask, cfg)
    return tot, cnt, aux


def _layer_cache(cfg, kind, batch_size, max_len, dtype, device):
    if kind == "ssm":
        return ssm_mod.ssm_cache_shape(cfg, batch_size, dtype, device)
    if kind == "rglru":
        return rglru_mod.rglru_cache_shape(cfg, batch_size, dtype, device)
    if kind == "mla":
        return attn.mla_cache_shape(cfg, batch_size, max_len, dtype, device)
    window = cfg.rglru.window if kind == "local_attn" else None
    return attn.gqa_cache_shape(cfg, batch_size, max_len, dtype, device,
                                window=window)


def init_cache(cfg, batch_size, max_len, dtype=torch.bfloat16, device=None):
    """Zero caches in JAX's layer-stacked layout (module docstring): K/V
    (L, B, max_len, KV, hd), MLA's {c_kv, k_rope} (L, B, max_len, .), a
    windowed layer's ring (L, B, min(window, max_len), KV, hd), the
    recurrent layers' states (L, B, ...)."""
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
    """Full-sequence forward of batch["tokens"] (B, S), after
    batch["patch_embeds"] for a vision_patches config; returns (the last
    token's fp32 logits over the padded vocab, caches). The caches'
    sequence length is S plus the patches (extend them before decoding
    further); a windowed layer's holds the last min(window, S)
    positions."""
    h, _, caches = backbone(params, cfg, batch, with_cache=True)
    logits = unembed(params.embed, h[:, -1], cfg)
    return logits.float(), caches


@torch.no_grad()
def decode_step(params, cfg, token, cache: Dict[str, Any], cache_pos: int):
    """token (B, 1) integer tensor; cache from init_cache(cfg, B,
    max_len), updated in place and returned; cache_pos = the number of
    tokens already in the cache. Returns (fp32 logits (B, Vp), cache)."""
    cache_pos = int(cache_pos)
    positions = cache_pos + torch.arange(1, device=token.device)
    h, _, cache = backbone(params, cfg, {"tokens": token},
                           positions=positions, caches=cache,
                           cache_pos=cache_pos)
    logits = unembed(params.embed, h[:, -1], cfg)
    return logits.float(), cache

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

The model axis (ROADMAP items 10.3b and 10.3c). Under a context mesh
whose 'model' axis has size tp > 1 every family runs on the blocks its
rank holds (`init_params(..., mesh=)`, or `launch.sharding.shard_params`
of a whole state): `layout` ("heads" or "seq", JAX's argument, default
"heads"; `launch.sharding.attn_layout` picks it as JAX's `_attn_layout`)
is the GQA attention's, the hybrid's local attention included
(`models.attention`); MLA runs on its heads (`attention.mla_apply`), the
SSM on its heads (`ssm.ssm_apply`), the RG-LRU on its channels
(`rglru.rglru_apply`); the MLPs, the shared experts and the vocab are
tensor-parallel (`models.layers`). With `cfg.seq_parallel` the residual
is held S/tp-sharded over 'model' between blocks (JAX's `lm.py:88-91`),
from the embedding to the final norm. An FSDP config's leaves held over
'data' too are gathered over 'data' just before use, inside each
layer's checkpoint (so the backward gathers them again), their
gradients reduce-scattered over 'data' (the gather's backward); a
decode step leaves the MoE layers' blocks as they are held, for the 2-D
decode (`moe._decode_moe_2d`). The prefill's caches are held by JAX's
`cache_specs`: every KV head, T over 'model' when T >= 4,096 and T % tp
== 0 (MLA's compressed rows alike); a windowed layer's ring and the
recurrent states whole. A decode over T rows held over 'model' takes
their whole length (`cache_len`). At tp = 1 every path is the one-device
one.
"""
from __future__ import annotations

import functools
import types
from typing import Any, Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import resolve
from repro_torch.distributed.context import get_mesh, mesh_context
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (META, MLP, Embed,  # noqa: F401
                                       Norm, chunked_ce_loss,
                                       chunked_ce_sums, cut_draws,
                                       embed_lookup, sinusoidal_positions,
                                       unembed, unembed_gathered)


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


def init_params(cfg, seed: int = 0, dtype=torch.bfloat16, device=None,
                mesh=None, layout: str = "heads"):
    """An LM with weights drawn from a torch.Generator seeded with
    `seed` on `device` (the card unless "cpu" is asked for): JAX's
    scales, not its bits, in `dtype` but for the MoE routers and the
    SSM's and RG-LRU's decay parameters (fp32). The same seed on one
    device gives the same weights; `.to(device)` moves a model to
    another. With `mesh` (a rank's mesh), the rank's held blocks
    (`launch.sharding.held_spec` under `layout`) of those same weights:
    each leaf is drawn whole in turn and cut at once, so the whole model
    never exists. `device="meta"` gives the shapes only (with `mesh`, the
    rank's blocks' shapes)."""
    meta = device is not None and torch.device(device).type == "meta"
    if meta and (mesh is None or mesh.size == 1):
        return LM(cfg, META, dtype)
    if not meta:
        gen = torch.Generator(device=resolve(device))
        gen.manual_seed(seed)
        if mesh is None or mesh.size == 1:
            return LM(cfg, gen, dtype)
    from repro_torch.launch.sharding import ShardingRules, local_slice
    rules = ShardingRules(cfg, mesh, layout)
    skel = LM(cfg, META, dtype)
    cuts = {n: local_slice(rules.held_spec(n, p.shape), p.shape, mesh)
            for n, p in skel.named_parameters()}
    if meta:
        model = skel
    else:
        with cut_draws([cuts[n] for n, p in skel.named_parameters()
                        if getattr(p, "drawn", False)]):
            model = LM(cfg, gen, dtype)
    for n, p in list(model.named_parameters()):
        if tuple(p.shape) == tuple(skel.get_parameter(n).shape):
            _set_leaf(model, n, p.data[cuts[n]].clone())
    return model


@functools.lru_cache(maxsize=None)
def param_shapes(cfg) -> Dict[str, tuple]:
    """{name: the global shape} of `cfg`'s parameters (a meta model)."""
    return {n: tuple(p.shape)
            for n, p in LM(cfg, META, torch.float32).named_parameters()}


def _set_leaf(model: nn.Module, name: str, value: torch.Tensor) -> None:
    """Put `value` in as the parameter `name` of `model` (keeping its
    requires_grad)."""
    *path, leaf = name.split(".")
    owner = model
    for part in path:
        owner = getattr(owner, part)
    old = getattr(owner, leaf)
    setattr(owner, leaf, nn.Parameter(value,
                                      requires_grad=old.requires_grad))


def block_apply(p, x, cfg, positions, cache=None, cache_pos=None,
                kind="attn", with_cache=False, layout="heads",
                seq_sharded=False, cache_len=None):
    """Returns (x, cache, aux): aux is the MoE layer's router loss, None
    for other blocks. cache is the block's new cache (decode: updated in
    place for attention, a new state for the recurrent kinds); for a
    pass over a sequence the attention's {k, v} and, with `with_cache`,
    the recurrent kinds' final state; None otherwise. `layout`,
    `seq_sharded` (x is the rank's rows of a sequence-parallel residual)
    and `cache_len`: the module docstring's model axis."""
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
                                cache_pos=cache_pos, cache_len=cache_len)
    else:
        window = cfg.rglru.window if kind == "local_attn" else None
        y, new = attn.gqa_apply(p.attn, h, cfg, positions, window=window,
                                cache=cache, cache_pos=cache_pos,
                                layout=layout, seq_sharded=seq_sharded,
                                with_cache=with_cache or cache is not None,
                                cache_len=cache_len)
    x = x + y
    h = p.ln2(x)
    if hasattr(p, "moe"):
        y, aux = moe_mod.moe_apply(p.moe, h, cfg)
        return x + y, new, aux
    return x + p.mlp(h, seq_sharded), new, None


def layer_apply(layer, x, cfg, blocks, positions, cache=None,
                cache_pos=None, with_cache=False, layout="heads",
                seq_sharded=False, cache_len=None):
    """One layer of a segment: its `blocks` (`layer_blocks`) in order.
    Returns (x, cache, aux) as `block_apply`, cache and aux gathered
    over the blocks (cache by block name for a group)."""
    aux, new = None, {}
    for name, kind in blocks:
        blk = layer if name is None else getattr(layer, name)
        cl = cache if cache is None or name is None else cache[name]
        x, nc, a = block_apply(blk, x, cfg, positions, cl, cache_pos, kind,
                               with_cache, layout, seq_sharded, cache_len)
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


def _embed_input(params, cfg, batch, positions, emb=None):
    """The token embeddings (from `emb`, the view of `params.embed` with
    its FSDP leaves gathered, when given), after the patch embeddings
    (cast to their dtype) when `_n_patch` has any, plus the sinusoidal
    positions for a `pos` "sinusoidal" config: JAX's `_embed_input`."""
    h = embed_lookup(params.embed if emb is None else emb,
                     batch["tokens"])
    if _n_patch(cfg, batch):
        h = torch.cat([batch["patch_embeds"].to(h.dtype), h], dim=1)
    if cfg.pos == "sinusoidal":
        h = h + sinusoidal_positions(positions, cfg.d_model).to(h.dtype)
    return h


class _Apply(nn.Module):
    """`layer_apply` as a module call, so that `functional_call` can put
    a layer's gathered FSDP leaves in for one call."""

    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def forward(self, *args, **kwargs):
        return layer_apply(self.layer, *args, **kwargs)


@functools.lru_cache(maxsize=None)
def _fsdp_dims(cfg, shape: tuple, names: tuple, layout: str
               ) -> Dict[str, int]:
    """{name: the dim a leaf is held over 'data' on} for an FSDP config
    of the model axis on a mesh of `shape` over `names`."""
    from repro_torch.distributed.context import Mesh
    from repro_torch.launch.sharding import ShardingRules
    mesh = Mesh(shape, names)
    if not (cfg.fsdp and mesh.shape.get("data", 1) > 1):
        return {}
    rules = ShardingRules(cfg, mesh, layout)
    out = {}
    for n, shp in param_shapes(cfg).items():
        spec = rules.held_spec(n, shp)
        if "data" in spec:
            out[n] = spec.index("data")
    return out


def _layout_dims(cfg, layout: str):
    """(the layout the model runs, its FSDP dims)."""
    mesh = get_mesh()
    layout = layout if mesh.shape.get("model", 1) > 1 else "heads"
    return layout, _fsdp_dims(cfg, tuple(mesh.shape.values()),
                              mesh.axis_names, layout)


def _prepare(params, cfg, layout: str):
    """(the layout the model runs, its FSDP dims, the embedding to use:
    `params.embed` or its leaves gathered over 'data')."""
    layout, dims = _layout_dims(cfg, layout)
    emb = params.embed
    if any(n.startswith("embed.") for n in dims):
        mesh = get_mesh()
        view = types.SimpleNamespace(vocab=emb.vocab)
        for leaf, t in emb.named_parameters():
            n = "embed." + leaf
            setattr(view, leaf, mesh.all_gather(t, "data", dim=dims[n])
                    if n in dims else t)
        emb = view
    return layout, dims, emb


def _run_layer(layer, prefix: str, dims, x, *args, **kwargs):
    """`layer_apply` of layer (named `prefix`..), its leaves held over
    'data' (FSDP) gathered first, but for a decode step's MoE layers
    under tp > 1 (`moe._decode_moe_2d` runs on the held blocks)."""
    mesh = get_mesh()
    two_d = x.shape[1] == 1 and mesh.shape.get("model", 1) > 1
    own = {n[len(prefix):]: t for n, t in
           layer.named_parameters(prefix=prefix[:-1])
           if n in dims and not (two_d and ".moe." in n)}
    if not own:
        return layer_apply(layer, x, *args, **kwargs)
    full = {"layer." + n: mesh.all_gather(t, "data",
                                          dim=dims[prefix + n])
            for n, t in own.items()}
    return torch.func.functional_call(_Apply(layer), full, (x, *args),
                                      kwargs)


def _remat_layer(layer, prefix, dims, x, cfg, blocks, positions, mesh,
                 kw):
    """(h, aux) of `_run_layer` under the forward's mesh: a checkpoint's
    recompute runs with the backward, on whatever thread autograd takes
    (the CUDA backward has one of its own, which opened no context)."""
    with mesh_context(mesh):
        return _run_layer(layer, prefix, dims, x, cfg, blocks, positions,
                          **kw)[::2]


def backbone(params, cfg, batch, positions=None, caches=None,
             cache_pos=None, with_cache=False, remat=None,
             layout="heads", cache_len=None, emb=None):
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
    backward. `layout`, `cache_len` and `emb` (`_prepare`'s): the module
    docstring's model axis."""
    remat = cfg.remat if remat is None else remat
    remat = remat and torch.is_grad_enabled() and caches is None \
        and not with_cache
    if emb is None:
        layout, dims, emb = _prepare(params, cfg, layout)
    else:
        layout, dims = _layout_dims(cfg, layout)
    mesh = get_mesh()
    tokens = batch["tokens"]
    if positions is None:
        positions = torch.arange(tokens.shape[1] + _n_patch(cfg, batch),
                                 device=tokens.device)
    h = _embed_input(params, cfg, batch, positions, emb)
    sp = _seq_parallel(cfg, mesh, caches, h)
    if sp:
        h = mesh.split(h, "model", dim=1)
    kw = {"layout": layout, "seq_sharded": sp, "cache_len": cache_len}
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    new = {}
    for name in segment_layers(cfg):
        blocks = layer_blocks(cfg, name)
        layers = []
        for i, layer in enumerate(getattr(params, name)):
            pre = f"{name}.{i}."
            if remat:
                h, a = checkpoint(_remat_layer, layer, pre, dims, h, cfg,
                                  blocks, positions, mesh, kw,
                                  use_reentrant=False, **_remat_kwargs(cfg))
            else:
                cl = None if caches is None else _index(caches[name], i)
                h, nc, a = _run_layer(layer, pre, dims, h, cfg, blocks,
                                      positions, cl, cache_pos, with_cache,
                                      **kw)
                if cl is not None:
                    _write(cl, nc)
                elif with_cache:
                    layers.append(nc)
            if a is not None:
                aux = aux + a
        if layers:
            new[name] = _stack(layers)
    if sp:
        h = mesh.gather_from(h, "model", dim=1)
    h = params.final_norm(h)
    if caches is None and with_cache:
        caches = new
    return h, aux, caches


def _seq_parallel(cfg, mesh, caches, h) -> bool:
    """Whether the residual is held S/tp-sharded over 'model' (JAX's
    `cfg.seq_parallel`, over a sequence: not in decode)."""
    return bool(cfg.seq_parallel) and mesh.shape.get("model", 1) > 1 \
        and caches is None and h.shape[1] > 1


def loss_fn(params, cfg, batch, layout="heads"):
    """The training loss of batch["tokens"] (B, S): next-token cross
    entropy (labels are the tokens rolled by one, the last position
    masked, times batch["loss_mask"] when given) over the text positions
    only (after any patches), from `loss_terms`. Returns (ce + aux,
    {"ce", "aux"}); aux, the MoE layers' router loss, is 0 for the other
    families."""
    tot, cnt, aux = loss_terms(params, cfg, batch, layout)
    ce = tot / cnt.clamp(min=1.0)
    return ce + aux, {"ce": ce, "aux": aux}


def loss_terms(params, cfg, batch, layout="heads"):
    """(the masked cross entropy summed over the batch's tokens, the
    count of tokens it covers, aux) as fp32 scalars, through
    `chunked_ce_sums`: what a data-parallel step adds over the ranks."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    layout, _, emb = _prepare(params, cfg, layout)
    h, aux, _ = backbone(params, cfg, batch, layout=layout, emb=emb)
    h = h[:, h.shape[1] - S:]
    labels = torch.roll(tokens, -1, dims=1)
    mask = torch.ones((B, S), dtype=torch.float32, device=tokens.device)
    mask[:, -1].fill_(0.0)   # not a setitem: the same ops on every device
    if "loss_mask" in batch:
        mask = mask * batch["loss_mask"]
    tot, cnt = chunked_ce_sums(emb, h, labels, mask, cfg)
    return tot, cnt, aux


def _layer_cache(cfg, kind, batch_size, max_len, dtype, device, rows=None):
    """A layer's zero cache of `max_len` positions; a K/V or MLA cache of
    `rows` rows when given (a rank's, `held_cache_len`), a windowed
    layer's ring of min(window, max_len) slots."""
    rows = max_len if rows is None else rows
    if kind == "ssm":
        return ssm_mod.ssm_cache_shape(cfg, batch_size, dtype, device)
    if kind == "rglru":
        return rglru_mod.rglru_cache_shape(cfg, batch_size, dtype, device)
    if kind == "mla":
        return attn.mla_cache_shape(cfg, batch_size, rows, dtype, device)
    if kind == "local_attn":
        return attn.gqa_cache_shape(cfg, batch_size, max_len, dtype, device,
                                    window=cfg.rglru.window)
    return attn.gqa_cache_shape(cfg, batch_size, rows, dtype, device)


def held_cache_len(cfg, max_len: int) -> int:
    """The K/V (or MLA) cache rows a rank holds under the context mesh:
    max_len/tp when max_len >= 4,096 divides over 'model' (JAX's
    `cache_specs`), max_len otherwise."""
    tp = get_mesh().shape.get("model", 1)
    if tp > 1 and max_len >= 4096 and max_len % tp == 0:
        return max_len // tp
    return max_len


def init_cache(cfg, batch_size, max_len, dtype=torch.bfloat16, device=None):
    """Zero caches in JAX's layer-stacked layout (module docstring): K/V
    (L, B, max_len, KV, hd), MLA's {c_kv, k_rope} (L, B, max_len, .), a
    windowed layer's ring (L, B, min(window, max_len), KV, hd), the
    recurrent layers' states (L, B, ...); under the context mesh the
    rank's rows (`held_cache_len`)."""
    dev = resolve(device)
    rows = held_cache_len(cfg, max_len)
    out = {}
    for name, L in segment_layers(cfg).items():
        tree = {n: _layer_cache(cfg, kind, batch_size, max_len, dtype, dev,
                                rows)
                for n, kind in layer_blocks(cfg, name)}
        tree = tree[None] if None in tree else tree
        out[name] = _expand(tree, L)
    return out


def extend_cache(caches, cfg, length: int, max_len: int):
    """The caches a prefill of `length` positions returned (leaves (L, B,
    length, ...), or a rank's rows of them, `held_cache_len`) as decode
    caches of `max_len` positions, held as `init_cache` holds them: K/V
    and MLA's {c_kv, k_rope} the prefill's rows first and zeros after; a
    windowed layer's last min(window, length) rows each in its ring slot
    (position % the ring's min(window, max_len) slots); the recurrent
    states ({conv, ssd}, {conv, h}) as they are."""
    mesh = get_mesh()

    def rows(t):
        if held_cache_len(cfg, length) != length:   # rows over 'model'
            t = mesh.all_gather(t.contiguous(), "model", dim=2)
        pad = [0, 0] * (t.dim() - 3) + [0, max_len - length]
        full = torch.nn.functional.pad(t, pad)
        n = held_cache_len(cfg, max_len)
        if n != max_len:
            r = mesh.coords["model"]
            full = full[:, :, r * n:(r + 1) * n]
        return full.contiguous()

    def ring(t):
        T, n = min(cfg.rglru.window, max_len), t.shape[2]
        full = t.new_zeros(t.shape[:2] + (T,) + t.shape[3:])
        full[:, :, (length - n + torch.arange(n, device=t.device)) % T] = t
        return full

    def walk(tree, ringed=False):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, ringed or (cfg.family == "hybrid"
                                            and k == "attn"))
            elif k in ("conv", "ssd", "h"):
                out[k] = v
            else:
                out[k] = ring(v) if ringed else rows(v)
        return out
    return walk(caches)


def _expand(tree, L):
    if isinstance(tree, dict):
        return {n: _expand(t, L) for n, t in tree.items()}
    return tree.expand((L,) + tree.shape).contiguous()


@torch.no_grad()
def prefill(params, cfg, batch, layout="heads") -> tuple:
    """Full-sequence forward of batch["tokens"] (B, S), after
    batch["patch_embeds"] for a vision_patches config; returns (the last
    token's fp32 logits over the padded vocab, caches). The caches'
    sequence length is S plus the patches (extend them before decoding
    further; under the model axis a rank's rows, `held_cache_len`); a
    windowed layer's holds the last min(window, S) positions."""
    layout, _, emb = _prepare(params, cfg, layout)
    h, _, caches = backbone(params, cfg, batch, with_cache=True,
                            layout=layout, emb=emb)
    logits = unembed_gathered(emb, h[:, -1], cfg)
    return logits.float(), caches


@torch.no_grad()
def decode_step(params, cfg, token, cache: Dict[str, Any], cache_pos: int,
                layout="heads", cache_len=None):
    """token (B, 1) integer tensor; cache from init_cache(cfg, B,
    max_len), updated in place and returned; cache_pos = the number of
    tokens already in the cache; `cache_len` the caches' whole length
    when their rows are held over 'model' (`held_cache_len`). Returns
    (fp32 logits (B, Vp), cache)."""
    # the cache slot is a host int (a 0-d tensor is read once here)
    cache_pos = int(cache_pos)  # tracelint: allow=host-sync
    layout, _, emb = _prepare(params, cfg, layout)
    positions = cache_pos + torch.arange(1, device=token.device)
    h, _, cache = backbone(params, cfg, {"tokens": token},
                           positions=positions, caches=cache,
                           cache_pos=cache_pos, layout=layout,
                           cache_len=cache_len, emb=emb)
    logits = unembed_gathered(emb, h[:, -1], cfg)
    return logits.float(), cache

"""Mixture-of-Experts with HiAER-style address-event routing — the port
of `repro/models/moe.py`.

A token choosing its top-k experts is an address event, and dispatch is
HiAER's two-phase routing: `_pack` is the pointer lookup (each event's
slot in its expert's capacity buffer), the expert FFN runs on the
buffers, and `_unpack` delivers each result back to its token, weighted.

Layout: experts are sharded over the context mesh's 'model' axis (cores
within an FPGA): under tp = mesh.shape["model"] > 1 a rank holds experts
[r·E/tp, (r+1)·E/tp) (`shard_experts` cuts a model's MoE layers to the
rank's blocks). `moe_apply` takes JAX's branches:
  * tp = 1, or one position (decode): every rank routes its own batch
    rows, runs its expert slice on the whole (E, C, d) buffer and the
    slices are gathered over 'model' (JAX's psum of disjoint slices).
    At tp = 1 on one rank this is the single-device layer, unchanged.
  * prefill and training at tp > 1 (`_seq_sharded`): each rank routes
    its own S/tp positions (the capacity from the local token count, so
    drops differ from tp = 1, as in JAX), packs, and one all_to_all of
    the (tp, E_loc·C, d) buffer over 'model' delivers each expert's
    tokens to its owner; the FFN runs on (E_loc, tp·C, d), a second
    all_to_all brings the results back, and the routed output is
    gathered over 'model' (`Mesh.split` in, `Mesh.gather_from` out: the
    replicated input's and output's gradients are whole on every rank,
    the router's partial). `_hiaer_exchange` is that exchange on a
    multi-pod mesh with `moe.hierarchical_a2a`.
  * decode on an FSDP config with a 'data' axis (`_decode_moe_2d`):
    experts 2-D (E over 'model', d over 'data'); tokens gathered over
    'data', partial pre-activations summed over 'data'. The shared
    experts are 2-D too: their tokens are gathered over 'data' as the
    routed experts' are, so each row's pre-activation sums its own
    d-slices. (JAX's code sums the data shards' different rows there;
    the port does not copy that: ROADMAP §3.)
The shared experts (and the MoE family's dense first layer, an `MLP`)
are the model axis's tensor-parallel MLP when held in their d_ff blocks
(`layers.mlp_apply`): on the whole replicated input, column- then
row-parallel; held whole they compute as on one device. The aux loss is
averaged over every axis of the mesh (JAX's pmean). The collectives are
the mesh's autograd-aware ones, so the layer trains under tp > 1 (the
backward of the all_to_all is the reverse all_to_all).

`moe_apply_sharded_ref` runs every shard's routing, exchange and FFN in
one process with no collectives: the yardstick the ranks are held to.

The order of JAX's arithmetic is kept where it decides which events are
dropped: the top-k of the fp32 *probabilities* in `lax.top_k`'s order
(descending, the lower expert first among equal values), events taken
token-major then by choice, an event's position in its expert the
exclusive count of earlier events there, and events past the capacity
sent to a sentinel row. The products are plain `torch.bmm`/`matmul`, as
JAX's are einsums outside any Pallas kernel.
"""
from __future__ import annotations

import math

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.context import Mesh, get_mesh
from repro_torch.models.layers import dense_init


class Shared(nn.Module):
    """The shared (always-on) experts as one gated FFN: `w_in`,
    `w_gate` (d, n_shared·F) and `w_out` (n_shared·F, d)."""

    def __init__(self, d: int, f: int, gen: torch.Generator, dtype):
        super().__init__()
        self.d_ff = f                    # the whole width, held or not
        self.w_in = dense_init(gen, (d, f), dtype)
        self.w_gate = dense_init(gen, (d, f), dtype)
        self.w_out = dense_init(gen, (f, d), dtype)


class MoE(nn.Module):
    """`router` (d, E), fp32 whatever the model's dtype; `w_in`,
    `w_gate` (E, d, F) and `w_out` (E, F, d); `shared` when the config
    has shared experts: JAX's `moe_init`."""

    def __init__(self, cfg, gen: torch.Generator, dtype):
        super().__init__()
        mo, d = cfg.moe, cfg.d_model
        E, F_ = mo.n_routed, mo.d_ff_expert
        self.router = dense_init(gen, (d, E), torch.float32)
        self.w_in = dense_init(gen, (E, d, F_), dtype, fan_in=d)
        self.w_gate = dense_init(gen, (E, d, F_), dtype, fan_in=d)
        self.w_out = dense_init(gen, (E, F_, d), dtype, fan_in=F_)
        if mo.n_shared:
            self.shared = Shared(d, mo.n_shared * F_, gen, dtype)


def _act(cfg, g, h):
    if cfg.act == "geglu":
        return F.gelu(g, approximate="tanh") * h
    return F.silu(g) * h


def _onehot(flat_e, E: int):
    """(N,) expert ids -> (E, N) int64 one-hot columns (a comparison,
    where `F.one_hot` would read the ids' range back to the host)."""
    return (torch.arange(E, device=flat_e.device)[:, None] == flat_e).long()


def _route(x_tok, router, cfg):
    """x_tok (T, d) -> the top-k weights (T, k) fp32, expert ids (T, k)
    int64 and the load-balance aux loss (Switch style, E · Σ_e f_e ·
    p̄_e times the aux weight; f counts every choice, dropped or not)."""
    mo = cfg.moe
    E = mo.n_routed
    probs = torch.softmax(x_tok.float() @ router.float(), dim=-1)
    # lax.top_k's order: a stable descending sort puts the lower expert
    # first among equal probabilities (torch.topk leaves ties unordered)
    ids = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :mo.top_k]
    w = probs.gather(1, ids)
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    f = _onehot(ids.reshape(-1), E).sum(1).float()
    f = f / f.sum().clamp(min=1.0)
    aux = E * (f * probs.mean(0)).sum() * mo.router_aux_weight
    return w, ids, aux


def _capacity(T: int, cfg) -> int:
    mo = cfg.moe
    c = int(math.ceil(T * mo.top_k / mo.n_routed * mo.capacity_factor))
    return max(8, ((c + 7) // 8) * 8)


def _pack(x_tok, ids, w, C: int, E: int):
    """Scatter each (token, choice) event's token into its expert's
    capacity buffer: (buf (E·C, d), slot (T·k,), keep (T·k,)). An
    event's slot is e·C + its position among the expert's events,
    token-major; past C it is dropped to the sentinel E·C."""
    T, d = x_tok.shape
    k = ids.shape[1]
    flat_e = ids.reshape(-1)
    # the count of the expert's events up to each event, less its own:
    # a scan along the events (the innermost axis, which the card scans
    # in parallel; along the outer axis one thread walks each expert)
    pos = _onehot(flat_e, E).cumsum(1).gather(0, flat_e[None])[0] - 1
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos, E * C)
    # kept slots are unique, so each kept row is one write
    buf = x_tok.new_zeros((E * C + 1, d)).index_add(
        0, slot, x_tok.repeat_interleave(k, dim=0))
    return buf[:-1], slot, keep


def _unpack(buf, slot, keep, w, T: int, k: int):
    """Gather each event's result, weight it (0 if dropped) and sum a
    token's k events in the buffer's dtype: (T, d)."""
    buf = torch.cat([buf, buf.new_zeros((1, buf.shape[1]))])
    # index_select's backward adds into the rows (every kept slot is read
    # once), where indexing's sorts the slots first
    y = buf.index_select(0, slot)
    y = y * (keep[:, None] * w.reshape(-1)[:, None]).to(y.dtype)
    return y.reshape(T, k, -1).sum(1)


def _expert_ffn(p, cfg, toks):
    """toks (E, N, d) -> (E, N, d), each expert's gated FFN."""
    h = torch.bmm(toks, p.w_in)
    g = torch.bmm(toks, p.w_gate)
    return torch.bmm(_act(cfg, g, h), p.w_out)


def _shared_ffn(sp, cfg, x):
    """The shared experts on x (B, S, d): `layers.mlp_apply`'s gated
    FFN, tensor-parallel when held in d_ff blocks."""
    if sp.w_out.shape[0] < getattr(sp, "d_ff", sp.w_out.shape[0]):
        mesh = get_mesh()
        x = mesh.copy_to(x, "model")
        return mesh.reduce_from(
            _act(cfg, x @ sp.w_gate, x @ sp.w_in) @ sp.w_out, "model")
    return _act(cfg, x @ sp.w_gate, x @ sp.w_in) @ sp.w_out


def _two_d(cfg, mesh) -> bool:
    """Whether decode runs `_decode_moe_2d` on this mesh."""
    return bool(cfg.fsdp) and mesh.shape["model"] > 1 \
        and "data" in mesh.axis_names


def expert_specs(cfg, mesh, decode: bool = False) -> Dict[str, tuple]:
    """The blocks a rank holds of an MoE layer's sharded leaves (names in
    the layer): the routed experts over 'model', and for
    `_decode_moe_2d` also d over 'data' and the shared experts 2-D.
    Leaves not named are whole on every rank."""
    if decode and _two_d(cfg, mesh):
        specs = {"w_in": ("model", "data", None),
                 "w_gate": ("model", "data", None),
                 "w_out": ("model", None, "data")}
        if cfg.moe.n_shared:
            specs.update({"shared.w_in": ("data", "model"),
                          "shared.w_gate": ("data", "model"),
                          "shared.w_out": ("model", "data")})
        return specs
    return {n: ("model", None, None) for n in ("w_in", "w_gate", "w_out")}


def shard_experts(model: nn.Module, cfg, mesh=None, decode=False):
    """Cut every MoE layer of `model` (a layer or a whole LM) to this
    rank's blocks under `expert_specs`, in place; a no-op at tp = 1.
    Returns the model."""
    from repro_torch.launch.sharding import local_slice
    mesh = get_mesh() if mesh is None else mesh
    if mesh.shape["model"] == 1:
        return model
    specs = expert_specs(cfg, mesh, decode)
    for mod in [m for m in model.modules() if isinstance(m, MoE)]:
        for name, spec in specs.items():
            *path, leaf = name.split(".")
            owner = mod
            for part in path:
                owner = getattr(owner, part)
            w = getattr(owner, leaf)
            block = w.data[local_slice(spec, w.shape, mesh)].clone()
            setattr(owner, leaf, nn.Parameter(block,
                                              requires_grad=w.requires_grad))
    return model


def _check_held(p, cfg, mesh, decode: bool) -> None:
    E, tp = cfg.moe.n_routed, mesh.shape["model"]
    want = E // tp
    if E % tp or p.w_in.shape[0] != want or (
            decode and _two_d(cfg, mesh)
            and p.w_in.shape[1] != cfg.d_model // mesh.shape["data"]):
        raise ValueError(
            f"an MoE layer at tp = {tp} holds w_in {tuple(p.w_in.shape)}: "
            f"each rank holds its blocks of {E} experts "
            f"(`shard_experts(model, cfg, mesh, decode={decode})`)")


def moe_apply(p, x, cfg):
    """x (B, S, d) -> (y (B, S, d), aux) under the context mesh: the
    rank's batch rows in and out (the whole sequence, replicated over
    'model'). One rank on a trivial mesh routes every token, packs the
    events into (E, C, d) buffers at C = `_capacity(B·S)`, runs every
    expert on its buffer, unpacks and adds the shared experts."""
    y, aux, _ = apply_with_keep(p, x, cfg)
    return y, aux


def apply_with_keep(p, x, cfg):
    """`moe_apply` that also returns the rank's keep mask (T·k,): which
    of the events it routed were kept (the others dropped past the
    capacity)."""
    mesh = get_mesh()
    tp, decode = mesh.shape["model"], x.shape[1] == 1
    if tp > 1:
        _check_held(p, cfg, mesh, decode)
    if decode and tp > 1 and _two_d(cfg, mesh):
        return _decode_moe_2d(p, x, cfg, mesh)
    if decode or tp == 1:
        return _replicated(p, x, cfg, mesh)
    return _seq_sharded(p, x, cfg, mesh)


def _replicated(p, x, cfg, mesh: Mesh):
    """JAX's replicated dispatch: route the rank's tokens, run its expert
    slice of the (E, C, d) buffer, gather the slices over 'model'.
    Returns (y, aux, keep)."""
    mo = cfg.moe
    B, S, d = x.shape
    E, T = mo.n_routed, B * S
    e_loc = E // mesh.shape["model"]
    j = mesh.coords["model"]
    xt = x.reshape(T, d)
    w, ids, aux = _route(xt, p.router, cfg)
    C = _capacity(T, cfg)
    buf, slot, keep = _pack(xt, ids, w, C, E)
    out = _expert_ffn(p, cfg, buf.reshape(E, C, d)[j * e_loc:(j + 1) * e_loc])
    full = mesh.all_gather(out, "model", dim=0)
    y = _unpack(full.reshape(E * C, d), slot, keep, w, T,
                mo.top_k).reshape(B, S, d)
    if hasattr(p, "shared"):
        y = y + _shared_ffn(p.shared, cfg, x)
    return y, mesh.pmean(aux, mesh.axis_names), keep


def _seq_sharded(p, x, cfg, mesh: Mesh):
    """JAX's sequence-sharded dispatch at tp > 1: the rank's S/tp
    positions routed and exchanged with one all_to_all each way; the
    output gathered over 'model'. Returns (y, aux, keep)."""
    mo = cfg.moe
    B, S, d = x.shape
    tp, E = mesh.shape["model"], mo.n_routed
    if S % tp:
        raise ValueError(f"S = {S} does not split over {tp} model ranks")
    e_loc, s = E // tp, S // tp
    xl = mesh.split(x, "model", dim=1)
    T = B * s
    xt = xl.reshape(T, d)
    w, ids, aux = _route(xt, p.router, cfg)
    C = _capacity(T, cfg)
    buf, slot, keep = _pack(xt, ids, w, C, E)       # (E·C, d) peer-ordered
    send = buf.reshape(tp, e_loc * C, d)
    if mo.hierarchical_a2a and "pod" in mesh.axis_names:
        ex = _hiaer_exchange(send, mesh)
    else:
        ex = mesh.all_to_all(send, "model")
    # ex (tp, E_loc·C, d): block j' came from peer j'
    toks = ex.reshape(tp, e_loc, C, d).transpose(0, 1).reshape(
        e_loc, tp * C, d)
    out = _expert_ffn(p, cfg, toks)
    back = out.reshape(e_loc, tp, C, d).transpose(0, 1).reshape(
        tp, e_loc * C, d)
    back = mesh.all_to_all(back, "model")
    y = _unpack(back.reshape(E * C, d), slot, keep, w, T,
                mo.top_k).reshape(B, s, d)
    y = mesh.gather_from(y, "model", dim=1)
    if hasattr(p, "shared"):
        y = y + _shared_ffn(p.shared, cfg, x)
    return y, mesh.pmean(aux, mesh.axis_names), keep


def _hiaer_exchange(buf, mesh: Mesh):
    """Hierarchical (HiAER) dispatch on the multi-pod mesh. Expert
    weights are replicated per pod (no spec shards experts over 'pod'),
    so token events go all_to_all over the fast intra-pod 'model' axis
    only and no token crosses pods — the slow hop carries only the
    once-a-step gradient reduction. It is the intra-pod exchange, kept as
    the seam for pod-sharded experts (which would add a cross-pod hop
    here)."""
    return mesh.all_to_all(buf, "model")


def _decode_moe_2d(p, x, cfg, mesh: Mesh):
    """Decode against 2-D sharded experts (E over 'model', d over
    'data'): the weights never move; each expert row's tokens are
    gathered over 'data', each rank contracts its d-slice and the
    partial pre-activations are summed over 'data' (exact for the gated
    nonlinearity). The shared experts (d over 'data', F over 'model')
    take the same path on the data shards' rows. Returns (y, aux,
    keep)."""
    mo = cfg.moe
    B, S, d = x.shape
    tp, dp, E = mesh.shape["model"], mesh.shape["data"], mo.n_routed
    e_loc, d_loc, T = E // tp, d // dp, B * S
    i_d, i_m = mesh.coords["data"], mesh.coords["model"]
    xt = x.reshape(T, d)
    w, ids, aux = _route(xt, p.router, cfg)
    C = _capacity(T, cfg)
    buf, slot, keep = _pack(xt, ids, w, C, E)       # (E·C, d) local tokens
    mine = buf.reshape(E, C, d)[i_m * e_loc:(i_m + 1) * e_loc]
    toks = mesh.all_gather(mine, "data", dim=1)     # (E_loc, dp·C, d)
    x_d = toks[..., i_d * d_loc:(i_d + 1) * d_loc]
    g = mesh.psum(torch.bmm(x_d, p.w_gate), "data")
    h = mesh.psum(torch.bmm(x_d, p.w_in), "data")
    out_d = torch.bmm(_act(cfg, g, h), p.w_out)     # (E_loc, dp·C, d_loc)
    out = mesh.all_gather(out_d, "data", dim=2)
    own = out[:, i_d * C:(i_d + 1) * C]
    full = mesh.all_gather(own, "model", dim=0)     # (E, C, d)
    y = _unpack(full.reshape(E * C, d), slot, keep, w, T,
                mo.top_k).reshape(B, S, d)
    if hasattr(p, "shared"):
        # every data shard's rows, each rank contracting its d-slice of
        # them: the sum over 'data' adds one row's slices, never two rows
        sp = p.shared
        xs = mesh.all_gather(x, "data", dim=0)          # (dp·B, S, d)
        xs_d = xs[..., i_d * d_loc:(i_d + 1) * d_loc]
        gs = mesh.psum(xs_d @ sp.w_gate, "data")
        hs = mesh.psum(xs_d @ sp.w_in, "data")
        ys_d = mesh.psum(_act(cfg, gs, hs) @ sp.w_out, "model")
        ys = mesh.all_gather(ys_d, "data", dim=2)       # (dp·B, S, d)
        y = y + ys[i_d * B:(i_d + 1) * B]
    return y, mesh.pmean(aux, mesh.axis_names), keep


class _Block:
    """A rank's view of a layer's parameters, for the reference."""

    def __init__(self, **leaves):
        self.__dict__.update(leaves)


def _block_of(p, cfg, mesh: Mesh, coords, decode: bool):
    from repro_torch.launch.sharding import local_slice
    specs = expert_specs(cfg, mesh, decode)

    def cut(name, w):
        spec = specs.get(name)
        return w if spec is None else \
            w[local_slice(spec, w.shape, mesh, coords)].contiguous()
    blk = _Block(router=p.router, **{n: cut(n, getattr(p, n))
                                     for n in ("w_in", "w_gate", "w_out")})
    if hasattr(p, "shared"):
        blk.shared = _Block(**{n: cut("shared." + n, getattr(p.shared, n))
                               for n in ("w_in", "w_gate", "w_out")})
    return blk


@torch.no_grad()
def moe_apply_sharded_ref(p, x, cfg, mesh_shape: Sequence[int]):
    """`moe_apply` on a mesh of `mesh_shape` (('data', 'model'), or
    ('pod', 'data', 'model') for three axes), computed in this process
    with no collectives: every shard's routing, exchange and FFN in a
    loop over the ranks, each on its blocks of the layer's whole
    parameters `p` and its rows of the global x (B, S, d). Returns (y
    (B, S, d), aux, the events each shard dropped, in rank order). The
    sums over 'data' add the shards in rank order (a gloo sum of two
    members gives the same bits)."""
    names = ("data", "model") if len(mesh_shape) == 2 \
        else ("pod", "data", "model")
    probe = Mesh(mesh_shape, names)
    baxes = names[:-1]                       # JAX's batch_axes()
    mo = cfg.moe
    B, S, d = x.shape
    tp, E = probe.shape["model"], mo.n_routed
    decode = S == 1
    branch = ("2d" if decode and tp > 1 and _two_d(cfg, probe) else
              "rep" if decode or tp == 1 else "seq")
    ranks = [Mesh(mesh_shape, names, rank=r) for r in range(probe.size)]
    nb = probe.axis_size(baxes)
    e_loc, s = E // tp, (S // tp if branch == "seq" else S)

    def rows(m):
        b = m.index(baxes)
        return x[b * B // nb:(b + 1) * B // nb]

    def peer(m, **coords):
        return _rank_of(probe, {**m.coords, **coords})

    st = []
    for m in ranks:
        blk = _block_of(p, cfg, probe, m.coords, branch == "2d")
        xl = rows(m)
        if branch == "seq":
            j = m.coords["model"]
            xl = xl[:, j * s:(j + 1) * s]
        xt = xl.reshape(-1, d)
        w, ids, aux = _route(xt, blk.router, cfg)
        C = _capacity(xt.shape[0], cfg)
        buf, slot, keep = _pack(xt, ids, w, C, E)
        st.append(dict(m=m, blk=blk, xl=xl, w=w, aux=aux, C=C, buf=buf,
                       slot=slot, keep=keep))
    C = st[0]["C"]
    if branch == "rep":
        for r in st:
            j = r["m"].coords["model"]
            r["out"] = _expert_ffn(r["blk"], cfg, r["buf"].reshape(E, C, d)[
                j * e_loc:(j + 1) * e_loc])
        for r in st:
            full = torch.cat([st[peer(r["m"], model=k)]["out"]
                              for k in range(tp)])
            r["y"] = _finish(r, full, cfg)
    elif branch == "seq":
        for r in st:
            j = r["m"].coords["model"]
            ex = torch.stack([st[peer(r["m"], model=k)]["buf"].reshape(
                tp, e_loc * C, d)[j] for k in range(tp)])
            toks = ex.reshape(tp, e_loc, C, d).transpose(0, 1).reshape(
                e_loc, tp * C, d)
            r["back"] = _expert_ffn(r["blk"], cfg, toks).reshape(
                e_loc, tp, C, d).transpose(0, 1).reshape(tp, e_loc * C, d)
        for r in st:
            j = r["m"].coords["model"]
            back = torch.stack([st[peer(r["m"], model=k)]["back"][j]
                                for k in range(tp)])
            r["y"] = _finish(r, back, cfg)
        for r in st:
            r["y_seq"] = torch.cat([st[peer(r["m"], model=k)]["y"]
                                    for k in range(tp)], dim=1)
        for r in st:
            r["y"] = r.pop("y_seq")
    else:
        dp = probe.shape["data"]
        d_loc = d // dp

        def over_data(r, key):
            return [st[peer(r["m"], data=i)][key] for i in range(dp)]
        for r in st:
            j = r["m"].coords["model"]
            r["mine"] = r["buf"].reshape(E, C, d)[j * e_loc:(j + 1) * e_loc]
        for r in st:
            i_d = r["m"].coords["data"]
            toks = torch.cat(over_data(r, "mine"), dim=1)
            x_d = toks[..., i_d * d_loc:(i_d + 1) * d_loc]
            r["g"] = torch.bmm(x_d, r["blk"].w_gate)
            r["h"] = torch.bmm(x_d, r["blk"].w_in)
            if hasattr(p, "shared"):
                xs = torch.cat(over_data(r, "xl"))
                xs_d = xs[..., i_d * d_loc:(i_d + 1) * d_loc]
                r["gs"] = xs_d @ r["blk"].shared.w_gate
                r["hs"] = xs_d @ r["blk"].shared.w_in
        for r in st:
            g, h = (_sum(over_data(r, k)) for k in ("g", "h"))
            r["out_d"] = torch.bmm(_act(cfg, g, h), r["blk"].w_out)
            if hasattr(p, "shared"):
                gs, hs = (_sum(over_data(r, k)) for k in ("gs", "hs"))
                r["ys_d"] = _act(cfg, gs, hs) @ r["blk"].shared.w_out
        for r in st:
            i_d = r["m"].coords["data"]
            out = torch.cat(over_data(r, "out_d"), dim=2)
            r["own"] = out[:, i_d * C:(i_d + 1) * C]
            if hasattr(p, "shared"):
                r["ys_m"] = _sum([st[peer(r["m"], model=k)]["ys_d"]
                                  for k in range(tp)])
        for r in st:
            full = torch.cat([st[peer(r["m"], model=k)]["own"]
                              for k in range(tp)])
            r["y"] = _finish(r, full, cfg, shared=False)
            if hasattr(p, "shared"):
                i_d, b = r["m"].coords["data"], r["xl"].shape[0]
                ys = torch.cat(over_data(r, "ys_m"), dim=2)
                r["y"] = r["y"] + ys[i_d * b:(i_d + 1) * b]
    aux = torch.stack([r["aux"] for r in st]).sum() / len(st)
    # the model-0 ranks, in rank order, hold the batch's rows in order
    y = torch.cat([r["y"] for r in st if r["m"].coords["model"] == 0])
    return y, aux, [int((~r["keep"]).sum()) for r in st]


def _rank_of(mesh: Mesh, coords) -> int:
    r = 0
    for a in mesh.axis_names:
        r = r * mesh.shape[a] + coords[a]
    return r


def _sum(parts):
    out = parts[0]
    for t in parts[1:]:
        out = out + t
    return out


def _finish(r, full, cfg, shared=True):
    """A reference shard's unpack (and shared experts) from its exchanged
    buffer."""
    mo = cfg.moe
    xl = r["xl"]
    B, s, d = xl.shape
    y = _unpack(full.reshape(-1, d), r["slot"], r["keep"], r["w"], B * s,
                mo.top_k).reshape(B, s, d)
    if shared and hasattr(r["blk"], "shared"):
        y = y + _shared_ffn(r["blk"].shared, cfg, xl)
    return y


def moe_flops(cfg, n_tokens: int) -> int:
    """Active FLOPs (top-k and shared experts) for n_tokens tokens."""
    mo = cfg.moe
    per_tok = (mo.top_k + mo.n_shared) * 3 * 2 * cfg.d_model * mo.d_ff_expert
    return per_tok * n_tokens

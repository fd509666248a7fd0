"""Shared layers of the LM stack: norms, RoPE and sinusoidal positions,
MLPs, embeddings and the sequence-chunked cross-entropy loss — the port
of `repro/models/layers.py`.

Parameters live in `nn.Module`s whose attribute names are the JAX
parameter tree's keys (`scale`, `bias`, `w_in`, `w_gate`, `w_out`,
`table`, `out`), in the JAX package's layouts, so a JAX tree maps onto
the port's state by name (`repro_torch.models.weights`). The math is the
plain functions, as in JAX (`apply_norm`, `apply_rope`, `mlp_apply`,
`embed_lookup`, `unembed`); each module's constructor is JAX's `*_init`.
Weights are drawn from a `torch.Generator` on the device they live on:
the same scales as JAX, not the same bits (tests move JAX's weights
over with `weights.params_from_jax`). A generator on the "meta" device
(`META`) draws nothing: the leaves are shapes only. Under `cut_draws`
each drawn leaf is drawn whole, in the order the modules draw them,
and cut to a rank's block at once (`lm.init_params` with a mesh).

The model axis (Megatron's tensor parallelism, ROADMAP item 10.3b). A
layer computes with the leaves it holds; under the context mesh's
'model' axis of size tp > 1 a leaf held in its rank's block
(`launch.sharding.held_spec`) makes the layer tensor-parallel:
  * the MLP (`mlp_apply`): `w_in`/`w_gate` held (d, d_ff/tp), column-
    parallel behind Megatron's f (`Mesh.copy_to`), `w_out` (d_ff/tp, d)
    row-parallel, summed through g (`Mesh.reduce_from`); with a
    sequence-parallel residual the input is gathered over 'model' along
    S and the output reduce-scattered back (`seq_sharded`);
  * the embedding (`embed_lookup`): `table` held (Vp/tp, d), vocab-
    parallel: the rank's rows, tokens outside them zero, summed over
    'model';
  * the unembedding (`unembed`) gives the rank's Vp/tp logits, and the
    loss (`chunked_ce_sums`) reduces the logsumexp (max, then the sum of
    exp) and the gold logit over 'model', the vocab padding masked by
    global ids, so the (B, S, Vp) logits are never gathered;
    `unembed_gathered` gathers the last token's logits to (B, Vp).
A leaf held whole computes as on one device. With tp = 1 every
collective is the identity and every function is the one-device one.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.context import get_mesh


class _MetaGen:
    """A stand-in generator on the meta device: `dense_init` draws
    nothing from it."""
    device = torch.device("meta")


META = _MetaGen()
_cuts = threading.local()


@contextlib.contextmanager
def cut_draws(cuts):
    """Within it, the i-th `dense_init` draw is cut to `cuts[i]` (an
    index, or None for the whole leaf) and its whole freed."""
    _cuts.queue = list(cuts)
    try:
        yield
        if _cuts.queue:
            raise RuntimeError(f"{len(_cuts.queue)} cut(s) left undrawn")
    finally:
        _cuts.queue = None


def dense_init(gen: torch.Generator, shape, dtype, fan_in=None):
    """A weight drawn N(0, 1/fan_in) in fp32 on the generator's device,
    cast to `dtype` (fan_in defaults to shape[0]); a shape on META."""
    if gen.device.type == "meta":
        p = nn.Parameter(torch.empty(shape, dtype=dtype, device="meta"))
        p.drawn = True
        return p
    fan_in = fan_in if fan_in is not None else shape[0]
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    w = w.mul_(1.0 / math.sqrt(max(1, fan_in))).to(dtype)   # in place:
    # a leaf drawn whole to be cut (`cut_draws`) peaks at one fp32 copy
    queue = getattr(_cuts, "queue", None)
    if queue is not None:
        cut = queue.pop(0)
        if cut is not None:
            w = w[cut].clone()
    return nn.Parameter(w)


def _tp():
    """(the context mesh, its 'model' size)."""
    mesh = get_mesh()
    return mesh, mesh.shape.get("model", 1)


class Norm(nn.Module):
    """RMSNorm (`scale`) or LayerNorm (`scale`, `bias`): JAX's
    `norm_init`."""

    def __init__(self, dim: int, dtype, kind: str = "rmsnorm", device=None):
        super().__init__()
        self.kind = kind
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype,
                                             device=device))
        if kind == "layernorm":
            self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype,
                                                 device=device))

    def forward(self, x):
        return apply_norm(self, x, self.kind)


def apply_norm(p, x, kind: str = "rmsnorm", eps: float = 1e-6):
    """Normalise over the last axis in fp32; the result in x's dtype."""
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p.scale.float() + p.bias.float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p.scale.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------- positions
def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd) or (..., S, hd); positions: (..., S) or (S,)
    integer tensor."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)            # (hd/2,)
    ang = positions[..., None].float() * freqs               # (..., S, hd/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.dim() - ang.dim() >= 2:                             # head axis
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions, d_model: int):
    half = d_model // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------- MLP
class MLP(nn.Module):
    """`w_in` (d, d_ff), `w_out` (d_ff, d), and `w_gate` (d, d_ff) for
    the gated activations: JAX's `mlp_init`."""

    def __init__(self, cfg, d_ff: int, gen: torch.Generator, dtype):
        super().__init__()
        d = cfg.d_model
        self.act = cfg.act
        self.d_ff = d_ff                 # the whole width, held or not
        self.w_in = dense_init(gen, (d, d_ff), dtype)
        self.w_out = dense_init(gen, (d_ff, d), dtype)
        if cfg.act in ("swiglu", "geglu"):
            self.w_gate = dense_init(gen, (d, d_ff), dtype)

    def forward(self, x, seq_sharded: bool = False):
        return mlp_apply(self, x, self.act, seq_sharded)


def mlp_apply(p, x, act: str, seq_sharded: bool = False):
    """The MLP of x (B, S, d). With `w_out` held (d_ff/tp, d) under tp >
    1 it is column- then row-parallel: x enters through f (or, when
    `seq_sharded`, x is the rank's S/tp rows, gathered over 'model'
    along S) and the partial outputs leave through g (reduce-scattered
    back to the rank's rows when `seq_sharded`)."""
    mesh, tp = _tp()
    par = tp > 1 and p.w_out.shape[0] < p.d_ff
    if par:
        x = mesh.all_gather(x, "model", dim=1) if seq_sharded \
            else mesh.copy_to(x, "model")
    h = x @ p.w_in
    if act == "swiglu":
        h = F.silu(x @ p.w_gate) * h
    elif act == "geglu":
        h = F.gelu(x @ p.w_gate, approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    y = h @ p.w_out
    if par:
        y = mesh.reduce_scatter(y, "model", dim=1) if seq_sharded \
            else mesh.reduce_from(y, "model")
    return y



# ---------------------------------------------------------------- embeddings
def padded_vocab(cfg) -> int:
    return ((cfg.vocab_size + 127) // 128) * 128


class Embed(nn.Module):
    """`table` (Vp, d), and `out` (d, Vp) when the embeddings are not
    tied: JAX's `embed_init`."""

    def __init__(self, cfg, gen: torch.Generator, dtype):
        super().__init__()
        vp, d = padded_vocab(cfg), cfg.d_model
        self.vocab = vp                  # the whole padded vocab
        self.table = dense_init(gen, (vp, d), dtype, fan_in=d)
        if not cfg.tie_embeddings:
            self.out = dense_init(gen, (d, vp), dtype)


def _vocab(p) -> int:
    """The whole padded vocab of an embedding (held whole when it does
    not record one)."""
    return getattr(p, "vocab", p.table.shape[0])


def _vocab_block(p):
    """(the first vocab id of the rank's block, its length): (0, Vp)
    for a table held whole."""
    mesh, tp = _tp()
    n = p.table.shape[0]
    if tp == 1 or n == _vocab(p):
        return 0, n
    return mesh.coords["model"] * n, n


def embed_lookup(p, tokens):
    """The tokens' rows of `table`; vocab-parallel with the rank's Vp/tp
    rows: tokens outside them are zero, the rows summed over 'model'."""
    v0, n = _vocab_block(p)
    if n == _vocab(p):
        return F.embedding(tokens, p.table)
    loc = tokens - v0
    inside = (loc >= 0) & (loc < n)
    e = F.embedding(torch.where(inside, loc, 0), p.table)
    e = e * inside[..., None].to(e.dtype)
    return get_mesh().reduce_from(e, "model")


def unembed(p, h, cfg):
    """h's logits over the vocab the rank holds: (..., Vp), or its
    (..., Vp/tp) block (h entering through f)."""
    if p.table.shape[0] != _vocab(p):
        h = get_mesh().copy_to(h, "model")
    if cfg.tie_embeddings:
        return h @ p.table.t()
    return h @ p.out


def unembed_gathered(p, h, cfg):
    """`unembed`'s logits gathered over 'model' to the whole padded
    vocab (prefill's and decode's last token)."""
    logits = unembed(p, h, cfg)
    if p.table.shape[0] != _vocab(p):
        logits = get_mesh().all_gather(logits.contiguous(), "model",
                                       dim=logits.dim() - 1)
    return logits


def chunked_ce_loss(emb, h, labels, mask, cfg):
    """Mean next-token cross entropy over the mask: h (B, S, d), labels
    (B, S) integer, mask (B, S) fp32. Returns tot / max(cnt, 1) as an
    fp32 scalar, from `chunked_ce_sums`."""
    tot, cnt = chunked_ce_sums(emb, h, labels, mask, cfg)
    return tot / cnt.clamp(min=1.0)


def chunked_ce_sums(emb, h, labels, mask, cfg):
    """(the masked cross entropy summed, the mask's sum), fp32 scalars.
    The sequence is cut into chunks of the largest divisor of S not
    above `cfg.loss_chunk`, so the (B, S, Vp) logits never exist at
    once; each chunk's fp32 logits mask the vocab padding to -1e30 and
    are rematerialized in the backward (`torch.utils.checkpoint`, JAX's
    `jax.checkpoint` on the scan body). A data-parallel step adds both
    over the ranks before it divides. With the vocab held in Vp/tp
    blocks, the logsumexp and the gold logit are reduced over 'model'
    (the max without a gradient, the sums through g)."""
    B, S, _ = h.shape
    chunk = min(cfg.loss_chunk, S)
    while S % chunk:        # largest divisor of S not above loss_chunk
        chunk -= 1
    v0, n = _vocab_block(emb)
    mesh = get_mesh()

    def body(hx, lx, mx):
        logits = unembed(emb, hx, cfg).float()
        pad = torch.arange(v0, v0 + logits.shape[-1],
                           device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad, torch.full((), -1e30, device=h.device),
                             logits)
        if n == _vocab(emb):
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.take_along_dim(logits, lx[..., None].long(),
                                        dim=-1)[..., 0]
        else:
            m = mesh.pmax(logits.detach().amax(dim=-1), "model")
            lse = m + torch.log(mesh.reduce_from(
                torch.exp(logits - m[..., None]).sum(dim=-1), "model"))
            loc = lx.long() - v0
            inside = (loc >= 0) & (loc < n)
            g = torch.take_along_dim(logits, torch.where(
                inside, loc, 0)[..., None], dim=-1)[..., 0]
            gold = mesh.reduce_from(torch.where(inside, g, 0.0), "model")
        return ((lse - gold) * mx).sum(), mx.sum()

    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        ce, k = checkpoint(body, h[:, sl], labels[:, sl], mask[:, sl],
                           use_reentrant=False)
        tot, cnt = tot + ce, cnt + k
    return tot, cnt

"""Gradient compression with error feedback — the port of
`repro/distributed/compression.py`, with its arithmetic.

Two compressors, both with error-feedback state (the residual carried
into the next step, so compression error does not bias convergence):
  * int8 blockwise quantization (~4x over fp32, one scale per block of
    256: max |x| / 127, the quotient rounded half to even);
  * top-k magnitude sparsification (k a fraction of the leaf; values and
    indices).

They plug into `make_train_step(compressor=...)` and act on the
gradients before the optimizer, as JAX's step applies them: on the
gradients after they are reduced over the data axes (JAX's docstring
places them between an intra-pod and a cross-pod reduce; neither
package's code does that).

Leaves are dicts of named tensors. JAX compresses a segment's leaf
stacked over its layers (`blocks/attn/wq`, (L, ...)): int8's blocks of
256 run on across the layers and top-k picks from all of them, and
`compressed_bytes` counts a leaf once. So the port's per-layer leaves
(`blocks.3.attn.wq`) are stacked by segment leaf before they are
compressed (`checkpoint.store.layer_of`), and the results split back.

Top-k picks JAX's set in JAX's order: `lax.top_k` puts the lower index
first among equal magnitudes, and `torch.topk` leaves the order of ties
unspecified, so the port takes the k-th magnitude from `torch.topk` and
breaks ties by index itself (`topk_compress`) — the same set on every
device.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.checkpoint.store import layer_of

BLOCK = 256


def _pad(x: torch.Tensor, m: int):
    flat = x.reshape(-1)
    n = flat.numel()
    pad = (-n) % m
    return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat, n


def int8_compress(g: torch.Tensor):
    """g (any shape) -> (q int8 (n_blocks, 256), scale fp32
    (n_blocks, 1), n)."""
    flat, n = _pad(g.float(), BLOCK)
    blocks = flat.reshape(-1, BLOCK)
    # a tensor divisor: CUDA turns division by a Python number into a
    # product with its reciprocal, which rounds otherwise than JAX's
    # (and the CPU's) quotient
    scale = blocks.abs().amax(dim=1, keepdim=True) / torch.full(
        (), 127.0, device=blocks.device)
    q = torch.round(blocks / scale.clamp(min=1e-12)).to(torch.int8)
    return q, scale, n


def int8_decompress(q, scale, n: int, shape) -> torch.Tensor:
    out = (q.float() * scale).reshape(-1)[:n]
    return out.reshape(shape)


def topk_compress(g: torch.Tensor, frac: float):
    """g -> (values fp32 (k,), indices (k,), size): the k = max(1,
    int(size * frac)) entries of largest magnitude in `lax.top_k`'s
    order, descending, the lower index first among equals. The k-th
    magnitude is `torch.topk`'s (its set of values is unique, its order
    among ties is not); every larger entry is taken, then the equal ones
    in index order until there are k, and those k are sorted stably — a
    sort of k entries, not of the leaf."""
    flat = g.float().reshape(-1)
    k = max(1, int(flat.numel() * frac))
    mag = flat.abs()
    kth = torch.topk(mag, k, sorted=False).values.min()
    above = (mag > kth).nonzero().squeeze(1)
    ties = (mag == kth).nonzero().squeeze(1)[:k - above.numel()]
    pick = torch.cat([above, ties])
    order = torch.sort(mag[pick], descending=True, stable=True).indices
    idx = pick[order]
    return flat[idx], idx, flat.numel()


def topk_decompress(vals, idx, size: int, shape) -> torch.Tensor:
    out = torch.zeros(size, dtype=torch.float32, device=vals.device)
    return out.index_put_((idx,), vals).reshape(shape)


class ErrorFeedback:
    """Stateful wrapper: grads <- decompress(compress(grads + residual));
    residual <- (grads + residual) - decompressed. `init` and `apply`
    take and give dicts of named leaves."""

    def __init__(self, mode: str = "int8", topk_frac: float = 0.01):
        if mode not in ("int8", "topk"):
            raise ValueError(f"compression mode {mode!r}: int8 or topk")
        self.mode = mode
        self.topk_frac = topk_frac

    def init(self, grads: Dict[str, torch.Tensor]):
        return {n: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                for n, g in grads.items()}

    def one(self, g: torch.Tensor, r: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = g.float() + r
        if self.mode == "int8":
            q, s, n = int8_compress(x)
            d = int8_decompress(q, s, n, x.shape)
        else:
            v, i, n = topk_compress(x, self.topk_frac)
            d = topk_decompress(v, i, n, x.shape)
        return d.to(g.dtype), x - d

    def apply(self, grads, residual):
        """Returns (compressed-then-decompressed grads, new residual),
        each segment leaf's layers compressed as one stacked leaf."""
        out, res = {}, {}
        for names in leaf_groups(grads):
            if len(names) == 1:
                n = names[0]
                out[n], res[n] = self.one(grads[n], residual[n])
                continue
            d, r = self.one(torch.stack([grads[n] for n in names]),
                            torch.stack([residual[n] for n in names]))
            for i, n in enumerate(names):
                out[n], res[n] = d[i], r[i]
        return out, res


def leaf_groups(grads) -> List[List[str]]:
    """The names of `grads` grouped by JAX leaf: a segment's per-layer
    leaves together, in layer order; every other name alone."""
    groups: Dict[tuple, dict] = {}
    for n in grads:
        path, i = layer_of(n)
        groups.setdefault(path if i is not None else (n,), {})[
            -1 if i is None else i] = n
    return [[by[i] for i in sorted(by)] for by in groups.values()]


def compressed_bytes(grads, mode: str = "int8", topk_frac: float = 0.01
                     ) -> int:
    """The bytes the compressed form of `grads` (a dict of leaves, a
    segment's layers counted as one leaf) takes: int8 one byte an element
    plus 4 a block, top-k 8 an entry."""
    total = 0
    for names in leaf_groups(grads):
        n = sum(grads[k].numel() for k in names)
        if mode == "int8":
            total += n + 4 * (n // BLOCK + 1)
        else:
            k = max(1, int(n * topk_frac))
            total += 8 * k
    return total

"""Flash attention, forward and backward — wrappers of the CUDA kernels
`csrc/flash_attention.cu` and `csrc/flash_attention_bwd.cu`, the ports of
the three entries of `repro/kernels/flash_attention.py` (with the
any-length interface of `repro.kernels.ops.flash_attention`):

  * `flash_attention(q, k, v, causal, window, q_start)` -> o, the forward
    (Pallas `_kernel`; the prefill's attention);
  * `flash_fwd_lse(q, k, v, causal, window, q_start)` -> (o, lse), the same
    forward with each row's logsumexp (Pallas `_kernel_lse`, JAX's
    `_flash_fwd_lse`);
  * `flash_attention_bwd(q, k, v, o, lse, do, causal, window, q_start)` ->
    (dq, dk, dv), two kernels as in JAX (`_bwd_dkv_kernel`,
    `_bwd_dq_kernel`);
  * `flash_attention_trainable(q, k, v, causal, window, q_start)`, the
    differentiable
    attention of the training path: a `torch.autograd.Function` whose
    forward is `flash_fwd_lse` and whose backward is
    `flash_attention_bwd`, saving (q, k, v, o, lse) as JAX's `_fat_fwd`.

q is (B, H, S, D); k is (B, KV, S, D) and v (B, KV, S, D_v) with H % KV
== 0 (Sq and Sk rows with an offset, below), query head h reading KV
head h // (H / KV) — the grouping of `repro.models.attention._sdpa`, so
the model's narrow K/V go in without being repeated; KV == H is the TPU
kernels' function. o is (B, H, S, D_v). dK and dV come back as k's and
v's shapes, each summed over its group's H / KV query heads. lse is
dense fp32 (B, H, S) (JAX keeps it as (B*H, S)). Any strides with a
dense last axis: the model passes its (B, S, H, D) projections through
`.transpose(1, 2)`, and o and dq keep q's layout (o's axes in q's
order at its own last dim). Any S >= 1: the kernels mask their ragged
tail where the TPU wrapper padded S. D = D_v in {64, 128, 192, 256}, or
(D, D_v) = (192, 128), DeepSeek-V2's MLA (q and k 128 + 64, v 128: its V
is never padded); fp32 or bf16.

`window` (an int >= 1, causal only; None for none) is the sliding window
of `repro.models.attention._sdpa`: query i sees keys i - window < j <= i
(RecurrentGemma's local attention). It reaches the kernels as a runtime
int (0 for none), so it adds no instance: the forward's walks start at
the first key tile in their window, the dK/dV walks stop at the last
query tile that sees their keys, and the tiles on the window's edge mask
the keys before it. The TPU kernels take no window; JAX's local
attention runs in XLA (`attend`), and the port runs it on these kernels.

`q_start` (an int >= 0; 0 by default) is the query offset of the
sequence-sharded layout (`repro.models.attention._shardmap_seq_attention`):
q holds Sq rows at positions q_start .. q_start + Sq - 1 and k, v hold Sk
>= q_start + Sq keys, q (B, H, Sq, D) against k, v (B, KV, Sk, D); the
masks read each row's position (`_sdpa(q_start=..., kv_len=Sk)`). Like
the window it reaches the kernels as a runtime int with Sq and Sk, so it
adds no instance: the forward's and dQ's walks stop at the key tile of
their last row's position, the dK/dV walks cover every key tile from the
first query tile whose diagonal reaches it (zeros for a key tile no query
sees). lse is (B, H, Sq), dK and dV (B, KV, Sk, D). With q_start = 0 and
Sq == Sk the kernels give the bits they gave before the offset. An
offset or lengths the kernels cannot take raise ValueError, on the CPU
as on the card.

The forward has one kernel per input type. fp32 runs every operation in
fp32 FMAs on the CUDA cores (the TPU kernel's contract; TF32 would break
its 2e-5). bf16 runs on Hopper's tensor cores: Q K^T and P V as wgmma
products with fp32 accumulators, the scale applied to the fp32 scores,
an fp32 online softmax, K/V tiles staged by TMA in a 2-stage ring. P
enters P V as P_hi + P_lo, two bf16 parts (~16 bits of p; the
denominator sums the unrounded p): P rounded once moved outputs of a
peaky softmax a bf16 ulp past the 2e-2 tolerance (`csrc` header).
The backward's two kernels follow the same split: fp32 FMAs for fp32,
Hopper's tensor cores for bf16 (every product a wgmma with fp32
accumulators, P and dS rounded to bf16 once, the scale applied in
fp32). dK/dV leave their kernel as fp32 partials (B, KV, chunks, S, D),
one per chunk of each group's query heads (one per query head in fp32;
for bf16 the kernel's chunk count, `flash_bwd_dkv_chunks`, which
depends on the shape only), summed here in order: the same bits on
every call, no float atomics.
The bf16 kernels' TMA loads and 16-byte stores need 16-byte-aligned
q, k, v, o (forward) and do, dq (backward) with (B, heads, S) strides
that are multiples of 8 elements; a bf16 CUDA tensor that breaks this
raises ValueError (it never falls back to the fp32 kernels).

CPU tensors take the plain versions (`kernels.ref`); CUDA tensors launch
the kernels or raise. Meta tensors (the dry-run, `launch.dryrun`) run the
launch path without the launch: the outputs and buffers the card's call
allocates (o, lse, delta, the dK/dV chunk partials), as empty meta
tensors; nothing is computed in the kernel's place, as a meta tensor has
no values. Each kernel launch adds one to its wrapper's `launches`:
`flash_attention.launches`, `flash_fwd_lse.launches`, and
`_bwd_dkv.launches` / `_bwd_dq.launches` for the backward's two kernels.
Every call is reported to an open `launch.op_analysis.OpCounter`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref, flash_fwd_lse_ref)
from repro_torch.launch import op_analysis

HEAD_DIMS = (64, 128, 192, 256)
# the (D, D_v) pairs with D_v != D that have instances (csrc): MLA's
HEAD_DIM_PAIRS = ((192, 128),)
# the dK/dV tensor-core kernel's shape (csrc/flash_attention_bwd.cu): keys
# a block at (D, D_v) (64 where its warpgroups split dK and dV, 128 where
# each holds both) and the blocks it wants
DKV_KEYS = {(64, 64): 128, (128, 128): 128, (192, 192): 64, (256, 256): 64,
            (192, 128): 128}
DKV_MIN_BLOCKS = 256


def dkv_chunks(bf16: bool, B: int, H: int, KV: int, Sk: int, D: int,
               Dv: int | None = None) -> int:
    """`flash_bwd_dkv_chunks`: the dK/dV partials' chunk count, one per
    query head of a group in fp32; in bf16 the fewest chunks of the
    group's H / KV heads (a divisor) that give DKV_MIN_BLOCKS blocks (Dv:
    v's head dim, D when None)."""
    rep = H // KV
    if not bf16:
        return rep
    keys = DKV_KEYS[(D, Dv or D)]
    base = B * KV * (-(-Sk // keys))
    for c in range(1, rep):
        if rep % c == 0 and base * c >= DKV_MIN_BLOCKS:
            return c
    return rep


def _cost(q, k, v, causal, window, q_start, at_d: int, at_dv: int) -> int:
    """The flops of `at_d` (B, H, Sq, Sk) x D products and `at_dv` of them
    at v's D_v, over the (query, key) pairs the mask keeps: PERF.md §6's
    bound rule."""
    B, H, Sq, D = q.shape
    pairs = op_analysis.attention_pairs(Sq, k.shape[2], causal, window,
                                        q_start)
    return 2 * B * H * pairs * (at_d * D + at_dv * v.shape[3])


def _bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _out_bytes(q, v) -> int:
    """The bytes of o: q's rows at v's D_v, in q's dtype."""
    return q.numel() // q.shape[3] * v.shape[3] * q.element_size()


def _empty_as(like, D: int, dtype=None):
    """An empty tensor of `like`'s shape with last dim D whose axes lie in
    memory in `like`'s order: o (at D_v) and dq as the card's call lays
    them out, q's layout."""
    if like.shape[3] == D:
        return torch.empty_like(like, dtype=dtype)
    order = sorted(range(3), key=lambda i: -like.stride(i))
    out = torch.empty([like.shape[i] for i in order] + [D],
                      dtype=dtype or like.dtype, device=like.device)
    return out.permute(*[order.index(i) for i in range(3)], 3)


def _laid_out(x, like):
    """x in `like`'s layout: the plain version's output laid out as the
    card's call gives it (o and dq keep q's layout), so that the ops
    after it are the card's on the CPU too."""
    return _empty_as(like, x.shape[3], x.dtype).copy_(x)


def _check(name, q, k, v, q_start=0):
    """Validate the forward's interface for a kernel launch; returns
    (B, H, KV, Sq, D) (Sk is k's length, D_v v's last dim)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"{name}: want q (B, H, Sq, D), k (B, KV, Sk, D) "
                         f"and v (B, KV, Sk, D_v), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if (k.shape[0], k.shape[3]) != (B, D) or KV == 0 or H % KV:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H % KV must be 0)")
    if v.shape[3] != D and (D, v.shape[3]) not in HEAD_DIM_PAIRS:
        raise ValueError(f"{name}: head dims (D, D_v) = {(D, v.shape[3])} "
                         f"have no instance: D_v == D, or a pair of "
                         f"{HEAD_DIM_PAIRS}")
    _offset(name, q_start, S, Sk)
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name} takes fp32 or bf16 q, k, v of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {HEAD_DIMS}")
    if not 0 < B <= 65535 or not 0 < H <= 65535:
        raise ValueError(f"{name} takes 1..65535 batch rows and heads, got "
                         f"B={B}, H={H}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the head dim must be dense (stride 1) in "
                         f"q, k and v")
    return B, H, KV, S, D


def _offset(name, q_start, Sq: int, Sk: int) -> int:
    """The kernels' q_start: an int >= 0 with q_start + Sq <= Sk (Sq ==
    Sk when it is 0 and the keys are the queries'), or ValueError."""
    if isinstance(q_start, bool) or not isinstance(q_start, int) \
            or q_start < 0 or q_start + Sq > Sk:
        raise ValueError(f"{name}: q_start must be an int >= 0 with q_start "
                         f"+ Sq <= Sk, got q_start={q_start!r}, Sq={Sq}, "
                         f"Sk={Sk}")
    return q_start


def _strides(*tensors):
    return [s for t in tensors for s in t.stride()[:3]]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_aligned(name, **tensors):
    """The bf16 kernel's TMA loads and 16-byte stores want 16-byte-aligned
    bases and (B, heads, S) strides that are multiples of 8 elements (an
    axis of extent 1 is never stepped); raises ValueError otherwise."""
    for n, t in tensors.items():
        if t.data_ptr() % 16 or any(t.stride(i) % 8 for i in range(3)
                                    if t.shape[i] > 1):
            raise ValueError(
                f"{name}: the bf16 kernel needs {n} 16-byte aligned with "
                f"strides that are multiples of 8 elements, got data_ptr % "
                f"16 = {t.data_ptr() % 16}, strides {t.stride()}")


def _window(name, causal, window) -> int:
    """The kernels' window argument: 0 for None, else window (an int
    >= 1, with causal) or ValueError."""
    if window is None:
        return 0
    if isinstance(window, bool) or not isinstance(window, int) \
            or window < 1 or not causal:
        raise ValueError(f"{name}: window must be an int >= 1 with "
                         f"causal=True, got window={window!r}, "
                         f"causal={causal}")
    return window


def _forward(name, q, k, v, causal, window, lse, q_start=0):
    B, H, KV, S, D = _check(name, q, k, v, q_start)
    Sk, Dv = k.shape[2], v.shape[3]
    out = _empty_as(q, Dv)
    if out.stride(3) != 1:
        raise ValueError(f"{name}: the head dim must be dense in q")
    if q.dtype == torch.bfloat16:
        _check_aligned(name, q=q, k=k, v=v, o=out)
    if S and q.is_cuda:
        err = _build.load("flash_attention", "flash_attention_launch")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            int(q.dtype == torch.bfloat16), B, H, KV, S, Sk, q_start, D, Dv,
            int(causal), window, D ** -0.5, *_strides(q, k, v, out),
            _stream(q))
        _build.check(err, name)
    return out


def flash_attention(q, k, v, causal: bool = True, window=None,
                    q_start: int = 0):
    """Attention with an online fp32 softmax, over the keys of each
    query's `window` when one is given, q's rows at positions q_start..
    against k, v's Sk keys; returns (B, H, Sq, D_v) in q's dtype. CPU
    tensors take the plain version; CUDA tensors launch the kernel (fp32
    or bf16, D = D_v in HEAD_DIMS or (D, D_v) in HEAD_DIM_PAIRS) or
    raise."""
    w = _window("flash_attention", causal, window)
    _offset("flash_attention", q_start, q.shape[2], k.shape[2])
    on = op_analysis.where("flash_attention", q, k, v)

    def launch(q, k, v):
        out = _forward("flash_attention", q, k, v, causal, w, None, q_start)
        if q.is_cuda and q.shape[2]:
            flash_attention.launches += 1
        return out
    with op_analysis.kernel(
            ("flash_attention",) if q.shape[2] else (),
            (_cost(q, k, v, causal, w, q_start, 1, 1),
             _bytes(q, k, v) + _out_bytes(q, v)),
            launch, (q, k, v), on) as call:
        call.result = _laid_out(flash_attention_ref(
            q, k, v, causal, window, q_start), q) if on == "cpu" \
            else launch(q, k, v)
    return call.result


def flash_fwd_lse(q, k, v, causal: bool = True, window=None,
                  q_start: int = 0):
    """`flash_attention` plus each row's logsumexp: returns (o in q's
    dtype (B, H, Sq, D_v), lse dense fp32 (B, H, Sq)). CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    w = _window("flash_fwd_lse", causal, window)
    _offset("flash_fwd_lse", q_start, q.shape[2], k.shape[2])
    on = op_analysis.where("flash_fwd_lse", q, k, v)
    B, H, S = q.shape[:3]

    def launch(q, k, v):
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        out = _forward("flash_fwd_lse", q, k, v, causal, w, lse, q_start)
        if q.is_cuda and S:
            flash_fwd_lse.launches += 1
        return out, lse
    with op_analysis.kernel(
            ("flash_fwd_lse",) if S else (),
            (_cost(q, k, v, causal, w, q_start, 1, 1),
             _bytes(q, k, v) + _out_bytes(q, v) + 4 * B * H * S), launch,
            (q, k, v),
            on) as call:
        if on == "cpu":
            o, lse = flash_fwd_lse_ref(q, k, v, causal, window, q_start)
            call.result = _laid_out(o, q), lse.contiguous()
        else:
            call.result = launch(q, k, v)
    return call.result


def _bwd_dkv(q, k, v, do, lse, delta, causal, window=0, q_start=0):
    """dK and dV as dense fp32 partials (B, KV, chunks, Sk, D) and (..,
    D_v), chunk c summing its share of each group's query heads (the
    first of the backward's two kernels); the caller sums the chunks."""
    B, H, S, D = q.shape
    KV, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    bf16 = int(q.dtype == torch.bfloat16)
    chunks = _build.load("flash_attention_bwd", "flash_bwd_dkv_chunks")(
        bf16, B, H, KV, Sk, D, Dv) if q.is_cuda else dkv_chunks(
            bf16, B, H, KV, Sk, D, Dv)
    dk = torch.empty((B, KV, chunks, Sk, D), dtype=torch.float32,
                     device=q.device)
    dv = torch.empty((B, KV, chunks, Sk, Dv), dtype=torch.float32,
                     device=q.device)
    if not q.is_cuda:
        return dk, dv
    err = _build.load("flash_attention_bwd", "flash_bwd_dkv_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        bf16, B, H, KV, S, Sk, q_start, D, Dv, int(causal), window, chunks,
        D ** -0.5, *_strides(q, k, v, do), _stream(q))
    _build.check(err, "flash_bwd_dkv")
    _bwd_dkv.launches += 1
    return dk, dv


def _bwd_dq(q, k, v, do, lse, delta, causal, window=0, q_start=0):
    """dQ in q's dtype and strides (the second of the backward's two
    kernels)."""
    B, H, S, D = q.shape
    dq = torch.empty_like(q)
    if dq.stride(3) != 1:
        raise ValueError("flash_attention_bwd: the head dim must be dense "
                         "in q")
    if q.dtype == torch.bfloat16:
        _check_aligned("flash_attention_bwd", dq=dq)
    if not q.is_cuda:
        return dq
    err = _build.load("flash_attention_bwd", "flash_bwd_dq_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        int(q.dtype == torch.bfloat16), B, H, k.shape[1], S, k.shape[2],
        q_start, D, v.shape[3], int(causal), window, D ** -0.5,
        *_strides(q, k, v, do, dq), _stream(q))
    _build.check(err, "flash_bwd_dq")
    _bwd_dq.launches += 1
    return dq


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        window=None, q_start: int = 0):
    """The flash backward: (dq, dk, dv) in the dtypes of q, k and v, from
    the forward's o and lse and the output gradient do (B, H, Sq, D_v).
    delta = rowsum(do * o) in fp32 is a torch op, as JAX computes it
    outside its kernels; dK/dV are the first kernel's fp32 partials
    summed over the chunks in order (deterministic, no float atomics).
    CPU tensors take the plain version; CUDA tensors launch both kernels
    or raise."""
    w = _window("flash_attention_bwd", causal, window)
    _offset("flash_attention_bwd", q_start, q.shape[2], k.shape[2])
    on = op_analysis.where("flash_attention_bwd", q, k, v, o, lse, do)
    if on != "cpu":
        _check_bwd(q, k, v, o, lse, do, q_start)
    S = q.shape[2]

    def launch(q, k, v, o, lse, do):
        if S == 0:
            return (torch.zeros_like(q), torch.zeros_like(k),
                    torch.zeros_like(v))
        delta = (do.float() * o.float()).sum(dim=-1).contiguous()
        dk, dv = _bwd_dkv(q, k, v, do, lse, delta, causal, w, q_start)
        dq = _bwd_dq(q, k, v, do, lse, delta, causal, w, q_start)
        return dq, dk.sum(dim=2).to(k.dtype), dv.sum(dim=2).to(v.dtype)
    with op_analysis.kernel(
            ("flash_bwd_dkv", "flash_bwd_dq") if S else (),
            (_cost(q, k, v, causal, w, q_start, 3, 2),
             _bytes(q, k, v, o, lse, do) + _bytes(q, k, v)), launch,
            (q, k, v, o, lse, do), on) as call:
        if on == "cpu":
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, o, lse, do, causal,
                                                 window, q_start)
            call.result = (_laid_out(dq, q), dk.contiguous(),
                           dv.contiguous())
        else:
            call.result = launch(q, k, v, o, lse, do)
    return call.result


def _check_bwd(q, k, v, o, lse, do, q_start) -> None:
    """Validate the backward's interface for a kernel launch."""
    B, H, KV, S, D = _check("flash_attention_bwd", q, k, v, q_start)
    want = (B, H, S, v.shape[3])
    if o.shape != want or do.shape != want or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd: o and do must be (B, H, Sq, "
                         f"D_v) = {want} and do q's dtype, got "
                         f"{tuple(o.shape)}, {tuple(do.shape)} {do.dtype}")
    if do.stride(3) != 1:
        raise ValueError("flash_attention_bwd: the head dim must be dense "
                         "(stride 1) in do")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: want a dense fp32 lse of "
                         f"shape {(B, H, S)}, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    if q.dtype == torch.bfloat16:
        _check_aligned("flash_attention_bwd", q=q, k=k, v=v, do=do)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_start):
        o, lse = flash_fwd_lse(q, k, v, causal, window, q_start)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.q_start = causal, window, q_start
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(3) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, ctx.causal,
                                         ctx.window, ctx.q_start)
        return dq, dk, dv, None, None, None


def flash_attention_trainable(q, k, v, causal: bool = True, window=None,
                              q_start: int = 0):
    """Differentiable flash attention: `flash_fwd_lse` forward,
    `flash_attention_bwd` backward (both kernels on the card, both plain
    versions on the CPU). Returns o (B, H, Sq, D_v) in q's dtype."""
    _window("flash_attention_trainable", causal, window)
    _offset("flash_attention_trainable", q_start, q.shape[2], k.shape[2])
    return _FlashAttention.apply(q, k, v, causal, window, q_start)


flash_attention.launches = 0
flash_fwd_lse.launches = 0
_bwd_dkv.launches = 0
_bwd_dq.launches = 0

"""Serving launcher: continuous batched decode — the port of
`repro/launch/serve.py`.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_5_3b \
        --reduced --requests 8 --max-new 16 [--device cpu]

The weights are fp32 with --reduced and bf16 otherwise (DeepSeekMoE-16B's
are 65.5 GB in fp32, 32.75 GB in bf16). Every config of the registry
serves here: dense, MoE, SSM (mamba2_780m), hybrid (recurrentgemma_2b,
whose local attention keeps a ring of min(window, max_len) K/V slots),
MLA (deepseek_v2_236b, whose decode attends in the absorbed form over
the compressed {c_kv, k_rope} cache) and the frontends'
(llava_next_mistral_7b, musicgen_medium), on tokens: as JAX's server,
this one feeds no patch embeddings. DeepSeek-V2-236B does not fit one
card whole at any precision here (472 GB in bf16).

A request queue feeds fixed slots; each slot tracks its own cache
position; a slot's prompt runs token by token through the shared decode
step, then every active slot advances one token per tick (static shapes:
slots, not ragged batches). Greedy sampling.

The slot and position logic is JAX's, quirks included, so that the two
servers give the same tokens:
  * `admit` runs the prompt through the batched decode step with every
    other slot's token set to 0, and the step writes every slot's K/V at
    the admitted slot's position, so admitting a slot overwrites the
    first len(prompt) cache rows of the slots admitted before it, and
    steps every other slot's recurrent state (SSM, RG-LRU) with token 0
    once a prompt token (MLA's compressed rows are overwritten as K/V
    rows are);
  * `tick` decodes all slots at one position, the first active slot's.

On a mesh with a model axis (the context mesh when the server is made,
JAX's `Server` under `make_local_mesh`: (1, tp), every rank running the
same server) each rank holds its blocks of the weights (the
`attn_layout` JAX's launcher picks, unless given), the caches by
`cache_specs` (their T rows over 'model' when max_len >= 4,096), and the
decode step is tensor-parallel; every rank gets the whole logits, so
the greedy tokens agree.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, get_reduced
from repro_torch.distributed import mesh as pg
from repro_torch.distributed.context import batch_axes, get_mesh, \
    mesh_context
from repro_torch.launch.sharding import attn_layout
from repro_torch.launch.steps import make_decode_step
from repro_torch.models import lm
from repro_torch.serve.queue import BufferFull, SlotPool


class Server:
    """Slots of an LM on `device` (the card unless "cpu" is asked for),
    its weights drawn from `seed` in `dtype`, or `params`, an `lm.LM`
    module already on `device` (a rank's held blocks under a mesh),
    served as it is; `self.params` is the module (`params.
    load_state_dict` serves other weights). Under a mesh with a model
    axis: the module docstring."""

    def __init__(self, cfg, max_len=128, slots=4, dtype=torch.float32,
                 seed=0, device=None, params=None, layout=None):
        self.cfg = cfg
        self.max_len = max_len
        self.slots = slots
        self.mesh = get_mesh()
        if self.mesh.axis_size(batch_axes()) > 1:
            raise ValueError(f"the server's slots are one batch: it runs "
                             f"on a (1, tp) mesh, not {self.mesh.shape}")
        self.layout = attn_layout(cfg, self.mesh.shape["model"]) \
            if layout is None else layout
        self.device = pg.rank_device(device)
        with mesh_context(self.mesh):
            self.params = params if params is not None else \
                lm.init_params(cfg, seed, dtype, self.device,
                               mesh=self.mesh, layout=self.layout)
            self.cache = lm.init_cache(cfg, slots, max_len, dtype,
                                       self.device)
            self._decode = make_decode_step(cfg, self.layout, max_len)
        self.pos = np.zeros((slots,), np.int32)
        # decode slots come from the same SlotPool primitive the spike
        # server uses for session lanes; its mask is the `active` vector
        # the batched tick indexes
        self.pool = SlotPool(slots)
        self.tokens = np.zeros((slots,), np.int32)
        self.outputs = [[] for _ in range(slots)]

    @property
    def active(self) -> np.ndarray:
        return self.pool.mask

    def admit(self, prompt):
        """Claim a free decode slot and run the prompt token by token
        through the shared decode step. Returns the slot id; raises
        BufferFull if the pool is full."""
        if len(prompt) == 0:
            raise ValueError("admit needs a prompt of at least one token")
        slot = self.pool.acquire()
        if slot is None:
            raise BufferFull(self.slots, self.slots,
                             what="decode slot pool")
        self.outputs[slot] = []
        for t in prompt:
            with mesh_context(self.mesh):
                lg, self.cache = self._decode(
                    self.params, self._tok_batch(slot, t), self.cache,
                    int(self.pos[slot]))
            self.pos[slot] += 1
        self.tokens[slot] = int(lg[slot, :self.cfg.vocab_size].argmax())
        return slot

    def _tok_batch(self, slot, tok):
        b = torch.zeros((self.slots, 1), dtype=torch.long)
        b[slot, 0] = int(tok)
        return b.to(self.device)

    def tick(self):
        """One decode step for all active slots (continuous batching).
        Slots whose stream hits max_len are released back to the pool,
        ready for the next admit."""
        if not self.active.any():
            return
        pos = int(self.pos[self.active][0])
        batch = torch.as_tensor(self.tokens[:, None], dtype=torch.long,
                                device=self.device)
        with mesh_context(self.mesh):
            lg, self.cache = self._decode(self.params, batch, self.cache,
                                          pos)
        nxt = lg[:, :self.cfg.vocab_size].argmax(dim=1).cpu().numpy()
        for s in range(self.slots):
            if self.active[s]:
                self.outputs[s].append(int(nxt[s]))
                self.tokens[s] = nxt[s]
                self.pos[s] += 1
                if self.pos[s] >= self.max_len - 1:
                    self.pool.release(s)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    cfg = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    rng = np.random.default_rng(0)
    dtype = torch.float32 if args.reduced else torch.bfloat16
    srv = Server(cfg, max_len=args.prompt_len + args.max_new + 2,
                 slots=args.requests, dtype=dtype, device=args.device)
    t0 = time.time()
    for _ in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size, args.prompt_len).tolist()
        srv.admit(prompt)
    for _ in range(args.max_new):
        srv.tick()
    dt = time.time() - t0
    total = sum(len(o) for o in srv.outputs)
    print(f"served {args.requests} requests, {total} tokens "
          f"in {dt:.2f}s ({total / dt:.1f} tok/s) on {srv.device}")
    for s, out in enumerate(srv.outputs):
        print(f"  req{s}: {out[:10]}...")
    return total


if __name__ == "__main__":
    main()

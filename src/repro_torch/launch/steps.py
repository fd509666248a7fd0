"""Step functions: `make_train_step`, `make_prefill_step` and
`make_decode_step`, the port of `repro/launch/steps.py`. PyTorch runs
eagerly, so there is nothing to jit."""
from __future__ import annotations

import torch

from repro_torch.device import resolve
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.adamw import named_leaves


def make_train_step(cfg, oc: AdamWConfig, microbatches: int = 1,
                    compressor=None, device=None):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm", "lr"}): `lm.loss_fn` and its gradients, then
    one AdamW update, in place on `params` (the `lm.LM` module) and
    `opt_state` (from `adamw_init`). The batch's arrays (numpy or
    tensors) go to `device`, the card unless "cpu" is asked for. With
    `microbatches` > 1 the batch is split along its rows, each part's
    gradients summed in fp32 and divided by the count, as JAX's
    `lax.scan` does; the loss is the parts' mean. Gradient compression
    (`compressor`) comes with the distribution slice."""
    if compressor is not None:
        raise NotImplementedError(
            "gradient compression is not ported yet; it comes with the "
            "distribution slice (ROADMAP item 10)")
    dev = resolve(device)

    def grads_of(params, batch):
        leaves = named_leaves(params)
        loss, _ = lm.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        if microbatches > 1:
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            acc = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in named_leaves(params).items()}
            for i in range(microbatches):
                mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                   + v.shape[1:])[i]
                      for k, v in batch.items()}
                l, g = grads_of(params, mb)
                for n, t in g.items():
                    acc[n] += t
                loss = loss + l
                del g
            grads = {n: t / microbatches for n, t in acc.items()}
            loss = loss / microbatches
        else:
            loss, grads = grads_of(params, batch)
        params, opt_state, om = adamw_update(params, grads, opt_state, oc)
        return params, opt_state, {"loss": loss, **om}

    return train_step


def make_prefill_step(cfg):
    def prefill_step(params, batch):
        return lm.prefill(params, cfg, batch)
    return prefill_step


def make_decode_step(cfg):
    def decode_step(params, token, cache, cache_pos):
        return lm.decode_step(params, cfg, token, cache, cache_pos)
    return decode_step

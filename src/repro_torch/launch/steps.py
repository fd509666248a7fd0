"""Step functions for serving: `make_prefill_step` / `make_decode_step`,
the port of `repro/launch/steps.py` (PyTorch runs eagerly, so there is
nothing to jit; the train step comes with the training slice)."""
from __future__ import annotations

from repro_torch.models import lm


def make_prefill_step(cfg):
    def prefill_step(params, batch):
        return lm.prefill(params, cfg, batch)
    return prefill_step


def make_decode_step(cfg):
    def decode_step(params, token, cache, cache_pos):
        return lm.decode_step(params, cfg, token, cache, cache_pos)
    return decode_step

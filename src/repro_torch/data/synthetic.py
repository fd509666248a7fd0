"""The synthetic token stream of the LM training loop — a copy of
`TokenPipeline` from `repro/data/synthetic.py` (numpy only, so the port
imports nothing of `repro`). Its batches equal JAX's, bit for bit, for
the same seed and step."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TokenPipeline:
    """Deterministic synthetic token stream for LM training, resumable
    from a step cursor: batch `step` depends only on (seed, step)."""
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    step: int = 0

    def next_batch(self):
        rng = np.random.default_rng((self.seed, self.step))
        # Markov-ish structure so the loss is learnable, not pure noise
        base = rng.integers(1, self.vocab_size,
                            (self.global_batch, self.seq_len), dtype=np.int32)
        repeat = rng.random((self.global_batch, self.seq_len)) < 0.5
        toks = base.copy()
        toks[:, 1:] = np.where(repeat[:, 1:], toks[:, :-1], base[:, 1:])
        self.step += 1
        return {"tokens": toks}

    def state_dict(self):
        return {"seed": self.seed, "step": self.step}

    def load_state_dict(self, d):
        self.seed, self.step = int(d["seed"]), int(d["step"])

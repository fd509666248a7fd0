"""Synthetic datasets and the LM token stream — copies of
`repro/data/synthetic.py` (numpy only, so the port imports nothing of
`repro`). Every array equals JAX's, bit for bit, for the same seed.

MNIST / DVS-Gesture are not available offline: `digits()` generates
class-conditional binary images with stroke-like structure and
controlled pixel-flip noise (MNIST's shapes and ~20 % active pixels),
and `event_frames()` does the same for 2-channel DVS-style inputs, so
the Table 2 pipeline (QAT, int16 quantization, A.2 conversion,
event-driven inference) runs end to end. `TokenPipeline` is the LM
training loop's stream: batch `step` depends only on (seed, step)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _class_templates(n_classes, shape, seed):
    H, W = shape
    templates = np.zeros((n_classes, H, W), bool)
    for c in range(n_classes):
        r = np.random.default_rng(seed * 1000 + c)
        img = np.zeros((H, W), bool)
        # stroke-like structure: random walks biased per class
        for _ in range(3 + c % 3):
            y, x = r.integers(2, H - 2), r.integers(2, W - 2)
            dy, dx = r.choice([-1, 0, 1]), r.choice([-1, 0, 1])
            for _ in range(H + W):
                img[max(0, min(H - 1, y)), max(0, min(W - 1, x))] = True
                if r.random() < 0.3:
                    dy, dx = r.choice([-1, 0, 1]), r.choice([-1, 0, 1])
                y += dy + (c % 2)
                x += dx
                y %= H
                x %= W
        templates[c] = img
    return templates


def digits(n, shape=(28, 28), n_classes=10, noise=0.03, seed=0):
    """Binary 'digit' images: (n, H, W) bool + labels (n,)."""
    rng = np.random.default_rng(seed)
    templates = _class_templates(n_classes, shape, seed=17)
    labels = rng.integers(0, n_classes, n)
    imgs = templates[labels].copy()
    flips = rng.random(imgs.shape) < noise
    imgs ^= flips
    return imgs, labels


def event_frames(n, shape=(63, 63), n_classes=11, frames=10, noise=0.02,
                 seed=0):
    """DVS-gesture-like: (n, frames, 2, H, W) bool ON/OFF events + labels."""
    rng = np.random.default_rng(seed)
    templates = _class_templates(n_classes, shape, seed=29)
    labels = rng.integers(0, n_classes, n)
    out = np.zeros((n, frames, 2, *shape), bool)
    for i, c in enumerate(labels):
        base = templates[c]
        for f in range(frames):
            shift = (f * (1 + c % 3)) % shape[1]
            moved = np.roll(base, shift, axis=1)
            prev = np.roll(base, shift - 1, axis=1)
            out[i, f, 0] = moved & ~prev          # ON events
            out[i, f, 1] = prev & ~moved          # OFF events
    flips = rng.random(out.shape) < noise
    out ^= flips
    return out, labels


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

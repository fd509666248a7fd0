"""Reinforcement-learning pipeline — the DVS Pong row of Table 2 (§6,
fourth experiment family; the twin of `repro.core.rl`).

The paper trains a DQN on Atari Pong with a DVS-style input representation
(frame differencing into ON/OFF event channels), converts it to an SNN and
deploys it on the hardware, reporting the mean score over 50 episodes.
Atari is not available offline, so the environment is a DVS-style *catch*
game with the same observation construction (2-channel ON/OFF pixel-change
events between consecutive frames) and the same pipeline:

  DQN (replay buffer, target network, ε-greedy)  →  int16 quantization
  →  A.2 conversion  →  event-driven engine  →  greedy policy from output
  membrane potentials  →  mean episode score, engine vs software (exact).

The Q-network uses binary activations (QAT) so the conversion is bit-exact
single-step. The environment, the replay buffer and every exploration
draw are numpy (JAX's draws, in JAX's order); only the Q network and its
update are torch, on the card unless `device="cpu"` is given.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.convert import (LayerSpec, QATModel, adam_init,
                                      adam_step, apply_quantized,
                                      infer_image, value_and_grad)
from repro_torch.device import resolve


@dataclass
class CatchEnv:
    """Ball falls; paddle catches. Observation: 2-channel ON/OFF event
    frame (pixel-change between consecutive raw frames, threshold-style —
    the paper's DVS construction)."""
    W: int = 9
    H: int = 9

    def reset(self, rng):
        self.ball_x = int(rng.integers(0, self.W))
        self.ball_y = 0
        self.pad_x = self.W // 2
        self.t = 0
        self.prev = self._raw()
        return self._obs()

    def _raw(self):
        # the paddle pixel blinks every frame (DVS sensors see flicker), so
        # a stationary paddle still emits events — without this, pure
        # frame-difference observations make the task unobservable
        f = np.zeros((self.H, self.W), bool)
        f[self.ball_y, self.ball_x] = True
        if self.t % 2 == 0:
            f[self.H - 1, self.pad_x] = True
        return f

    def _obs(self):
        cur = self._raw()
        on = cur & ~self.prev
        off = self.prev & ~cur
        self.prev = cur
        return np.stack([on, off]).astype(np.float32)   # (2, H, W)

    def step(self, action: int):
        self.pad_x = int(np.clip(self.pad_x + (action - 1), 0, self.W - 1))
        self.ball_y += 1
        self.t += 1
        done = self.ball_y >= self.H - 1
        reward = 0.0
        if done:
            reward = 1.0 if self.pad_x == self.ball_x else -1.0
        return self._obs(), reward, done

    @property
    def n_actions(self):
        return 3


def make_qnet(env: CatchEnv) -> QATModel:
    return QATModel(input_shape=(2, env.H, env.W),
                    layers=[LayerSpec("dense", out_features=64)],
                    n_classes=env.n_actions)


def train_dqn(env: CatchEnv, *, episodes=400, gamma=0.9, lr=1e-3,
              batch=64, buffer_cap=5000, target_sync=100, seed=0,
              verbose=False, device=None):
    """Standard DQN (the paper's §6 protocol, scaled down), the Q network
    on `device` (the card when None); initial weights from
    `torch.Generator().manual_seed(seed)`. Returns (model, params)."""
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    model = make_qnet(env)
    params = [{k: a.detach().clone().requires_grad_() for k, a in p.items()}
              for p in model.init(torch.Generator().manual_seed(seed),
                                  device=dev)]
    target = [{k: a.detach() for k, a in p.items()} for p in params]
    m, v = adam_init(params)

    def q_loss(p, tp, s, a, r, s2, done):
        q = model.apply(p, s)
        qa = q.gather(1, a[:, None])[:, 0]
        with torch.no_grad():
            q2 = torch.max(model.apply(tp, s2), dim=1).values
            tgt = r + gamma * q2 * (1.0 - done)
        return torch.mean((qa - tgt) ** 2)

    def upload(x, dtype):
        return torch.as_tensor(np.asarray(x), device=dev).to(dtype)

    buf = []
    t = 0
    for ep in range(episodes):
        s = env.reset(rng)
        done = False
        eps = max(0.05, 1.0 - ep / (episodes * 0.6))
        while not done:
            if rng.random() < eps:
                a = int(rng.integers(0, env.n_actions))
            else:
                with torch.no_grad():
                    q = model.apply(params, upload(s[None], torch.float32))
                a = int(np.argmax(q[0].cpu().numpy()))
            s2, r, done = env.step(a)
            buf.append((s, a, r, s2, float(done)))
            if len(buf) > buffer_cap:
                buf.pop(0)
            s = s2
            if len(buf) >= batch:
                idx = rng.integers(0, len(buf), batch)
                bs, ba, br, bs2, bd = map(np.stack,
                                          zip(*[buf[i] for i in idx]))
                t += 1
                _, grads = value_and_grad(
                    q_loss, params, target, upload(bs, torch.float32),
                    upload(ba, torch.int64), upload(br, torch.float32),
                    upload(bs2, torch.float32), upload(bd, torch.float32))
                params, m, v = adam_step(params, grads, m, v, t, lr)
                if t % target_sync == 0:
                    target = [{k: a_.detach().clone() for k, a_ in p.items()}
                              for p in params]
        if verbose and ep % 100 == 0:
            print(f"ep {ep}: eps={eps:.2f} buffer={len(buf)}")
    return model, [{k: a.detach() for k, a in p.items()} for p in params]


def evaluate(env, policy, episodes=50, seed=100):
    rng = np.random.default_rng(seed)
    total = 0.0
    for _ in range(episodes):
        s = env.reset(rng)
        done = False
        while not done:
            a = policy(s)
            s, r, done = env.step(a)
        total += r
    return total / episodes


def software_policy(model, qparams):
    def policy(s):
        q = apply_quantized(model, qparams, s[None].astype(np.int64))[0]
        return int(np.argmax(q))
    return policy


def engine_policy(net, out_keys, model):
    def policy(s):
        pred, _ = infer_image(net, s, model, out_keys)
        return pred
    return policy

"""The port's DVS-Pong-style RL pipeline (`repro_torch.core.rl`, Table 2
row 4's protocol) against the JAX package's: `CatchEnv` episodes bit for
bit; `train_dqn`'s updates within 1e-5 abs + 1e-5 rel from carried
weights (the same numpy draws in the same order); the converted policy
on the port's CPU engine scoring exactly what the quantized software
policy and JAX's engine policy score; a torch-trained policy beating a
uniform random one."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.convert as jc
import repro.core.rl as jrl
import repro_torch.core.convert as tc
import repro_torch.core.rl as trl

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def trained():
    """A DQN trained as tests/test_rl.py trains JAX's (400 episodes,
    seed 3), on one thread: the Q network is 70 -> 64 -> 3, far below
    what torch's intra-op threads pay for."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model, params = trl.train_dqn(trl.CatchEnv(W=5, H=7), episodes=400,
                                      seed=3, device="cpu")
    finally:
        torch.set_num_threads(threads)
    return model, tc.quantize(params)[0]


@pytest.mark.parametrize("W,H,seed", [(5, 7, 0), (9, 9, 4)])
def test_catch_episodes_equal_jax(W, H, seed):
    envs = trl.CatchEnv(W=W, H=H), jrl.CatchEnv(W=W, H=H)
    rngs = np.random.default_rng(seed), np.random.default_rng(seed)
    acts = np.random.default_rng(seed + 1).integers(0, 3, 200)
    obs = [e.reset(r) for e, r in zip(envs, rngs)]
    for a in acts:
        np.testing.assert_array_equal(obs[0], obs[1])
        assert obs[0].dtype == obs[1].dtype == np.float32
        out = [e.step(int(a)) for e in envs]
        assert out[0][1:] == out[1][1:]                  # reward, done
        obs = [o[0] for o in out]
        if out[0][2]:
            obs = [e.reset(r) for e, r in zip(envs, rngs)]


def test_dvs_observation_construction():
    """ON = newly-set pixels, OFF = newly-cleared — the paper's frame
    differencing."""
    env = trl.CatchEnv()
    env.reset(np.random.default_rng(0))
    on, off = env.step(1)[0]            # stay
    assert on.sum() >= 1 and off.sum() >= 1
    assert env.step(1)[0].shape == (2, env.H, env.W)


@pytest.mark.parametrize("batch,sync", [(6, 100), (4, 2)],
                         ids=["one-update", "three-updates-target-sync"])
def test_dqn_updates_match_jax(monkeypatch, batch, sync):
    """One episode of 6 transitions at eps = 1 (exploration draws only,
    so both packages take the same actions): batch 6 makes one update,
    batch 4 three, with the target network synced after the second."""
    env = trl.CatchEnv(W=5, H=7)
    tm = trl.make_qnet(env)
    jm = jrl.make_qnet(jrl.CatchEnv(W=5, H=7))
    params = [{k: a.numpy() for k, a in p.items()}
              for p in tm.init(torch.Generator().manual_seed(7),
                               device="cpu")]
    rng = np.random.default_rng(7)
    for p in params:                     # nonzero biases
        p["b"] = rng.normal(0, 0.3, p["b"].shape).astype(np.float32)
    jm.init = lambda key: [{k: jnp.asarray(a) for k, a in p.items()}
                           for p in params]
    tm.init = lambda gen, device=None: tc.params_from_jax(params, device)
    monkeypatch.setattr(jrl, "make_qnet", lambda e: jm)
    monkeypatch.setattr(trl, "make_qnet", lambda e: tm)
    kw = dict(episodes=1, batch=batch, target_sync=sync, lr=1e-2, seed=5)
    _, want = jrl.train_dqn(jrl.CatchEnv(W=5, H=7), **kw)
    _, got = trl.train_dqn(env, device="cpu", **kw)
    for g, w, p in zip(got, want, params):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), **TOL)
            assert not np.array_equal(g[k].numpy(), p[k])


def test_engine_score_equals_software_and_jax(trained):
    model, qp = trained
    sw = trl.evaluate(trl.CatchEnv(W=5, H=7),
                      trl.software_policy(model, qp), episodes=50)
    net, keys = tc.to_network(model, qp, backend="engine", device="cpu")
    hw = trl.evaluate(trl.CatchEnv(W=5, H=7),
                      trl.engine_policy(net, keys, model), episodes=50)
    assert hw == sw                      # exact policy parity on hardware
    c = net.counter.as_dict()
    assert c["energy_uJ"] > 0 and c["latency_us"] > 0
    jm = jrl.make_qnet(jrl.CatchEnv(W=5, H=7))
    jnet, jkeys = jc.to_network(jm, qp, backend="engine")
    assert jrl.evaluate(jrl.CatchEnv(W=5, H=7),
                        jrl.engine_policy(jnet, jkeys, jm),
                        episodes=50) == hw
    assert jnet.counter.as_dict() == c


def test_policy_beats_uniform_random(trained):
    model, qp = trained
    sw = trl.evaluate(trl.CatchEnv(W=5, H=7),
                      trl.software_policy(model, qp), episodes=100, seed=5)
    rng = np.random.default_rng(1)
    rand = trl.evaluate(trl.CatchEnv(W=5, H=7),
                        lambda s: int(rng.integers(0, 3)), episodes=100,
                        seed=5)
    assert sw >= rand                    # trained >= random (often >>)

"""The port's slot server (`repro_torch.launch.serve.Server`) against the
JAX package's on the CPU, on the same weights: identical greedy tokens,
positions and slot states, and K/V caches within 1e-4 (fp32, reductions
summed in another order). That pins JAX's slot logic, quirks included:
`admit` runs a prompt through the batched decode step, which writes every
slot's K/V at the admitted slot's position, so admitting slot 1
overwrites the first len(prompt) cache rows of slot 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pair import lm_pair
from repro.configs import get_reduced as jget_reduced
from repro.distributed.context import mesh_context
from repro.launch import serve as jserve
from repro.launch.mesh import make_local_mesh
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import lm as tlm
from repro_torch.serve.queue import BufferFull

TOL = 1e-4


def servers(arch, max_len, slots, seed=0):
    """A JAX server and a port server on the JAX server's weights."""
    import jax
    from repro_torch.configs import get_reduced
    from repro_torch.models.weights import params_from_jax
    jcfg = jget_reduced(arch)
    with mesh_context(make_local_mesh()):
        js = jserve.Server(jcfg, max_len=max_len, slots=slots, seed=seed)
    tcfg = get_reduced(arch)
    ts = tserve.Server(tcfg, max_len=max_len, slots=slots, device="cpu")
    ts.params.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, js.params), tcfg))
    return js, ts


def cache_of(srv, n="k"):
    c = srv.cache["blocks"][n]
    return c.numpy() if torch.is_tensor(c) else np.asarray(c)


def same_state(js, ts):
    assert ts.outputs == js.outputs
    assert np.array_equal(ts.tokens, js.tokens)
    assert np.array_equal(ts.pos, js.pos)
    assert np.array_equal(ts.active, js.active)
    for n in ("k", "v"):
        assert np.max(np.abs(cache_of(ts, n) - cache_of(js, n))) < TOL


def test_three_requests_give_jax_greedy_tokens():
    prompt_len, max_new, n = 8, 6, 3
    js, ts = servers("qwen2_5_3b", prompt_len + max_new + 2, n)
    rng = np.random.default_rng(0)
    with mesh_context(make_local_mesh()):
        for _ in range(n):
            prompt = rng.integers(1, 256, prompt_len).tolist()
            assert ts.admit(prompt) == js.admit(prompt)
            same_state(js, ts)
        for _ in range(max_new):
            js.tick()
            ts.tick()
            same_state(js, ts)
    assert all(len(o) == max_new for o in ts.outputs)


def test_admit_overwrites_earlier_slots_cache_as_jax_does():
    js, ts = servers("qwen2_5_3b", 16, 2, seed=1)
    with mesh_context(make_local_mesh()):
        for srv in (js, ts):
            srv.admit([5, 6, 7])
        before = cache_of(ts)[:, 0, :3].copy()
        for srv in (js, ts):
            srv.admit([9, 10, 11])
    after = cache_of(ts)[:, 0, :3]
    assert np.max(np.abs(after - before)) > 1e-3      # slot 0 was overwritten
    same_state(js, ts)


def test_slots_release_at_max_len_and_a_full_pool_raises():
    js, ts = servers("gemma_7b", 6, 1, seed=2)
    with mesh_context(make_local_mesh()):
        for srv in (js, ts):
            srv.admit([1, 2, 3])
        with pytest.raises(BufferFull, match="decode slot pool"):
            ts.admit([4])
        for _ in range(3):
            js.tick()
            ts.tick()
        same_state(js, ts)
        assert not ts.active.any()
        ts.tick()                           # nothing active: a no-op
        for srv in (js, ts):
            srv.admit([7, 8])
        same_state(js, ts)


def test_step_factories_are_the_lm_entry_points():
    _, tcfg, _, model = lm_pair("qwen2_7b")
    tok = torch.tensor([[1, 2, 3, 4]])
    lp, cp = make_prefill_step(tcfg)(model, {"tokens": tok})
    lw, cw = tlm.prefill(model, tcfg, {"tokens": tok})
    assert torch.equal(lp, lw) and torch.equal(cp["blocks"]["k"],
                                               cw["blocks"]["k"])
    cache = tlm.init_cache(tcfg, 1, 4, torch.float32, device="cpu")
    ld, _ = make_decode_step(tcfg)(model, tok[:, :1], cache, 0)
    lw, _ = tlm.decode_step(model, tcfg, tok[:, :1],
                            tlm.init_cache(tcfg, 1, 4, torch.float32,
                                           device="cpu"), 0)
    assert torch.equal(ld, lw)


def test_cli_serves_on_the_cpu(capsys):
    total = tserve.main(["--arch", "qwen2_5_3b", "--reduced", "--requests",
                         "2", "--max-new", "3", "--prompt-len", "4",
                         "--device", "cpu"])
    assert total == 6
    assert "served 2 requests, 6 tokens" in capsys.readouterr().out

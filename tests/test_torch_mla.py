"""The port's multi-head latent attention (DeepSeek-V2's MLA:
`repro_torch.models.attention.MLA`, `mla_apply`, the "mla" blocks of
`models.lm`, `weights`, the launchers) against the JAX package's, on the
CPU, on reduced deepseek_v2_236b (3 layers: 1 dense + 2 MoE, 4 heads,
kv_lora 32, q_lora 48, 16 + 8 / 16 head dims, 8 experts top-2, 1
shared; capacity factor 8, so nothing drops). Both packages compute in
fp32 on the same weights (JAX's, moved over with `params_from_jax`);
JAX runs under `mesh_context(make_local_mesh())`. The naive form runs
the flash kernels' plain versions at head dim 24 (the published 192 on
the card: `chip_smoke.py` phase 24), V padded from 16.

Tolerances, as in `test_torch_moe.py`: 1e-5 absolute on single
functions (`mla_apply`'s output of magnitude ~1), on the loss and on one
AdamW step's moments; 1e-4 on logits (magnitude ~4), caches and
gradients."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pair import lm_pair
from repro.configs import get_reduced as jget_reduced
from repro.distributed.context import mesh_context
from repro.launch import serve as jserve
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import attention as jattn
from repro.models import lm as jlm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch.configs import get_reduced
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import make_train_step
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models.weights import opt_state_from_jax, params_from_jax
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import named_leaves

ARCH = "deepseek_v2_236b"
FN_TOL = 1e-5
TOL = 1e-4
CACHE = ("c_kv", "k_rope")


def err(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) if got.size else 0.0


@pytest.fixture(scope="module")
def pair():
    """(JAX config, port config, JAX tree as numpy, the port's model on
    it); tests that update the model in place build their own."""
    return lm_pair(ARCH, seed=13)


def layer(tree, model, seg="blocks", i=1):
    """One layer's MLA weights: JAX's dict (jnp) and the port's module."""
    jp = jax.tree.map(lambda a: jnp.asarray(a[i]), tree[seg]["attn"])
    return jp, getattr(model, seg)[i].attn


def x_of(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


# ------------------------------------------------------------------ mla_apply
@pytest.mark.parametrize("S,with_cache", [(1, False), (37, False),
                                          (64, True)])
def test_naive_form_matches_jax(pair, S, with_cache):
    """Training and prefill: the decompressed form over a sequence (the
    flash kernels' plain versions at head dim nope + rope, V padded); with
    a cache, the prefill's compressed {c_kv, k_rope}."""
    jcfg, tcfg, tree, model = pair
    jp, tp = layer(tree, model)
    x = x_of((2, S, tcfg.d_model), S)
    pos = np.arange(S)
    jcache = jattn.mla_cache_shape(jcfg, 2, S, jnp.float32) \
        if with_cache else None
    with mesh_context(make_local_mesh()):
        jy, jc = jax.jit(lambda p, x, pos: jattn.mla_apply(
            p, x, jcfg, pos, cache=jcache))(jp, jnp.asarray(x),
                                            jnp.asarray(pos))
    ty, tc = tattn.mla_apply(tp, torch.from_numpy(x), tcfg,
                             torch.from_numpy(pos))
    assert err(ty, jy) <= FN_TOL
    if with_cache:
        for n in CACHE:
            assert err(tc[n], jc[n]) <= FN_TOL, n


@pytest.mark.parametrize("cache_pos", [0, 5, 9, 12])
def test_absorbed_decode_matches_jax(pair, cache_pos):
    """Decode: the absorbed form over a compressed cache (random rows),
    the new row written at cache_pos; past the cache (T = 10) JAX's
    dynamic_update_slice clamps the write to the last row and the mask
    reads every row, and so does the port."""
    jcfg, tcfg, tree, model = pair
    jp, tp = layer(tree, model, "dense_blocks", 0)
    m = tcfg.mla
    B, T = 2, 10
    x = x_of((B, 1, tcfg.d_model), cache_pos)
    cache = {"c_kv": x_of((B, T, m.kv_lora_rank), 50 + cache_pos),
             "k_rope": x_of((B, T, m.qk_rope_head_dim), 60 + cache_pos)}
    pos = np.array([cache_pos])
    with mesh_context(make_local_mesh()):
        jy, jc = jax.jit(lambda p, x, pos, c, i: jattn.mla_apply(
            p, x, jcfg, pos, cache=c, cache_pos=i))(
            jp, jnp.asarray(x), jnp.asarray(pos),
            {n: jnp.asarray(v) for n, v in cache.items()},
            jnp.int32(cache_pos))
    tc = {n: torch.from_numpy(v.copy()) for n, v in cache.items()}
    with torch.no_grad():               # as decode_step runs it
        ty, tc2 = tattn.mla_apply(tp, torch.from_numpy(x), tcfg,
                                  torch.from_numpy(pos), cache=tc,
                                  cache_pos=cache_pos)
    assert tc2 is tc                         # written in place
    assert err(ty, jy) <= FN_TOL
    for n in CACHE:
        assert err(tc[n], jc[n]) <= FN_TOL, n
    slot = min(cache_pos, T - 1)
    others = [t for t in range(T) if t != slot]
    assert np.array_equal(tc["c_kv"].numpy()[:, others],
                          cache["c_kv"][:, others])


def test_cache_shape_matches_jax(pair):
    jcfg, tcfg, _, _ = pair
    want = jattn.mla_cache_shape(jcfg, 3, 7)
    got = tattn.mla_cache_shape(tcfg, 3, 7, device="cpu")
    assert {n: tuple(t.shape) for n, t in got.items()} \
        == {n: a.shape for n, a in want.items()}
    assert all(t.dtype == torch.bfloat16 and not t.any()
               for t in got.values())


# ------------------------------------------------------------------ the model
def jax_prefill(tree, cfg, tokens):
    with mesh_context(make_local_mesh()):
        return jax.jit(lambda p, t: jlm.prefill(p, cfg, {"tokens": t}))(
            tree, jnp.asarray(tokens))


@pytest.mark.parametrize("B,S", [(2, 37), (1, 130)])
def test_prefill_matches_jax(pair, B, S):
    """Last-token logits and both segments' compressed caches."""
    jcfg, tcfg, tree, model = pair
    tokens = np.random.default_rng(S).integers(0, jcfg.vocab_size, (B, S))
    lj, cj = jax_prefill(tree, jcfg, tokens)
    lt, ct = tlm.prefill(model, tcfg, {"tokens": torch.from_numpy(tokens)})
    assert lt.dtype == torch.float32 and err(lt, lj) <= TOL
    m = tcfg.mla
    for seg, L in tlm.segment_layers(tcfg).items():
        assert ct[seg]["c_kv"].shape == (L, B, S, m.kv_lora_rank)
        assert ct[seg]["k_rope"].shape == (L, B, S, m.qk_rope_head_dim)
        for n in CACHE:
            assert err(ct[seg][n], cj[seg][n]) <= TOL, (seg, n)


def test_decode_steps_match_jax(pair):
    """Five decode steps of 2 rows from `init_cache`, feeding JAX's greedy
    tokens to both packages."""
    jcfg, tcfg, tree, model = pair
    B, T = 2, 8
    jc = jlm.init_cache(jcfg, B, T, jnp.float32)
    tc = tlm.init_cache(tcfg, B, T, torch.float32, device="cpu")
    tok = np.array([[3], [11]])
    with mesh_context(make_local_mesh()):
        step = jax.jit(lambda p, t, c, i: jlm.decode_step(p, jcfg, t, c, i))
        for pos in range(5):
            lj, jc = step(tree, jnp.asarray(tok), jc, jnp.int32(pos))
            lt, tc = tlm.decode_step(model, tcfg, torch.from_numpy(tok),
                                     tc, pos)
            assert err(lt, lj) <= TOL
            for seg in ("dense_blocks", "blocks"):
                for n in CACHE:
                    assert err(tc[seg][n], jc[seg][n]) <= TOL, (pos, seg, n)
            tok = np.asarray(lj)[:, :jcfg.vocab_size].argmax(1)[:, None]


def test_absorbed_decode_matches_naive_teacher_forcing(pair):
    """Tokens fed one by one through decode_step (the absorbed form over
    the compressed cache) give the naive prefill's last logits and its
    caches: the two forms compute one function."""
    _, tcfg, _, model = pair
    B, S = 2, 16
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (B, S)))
    full, fc = tlm.prefill(model, tcfg, {"tokens": toks})
    cache = tlm.init_cache(tcfg, B, S, torch.float32, device="cpu")
    for t in range(S):
        lg, cache = tlm.decode_step(model, tcfg, toks[:, t:t + 1], cache, t)
    assert err(lg, full.numpy()) <= TOL
    for seg in fc:
        for n in CACHE:
            assert err(cache[seg][n], fc[seg][n].numpy()) <= TOL, (seg, n)


def test_loss_and_grads_match_jax(pair):
    """Loss and ce of jax.value_and_grad(lm.loss_fn), and every gradient
    leaf (MLA's norms and projections in both segments), with the port's
    remat off, "full" and "dots"."""
    jcfg, tcfg, tree, model = pair
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 40))
    lmask = (rng.random((2, 40)) < 0.8).astype(np.float32)
    batch = {"tokens": tokens, "loss_mask": lmask}
    with mesh_context(make_local_mesh()):
        (jv, jparts), jg = jax.jit(jax.value_and_grad(
            lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))(
            jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    want = params_from_jax(jax.tree.map(np.asarray, jg), tcfg)
    leaves = named_leaves(model)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert {"dense_blocks.0.attn.q_norm.scale", "blocks.1.attn.kv_norm.scale",
            "blocks.0.attn.w_uk", "dense_blocks.0.attn.w_dkv"} <= set(want)
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        cfg = dataclasses.replace(tcfg, remat=remat, remat_policy=policy)
        loss, parts = tlm.loss_fn(model, cfg, tbatch)
        assert err(loss, jv) <= FN_TOL and err(parts["ce"], jparts["ce"]) \
            <= FN_TOL
        g = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
        assert set(g) == set(want)
        for n in want:
            assert err(g[n], want[n]) <= TOL, (remat, policy, n)


ILL = 1e-6     # sqrt(nu_hat) under 100 * eps: Adam's step is ill-conditioned


def test_train_step_matches_jax():
    """One step of the port's make_train_step against JAX's jitted step
    from the same parameters and AdamW state (lr 1e-2): loss, grad norm
    and lr within 1e-5, mu and nu within 1e-5, parameters within 1e-5
    where the step is well-conditioned and within 2 lr elsewhere
    (test_torch_train.py says why)."""
    jcfg, tcfg, tree, model = lm_pair(ARCH, seed=6)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    joc, toc = JAdamWConfig(**kw), AdamWConfig(**kw)
    batch = {"tokens": np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (4, 32)).astype(np.int32)}
    with mesh_context(make_local_mesh()):
        jp = jax.tree.map(jnp.asarray, tree)
        jopt = jadamw_init(jp, joc)
        topt = opt_state_from_jax(jax.tree.map(np.asarray, jopt), tcfg)
        jp, jopt, jm = jax.jit(jmake_train_step(jcfg, joc))(
            jp, jopt, jax.tree.map(jnp.asarray, batch))
    model, topt, tm = make_train_step(tcfg, toc, device="cpu")(model, topt,
                                                               batch)
    for k in ("loss", "grad_norm", "lr"):
        assert err(tm[k], jm[k]) <= FN_TOL, k
    assert int(topt["step"]) == int(jopt["step"]) == 1
    for name in ("mu", "nu"):
        want = params_from_jax(jax.tree.map(np.asarray, jopt[name]), tcfg)
        for n in want:
            assert err(topt[name][n], want[n]) <= FN_TOL, (name, n)
    nu = params_from_jax(jax.tree.map(np.asarray, jopt["nu"]), tcfg)
    state = model.state_dict()
    want = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    n_ill = n_all = 0
    for n in want:
        well = (nu[n] == 0) | (torch.sqrt(nu[n] / (1 - joc.b2)) >= ILL)
        gap = (state[n] - want[n]).abs()
        assert float(torch.where(well, gap, 0.0).max()) <= FN_TOL, n
        assert float(gap.max()) <= 2 * joc.lr, n
        n_ill += int((~well).sum())
        n_all += gap.numel()
    assert n_ill < 1e-2 * n_all, (n_ill, n_all)


# ------------------------------------------------------------------ weights
def test_params_from_jax_round_trips_every_leaf(pair):
    _, tcfg, tree, model = pair
    state = model.state_dict()
    layers = tlm.segment_layers(tcfg)
    seen = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [k.key for k in path]
        if keys[0] in layers:
            names = [".".join([keys[0], str(i)] + keys[1:])
                     for i in range(layers[keys[0]])]
            back = np.stack([state[n].numpy() for n in names])
        else:
            names = [".".join(keys)]
            back = state[names[0]].numpy()
        seen.update(names)
        assert back.dtype == leaf.dtype and np.array_equal(back, leaf), keys
    assert seen == set(state), set(state) ^ seen
    assert {f"{seg}.0.attn.{n}" for seg in layers
            for n in ("w_dq", "w_uq", "w_dkv", "w_uk", "w_uv", "w_o",
                      "q_norm.scale", "kv_norm.scale")} <= seen


def test_params_from_jax_keeps_bf16():
    jcfg, tcfg = jget_reduced(ARCH), get_reduced(ARCH)
    tree = jax.tree.map(np.asarray, jlm.init_params(
        jcfg, jax.random.PRNGKey(3), jnp.bfloat16))
    state = params_from_jax(tree, tcfg)
    t = state["blocks.1.attn.w_uq"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.float().numpy(), tree["blocks"]["attn"]["w_uq"][1]
                          .astype(np.float32))
    model = tlm.init_params(tcfg, dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(state)
    assert model.dense_blocks[0].attn.kv_norm.scale.dtype == torch.bfloat16


# ------------------------------------------------------------------ launchers
def test_server_gives_jax_greedy_tokens():
    """The slot Server on JAX's Server's weights: the same greedy tokens,
    positions and slots, and both segments' compressed caches within 1e-4
    after every admit and tick. Admitting a slot runs the batched decode
    step, which writes every slot's c_kv and k_rope rows at the admitted
    slot's positions (JAX's quirk, kept): slot 0's first rows move while
    slot 1 is admitted, in both servers (and stay while slot 2 is, whose
    admission writes them from the same inputs again)."""
    jcfg, tcfg = jget_reduced(ARCH), get_reduced(ARCH)
    prompt_len, max_new, n = 6, 5, 3
    with mesh_context(make_local_mesh()):
        js = jserve.Server(jcfg, max_len=prompt_len + max_new + 2, slots=n,
                           seed=4)
    model = tlm.init_params(tcfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, js.params), tcfg))
    ts = tserve.Server(tcfg, max_len=prompt_len + max_new + 2, slots=n,
                       device="cpu", params=model)

    def same():
        assert ts.outputs == js.outputs
        assert np.array_equal(ts.pos, js.pos)
        assert np.array_equal(ts.active, js.active)
        for seg in ("dense_blocks", "blocks"):
            for k in CACHE:
                assert err(ts.cache[seg][k], js.cache[seg][k]) <= TOL
    rng = np.random.default_rng(0)
    moved = []
    with mesh_context(make_local_mesh()):
        for _ in range(n):
            before = ts.cache["blocks"]["c_kv"][:, 0, :prompt_len].clone()
            prompt = rng.integers(1, jcfg.vocab_size, prompt_len).tolist()
            assert ts.admit(prompt) == js.admit(prompt)
            moved.append(not torch.equal(
                before, ts.cache["blocks"]["c_kv"][:, 0, :prompt_len]))
            same()
        for _ in range(max_new):
            js.tick()
            ts.tick()
            same()
    assert moved == [True, True, False]
    assert all(len(o) == max_new for o in ts.outputs)


def test_serve_cli_runs_mla(capsys):
    total = tserve.main(["--arch", ARCH, "--reduced", "--requests", "2",
                         "--max-new", "3", "--prompt-len", "4",
                         "--device", "cpu"])
    assert total == 6
    assert "served 2 requests, 6 tokens" in capsys.readouterr().out

"""The port's MoE family (`repro_torch.models.moe`, the MoE half of
`models.lm`, `weights`, the launchers) against the JAX package's, on the
CPU, on reduced deepseek_moe_16b (3 layers: 1 dense + 2 MoE, 8 experts,
top-2, 1 shared). Both packages compute in fp32 on the same weights
(JAX's, moved over with `params_from_jax`); JAX runs under
`mesh_context(make_local_mesh())`, so its `moe_apply` takes the
single-device branch the port implements.

Tolerances: routing (expert ids, slots, keep, the dropped set) exact;
1e-5 absolute on single functions (router weights, aux, buffers, expert
outputs of magnitude ~1), 1e-4 on logits (magnitude ~4), caches and
gradients, 1e-5 on the loss and on one AdamW step's moments, as in
`test_torch_lm.py` and `test_torch_train.py`. The reduced config keeps
`capacity_factor=8.0` and never drops; `DROP` (capacity_factor 0.5)
drops events, and the dropped set must be JAX's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_pair import lm_pair
from repro.configs import get_arch as jget_arch
from repro.configs import get_reduced as jget_reduced
from repro.distributed.context import mesh_context
from repro.launch import serve as jserve
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch, get_reduced
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models.weights import opt_state_from_jax, params_from_jax
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import named_leaves

ARCH = "deepseek_moe_16b"
FN_TOL = 1e-5
TOL = 1e-4


def err(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) if got.size else 0.0


def exact(got, want):
    got = got.numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    assert got.shape == want.shape and np.array_equal(got, want)


def with_capacity(cfg, cf):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


CFS = {"dropless": 8.0, "drops": 0.5}


@pytest.fixture(scope="module")
def pair():
    """(JAX config, port config, JAX tree as numpy, the port's model on
    it); tests that update the model in place build their own."""
    return lm_pair(ARCH, seed=11)


def tokens_of(x, layer=0):
    """The (T, d) inputs of one MoE layer's layer-`layer` weights, from
    a numpy seed: rows of RMS ~1, as ln2 gives them."""
    return np.random.default_rng(100 + layer).normal(0, 1, x).astype(
        np.float32)


def moe_weights(tree, layer=0):
    return jax.tree.map(lambda a: a[layer], tree["blocks"]["moe"])


class P:
    """Attribute access over a (nested) dict of numpy arrays."""

    def __init__(self, d):
        for k, v in d.items():
            setattr(self, k, P(v) if isinstance(v, dict)
                    else torch.from_numpy(np.asarray(v)))


# ------------------------------------------------------------------ routing
@pytest.mark.parametrize("T", [1, 37, 256])
def test_route_matches_jax(pair, T):
    jcfg, tcfg, tree, _ = pair
    p = moe_weights(tree, 1)
    x = tokens_of((T, tcfg.d_model), T)
    jw, jids, jaux = jmoe._route(jnp.asarray(x), jnp.asarray(p["router"]),
                                 jcfg)
    w, ids, aux = tmoe._route(torch.from_numpy(x),
                              torch.from_numpy(p["router"]), tcfg)
    exact(ids, jids)
    assert w.dtype == torch.float32 and aux.shape == ()
    assert err(w, jw) <= FN_TOL and err(aux, jaux) <= FN_TOL


@pytest.mark.parametrize("kind", ["all equal", "pairs equal"])
def test_route_exact_ties_follow_lax_top_k(pair, kind):
    """Equal router columns give exactly equal probabilities; the port
    takes them in lax.top_k's order (the lower expert first), where
    torch.topk leaves the order of ties open."""
    jcfg, tcfg, _, _ = pair
    d, E = tcfg.d_model, tcfg.moe.n_routed
    rng = np.random.default_rng(5)
    if kind == "all equal":
        router = np.repeat(rng.normal(0, 0.2, (d, 1)), E, axis=1)
    else:
        router = np.repeat(rng.normal(0, 0.2, (d, E // 2)), 2, axis=1)
    router = router.astype(np.float32)
    x = tokens_of((64, d))
    jw, jids, _ = jmoe._route(jnp.asarray(x), jnp.asarray(router), jcfg)
    w, ids, _ = tmoe._route(torch.from_numpy(x), torch.from_numpy(router),
                            tcfg)
    exact(ids, jids)
    assert err(w, jw) <= FN_TOL
    if kind == "all equal":
        assert (ids == torch.arange(tcfg.moe.top_k)).all()
    else:               # each pair's lower expert first
        assert (ids[:, 0] % 2 == 0).all()
        assert (ids[:, 1] == ids[:, 0] + 1).all()


@pytest.mark.parametrize("cf", sorted(CFS.values()))
def test_capacity_matches_jax(pair, cf):
    jcfg, tcfg, _, _ = pair
    jc, tc = with_capacity(jcfg, cf), with_capacity(tcfg, cf)
    for T in list(range(1, 70)) + [127, 128, 129, 1000, 4096, 32768]:
        assert tmoe._capacity(T, tc) == jmoe._capacity(T, jc), T
    # the published config at S = 4,096: 4,096 * 6 / 64 * 1.5 = 576
    assert tmoe._capacity(4096, get_arch(ARCH)) == 576


def route_and_pack(pair, cf, T=96):
    jcfg, tcfg, tree, _ = pair
    jc, tc = with_capacity(jcfg, cf), with_capacity(tcfg, cf)
    p = moe_weights(tree)
    x = tokens_of((T, tcfg.d_model))
    E = tc.moe.n_routed
    C = tmoe._capacity(T, tc)
    jw, jids, _ = jmoe._route(jnp.asarray(x), jnp.asarray(p["router"]), jc)
    jbuf, jslot, jkeep = jmoe._pack(jnp.asarray(x), jids, jw, C, E)
    w, ids, _ = tmoe._route(torch.from_numpy(x),
                            torch.from_numpy(p["router"]), tc)
    buf, slot, keep = tmoe._pack(torch.from_numpy(x), ids, w, C, E)
    return (jc, tc, p, x, C, (jw, jids, jbuf, jslot, jkeep),
            (w, ids, buf, slot, keep))


@pytest.mark.parametrize("case", sorted(CFS))
def test_pack_matches_jax(pair, case):
    """Slots and keep exact (the dropped set JAX's), the buffers equal."""
    *_, C, (jw, jids, jbuf, jslot, jkeep), (w, ids, buf, slot, keep) = \
        route_and_pack(pair, CFS[case])
    exact(slot, jslot)
    exact(keep, jkeep)
    assert err(buf, jbuf) <= FN_TOL
    n_drop = int((~keep).sum())
    assert (n_drop > 0) == (case == "drops"), n_drop


@pytest.mark.parametrize("case", sorted(CFS))
def test_unpack_and_expert_ffn_match_jax(pair, case):
    jc, tc, p, x, C, (jw, jids, jbuf, jslot, jkeep), \
        (w, ids, buf, slot, keep) = route_and_pack(pair, CFS[case])
    E, d, k = tc.moe.n_routed, tc.d_model, tc.moe.top_k
    T = x.shape[0]
    jout = jmoe._expert_ffn({n: jnp.asarray(v) for n, v in p.items()
                             if n != "shared"}, jc, jbuf.reshape(E, C, d))
    out = tmoe._expert_ffn(P(p), tc, buf.reshape(E, C, d))
    assert err(out, jout) <= FN_TOL
    jy = jmoe._unpack(jout.reshape(E * C, d), jslot, jkeep, jw, T, k)
    y = tmoe._unpack(out.reshape(E * C, d), slot, keep, w, T, k)
    assert err(y, jy) <= FN_TOL
    # a dropped event contributes nothing
    dropped = np.nonzero(~keep.numpy().reshape(T, k).all(1))[0]
    assert (len(dropped) > 0) == (case == "drops")


@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_shared_ffn_matches_jax(pair, act):
    jcfg, tcfg, tree, _ = pair
    jc, tc = (dataclasses.replace(c, act=act) for c in (jcfg, tcfg))
    sp = moe_weights(tree)["shared"]
    x = tokens_of((2, 9, tcfg.d_model))
    want = jmoe._shared_ffn({n: jnp.asarray(v) for n, v in sp.items()}, jc,
                            jnp.asarray(x))
    assert err(tmoe._shared_ffn(P(sp), tc, torch.from_numpy(x)), want) \
        <= FN_TOL


@pytest.mark.parametrize("case,S", [("dropless", 1), ("dropless", 50),
                                    ("drops", 50)])
def test_moe_apply_matches_jax(pair, case, S):
    jcfg, tcfg, tree, _ = pair
    jc, tc = (with_capacity(c, CFS[case]) for c in (jcfg, tcfg))
    p = moe_weights(tree, 1)
    x = tokens_of((2, S, tcfg.d_model), S)
    with mesh_context(make_local_mesh()):
        jy, jaux = jax.jit(lambda p, x: jmoe.moe_apply(p, x, jc))(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    y, aux = tmoe.moe_apply(P(p), torch.from_numpy(x), tc)
    assert err(y, jy) <= FN_TOL and err(aux, jaux) <= FN_TOL


def test_moe_pack_unpack_inverse():
    """The port's twin of tests/test_layers.py::test_moe_pack_unpack_inverse:
    identity experts and a dropless capacity give unpack(pack(x)) == x."""
    cfg = get_reduced(ARCH)
    g = torch.Generator().manual_seed(2)
    T, d = 32, 16
    E, k = cfg.moe.n_routed, cfg.moe.top_k
    x = torch.randn((T, d), generator=g)
    ids = torch.randint(0, E, (T, k), generator=g)
    w = torch.full((T, k), 1.0 / k)
    C = tmoe._capacity(T, cfg)
    buf, slot, keep = tmoe._pack(x, ids, w, C, E)
    y = tmoe._unpack(buf, slot, keep, w, T, k)
    assert bool(keep.all())
    assert float((y - x).abs().max()) <= 1e-6


def test_moe_flops_matches_jax(pair):
    jcfg, tcfg, _, _ = pair
    for j, t in ((jcfg, tcfg), (jget_arch(ARCH), get_arch(ARCH))):
        assert tmoe.moe_flops(t, 4096) == jmoe.moe_flops(j, 4096)


# ------------------------------------------------------------------ the model
def jax_prefill(tree, cfg, tokens):
    with mesh_context(make_local_mesh()):
        return jax.jit(lambda p, t: jlm.prefill(p, cfg, {"tokens": t}))(
            tree, jnp.asarray(tokens))


@pytest.mark.parametrize("case,B,S", [("dropless", 2, 37),
                                      ("dropless", 1, 160),
                                      ("drops", 2, 64)])
def test_prefill_matches_jax(pair, case, B, S):
    """Last-token logits and both cache segments (dense_blocks, blocks)."""
    jcfg, tcfg, tree, model = pair
    jc, tc = (with_capacity(c, CFS[case]) for c in (jcfg, tcfg))
    tokens = np.random.default_rng(S).integers(0, jcfg.vocab_size, (B, S))
    lj, cj = jax_prefill(tree, jc, tokens)
    lt, ct = tlm.prefill(model, tc, {"tokens": torch.from_numpy(tokens)})
    assert lt.dtype == torch.float32 and err(lt, lj) <= TOL
    assert set(ct) == {"dense_blocks", "blocks"}
    for seg, L in tlm.segment_layers(tc).items():
        for n in ("k", "v"):
            assert ct[seg][n].shape == (L, B, S, tc.n_kv_heads,
                                        tc.resolved_head_dim)
            assert err(ct[seg][n], cj[seg][n]) <= TOL, (seg, n)


def test_decode_steps_match_jax(pair):
    """Five decode steps of 2 rows from `init_cache`, feeding JAX's greedy
    tokens to both packages."""
    jcfg, tcfg, tree, model = pair
    B, T = 2, 8
    jc = jlm.init_cache(jcfg, B, T, jnp.float32)
    tc = tlm.init_cache(tcfg, B, T, torch.float32, device="cpu")
    assert {s: tc[s]["k"].shape[0] for s in tc} == {"dense_blocks": 1,
                                                    "blocks": 2}
    tok = np.array([[3], [11]])
    with mesh_context(make_local_mesh()):
        step = jax.jit(lambda p, t, c, i: jlm.decode_step(p, jcfg, t, c, i))
        for pos in range(5):
            lj, jc = step(tree, jnp.asarray(tok), jc, jnp.int32(pos))
            lt, tc = tlm.decode_step(model, tcfg, torch.from_numpy(tok),
                                     tc, pos)
            assert err(lt, lj) <= TOL
            for seg in ("dense_blocks", "blocks"):
                for n in ("k", "v"):
                    assert err(tc[seg][n], jc[seg][n]) <= TOL, (pos, seg, n)
            tok = np.asarray(lj)[:, :jcfg.vocab_size].argmax(1)[:, None]


def test_decode_matches_teacher_forcing(pair):
    """The port's twin of tests/test_models_smoke.py::
    test_decode_matches_teacher_forcing for MoE: tokens fed one by one
    through decode_step give the full forward's last logits (dropless,
    so each token's routing is its own)."""
    _, tcfg, _, model = pair
    B, S = 2, 16
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (B, S)))
    full, _ = tlm.prefill(model, tcfg, {"tokens": toks})
    cache = tlm.init_cache(tcfg, B, S, torch.float32, device="cpu")
    for t in range(S):
        lg, cache = tlm.decode_step(model, tcfg, toks[:, t:t + 1], cache, t)
    assert err(lg, full.numpy()) <= TOL


class CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                    torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_loss_and_grads_match_jax(pair):
    """Loss, ce and aux of jax.value_and_grad(lm.loss_fn), and every
    gradient leaf (the fp32 routers included), with the port's remat off,
    "full" and "dots"; "dots" gives "full"'s gradients bit for bit and
    recomputes fewer matmuls in the backward."""
    jcfg, tcfg, tree, model = pair
    assert tcfg.remat_policy == "dots"
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 48))
    lmask = (rng.random((2, 48)) < 0.8).astype(np.float32)
    batch = {"tokens": tokens, "loss_mask": lmask}
    with mesh_context(make_local_mesh()):
        (jv, jparts), jg = jax.jit(jax.value_and_grad(
            lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))(
            jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    want = params_from_jax(jax.tree.map(np.asarray, jg), tcfg)
    leaves = named_leaves(model)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, mms = {}, {}
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        cfg = dataclasses.replace(tcfg, remat=remat, remat_policy=policy)
        loss, parts = tlm.loss_fn(model, cfg, tbatch)
        assert err(loss, jv) <= FN_TOL and err(parts["ce"], jparts["ce"]) \
            <= FN_TOL
        assert float(parts["aux"].detach()) > 0
        assert err(parts["aux"], jparts["aux"]) <= 1e-5 * float(jparts["aux"])
        with CountMatmuls() as count:
            g = torch.autograd.grad(loss, list(leaves.values()))
        got[(remat, policy)] = dict(zip(leaves, g))
        mms[(remat, policy)] = count.n
    assert set(got[(True, "dots")]) == set(want)
    assert any("moe.router" in n for n in want)
    for n in want:
        assert torch.equal(got[(True, "dots")][n], got[(True, "full")][n]), n
        for key in got:
            assert err(got[key][n], want[n]) <= TOL, (key, n)
    # the backward recomputes the forward's matmuls under "full", none of
    # them under "dots"
    assert mms[(True, "dots")] == mms[(False, "full")] < mms[(True, "full")]


def test_routing_is_sparse_and_loadbalanced(pair):
    """The port's twin of tests/test_models_smoke.py::
    test_moe_routing_is_sparse_and_loadbalanced."""
    _, tcfg, _, model = pair
    tokens = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 64))
    with torch.no_grad():
        _, parts = tlm.loss_fn(model, tcfg, {"tokens":
                                             torch.from_numpy(tokens)})
    assert 0 < float(parts["aux"]) < 0.2 * float(parts["ce"])


ILL = 1e-6     # sqrt(nu_hat) under 100 * eps: Adam's step is ill-conditioned


def test_train_step_matches_jax():
    """One step of the port's make_train_step against JAX's jitted step
    from the same parameters and AdamW state (lr 1e-2): loss, grad norm
    and lr within 1e-5, mu and nu within 1e-5, parameters within 1e-5
    where the step is well-conditioned (sqrt(nu_hat) >= 100 eps) and
    within 2 lr elsewhere (test_torch_train.py says why)."""
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
    assert {"dense_blocks.0.mlp.w_in", "blocks.1.moe.router",
            "blocks.0.moe.shared.w_out"} <= seen


def test_params_from_jax_keeps_bf16_and_the_fp32_router():
    jcfg, tcfg = jget_reduced(ARCH), get_reduced(ARCH)
    tree = jax.tree.map(np.asarray, jlm.init_params(
        jcfg, jax.random.PRNGKey(3), jnp.bfloat16))
    assert tree["blocks"]["moe"]["router"].dtype == np.float32
    state = params_from_jax(tree, tcfg)
    assert state["blocks.1.moe.router"].dtype == torch.float32
    assert state["blocks.1.moe.w_in"].dtype == torch.bfloat16
    assert np.array_equal(state["blocks.1.moe.w_out"].float().numpy(),
                          tree["blocks"]["moe"]["w_out"][1]
                          .astype(np.float32))
    model = tlm.init_params(tcfg, dtype=torch.bfloat16, device="cpu")
    assert model.blocks[0].moe.router.dtype == torch.float32
    model.load_state_dict(state)
    assert torch.equal(model.blocks[1].moe.router, state[
        "blocks.1.moe.router"])


@pytest.mark.parametrize("seg", ["dense_blocks", "blocks"])
def test_params_from_jax_checks_each_segments_layer_count(pair, seg):
    _, tcfg, tree, _ = pair
    short = jax.tree.map(lambda a: a, tree)
    short[seg]["ln1"]["scale"] = np.concatenate(
        [short[seg]["ln1"]["scale"]] * 2)
    with pytest.raises(ValueError, match=f"{seg}.ln1.scale: .* layers "
                                         f"stacked"):
        params_from_jax(short, tcfg)


# ------------------------------------------------------------------ launchers
def test_server_gives_jax_greedy_tokens():
    """The slot Server on JAX's Server's weights: the same greedy tokens,
    positions and slots, and both cache segments within 1e-4."""
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
    assert ts.params is model

    def same():
        assert ts.outputs == js.outputs
        assert np.array_equal(ts.pos, js.pos)
        assert np.array_equal(ts.active, js.active)
        for seg in ("dense_blocks", "blocks"):
            for k in ("k", "v"):
                assert err(ts.cache[seg][k], js.cache[seg][k]) <= TOL
    rng = np.random.default_rng(0)
    with mesh_context(make_local_mesh()):
        for _ in range(n):
            prompt = rng.integers(1, jcfg.vocab_size, prompt_len).tolist()
            assert ts.admit(prompt) == js.admit(prompt)
            same()
        for _ in range(max_new):
            js.tick()
            ts.tick()
            same()
    assert all(len(o) == max_new for o in ts.outputs)


def test_serve_cli_runs_moe(capsys):
    total = tserve.main(["--arch", ARCH, "--reduced", "--requests", "2",
                         "--max-new", "3", "--prompt-len", "4",
                         "--device", "cpu"])
    assert total == 6
    assert "served 2 requests, 6 tokens" in capsys.readouterr().out


def train(*extra):
    return ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--batch", "2", "--seq", "32", "--log-every", "1",
                        *extra])


def test_train_cli_resumes_exactly(capsys, tmp_path):
    """Three steps straight give the same loss, parameters and moments,
    bit for bit, as two steps, a restore from --ckpt-dir and one more."""
    straight = train("--steps", "3", "--ckpt-dir", str(tmp_path / "a"))
    train("--steps", "2", "--ckpt-dir", str(tmp_path / "b"))
    capsys.readouterr()
    resumed = train("--steps", "3", "--ckpt-dir", str(tmp_path / "b"))
    out = capsys.readouterr().out
    assert "[resume] from step 2" in out and "step 0:" not in out
    assert np.isfinite(straight) and resumed == straight
    model = tlm.init_params(get_reduced(ARCH), 1, torch.float32, "cpu")
    like = {"params": model.state_dict(),
            "opt": adamw_init(model, AdamWConfig())}
    (ta, _), (tb, _) = (CheckpointManager(tmp_path / n).restore(like)
                        for n in "ab")
    for x, y in ((ta["params"], tb["params"]),
                 (ta["opt"]["mu"], tb["opt"]["mu"]),
                 (ta["opt"]["nu"], tb["opt"]["nu"])):
        assert x.keys() == y.keys() and any("moe.router" in n for n in x)
        for n in x:
            assert torch.equal(x[n], y[n]), n

"""The port's SSM family (`repro_torch.models.ssm`, the Mamba-2 half of
`models.lm`, `weights`, the launchers) against the JAX package's, on the
CPU, on reduced mamba2_780m (2 layers, d_model 64, 4 SSD heads of 32,
d_state 16, chunk 32). Both packages compute in fp32 on the same weights
(JAX's, moved over with `params_from_jax`); inputs come from numpy seeds.

Tolerances, as in `test_torch_moe.py`: 1e-5 absolute on single functions
(values of magnitude ~1), 1e-4 on logits (magnitude ~4), caches and
gradients, 1e-5 on the loss and one AdamW step.

One test pins a fault of the reference: JAX's `ssd_chunked` takes
exp(cum_t - cum_s) of every (t, s) pair before masking, which overflows
above the diagonal at the published chunk of 256, so `jax.grad` through
it is NaN; the port masks the exponent and its gradient is finite."""
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
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch, get_reduced
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_train_step
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.models.weights import opt_state_from_jax, params_from_jax
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import named_leaves

ARCH = "mamba2_780m"
FN_TOL = 1e-5
TOL = 1e-4


def err(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) if got.size else 0.0


class P:
    """Attribute access over a (nested) dict of numpy arrays."""

    def __init__(self, d):
        for k, v in d.items():
            setattr(self, k, P(v) if isinstance(v, dict)
                    else torch.from_numpy(np.asarray(v)))


@pytest.fixture(scope="module")
def pair():
    """(JAX config, port config, JAX tree as numpy, the port's model on
    it); tests that update the model in place build their own."""
    return lm_pair(ARCH, seed=7)


def ssd_inputs(seed, B, S, H, Pd, N, log_a=None):
    """xh, a, Bm, Cm (and an initial state) from a numpy seed; a in
    (0.05, 0.95), or e^log_a everywhere; B and C of RMS N**-0.5, so that
    C.B and the outputs are of magnitude ~1."""
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(B, S, H, Pd)).astype(np.float32)
    if log_a is None:
        a = (1 / (1 + np.exp(-rng.normal(size=(B, S, H))))) * 0.9 + 0.05
    else:
        a = np.full((B, S, H), np.exp(log_a))
    Bm = rng.normal(0, N ** -0.5, (B, S, N)).astype(np.float32)
    Cm = rng.normal(0, N ** -0.5, (B, S, N)).astype(np.float32)
    h0 = rng.normal(size=(B, H, Pd, N)).astype(np.float32)
    return xh, a.astype(np.float32), Bm, Cm, h0


def naive_ssd(xh, a, Bm, Cm, h0=None):
    """The recurrence h = a h + x B^T, y = C.h token by token (the oracle
    of tests/test_layers.py), in torch at the inputs' precision."""
    B, S, H, Pd = xh.shape
    h = torch.zeros((B, H, Pd, Bm.shape[-1]), dtype=xh.dtype) \
        if h0 is None else h0
    ys = []
    for t in range(S):
        h = h * a[:, t, :, None, None] + torch.einsum(
            "bhp,bn->bhpn", xh[:, t], Bm[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], h))
    return torch.stack(ys, dim=1), h


# ------------------------------------------------------------------ pieces
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(1)
    K, C = 4, 24
    w = rng.normal(0, 0.5, (K, C)).astype(np.float32)
    b = rng.normal(0, 0.1, C).astype(np.float32)
    x = rng.normal(size=(2, 9, C)).astype(np.float32)
    st = rng.normal(size=(2, K - 1, C)).astype(np.float32) \
        if with_state else None
    jy, jst = jssm._causal_conv(jnp.asarray(w), jnp.asarray(b),
                                jnp.asarray(x),
                                None if st is None else jnp.asarray(st))
    ty, tst = tssm._causal_conv(torch.from_numpy(w), torch.from_numpy(b),
                                torch.from_numpy(x),
                                None if st is None else torch.from_numpy(st))
    assert err(ty, jy) <= FN_TOL
    assert err(tst, jst) == 0.0


@pytest.mark.parametrize("chunk", [8, 16, 32])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunked_matches_jax(chunk, init):
    xh, a, Bm, Cm, h0 = ssd_inputs(chunk, 2, 64, 3, 4, 8)
    h0 = h0 if init else None
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, (xh, a, Bm, Cm)), chunk,
                              None if h0 is None else jnp.asarray(h0))
    ty, th = tssm.ssd_chunked(*map(torch.from_numpy, (xh, a, Bm, Cm)),
                              chunk, None if h0 is None
                              else torch.from_numpy(h0))
    assert ty.dtype == th.dtype == torch.float32
    assert err(ty, jy) <= FN_TOL and err(th, jh) <= FN_TOL


@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunked_matches_naive_recurrence(init):
    xh, a, Bm, Cm, h0 = ssd_inputs(3, 1, 32, 2, 4, 8)
    t = [torch.from_numpy(v).double() for v in (xh, a, Bm, Cm, h0)]
    want_y, want_h = naive_ssd(*t[:4], t[4] if init else None)
    y, h = tssm.ssd_chunked(*map(torch.from_numpy, (xh, a, Bm, Cm)), 8,
                            torch.from_numpy(h0) if init else None)
    assert err(y, want_y) <= FN_TOL and err(h, want_h) <= FN_TOL


def test_ssd_chunked_rejects_a_ragged_length():
    xh, a, Bm, Cm, _ = ssd_inputs(0, 1, 20, 2, 4, 8)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tssm.ssd_chunked(*map(torch.from_numpy, (xh, a, Bm, Cm)), 8)


def test_ssd_gradient_is_finite_at_the_published_chunk():
    """At chunk 256 and a = e^-0.8, JAX's exp(cum_t - cum_s) overflows
    above the diagonal (up to e^204): its forward is right, jax.grad is
    not finite. The port's forward equals JAX's; its gradient is finite
    and equals float64 autograd through the naive recurrence."""
    S = 256
    assert get_arch(ARCH).ssm.chunk_size == S
    xh, a, Bm, Cm, _ = ssd_inputs(11, 1, S, 2, 4, 8, log_a=-0.8)
    g_y = np.random.default_rng(12).normal(size=xh.shape).astype(np.float32)

    def jloss(xh, a, Bm, Cm):
        return jnp.sum(jssm.ssd_chunked(xh, a, Bm, Cm, S)[0] * g_y)
    jargs = tuple(map(jnp.asarray, (xh, a, Bm, Cm)))
    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*jargs)
    assert not all(bool(jnp.isfinite(g).all()) for g in jgrads)
    assert not bool(jnp.isfinite(jgrads[1]).all())     # d/da

    targs = [torch.from_numpy(v).requires_grad_() for v in (xh, a, Bm, Cm)]
    ty, _ = tssm.ssd_chunked(*targs, S)
    assert err(ty, jssm.ssd_chunked(*jargs, S)[0]) <= FN_TOL
    tgrads = torch.autograd.grad((ty * torch.from_numpy(g_y)).sum(), targs)
    assert all(bool(torch.isfinite(g).all()) for g in tgrads)
    dargs = [torch.from_numpy(v).double().requires_grad_()
             for v in (xh, a, Bm, Cm)]
    wy, _ = naive_ssd(*dargs)
    wgrads = torch.autograd.grad((wy * torch.from_numpy(g_y).double())
                                 .sum(), dargs)
    for g, w in zip(tgrads, wgrads):
        assert err(g, w) <= TOL * max(1.0, float(w.abs().max()))


def test_loss_gradients_are_finite_at_the_published_chunk(pair):
    """The model's view of the same fault: the reduced config at
    chunk_size 256 and S = 256. jax.grad of JAX's loss has non-finite
    leaves; every gradient leaf of the port's loss is finite, on the
    same weights, and the losses agree."""
    jcfg, tcfg, tree, model = pair
    jc, tc = (dataclasses.replace(c, ssm=dataclasses.replace(
        c.ssm, chunk_size=256)) for c in (jcfg, tcfg))
    tokens = np.random.default_rng(8).integers(0, jc.vocab_size, (1, 256))
    with mesh_context(make_local_mesh()):
        jv, jg = jax.jit(jax.value_and_grad(
            lambda p, t: jlm.loss_fn(p, jc, {"tokens": t})[0]))(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens))
    bad = [k for k, v in jax.tree_util.tree_flatten_with_path(jg)[0]
           if not bool(jnp.isfinite(v).all())]
    assert bad, "JAX's gradient is finite at chunk 256"
    leaves = named_leaves(model)
    loss, _ = tlm.loss_fn(model, tc, {"tokens": torch.from_numpy(tokens)})
    assert err(loss, jv) <= FN_TOL
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def ssm_weights(tree, layer=0):
    return jax.tree.map(lambda a: a[layer], tree["blocks"]["ssm"])


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_ssm_apply_matches_jax(pair, mode):
    jcfg, tcfg, tree, _ = pair
    p = ssm_weights(tree, 1)
    S = 1 if mode == "decode" else 64
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, S, tcfg.d_model)).astype(np.float32)
    jcache = tcache = None
    if mode != "train":
        shapes = jssm.ssm_cache_shape(jcfg, 2, jnp.float32)
        cache = {n: rng.normal(0, 0.5, v.shape).astype(np.float32)
                 if mode == "decode" else np.zeros(v.shape, np.float32)
                 for n, v in shapes.items()}
        jcache = jax.tree.map(jnp.asarray, cache)
        tcache = {n: torch.from_numpy(v) for n, v in cache.items()}
    with mesh_context(make_local_mesh()):
        jy, jnew = jssm.ssm_apply(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x), jcfg, cache=jcache)
    ty, tnew = tssm.ssm_apply(P(p), torch.from_numpy(x), tcfg, cache=tcache)
    assert err(ty, jy) <= FN_TOL
    if mode == "train":
        assert tnew is None and jnew is None
    else:
        assert set(tnew) == {"conv", "ssd"}
        for n in tnew:
            assert tnew[n].dtype == torch.float32
            assert err(tnew[n], jnew[n]) <= FN_TOL, n


# ------------------------------------------------------------------ the model
def jax_prefill(tree, cfg, tokens):
    with mesh_context(make_local_mesh()):
        return jax.jit(lambda p, t: jlm.prefill(p, cfg, {"tokens": t}))(
            tree, jnp.asarray(tokens))


@pytest.mark.parametrize("B,S", [(2, 64), (1, 24)])
def test_prefill_matches_jax(pair, B, S):
    """Last-token logits and the {conv, ssd} cache; S = 24 < chunk runs
    one chunk of 24, as JAX's min(chunk_size, S)."""
    jcfg, tcfg, tree, model = pair
    tokens = np.random.default_rng(S).integers(0, jcfg.vocab_size, (B, S))
    lj, cj = jax_prefill(tree, jcfg, tokens)
    lt, ct = tlm.prefill(model, tcfg, {"tokens": torch.from_numpy(tokens)})
    assert lt.dtype == torch.float32 and err(lt, lj) <= TOL
    assert set(ct) == {"blocks"} and set(ct["blocks"]) == {"conv", "ssd"}
    for n in ("conv", "ssd"):
        assert ct["blocks"][n].shape == cj["blocks"][n].shape
        assert err(ct["blocks"][n], cj["blocks"][n]) <= TOL, n


def test_decode_steps_match_jax(pair):
    """Six decode steps of 2 rows from `init_cache`, JAX's greedy tokens
    fed to both packages: logits and both state leaves each step."""
    jcfg, tcfg, tree, model = pair
    B, T = 2, 8
    jc = jlm.init_cache(jcfg, B, T, jnp.float32)
    tc = tlm.init_cache(tcfg, B, T, torch.float32, device="cpu")
    assert {n: tuple(t.shape) for n, t in tc["blocks"].items()} == \
        {n: t.shape for n, t in jc["blocks"].items()}
    tok = np.array([[3], [11]])
    with mesh_context(make_local_mesh()):
        step = jax.jit(lambda p, t, c, i: jlm.decode_step(p, jcfg, t, c, i))
        for pos in range(6):
            lj, jc = step(tree, jnp.asarray(tok), jc, jnp.int32(pos))
            lt, tc = tlm.decode_step(model, tcfg, torch.from_numpy(tok),
                                     tc, pos)
            assert err(lt, lj) <= TOL
            for n in ("conv", "ssd"):
                assert err(tc["blocks"][n], jc["blocks"][n]) <= TOL, (pos, n)
            tok = np.asarray(lj)[:, :jcfg.vocab_size].argmax(1)[:, None]


def test_decode_matches_teacher_forcing(pair):
    """The port's twin of tests/test_models_smoke.py::
    test_decode_matches_teacher_forcing for the SSM: tokens fed one by
    one through decode_step give the full forward's last logits, and
    the prefill's state equals the one decoding leaves."""
    _, tcfg, _, model = pair
    B, S = 2, 32
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (B, S)))
    full, pre = tlm.prefill(model, tcfg, {"tokens": toks})
    cache = tlm.init_cache(tcfg, B, S, torch.float32, device="cpu")
    for t in range(S):
        lg, cache = tlm.decode_step(model, tcfg, toks[:, t:t + 1], cache, t)
    assert err(lg, full.numpy()) <= TOL
    for n in ("conv", "ssd"):
        assert err(cache["blocks"][n], pre["blocks"][n].numpy()) <= TOL, n


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(pair, remat):
    """Loss of jax.value_and_grad(lm.loss_fn) and every gradient leaf
    (the fp32 a_log, dt_bias and d_skip among them), with the port's
    remat off and on (one checkpoint a block)."""
    jcfg, tcfg, tree, model = pair
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 64))
    lmask = (rng.random((2, 64)) < 0.8).astype(np.float32)
    batch = {"tokens": tokens, "loss_mask": lmask}
    with mesh_context(make_local_mesh()):
        (jv, _), jg = jax.jit(jax.value_and_grad(
            lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))(
            jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    want = params_from_jax(jax.tree.map(np.asarray, jg), tcfg)
    leaves = named_leaves(model)
    cfg = dataclasses.replace(tcfg, remat=remat)
    loss, parts = tlm.loss_fn(model, cfg, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    assert err(loss, jv) <= FN_TOL and float(parts["aux"]) == 0.0
    got = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert set(got) == set(want)
    assert {"blocks.0.ssm.a_log", "blocks.1.ssm.d_skip",
            "blocks.1.ssm.out_norm.scale"} <= set(want)
    for n in want:
        assert got[n].dtype == want[n].dtype
        assert err(got[n], want[n]) <= TOL, n


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
        0, jcfg.vocab_size, (2, 64)).astype(np.int32)}
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
    """Every leaf, its dtype (bf16 weights, fp32 a_log/dt_bias/d_skip)
    and its layer."""
    _, tcfg, _, _ = pair
    jcfg = jget_reduced(ARCH)
    tree = jax.tree.map(np.asarray, jlm.init_params(
        jcfg, jax.random.PRNGKey(3), jnp.bfloat16))
    state = params_from_jax(tree, tcfg)
    model = tlm.init_params(tcfg, dtype=torch.bfloat16, device="cpu")
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    seen = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [k.key for k in path]
        if keys[0] == "blocks":
            names = [".".join(["blocks", str(i)] + keys[1:])
                     for i in range(tcfg.n_layers)]
            back = np.stack([state[n].float().numpy() for n in names])
        else:
            names = [".".join(keys)]
            back = state[names[0]].float().numpy()
        seen.update(names)
        assert state[names[0]].dtype == {
            "float32": torch.float32, "bfloat16": torch.bfloat16}[
            leaf.dtype.name], keys
        assert np.array_equal(back, leaf.astype(np.float32)), keys
    assert seen == set(state)
    assert model.blocks[1].ssm.a_log.dtype == torch.float32
    assert not hasattr(model.blocks[0], "ln2") \
        and not hasattr(model.blocks[0], "mlp")


def test_params_from_jax_checks_the_layer_count(pair):
    _, tcfg, tree, _ = pair
    short = jax.tree.map(lambda a: a, tree)
    short["blocks"]["ssm"]["a_log"] = short["blocks"]["ssm"]["a_log"][:1]
    with pytest.raises(ValueError, match="blocks.ssm.a_log: 1 layers "
                                         "stacked"):
        params_from_jax(short, tcfg)


# ------------------------------------------------------------------ launchers
def test_server_gives_jax_greedy_tokens():
    """The slot Server on JAX's Server's weights: the same greedy tokens,
    positions and slots, and the states within 1e-4 after every admit
    and tick. Admitting a slot runs the batched decode step, which steps
    every other slot's state with token 0 (JAX's quirk, kept): slot 0's
    state moves while slot 1 is admitted, in both servers."""
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
        for k in ("conv", "ssd"):
            assert err(ts.cache["blocks"][k], js.cache["blocks"][k]) <= TOL
    rng = np.random.default_rng(0)
    moved = []
    with mesh_context(make_local_mesh()):
        for _ in range(n):
            before = ts.cache["blocks"]["ssd"][:, 0].clone()
            prompt = rng.integers(1, jcfg.vocab_size, prompt_len).tolist()
            assert ts.admit(prompt) == js.admit(prompt)
            moved.append(not torch.equal(before,
                                         ts.cache["blocks"]["ssd"][:, 0]))
            same()
        for _ in range(max_new):
            js.tick()
            ts.tick()
            same()
    assert moved == [True, True, True]
    assert all(len(o) == max_new for o in ts.outputs)


def test_serve_cli_runs_the_ssm(capsys):
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
        assert x.keys() == y.keys() and "blocks.1.ssm.a_log" in x
        for n in x:
            assert torch.equal(x[n], y[n]), n

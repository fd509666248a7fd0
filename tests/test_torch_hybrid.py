"""The port's hybrid family (`repro_torch.models.rglru`, the windowed GQA
of `models.attention`, the window of the flash plain versions, the
RecurrentGemma half of `models.lm`, `weights`, the launchers) against the
JAX package's, on the CPU. Two configs: reduced recurrentgemma_2b (6
layers = 2 (rglru, rglru, local_attn) groups, no tail; d_model 64, 4
query heads over 1 KV head of 16, window 32) and the same at 8 layers
(2 groups + a 2-layer tail, the published layout's shape). Both packages
compute in fp32 on the same weights (JAX's, moved over with
`params_from_jax`); inputs come from numpy seeds.

Tolerances, as in `test_torch_moe.py`: 1e-5 absolute on single functions
(values of magnitude ~1), 1e-4 on logits (magnitude ~4), caches and
gradients, 1e-5 on the loss and one AdamW step."""
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
from repro.models import rglru as jrglru
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch, get_reduced
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_trainable,
                                                 flash_fwd_lse)
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref, flash_fwd_lse_ref)
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_train_step
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import rglru as trglru
from repro_torch.models.weights import opt_state_from_jax, params_from_jax
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import named_leaves

ARCH = "recurrentgemma_2b"
FN_TOL = 1e-5
TOL = 1e-4
LAYERS = {"groups only": 6, "groups + tail": 8}


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
                    else torch.from_numpy(np.array(v)))


def hybrid_pair(n_layers, seed):
    """lm_pair at `n_layers` (the reduced config's 6, or 8 for a tail)."""
    import repro.configs as jconfigs
    import repro_torch.configs as tconfigs
    if n_layers == jget_reduced(ARCH).n_layers:
        return lm_pair(ARCH, seed=seed)
    orig = (jconfigs.get_reduced, tconfigs.get_reduced)
    try:
        jconfigs.get_reduced = lambda a: dataclasses.replace(
            orig[0](a), n_layers=n_layers)
        tconfigs.get_reduced = lambda a: dataclasses.replace(
            orig[1](a), n_layers=n_layers)
        return lm_pair(ARCH, seed=seed)
    finally:
        jconfigs.get_reduced, tconfigs.get_reduced = orig


@pytest.fixture(scope="module", params=sorted(LAYERS))
def pair(request):
    return hybrid_pair(LAYERS[request.param], seed=9)


# ------------------------------------------------------------------ RG-LRU
@pytest.mark.parametrize("S", [1, 12, 33, 64])
def test_associative_scan_matches_jax(S):
    """The odd/even recursion of jax.lax.associative_scan, bit for bit."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.3, 1.0, (2, S, 5)).astype(np.float32)
    b = rng.normal(size=(2, S, 5)).astype(np.float32)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]
    # eager: under jit XLA contracts a2 * b1 + b2 into one FMA
    ja, jb = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    ta, tb = trglru.associative_scan(torch.from_numpy(a),
                                     torch.from_numpy(b), dim=1)
    assert err(ta, ja) == 0.0 and err(tb, jb) == 0.0


def rec_weights(tree, group=0, name="rec1"):
    return jax.tree.map(lambda a: a[group], tree["groups"][name]["rec"])


@pytest.mark.parametrize("mode", ["scan", "prefill", "step"])
def test_rglru_apply_matches_jax(mode):
    jcfg, tcfg, tree, _ = lm_pair(ARCH, seed=2)
    p = rec_weights(tree, 1, "rec2")
    S = 1 if mode == "step" else 24
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (2, S, tcfg.d_model)).astype(np.float32)
    jcache = tcache = None
    if mode != "scan":
        shapes = jrglru.rglru_cache_shape(jcfg, 2, jnp.float32)
        cache = {n: rng.normal(0, 0.5, v.shape).astype(np.float32)
                 if mode == "step" else np.zeros(v.shape, np.float32)
                 for n, v in shapes.items()}
        jcache = jax.tree.map(jnp.asarray, cache)
        tcache = {n: torch.from_numpy(v) for n, v in cache.items()}
    with mesh_context(make_local_mesh()):
        jy, jnew = jax.jit(lambda p, x, c: jrglru.rglru_apply(
            p, x, jcfg, cache=c))(jax.tree.map(jnp.asarray, p),
                                  jnp.asarray(x), jcache)
    ty, tnew = trglru.rglru_apply(P(p), torch.from_numpy(x), tcfg,
                                  cache=tcache)
    assert err(ty, jy) <= FN_TOL
    if mode == "scan":
        assert tnew is None and jnew is None
    else:
        for n in ("conv", "h"):
            assert err(tnew[n], jnew[n]) <= FN_TOL, n


def test_gate_blocks_of_the_published_width():
    assert trglru._gate_blocks(get_arch(ARCH)) == (10, 256)
    assert trglru._gate_blocks(get_reduced(ARCH)) == \
        jrglru._gate_blocks(jget_reduced(ARCH))


# ------------------------------------------------------------------ window
def attn_inputs(seed, B, S, H, KV, hd, T=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, T or S, KV, hd)).astype(np.float32)
    v = rng.normal(size=(B, T or S, KV, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window", [None, 1, 7, 32, 100])
def test_attend_with_a_window_matches_jax(window):
    """The port's decode-path `attend` with JAX's window mask, at a query
    block starting inside the sequence."""
    q, k, v = attn_inputs(1, 2, 9, 4, 1, 16, T=40)
    want = jattn._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 31,
                       40, window, 16 ** -0.5)
    got = tattn.attend(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), 31, 40, window=window)
    assert err(got, want) <= FN_TOL


def plain_pair(seed, B, S, H, KV, D):
    """(q, k, v, do) as the flash functions take them, (B, heads, S, D),
    from a numpy seed, and the same as JAX's (B, S, heads, D)."""
    q, k, v = attn_inputs(seed, B, S, H, KV, D)
    do = np.random.default_rng(seed + 1).normal(
        size=q.shape).astype(np.float32)
    t = [torch.from_numpy(x).transpose(1, 2) for x in (q, k, v, do)]
    return t, [jnp.asarray(x) for x in (q, k, v, do)]


@pytest.mark.parametrize("S,window", [(40, 7), (64, 32), (33, 1),
                                      (50, 49)])
def test_flash_plain_versions_take_the_window_of_sdpa(S, window):
    """flash_attention_ref / flash_fwd_lse_ref against JAX's `_sdpa` with
    the window, and flash_attention_bwd_ref against jax.grad of it."""
    (q, k, v, do), (jq, jk, jv, jdo) = plain_pair(S, 2, S, 4, 1, 16)

    def sdpa(q, k, v):
        return jattn._sdpa(q, k, v, 0, S, window, 16 ** -0.5)

    def fwd_bwd(q, k, v, do):
        o, vjp = jax.vjp(sdpa, q, k, v)
        return o, vjp(do)
    jo, jg = jax.jit(fwd_bwd)(jq, jk, jv, jdo)
    o = flash_attention_ref(q, k, v, True, window)
    assert err(o.transpose(1, 2), jo) <= FN_TOL
    o2, lse = flash_fwd_lse_ref(q, k, v, True, window)
    assert torch.equal(o, o2)
    g = flash_attention_bwd_ref(q, k, v, o2, lse, do, True, window)
    for got, want in zip(g, jg):
        assert err(got.transpose(1, 2), want) <= FN_TOL


def test_flash_window_past_the_sequence_is_no_window():
    """window >= S gives the unwindowed results bit for bit, and the
    wrappers take the plain versions on the CPU with the window."""
    (q, k, v, do), _ = plain_pair(3, 1, 30, 4, 2, 64)
    for w in (30, 31, 4096):
        assert torch.equal(flash_attention(q, k, v, window=w),
                           flash_attention(q, k, v))
        o, lse = flash_fwd_lse(q, k, v, window=w)
        o0, lse0 = flash_fwd_lse(q, k, v)
        assert torch.equal(o, o0) and torch.equal(lse, lse0)
        for a, b in zip(flash_attention_bwd(q, k, v, o, lse, do, window=w),
                        flash_attention_bwd(q, k, v, o, lse, do)):
            assert torch.equal(a, b)
    assert torch.equal(flash_attention(q, k, v, window=5),
                       flash_attention_ref(q, k, v, True, 5))


@pytest.mark.parametrize("bad", [0, -3, 2.0, True])
def test_flash_window_must_be_a_positive_int_with_causal(bad):
    (q, k, v, do), _ = plain_pair(4, 1, 8, 2, 1, 64)
    for fn in (flash_attention, flash_fwd_lse, flash_attention_trainable):
        with pytest.raises(ValueError, match="window"):
            fn(q, k, v, window=bad)
        with pytest.raises(ValueError, match="window"):
            fn(q, k, v, causal=False, window=4)


def test_trainable_flash_with_a_window_matches_autograd():
    """flash_attention_trainable's gradients with a window equal
    autograd through the plain forward."""
    (q, k, v, do), _ = plain_pair(5, 2, 37, 4, 2, 64)
    args = [t.clone().requires_grad_() for t in (q, k, v)]
    o = flash_attention_trainable(*args, window=9)
    g = torch.autograd.grad(o, args, do)
    args2 = [t.clone().requires_grad_() for t in (q, k, v)]
    g2 = torch.autograd.grad(flash_attention_ref(*args2, True, 9), args2, do)
    for a, b in zip(g, g2):
        assert err(a, b) <= FN_TOL


def attn_weights(tree, group=0):
    return jax.tree.map(lambda a: a[group], tree["groups"]["attn"]["attn"])


def test_windowed_prefill_cache_and_ring_decode_match_jax():
    """JAX's gqa_apply at the reduced window (32): the prefill at S = 40
    keeps the last 32 K/V rows in order; decode from a zero ring of
    T = 32 slots runs 45 steps, past the wrap, output and ring equal
    JAX's at every step."""
    jcfg, tcfg, tree, _ = lm_pair(ARCH, seed=8)
    W = tcfg.rglru.window
    assert W == 32
    p = attn_weights(tree, 1)
    jp = jax.tree.map(jnp.asarray, p)
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2, 40, tcfg.d_model)).astype(np.float32)
    pos = np.arange(40)
    with mesh_context(make_local_mesh()):
        jy, jc = jattn.gqa_apply(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                 window=W, cache={})
    ty, tc = tattn.gqa_apply(P(p), torch.from_numpy(x), tcfg,
                             torch.from_numpy(pos), window=W, cache=None)
    assert err(ty, jy) <= FN_TOL
    for n in ("k", "v"):
        assert tc[n].shape == (2, W, 1, 16)
        assert err(tc[n], jc[n]) <= FN_TOL
    jcache = jattn.gqa_cache_shape(jcfg, 2, 64, window=W, dtype=jnp.float32)
    tcache = tattn.gqa_cache_shape(tcfg, 2, 64, torch.float32, window=W)
    assert tcache["k"].shape == jcache["k"].shape == (2, W, 1, 16)
    step = jax.jit(lambda p, x, c, i: jattn.gqa_apply(
        p, x, jcfg, i + jnp.arange(1), window=W, cache=c, cache_pos=i))
    with mesh_context(make_local_mesh()):
        for t in range(45):
            xt = rng.normal(0, 1, (2, 1, tcfg.d_model)).astype(np.float32)
            jy, jcache = step(jp, jnp.asarray(xt), jcache, jnp.int32(t))
            ty, tcache = tattn.gqa_apply(
                P(p), torch.from_numpy(xt), tcfg, torch.tensor([t]),
                window=W, cache=tcache, cache_pos=t)
            assert err(ty, jy) <= FN_TOL, t
            for n in ("k", "v"):
                assert err(tcache[n], jcache[n]) <= FN_TOL, (t, n)


# ------------------------------------------------------------------ the model
def jax_prefill(tree, cfg, tokens):
    with mesh_context(make_local_mesh()):
        return jax.jit(lambda p, t: jlm.prefill(p, cfg, {"tokens": t}))(
            tree, jnp.asarray(tokens))


def leaves_of(tree):
    return {tuple(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_prefill_matches_jax(pair):
    """Last-token logits and every cache leaf (groups' rec1/rec2 {conv,
    h} and attn {k, v} of the last 32 positions; the tail's {conv, h})
    at S = 64, past the window."""
    jcfg, tcfg, tree, model = pair
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 64))
    lj, cj = jax_prefill(tree, jcfg, tokens)
    lt, ct = tlm.prefill(model, tcfg, {"tokens": torch.from_numpy(tokens)})
    assert lt.dtype == torch.float32 and err(lt, lj) <= TOL
    want = leaves_of(cj)
    assert set(ct) == set(cj) == set(tlm.segment_layers(tcfg))
    assert ("tail" in ct) == (tcfg.n_layers % 3 > 0)
    for path, leaf in want.items():
        got = get(ct, path)
        assert tuple(got.shape) == leaf.shape, path
        assert err(got, leaf) <= TOL, path


def test_decode_steps_match_jax_across_the_ring(pair):
    """40 decode steps of 2 rows from `init_cache(max_len=48)` (a ring of
    32 slots, so steps 32-39 overwrite the oldest), JAX's greedy tokens
    fed to both packages: logits and every cache leaf each step."""
    jcfg, tcfg, tree, model = pair
    B, T = 2, 48
    jc = jlm.init_cache(jcfg, B, T, jnp.float32)
    tc = tlm.init_cache(tcfg, B, T, torch.float32, device="cpu")
    assert {p: tuple(get(tc, p).shape) for p in leaves_of(jc)} == \
        {p: leaf.shape for p, leaf in leaves_of(jc).items()}
    assert tc["groups"]["attn"]["k"].shape[2] == tcfg.rglru.window
    tok = np.array([[3], [11]])
    with mesh_context(make_local_mesh()):
        step = jax.jit(lambda p, t, c, i: jlm.decode_step(p, jcfg, t, c, i))
        for pos in range(40):
            lj, jc = step(tree, jnp.asarray(tok), jc, jnp.int32(pos))
            lt, tc = tlm.decode_step(model, tcfg, torch.from_numpy(tok),
                                     tc, pos)
            assert err(lt, lj) <= TOL, pos
            for path, leaf in leaves_of(jc).items():
                assert err(get(tc, path), leaf) <= TOL, (pos, path)
            tok = np.asarray(lj)[:, :jcfg.vocab_size].argmax(1)[:, None]


def test_decode_matches_teacher_forcing(pair):
    """Tokens fed one by one through decode_step (a 32-slot ring) give
    the full forward's last logits at S = 48, past the window."""
    _, tcfg, _, model = pair
    B, S = 2, 48
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (B, S)))
    full, _ = tlm.prefill(model, tcfg, {"tokens": toks})
    cache = tlm.init_cache(tcfg, B, S, torch.float32, device="cpu")
    for t in range(S):
        lg, cache = tlm.decode_step(model, tcfg, toks[:, t:t + 1], cache, t)
    assert err(lg, full.numpy()) <= TOL


def test_loss_and_grads_match_jax(pair):
    """Loss of jax.value_and_grad(lm.loss_fn) and every gradient leaf at
    S = 64 (past the window), the port's remat on (one checkpoint a
    group and a tail block) and off."""
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
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    assert tcfg.remat
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        loss, parts = tlm.loss_fn(model, cfg, tbatch)
        assert err(loss, jv) <= FN_TOL and float(parts["aux"]) == 0.0
        got = dict(zip(leaves, torch.autograd.grad(loss,
                                                   list(leaves.values()))))
        assert set(got) == set(want)
        assert "groups.1.rec2.rec.lam" in want
        for n in want:
            assert err(got[n], want[n]) <= TOL, (remat, n)


ILL = 1e-6     # sqrt(nu_hat) under 100 * eps: Adam's step is ill-conditioned


def test_train_step_matches_jax():
    """One step of the port's make_train_step against JAX's jitted step
    (lr 1e-2) on the 8-layer config: loss, grad norm and lr within 1e-5,
    mu and nu within 1e-5, parameters within 1e-5 where the step is
    well-conditioned and within 2 lr elsewhere (test_torch_train.py says
    why). Ill-conditioned entries are ~1 % here, not under 1 % as in
    the dense and MoE tests: the RG-LRU's recurrence gates `w_r` take
    gradients of ~1e-8 on up to a quarter of their entries (the sigmoid
    r enters only through r * softplus(lam)); the check asks for under
    5 %, so that the well-conditioned comparison still covers nearly
    every parameter."""
    jcfg, tcfg, tree, model = hybrid_pair(8, seed=6)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    joc, toc = JAdamWConfig(**kw), AdamWConfig(**kw)
    batch = {"tokens": np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 48)).astype(np.int32)}
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
    assert "tail.1.rec.w_i" in want
    n_ill = n_all = 0
    for n in want:
        well = (nu[n] == 0) | (torch.sqrt(nu[n] / (1 - joc.b2)) >= ILL)
        gap = (state[n] - want[n]).abs()
        assert float(torch.where(well, gap, 0.0).max()) <= FN_TOL, n
        assert float(gap.max()) <= 2 * joc.lr, n
        n_ill += int((~well).sum())
        n_all += gap.numel()
    assert n_ill < 5e-2 * n_all, (n_ill, n_all)


# ------------------------------------------------------------------ weights
@pytest.mark.parametrize("n_layers", sorted(LAYERS.values()))
def test_params_from_jax_round_trips_every_leaf(n_layers):
    """Every leaf of JAX's bf16 tree (fp32 lam) by segment — groups.<i>.
    {rec1, rec2, attn} and tail.<i> — into the port's model."""
    jcfg, tcfg = (dataclasses.replace(c, n_layers=n_layers) for c in
                  (jget_reduced(ARCH), get_reduced(ARCH)))
    tree = jax.tree.map(np.asarray, jlm.init_params(
        jcfg, jax.random.PRNGKey(3), jnp.bfloat16))
    state = params_from_jax(tree, tcfg)
    model = tlm.init_params(tcfg, dtype=torch.bfloat16, device="cpu")
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    layers = tlm.segment_layers(tcfg)
    assert layers == ({"groups": 2} if n_layers == 6
                      else {"groups": 2, "tail": 2})
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [k.key for k in path]
        if keys[0] in layers:
            back = np.stack([state[".".join([keys[0], str(i)] + keys[1:])]
                             .float().numpy() for i in range(layers[keys[0]])])
        else:
            back = state[".".join(keys)].float().numpy()
        assert np.array_equal(back, leaf.astype(np.float32)), keys
    assert state["groups.1.rec1.rec.lam"].dtype == torch.float32
    assert state["groups.0.attn.attn.wk"].dtype == torch.bfloat16


@pytest.mark.parametrize("seg", ["groups", "tail"])
def test_params_from_jax_checks_each_segments_layer_count(seg):
    jcfg, tcfg, tree, _ = hybrid_pair(8, seed=1)
    short = jax.tree.map(lambda a: a, tree)
    node = short[seg]["rec"] if seg == "tail" else short[seg]["rec1"]["rec"]
    node["lam"] = np.concatenate([node["lam"]] * 2)
    with pytest.raises(ValueError, match=f"{seg}.* layers stacked"):
        params_from_jax(short, tcfg)


# ------------------------------------------------------------------ launchers
def test_server_gives_jax_greedy_tokens():
    """The slot Server on JAX's Server's weights, max_len 38 > the
    window (a 32-slot ring that wraps): the same greedy tokens,
    positions and slots, and every cache leaf within 1e-4 after every
    admit and tick. Admitting a slot steps every other slot's recurrent
    state with token 0 (JAX's quirk, kept): slot 0's h moves while slots
    1 and 2 are admitted, in both servers."""
    jcfg, tcfg = jget_reduced(ARCH), get_reduced(ARCH)
    prompt_len, max_new, n = 20, 16, 3
    with mesh_context(make_local_mesh()):
        js = jserve.Server(jcfg, max_len=prompt_len + max_new + 2, slots=n,
                           seed=4)
    model = tlm.init_params(tcfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree.map(np.asarray, js.params), tcfg))
    ts = tserve.Server(tcfg, max_len=prompt_len + max_new + 2, slots=n,
                       device="cpu", params=model)
    assert ts.cache["groups"]["attn"]["k"].shape[2] == tcfg.rglru.window

    def same():
        assert ts.outputs == js.outputs
        assert np.array_equal(ts.pos, js.pos)
        assert np.array_equal(ts.active, js.active)
        for path, leaf in leaves_of(js.cache).items():
            assert err(get(ts.cache, path), leaf) <= TOL, path
    rng = np.random.default_rng(0)
    moved = []
    with mesh_context(make_local_mesh()):
        for _ in range(n):
            h0 = ts.cache["groups"]["rec1"]["h"][:, 0].clone()
            jh0 = np.asarray(js.cache["groups"]["rec1"]["h"][:, 0])
            prompt = rng.integers(1, jcfg.vocab_size, prompt_len).tolist()
            assert ts.admit(prompt) == js.admit(prompt)
            moved.append((not torch.equal(
                h0, ts.cache["groups"]["rec1"]["h"][:, 0]),
                not np.array_equal(
                    jh0, np.asarray(js.cache["groups"]["rec1"]["h"][:, 0]))))
            same()
        for _ in range(max_new):
            js.tick()
            ts.tick()
            same()
    assert moved == [(True, True)] * 3
    assert all(len(o) == max_new for o in ts.outputs)


def test_serve_cli_runs_the_hybrid(capsys):
    total = tserve.main(["--arch", ARCH, "--reduced", "--requests", "2",
                         "--max-new", "3", "--prompt-len", "4",
                         "--device", "cpu"])
    assert total == 6
    assert "served 2 requests, 6 tokens" in capsys.readouterr().out


def train(*extra):
    return ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--batch", "2", "--seq", "48", "--log-every", "1",
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
        assert x.keys() == y.keys() and "groups.1.rec2.rec.lam" in x
        for n in x:
            assert torch.equal(x[n], y[n]), n

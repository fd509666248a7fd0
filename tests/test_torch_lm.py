"""The port's LM stack (dense family, serving half) against the JAX
package's, on the CPU: the layer functions; `prefill` (last-token logits
and the K/V caches) for reduced qwen2_5_3b, qwen2_7b and gemma_7b, at a
ragged length and past JAX's q_chunk of 1024; `decode_step` from
`init_cache`; the parameter converter; every config of the registry
run through the port at its reduced size against JAX's shapes (the
families' own files: `test_torch_moe.py`, `test_torch_ssm.py`,
`test_torch_hybrid.py`, `test_torch_mla.py`, `test_torch_frontends.py`).
Both packages compute in fp32 on the same weights (JAX's, moved over
with `params_from_jax`); the tolerance is 1e-4 absolute on logits of
magnitude ~4 and on the caches, for reductions of depth up to 256
summed in another order (the measured gap is ~4e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pair import lm_pair
from repro.distributed.context import mesh_context
from repro.launch.mesh import make_local_mesh
from repro import configs as jcfgs
from repro.models import layers as jl
from repro.models import lm as jlm
from repro_torch.configs import get_reduced
from repro_torch.models import layers as tl
from repro_torch.models import lm as tlm
from repro_torch.models.weights import params_from_jax

TOL = 1e-4


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    e = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert e <= tol, e


class P:
    """Attribute access over a dict of numpy arrays, for the port's
    layer functions."""

    def __init__(self, d):
        for k, v in d.items():
            setattr(self, k, torch.from_numpy(np.asarray(v)))


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_apply_norm(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 2, (2, 5, 48)).astype(np.float32)
    p = {"scale": rng.normal(1, 0.3, 48).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.normal(0, 0.3, 48).astype(np.float32)
    want = jl.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), kind)
    close(tl.apply_norm(P(p), torch.from_numpy(x), kind), want, 1e-5)


@pytest.mark.parametrize("shape,theta", [((2, 9, 3, 16), 1e6),
                                         ((9, 32), 1e4),
                                         ((1, 300, 2, 64), 5e5)])
def test_apply_rope(shape, theta):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    pos = np.arange(shape[-3] if len(shape) == 4 else shape[0]) * 3
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    close(got, want, 1e-5)


def test_sinusoidal_positions():
    pos = np.arange(50)
    close(tl.sinusoidal_positions(torch.from_numpy(pos), 64),
          jl.sinusoidal_positions(jnp.asarray(pos), 64), 1e-5)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_apply(act):
    rng = np.random.default_rng(2)
    d, f = 32, 80
    p = {"w_in": rng.normal(0, 0.2, (d, f)), "w_out": rng.normal(0, 0.1,
                                                                 (f, d))}
    if act != "gelu":
        p["w_gate"] = rng.normal(0, 0.2, (d, f))
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 7, d)).astype(np.float32)
    cfg = get_reduced("qwen2_5_3b").__class__(
        name="t", family="dense", n_layers=1, d_model=d, n_heads=2,
        n_kv_heads=2, d_ff=f, vocab_size=8, act=act)
    with mesh_context(make_local_mesh()):
        want = jl.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), cfg)
    close(tl.mlp_apply(P(p), torch.from_numpy(x), act), want, 1e-5)


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "qwen2_7b"])
def test_embed_and_unembed(arch):
    """Tied (qwen2_5_3b) and untied (qwen2_7b) output embeddings over the
    padded vocab."""
    jcfg, tcfg, tree, model = lm_pair(arch)
    assert tl.padded_vocab(tcfg) == jl.padded_vocab(jcfg)
    assert model.embed.table.shape[0] == tl.padded_vocab(tcfg)
    tok = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 6))
    emb = {k: jnp.asarray(v) for k, v in tree["embed"].items()}
    h = tl.embed_lookup(model.embed, torch.from_numpy(tok))
    close(h, jl.embed_lookup(emb, jnp.asarray(tok)), 0)
    close(tl.unembed(model.embed, h, tcfg),
          jl.unembed(emb, jnp.asarray(h.detach().numpy()), jcfg), 1e-5)


# ------------------------------------------------------------------ prefill
def jax_prefill(tree, cfg, tokens):
    with mesh_context(make_local_mesh()):
        return jlm.prefill(tree, cfg, {"tokens": jnp.asarray(tokens)})


@pytest.mark.parametrize("arch,B,S", [("qwen2_5_3b", 2, 37),
                                      ("qwen2_7b", 2, 64),
                                      ("gemma_7b", 1, 45),
                                      ("qwen2_5_3b", 1, 2048)])
def test_prefill_matches_jax(arch, B, S):
    """S = 2048 takes JAX's q-chunked branch (S > q_chunk = 1024)."""
    jcfg, tcfg, tree, model = lm_pair(arch, seed=S)
    tokens = np.random.default_rng(S).integers(0, jcfg.vocab_size, (B, S))
    lj, cj = jax_prefill(tree, jcfg, tokens)
    lt, ct = tlm.prefill(model, tcfg, {"tokens": torch.from_numpy(tokens)})
    assert lt.dtype == torch.float32
    close(lt, lj)
    for n in ("k", "v"):
        assert ct["blocks"][n].shape == (tcfg.n_layers, B, S,
                                         tcfg.n_kv_heads,
                                         tcfg.resolved_head_dim)
        close(ct["blocks"][n], cj["blocks"][n])


# ------------------------------------------------------------------ decode
def test_decode_steps_match_jax():
    """Five decode steps of 2 rows from `init_cache`, feeding JAX's
    greedy tokens to both packages."""
    jcfg, tcfg, tree, model = lm_pair("qwen2_5_3b", seed=7)
    B, T = 2, 8
    jc = jlm.init_cache(jcfg, B, T, jnp.float32)
    tc = tlm.init_cache(tcfg, B, T, torch.float32, device="cpu")
    tok = np.array([[3], [11]])
    with mesh_context(make_local_mesh()):
        for pos in range(5):
            lj, jc = jlm.decode_step(tree, jcfg, jnp.asarray(tok), jc,
                                     jnp.int32(pos))
            lt, tc = tlm.decode_step(model, tcfg, torch.from_numpy(tok),
                                     tc, pos)
            close(lt, lj)
            for n in ("k", "v"):
                close(tc["blocks"][n], jc["blocks"][n])
            tok = np.asarray(lj)[:, :jcfg.vocab_size].argmax(1)[:, None]


def test_decode_after_the_cache_end_clamps_like_jax():
    """cache_pos past the cache: JAX's dynamic_update_slice clamps the
    write to the last row; the mask still reads cache_pos + 1 keys."""
    jcfg, tcfg, tree, model = lm_pair("gemma_7b", seed=2)
    jc = jlm.init_cache(jcfg, 1, 3, jnp.float32)
    tc = tlm.init_cache(tcfg, 1, 3, torch.float32, device="cpu")
    tok = np.array([[5]])
    with mesh_context(make_local_mesh()):
        for pos in (0, 1, 2, 4):
            lj, jc = jlm.decode_step(tree, jcfg, jnp.asarray(tok), jc,
                                     jnp.int32(pos))
            lt, tc = tlm.decode_step(model, tcfg, torch.from_numpy(tok),
                                     tc, pos)
            close(lt, lj)
            close(tc["blocks"]["k"], jc["blocks"]["k"])


# ------------------------------------------------------------------ weights
@pytest.mark.parametrize("arch", ["qwen2_5_3b", "qwen2_7b", "gemma_7b"])
def test_params_from_jax_round_trips_every_leaf(arch):
    jcfg, tcfg, tree, model = lm_pair(arch)
    state = model.state_dict()
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    seen = set()
    for path, leaf in leaves:
        keys = [k.key for k in path]
        if keys[0] == "blocks":
            names = [".".join(["blocks", str(i)] + keys[1:])
                     for i in range(tcfg.n_layers)]
            back = np.stack([state[n].numpy() for n in names])
        else:
            names = [".".join(keys)]
            back = state[names[0]].numpy()
        seen.update(names)
        assert back.dtype == leaf.dtype and np.array_equal(back, leaf), keys
    assert seen == set(state), set(state) ^ seen
    assert "embed.table" in seen
    assert ("blocks.0.attn.bq" in seen) == tcfg.qkv_bias


def test_params_from_jax_keeps_bf16():
    jcfg, tcfg, tree, _ = lm_pair("qwen2_5_3b")
    tree16 = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                          tree)
    state = params_from_jax(tree16, tcfg)
    t = state["blocks.1.mlp.w_gate"]
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.float().numpy(),
                          tree16["blocks"]["mlp"]["w_gate"][1]
                          .astype(np.float32))


def test_params_from_jax_checks_the_layer_count():
    jcfg, tcfg, tree, _ = lm_pair("qwen2_5_3b")
    short = jax.tree.map(lambda a: a, tree)
    short["blocks"]["ln1"]["scale"] = short["blocks"]["ln1"]["scale"][:1]
    with pytest.raises(ValueError, match="layers stacked"):
        params_from_jax(short, tcfg)


# ------------------------------------------------------------------ families
def shape_tree(tree, path=()):
    """{"a/b": shape} of every leaf of a nested dict of arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(shape_tree(v, path + (k,)))
        else:
            out["/".join(path + (k,))] = tuple(v.shape)
    return out


@pytest.mark.parametrize("arch", jcfgs.ARCH_IDS + jcfgs.EXTRA_ARCH_IDS)
def test_every_config_runs_with_jax_shapes(arch):
    """Every id of the registry: for an LM config (all of ARCH_IDS), the
    port's init_params, prefill (with seeded patch_embeds for a
    vision_patches config), init_cache, decode_step and loss_fn run on
    the CPU at the reduced config and give JAX's parameter leaves and
    shapes, output shapes and cache trees (JAX's traced by
    jax.eval_shape). `hiaer_snn_40b` (EXTRA_ARCH_IDS) names the SNN
    step the dry-run lowers, no LM config in either package."""
    if arch not in jcfgs.ARCH_IDS:
        for get in (jcfgs.get_reduced, get_reduced):
            with pytest.raises(ModuleNotFoundError):
                get(arch)
        return
    jcfg, tcfg = jcfgs.get_reduced(arch), get_reduced(arch)
    B, S, T = 2, 12, 20
    rng = np.random.default_rng(len(arch))
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S))}
    if jcfg.frontend == "vision_patches":
        batch["patch_embeds"] = rng.normal(
            0, 1, (B, jcfg.n_patch_tokens, jcfg.d_model)).astype(np.float32)
    tok = batch["tokens"][:, :1]
    with mesh_context(make_local_mesh()):
        jp = jax.eval_shape(lambda: jlm.init_params(
            jcfg, jax.random.PRNGKey(0), jnp.float32))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jl, jc = jax.eval_shape(lambda p: jlm.prefill(p, jcfg, jb), jp)
        jdl, jdc = jax.eval_shape(
            lambda p: jlm.decode_step(p, jcfg, jnp.asarray(tok),
                                      jlm.init_cache(jcfg, B, T, jnp.float32),
                                      jnp.int32(3)), jp)
        jloss = jax.eval_shape(lambda p: jlm.loss_fn(p, jcfg, jb)[0], jp)
    model = tlm.init_params(tcfg, dtype=torch.float32, device="cpu")
    layers = tlm.segment_layers(tcfg)
    want = {}
    for name, shape in shape_tree(jp).items():
        seg, *rest = name.split("/")
        names = ([".".join([seg, str(i)] + rest) for i in range(shape[0])]
                 if seg in layers else [".".join([seg] + rest)])
        want.update({n: shape[1:] if seg in layers else shape
                     for n in names})
    assert {n: tuple(t.shape) for n, t in model.state_dict().items()} \
        == want
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    lt, ct = tlm.prefill(model, tcfg, tb)
    assert lt.shape == jl.shape and bool(torch.isfinite(lt).all())
    assert shape_tree(ct) == shape_tree(jc)
    cache = tlm.init_cache(tcfg, B, T, torch.float32, device="cpu")
    assert shape_tree(cache) == shape_tree(jdc)
    dl, dc = tlm.decode_step(model, tcfg, torch.from_numpy(tok), cache, 3)
    assert dl.shape == jdl.shape and shape_tree(dc) == shape_tree(jdc)
    loss, _ = tlm.loss_fn(model, tcfg, tb)
    assert loss.shape == jloss.shape and bool(torch.isfinite(loss))

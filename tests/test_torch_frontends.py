"""The port's modality frontends (`models.lm._embed_input` and what
follows from it) against the JAX package's, on the CPU, at the reduced
configs: LLaVA-NeXT-Mistral-7B's `vision_patches` (2 layers, GQA 4 / 2,
8 patch embeddings before the text, seeded with numpy, as the vision
tower is a stub in both packages) and MusicGen-Medium's `audio_tokens`
(2 layers, MHA 4 heads, LayerNorm, non-gated GELU, sinusoidal positions
added to the token embeddings). Prefill logits and K/V caches (over
n_patch + S positions for LLaVA), decode steps after the prefill, the
loss over the text positions only and every gradient, each Server's
greedy tokens, and the serving and training CLIs of the three configs
ported with them (DeepSeek-V2's MLA: `test_torch_mla.py`). Both packages
compute in fp32 on the same weights (JAX's, moved over with
`params_from_jax`); tolerances as in `test_torch_lm.py`: 1e-5 on the
embeddings and the loss, 1e-4 on logits, caches and gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pair import lm_pair
from repro.distributed.context import mesh_context
from repro.launch import serve as jserve
from repro.launch.mesh import make_local_mesh
from repro.models import lm as jlm
from repro_torch.configs import get_reduced
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models.weights import params_from_jax
from repro_torch.optim.adamw import named_leaves

LLAVA, MUSICGEN = "llava_next_mistral_7b", "musicgen_medium"
ARCHS = [LLAVA, MUSICGEN]
FN_TOL = 1e-5
TOL = 1e-4


def err(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) if got.size else 0.0


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return lm_pair(request.param, seed=17)


def batch_of(cfg, B, S, seed, patches=True):
    """Token ids and, for a vision_patches config, seeded patch
    embeddings (B, n_patch_tokens, d) of RMS ~1, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    if patches and cfg.frontend == "vision_patches":
        batch["patch_embeds"] = rng.normal(
            0, 1, (B, cfg.n_patch_tokens, cfg.d_model)).astype(np.float32)
    return batch


def j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_frontends_are_the_configs_own():
    for arch, frontend, pos in ((LLAVA, "vision_patches", "rope"),
                                (MUSICGEN, "audio_tokens", "sinusoidal")):
        cfg = get_reduced(arch)
        assert (cfg.frontend, cfg.pos) == (frontend, pos)
    assert get_reduced(LLAVA).n_patch_tokens == 8


def test_embed_input_matches_jax(pair):
    """The embeddings the first block sees: LLaVA's patches, cast and put
    before the tokens; MusicGen's tokens plus the sinusoidal positions."""
    jcfg, tcfg, tree, model = pair
    batch = batch_of(tcfg, 2, 11, 1)
    S_total = 11 + tlm._n_patch(tcfg, batch)
    assert S_total == 11 + (8 if tcfg.frontend == "vision_patches" else 0)
    pos = np.arange(S_total)
    want = jlm._embed_input({"embed": jax.tree.map(jnp.asarray,
                                                   tree["embed"])},
                            jcfg, j(batch), jnp.asarray(pos))
    got = tlm._embed_input(model, tcfg, t(batch), torch.from_numpy(pos))
    assert err(got, want) <= FN_TOL


def test_prefill_matches_jax(pair):
    """Last-token logits and K/V caches; LLaVA's over the patch positions
    and the text's, and over the text's alone without patches."""
    jcfg, tcfg, tree, model = pair
    B, S = 2, 29
    for patches in (True, False)[:1 + (tcfg.frontend == "vision_patches")]:
        batch = batch_of(tcfg, B, S, 2, patches)
        with mesh_context(make_local_mesh()):
            lj, cj = jlm.prefill(tree, jcfg, j(batch))
        lt, ct = tlm.prefill(model, tcfg, t(batch))
        assert err(lt, lj) <= TOL
        S_total = S + (tcfg.n_patch_tokens if patches
                       and tcfg.frontend == "vision_patches" else 0)
        for n in ("k", "v"):
            assert ct["blocks"][n].shape == (tcfg.n_layers, B, S_total,
                                             tcfg.n_kv_heads,
                                             tcfg.resolved_head_dim)
            assert err(ct["blocks"][n], cj["blocks"][n]) <= TOL, n


def test_decode_after_prefill_matches_jax(pair):
    """Four decode steps from the prefill's caches (LLaVA's after its
    patches: positions go on from n_patch + S), extended with zero rows,
    both packages fed JAX's greedy tokens."""
    jcfg, tcfg, tree, model = pair
    B, S = 2, 13
    batch = batch_of(tcfg, B, S, 3)
    S_total = S + tlm._n_patch(tcfg, batch)
    T = S_total + 4
    with mesh_context(make_local_mesh()):
        lj, cj = jlm.prefill(tree, jcfg, j(batch))
    lt, ct = tlm.prefill(model, tcfg, t(batch))

    def extend(cache):
        return {n: np.concatenate([np.asarray(a), np.zeros(
            a.shape[:2] + (T - S_total,) + a.shape[3:], np.float32)], 2)
            for n, a in cache["blocks"].items()}
    jc = {"blocks": {n: jnp.asarray(a) for n, a in extend(cj).items()}}
    tc = {"blocks": {n: torch.from_numpy(a) for n, a in extend(ct).items()}}
    tok = np.asarray(lj)[:, :jcfg.vocab_size].argmax(1)[:, None]
    with mesh_context(make_local_mesh()):
        step = jax.jit(lambda p, x, c, i: jlm.decode_step(p, jcfg, x, c, i))
        for pos in range(S_total, T):
            lj, jc = step(tree, jnp.asarray(tok), jc, jnp.int32(pos))
            lt, tc = tlm.decode_step(model, tcfg, torch.from_numpy(tok), tc,
                                     pos)
            assert err(lt, lj) <= TOL, pos
            for n in ("k", "v"):
                assert err(tc["blocks"][n], jc["blocks"][n]) <= TOL, (pos, n)
            tok = np.asarray(lj)[:, :jcfg.vocab_size].argmax(1)[:, None]


def test_loss_and_grads_match_jax(pair):
    """Loss and every gradient leaf of jax.value_and_grad(lm.loss_fn), with
    LLaVA's patches before the text: the loss reads the text positions
    only, so it is the chunked CE of the backbone's last S rows."""
    jcfg, tcfg, tree, model = pair
    B, S = 2, 24
    batch = batch_of(tcfg, B, S, 4)
    batch["loss_mask"] = (np.random.default_rng(5).random((B, S)) < 0.8) \
        .astype(np.float32)
    with mesh_context(make_local_mesh()):
        (jv, jparts), jg = jax.jit(jax.value_and_grad(
            lambda p, b: jlm.loss_fn(p, jcfg, b), has_aux=True))(
            jax.tree.map(jnp.asarray, tree), j(batch))
    want = params_from_jax(jax.tree.map(np.asarray, jg), tcfg)
    leaves = named_leaves(model)
    loss, parts = tlm.loss_fn(model, tcfg, t(batch))
    assert err(loss, jv) <= FN_TOL and err(parts["ce"], jparts["ce"]) \
        <= FN_TOL
    g = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert set(g) == set(want)
    for n in want:
        assert err(g[n], want[n]) <= TOL, n
    with torch.no_grad():
        h = tlm.backbone(model, tcfg, t(batch))[0]
        assert h.shape[1] == S + tlm._n_patch(tcfg, batch)
        tok = torch.from_numpy(batch["tokens"])
        mask = torch.from_numpy(batch["loss_mask"]).clone()
        mask[:, -1] = 0.0
        ce = tlm.chunked_ce_loss(model.embed, h[:, -S:],
                                 torch.roll(tok, -1, dims=1), mask, tcfg)
    assert err(ce, parts["ce"].detach().numpy()) <= FN_TOL


def test_server_gives_jax_greedy_tokens(pair):
    """The slot Server on JAX's Server's weights (tokens only, as both
    launchers feed them): the same greedy tokens, positions and slots,
    and the caches within 1e-4 after every admit and tick."""
    jcfg, tcfg = pair[:2]
    prompt_len, max_new, n = 5, 4, 2
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
        for k in ("k", "v"):
            assert err(ts.cache["blocks"][k], js.cache["blocks"][k]) <= TOL
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


@pytest.mark.parametrize("arch", ["deepseek_v2_236b"] + ARCHS)
def test_launch_clis_run(arch, capsys):
    """`python -m repro_torch.launch.serve` and `.train` run each config
    of this slice at its reduced size on the CPU."""
    total = tserve.main(["--arch", arch, "--reduced", "--requests", "2",
                         "--max-new", "3", "--prompt-len", "4",
                         "--device", "cpu"])
    assert total == 6
    loss = ttrain.main(["--arch", arch, "--reduced", "--device", "cpu",
                        "--steps", "2", "--batch", "2", "--seq", "16",
                        "--log-every", "1"])
    out = capsys.readouterr().out
    assert "served 2 requests, 6 tokens" in out and "step 1:" in out
    assert np.isfinite(loss)

"""The model axis (ROADMAP items 10.3b and 10.3c): the port's
tensor-parallel families held to JAX on the same (data, model) meshes,
on the CPU.

JAX runs each case of `tests/_torch_dist_ranks.py`'s `TP_CASES` on
virtual devices (`tests/_jax_dist_ref.py tp`: jitted
`make_prefill_step`, `make_decode_step` and `make_train_step` with the
case's layout, parameters placed by `params_specs`, the batch by
`batch_specs`, caches by `cache_specs`, moments by `opt_specs`); the
port runs the same cases as four gloo ranks (`_torch_dist_ranks.py
tp`), each holding its blocks (`ShardingRules.held_spec`), and the
blocks are assembled here. The cases cover reduced qwen2_5_3b (KV
replicated at tp = 4), qwen2_7b (KV sharded at tp = 2), gemma_7b,
llava_next_mistral_7b, musicgen_medium and deepseek_moe_16b, on (1, 2),
(1, 4) and (2, 2) in "heads" and "seq"; llama3_405b with FSDP on (2, 2)
with its published sequence-parallel residual; deepseek_v2_236b's MLA on
(1, 4) and with FSDP on (2, 2); mamba2_780m on (1, 4) and (2, 2);
recurrentgemma_2b in "heads" on (1, 2) (its gate blocks divided over
'model') and in "seq" on (1, 4) (6 heads, its window reaching over the
ranks' blocks, its one gate block cut by the ranks' channels); and
prefills at S = 4,096 decoded into T = 8,192 caches held over 'model'
(the 2-D cache: qwen2_7b's K/V, DeepSeek-V2's compressed rows).
`W1_DECODE`'s decode (DeepSeek-V2 with FSDP on (2, 2)) is held to the
port at world size 1: JAX's FSDP MoE decode adds the data shards'
different rows in its shared experts (ROADMAP §3).

Tolerances (fp32, as chip_smoke.py's phase 25(b)): the loss within
1e-5; each gradient within 1e-4 of its largest magnitude; logits,
caches and moments within 1e-5 of max(1, their largest magnitude);
parameters within 1e-5 where Adam's step is well-conditioned
(`test_train_step_matches_jax`'s rule) and within 2 lr elsewhere, the
ill-conditioned elements under 1 % (under 5 % for the hybrid, the cap
of its own single-device test, tests/test_torch_hybrid.py). The 2-D
cache's V (and MLA's c_kv) is held to JAX within 1e-5, its K (MLA's
k_rope) to the port at world size 1 within 1e-5 and to JAX within
`ROPE_TOL`: RoPE at positions past 2,048 differs between the two
packages by 1.26e-5 of |K| at world size 1 already (sin and cos of
large angles, the frequencies' last bit).
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

from _torch_dist_ranks import (OC, TP_SERVE, TP_TICKS,  # noqa: E402
                               W1_DECODE, tp_cases, tp_cfg, world_one)
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.distributed.context import Mesh  # noqa: E402
from repro_torch.launch.sharding import (ShardingRules,  # noqa: E402
                                         assemble, shard_params)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402

CASES = tp_cases()
TRAINED = [c for c in CASES if c["train"]]
TWO_D = [c for c in CASES if "cache2d" in c["name"]]
TOL, GRAD_TOL = 1e-5, 1e-4
ROPE_TOL = 2e-5         # the 2-D cache's K against JAX (the docstring)
LR1 = 1e-2 / OC["warmup_steps"]         # the first step's learning rate


JAX_PROCS = 2           # JAX's side in two processes, beside the ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's side (`JAX_PROCS` processes, each a share of the cases) and
    the port's four ranks, all at once: neither reads the other."""
    d = tmp_path_factory.mktemp("tp")
    cmds = [[sys.executable, str(ROOT / "tests" / "_jax_dist_ref.py"), "tp",
             str(d), f"{i}/{JAX_PROCS}"] for i in range(JAX_PROCS)]
    cmds.append([sys.executable, str(ROOT / "tests" / "_torch_dist_ranks.py"),
                 "tp", str(d), str(d / "store")])
    logs = [d / f"proc{i}.log" for i in range(len(cmds))]
    procs = []
    try:
        for cmd, log in zip(cmds, logs):     # a file each: no pipe fills
            with open(log, "w") as f:
                procs.append(subprocess.Popen(cmd, stdout=f,
                                              stderr=subprocess.STDOUT,
                                              cwd=str(ROOT)))
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.read_text()[-6000:]
    jax_out = {}
    for i in range(JAX_PROCS):
        with np.load(d / f"jax_tp{i}.npz") as f:
            jax_out.update({k: f[k] for k in f.files})
    return _Npz(jax_out), [np.load(d / f"rank{r}.npz") for r in range(4)]


class _Npz(dict):
    """The JAX processes' outputs merged: an npz's `files` and `[key]`."""

    @property
    def files(self):
        return list(self)


def _case(c):
    cfg = tp_cfg(get_reduced, c)
    mesh = Mesh(tuple(c["shape"]), ("data", "model"))
    return cfg, mesh, ShardingRules(cfg, mesh, c["layout"])


def _rows(c, ranks, key):
    """Rows gathered over the data ranks (the model ranks hold them
    whole)."""
    tp = c["shape"][1]
    n = int(np.prod(c["shape"]))
    return np.concatenate([ranks[r][key] for r in range(0, n, tp)])


def _near(got, want, tol=TOL):
    gap = float(np.abs(got - want).max())
    assert gap <= tol * max(1.0, float(np.abs(want).max())), gap


def _caches(c, jax_out, ranks, kind):
    """{key: (port assembled by `cache_specs`, JAX)} of one case's
    prefill ("cache") or decoded ("decoded") caches."""
    _, mesh, rules = _case(c)
    n = mesh.size
    out = {}
    for k in jax_out.files:
        if k.startswith(f"{c['name']}/{kind}/"):
            want = jax_out[k]
            spec = rules.cache_specs({"x": want.shape})["x"]
            out[k] = (assemble([ranks[r][k] for r in range(n)], spec,
                               want.shape, mesh), want)
    assert out
    return out


def _nest(out, prefix):
    tree = {}
    for k in out.files:
        if k.startswith(prefix):
            *path, leaf = k[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = out[k]
    return tree


def _leaves(c, jax_out, ranks, kind):
    """{name: (port assembled from the held blocks, JAX)} of one case's
    gradients, parameters or moments."""
    cfg, mesh, rules = _case(c)
    want = params_from_jax(_nest(jax_out, f"{c['name']}/{kind}/"), cfg)
    out = {}
    for n, w in want.items():
        w = w.numpy()
        spec = rules.held_moment_spec(n, w.shape) if kind in ("mu", "nu") \
            else rules.held_spec(n, w.shape)
        out[n] = (assemble([ranks[r][f"{c['name']}/{kind}/{n}"]
                            for r in range(mesh.size)], spec, w.shape,
                           mesh), w)
    return out


def _cache_tol(c, key):
    return ROPE_TOL if c in TWO_D and key.endswith(("/k", "/k_rope")) \
        else TOL


@pytest.mark.parametrize("c", CASES, ids=[c["name"] for c in CASES])
def test_prefill_logits_and_caches_match_jax(runs, c):
    jax_out, ranks = runs
    _near(_rows(c, ranks, f"{c['name']}/logits"),
          jax_out[f"{c['name']}/logits"])
    for k, (got, want) in _caches(c, jax_out, ranks, "cache").items():
        _near(got, want, _cache_tol(c, k))


@pytest.mark.parametrize("c", CASES, ids=[c["name"] for c in CASES])
def test_decode_ticks_match_jax(runs, c):
    """Every tick's logits and the caches after them: held to JAX, and
    for `W1_DECODE` to the port at world size 1 (the module
    docstring)."""
    jax_out, ranks = runs
    name, one = c["name"], world_one(c)
    w1 = name in W1_DECODE
    for t in range(TP_TICKS):
        want = ranks[0][f"{one}/tick{t}"] if w1 else \
            jax_out[f"{name}/tick{t}"]
        _near(_rows(c, ranks, f"{name}/tick{t}"), want)
    for k, (got, want) in _caches(c, jax_out, ranks, "decoded").items():
        if w1:
            want = ranks[0][k.replace(name, one, 1)]
        _near(got, want, _cache_tol(c, k))


@pytest.mark.parametrize("c", TWO_D, ids=[c["name"] for c in TWO_D])
def test_2d_cache_equals_world_one(runs, c):
    """The 2-D cache's rows (each rank 2,048 of the prefill's 4,096, then
    4,096 of the 8,192 decode rows) assembled equal the port's world
    size 1 run within 1e-5, and every tick's logits too."""
    jax_out, ranks = runs
    name, w1 = c["name"], world_one(c)
    assert c["max_len"] == 8192 and c["shape"] == (1, 2)
    for kind in ("cache", "decoded"):
        for k, (got, _) in _caches(c, jax_out, ranks, kind).items():
            one = ranks[0][k.replace(name, w1, 1)]
            assert ranks[1][k].shape[2] * 2 == one.shape[2], k
            _near(got, one)
    for t in range(TP_TICKS):
        _near(_rows(c, ranks, f"{name}/tick{t}"), ranks[0][f"{w1}/tick{t}"])


def test_backward_on_a_thread_without_the_mesh_context(runs):
    """Autograd runs a CUDA backward, and each layer checkpoint's
    recompute with it, on a thread of its own that opened no mesh
    context: there the recompute must see the forward's mesh (it saw the
    trivial one, skipped its collectives and gave wrong gradients on the
    card). The gradients taken on a fresh thread equal the step's."""
    _, ranks = runs
    for r in (0, 1):
        keys = [k for k in ranks[r].files if k.startswith("threaded/grad/")]
        assert keys
        for k in keys:
            want = ranks[r][k.replace("threaded", "qwen2_heads_1x2")]
            got = ranks[r][k]
            assert np.abs(got - want).max() <= 1e-6 * max(
                1.0, np.abs(want).max()), (r, k)


@pytest.mark.parametrize("arch,shape,layout", TP_SERVE,
                         ids=[f"{a}-{s[1]}-{l}" for a, s, l in TP_SERVE])
def test_server_on_the_model_axis_equals_world_one(runs, arch, shape,
                                                   layout):
    """A 2-slot `Server` on a (1, tp) mesh (every rank the same server,
    its held blocks, the tensor-parallel decode) gives every rank the
    greedy tokens of the world size 1 server."""
    _, ranks = runs
    want = ranks[0][f"serve/{arch}/w1"]
    assert want.shape == (2, 4)
    for r in range(int(np.prod(shape))):
        assert np.array_equal(ranks[r][f"serve/{arch}/{layout}"], want), r


@pytest.mark.parametrize("c", TRAINED, ids=[c["name"] for c in TRAINED])
def test_train_step_matches_jax(runs, c):
    """Loss, every assembled gradient, the parameters and moments after
    one AdamW step (the ill-conditioned share under the family's own
    cap: the module docstring)."""
    jax_out, ranks = runs
    name = c["name"]
    for r in range(int(np.prod(c["shape"]))):
        assert abs(float(ranks[r][f"{name}/loss"])
                   - float(jax_out[f"{name}/loss"])) <= TOL
    for n, (got, want) in _leaves(c, jax_out, ranks, "grad").items():
        assert np.abs(want).max() > 0, n
        assert np.abs(got - want).max() <= GRAD_TOL * np.abs(want).max(), n
    for k in ("mu", "nu"):
        for n, (got, want) in _leaves(c, jax_out, ranks, k).items():
            _near(got, want)
    nu = _leaves(c, jax_out, ranks, "nu")
    n_ill = n_all = 0
    for n, (got, want) in _leaves(c, jax_out, ranks, "params").items():
        v = nu[n][1]
        gap = np.abs(got - want)
        well = (v == 0) | (np.sqrt(v / (1 - 0.95)) >= 1e-6)
        assert gap[well].max(initial=0) <= TOL, n
        assert gap.max() <= 2 * LR1, n
        n_ill += int((~well).sum())
        n_all += gap.size
    cap = 5e-2 if c["arch"] == "recurrentgemma_2b" else 1e-2
    assert n_ill < cap * n_all, (n_ill, n_all)


# a (1, 2) mesh's rank 1's blocks of reduced configs: {path: shape}
HELD = {
    "qwen2_5_3b": {"blocks.0.attn.wq": (64, 2, 16),
                   "blocks.0.attn.wk": (64, 1, 16),
                   "blocks.0.mlp.w_out": (128, 64),
                   "embed.table": (128, 64), "blocks.0.ln1.scale": (64,)},
    "deepseek_v2_236b": {"blocks.0.attn.w_uq": (48, 2, 24),
                         "blocks.0.attn.w_uv": (32, 2, 16),
                         "blocks.0.attn.w_o": (2, 16, 64),
                         "blocks.0.attn.w_dkv": (64, 40),
                         "blocks.0.moe.w_in": (4, 64, 64)},
    "mamba2_780m": {"blocks.0.ssm.w_out": (64, 64),
                    "blocks.0.ssm.w_in": (64, 292),
                    "blocks.0.ssm.a_log": (4,),
                    "blocks.0.ssm.out_norm.scale": (128,)},
    "recurrentgemma_2b": {"groups.0.rec1.rec.w_x": (64, 32),
                          "groups.0.rec1.rec.lam": (32,),
                          "groups.0.rec1.rec.conv_w": (4, 64),
                          "groups.0.rec1.rec.w_i": (1, 64, 64),
                          "groups.0.rec1.rec.w_out": (32, 64),
                          "groups.0.attn.attn.wq": (64, 2, 16)},
}


@pytest.mark.parametrize("arch", list(HELD))
def test_held_blocks_cut_the_whole_model(arch):
    """`lm.init_params(..., mesh=)` draws each leaf whole and keeps the
    rank's block: the blocks equal `shard_params` of the whole model of
    the same seed, on every rank, in both layouts; and a (1, 2) rank
    holds `HELD`'s blocks."""
    cfg = get_reduced(arch)
    whole = lm.init_params(cfg, 3, torch.float32, "cpu").state_dict()
    for layout in ("heads", "seq"):
        for r in range(4):
            mesh = Mesh((2, 2), ("data", "model"), rank=r)
            got = lm.init_params(cfg, 3, torch.float32, "cpu", mesh=mesh,
                                 layout=layout).state_dict()
            want = shard_params(whole, cfg, mesh, layout)
            assert got.keys() == want.keys()
            for n in want:
                assert torch.equal(got[n], want[n]), (layout, r, n)
    m = Mesh((1, 2), ("data", "model"), rank=1)
    held = lm.init_params(cfg, 3, torch.float32, "cpu", mesh=m).state_dict()
    for n, shape in HELD[arch].items():
        assert tuple(held[n].shape) == shape, n


@pytest.mark.parametrize("H,KV,tp,want", [
    (16, 2, 4, [[0], [0], [1], [1]]),          # groups of 8 over 4 ranks
    (4, 2, 4, [[0], [0], [1], [1]]),
    (24, 6, 4, [[0, 0, 0, 0, 1, 1], [1, 1, 2, 2, 2, 2], [3, 3, 3, 3, 4, 4],
                [4, 4, 5, 5, 5, 5]]),          # uneven: one a query head
    (12, 3, 2, [[0, 0, 0, 0, 1, 1], [1, 1, 2, 2, 2, 2]]),
    (16, 4, 2, [[0, 1], [2, 3]]),
])
def test_replicated_kv_heads_of_each_rank(H, KV, tp, want):
    """A rank's query heads read global KV head (rank H/tp + h) //
    (H/KV) of K/V held whole: one per even group of local heads, else
    one per local head."""
    import dataclasses
    cfg = dataclasses.replace(get_reduced("qwen2_5_3b"), n_heads=H,
                              n_kv_heads=KV)
    assert [tattn._kv_heads(cfg, tp, r) for r in range(tp)] == want


def test_fsdp_dims_are_the_residual_dim():
    """An FSDP config holds its residual dim over 'data' (JAX's `_f`),
    which the backbone gathers before each layer; a TP config and a
    model axis of size 1 gather nothing over 'data' but FSDP leaves."""
    import dataclasses
    cfg = dataclasses.replace(get_reduced("llama3_405b"), fsdp=True)
    dims = lm._fsdp_dims(cfg, (2, 2), ("data", "model"), "heads")
    assert dims["blocks.0.attn.wq"] == 0 and dims["blocks.0.attn.wo"] == 2
    assert dims["blocks.0.mlp.w_out"] == 1 and dims["embed.table"] == 1
    assert "blocks.0.ln1.scale" not in dims
    assert lm._fsdp_dims(get_reduced("llama3_405b"), (2, 2),
                         ("data", "model"), "heads") == {}

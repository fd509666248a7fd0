"""The port's LM training path (dense family) against the JAX package's,
on the CPU: `chunked_ce_loss`; `loss_fn` and its gradients with remat on
and off; `make_train_step` (AdamW, clipping, the cosine schedule,
microbatches) over three steps; the token pipeline; the training
launcher with checkpoint and resume; the checkpoint store; the step
watchdog. Both packages compute in fp32 on the same weights (JAX's,
moved over with `params_from_jax`; JAX's AdamW state with
`opt_state_from_jax`). Tolerances are absolute, on a loss of ~6 and
gradients up to ~0.3: 1e-5 on the loss and 1e-4 on gradients (reductions
summed in another order), 1e-5 on parameters and moments after three
steps."""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pair import lm_pair
from repro.data.synthetic import TokenPipeline as JPipeline
from repro.distributed.context import mesh_context
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import layers as jl
from repro.models import lm as jlm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch.checkpoint import CheckpointManager, restore_tree, save_tree
from repro_torch.configs import get_reduced
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.distributed.elastic import StepWatchdog
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_train_step
from repro_torch.models import layers as tl
from repro_torch.models import lm as tlm
from repro_torch.models.weights import opt_state_from_jax, params_from_jax
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import global_norm, named_leaves


def err(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want))) if got.size else 0.0


def jnp_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


# ------------------------------------------------------------------ the loss
class Emb:
    def __init__(self, table):
        self.table = table


@pytest.mark.parametrize("S,chunk,masked", [(60, 16, False), (37, 8, True),
                                            (64, 512, True)])
def test_chunked_ce_loss_matches_jax(S, chunk, masked):
    """Values and gradients (h and the tied table) with the divisor
    search (60 -> 15, 37 -> 1), vocab padding (200 of 256 rows) and a
    loss mask."""
    cfg = dataclasses.replace(get_reduced("qwen2_5_3b"), vocab_size=200,
                              loss_chunk=chunk)
    rng = np.random.default_rng(S)
    B, d, vp = 2, cfg.d_model, tl.padded_vocab(cfg)
    h = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    table = rng.normal(0, 0.2, (vp, d)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (B, S))
    mask = (rng.random((B, S)) < 0.7 if masked
            else np.ones((B, S))).astype(np.float32)

    def jloss(table, h):
        return jl.chunked_ce_loss({"table": table}, h, jnp.asarray(labels),
                                  jnp.asarray(mask), cfg)
    jv, (jgt, jgh) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(table), jnp.asarray(h))
    tt = torch.from_numpy(table).requires_grad_()
    th = torch.from_numpy(h).requires_grad_()
    tv = tl.chunked_ce_loss(Emb(tt), th, torch.from_numpy(labels),
                            torch.from_numpy(mask), cfg)
    gt, gh = torch.autograd.grad(tv, (tt, th))
    assert tv.dtype == torch.float32 and tv.shape == ()
    assert err(tv, jv) < 1e-5
    assert err(gt, jgt) < 1e-4 and err(gh, jgh) < 1e-4
    with torch.no_grad():
        assert err(tl.chunked_ce_loss(Emb(tt), th, torch.from_numpy(labels),
                                      torch.from_numpy(mask), cfg), jv) < 1e-5


def grads_by_name(tree, tcfg):
    return params_from_jax(jax.tree.map(np.asarray, tree), tcfg)


@pytest.mark.parametrize("arch", ["qwen2_5_3b", "qwen2_7b"])
def test_loss_fn_and_grads_match_jax(arch):
    """Loss within 1e-5 and every gradient leaf within 1e-4 of
    jax.value_and_grad(lm.loss_fn); the port's remat on and off give
    the same gradients."""
    jcfg, tcfg, tree, model = lm_pair(arch, seed=4)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 64))
    lmask = (rng.random((2, 64)) < 0.8).astype(np.float32)
    batch = {"tokens": tokens, "loss_mask": lmask}
    with mesh_context(make_local_mesh()):
        (jv, jparts), jg = jax.value_and_grad(
            lambda p: jlm.loss_fn(p, jcfg, jnp_tree(batch)), has_aux=True)(
            jnp_tree(tree))
    want = grads_by_name(jg, tcfg)
    leaves = named_leaves(model)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = {}
    for remat in (True, False):
        loss, parts = tlm.loss_fn(
            model, dataclasses.replace(tcfg, remat=remat), tbatch)
        assert err(loss, jv) < 1e-5 and err(parts["ce"], jparts["ce"]) < 1e-5
        assert float(parts["aux"]) == 0.0
        got[remat] = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
    assert set(got[True]) == set(want)
    for n in want:
        assert torch.equal(got[True][n], got[False][n]), n
        assert err(got[True][n], want[n]) < 1e-4, n


ILL = 1e-6     # sqrt(nu_hat) under 100 * eps: Adam's step is ill-conditioned


@pytest.mark.parametrize("arch,microbatches,remat",
                         [("qwen2_5_3b", 1, True), ("qwen2_5_3b", 2, False),
                          ("qwen2_7b", 1, False), ("qwen2_7b", 2, True)])
def test_train_step_matches_jax(arch, microbatches, remat):
    """Three steps of the port's make_train_step against JAX's jitted
    step, from the same parameters and AdamW state, with an update that
    shows (lr 1e-2, warmup 2): equal step counters; losses, grad norms,
    mu and nu within 1e-5 after every step; parameters within 1e-5 on
    every element whose Adam step was well-conditioned at every step.

    Where 0 < sqrt(nu_hat) < 1e-6 = 100 eps, the step g / (|g| + eps) turns
    the ~1e-8 difference that reassociated fp32 sums leave in a gradient
    into a parameter difference of order lr (the k-bias entries of the
    slow RoPE frequencies, whose gradient cancels to ~1e-8 through the
    softmax's shift invariance, and a few MLP weights). Those elements
    are counted (under 1 % of the parameters) and held to 2 lr per
    step, the most two such steps can differ."""
    jcfg, tcfg, tree, model = lm_pair(arch, seed=6)
    jcfg = dataclasses.replace(jcfg, remat=remat)
    tcfg = dataclasses.replace(tcfg, remat=remat)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    joc, toc = JAdamWConfig(**kw), AdamWConfig(**kw)
    pipe = TokenPipeline(jcfg.vocab_size, 32, 4, seed=3)
    well, lr_sum = None, 0.0
    with mesh_context(make_local_mesh()):
        jp = jnp_tree(tree)
        jopt = jadamw_init(jp, joc)
        topt = opt_state_from_jax(jax.tree.map(np.asarray, jopt), tcfg)
        jstep = jax.jit(jmake_train_step(jcfg, joc,
                                         microbatches=microbatches))
        tstep = make_train_step(tcfg, toc, microbatches=microbatches,
                                device="cpu")
        for t in range(1, 4):
            batch = pipe.next_batch()
            jp, jopt, jm = jstep(jp, jopt, jnp_tree(batch))
            model, topt, tm = tstep(model, topt, batch)
            for k in ("loss", "grad_norm", "lr"):
                assert err(tm[k], jm[k]) < 1e-5, k
            assert int(topt["step"]) == int(jopt["step"]) == t
            for name in ("mu", "nu"):
                want = grads_by_name(jopt[name], tcfg)
                for n in want:
                    assert err(topt[name][n], want[n]) < 1e-5, (name, n)
            nu = grads_by_name(jopt["nu"], tcfg)
            nu_hat = {n: (v == 0)
                      | (torch.sqrt(v / (1 - joc.b2 ** t)) >= ILL)
                      for n, v in nu.items()}
            well = nu_hat if well is None else \
                {n: well[n] & nu_hat[n] for n in well}
            lr_sum += float(jm["lr"])
    state, want = model.state_dict(), grads_by_name(jp, tcfg)
    n_ill = n_all = 0
    for n in want:
        gap = (state[n] - want[n]).abs()
        assert float(torch.where(well[n], gap, 0.0).max()) < 1e-5, n
        assert float(gap.max()) <= 2 * lr_sum, n
        n_ill += int((~well[n]).sum())
        n_all += gap.numel()
    assert n_ill < 1e-2 * n_all, (n_ill, n_all)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_global_norm_is_exact_on_large_leaves(dtype):
    """The global norm of leaves of millions of elements within 1e-6 of
    the float64 sum of squares, as JAX's fp32 `jnp.sum` gives it."""
    g = torch.Generator().manual_seed(0)
    grads = {"a": (torch.randn((1 << 22) + 12345, generator=g) * 1e-3)
             .to(dtype),
             "b": torch.randn(3, 5, generator=g).to(dtype)}
    want = sum(float(t.double().square().sum()) for t in grads.values())
    got = float(global_norm(grads))
    assert abs(got - want ** 0.5) <= 1e-6 * want ** 0.5


def test_train_step_takes_no_compressor_yet():
    """`make_train_step(compressor=...)` (it raised before the
    distribution slice): the compressor gets every leaf's gradient once
    a step and AdamW sees what it returns — zeros leave mu, nu and the
    grad norm at 0."""
    cfg = get_reduced("qwen2_5_3b")
    model = tlm.init_params(cfg, 2, torch.float32, "cpu")
    opt = adamw_init(model, AdamWConfig())
    seen = []

    def zero(grads):
        seen.append(set(grads))
        return {n: torch.zeros_like(g) for n, g in grads.items()}
    step = make_train_step(cfg, AdamWConfig(), compressor=zero, device="cpu")
    batch = TokenPipeline(cfg.vocab_size, 16, 2, seed=1).next_batch()
    _, opt, m = step(model, opt, batch)
    assert seen == [set(named_leaves(model))]
    assert float(m["grad_norm"]) == 0.0
    assert all(float(t.abs().max()) == 0.0 for k in ("mu", "nu")
               for t in opt[k].values())


# ------------------------------------------------------------------ data
def test_token_pipeline_matches_jax():
    jp, tp = JPipeline(256, 16, 3, seed=7), TokenPipeline(256, 16, 3, seed=7)
    for _ in range(3):
        a, b = jp.next_batch()["tokens"], tp.next_batch()["tokens"]
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tp.state_dict() == jp.state_dict() == {"seed": 7, "step": 3}
    again = TokenPipeline(256, 16, 3)
    again.load_state_dict({"seed": 7, "step": 1})
    jp.load_state_dict({"seed": 7, "step": 1})
    for _ in range(2):
        assert np.array_equal(again.next_batch()["tokens"],
                              jp.next_batch()["tokens"])


# ------------------------------------------------------------------ launcher
LOG = re.compile(r"^step \d+: loss=\d+\.\d{4} gnorm=\d+\.\d{3} "
                 r"lr=\d\.\d{2}e[-+]\d{2} \(\d+\.\d{2}s\)$")


def train(tmp_path, *extra):
    return ttrain.main(["--arch", "qwen2_5_3b", "--reduced", "--device",
                        "cpu", "--batch", "2", "--seq", "32",
                        "--log-every", "1", *extra])


def test_launch_train_runs_and_logs_like_jax(capsys, tmp_path):
    loss = train(tmp_path, "--steps", "3", "--microbatches", "2")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and all(LOG.match(line) for line in lines), lines
    assert lines[-1].startswith("step 2: loss=")
    assert np.isfinite(loss) and f"loss={loss:.4f}" in lines[-1]


def test_launch_train_resume_is_exact(capsys, tmp_path):
    """Four steps straight give the same parameters and optimizer state,
    bit for bit, as two steps, a restore from --ckpt-dir and two more
    (the schedule is in warmup, so --steps does not change it)."""
    straight = train(tmp_path, "--steps", "4", "--ckpt-dir",
                     str(tmp_path / "a"))
    train(tmp_path, "--steps", "2", "--ckpt-dir", str(tmp_path / "b"))
    capsys.readouterr()
    resumed = train(tmp_path, "--steps", "4", "--ckpt-dir",
                    str(tmp_path / "b"))
    out = capsys.readouterr().out
    assert "[resume] from step 2" in out and "step 0:" not in out
    assert resumed == straight
    a, b = (CheckpointManager(tmp_path / n) for n in "ab")
    assert a.latest_step() == b.latest_step() == 4
    model = tlm.init_params(get_reduced("qwen2_5_3b"), 1, torch.float32,
                            "cpu")
    like = {"params": model.state_dict(),
            "opt": adamw_init(model, AdamWConfig())}
    (ta, aux_a), (tb, aux_b) = a.restore(like), b.restore(like)
    assert aux_a == aux_b == {"seed": 0, "step": 4, "step_counter": 4}
    flat = [(ta["params"], tb["params"]), (ta["opt"]["mu"], tb["opt"]["mu"]),
            (ta["opt"]["nu"], tb["opt"]["nu"])]
    for x, y in flat:
        assert x.keys() == y.keys()
        for n in x:
            assert torch.equal(x[n], y[n]), n
    assert int(ta["opt"]["step"]) == int(tb["opt"]["step"]) == 4


class DeferredThread:
    """A stand-in for `threading.Thread` whose work runs only when it is
    joined: the latest an async save's background write can run."""

    def __init__(self, target, daemon=None):
        self.target = target

    def start(self):
        pass

    def join(self):
        self.target()


def test_launch_train_async_save_is_a_snapshot(capsys, tmp_path,
                                               monkeypatch):
    """An async save at step 2 whose write runs only after steps 3 and 4
    have updated the parameters and moments in place restores, bit for
    bit, what two straight steps give."""
    train(tmp_path, "--steps", "2", "--ckpt-dir", str(tmp_path / "a"))
    monkeypatch.setattr("repro_torch.checkpoint.store.threading.Thread",
                        DeferredThread)
    train(tmp_path, "--steps", "4", "--ckpt-every", "2", "--ckpt-dir",
          str(tmp_path / "b"))
    capsys.readouterr()
    a, b = (CheckpointManager(tmp_path / n) for n in "ab")
    assert b.steps() == [2, 4]
    model = tlm.init_params(get_reduced("qwen2_5_3b"), 1, torch.float32,
                            "cpu")
    like = {"params": model.state_dict(),
            "opt": adamw_init(model, AdamWConfig())}
    (ta, aux_a), (tb, aux_b) = a.restore(like, 2), b.restore(like, 2)
    assert aux_a == aux_b == {"seed": 0, "step": 2, "step_counter": 2}
    for x, y in ((ta["params"], tb["params"]),
                 (ta["opt"]["mu"], tb["opt"]["mu"]),
                 (ta["opt"]["nu"], tb["opt"]["nu"])):
        for n in x:
            assert torch.equal(x[n], y[n]), n
    assert int(ta["opt"]["step"]) == int(tb["opt"]["step"]) == 2


# ------------------------------------------------------------------ checkpoint
def test_checkpoint_round_trips_bf16_exactly(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"params": {"blocks.0.attn.wq": torch.randn(4, 3, 2, generator=g)
                       .to(torch.bfloat16),
                       "embed.table": torch.randn(5, 4, generator=g)},
            "opt": {"mu": {"w": torch.randn(3, generator=g)},
                    "step": torch.tensor(7, dtype=torch.int32)}}
    save_tree(tmp_path / "step_1", tree, aux={"seed": 1})
    assert not (tmp_path / "step_1.tmp").exists()
    raw = np.load(tmp_path / "step_1" / "params__blocks.0.attn.wq.npy")
    assert raw.dtype == np.uint16
    back, aux = restore_tree(tmp_path / "step_1", tree)
    assert aux == {"seed": 1}
    for x, y in ((tree["params"], back["params"]),
                 (tree["opt"]["mu"], back["opt"]["mu"])):
        for n in x:
            assert x[n].dtype == y[n].dtype and torch.equal(x[n], y[n]), n
    assert back["opt"]["step"].dtype == torch.int32
    assert int(back["opt"]["step"]) == 7
    with pytest.raises(KeyError, match="missing"):
        restore_tree(tmp_path / "step_1", {**tree, "extra": tree["opt"]})


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3):
        mgr.save(s, {"x": torch.full((2,), float(s))}, aux={"k": s},
                 async_=(s == 2))
    mgr.wait()
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    tree, aux = mgr.restore({"x": torch.zeros(2)})
    assert aux == {"k": 3, "step": 3} and tree["x"].tolist() == [3.0, 3.0]


# ------------------------------------------------------------------ watchdog
class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("patience", [2, 3])
def test_step_watchdog_flags_stragglers_and_evicts(patience):
    clock = FakeClock()
    wd = StepWatchdog(factor=3.0, patience=patience, clock=clock)

    def step(dt):
        wd.start()
        clock.t += dt
        return wd.stop()
    for _ in range(8):
        info = step(1.0)
        assert not info["straggler"] and not info["evict"]
    assert step(2.9)["straggler"] is False        # under 3x the median
    for i in range(patience):
        info = step(5.0)
        assert info["straggler"] and info["step_s"] == pytest.approx(5.0)
        assert info["evict"] == (i == patience - 1)
    info = step(1.0)
    assert not info["straggler"] and not info["evict"] and wd.strikes == 0

"""Gradient compression (`repro_torch.distributed.compression`) against
the JAX package's, on the CPU: int8 and top-k compress / decompress,
three `ErrorFeedback` steps over a dict of leaves (fp32 and bf16) and
`compressed_bytes`, bit for bit; then `make_train_step(compressor=...)`
over three steps against JAX's `make_train_step` with the same
error-feedback compressor on the same gradients, within
`test_torch_train.py`'s tolerances (1e-4 on the gradients handed over;
1e-5 on the loss, grad norm, mu and nu; parameters within 1e-5 where
Adam's step is well-conditioned). JAX's step runs without `jit` there:
under `jit` the launcher's closure over the residual is traced once, so
every step starts from a zero residual (the port's launcher carries
it)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_pair import lm_pair
from repro.data.synthetic import TokenPipeline as JPipeline
from repro.distributed import compression as jc
from repro.distributed.context import mesh_context
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import make_train_step as jmake_train_step
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch.distributed import compression as tc
from repro_torch.launch.steps import make_train_step
from repro_torch.models.weights import opt_state_from_jax, params_from_jax
from repro_torch.optim import AdamWConfig

SHAPES = [(1000,), (37, 29), (256,), (3,), (4, 64, 5), (512, 3)]


def arr(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, scale, shape).astype(np.float32)
    if x.size > 300:
        x.reshape(-1)[256:512] = 0.0            # an all-zero block
    return x


def same(t, a) -> bool:
    a = np.asarray(a)
    t = t.detach()
    if a.dtype.name == "bfloat16":
        return np.array_equal(t.view(torch.int16).numpy(),
                              a.view(np.int16))
    return t.dtype == torch.from_numpy(a.copy()).dtype and np.array_equal(
        t.numpy(), a)


@pytest.mark.parametrize("shape", SHAPES)
def test_int8_matches_jax_bit_for_bit(shape):
    for seed, scale in ((0, 1.0), (1, 1e-6), (2, 3e4)):
        g = arr(shape, seed, scale)
        q, s, n = jc.int8_compress(jnp.asarray(g))
        tq, ts, tn = tc.int8_compress(torch.from_numpy(g))
        assert same(tq, q) and same(ts, s) and tn == n
        assert same(tc.int8_decompress(tq, ts, tn, g.shape),
                    jc.int8_decompress(q, s, n, g.shape))


@pytest.mark.parametrize("frac", [0.01, 0.05, 0.3, 1.0])
def test_topk_matches_jax_on_ties(frac):
    """Magnitudes repeat (±1, ±2, many zeros): `lax.top_k` takes the
    lower index first among equals, and so does the port's stable sort
    (`torch.topk` leaves ties unordered)."""
    g = np.tile(np.array([1, -1, 1, 0.5, -1, 1, 2, -2, 0, 0, 0, 0],
                         np.float32), 50)
    for x in (g, arr((777,), 3), arr((16, 16), 4)):
        v, i, n = jc.topk_compress(jnp.asarray(x), frac)
        tv, ti, tn = tc.topk_compress(torch.from_numpy(x), frac)
        assert np.array_equal(ti.numpy(), np.asarray(i)) and tn == n
        assert same(tv, v)
        assert same(tc.topk_decompress(tv, ti, tn, x.shape),
                    jc.topk_decompress(v, i, n, x.shape))


@pytest.mark.parametrize("mode", ["int8", "topk"])
def test_error_feedback_three_steps_and_bytes(mode):
    leaves = {"a": (37, 29), "b.w": (1000,), "c": (4, 64, 5)}
    jef, tef = jc.ErrorFeedback(mode, 0.05), tc.ErrorFeedback(mode, 0.05)
    jres = tres = None
    for step in range(3):
        g = {k: arr(s, 10 * step + i) for i, (k, s) in
             enumerate(leaves.items())}
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        jg["bf"] = jnp.asarray(g["a"]).astype(jnp.bfloat16)
        tg["bf"] = torch.from_numpy(g["a"]).to(torch.bfloat16)
        if jres is None:
            jres, tres = jef.init(jg), tef.init(tg)
            assert all(same(tres[k], jres[k]) for k in jg)
        jout, jres = jef.apply(jg, jres)
        tout, tres = tef.apply(tg, tres)
        for k in jg:
            assert same(tout[k], jout[k]), (step, k)
            assert same(tres[k], jres[k]), (step, k)
        assert tout["bf"].dtype == torch.bfloat16
    for frac in (0.01, 0.3):
        assert tc.compressed_bytes(tg, mode, frac) == \
            jc.compressed_bytes(jg, mode, frac)
    with pytest.raises(ValueError):
        tc.ErrorFeedback("fp8")


@pytest.mark.parametrize("mode", ["int8", "topk"])
def test_layers_compress_as_the_stacked_leaf(mode):
    """A segment's per-layer leaves (`blocks.0.x`, `blocks.1.x`, 100
    elements each: int8's blocks straddle the layers) compress as JAX's
    stacked leaf `blocks/x` (2, 100) does, and count once in
    `compressed_bytes`."""
    x = arr((2, 100), 7)
    y = arr((30,), 8)
    jg = {"blocks": {"x": jnp.asarray(x)}, "y": jnp.asarray(y)}
    tg = {"blocks.0.x": torch.from_numpy(x[0]),
          "blocks.1.x": torch.from_numpy(x[1]), "y": torch.from_numpy(y)}
    jef, tef = jc.ErrorFeedback(mode, 0.05), tc.ErrorFeedback(mode, 0.05)
    jout, jres = jef.apply(jg, jef.init(jg))
    tout, tres = tef.apply(tg, tef.init(tg))
    for i in (0, 1):
        assert same(tout[f"blocks.{i}.x"], np.asarray(jout["blocks"]["x"])[i])
        assert same(tres[f"blocks.{i}.x"], np.asarray(jres["blocks"]["x"])[i])
    assert same(tout["y"], jout["y"])
    assert tc.compressed_bytes(tg, mode, 0.05) == \
        jc.compressed_bytes(jg, mode, 0.05)


ILL = 1e-6


def stateful(ef, record=None, source=None):
    """The launchers' compressor: error feedback with its residual
    carried from step to step. `record` collects each step's input;
    `source`, when given, supplies the input in its place (the other
    package's gradients of the same step, as numpy)."""
    state = {}

    def compress(grads):
        if record is not None:
            record.append(grads)
        if source is not None:
            grads = type(grads)(source.pop(0))
        if not state:
            state["r"] = ef.init(grads)
        out, state["r"] = ef.apply(grads, state["r"])
        return out
    return compress


@pytest.mark.parametrize("mode", ["int8", "topk"])
def test_train_step_with_compressor_matches_jax(mode):
    """Both steps compress the port's gradients of the step (JAX's
    compressor gets them in place of its own, which are held within 1e-4
    of them): rounding to int8 or choosing the top 1 % is a step
    function, so gradients that differ in their last bits (reductions
    summed in another order) can land one quantum or one element apart
    at a boundary, and Adam turns that into a step of lr. On equal
    inputs the compressors agree bit for bit (the tests above), so this
    holds what `make_train_step` does around its compressor: the
    gradients it hands over, and the update from what comes back."""
    jcfg, tcfg, tree, model = lm_pair("qwen2_5_3b", seed=8)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    joc, toc = JAdamWConfig(**kw), AdamWConfig(**kw)
    pipe = JPipeline(jcfg.vocab_size, 32, 2, seed=9)
    jnp_tree = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    well, lr_sum = None, 0.0
    port_in, jax_in, handed = [], [], []
    with mesh_context(make_local_mesh()):
        jp = jnp_tree(tree)
        jopt = jadamw_init(jp, joc)
        topt = opt_state_from_jax(jax.tree.map(np.asarray, jopt), tcfg)
        jstep = jmake_train_step(jcfg, joc, compressor=stateful(
            jc.ErrorFeedback(mode), jax_in, handed))
        tstep = make_train_step(tcfg, toc, compressor=stateful(
            tc.ErrorFeedback(mode), port_in), device="cpu")
        for t in range(1, 4):
            batch = pipe.next_batch()
            model, topt, tm = tstep(model, topt, batch)
            handed.append(jax_tree_of(port_in[-1], jax_in[-1] if jax_in
                                      else jp))
            jp, jopt, jm = jstep(jp, jopt, jnp_tree(batch))
            mine = params_from_jax(jax.tree.map(np.asarray, jax_in[-1]),
                                   tcfg)
            for n, g in port_in[-1].items():
                assert float((g - mine[n]).abs().max()) < 1e-4, (n, t)
            for k in ("loss", "grad_norm", "lr"):
                assert abs(float(tm[k]) - float(jm[k])) < 1e-5, (k, t)
            for name in ("mu", "nu"):
                want = params_from_jax(jax.tree.map(np.asarray, jopt[name]),
                                       tcfg)
                for n in want:
                    gap = float((topt[name][n] - want[n]).abs().max())
                    assert gap < 1e-5, (name, n, t)
            nu = params_from_jax(jax.tree.map(np.asarray, jopt["nu"]), tcfg)
            ok = {n: (v == 0) | (torch.sqrt(v / (1 - joc.b2 ** t)) >= ILL)
                  for n, v in nu.items()}
            well = ok if well is None else {n: well[n] & ok[n] for n in ok}
            lr_sum += float(jm["lr"])
    state = model.state_dict()
    want = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    n_ill = n_all = 0
    for n in want:
        gap = (state[n] - want[n]).abs()
        assert float(torch.where(well[n], gap, 0.0).max()) < 1e-5, n
        assert float(gap.max()) <= 2 * lr_sum, n
        n_ill += int((~well[n]).sum())
        n_all += gap.numel()
    assert n_ill < 1e-2 * n_all


def jax_tree_of(grads, like):
    """The port's gradient dict as a JAX tree shaped like `like`."""
    from repro_torch.models.weights import params_to_jax
    from repro_torch.configs import get_reduced
    tree = params_to_jax({n: g.detach() for n, g in grads.items()},
                         get_reduced("qwen2_5_3b"))
    return jax.tree.map(lambda t, _: jnp.asarray(t.numpy()), tree, like)

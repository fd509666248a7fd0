"""The port's spiking CNN pipeline (`repro_torch.core.spiking`, the
DVS-gesture rows of Table 2) against the JAX package's: `atan_spike`,
`SpikingModel.apply` and one `train_spiking` Adam step within 1e-5 abs +
1e-5 rel from carried weights; `simulate_quantized` bit for bit;
`infer_frames` / `infer_frames_batch` on the port's CPU engine (both
paths), simulator and hiaer backends equal to JAX's `CRI_network` and
the integer oracle; a short torch training reaching JAX's bar."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.convert as jc
import repro.core.spiking as js
import repro_torch.core.convert as tc
import repro_torch.core.partition as tpart
import repro_torch.core.spiking as ts
from repro.data.synthetic import event_frames

TOL = dict(atol=1e-5, rtol=1e-5)
LAYERS = [("conv", dict(channels=3, kernel=5, stride=2)),
          ("dense", dict(out_features=16))]
VARIANTS = [("engine", {}), ("engine", {"fused": True}), ("simulator", {}),
            ("hiaer", {"hierarchy": tpart.Hierarchy(1, 2, 2, 40)})]


def models(layers=LAYERS, shape=(2, 13, 13), n_classes=4):
    return (js.SpikingModel(shape, [jc.LayerSpec(k, **kw)
                                    for k, kw in layers], n_classes),
            ts.SpikingModel(shape, [tc.LayerSpec(k, **kw)
                                    for k, kw in layers], n_classes))


def random_params(tm, seed=0, scale=3.0):
    """Port-initialised weights, scaled up so that every layer spikes,
    with nonzero biases, as numpy dicts."""
    p = tm.init(torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed)
    return [{"w": scale * d["w"].numpy(),
             "b": rng.normal(0, 0.3, d["b"].shape).astype(np.float32)}
            for d in p]


def jax_params(params):
    return [{k: jnp.asarray(a) for k, a in p.items()} for p in params]


@pytest.fixture(scope="module")
def data():
    return event_frames(260, shape=(13, 13), n_classes=4, frames=5, seed=2)


@pytest.fixture(scope="module")
def trained(data):
    """The port's spiking CNN trained as tests/test_spiking.py trains
    JAX's (10 epochs at lr 5e-3)."""
    F, y = data
    jm, tm = models()
    params = ts.train_spiking(tm, F[:220].astype(np.float32), y[:220],
                              epochs=10, lr=5e-3, device="cpu")
    return jm, tm, params, tc.quantize(params)[0]


def test_atan_spike_forward_and_gradient_match_jax():
    rng = np.random.default_rng(1)
    v = rng.normal(0, 1, (50, 21)).astype(np.float32)
    g = rng.normal(0, 1, v.shape).astype(np.float32)
    jy, vjp = jax.vjp(js.atan_spike, jnp.asarray(v))
    tv = torch.tensor(v, requires_grad=True)
    ty = ts.atan_spike(tv)
    ty.backward(torch.tensor(g))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_allclose(tv.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(g))[0]), **TOL)


@pytest.mark.parametrize("layers", [LAYERS, LAYERS[1:]],
                         ids=["conv", "dense"])
def test_apply_and_gradient_match_jax(data, layers):
    F, y = data
    jm, tm = models(layers)
    params = random_params(tm, seed=3)
    x = F[:16].astype(np.float32)

    def jloss(p):
        return jnp.sum(jm.apply(p, jnp.asarray(x)) * jnp.arange(4.0))

    _, jgrad = jax.value_and_grad(jloss)(jax_params(params))
    tp = [{k: a.requires_grad_() for k, a in d.items()}
          for d in tc.params_from_jax(params, device="cpu")]
    rates = tm.apply(tp, torch.as_tensor(x))
    jrates = np.asarray(jm.apply(jax_params(params), jnp.asarray(x)))
    np.testing.assert_allclose(rates.detach().numpy(), jrates, **TOL)
    assert 0 < jrates.mean() < 1                 # the readout spikes
    (rates * torch.arange(4.0)).sum().backward()
    for d, jd in zip(tp, jgrad):
        for k in ("w", "b"):
            np.testing.assert_allclose(d[k].grad.numpy(),
                                       np.asarray(jd[k]), **TOL)


def test_train_spiking_one_step_matches_jax(data):
    F, y = data
    jm, tm = models()
    params = random_params(tm, seed=4)
    jm.init = lambda key: jax_params(params)
    tm.init = lambda gen, device=None: tc.params_from_jax(params, device)
    x = F[:16].astype(np.float32)
    want = js.train_spiking(jm, x, y[:16], epochs=1, batch=16, lr=1e-2)
    got = ts.train_spiking(tm, x, y[:16], epochs=1, batch=16, lr=1e-2,
                           device="cpu")
    for g, w, p in zip(got, want, params):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]), **TOL)
            assert not np.array_equal(g[k].numpy(), p[k])


def test_simulate_quantized_matches_jax(data, trained):
    F, _ = data
    jm, tm, _, qp = trained
    got = ts.simulate_quantized(tm, qp, F[220:232])
    np.testing.assert_array_equal(got, js.simulate_quantized(jm, qp,
                                                             F[220:232]))
    assert got.max() <= F.shape[1] + len(tm.layers) + 1


@pytest.fixture(scope="module")
def jax_counts(data, trained):
    """JAX's converted engine network's spike counts on 8 samples."""
    F, _ = data
    jm, _, _, qp = trained
    net, keys = js.spiking_to_network(jm, qp, backend="engine")
    return js.infer_frames_batch(net, F[220:228], jm, keys)[1]


@pytest.mark.parametrize("backend,kw", VARIANTS,
                         ids=["engine", "engine-fused", "simulator", "hiaer"])
def test_infer_frames_batch_matches_jax_and_oracle(data, trained, jax_counts,
                                                   backend, kw):
    F, _ = data
    _, tm, _, qp = trained
    net, keys = ts.spiking_to_network(tm, qp, backend=backend, device="cpu",
                                      **kw)
    preds, counts = ts.infer_frames_batch(net, F[220:228], tm, keys)
    np.testing.assert_array_equal(counts, jax_counts)
    np.testing.assert_array_equal(counts,
                                  ts.simulate_quantized(tm, qp, F[220:228]))
    np.testing.assert_array_equal(preds, counts.argmax(1))
    # the per-step protocol gives the same counts
    for i in range(2):
        pred, c = ts.infer_frames(net, F[220 + i], tm, keys)
        np.testing.assert_array_equal(c, counts[i])
        assert pred == preds[i]


def test_snn_learns(data, trained):
    """JAX's bar (tests/test_spiking.py) on a torch-trained model."""
    F, y = data
    _, tm, params, _ = trained
    rates = tm.apply(params, torch.as_tensor(F[220:].astype(np.float32)))
    assert (rates.numpy().argmax(1) == y[220:]).mean() > 0.5  # chance 0.25

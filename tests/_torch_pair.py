"""Shared builders for the port's tests: one network, built from the
same numpy seed in the JAX package (`repro`) and in the PyTorch port
(`repro_torch`), so both see identical inputs."""
import numpy as np

import repro.core.neuron as jn
import repro_torch.core.neuron as tn
from repro.core.spec import NetworkSpec as JSpec
from repro_torch.core.spec import NetworkSpec as TSpec


def torch_model(m):
    """A `repro` neuron model as the port's model of the same params."""
    if m.kind == "LIF":
        return tn.LIF_neuron(m.threshold, m.nu, m.lam)
    return tn.ANN_neuron(m.threshold, m.nu)


def specs_from_dicts(axons, neurons, outputs):
    """(repro spec, repro_torch spec) of one legacy dict network whose
    models are `repro` LIF/ANN neurons."""
    t_neurons = {k: (f, torch_model(m)) for k, (f, m) in neurons.items()}
    return (JSpec.from_dicts(axons, neurons, outputs),
            TSpec.from_dicts(axons, t_neurons, outputs))


def hub_dicts(n=120):
    """Every neuron feeds one hub, so the padded fan-in transpose is
    uneconomical and the engine routes through the CSR accumulate."""
    lif = jn.LIF_neuron(threshold=20, nu=-32, lam=5)
    names = [f"n{i}" for i in range(n)]
    neurons = {k: ([("hub", 3)], lif) for k in names}
    neurons["hub"] = ([(names[0], 1)], jn.LIF_neuron(threshold=40, nu=1,
                                                      lam=3))
    axons = {"a0": [(names[i], 30) for i in range(0, n, 7)],
             "a1": [("hub", 9), (names[3], -4)]}
    return axons, neurons, ["hub"]


def power_law_dicts(seed=3, n=150):
    """Zipf in-degrees: neuron j receives ~ n/(j+1) synapses."""
    rng = np.random.default_rng(seed)
    lif = jn.LIF_neuron(threshold=10, nu=0, lam=4)
    names = [f"n{i}" for i in range(n)]
    neurons = {}
    for k in names:
        fan = rng.zipf(1.3, 4)
        tgt = np.unique(np.minimum(
            rng.zipf(1.2, int(fan.sum()) % 17 + 1) - 1, n - 1))
        neurons[k] = ([(names[j], int(rng.integers(-9, 10)) or 2)
                       for j in tgt], lif)
    axons = {"a0": [(names[j], 25) for j in range(0, n, 11)]}
    return axons, neurons, names[:4]


def noisy_spec(pkg_spec, neuron_mod, seed=0, n=64, n_axons=6, fanout=5):
    """A columnar network with LIF and ANN neurons, some noisy, built
    through one package's NetworkSpec from a numpy seed."""
    rng = np.random.default_rng(seed)
    spec = pkg_spec()
    ax = spec.add_axons(n_axons)
    spec.add_neurons(n // 2, neuron_mod.LIF_neuron(threshold=40, nu=1,
                                                   lam=3))
    spec.add_neurons(n // 4, neuron_mod.ANN_neuron(threshold=30, nu=0))
    spec.add_neurons(n - n // 2 - n // 4,
                     neuron_mod.LIF_neuron(threshold=60, nu=-32, lam=63))
    pre = np.concatenate([np.repeat(ax, fanout),
                          np.repeat(np.arange(n - 3), fanout)])
    post = rng.integers(0, n, pre.size)
    w = rng.integers(-30, 45, pre.size)
    spec.connect(pre, post, w)
    spec.set_outputs(np.arange(4))
    return spec


def lm_pair(arch, seed=0):
    """One reduced dense LM in both packages: (JAX config, port config,
    the JAX parameter tree as numpy — fp32, its norm scales and QKV
    biases drawn at random so that they matter — and the port's fp32 CPU
    model loaded with the same weights through `params_from_jax`)."""
    import jax
    import torch
    from repro.configs import get_reduced as jget_reduced
    from repro.models import lm as jlm
    from repro_torch.configs import get_reduced
    from repro_torch.models import lm as tlm
    from repro_torch.models.weights import params_from_jax
    jcfg, tcfg = jget_reduced(arch), get_reduced(arch)
    tree = jax.tree.map(np.asarray, jlm.init_params(
        jcfg, jax.random.PRNGKey(seed), jax.numpy.float32))
    rng = np.random.default_rng(seed)

    def jitter(node):
        for k, val in node.items():
            if isinstance(val, dict):
                jitter(val)
            elif k in ("scale", "bias", "bq", "bk", "bv"):
                node[k] = (val + rng.normal(0, 0.3, val.shape)).astype(
                    val.dtype)
    jitter(tree)
    model = tlm.init_params(tcfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(params_from_jax(tree, tcfg))
    return jcfg, tcfg, tree, model

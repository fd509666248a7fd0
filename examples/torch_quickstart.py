"""Quickstart on the PyTorch/CUDA port — the Appendix A.1 example
network, verbatim API, plus the staged build→compile→deploy pipeline the
dict facade sits on. The twin of `examples/quickstart.py`.

    PYTHONPATH=src python examples/torch_quickstart.py                # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse

import numpy as np

from repro_torch import (ANN_neuron, CRI_network, LIF_neuron, NetworkSpec,
                         compile_spec, deploy)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the network runs (default: the card; cpu "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    # neuron models (A.1): a,b = LIF θ=3 almost-no-leak; c = LIF θ=4
    # λ=2; d = stochastic ANN θ=5
    lif_ab = LIF_neuron(threshold=3, nu=-32, lam=60)
    lif_c = LIF_neuron(threshold=4, nu=-32, lam=2)
    ann_d = ANN_neuron(threshold=5, nu=0)

    axons = {
        "alpha": [("a", 3), ("c", 2)],
        "beta": [("b", 3)],
    }
    neurons = {
        "a": ([("b", 1), ("a", 2)], lif_ab),
        "b": ([], lif_ab),
        "c": ([], lif_c),
        "d": ([("c", 1)], ann_d),
    }
    outputs = ["a", "b"]

    network = CRI_network(axons=axons, neurons=neurons, outputs=outputs,
                          backend="engine", device=args.device)

    print("== stepping the A.1 network ==")
    for t in range(6):
        inputs = ["alpha", "beta"] if t % 2 == 0 else ["alpha"]
        fired = network.step(inputs)
        print(f"t={t} inputs={inputs} fired={fired}")

    # monitor membrane potentials
    fired, potentials = network.step(["beta"], membranePotential=True)
    print("potentials:", potentials)

    # A.1: increment the a->b synapse over the PCIe path
    w = network.read_synapse("a", "b")
    network.write_synapse("a", "b", w + 1)
    print(f"synapse a->b: {w} -> {network.read_synapse('a', 'b')}")

    # the hardware cost model (Table 2 instrumentation)
    print("HBM access counter:", network.counter.as_dict())

    # == the same network through the staged columnar API ==
    # stage 1: columnar spec (bulk array construction — scales to
    # millions of synapses with no per-synapse Python)
    spec = NetworkSpec()
    ax = spec.add_axons(2, keys=["alpha", "beta"])
    nr_ab = spec.add_neurons(2, lif_ab, keys=["a", "b"])
    nr_c = spec.add_neurons(1, lif_c, keys=["c"])
    nr_d = spec.add_neurons(1, ann_d, keys=["d"])
    a, b, c, d = int(nr_ab[0]), int(nr_ab[1]), int(nr_c[0]), int(nr_d[0])
    spec.connect(np.array([ax[0], ax[0], ax[1], a, a, d]),
                 np.array([a, c, b, b, a, c]),
                 np.array([3, 2, 3, 1, 2, 1]))
    spec.set_outputs([a, b])

    # stage 2: compile to the packed HBM image (bit-identical to the
    # dict route) — the artifact saves/loads for reuse, in either package
    compiled = compile_spec(spec, target="engine")
    print("staged image stats:", compiled.stats())

    # stage 3: deploy and run; batched reconfiguration is one upload
    dep = deploy(compiled, seed=0, device=args.device)
    dep.run(np.ones((4, 2), np.int32))
    dep.write_synapses([int(ax[0]), a], [a, b], [5, 2])   # ONE upload
    print("staged read_synapses:",
          dep.read_synapses([int(ax[0]), a], [a, b]).tolist())


if __name__ == "__main__":
    main()

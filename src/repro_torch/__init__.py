"""PyTorch/CUDA port of the HiAER-Spike event engine.

The JAX package `repro` is the reference; this package runs the same
main path — ``NetworkSpec -> compile_spec(target="engine") -> deploy ->
run / run_batch / run_lanes`` — on an NVIDIA H100, with the two TPU
kernels of that path (`lif_step` and the fused route+LIF step) written
by hand in CUDA C++ (`csrc/`). It imports torch and numpy, never jax and
nothing of `repro`.

    from repro_torch import NetworkSpec, LIF_neuron, compile_spec, deploy
    dep = deploy(compile_spec(spec))            # on the card
    dep = deploy(compile_spec(spec), device="cpu")   # plain versions
"""
from repro_torch.core.compile import CompiledNetwork, compile_spec
from repro_torch.core.deploy import Deployment, deploy
from repro_torch.core.neuron import ANN_neuron, LIF_neuron
from repro_torch.core.spec import NetworkSpec

__all__ = ["ANN_neuron", "CompiledNetwork", "Deployment", "LIF_neuron",
           "NetworkSpec", "compile_spec", "deploy"]

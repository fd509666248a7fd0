"""PyTorch/CUDA port of the HiAER-Spike event engine, its dense
simulator and the LM stack's serving and training paths.

The JAX package `repro` is the reference; this package runs the same
paths — ``NetworkSpec -> compile_spec(target="engine" | "simulator") ->
deploy -> step / run / run_batch / run_lanes``, the `CRI_network`
facade over them, dense-LM serving (`models.lm.prefill` /
`decode_step`, `launch.serve.Server`) and dense-LM training
(`models.lm.loss_fn`, `launch.steps.make_train_step` with `optim`'s
AdamW, `python -m repro_torch.launch.train`) — on an NVIDIA H100, with
the six TPU kernel bodies of those paths written by hand in CUDA C++
(`csrc/`): `lif_step`, the fused route+LIF step, `spike_matmul`, the
flash-attention forward (`flash_attention`), its forward with logsumexp
rows (`flash_fwd_lse`) and its two-kernel backward
(`flash_attention_bwd`). It imports torch and numpy, never jax and
nothing of `repro`.

    from repro_torch import CRI_network, NetworkSpec, compile_spec, deploy
    dep = deploy(compile_spec(spec))            # on the card
    dep = deploy(compile_spec(spec), device="cpu")   # plain versions
    net = CRI_network.from_spec(spec, backend="simulator")
"""
from repro_torch.core.api import CRI_network
from repro_torch.core.compile import CompiledNetwork, compile_spec
from repro_torch.core.deploy import Deployment, deploy
from repro_torch.core.neuron import ANN_neuron, LIF_neuron
from repro_torch.core.partition import Hierarchy
from repro_torch.core.spec import NetworkSpec

__all__ = ["ANN_neuron", "CRI_network", "CompiledNetwork", "Deployment",
           "Hierarchy", "LIF_neuron", "NetworkSpec", "compile_spec",
           "deploy"]

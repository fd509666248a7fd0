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
__all__ = ["ANN_neuron", "CRI_network", "CompiledNetwork", "Deployment",
           "Hierarchy", "LIF_neuron", "NetworkSpec", "compile_spec",
           "deploy"]

# resolved at first use (PEP 562): `python -m repro_torch.portal --worker`
# and the stdlib-only modules it imports (portal.{errors,auth,ws,http,
# bridge}, obs, faults) load neither torch nor numpy
_LAZY = {"CRI_network": "repro_torch.core.api",
         "ANN_neuron": "repro_torch.core.neuron",
         "LIF_neuron": "repro_torch.core.neuron",
         "CompiledNetwork": "repro_torch.core.compile",
         "compile_spec": "repro_torch.core.compile",
         "Deployment": "repro_torch.core.deploy",
         "deploy": "repro_torch.core.deploy",
         "Hierarchy": "repro_torch.core.partition",
         "NetworkSpec": "repro_torch.core.spec"}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch' has no attribute "
                             f"{name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)

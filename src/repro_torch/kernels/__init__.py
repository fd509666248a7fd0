"""The port's kernels: CUDA C++ sources in `repro_torch/csrc/`, their
ctypes wrappers (`lif_step`, `route.route_lif`, `spike_matmul`, and in
`flash_attention` the forward, the forward with lse, the backward and
the autograd Function over them), their plain PyTorch versions (`ref`),
and the torch-op routing around them (`route`)."""

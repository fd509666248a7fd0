"""The port's kernels: CUDA C++ sources in `repro_torch/csrc/`, their
ctypes wrappers (`lif_step`, `route.route_lif`, `spike_matmul`,
`flash_attention`), their plain PyTorch versions (`ref`), and the
torch-op routing around them (`route`)."""

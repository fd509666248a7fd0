"""Share of the roofline of the routing-and-membrane kernels of
`csrc/route_lif.cu` (the compaction, the span walk and membrane.cuh's
pass): the least time for the benchmark's count of their work
(`counts.snn_step.StepWork.route_bytes_ops`) over their device time in
the traced slice."""
from perfbench.harness.peaks import least_seconds

KERNELS = ("route_compact_kernel", "route_walk_kernel", "membrane_kernel")


def read(r):
    if r.trace is None or r.work is None:
        return None
    spent = r.trace.device_seconds(*KERNELS)
    if spent <= 0:
        return None
    least, _ = least_seconds(*r.work.route_bytes_ops())
    return 100.0 * least / spent

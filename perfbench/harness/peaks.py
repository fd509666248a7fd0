"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit). The benchmark states every roofline
share against these; the card's own power limit is printed beside it."""

HBM_BYTES_PER_S = 3.35e12       # HBM3 bandwidth
# int32 operations a second outside the tensor cores: 132 SMs x 64 int32
# lanes a clock x the 1.98 GHz boost clock
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def least_seconds(n_bytes: float, n_ops: float):
    """(seconds, what bounds): the larger of the bytes over the memory
    rate and the int32 operations over the int32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / INT32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

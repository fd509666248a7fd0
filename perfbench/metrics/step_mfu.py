"""The whole step's share of the card's peak over the traced slice: the
least time of the slice's work (`counts.snn_step.StepWork.step_bytes_ops`
over the windows run under the profiler, bytes at the HBM rate or int32
operations at the int32 rate, whichever bounds) over the slice's length
in the trace (`TraceReading.window_s`). Work and time are of the same
windows."""
from perfbench.harness.peaks import least_seconds


def read(r):
    if r.trace is None or r.work is None or not r.work.steps \
            or not r.trace.window_s:
        return None
    least, _ = least_seconds(*r.work.step_bytes_ops())
    return 100.0 * least / r.trace.window_s

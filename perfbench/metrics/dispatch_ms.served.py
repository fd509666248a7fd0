"""Median over the window's batches of the server's own `dispatch_ms`
(`ServeResult`): the batch's run_lanes with its host reads."""
import numpy as np


def read(r):
    v = r.spans.get("dispatch_ms")
    return float(np.median(v)) if v else None

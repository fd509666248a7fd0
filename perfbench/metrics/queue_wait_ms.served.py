"""Median over the window's requests of the server's own
`queue_wait_ms` (`ServeResult`): submit to batch assembly."""
import numpy as np


def read(r):
    v = r.spans.get("queue_wait_ms")
    return float(np.median(v)) if v else None

"""95th percentile of the latency of the window's requests, from when
each was due to when its result arrived; a failed request counts as
infinite (and the run is then not correct: its `failed` check reads
above 0). Requests of the backlog that a mix above capacity cancels at
the close have no latency and are left out, so above capacity this is
the wait of the backlog the server got through. The percentile is
numpy's linear one; none where it is infinite."""
import numpy as np


def read(r):
    if r.latencies_ms is None or len(r.latencies_ms) == 0:
        return None
    v = float(np.percentile(np.asarray(r.latencies_ms), 95))
    return v if np.isfinite(v) else None

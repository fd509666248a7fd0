"""Always-on serving tier, the port of `repro/serve/`: micro-batched
spike-stream serving over resident `Deployment`s on the card.

    from repro_torch.serve import SpikeServer

    srv = SpikeServer(max_batch=8, max_wait_ms=2.0)
    srv.add_model("snn", compiled, window=16, n_sessions=8)  # the card
    with srv:
        res = srv.submit("snn", counts).result()      # ServeResult

Requests from many clients enter a double-buffered queue, are
micro-batched under a deadline + max-batch policy into single
`Deployment.run_lanes` dispatches, and come back per-client:
bit-identical to running each request alone, and to `repro`'s server.
A mesh deployment spanning several ranks is served by rank 0 while the
other ranks replay its calls (`serve_follower`, `serve.replica`).
`python -m repro_torch.serve` runs a self-contained demo server against
a synthetic network. `queue.SlotPool` also backs the LM slot server.
"""
from repro_torch.serve.queue import (BufferClosed, BufferFull,
                                     DoubleBuffer, SlotPool)
from repro_torch.serve.replica import serve_follower
from repro_torch.serve.server import ResidentModel, SpikeServer, next_pow2
from repro_torch.serve.session import (DeadlineError, DispatchRestart,
                                       Reconfigure, Request, ServeResult,
                                       Session, SessionStore)

__all__ = [
    "SpikeServer", "ResidentModel", "next_pow2",
    "DoubleBuffer", "SlotPool", "BufferFull", "BufferClosed",
    "Request", "Reconfigure", "ServeResult", "Session", "SessionStore",
    "DeadlineError", "DispatchRestart", "serve_follower",
]

"""Web-portal front end over the serving tier — the port of
`repro/portal/`, the paper's "made easily available over a web portal"
delivery layer, in front of the port's `SpikeServer` on the card.

    from repro_torch.portal import Portal, TokenQuota
    from repro_torch.serve import SpikeServer

    srv = SpikeServer(max_batch=8, max_pending=64)
    srv.add_model("demo", compiled, window=8, n_sessions=8)   # the card
    with srv, Portal(srv, port=8787, workers=4,
                     tokens={"s3cret": TokenQuota(rate=50)}) as portal:
        ...                      # curl http://127.0.0.1:8787/healthz

Layering (each module one concern, each the twin of `repro.portal`'s):

    errors.py    PortalError — status + E_* code + Retry-After + findings
    auth.py      bearer tokens, token-bucket rate + in-flight quotas
    http.py      HTTP/1.1 on asyncio streams (run/reconfigure/sessions/
                 healthz/metrics)
    ws.py        RFC 6455 websocket streaming sessions (lane-pinned)
    bridge.py    N front-end worker processes over a unix socket, one
                 resident dispatcher (SO_REUSEPORT fan-in)
    gateway.py   LocalGateway over SpikeServer + the Portal lifecycle

Everything except `gateway` is stdlib-only: bridge WORKER processes
import neither torch nor numpy, which is why this `__init__` (and the
package's own) resolves the heavy exports lazily —
`python -m repro_torch.portal --worker` must stay light.
`python -m repro_torch.portal` serves a demo model over localhost.
"""
from repro_torch.portal.auth import Authenticator, TokenQuota
from repro_torch.portal.errors import PortalError

__all__ = ["PortalError", "Authenticator", "TokenQuota",
           "Portal", "LocalGateway", "map_exception", "result_digest",
           "WSClient"]

_LAZY = {"Portal": "repro_torch.portal.gateway",
         "LocalGateway": "repro_torch.portal.gateway",
         "map_exception": "repro_torch.portal.gateway",
         "result_digest": "repro_torch.portal.gateway",
         "WSClient": "repro_torch.portal.ws"}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.portal' has no "
                             f"attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)

"""Web-portal front end over the serving tier — the port of
`repro/portal/`. Only `result_digest` is here so far; the gateway,
HTTP, websocket, auth and bridge layers come with ROADMAP item 5b,
under the same module names."""
from repro_torch.portal.gateway import result_digest

__all__ = ["result_digest"]

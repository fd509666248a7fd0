"""The portal's dispatcher-side half (`repro/portal/gateway.py`). So far
it holds the digest both packages' serving tests and chaos CLIs compare;
`LocalGateway`, `Portal` and `map_exception` come with ROADMAP item 5b.
"""
from __future__ import annotations

import hashlib

import numpy as np

__all__ = ["result_digest"]


def result_digest(spikes, membrane) -> str:
    """Canonical digest of one served window — sha256 over the bool
    spike raster and the int32 final membranes. The same bytes hash on
    both sides of the wire (and in both packages), so bit-exactness
    checks compare 64 hex chars instead of shipping arrays around."""
    s = np.ascontiguousarray(np.asarray(spikes), dtype=np.uint8)
    v = np.ascontiguousarray(np.asarray(membrane), dtype="<i4")
    h = hashlib.sha256()
    h.update(np.asarray(s.shape, "<i8").tobytes())
    h.update(s.tobytes())
    h.update(v.tobytes())
    return h.hexdigest()

"""Host seconds of `deploy` and `alloc_lanes`, the tables uploaded and
the card synchronised (harness's clock)."""


def read(r):
    return r.host.get("deploy_s")

"""Device operations (kernels, copies, sets) in the traced slice over its
batched steps."""


def read(r):
    if r.trace is None or not r.trace.steps or not r.trace.device_events:
        return None
    return r.trace.device_events / r.trace.steps

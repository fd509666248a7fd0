"""Share of the traced slice with no operation on the card, in the lanes
cells."""


def read(r):
    t = r.trace
    if t is None or not t.window_s or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)

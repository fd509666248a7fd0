"""Every (lane, step) simulated in the measured window over the whole
window (host clock)."""


def read(r):
    if not r.lane_steps or not r.window_s:
        return None
    return r.lane_steps / r.window_s

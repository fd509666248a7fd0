"""Requests answered within the measured window over the window's length
(host clock), in an open loop offered above the server's capacity: the
rate the server sustains."""


def read(r):
    if not r.answered or not r.window_s:
        return None
    return r.answered / r.window_s

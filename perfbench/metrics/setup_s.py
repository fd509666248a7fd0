"""Set-up: process start to the first timed step (host clock)."""


def read(r):
    return r.setup_s

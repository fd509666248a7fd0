"""Host seconds of the program's `compile_spec` (harness's clock)."""


def read(r):
    return r.host.get("compile_s")

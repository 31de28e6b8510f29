"""Seconds from the process's start to the window's first round: imports,
the kernels' builds (first run of a checkout), the load, the draw
horizon and the warm-up."""


def read(ctx):
    return ctx["setup_s"]

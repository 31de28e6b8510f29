"""Kernels the device ran in the traced rounds (copies and fills
excluded), per round."""


def read(ctx):
    k = ctx["trace"]["kernels"]
    return sum(c for _, c in k.values()) / ctx["trace_rounds"] if k else None

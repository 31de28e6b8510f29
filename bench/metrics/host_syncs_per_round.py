"""CUDA runtime calls after which the host waits for the device
(stream, device and event synchronisations, blocking copies) in the
traced rounds, per round."""


def read(ctx):
    return ctx["trace"]["syncs"] / ctx["trace_rounds"]

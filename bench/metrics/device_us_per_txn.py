"""The card's busy time a committed transaction costs: the union of the
device's operation intervals (kernels, copies, fills) over the traced
rounds, in microseconds, over the transactions of every type that those
rounds committed. The rounds run after the window, under the profiler,
in every run."""


def read(ctx):
    tr = ctx["trace"]
    s = ctx["trace_stats"]
    commits = sum(v for k, v in s.items() if k.startswith("commits"))
    if not tr["device_ops"] or not commits:
        return None
    return tr["busy_s"] * 1e6 / commits

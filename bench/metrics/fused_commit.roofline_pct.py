"""The least time the traced rounds' commit calls need (whole commits,
and the decide-only and apply launches over servers; ``bench/work.py``)
over the profiler's device time of ``fused_commit_kernel``, in %."""


def read(ctx):
    t = sum(v[0] for n, v in ctx["trace"]["kernels"].items()
            if "fused_commit_kernel" in n)
    if not t or not ctx["work_calls"]["fused_commit"]:
        return None
    return 100.0 * ctx["work"]["fused_commit"] / t

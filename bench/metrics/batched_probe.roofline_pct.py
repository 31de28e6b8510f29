"""The least time the traced rounds' probe calls need (their bytes at the
HBM bandwidth, ``bench/work.py``) over the profiler's device time of
``batched_probe_kernel``, in %."""


def read(ctx):
    t = sum(v[0] for n, v in ctx["trace"]["kernels"].items()
            if "batched_probe_kernel" in n)
    if not t or not ctx["work_calls"]["batched_probe"]:
        return None
    return 100.0 * ctx["work"]["batched_probe"] / t

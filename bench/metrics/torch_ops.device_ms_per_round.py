"""Device time of every operation other than the two protocol kernels
(the plain PyTorch around them: reads, inserts, the index, the version
mover, GC, copies), per traced round."""
KERNELS = ("batched_probe_kernel", "fused_commit_kernel")


def read(ctx):
    ops = ctx["trace"]["device_ops"]
    t = sum(v[0] for n, v in ops.items()
            if not any(k in n for k in KERNELS))
    return t * 1e3 / ctx["trace_rounds"] if ops else None

"""The reduction of a ``torch.profiler`` trace of the traced window.

Read from the trace: every device operation (kernels, copies, fills) with
its interval; the host's CUDA runtime calls that wait for the device; and
the benchmark's own host spans (``bench.<name>`` ranges), among them
``bench.window`` around the driver call.
"""
from __future__ import annotations

import bisect

# runtime calls after which the host waits for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def _union(intervals):
    """Total length of the union of ``(start, end)`` intervals, and the
    merged intervals in order."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _kind(name: str) -> str:
    """A device event's kind: a copy, a fill or a kernel."""
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    return "gpu_memset" if name.startswith("Memset") else "kernel"


def summarize(prof) -> dict:
    """Times in seconds: ``device_ops`` {name: (seconds, count)} of the
    device events inside the window, ``busy_s`` their union, ``window_s``,
    ``kernels`` (device events other than copies and fills), ``syncs``
    (runtime waits inside the window), ``spans`` {name: (host seconds,
    calls)} and ``idle_gaps`` {innermost span: idle seconds}. Reads the
    profiler's raw events: kernels, copies and fills on the device; the
    runtime's calls and the benchmark's ranges on the host."""
    from torch.autograd import DeviceType
    dev, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-3
        t = (s, s + e.duration_ns() * 1e-3, e.name())
        if e.device_type() != DeviceType.CUDA:
            cpu.append(t)
        elif not t[2].startswith("bench."):   # not a range's device copy
            dev.append(t + (_kind(t[2]),))
    win = [(s, e) for s, e, n in cpu if n == "bench.window"]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} bench.window spans")
    w0, w1 = win[0]
    dev = [(max(s, w0), min(e, w1), n, k) for s, e, n, k in dev
           if e > w0 and s < w1]
    ops, kernels = {}, {}
    for s, e, n, k in dev:
        for d in (ops, kernels) if k == "kernel" else (ops,):
            t, c = d.get(n, (0.0, 0))
            d[n] = (t + (e - s) * 1e-6, c + 1)
    busy_us, merged = _union([(s, e) for s, e, _, _ in dev])
    syncs = sum(1 for s, e, n in cpu if n in SYNC_CALLS and w0 <= s <= w1)
    spans = {}
    span_list = sorted((s, e, n[len("bench."):]) for s, e, n in cpu
                       if n.startswith("bench.") and n != "bench.window"
                       and w0 <= s <= w1)
    for s, e, n in span_list:
        t, c = spans.get(n, (0.0, 0))
        spans[n] = (t + (e - s) * 1e-6, c + 1)
    # idle gaps: between the merged device intervals, and from the window's
    # start to the first one; each goes to the innermost span around its
    # middle, or to "driver" outside every span
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    starts = [s for s, _, _ in span_list]
    idle = {}
    for a, b in gaps:
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        owner = "driver"
        best = None
        for s, e, n in span_list[max(0, i - 64):i]:
            if s <= mid <= e and (best is None or s >= best):
                best, owner = s, n
        idle[owner] = idle.get(owner, 0.0) + (b - a) * 1e-6
    return {"device_ops": ops, "busy_s": busy_us * 1e-6,
            "window_s": (w1 - w0) * 1e-6,
            "kernels": kernels,
            "syncs": syncs, "spans": spans, "idle_gaps": idle}


def breakdown(summary: dict) -> dict:
    """The ten device operations that took most time and the ten largest
    idle shares by host span, as ``[name, seconds]`` lists."""
    ops = sorted(((n, t) for n, (t, _) in summary["device_ops"].items()),
                 key=lambda r: -r[1])[:10]
    gaps = sorted(summary["idle_gaps"].items(), key=lambda r: -r[1])[:10]
    return {"device_ops": [[n[:120], t] for n, t in ops],
            "idle_gaps": [[n, t] for n, t in gaps]}

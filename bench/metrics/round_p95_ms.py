"""The 95th percentile, nearest rank, of the window's round times: host
clock between the rounds' draws, the last to the synchronisation after the
driver; the whole window (hundreds of rounds), which the profiler does
not slow. ``commit_p95_ms`` where its spread over runs is too wide for an
end-to-end bound."""
import math


def read(ctx):
    times = sorted(ctx["round_s"])
    return times[math.ceil(0.95 * len(times)) - 1] * 1e3

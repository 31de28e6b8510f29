"""W03/A3 corpus (torch): the sentinel-blind snapshot-slot choice.

``times`` uses -1 for never-used slots. A bare ``argmin`` prefers unused
slots only because -1 sorts below every valid wall-clock time — a
coincidence of the sentinel encoding. The fix selects explicitly (a
boolean unused-mask first, the where-guarded argmin second). Do not fix:
tests/test_torch_analysis.py asserts this fires.
"""


def bad_take_snapshot(times, vecs, now, vec):
    pos = times.argmin()
    times[pos] = now
    vecs[pos] = vec
    return times, vecs

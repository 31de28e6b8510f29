"""W06 corpus: fault F1, minimized — a gather index fed to a scatter.

``_u32.gidx`` is JAX's *gather* rule: a negative index wraps once, then
the index is clamped. JAX's *scatter* drops a lane still out of range. An
index made by ``gidx`` and then written through therefore writes the
out-of-range lane into row R-1 (``R + 5`` clamps to ``R - 1``), where the
reference writes nothing: the port's commit path once did exactly that.
``good_install`` is the fix (``_u32.sidx`` and the lane mask).
Do not fix: tests/test_torch_analysis.py asserts both bad variants fire
and that ``bad_install`` really writes row R-1.
"""
from repro_torch._u32 import gidx, rows_of, sidx


def bad_install(cur_hdr, slots, new_hdr, mask):
    safe = gidx(slots, cur_hdr.shape[0])
    rows = rows_of(mask)
    cur_hdr.index_put_((safe[rows],), new_hdr[rows])
    return cur_hdr


def bad_release(cur_hdr, slots, mask):
    s = gidx(slots, cur_hdr.shape[0])[rows_of(mask)]
    cur_hdr[s, 0] = cur_hdr[s, 0] & ~1
    return cur_hdr


def good_install(cur_hdr, slots, new_hdr, mask):
    R = cur_hdr.shape[0]
    idx = sidx(slots, R)
    rows = rows_of(mask & (idx < R))
    cur_hdr.index_put_((idx[rows],), new_hdr[rows])
    return cur_hdr

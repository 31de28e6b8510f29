"""W02/A2 corpus (torch): the replay-order-key wraparound, minimized.

The port keeps uint32 timestamps as int32 bit patterns, so ``sum(T)`` over
them adds signed patterns (a word past 2^31 counts as negative) and, in
any 32-bit accumulation, wraps past 2^32: either way the vector-dominance
order the replay relies on inverts. The fixed code (``wal._order_keys``)
widens with ``_u32.u64`` and sums the low and high 16-bit digits apart.
Do not fix: tests/test_torch_analysis.py asserts this fires.
"""


def bad_order_key(ts_vec):
    # int32 [Th, Cap, n_slots] — the logged read snapshots
    return ts_vec.sum(dim=-1)

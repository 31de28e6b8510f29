"""W05 corpus (torch): the wraparound-blind replay window, minimized.

A journal ring's position ``p`` holds the entry with append index
``used - 1 - ((used - 1 - p) mod capacity)``: comparing raw positions
against ``used`` is only right before the first wrap, and replays
overwritten entries after it. The fixed code (``wal._live_window``) maps
each position to its latest append index. Do not fix:
tests/test_torch_analysis.py asserts this fires.
"""
import torch


def bad_live_window(j):
    # "everything below the cursor is live" — wrong after the first wrap
    return (torch.arange(j.capacity, dtype=torch.int32)[None, :]
            < j.used[:, None])

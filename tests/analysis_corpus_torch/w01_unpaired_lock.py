"""W01/A1 corpus (torch): CAS-acquire without a matching release.

``bad_round_no_release`` leaks every granted lock — no release call at
all; the AST lint (W01) and the graph audit (A1, a missing tag) both fire.
``bad_round_foreign_release`` is the subtler variant: it *does* call
``cas.release``, but with a mask not derived from the grant — the
spelling-level W01 is silent, only the A1 taint walk sees that the grant
never reaches the release. Do not fix: tests/test_torch_analysis.py
asserts these fire.
"""
import torch

from repro_torch.core import annotations as anno
from repro_torch.core import cas


def bad_round_no_release(hdrs, slots, expected, prio, active):
    res = cas.arbitrate(hdrs, slots, expected, prio, active)
    granted = anno.tag(res.granted, anno.LOCK_GRANTED)
    committed = anno.tag(granted.all(), anno.COMMIT_COMMITTED)
    # aborted lanes' locks are never released — they leak
    return torch.where(committed, 1, 0), res.new_hdr


def bad_round_foreign_release(hdrs, slots, expected, prio, active,
                              stale_mask):
    res = cas.arbitrate(hdrs, slots, expected, prio, active)
    granted = anno.tag(res.granted, anno.LOCK_GRANTED)
    committed = anno.tag(granted.all(), anno.COMMIT_COMMITTED)
    # releases a mask computed from stale state, not from this round's
    # grant — locks granted this round can survive the release
    released = anno.tag(stale_mask, anno.LOCK_RELEASED)
    return cas.release(res.new_hdr, slots, released), committed

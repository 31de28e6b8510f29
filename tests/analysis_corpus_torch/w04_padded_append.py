"""W04/A4 corpus (torch): the padded-vector journal append, minimized.

The sharded engine pads the timestamp vector so that it divides over the
servers; logging the *padded* vector (or an unpadded write-set) into a
journal of another declared width writes a wrong-shaped entry, and replay
rebuilds the wrong snapshot. The fixed call sites slice the vector to the
journal's ``n_slots`` and run the write-set through
``*wal.pad_writes(...)``; ``append_intent`` raises "[A4]" on a mismatch.
Do not fix: tests/test_torch_analysis.py asserts this fires.
"""
from repro_torch.core import wal


def bad_append(journal, tid, padded_vec, slots, new_hdr, new_data,
               write_mask):
    return wal.append_intent(journal, tid, padded_vec, slots, new_hdr,
                             new_data, write_mask)

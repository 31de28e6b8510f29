"""Plain PyTorch version of the batched probe: the production composition
``hashtable.lookup`` (keyed lanes) → ``mvcc.locate_visible`` (all lanes),
exactly the path ``si.run_round`` takes when ``batched_probe`` is off."""
from __future__ import annotations

import torch

from repro_torch.core import hashtable as ht, mvcc


def batched_probe_ref(dir_keys, dir_vals, table: mvcc.VersionedTable, ts_vec,
                      fallback_slots, keys, key_mask, *,
                      max_probes: int = 16):
    """Returns ``(slot int32, found bool, src int32, pos int32)``, each [Q].

    ``slot`` is -1 exactly on a keyed miss and the raw fallback on a slot
    lane; ``src``/``pos`` locate the newest usable version of the lane's
    safe slot (a miss resolves slot 0). ``dir_keys=None`` is the
    locate-only mode. Reads only; writes nothing.
    """
    fallback_slots = fallback_slots.to(torch.int32)
    if dir_keys is None:
        kvals = torch.zeros_like(fallback_slots)
        kfound = torch.zeros(fallback_slots.shape, dtype=torch.bool,
                             device=fallback_slots.device)
        key_mask = kfound
    else:
        kvals, kfound = ht.lookup(ht.HashTable(keys=dir_keys, vals=dir_vals),
                                  keys, max_probes=max_probes)
    km = key_mask
    resolved = torch.where(km, torch.where(kfound, kvals, 0), fallback_slots)
    loc = mvcc.locate_visible(table, resolved, ts_vec)
    return (torch.where(km, torch.where(kfound, kvals, -1), fallback_slots),
            (~km | kfound) & loc.found, loc.src, loc.pos)

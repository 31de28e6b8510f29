"""Plain PyTorch versions of the probe kernels: the production composition
``hashtable.lookup`` → ``mvcc.locate_visible``. For the batched probe it is
exactly the path ``si.run_round`` takes when ``batched_probe`` is off."""
from __future__ import annotations

import torch

from repro_torch.core import hashtable as ht, mvcc


def hash_probe_ref(dir_keys, dir_vals, table: mvcc.VersionedTable, ts_vec,
                   queries, *, max_probes: int = 16):
    """Single-key probe + §5.1 location of every query key.

    Returns ``(slot int32, found bool, src int32, pos int32)``, each [Q]:
    a missing or invalidated key gives ``slot = -1``, ``found = False`` and
    ``src = pos = 0`` (unlike :func:`batched_probe_ref`, which resolves safe
    slot 0). Reads only.
    """
    vals, kfound = ht.lookup(ht.HashTable(keys=dir_keys, vals=dir_vals),
                             queries, max_probes=max_probes)
    loc = mvcc.locate_visible(table, torch.where(kfound, vals, 0), ts_vec)
    return (torch.where(kfound, vals, -1), kfound & loc.found,
            torch.where(kfound, loc.src, 0), torch.where(kfound, loc.pos, 0))


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

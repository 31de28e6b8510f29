"""Protocol-invariant annotations read by ``repro_torch.analysis``.

The commit path marks its protocol-critical values with :func:`tag` so the
graph audit (``repro_torch.analysis.graph_audit``) finds them by name
instead of guessing from op patterns. A tag returns its tensor itself and
changes no result. A Python no-op would be invisible to the audit, which
sees dispatched ops; an identity ``torch.library`` op would be seen but
would add a dispatch (and an alias) to every round. So :func:`tag` takes
the third way: while an audit runs it reports ``(name, x)`` to the audit's
hook, and otherwise it costs one branch.

Tag names are namespaced under ``nam.``, as the JAX package's are. The
three tags below are the A1 lock-pairing contract: every CAS-acquire site
tags its grant mask, and the audit proves that mask flows into *both* the
released mask and the commit decision, so every granted lock is either
released (the abort path) or owned by a committed transaction (whose
install and make-visible consume it).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

_NAMESPACE = "nam."

# The A1 contract tags. Keep these in sync with DESIGN.md §7 and
# repro_torch/analysis/graph_audit.py.
LOCK_GRANTED = "lock.granted"      # CAS arbitration grant mask  [T*WS] bool
LOCK_RELEASED = "lock.released"    # abort-path release mask     [T*WS] bool
COMMIT_COMMITTED = "commit.committed"  # per-txn commit decision [T]  bool

# the running audit's hook, ``hook(namespaced_name, tensor)``; set only
# for the extent of ``graph_audit.audit_callable`` (and its entry points)
_hook: Optional[Callable[[str, torch.Tensor], None]] = None


def tag(x: torch.Tensor, name: str) -> torch.Tensor:
    """Mark ``x`` as the protocol value ``name`` for the graph audit.

    Returns ``x`` itself: no copy, no op, nothing changes in any result.
    """
    if _hook is not None:
        _hook(_NAMESPACE + name, x)
    return x

"""Protocol analysis of the PyTorch port (DESIGN.md §7).

Three levels over one rule catalog (:mod:`.rules`, its own copy: the port
imports nothing of the JAX package):

* :mod:`.graph_audit` (A1-A4): runs the real commit/replay/GC entry points
  under a ``TorchDispatchMode`` and checks lock pairing through the
  protocol tags (:mod:`repro_torch.core.annotations`), overflow-unsafe
  timestamp reductions, sentinel-blind argmin/argmax and journal widths;
* :mod:`.lint` (W01-W06): stdlib AST lint over the port's source; W06 is
  the port's own rule, a clamped gather index fed to a scatter (fault F1);
* :mod:`.kernel_audit` (K3, K5) and :mod:`.sanitize` (the run checks on
  the card that stand in for K1 and K2 over CUDA C++).

Run them with ``python -m repro_torch.analysis [--strict] [--device cpu]``;
suppress a proven-safe site with ``# analysis: safe(Wxx): reason``. The
known-bad corpus in ``tests/analysis_corpus_torch/`` tests the analyzer
itself.
"""
from repro_torch.analysis.rules import (  # noqa: F401
    RULES, Finding, canonical, scan_suppressions, suppression_for)

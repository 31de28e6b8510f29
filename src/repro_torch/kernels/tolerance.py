"""How closely each LM kernel is held to its plain version.

``LM_TOL`` (attention and the expert FFN) and ``MAMBA_TOL`` (the scan) give
atol = rtol per input dtype, as the reference's kernel tests hold its
kernels (``tests/test_kernels.py``: bfloat16 2e-2, the scan in bfloat16
5e-2). In bfloat16 the plain version rounds where the reference rounds
(the attention scores to bfloat16 before the softmax), so the kernel,
which computes in float32, is no closer to it than that.

A bfloat16 call is also held against the plain version on float32 copies
of its inputs. The two then differ by the kernel's rounding of its output
to bfloat16 (at most 2^-8 of a value) and float32 noise, so the limit is
``F32_PLAIN_RTOL`` of each value plus ``F32_PLAIN_ATOL_RMS`` of the plain
output's root mean square.
"""
from __future__ import annotations

LM_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
MAMBA_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
TOL = {"flash_attention": LM_TOL, "paged_attention": LM_TOL,
       "moe_gmm": LM_TOL, "mamba_scan": MAMBA_TOL}

F32_PLAIN_RTOL = 2.0 ** -7
F32_PLAIN_ATOL_RMS = 1e-3

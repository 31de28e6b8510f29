"""The LM model stack (``repro/models``) for attention architectures:
primitives (``common``), MoE (``moe``), layer blocks (``blocks``), the
transformer (``transformer``) and its API (``api``); ``recurrent`` holds
the chunked linear recurrence the scan kernel's plain version runs."""

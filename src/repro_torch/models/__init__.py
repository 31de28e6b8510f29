"""Model primitives of the LM side: what the LM kernels' plain versions
delegate to (``common``: chunked and decode attention; ``recurrent``: the
chunked linear recurrence)."""

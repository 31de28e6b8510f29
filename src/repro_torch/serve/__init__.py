"""Serving: the paged KV cache's page data and sequence table, and the
gather that the paged attention kernel's plain version runs."""

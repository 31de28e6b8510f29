"""Checkpoints of the memory-server state (paper §6.2)."""

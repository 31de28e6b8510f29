"""Synthetic inputs of the LM side."""

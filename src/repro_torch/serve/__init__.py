"""Serving: the paged KV pool (``kvcache``) and the continuous-batching
engine over it (``engine``)."""

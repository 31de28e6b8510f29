"""PyTorch port of the NAM-DB reproduction (``repro``), for NVIDIA Hopper.

It imports nothing of the JAX package; see README.md for its conventions.
"""

"""Public model API (``repro/models/api.py``): ``build(arch)`` → Model with
its init, train and serve entry points.

The reference's ``param_shapes``, ``input_specs`` and ``cache_specs`` are
``jax.eval_shape`` dry runs for its ``launch/`` tools; they wait for the
port's analogues of those tools.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def init(self, generator: torch.Generator, dtype=None,
             device=None) -> transformer.Transformer:
        """Random weights from ``generator`` on ``device`` (the card unless
        the CPU is asked for)."""
        return transformer.init_params(self.cfg, generator, device, dtype)

    def train_loss(self, params, batch):
        """The scalar loss of ``batch`` (``transformer.train_loss``), on
        the plain path."""
        return transformer.train_loss(self.cfg, params, batch)

    def prefill(self, params, batch, max_len: int, kernels=True):
        """``batch``: ``tokens`` [B, S], and ``frames`` [B, encoder_seq,
        D] (encoder-decoder) or ``patches`` [B, prefix_len, D]
        (prefix-LM), the stub frontends' embeddings."""
        return transformer.prefill(self.cfg, params, batch, max_len,
                                   kernels)

    def decode_step(self, params, cache, token, kernels=True):
        return transformer.decode_step(self.cfg, params, cache, token,
                                       kernels)


def build(cfg: ArchConfig) -> Model:
    return Model(cfg=cfg)

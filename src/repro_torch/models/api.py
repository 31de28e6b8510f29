"""Public model API (``repro/models/api.py``): ``build(arch)`` → Model with
its init, train and serve entry points, and the dry run's shape-only
specs.

The reference builds ``param_shapes``, ``input_specs`` and
``cache_specs`` with ``jax.eval_shape``; their counterpart is torch's
``meta`` device: tensors with a shape and a dtype and no storage, which
every op of the plain path accepts, so that ``launch/dryrun.py`` runs a
whole step of any size with no allocation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import transformer

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def init(self, generator: torch.Generator, dtype=None,
             device=None) -> transformer.Transformer:
        """Random weights from ``generator`` on ``device`` (the card unless
        the CPU is asked for)."""
        return transformer.init_params(self.cfg, generator, device, dtype)

    def param_shapes(self, dtype=None) -> transformer.Transformer:
        """The parameters on the ``meta`` device: shapes and dtypes, no
        allocation (for the dry run's specs and memory)."""
        return transformer.init_params(self.cfg, None, META, dtype)

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

    def _frontend(self, B: int) -> Dict[str, torch.Tensor]:
        """The stub frontends' embeddings of a batch of ``B``, on meta."""
        cfg = self.cfg
        specs = {}
        if cfg.is_encdec:
            specs["frames"] = _meta((B, cfg.encoder_seq, cfg.d_model),
                                    cfg.param_dtype)
        if cfg.is_prefix_lm:
            specs["patches"] = _meta((B, cfg.prefix_len, cfg.d_model),
                                     cfg.param_dtype)
        return specs

    def input_specs(self, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
        """The step's inputs as meta tensors, the reference's keys, shapes
        and dtypes: ``tokens``, ``targets`` (int32) and ``mask`` (float32)
        [B, S] to train, ``tokens`` to prefill, each with the frontends'
        embeddings; ``token`` [B] to decode."""
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "train":
            return {"tokens": _meta((B, S), torch.int32),
                    "targets": _meta((B, S), torch.int32),
                    "mask": _meta((B, S), torch.float32),
                    **self._frontend(B)}
        if shape.kind == "prefill":
            return {"tokens": _meta((B, S), torch.int32),
                    **self._frontend(B)}
        # decode / long_decode: one new token against a cache of S tokens
        return {"token": _meta((B,), torch.int32)}

    def cache_specs(self, shape: ShapeConfig) -> transformer.DecodeCache:
        """The ``DecodeCache`` holding ``seq_len`` keys, on meta: the
        reference's dry run, ``prefill`` of a 4-token prompt (behind the
        frontends' embeddings) with ``max_len = seq_len``."""
        B = shape.global_batch
        batch = {"tokens": _meta((B, 4), torch.int32), **self._frontend(B)}
        _, cache = self.prefill(self.param_shapes(), batch, shape.seq_len,
                                kernels=False)
        return cache


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def build(cfg: ArchConfig) -> Model:
    return Model(cfg=cfg)

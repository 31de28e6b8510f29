"""Deterministic synthetic token pipeline (``repro/data/pipeline.py``):
``DataConfig``, ``make_batch`` for training and ``make_prompts`` for
serving.

Every ``(seed, step, shard)`` seeds its own ``torch.Generator``, so any
step of any shard can be regenerated exactly, which a restart's journal
replay needs, without saving the iterator's state. The reference folds
``step`` and ``shard`` into a threefry key; the port does not port
threefry (its draws differ), and takes the reference's draws through
``draws`` where a test holds the two against each other.

Token streams repeat a per-sequence motif with uniform noise, so a model
can learn next-token prediction within tens of steps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    motif_len: int = 16
    noise: float = 0.1
    seed: int = 42


def _generator(*ints) -> torch.Generator:
    """A CPU generator of its own for the tuple ``ints``."""
    seed = np.random.SeedSequence([int(i) for i in ints]) \
        .generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed) & (2 ** 63 - 1))


def _draws(cfg: DataConfig, step: int, shard: int, b: int, arch) -> dict:
    """The random draws of one batch: ``motif`` [b, motif_len] and
    ``noise_tok`` [b, seq_len + 1] uniform in ``[0, vocab)``, ``uniform``
    [b, seq_len + 1] in [0, 1), and N(0, 1) ``frames`` or ``patches`` in
    the architecture's dtype where it takes them."""
    S1 = cfg.seq_len + 1
    g = _generator(cfg.seed, step, shard)
    out = {"motif": torch.randint(0, cfg.vocab, (b, cfg.motif_len),
                                  generator=g),
           "noise_tok": torch.randint(0, cfg.vocab, (b, S1), generator=g),
           "uniform": torch.rand((b, S1), generator=g)}

    def normal(seed, n):
        return torch.randn((b, n, arch.d_model), generator=_generator(
            seed, step, shard)).to(arch.param_dtype)
    if arch is not None and arch.is_encdec:
        out["frames"] = normal(cfg.seed + 1, arch.encoder_seq)
    if arch is not None and arch.is_prefix_lm:
        out["patches"] = normal(cfg.seed + 2, arch.prefix_len)
    return out


def make_batch(cfg: DataConfig, step: int, shard: int = 0, n_shards: int = 1,
               arch=None, *, device=None, draws: Optional[dict] = None
               ) -> Dict[str, torch.Tensor]:
    """Batch for (step, shard) on ``device`` (the card unless the CPU is
    asked for): ``tokens`` and ``targets`` [b, seq_len] int32, the
    sequence and the sequence shifted by one; ``mask`` float32 ones; and
    ``frames`` [b, encoder_seq, D] (encoder-decoder) or ``patches`` [b,
    prefix_len, D] (prefix-LM), ``0.1 · N(0, 1)`` in ``arch.param_dtype``.
    Each sequence tiles its motif to ``seq_len + 1`` tokens, and a token
    whose uniform draw falls below ``noise`` is replaced by its noise
    token. ``draws`` gives the draws (``_draws``' keys, any array type)
    instead of the generators; the batch is made from them on the CPU
    and moved to ``device``, so it is the same on every device."""
    assert cfg.global_batch % n_shards == 0
    dev = resolve_device(device)
    b = cfg.global_batch // n_shards
    if draws is None:
        draws = _draws(cfg, step, shard, b, arch)
    d = {k: torch.as_tensor(np.asarray(v)) if not isinstance(
        v, torch.Tensor) else v for k, v in draws.items()}
    reps = -(-(cfg.seq_len + 1) // cfg.motif_len)
    seq = d["motif"].long().repeat(1, reps)[:, : cfg.seq_len + 1]
    flip = d["uniform"].float() < cfg.noise
    seq = torch.where(flip, d["noise_tok"].long(), seq)
    batch = {"tokens": seq[:, :-1].to(torch.int32),
             "targets": seq[:, 1:].to(torch.int32),
             "mask": torch.ones((b, cfg.seq_len), dtype=torch.float32)}
    for name in ("frames", "patches"):
        if name in d:
            dt = arch.param_dtype
            batch[name] = torch.tensor(0.1, dtype=dt) * d[name].to(dt)
    return {k: v.to(dev) for k, v in batch.items()}


def make_prompts(seed: int, n: int, vocab: int, min_len: int = 4,
                 max_len: int = 12):
    """Random prompts for the serving examples and benchmarks: ``n`` int32
    arrays of ``min_len..max_len`` tokens in ``[2, vocab)``. ``seed`` takes
    the place of the reference's JAX key: the reference seeds numpy with
    ``int(jax.random.randint(key, (), 0, 2**31 - 1))``, so that integer
    here gives the same prompts."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(min_len, max_len + 1, size=n)
    return [rng.integers(2, vocab, size=l).astype(np.int32) for l in lens]

"""Perf policy (``repro/policy.py``): the named knobs of the reference's
roofline hillclimb, the port's own copy, so that the port's train step
reads the port's policy.

On one card the port honours the fields that shape its computation:

  * ``remat`` — the activation checkpoint policy of the train step
    (``train/trainstep.py``);
  * ``n_microbatches`` — the gradient-accumulation depth (None: the
    caller's);
  * ``remat_unit`` — checkpoint each scanned unit of the layer stack
    (``models/transformer.py``);
  * ``remat_save_block_out`` — with ``remat_unit``, keep the block
    outputs and recompute each block's body alone;
  * ``constrain_activations`` — with a live shape-only mesh
    (``launch/mesh.py``), ``moe.apply_moe`` dispatches per data shard
    (``moe.apply_moe_sharded``), as the reference's does;
  * ``embed_lookup_model_sharded`` — the embedding's partition rule in
    ``launch/sharding.param_pspecs``.

The others steer GSPMD's partitioning and its collectives, which one
card does not run: ``ce_vocab_sharded``, ``ar_dtype_bf16``, ``pin_grads``,
``kv_local_update`` and ``recurrent_local``. They are kept, with the
reference's values in every named policy, so that the names and the
policies are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class PerfPolicy:
    name: str = "baseline"
    embed_lookup_model_sharded: bool = False
    constrain_activations: bool = False
    ce_vocab_sharded: bool = False
    ar_dtype_bf16: bool = False
    remat: str = "nothing_saveable"
    n_microbatches: Optional[int] = None    # None → driver default
    # §Perf iter 4: checkpoint the scanned unit body. Without it the unit
    # scan saves EVERY intermediate (incl. [E,C,D] MoE buckets) for the
    # backward pass — at mixtral scale 1.15 TB/device of saved residuals.
    remat_unit: bool = False
    # §Perf iter 5: with remat_unit, also save named block outputs so the
    # backward recompute skips re-running attention/MoE bodies (and their
    # collectives). Costs 2 carry-sized saves per unit.
    remat_save_block_out: bool = False
    # §Perf iter 7: constrain weight grads to the parameter sharding inside
    # the accumulation loop (reduce-scatter, not all-reduce + full buffer).
    pin_grads: bool = False
    # §Perf iter D1: decode KV write via shard_map (owner-shard local row
    # update) instead of a GSPMD-rewritten replicated f32 scatter.
    kv_local_update: bool = False
    # §Perf iter X2 (xlstm): pin the sLSTM time-scan carry to batch over
    # (data, model) jointly — one reshard per layer replaces a [B,4D]
    # all-reduce per TIMESTEP (4096/step). (X1 — replicating the recurrent
    # params over model — was REFUTED: duplicate compute + f32 gathers.)
    recurrent_local: bool = False


POLICIES = {
    "baseline": PerfPolicy(),
    # incremental steps of the hillclimb (§Perf iteration log)
    "opt-embed": PerfPolicy(name="opt-embed",
                            embed_lookup_model_sharded=True,
                            constrain_activations=True),
    "opt-remat-unit": PerfPolicy(name="opt-remat-unit",
                                 embed_lookup_model_sharded=True,
                                 constrain_activations=True,
                                 ce_vocab_sharded=True,
                                 ar_dtype_bf16=True,
                                 n_microbatches=1,
                                 remat_unit=True),
    "opt-ce": PerfPolicy(name="opt-ce",
                         embed_lookup_model_sharded=True,
                         constrain_activations=True,
                         ce_vocab_sharded=True),
    "opt-bf16": PerfPolicy(name="opt-bf16",
                           embed_lookup_model_sharded=True,
                           constrain_activations=True,
                           ce_vocab_sharded=True,
                           ar_dtype_bf16=True),
    # §Perf iteration 3 decomposition
    "opt-micro1": PerfPolicy(name="opt-micro1",
                             embed_lookup_model_sharded=True,
                             constrain_activations=True,
                             ce_vocab_sharded=True,
                             ar_dtype_bf16=True,
                             n_microbatches=1),
    "opt-dots": PerfPolicy(name="opt-dots",
                           embed_lookup_model_sharded=True,
                           constrain_activations=True,
                           ce_vocab_sharded=True,
                           ar_dtype_bf16=True,
                           remat="dots_saveable"),
    # the full beyond-paper-baseline variant (== opt-micro1: dots_saveable
    # was REFUTED in §Perf iter 3b — saved dot outputs cost more HBM traffic
    # than the remat recompute they avoid at these shapes)
    "opt": PerfPolicy(name="opt",
                      embed_lookup_model_sharded=True,
                      constrain_activations=True,
                      ce_vocab_sharded=True,
                      ar_dtype_bf16=True,
                      remat="nothing_saveable",
                      n_microbatches=1,
                      remat_unit=True,
                      remat_save_block_out=True,
                      pin_grads=True,
                      kv_local_update=True,
                      recurrent_local=False),  # X1+X2 both REFUTED (§Perf)
    # §Perf iter D2: decode/long_decode want the opposite trade — weights
    # stay fully sharded (the activations are ONE token, so AR-ing them is
    # nearly free, while re-gathering weights per step is not). Only the
    # owner-shard KV write stays on.
    "opt-decode": PerfPolicy(name="opt-decode", kv_local_update=True),
}

_CURRENT = POLICIES["baseline"]


def set_policy(p) -> PerfPolicy:
    global _CURRENT
    if isinstance(p, str):
        p = POLICIES[p]
    _CURRENT = p
    return p


def current() -> PerfPolicy:
    return _CURRENT

#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py [--rounds 32] [--mix-rounds 32] [--probe-rounds 8]
                          [--seed 0] [--profile-rounds 4] [--lm-reps 20]
                          [--durable-rounds 8] [--shards 4]
                          [--shard-rounds 8] [--oracle-rounds 32]
                          (phases 12-15, the LM models and training,
                          take --seed)

Phases, each fatal on failure:

1. build the seven CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
   each, started together), print every kernel function's registers and
   spills as ``ptxas -v`` reports them, and count the tensor-core MMA
   instructions (``HMMA``, ``HGMMA``) of each function in the built
   ``flash_attention`` and ``moe_gmm`` libraries (``cuobjdump -sass``):
   every function of their bf16 routes must have some;
2. load TPC-C at one NAM-DB memory server's scale (50 warehouses, 100,000
   items, 3,000 customers per district, 60 threads) on the card;
3. run ``batched_probe`` and ``fused_commit`` and their plain versions on
   clones of one real new-order round's inputs and of a constructed
   adversarial case (with write slots out of range, one of them granted
   beside a request of its priority): outputs and state planes must be
   bit-identical, and the commit wrapper must not wait on the device (a
   call under ``torch.cuda.set_sync_debug_mode("error")``);
4. new-order path: run ``--rounds`` new-order rounds through the kernels
   (key-addressed, ``batched_probe`` and ``fused_commit`` on) and the same
   inputs from a cloned start state through the plain path: per-round
   outcomes and the final state must be identical, both kernels must have
   launched, and some transactions must commit;
5. mix path: the same for ``--mix-rounds`` rounds of the full
   five-transaction mix (45/43/4/4/4) from the loaded state: every
   sub-round's outcomes, every run statistic and the final state must be
   identical, all five types must run, some delivery must deliver, some
   order-status must find an order, and both kernels must launch inside
   every payment and delivery sub-round;
6. ``hash_probe`` path: ``--probe-rounds`` more mix rounds in which every
   keyed read of an order-status or stock-level sub-round is also resolved
   through ``kernels.hash_probe.ops.hash_probe`` on the same state and
   keys: (a) the kernel must equal its plain version bit for bit, and its
   locator gathered with ``mvcc.gather_version`` must equal the round's own
   ``lookup`` + ``read_visible``; then (b) the probe bench's point (2^18
   buckets, load 0.45, 8,192 queries, 8 old and 16 overflow versions) and
   (c) an adversarial case over every key of the path and of records
   written twice (absent keys, invalidated entries, and in turn a halved
   snapshot and one a commit older), and over the same keys under a
   snapshot that hides the newest write of one rewritten record, are held
   the same way: some reads of (c) must be served from the old ring and
   some from the overflow ring;
7. time the rounds, each kernel (CUDA events) beside its bound, its
   plain version and the launch floor (an empty kernel, and the commit
   kernel's cluster with no barrier and with its three), and profile a few
   rounds of each path for the device breakdown, each protocol kernel's
   CUDA launches a round (a new-order round must launch each once) and
   the host synchronisations a round;
8. the LM kernels on their entry points: ``flash_attention``,
   ``paged_attention``, ``moe_gmm`` and ``mamba_scan`` (``ops``) at the full
   widths of gemma2-27b (local and global attention layers, decode over a
   paged cache of 32 sequences of up to 32,768 tokens, and of 32 of
   32,768 each), mixtral-8x22b (an attention layer at S = 8,192, the
   experts at 4,096 tokens) and jamba-v0.1 (a mamba layer), and at the
   four points of ``benchmarks/bench_kernels.py``, in bfloat16: each call
   once with the launch counts reset, then each output held against the
   plain version
   (atol = rtol = 2e-2, mamba 5e-2) and against the plain version on
   float32 copies of its inputs (2^-7 of each value plus 1e-3 of the
   output's RMS, ``kernels/tolerance.py``), timed (after a discarded
   round of warm-up launches: the first round after the plain versions ran
   up to 17 % slower on the paged cases) beside its bound, its plain
   version and, for the mixtral attention layer, SDPA; beside each
   expert FFN call the same products as cuBLAS bf16 ``torch.bmm`` are
   timed as a tensor-core yardstick (never on the path, and not the same
   function: it rounds ``a·h`` to bf16). Two more
   calls of the gemma2 local layer, with queries scaled by 2 and by 16 so
   that the logits reach the softcap's range, are held to the float32
   plain version alone. Each paged case prints its live partitions and
   blocks, each scan case its blocks and warps an SM;
9. the durability path, with the settings of the reference's kill bench
   (``bench_tpcc_scaling.py --kill``: a GC sweep every 2 rounds with
   E = 1, a journal of ``5 (n + 2)`` entries a thread, checkpoints into a
   temporary directory that is deleted afterwards), on the state the
   earlier phases left: ``--durable-rounds`` (n) full-mix rounds.
   (a) The kernel path, journalled, checkpointed and uninterrupted,
   against the same draws on the plain path from a cloned start state:
   every sub-round's outcomes, every statistic (``gc_sweeps`` and
   ``reclaim_traj`` included), every journal leaf and the final state must
   be identical, both kernels must launch in every write sub-round, and
   the sweeps must reclaim overflow slots. (b) The kernel path killed at
   round ``(n // 2) | 1`` with intents in flight and recovered, against
   (a): the final state with its vector, the statistics and the resolved
   journal entries must be identical, the replicas equal after
   ``rereplicate``, the checkpoint older than the kill and some intent
   undetermined. (c) ``hash_probe`` against its plain version over every
   record whose overflow ring (a) touched, under the last sweep's safe
   vector and each snapshot of its log: some reads must be served from an
   overflow ring and some probed rings must hold reclaimed slots. It
   prints each checkpoint save's bytes and seconds, the restore and replay
   seconds, ``recovery_seconds``, each sweep's device time and the
   durable round's median beside phase 5's, each beside the card's name
   and power limit;
10. the sharded store: NAM-DB §7's deployment of 50 warehouses and 60
   threads a memory server on ``--shards`` (S, default 4) servers, the
   servers a leading shard axis of one padded pool on the card
   (``store.distributed_round``), the vector partitioned over them, with
   the pool's size reckoned from the catalog first. (a) ``--shard-rounds``
   (n) full-mix rounds over the servers with both kernels (a locate-only
   ``batched_probe`` launch a server, and ``fused_commit``'s decide and
   apply launch a server, in every new-order, payment and delivery
   sub-round: counted and checked), a GC sweep every 2 rounds (E = 1) and
   a journal of a replica a server, against the same draws over the
   servers on the plain path and through the single-server driver with and
   without the kernels on the unpadded pool: every sub-round's outcomes,
   every statistic, every journal leaf and the final state (trimmed to the
   real records) must be identical, and some transactions must commit;
   then one more new-order round whose kernel calls are kept, so that each
   server's probe, decide and apply launch is held against its plain twin
   (the decide launch must write nothing) and timed with CUDA events beside
   the single-server ``fused_commit`` of a round at the same scale, and
   two rounds of each engine are profiled (CUDA launches and host
   synchronisations a round). (b) The same run, checkpointed, killed at
   round ``(n // 2) | 1`` with intents in flight on server S − 1, whose
   view and journal replica are overwritten before the recovery: the final
   state, the statistics and the resolved journal entries must equal (a),
   the replicas must be equal after ``rereplicate`` and some intent
   undetermined. (c) The same run born on S / 2 servers and grown to S at
   round 3 must equal (a), and its report must show moved slots and
   buckets. It prints each sub-phase's seconds, ``recovery_seconds`` and
   ``migration_seconds``, each beside the card's name and power limit;
11. the timestamp oracles (paper §3.1, §4.2). (a) At phase 2's
   deployment, from the loaded state, ``--oracle-rounds`` (n) full-mix
   rounds under each of ``VectorOracle(60)``,
   ``CompressedVectorOracle(60, threads_per_server=60)`` (one compute
   server co-located with its memory server, NAM-DB §7: the 60 threads
   share one slot) and ``NaiveOracleAdapter(60, capacity=1 << 16)`` (the
   global counter's own capacity), on the same draws: for each, the kernel
   path against the plain path from a cloned start (every sub-round's
   outcomes, every statistic, the final state with the oracle's whole
   state) and both kernels once in every write sub-round; across oracles,
   every sub-round's outcomes and the payloads must equal the vector
   oracle's (the headers differ by design). Each oracle's round medians,
   kernel path and plain, and two profiled rounds (launches and host
   synchronisations a round: the runtime's synchronising calls, which
   every copy the host waits for ends in, and the operators that read the
   device's values, ``_local_scalar_dense`` and ``nonzero``, both counted
   on the host's side of the trace, must not exceed the vector oracle's;
   the device-side copies to the host, whose records vary between runs of
   one code, are printed alone) are printed, and the naive counter beside
   its capacity. (b) Phase 10's deployment on its loaded pool under ``CompressedVectorOracle(60 S,
   threads_per_server=60)``, the vector replicated (S slots): ``--shard-
   rounds`` journalled mix rounds with a GC sweep every 2 rounds over the
   servers with both kernels, against the plain path over the servers and
   the one-server driver with the kernels (outcomes, statistics, journal,
   state). (c) ``si.run_rounds``: 16 rounds of a seeded synthetic stream
   of 60 transactions (8 distinct reads over the pool's first 2,048
   records, 4 writes inside them) with ``staleness`` 0 and 2, the kernel
   path against the plain path bit for bit; and from each round's shared
   start a 2-stale snapshot must commit a subset of what the fresh one
   commits, with some extra abort;
12. the LM serve path (``serve.engine.Engine`` over ``models``): random
   bf16 weights from ``--seed`` at full width, depth cut (mixtral-8x22b,
   8 of 56 layers, 40.5 GB; gemma2-27b, 4 of 46, two local/global
   units), ``examples/serve_lm.py``'s traffic (``EngineConfig(8, 16,
   1024, 4352)``, 12 requests of ``make_prompts`` at 32-1,024 tokens, the
   ninth replaced by one of 4,100, admitted in two waves of at most 8,
   ``max_new`` 16, stragglers forced done and released). The kernel engine
   and the plain engine run in lockstep, the plain engine's tokens and
   ``done`` copied into the kernel engine after every admission and step,
   and each of the plain engine's MoE layers on the expert choices of the
   kernel engine's same call (weighted by its own router's
   probabilities), so the two differ by the kernels' arithmetic alone:
   the integer state (page headers, refcounts, page table, lengths,
   flags, epoch) must be bit-identical throughout; the first layer's K/V
   bit-identical and every layer's at every written position within a
   relative RMS difference of ``SERVE_RRMS["kv"]``; every row of each
   admission's and step's logits within ``SERVE_RRMS["logits"]``;
   greedy tokens equal wherever the plain path's top-1/top-2 margin
   exceeds 4x the position's max |logit difference| (every prompt
   position and every decode row; at least one such position a
   request). Where the plain router's own choice differs from the kernel
   engine's (another expert, or the other side of a capacity), at its
   first such layer it must nearly tie (``SERVE_ROUTER_TIE``) or its
   rank lie within ``SERVE_EDGE_RANKS`` of the capacity's edge, and at
   most ``SERVE_DIVERTED_ADMIT`` of an admission's tokens may differ (a
   step's lanes are counted). The first and
   the last call of each kernel in every admission and step must match
   its plain version
   (``tolerance``);
   ``flash_attention`` must launch once a layer an admission,
   ``paged_attention`` once a layer a step with a lane in its contract
   (the other lanes, checked against the contract from the table, go
   through the plain sub-batch and must give the plain engine's rows at
   the first layer), ``moe_gmm`` once a MoE layer an admission and a step.
   Both paths then run the traffic alone, timed: prefill ms a wave, the
   median decode step, decoded tokens/s, and over a profiled admission and
   4 profiled steps the host syncs a step, the idle share and each
   kernel's device time a call beside the mean bound of the same calls
   (recorded in a replay of that admission and those steps);
13. the recurrent and hybrid models through ``Model.prefill`` /
   ``decode_step`` (phase 12's model freed first), 4 prompts of 1,000
   tokens each (not a multiple of the scan's 64-step chunk), then 16
   greedy decode steps. (a) jamba-v0.1-52b at full width, one unit of 8
   of its 32 layers (7 mamba, attention at 3, MoE at the odd positions;
   26 GB of bf16 weights from ``--seed``): the kernel path and the plain
   path (``kernels=False``) in lockstep on one model, both fed the plain
   path's greedy tokens, the plain path's MoE layers replaying the kernel
   path's expert choices (so the two differ by the kernels' arithmetic
   alone). ``flash_attention`` must launch once and
   ``mamba_scan`` once a mamba layer (7) a prefill, ``moe_gmm`` once a
   MoE layer a prefill and a step; the first and last call of each
   kernel in the prefill and every step must match its plain version
   (the scan's y and last state within ``MAMBA_TOL`` of float32);
   ``kv_len`` equal; the first layer's conv state bit-identical; every
   layer's conv state, SSM state and K/V and every row of logits within
   a relative RMS difference of ``JAMBA_RRMS`` (0.03, 0.05, 0.015 and
   0.03); the plain router's own other choices first at a margin of at
   most 0.02 and, over a prefill, a share of at most 0.4; greedy tokens
   equal where the margin tests them (every prompt position and every
   step, at least one a prompt). Both paths then run the traffic
   alone, timed (prefill ms, the median decode step, idle share, host
   syncs), with each kernel's device time a call beside its bound. (b)
   xlstm-350m at full width and depth in bf16 (no kernel serves mLSTM or
   sLSTM: none may launch), timed the same way; then one unit (an mLSTM
   and an sLSTM layer) in float32 on the card and on the CPU with the same
   weights and tokens: the logits and every cache leaf within a relative
   RMS difference of 1e-4 after the prefill of the prompts' first 128
   tokens and every step after it, and of 1e-3 over the whole prompts
   (float32 itself drifts from exact arithmetic as the sLSTM's sequence
   grows: ``scripts/xlstm_unit_precision.py``);
14. the encoder-decoder and prefix-LM models through ``Model.prefill`` /
   ``decode_step`` (phase 13's models freed first), each at full width
   and depth with bf16 weights from ``--seed``: whisper-medium, 8 clips of
   its 1,500-frame (30 s) window as stub embeddings (0.1·N(0, 1)) and a
   4-token prompt; paligemma-3b, 8 images of 256 patch embeddings and 32
   text tokens (S = 288); then 16 greedy decode steps. The kernel path
   and the plain path in lockstep on one model, both fed the plain path's
   greedy tokens: ``flash_attention`` must launch once an encoder layer,
   once a decoder layer's self-attention and once a cross-attention a
   whisper prefill (72) and once a cross-attention a step (24), twice a
   paligemma layer a prefill (a causal launch over the 288 rows and a
   non-causal one over the 256-patch prefix: 36) and never a step, and no
   other kernel may launch; the first and the last call of each kind
   (encoder, decoder self-attention, cross-attention at prefill and at
   decode, prefix causal and prefix block) in the prefill and every step
   must match its plain version (``tolerance``); ``kv_len`` equal; the
   first layer's K/V bit-identical; every layer's K/V, whisper's encoder
   output at its full 1,500 frames and every row of logits within a
   relative RMS difference of ``ENCDEC_RRMS``; greedy tokens equal where
   the margin tests them (every prompt position and every step, at least
   one a prompt). Each kind's first call is then timed with CUDA events
   beside its bound, its plain version and SDPA on the same inputs, and
   both paths run the traffic alone, timed (prefill ms, the median decode
   step, idle share, host syncs), with the kernel's device time a call
   beside its bound;
15. training (phase 14's models freed first; deterministic algorithms on
   for this phase alone, with ``CUBLAS_WORKSPACE_CONFIG`` set before CUDA
   starts). (a) granite-3-8b at full width (d 4,096, 32 heads over 8 KV
   heads of 128, d_ff 12,800, vocab 49,155), 8 of its 40 layers, bf16
   weights from ``--seed`` (1.80 B parameters): 24 steps of
   ``train.trainstep.make_train_step`` (``DataConfig(vocab=49155,
   seq_len=1024, global_batch=8)``, 2 microbatches, the ``baseline``
   policy's ``nothing_saveable`` remat, ``AdamWConfig(lr=3e-4,
   warmup_steps=8, total_steps=24)``): every loss and gradient norm
   finite, the mean of the last 4 losses below the first, and no LM
   kernel launched (the train step differentiates the plain path); it
   prints the median step, tokens/s, the matrix products' flops against
   the bf16 peak, ``max_memory_allocated``, and over 2 profiled steps the
   idle share, host syncs a step and the device time of the matrix
   products, the plain attention, the cross-entropy and the optimizer.
   (b) One float32 layer at the same width, B = 2, S = 128, TF32 off: the
   loss and every gradient leaf on the card against the host CPU, and 2
   microbatches against 1 on the card, within ``TRAIN_UNIT_RRMS``; the
   three remat policies bit-identical to no remat on the card; the CPU's
   pass runs on a second host thread while (c) runs. (c)
   ``examples/train_lm_torch.py``'s scenario at its 10m preset (60 steps,
   a checkpoint every 20, a failure at 35 recovered from the checkpoint
   and the journal): the recovered parameters equal the uninterrupted
   run's bit for bit.
16. the ``launch/`` analogues (phase 15's model freed first). (a) The dry
   run (``launch/dryrun.count_cell``) on this host's CPU, on meta tensors:
   phase 15's step (granite-3-8b, 8 layers, 8 × 1,024 tokens in 2
   microbatches, ``nothing_saveable``) and phase 12's mixtral-8x22b at its
   8 layers (a prefill of 8 × 1,024 tokens and a decode step over a
   1,024-position cache): counted FLOPs, model FLOPs and argument bytes;
   phase 15's measured median step as a share of the bf16 peak from both
   FLOP counts; ``fits_one_card`` of every architecture × shape at full
   depth when that sweep takes at most 60 s. These are counts on the H100
   spec constants, not card times. (b) ``moe.apply_moe_sharded`` at
   mixtral-8x22b width (one MoE layer's weights from ``--seed``), 8,192
   tokens, under the ``opt`` policy on a (4, 1) and a (2, 2) shape-only
   mesh: at a dropless capacity each mesh's routing and ``load`` equal the
   global dispatch's, and the (4, 1) mesh's y equals the global kernel
   path's bit for bit (the (2, 2) mesh's two F-slices' bf16 partials are
   summed, so it is held within ``tolerance``); at ``capacity_factor``
   1.25 every mesh's kernel path equals its plain path within the
   ``moe_gmm`` tolerance, with ``load`` and ``dropped_fraction`` equal;
   ``moe_gmm`` launches once a model slice a call; the dispatches and the
   (4, 1) mesh's ``moe_gmm`` launch over ``[E, |dp|·C_l, D]`` are timed
   with CUDA events beside its bound and its plain version. (c) One
   ``Model.prefill`` of mixtral-8x22b at full width, 2 of its 56 layers,
   8 prompts of 1,024 tokens, under the opt policy and the (4, 1) mesh:
   ``moe.apply_moe_sharded`` runs once a MoE layer a path,
   ``flash_attention`` and ``moe_gmm`` launch once a layer, and the
   kernel path is held against the plain path on its expert choices by
   phase 12's rule.
17. the protocol analyzer's card-only parts (``repro_torch.analysis``),
   last, (c) first and (a) last. (a) K3: every (function, threads,
   dynamic shared memory) the wrappers recorded as they launched in
   phases 3-16 and (c) (``kernel_audit.launched``), each kernel at least
   once, against its
   built function's static shared memory and registers
   (``cuobjdump --dump-resource-usage``):
   static plus dynamic shared memory within the card's
   ``shared_memory_per_block_optin``, which must equal ``_cuda.MAX_SMEM``,
   and registers times threads within an SM's 65,536. (b) The
   dispatch-level audit (A1-A4) on CUDA tensors: the four entry points of
   ``graph_audit.ENTRYPOINTS`` at their fixture size, and one new-order
   sub-round at phase 2's scale (50 warehouses, 60 threads, reloaded) on
   the unfused path; no active finding (a missing A1 tag, or a grant that
   does not flow into the release and the commit, is one: W01). (c) The kernels' run
   checks (``analysis/sanitize.py``): each of the seven kernels three
   times on adversarial inputs inside canary margins, over scratch
   poisoned with 0x00 and 0xFF: margins intact, the runs bit-identical,
   the plain version held. ``compute-sanitizer`` refuses this card
   ("Device not supported"), so it is not run. Every part is fatal.

It prints the card, the kernels' JSON line, and as its last line
``{"ok": true, "device": {...}}``. Without a card it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# deterministic cuBLAS for phase 15's exact recovery: read when CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch._u32 import rows_of, to_i32, u64  # noqa: E402
from repro_torch.checkpoint import snapshot  # noqa: E402
from repro_torch.core import gc as gc_ops, store, wal  # noqa: E402
from repro_torch.core import hashtable as ht, mvcc  # noqa: E402
from repro_torch.core import header as hdr_ops  # noqa: E402
from repro_torch.core import si, tsoracle  # noqa: E402
from repro_torch.core.tsoracle import VectorOracle  # noqa: E402
from repro_torch.core.tsoracle import PartitionedVectorOracle  # noqa: E402
from repro_torch.core.tsoracle import CompressedVectorOracle  # noqa: E402
from repro_torch.core.tsoracle import NaiveOracleAdapter  # noqa: E402
from repro_torch.db import tpcc, workload  # noqa: E402
from repro_torch.kernels import _build, _cuda  # noqa: E402
from repro_torch.kernels.commit import ops as commit_ops  # noqa: E402
from repro_torch.kernels.commit import ref as commit_ref  # noqa: E402
from repro_torch.kernels.hash_probe import ops as probe_ops  # noqa: E402
from repro_torch.kernels.hash_probe import ref as probe_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.kernels.mamba_scan import ops as mamba_ops  # noqa: E402
from repro_torch.kernels.mamba_scan import ref as mamba_ref  # noqa: E402
from repro_torch.kernels.moe_gmm import ops as moe_ops  # noqa: E402
from repro_torch.kernels.moe_gmm import ref as moe_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as paged_ops  # noqa: E402
from repro_torch.kernels.paged_attention import ref as paged_ref  # noqa: E402
from repro_torch.kernels import tolerance  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.pipeline import make_prompts  # noqa: E402
from repro_torch.models import common as model_common  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import api, transformer  # noqa: E402
from repro_torch.models import blocks as model_blocks  # noqa: E402
from repro_torch.serve import engine as serve_engine  # noqa: E402
from repro_torch import policy as perf_policy  # noqa: E402
from repro_torch.configs import SHAPES  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun as launch_dryrun  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_host_mesh  # noqa: E402
from repro_torch.data import pipeline as train_data  # noqa: E402
from repro_torch.train import optimizer as train_opt  # noqa: E402
from repro_torch.train import trainstep  # noqa: E402
from repro_torch.analysis import graph_audit  # noqa: E402
from repro_torch.analysis import kernel_audit  # noqa: E402
from repro_torch.analysis import sanitize  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the FP32 rate
# outside the tensor cores, taken as the rate of 32-bit integer work
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 67e12
F32_FLOPS = 67e12            # FP32 outside the tensor cores
BF16_FLOPS = 989.4e12        # dense BF16 on the tensor cores
# exponentials on the SFU: 16 a clock per SM (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0), 132 SMs at
# the 1.98 GHz boost clock
SMS = 132
EXP_PER_S = SMS * 16 * 1.98e9
OPS_PER_WORD = 10   # integer operations counted per 32-bit word loaded

SLICE = tpcc.TPCCConfig(
    n_warehouses=50, customers_per_district=3000, n_items=100_000,
    n_threads=60, orders_per_thread=128, dist_degree=10.0,
    n_old_versions=2, n_overflow=2, layout="table_major",
    key_addressed=True, fused_commit=True, batched_probe=True)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ------------------------------------------------------------ trees ----
def tmap(fn, x):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        vals = [tmap(fn, y) for y in x]
        return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)
    return x


def leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for y in x for t in leaves(y)]
    return []


def clone(x):
    return tmap(lambda t: t.clone(), x)


def max_abs_err(a, b):
    """Largest |a - b| over paired integer/bool leaves; raises on a shape
    mismatch."""
    la, lb = leaves(a), leaves(b)
    check(len(la) == len(lb), f"leaf count {len(la)} != {len(lb)}")
    err = 0
    for x, y in zip(la, lb):
        check(x.shape == y.shape, f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def same(a, b, what):
    err = max_abs_err(a, b)
    check(err == 0, f"{what}: kernel and plain version differ "
                    f"(max |diff| {err})")
    return err


# ----------------------------------------------------------- timing ----
HOLD_CYCLES = 50_000_000   # ~25 ms of GPU clock: longer than enqueueing


def time_events(fn, n, before=None, hold=False):
    """Mean ms of ``fn`` over ``n`` calls, each between a pair of CUDA
    events; ``before`` runs outside the timed pair. With ``hold`` the GPU
    first spins while every call is enqueued, so each pair brackets device
    work alone and not the host's launch overhead (``fn`` must not
    synchronise)."""
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda.synchronize()
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
    for i in range(n):
        if before is not None:
            before()
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / n


def time_host(fn, n, before=None):
    """Mean ms per call on the host clock, the device synchronised after
    every call: what a caller waits for one launch."""
    total = 0.0
    for _ in range(n):
        if before is not None:
            before()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return total / n * 1e3


def bound(n_bytes, n_words):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_words * OPS_PER_WORD / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------- work of a call ----
def _chain_work(dk, keys, live, max_probes):
    """Directory words the probe walks of the ``live`` lanes read, and the
    lanes whose walk met their key (each then reads one value)."""
    key1 = (u64(keys) + 1) & 0xFFFFFFFF
    base = ht._hash(keys, dk.shape[0])
    steps = torch.zeros(keys.shape, dtype=torch.int64, device=keys.device)
    hit = torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    done = ~live
    for p in range(max_probes):
        k = u64(dk[(base + p) % dk.shape[0]])
        steps += (~done).long()
        hit |= ~done & (k == key1)
        done = done | (k == key1) | (k == 0)
    return int(steps.sum()), int(hit.sum())


def _resolution_work(table, ts, slot, found, src, pos, live):
    """Headers, ring counters and distinct ``ts_vec`` words the §5.1
    resolutions of the ``live`` lanes examine (current, old ring up to the
    serving version, overflow ring). A header's visibility test reads the
    word ``ts[min(tid, n-1)]``, except for a never-written old-ring
    sentinel, which is skipped unread; the words are counted once each, as
    are their 32-byte sectors."""
    K, KO = table.n_old, table.ovf_hdr.shape[1]
    s = torch.where(slot >= 0, slot, 0).long().clamp(0, table.n_records - 1)
    nw = table.next_write[s].long()
    on = table.ovf_next[s].long()
    old_seen = torch.where(src == 0, 0, torch.where(
        src == 1, torch.remainder(nw - 1 - pos, K) + 1, K))
    ovf_seen = torch.where(src == 2, torch.where(
        found, torch.remainder(on - 1 - pos, KO) + 1, KO), 0)
    ages_k = torch.arange(K, device=s.device)
    ages_o = torch.arange(KO, device=s.device)
    oh = table.old_hdr[s[:, None], torch.remainder(nw[:, None] - 1 - ages_k,
                                                   K)]
    vh = table.ovf_hdr[s[:, None], torch.remainder(on[:, None] - 1 - ages_o,
                                                   KO)]
    old_ex = live[:, None] & (ages_k < old_seen[:, None])
    ovf_ex = live[:, None] & (ages_o < ovf_seen[:, None])
    sentinel = (hdr_ops.commit_ts(oh) == 0) & (hdr_ops.thread_id(oh) == 0) \
        & hdr_ops.is_moved(oh)
    tids = torch.cat([hdr_ops.thread_id(table.cur_hdr[s])[live],
                      hdr_ops.thread_id(oh)[old_ex & ~sentinel],
                      hdr_ops.thread_id(vh)[ovf_ex]])
    words = torch.unique(tids.clamp(max=ts.shape[0] - 1))
    headers = int(live.sum()) + int(old_ex.sum()) + int(ovf_ex.sum())
    counters = int((live & (src != 0)).sum()) + int((live & (src == 2)).sum())
    return (headers, counters, int(words.numel()),
            int(torch.unique(words // 8).numel()))


def probe_work(args, kw, out):
    """Bytes the batched probe must move on these inputs: each lane's
    inputs and outputs, the directory words its probe chain reads, the
    headers and ring counters its resolution examines, and each distinct
    ``ts_vec`` word those headers name."""
    dk, dv, table, ts, fb, keys, km = args
    slot, found, src, pos = out
    Q = fb.shape[0]
    n_bytes = Q * (4 + 13)
    words = dir_loads = 0
    if dk is not None:
        n_bytes += Q * 5
        n_probe, n_hit = _chain_work(dk, keys, km, kw.get("max_probes", 16))
        n_bytes += n_probe * 4 + n_hit * 4
        words += n_probe
        dir_loads = n_probe + n_hit
    headers, counters, ts_words, ts_sectors = _resolution_work(
        table, ts, slot, found, src, pos,
        torch.ones(Q, dtype=torch.bool, device=fb.device))
    n_bytes += headers * 8 + counters * 4 + ts_words * 4
    words += 2 * headers + counters
    # random loads, one 32-byte sector each: probes, values, headers and
    # ring counters, and the sectors of ts_vec they name
    sectors = dir_loads + headers + counters + ts_sectors
    return n_bytes, words, sectors


def hash_probe_work(args, kw, out):
    """Bytes the single-key probe must move on these inputs: each query and
    its outputs, the directory words its walk reads, one value per met key,
    and for the found keys only the headers and ring counters of their
    resolution and each distinct ``ts_vec`` word those headers name."""
    dk, dv, table, ts, queries = args
    slot, found, src, pos = out
    Q = queries.shape[0]
    n_probe, n_hit = _chain_work(
        dk, queries, torch.ones(Q, dtype=torch.bool, device=queries.device),
        kw.get("max_probes", 16))
    headers, counters, ts_words, ts_sectors = _resolution_work(
        table, ts, slot, found, src, pos, slot >= 0)
    n_bytes = Q * (4 + 13) + (n_probe + n_hit) * 4 + headers * 8 \
        + counters * 4 + ts_words * 4
    words = n_probe + 2 * headers + counters
    sectors = n_probe + n_hit + headers + counters + ts_sectors
    return n_bytes, words, sectors


def commit_work(args, out):
    """Bytes the fused commit must move on these inputs: each request's
    slot, priority, transaction, active flag and two output flags; the
    expected header and the header, ring counter and ring victim of each
    active request; the new header and the payload rows of each install
    (the new row read, the current row read, the ring and current rows
    written, two headers and the counter written); each transaction's
    inputs, outputs and vector slot."""
    (table, vec, slots, exp, prio, act, txn, new_hdr, new_data, txn_ok,
     txn_slot, cts, ext) = args
    Q, T, W = slots.shape[0], txn_ok.shape[0], new_data.shape[1]
    n_act = int(act.sum())
    n_inst = int(out.do_install.sum())
    n_bytes = Q * (13 + 2) + n_act * (8 + 20) + n_inst * (8 + 20 + 16 * W) \
        + T * (13 + 8 + 5)
    words = Q * 4 + n_act * 7 + n_inst * (7 + 4 * W) + T * 5
    # random accesses, one 32-byte sector each: header, counter and ring
    # victim per active request, three header writes and three payload
    # rows per install, a vector slot per transaction
    sectors = 3 * n_act + n_inst * (3 + 3 * -(-W * 4 // 32)) + T
    return n_bytes, words, sectors


def timed_run(driver, cfg, lay, st, oracle, stream, n_rounds):
    """``driver`` (``run_neworder_rounds`` or ``run_mixed_rounds``) with
    each round's host time: the driver calls ``draw`` once at the start of
    every round and synchronises on the round's outcomes within it, so the
    gaps between draws are rounds, and their sum is the run."""
    stamps = []

    def draw(r):
        stamps.append(time.perf_counter())
        return stream(r)

    torch.cuda.synchronize()
    st, stats = driver(cfg, lay, st, oracle, draw, n_rounds, device="cuda")
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    return st, stats, [b - a for a, b in zip(stamps, stamps[1:])]


# each kernel's wrapper, the entry point that counts its launches
WRAPPERS = {"batched_probe": (probe_ops, "batched_probe"),
            "fused_commit": (commit_ops, "fused_commit"),
            "hash_probe": (probe_ops, "hash_probe"),
            "flash_attention": (flash_ops, "flash_attention"),
            "paged_attention": (paged_ops, "paged_attention"),
            "moe_gmm": (moe_ops, "moe_gmm"),
            "mamba_scan": (mamba_ops, "mamba_scan")}


# the wrapper functions themselves, whose counters a shadow's replacing of
# the module attribute leaves in place
COUNTERS = {n: getattr(m, f) for n, (m, f) in WRAPPERS.items()}


def launch_counts(decide=False):
    """Each kernel's launches; with ``decide`` also the decide-only ones
    among ``fused_commit``'s (``fused_commit_decide``)."""
    counts = {n: c.launches for n, c in COUNTERS.items()}
    if decide:
        counts["fused_commit_decide"] = \
            COUNTERS["fused_commit"].decide_launches
    return counts


def reset_launch_counts():
    for c in COUNTERS.values():
        c.launches = 0
    COUNTERS["fused_commit"].decide_launches = 0


# the outcome of each sub-round of the mix, as the driver sees it
OUTCOMES = {"neworder_round": ("committed", "snapshot_miss", "o_id"),
            "payment_round": ("committed", "snapshot_miss"),
            "delivery_round": ("committed", "delivered", "snapshot_miss"),
            "orderstatus_round": ("result", "found"),
            "stocklevel_round": ("result", "found")}


# the mix's round functions over memory servers, by the name of their
# single-server twin
MESH_ROUNDS = {"neworder_round_distributed": "neworder_round",
               "payment_round_distributed": "payment_round",
               "delivery_round_distributed": "delivery_round",
               "orderstatus_round": "orderstatus_round",
               "stocklevel_round": "stocklevel_round"}


class SubRounds:
    """While active, wraps the mix's five round functions (those over the
    memory servers with ``mesh``): each call logs, under its single-server
    name, clones of its outcome tensors and the kernel launches it made."""

    def __init__(self, mesh=False):
        self.log = []
        self.names = MESH_ROUNDS if mesh else {n: n for n in OUTCOMES}

    def __enter__(self):
        self.orig = {n: getattr(tpcc, n) for n in self.names}
        for n, fn in self.orig.items():
            setattr(tpcc, n, self._wrap(self.names[n], fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(tpcc, n, fn)

    def _wrap(self, name, fn):
        def run(*a, **k):
            before = launch_counts(decide=True)
            out = fn(*a, **k)
            after = launch_counts(decide=True)
            self.log.append((name, tuple(getattr(out, f).clone()
                                         for f in OUTCOMES[name]),
                             {n: after[n] - before[n] for n in after}))
            return out
        return run

    def launches(self, name):
        """Per call of round function ``name``: its kernel launches."""
        return [d for n, _, d in self.log if n == name]


# ---------------------------------------------------------- capture ----
def capture_round(cfg, lay, st, oracle, stream, n_rounds):
    """Run ``n_rounds`` rounds on ``st`` and keep clones of the last
    round's kernel inputs."""
    cap = {}
    orig = probe_ops.batched_probe, commit_ops.fused_commit

    def grab(name, fn):
        def wrapped(*a, **k):
            cap[name] = (clone(a), dict(k))
            return fn(*a, **k)
        return wrapped

    probe_ops.batched_probe = grab("probe", orig[0])
    commit_ops.fused_commit = grab("commit", orig[1])
    try:
        tpcc.run_neworder_rounds(cfg, lay, st, oracle, stream, n_rounds,
                                 device=st.nam.table.cur_hdr.device)
    finally:
        probe_ops.batched_probe, commit_ops.fused_commit = orig
    return cap["probe"], cap["commit"]


def adversarial_probe(args):
    """The real round's lanes made hostile: absent keys, a key whose +1
    wraps to the empty marker, invalidated directory entries, slot lanes
    out of range, and a halved snapshot that hides recent versions."""
    dk, dv, table, ts, fb, keys, km = clone(args)
    Q = fb.shape[0]
    lane = torch.arange(Q, device=fb.device)
    keys[lane % 10 == 3] = 0x5EADBEEF
    keys[5] = -1
    hit = torch.isin(u64(dk), (u64(keys[km][::7]) + 1) & 0xFFFFFFFF)
    dv[hit] = -1
    fb[(lane % 17 == 4) & ~km] = -3
    fb[(lane % 19 == 6) & ~km] = table.n_records + 5
    ts.copy_((u64(ts) // 2).to(torch.int32))
    return dk, dv, table, ts, fb, keys, km


def adversarial_commit(args):
    """The real round's requests made hostile, sparsely enough that some
    transactions still commit: hot duplicate slots across transactions,
    stale expectations, locked targets, immovable ring victims, padding
    lanes with garbage ids, remote failures, gated-off transactions, and
    write slots out of range (F1's lanes, :func:`f1_lanes`)."""
    (table, vec, slots, exp, prio, act, txn, new_hdr, new_data, txn_ok,
     txn_slot, cts, ext) = clone(args)
    Q, T = slots.shape[0], txn_ok.shape[0]
    WS = Q // T
    lane = torch.arange(Q, device=slots.device)
    hot = (lane % WS == 1) & (txn % 3 == 1) & act
    hot_slot = int(slots[0])
    slots[hot] = hot_slot
    exp[hot] = table.cur_hdr[hot_slot]
    exp[(lane % 97 == 2) & act, 1] += 1
    lk = (lane % 89 == 5) & act
    locked = slots[lk].long()
    table.cur_hdr[locked, 0] |= 1
    exp[lk] = table.cur_hdr[locked]
    victim = slots[(lane % WS == 2) & act & (txn % 7 == 3)].long()
    wpos = torch.remainder(table.next_write[victim].long(), table.n_old)
    table.old_hdr[victim, wpos, 0] &= ~4
    pad = (lane % 13 == 0) & (lane % WS != 0)
    act[pad] = False
    txn[pad] = 10 ** 6
    slots[pad] = -7
    ext[1::4] = 1
    txn_ok[2::9] = False
    R = table.n_records
    for lane, slot, gathered in f1_lanes(WS, R):
        act[lane], txn[lane], slots[lane] = True, lane // WS, slot
        exp[lane] = table.cur_hdr[gathered]
    # the record R-1 of the same-priority pair: unlocked, its victims moved
    table.cur_hdr[R - 1, 0] &= ~1
    table.old_hdr[R - 1, :, 0] |= 4
    exp[5 * WS + 1] = exp[5 * WS + 2] = table.cur_hdr[R - 1]
    return (table, vec, slots, exp, prio, act, txn, new_hdr, new_data,
            txn_ok, txn_slot, cts, ext)


def f1_lanes(WS, R):
    """``(lane, slot, gathered record)`` of the requests the adversarial
    commit aims out of range: transaction 5 writes record R-1 (lane 5·WS+1)
    and slot R+5 (lane 5·WS+2), whose bid is dropped but whose won test
    reads record R-1 at the same priority, so it is granted and writes
    nothing; transaction 11 writes slot -R-1 (record 0 for its gathers,
    dropped by its scatters), transaction 17 slot R alone."""
    return ((5 * WS + 1, R - 1, R - 1), (5 * WS + 2, R + 5, R - 1),
            (11 * WS + 3, -R - 1, 0), (17 * WS + 4, R, R - 1))


def commit_without_sync(args):
    """``fused_commit(*args)`` with every synchronising torch op made to
    raise: the wrapper must not wait on the device."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return commit_ops.fused_commit(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def commit_lattice(args, out):
    """Outcome counts of one commit: committed and aborted transactions,
    denied requests and granted requests of aborted transactions."""
    act, txn = args[5], args[6].long().clamp(0, args[9].shape[0] - 1)
    c, g = out.committed, out.granted
    return dict(committed=int(c.sum()), aborted=int((~c).sum()),
                denied=int((act & ~g).sum()),
                released=int((g & ~c[txn]).sum()),
                installed=int(out.do_install.sum()))


def flat_commit(out):
    return tuple(out.table) + tuple(out[1:])


def time_kernels(p_args, p_kw, c_args, n_time=200):
    """``batched_probe``'s and ``fused_commit``'s times (CUDA events over
    ``n_time`` launches on the same buffers), their plain versions' times
    and their work, at one real new-order round's shapes:
    ``{name: (ms, host_ms, plain_ms, (bytes, words, sectors))}``."""
    launch = probe_ops.prepare(*p_args, **p_kw)
    for _ in range(10):
        launch()
    probe_ms = time_events(launch, n_time, hold=True)
    probe_host_ms = time_host(launch, 50)
    probe_plain_ms = time_events(
        lambda: probe_ref.batched_probe_ref(*p_args, **p_kw), 20)
    probe_work_ = probe_work(
        p_args, p_kw, probe_ref.batched_probe_ref(*p_args, **p_kw))

    base = clone(c_args)
    table = base[0]
    touched = torch.where(base[5], base[2], 0).long()
    saved = [t[touched].clone() for t in table[:5]] + [base[1].clone()]

    def restore():
        for t, s in zip(table[:5], saved[:5]):
            t.index_copy_(0, touched, s)
        base[1].copy_(saved[5])

    commit_launch = commit_ops.prepare(*base)
    restore()
    for _ in range(10):
        commit_launch()
        restore()
    # restore() is six small launches per call: fewer calls keep the queue
    # short enough to be filled while the GPU is held
    commit_ms = time_events(commit_launch, max(1, n_time // 4),
                            before=restore, hold=True)
    commit_host_ms = time_host(commit_launch, 50, before=restore)
    commit_plain_ms = time_events(
        lambda: commit_ref.fused_commit_ref(*base), 20, before=restore)
    restore()
    commit_work_ = commit_work(
        base, commit_ref.fused_commit_ref(*clone(base)))
    torch.cuda.synchronize()
    return {"batched_probe": (probe_ms, probe_host_ms, probe_plain_ms,
                              probe_work_),
            "fused_commit": (commit_ms, commit_host_ms, commit_plain_ms,
                             commit_work_)}


def time_launch_floor(n_time=200):
    """``{label: ms}``: the launch floor timed as the kernels are (CUDA
    events, GPU held while queued), from ``fused_commit``'s library: an
    empty kernel of one block, and the commit kernel's cluster shape
    passing no barrier and as many as the kernel does."""
    lib = _build.load("fused_commit")
    fn = lib.fused_commit_floor_launch
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    floors = {"empty kernel": -1, "empty cluster": 0,
              f"cluster, {lib.fused_commit_barriers()} barriers": 1}
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for label, barriers in floors.items():
        def launch():
            check(fn(barriers, stream) == 0,
                  f"launch floor ({label}) failed")
        for _ in range(10):
            launch()
        out[label] = time_events(launch, n_time, hold=True)
    torch.cuda.synchronize()
    return out


def time_hash_probe(args, kw, n_time=200):
    """``hash_probe``'s time (CUDA events, GPU held), its time per
    synchronised call, its plain version's time and its work on
    ``args``."""
    launch = probe_ops.prepare_hash_probe(*args, **kw)
    for _ in range(10):
        launch()
    ms = time_events(launch, n_time, hold=True)
    host_ms = time_host(launch, 50)
    plain_ms = time_events(lambda: probe_ref.hash_probe_ref(*args, **kw), 20)
    work = hash_probe_work(args, kw, probe_ref.hash_probe_ref(*args, **kw))
    torch.cuda.synchronize()
    return ms, host_ms, plain_ms, work


KERNEL_SOURCES = {
    "batched_probe": ("src/repro_torch/csrc/batched_probe.cu",
                      "src/repro/kernels/hash_probe/kernel.py:231"),
    "fused_commit": ("src/repro_torch/csrc/fused_commit.cu",
                     "src/repro/kernels/commit/kernel.py:126"),
    "hash_probe": ("src/repro_torch/csrc/hash_probe.cu",
                   "src/repro/kernels/hash_probe/kernel.py:191"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:87"),
    "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention/kernel.py:76"),
    "moe_gmm": ("src/repro_torch/csrc/moe_gmm.cu",
                "src/repro/kernels/moe_gmm/kernel.py:56"),
    "mamba_scan": ("src/repro_torch/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan/kernel.py:52"),
}


def kernel_record(name, launches, by_path, err, timing, label=""):
    """One kernel's entry of the JSON line, printed as it is built."""
    ms, host_ms, plain_ms, (nb, nw, ns) = timing
    src, replaces = KERNEL_SOURCES[name]
    bound_ms, bound_by = bound(nb, nw)
    sector_ms = ns * 32 / HBM_BYTES_PER_S * 1e3
    print(f"{name}{label}: {ms * 1e3:.2f} us/launch on the device (CUDA "
          f"events, GPU held while queued), {host_ms * 1e3:.2f} us per "
          f"synchronised call on the host clock, plain "
          f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.4f} us "
          f"({bound_by}, {nb} B); {ns} random 32-byte sectors: "
          f"{sector_ms * 1e3:.4f} us")
    return dict(name=name, route="cuda", source=src, replaces=replaces,
                launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, match=err == 0, launches_by_path=by_path,
                bytes=nb, random_sectors=ns, sector_bound_ms=sector_ms,
                host_ms=host_ms)


# ------------------------------------------------------- hash_probe ----
def check_gather(args, kw, out, what, read=None):
    """``mvcc.gather_version`` over the probe's locator must equal
    ``read`` — ``(data, found)`` of the same keys by ``lookup`` +
    ``read_visible``, computed here when not given — on found lanes, and
    the found masks must agree."""
    dk, dv, table, ts, q = args
    slot, found, src, pos = out
    _, data = mvcc.gather_version(table, torch.where(found, slot, 0),
                                  mvcc.VersionLoc(found, src, pos))
    if read is None:
        vals, kf = ht.lookup(ht.HashTable(dk, dv), q,
                             max_probes=kw["max_probes"])
        vr = mvcc.read_visible(table, torch.where(kf, vals, 0), ts)
        read = (vr.data, kf & vr.found)
    check(torch.equal(found, read[1]),
          f"{what}: found lanes differ from lookup + read_visible")
    check(torch.equal(data[found], read[0][found]),
          f"{what}: gathered versions differ from lookup + read_visible")


def probe_summary(out):
    slot, found, src, _ = out
    return (f"Q={slot.shape[0]} found {int(found.sum())} missing keys "
            f"{int((slot < 0).sum())} src0/1/2 "
            f"{[int((found & (src == s)).sum()) for s in range(3)]}")


class ProbeShadow:
    """While active, every keyed read of an order-status or stock-level
    sub-round (``tpcc._snapshot_read`` with keys) is also resolved through
    ``ops.hash_probe`` on the same state, snapshot and keys (the lanes its
    key mask selects): the kernel must equal its plain version bit for bit,
    and its locator gathered must equal the round's own read. A read with
    no keyed lane is left alone: there is nothing to launch."""

    def __init__(self):
        self.err = 0
        self.calls = 0          # reads with keyed lanes, one launch each
        self.lanes = self.found = self.missing = 0
        self.src = [0, 0, 0]
        self.kinds = {}
        self.largest = None     # (queries, snapshot) of the widest launch
        self.queries = []       # every launch's queries
        self.last_vec = None

    def __enter__(self):
        self.orig = tpcc._snapshot_read
        tpcc._snapshot_read = self._read
        return self

    def __exit__(self, *exc):
        tpcc._snapshot_read = self.orig

    def _read(self, st, engine, vec, slots, mask, keys=None, key_mask=None):
        out = self.orig(st, engine, vec, slots, mask, keys, key_mask)
        if keys is not None:
            self._shadow(st, vec, keys, key_mask, out)
        return out

    def _shadow(self, st, vec, keys, key_mask, out):
        km = key_mask.reshape(-1)
        q = keys.reshape(-1)[km].contiguous()
        if q.shape[0] == 0:
            return
        self.calls += 1
        args = (st.directory.keys, st.directory.vals, st.nam.table, vec, q)
        kw = dict(max_probes=tpcc.DIR_PROBES)
        ker = probe_ops.hash_probe(*args, **kw)
        plain = probe_ref.hash_probe_ref(*args, **kw)
        what = "hash_probe (a: the mix's read-only keys)"
        self.err = max(self.err, same(ker, plain, what))
        data = out[0].reshape(-1, out[0].shape[-1])[km]
        check_gather(args, kw, ker, what, read=(data, out[1].reshape(-1)[km]))
        slot, found, src, _ = ker
        kind = "orderstatus customers" if keys.shape[1] == 2 \
            else "stocklevel stocks"
        self.kinds[kind] = self.kinds.get(kind, 0) + q.shape[0]
        self.lanes += q.shape[0]
        self.found += int(found.sum())
        self.missing += int((slot < 0).sum())
        for s in range(3):
            self.src[s] += int((found & (src == s)).sum())
        if self.largest is None or q.shape[0] > self.largest[0].shape[0]:
            self.largest = (q.clone(), vec.clone())
        self.queries.append(q.clone())
        self.last_vec = vec.clone()


def probe_bench_case(dev, n_buckets=1 << 18, n_queries=8192, n_old=8,
                     n_overflow=16, width=8, max_probes=16, load=0.45):
    """The point of the probe bench (``bench_tpcc_scaling.py --probe``),
    rebuilt: one record per directory entry, a fresh table with §5.3-sized
    rings, the keys ``i * 2654435761 mod 2^31``, the queries those keys
    repeated. Returns ``(args, kw)`` of ``hash_probe``."""
    tbl = mvcc.init_table(n_buckets, width, n_old=n_old,
                          n_overflow=n_overflow, device=dev)
    n = int(n_buckets * load)
    i = torch.arange(1, n + 1, dtype=torch.int64, device=dev)
    keys = ((i * 2654435761) % (1 << 31)).to(torch.int32)
    d, placed = ht.insert(ht.init(n_buckets, device=dev), keys,
                          (torch.arange(n, device=dev) % n_buckets)
                          .to(torch.int32), max_probes=64)
    check(bool((placed >= 0).all()), "probe bench directory overflowed")
    qs = keys.repeat(-(-n_queries // n))[:n_queries].contiguous()
    return ((d.keys, d.vals, tbl, torch.zeros(8, dtype=torch.int32,
                                              device=dev), qs),
            dict(max_probes=max_probes))


def rewritten_records(table, dk, dv, vec, n=256):
    """Keys of up to ``n`` directory records whose old ring holds a usable
    candidate (neither a never-written sentinel nor deleted), and the
    snapshot ``vec`` with the writer's entry of the first such record whose
    current version has a nonzero stamp set just below that stamp: the
    current version is hidden and an older one is served from the old ring
    (a thread's stamps rise, and ``vec`` shows every other commit)."""
    live = rows_of((dk != 0) & (dv >= 0))
    slots = dv[live].long().clamp(max=table.n_records - 1)
    oh = table.old_hdr[slots]
    cand = ~((hdr_ops.commit_ts(oh) == 0) & (hdr_ops.thread_id(oh) == 0)
             & hdr_ops.is_moved(oh)) & ~hdr_ops.is_deleted(oh)
    cur = table.cur_hdr[slots]
    pick = rows_of(cand.any(dim=1) & (hdr_ops.commit_ts(cur) != 0))[:n]
    check(pick.numel() > 0, "no directory record was written twice")
    keys = ((u64(dk[live[pick]]) - 1) & 0xFFFFFFFF)
    first = cur[pick[0]]
    tid = int(hdr_ops.thread_id(first).clamp(max=vec.shape[0] - 1))
    vec = vec.clone()
    vec[tid] = to_i32(u64(hdr_ops.commit_ts(first)) - 1)
    return to_i32(keys), vec


# older snapshots for the adversarial case: each hides recent versions so
# that reads reach the old and overflow rings
OLDER_SNAPSHOTS = {"halved snapshot": lambda t: t // 2,
                   "snapshot one commit older": lambda t: (t - 1).clamp(min=0)}


def adversarial_hash_probe(args, older):
    """Real keys made hostile: absent keys, a key whose +1 wraps to the
    empty marker, invalidated directory entries, and the snapshot
    ``older(T_R)`` (uint32 values as int64)."""
    dk, dv, table, ts, q = args
    dv, q = dv.clone(), q.clone()
    lane = torch.arange(q.shape[0], device=q.device)
    hit = torch.isin(u64(dk), (u64(q[::7]) + 1) & 0xFFFFFFFF)
    dv[hit] = -1
    q[lane % 10 == 3] = 0x5EADBEEF
    q[5 % q.shape[0]] = -1
    return dk, dv, table, older(u64(ts)).to(torch.int32), q


# ----------------------------------------------- what was built ----
# the libraries whose bf16 routes run on the tensor cores
TC_KERNELS = ("flash_attention", "moe_gmm")


def _tool(name):
    """A CUDA toolkit program beside ``nvcc``, else on ``PATH``."""
    return shutil.which(name, path=str(Path(_build.find_nvcc()).parent)) \
        or shutil.which(name)


def demangle(names):
    """``{mangled: readable}``: the name without namespace or parameters,
    as ``cu++filt`` gives it (the mangled name where it is missing)."""
    tool = _tool("cu++filt") or _tool("c++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    short = [re.sub(r"\(.*$", "", re.sub(
        r"\(anonymous namespace\)::|<unnamed>::|\(int\)|^void ", "", o))
        .strip() for o in out]
    return dict(zip(names, short))


def ptxas_functions(log):
    """``[(function, registers, "stores/loads")]`` from ``nvcc -Xptxas -v``
    output: each entry function's register count and spilled bytes."""
    rows, fn, spill = [], None, "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            rows.append((fn, int(m.group(1)), spill))
            fn, spill = None, "?"
    names = demangle([r[0] for r in rows])
    return [(names[f], r, sp) for f, r, sp in rows]


def sass_mma_counts(name):
    """``{function: n}``: the tensor-core MMA instructions (``HMMA``,
    ``HGMMA``) in each function of kernel ``name``'s built library."""
    tool = _tool("cuobjdump")
    check(tool is not None, "cuobjdump not found beside nvcc or on PATH")
    sass = subprocess.run([tool, "-sass", str(_build.library(name))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and re.search(r"\bH(G)?MMA\b", line):
            counts[fn] += 1
    names = demangle(list(counts))
    return {names[f]: n for f, n in counts.items()}


# ------------------------------------------------- the LM kernels ----
# the plain version of each LM kernel
LM_PLAIN = {"flash_attention": flash_ref.flash_attention_ref,
            "paged_attention": paged_ref.paged_attention_ref,
            "moe_gmm": moe_ref.moe_gmm_ref,
            "mamba_scan": mamba_ref.mamba_scan_ref}


@dataclasses.dataclass
class LMCase:
    """One call of an LM kernel's entry point, with the work it needs."""
    label: str
    kernel: str
    args: tuple
    kw: dict
    flops: float
    flop_rate: float
    n_bytes: float
    exps: float = 0.0
    reps: int = 20
    plain_reps: int = 2
    library: object = None        # one PyTorch call of the same function
    yardstick: object = None      # a tensor-core call of other numerics
    kernel_kw: dict = dataclasses.field(default_factory=dict)  # ops only
    # held to the plain version in the inputs' dtype (else only to the
    # plain version on float32 copies of the inputs)
    gate_plain: bool = True
    note: str = ""                # the launch's shape, printed with it

    def bound(self):
        terms = {"bytes": self.n_bytes / HBM_BYTES_PER_S,
                 "operations": max(self.flops / self.flop_rate,
                                   self.exps / EXP_PER_S)}
        by = max(terms, key=terms.get)
        return terms[by] * 1e3, by

    def tol(self):
        """atol = rtol against the plain version in the inputs' dtype."""
        name = str(self.args[0].dtype).split(".")[-1]
        return tolerance.TOL[self.kernel][name]


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def flash_pairs(Sq, Sk, causal, window):
    """Query-key pairs a mask lets through, counted row by row."""
    q = torch.arange(Sq, dtype=torch.int64)
    hi = torch.minimum(q, torch.tensor(Sk - 1)) if causal \
        else torch.full_like(q, Sk - 1)
    lo = (q - window + 1).clamp(min=0) if window is not None \
        else torch.zeros_like(q)
    return int((hi - lo + 1).clamp(min=0).sum())


def flash_case(label, gen, dev, B, S, Hq, Hkv, D, *, causal=True,
               window=None, softcap=None, reps=10, inputs=None,
               library=False, gate_plain=True):
    if inputs is None:
        inputs = (torch.randn(B, S, Hq, D, generator=gen, device=dev,
                              dtype=torch.bfloat16),
                  torch.randn(B, S, Hkv, D, generator=gen, device=dev,
                              dtype=torch.bfloat16),
                  torch.randn(B, S, Hkv, D, generator=gen, device=dev,
                              dtype=torch.bfloat16))
    q, k, v = inputs
    kw = dict(causal=causal, window=window, softcap=softcap)
    pairs = flash_pairs(S, S, causal, window)
    lib = None
    if library:
        qpos = torch.arange(S, device=dev)[:, None]
        kpos = torch.arange(S, device=dev)[None, :]
        band = kpos <= qpos if causal else torch.ones_like(kpos <= qpos)
        if window is not None:
            band &= qpos - kpos < window
        qt, kt, vt = (t.transpose(1, 2) for t in inputs)

        def lib():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band, enable_gqa=True).transpose(1, 2)
    return LMCase(label, "flash_attention", inputs, kw,
                  flops=4.0 * D * pairs * B * Hq, flop_rate=BF16_FLOPS,
                  n_bytes=2 * _nbytes(q) + _nbytes(k, v), reps=reps,
                  library=lib, gate_plain=gate_plain)


def paged_work(q, k_pool, page_table, kv_len, window):
    """The keys each sequence attends to (summed over sequences), the
    distinct pool rows (page, slot) they are read from, and the page-table
    entries that name them."""
    B, n_pages = page_table.shape
    P, ps = k_pool.shape[:2]
    pos = torch.arange(n_pages * ps, device=q.device)[None]
    kl = kv_len.long()[:, None]
    vis = pos < kl
    if window is not None:
        vis &= pos >= kl - window
    page = page_table.long()[:, pos[0] // ps]
    vis &= page >= 0
    rows = torch.zeros(P * ps, dtype=torch.bool, device=q.device)
    rows[(page.clamp(0, P - 1) * ps + pos % ps)[vis]] = True
    entries = int(vis.reshape(B, n_pages, ps).any(dim=2).sum())
    return int(vis.sum()), int(rows.sum()), entries


def paged_launch_note(k_pool, page_table, kv_len, g, window):
    """Launch 1's partitions and blocks, live (holding a visible token)
    and in all, at the default partition."""
    B, n_pages = page_table.shape
    ps, Hkv = k_pool.shape[1], k_pool.shape[2]
    part = paged_ops.default_part(ps)
    lo, hi = paged_ops.live_partitions(kv_len, n_pages, ps, part, window)
    live = int((hi - lo).sum())
    per_part = paged_ops.blocks(1, Hkv, g, part, part)
    n_part = paged_ops.partitions(n_pages, part)
    warps = paged_ops.ring(k_pool.shape[3], k_pool.element_size())[0]
    return (f"{part} pages a partition: {live} of {B * n_part} partitions "
            f"live, {live * per_part} of "
            f"{paged_ops.blocks(B, Hkv, g, n_pages, part)} blocks of "
            f"{warps} warps")


def paged_case(label, dev, q, k_pool, v_pool, page_table, kv_len, *,
               window=None, softcap=None, reps=20):
    B, Hq, D = q.shape
    Hkv = k_pool.shape[2]
    n_keys, n_rows, n_entries = paged_work(q, k_pool, page_table, kv_len,
                                           window)
    row_bytes = Hkv * D * k_pool.element_size()
    return LMCase(label, "paged_attention",
                  (q, k_pool, v_pool, page_table, kv_len),
                  dict(window=window, softcap=softcap),
                  flops=4.0 * D * Hq * n_keys, flop_rate=BF16_FLOPS,
                  n_bytes=2 * _nbytes(q) + 2 * n_rows * row_bytes
                  + 4 * n_entries + _nbytes(kv_len), reps=reps,
                  plain_reps=3,
                  note=paged_launch_note(k_pool, page_table, kv_len,
                                         Hq // Hkv, window))


def moe_case(label, gen, dev, E, C, D, F, *, activation="silu", x_std=1.0,
             w_scale=None, reps=5):
    def w(*shape, fan_in):
        s = fan_in ** -0.5 if w_scale is None else w_scale
        return torch.randn(*shape, generator=gen, device=dev,
                           dtype=torch.bfloat16).mul_(s)
    x = torch.randn(E, C, D, generator=gen, device=dev).mul_(x_std).bfloat16()
    wg, wi, wo = w(E, D, F, fan_in=D), w(E, D, F, fan_in=D), \
        w(E, F, D, fan_in=F)
    gated = activation != "sq_relu"
    return LMCase(label, "moe_gmm", (x, wg, wi, wo),
                  dict(activation=activation),
                  flops=2.0 * E * C * D * F * (3 if gated else 2),
                  flop_rate=BF16_FLOPS,
                  n_bytes=2 * _nbytes(x) + _nbytes(wi, wo)
                  + (_nbytes(wg) if gated else 0), reps=reps, plain_reps=2,
                  yardstick=moe_yardstick(x, wg, wi, wo, activation))


def moe_yardstick(x, wg, wi, wo, activation):
    """The expert FFN's products as cuBLAS bf16 ``torch.bmm`` (the gate's
    only where the activation reads it), the last on an ``a·h`` made once
    and rounded to bf16: a tensor-core yardstick of the kernel's time, not
    the same function."""
    gated = activation != "sq_relu"
    ah = moe_ref.act_and_up(torch.bmm(x, wg).float(),
                            torch.bmm(x, wi).float(), activation).bfloat16()

    def products():
        if gated:
            torch.bmm(x, wg)
        torch.bmm(x, wi)
        torch.bmm(ah, wo)
    return products


def mamba_case(label, gen, dev, B, S, Di, N, *, dtype=torch.bfloat16,
               A_log=None, reps=20, **kw):
    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev).mul_(scale) \
            .to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn(B, S, Di, generator=gen, device=dev)).to(dtype)
    x, Bm, Cm = r(B, S, Di), r(B, S, N, scale=0.3), r(B, S, N, scale=0.3)
    if A_log is None:   # models/recurrent.py:init_mamba
        A_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                       device=dev)).repeat(Di, 1)
    D_skip = torch.ones(Di, dtype=torch.float32, device=dev)
    args = (dt, x, Bm, Cm, A_log, D_skip)
    flops, n_bytes, exps = scan_work(args)
    return LMCase(label, "mamba_scan", args, {}, kernel_kw=kw, flops=flops,
                  flop_rate=F32_FLOPS, n_bytes=n_bytes, exps=exps, reps=reps,
                  plain_reps=2, note=mamba_launch_note(B, Di, **kw))


def scan_work(args, return_state=False):
    """``(flops, bytes, exponentials)`` of a ``mamba_scan`` call: six flops
    a state and three a channel each step, every input read and y (and
    the last state) written once, one exponential a state each step and
    one a (channel, state) for A."""
    dt, x, Bm, Cm, A_log, D_skip = args
    B, S, Di = x.shape
    N = Bm.shape[2]
    n = B * S * Di
    return (n * (6.0 * N + 3),
            _nbytes(*args) + n * x.element_size()
            + (4 * B * Di * N if return_state else 0),
            float(n * N + Di * N))


def mamba_launch_note(B, Di, bd=None, **_):
    """Blocks, threads and warps an SM of a launch."""
    blocks, threads = mamba_ops.launch_shape(B, Di, bd)
    return (f"{blocks} blocks of {threads} threads, "
            f"{blocks * threads / 32 / SMS:.2f} warps an SM")


def lm_cases(dev, seed, reps):
    """Phase 8's calls: full widths of three configurations of
    ``src/repro/configs`` (depth and batch cut as stated) and the four
    points of ``benchmarks/bench_kernels.py``, in bfloat16 (the mamba
    bench point in float32, as there)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    fr = max(2, reps // 2)
    cases = []
    # gemma2_27b.py: 32 heads, 16 KV heads, head dim 128, window 4096,
    # attention softcap 50; S = 8,192, a cut of prefill_32k's 32,768
    g_inputs = (torch.randn(1, 8192, 32, 128, generator=gen, device=dev,
                            dtype=torch.bfloat16),
                torch.randn(1, 8192, 16, 128, generator=gen, device=dev,
                            dtype=torch.bfloat16),
                torch.randn(1, 8192, 16, 128, generator=gen, device=dev,
                            dtype=torch.bfloat16))
    cases.append(flash_case("F1 gemma2-27b local layer", gen, dev, 1, 8192,
                            32, 16, 128, window=4096, softcap=50.0, reps=fr,
                            inputs=g_inputs))
    cases.append(flash_case("F2 gemma2-27b global layer", gen, dev, 1, 8192,
                            32, 16, 128, softcap=50.0, reps=fr,
                            inputs=g_inputs))
    # F1 with its queries scaled by 2 (logits of std 2) and by 16 (std 16:
    # the largest reach about 56 and the cap bends them to about 40). The
    # plain version in bfloat16 rounds each logit to bfloat16, 2^-9 of its
    # size, which here moves the output by more than 2e-2, so these two are
    # held to the plain version on float32 copies of their inputs alone.
    for mul, what in ((2, "queries N(0, 4)"),
                      (16, "queries N(0, 256), logits reach the cap")):
        cases.append(flash_case(
            f"F1 gemma2-27b local layer, {what}", gen, dev, 1, 8192, 32, 16,
            128, window=4096, softcap=50.0, reps=fr, gate_plain=False,
            inputs=(g_inputs[0] * mul,) + g_inputs[1:]))
    # mixtral_8x22b.py: 48 heads, 8 KV heads, head dim 128, window 4096
    cases.append(flash_case("F3 mixtral-8x22b layer", gen, dev, 1, 8192, 48,
                            8, 128, window=4096, reps=fr, library=True))
    # gemma2-27b decode_32k: batch 32 (a cut of 128), page size 16
    # (serve/engine.py:34), kv_len in [1, 32768], each sequence's pages a
    # slice of one permutation of the pool (65,536 pages, 8.6 GB)
    B, ps, n_pages = 32, 16, 32768 // 16
    pool = B * n_pages
    kp = torch.randn(pool, ps, 16, 128, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    vp = torch.randn(pool, ps, 16, 128, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    pt = torch.randperm(pool, generator=gen, device=dev).to(torch.int32) \
        .reshape(B, n_pages)
    kl = torch.randint(1, 32769, (B,), generator=gen, device=dev,
                       dtype=torch.int32)
    qd = torch.randn(B, 32, 128, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    cases.append(paged_case("P1 gemma2-27b decode_32k", dev, qd, kp, vp, pt,
                            kl, softcap=50.0, reps=reps))
    cases.append(paged_case("P2 gemma2-27b decode_32k, window 4096", dev,
                            qd, kp, vp, pt, kl, window=4096, softcap=50.0,
                            reps=reps))
    # P1 with every sequence at the full 32,768 tokens: decode_32k itself
    cases.append(paged_case("P3 gemma2-27b decode_32k, every kv_len 32768",
                            dev, qd, kp, vp, pt, torch.full_like(kl, 32768),
                            softcap=50.0, reps=reps))
    # mixtral-8x22b experts: 4,096 tokens at top-2 and capacity factor
    # 1.25 give C = 1,280 rows per expert; weights scaled by fan-in^-0.5
    cases.append(moe_case("M1 mixtral-8x22b experts", gen, dev, 8, 1280,
                          6144, 16384, reps=max(2, reps // 4)))
    # jamba_v01_52b.py: d_inner = 2 x 4096, d_state 16; B = 2, S = 4,096
    cases.append(mamba_case("S1 jamba-v0.1 mamba layer", gen, dev, 2, 4096,
                            8192, 16, reps=reps))
    # benchmarks/bench_kernels.py:32-115
    cases.append(flash_case("bench: flash 1k", gen, dev, 1, 1024, 4, 2, 128,
                            reps=reps))
    qb = torch.randn(16, 8, 128, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    kb = torch.randn(512, 16, 8, 128, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    vb = torch.randn(512, 16, 8, 128, generator=gen, device=dev,
                     dtype=torch.bfloat16)
    ptb = torch.arange(16, dtype=torch.int32, device=dev).repeat(16, 1)
    klb = torch.full((16,), 256, dtype=torch.int32, device=dev)
    cases.append(paged_case("bench: paged decode", dev, qb, kb, vb, ptb, klb,
                            reps=reps))
    cases.append(moe_case("bench: moe_gmm", gen, dev, 4, 128, 256, 512,
                          w_scale=0.1, reps=reps))
    cases.append(mamba_case("bench: mamba_scan", gen, dev, 2, 256, 128, 16,
                            dtype=torch.float32, reps=reps, bd=64, chunk=16))
    return cases


def held_to(out, plain, atol, rtol):
    """Max abs and rel error of ``out`` against ``plain`` and whether every
    element is within ``atol + rtol·|plain|``; the rel error is taken where
    |plain| > atol."""
    o, p = out.float(), plain.float()
    err = (o - p).abs()
    big = p.abs() > atol
    rel = float((err[big] / p.abs()[big]).max()) if big.any() else 0.0
    ok = bool((err <= atol + rtol * p.abs()).all()) and bool(
        torch.isfinite(o).all())
    return float(err.max()), rel, ok


def rms(t):
    return float(t.float().pow(2).mean().sqrt())


def plain_f32(c, plain_fn):
    """The plain version on float32 copies of the case's inputs: the same
    values, none of the bfloat16 rounding the plain version does inside.
    The paged cases run four sequences at a time over float32 copies of
    the pages those sequences name, as a float32 copy of the whole pool
    does not fit beside it."""
    up = [a.float() if a.is_floating_point() else a for a in c.args]
    if c.kernel != "paged_attention":
        return plain_fn(*up, **c.kw)
    q, k_pool, v_pool, pt, kl = c.args
    out = []
    for i in range(0, q.shape[0], 4):
        rows = pt[i:i + 4]
        pages = rows[rows >= 0].long().clamp(max=k_pool.shape[0] - 1)
        local = torch.full_like(rows, -1)
        local[rows >= 0] = torch.arange(pages.numel(), device=q.device,
                                        dtype=torch.int32)
        out.append(plain_fn(q[i:i + 4].float(), k_pool[pages].float(),
                            v_pool[pages].float(), local, kl[i:i + 4],
                            **c.kw))
    return torch.cat(out)


def run_lm_phase(dev, seed, reps):
    """Phase 8: every LM kernel through its ``ops`` entry point at full
    width, held against its plain version, timed beside its bound."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cases = lm_cases(dev, seed, reps)
    torch.cuda.synchronize()
    print(f"LM inputs: {time.perf_counter() - t0:.2f} s, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.3f}"
          f" GB", flush=True)
    # the path: each case once through its entry point
    reset_launch_counts()
    outs = []
    for c in cases:
        mod, fn = WRAPPERS[c.kernel]
        outs.append(getattr(mod, fn)(*c.args, **c.kw, **c.kernel_kw))
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {n: sum(c.kernel == n for c in cases) for n in WRAPPERS}
    check(counts == want, f"LM entry points launched {counts}, expected "
                          f"{want}")
    print(f"LM path: {len(cases)} calls, launches {counts}")
    records = {n: [] for n in LM_PLAIN}
    for c, out in zip(cases, outs):
        mod = WRAPPERS[c.kernel][0]
        plain_fn = LM_PLAIN[c.kernel]
        plain = plain_fn(*c.args, **c.kw)
        torch.cuda.synchronize()
        tol = c.tol()
        abs_err, rel_err, ok = held_to(out, plain, tol, tol)
        scale, rms_plain = float(plain.float().abs().max()), rms(plain)
        check(out.shape == plain.shape, f"{c.label}: shape "
                                        f"{tuple(out.shape)} != "
                                        f"{tuple(plain.shape)}")
        check(ok or not c.gate_plain,
              f"{c.label}: kernel and plain version differ beyond "
              f"atol = rtol = {tol} (max abs {abs_err}, max rel {rel_err})")
        del plain
        plain32 = plain_f32(c, plain_fn)
        if out.dtype == torch.bfloat16:
            rtol32 = tolerance.F32_PLAIN_RTOL
            atol32 = tolerance.F32_PLAIN_ATOL_RMS * rms(plain32)
        else:      # float32 inputs: the plain version is already float32
            rtol32 = atol32 = tol
        abs32, rel32, ok32 = held_to(out, plain32, atol32, rtol32)
        del plain32
        torch.cuda.empty_cache()
        check(ok32, f"{c.label}: kernel and the float32 plain version "
                    f"differ beyond atol {atol32:.3g} + rtol {rtol32:.3g} "
                    f"(max abs {abs32}, max rel {rel32})")
        launch = mod.prepare(*c.args, **c.kw, **c.kernel_kw)
        launch()
        time_events(launch, c.reps, hold=True)   # warm-up round, not kept
        ms = time_events(launch, c.reps, hold=True)
        plain_ms = time_events(lambda: plain_fn(*c.args, **c.kw),
                               c.plain_reps)
        lib_ms = lib_err = yard_ms = None
        if c.library is not None:
            lib_err = float((c.library().float() - out.float()).abs().max())
            lib_ms = time_events(c.library, c.reps, hold=True)
        if c.yardstick is not None:
            c.yardstick()
            yard_ms = time_events(c.yardstick, c.reps, hold=True)
        bound_ms, bound_by = c.bound()
        print(f"{c.kernel} [{c.label}]: {ms:.4f} ms/launch (CUDA events, GPU "
              f"held, {c.reps} launches"
              + (f"; {c.note}" if c.note else "")
              + f"), plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {c.flops:.4g} flop, "
              f"{c.n_bytes:.4g} B, {c.exps:.4g} exp)"
              + (f", SDPA {lib_ms:.4f} ms (max abs {lib_err:.3g} from the "
                 f"kernel)" if lib_ms is not None else "")
              + (f", cuBLAS bf16 bmm yardstick {yard_ms:.4f} ms (the same "
                 f"products, a·h rounded to bf16; not on the path)"
                 if yard_ms is not None else "")
              + f"; max abs err {abs_err:.4g}, max rel err {rel_err:.4g} "
                f"(where |plain| > {tol}), max |plain| {scale:.4g}, rms "
                f"plain {rms_plain:.4g}: "
                + ("within" if ok else "NOT within (not held here)")
                + f" atol = rtol = {tol}; against the float32 plain version "
                f"max abs {abs32:.4g}, max rel {rel32:.4g}: within atol "
                f"{atol32:.4g} + rtol {rtol32:.4g}", flush=True)
        records[c.kernel].append(dict(
            case=c.label, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=lib_ms, yardstick_ms=yard_ms,
            max_abs_err=abs_err,
            max_rel_err=rel_err, max_abs_plain=scale, rms_plain=rms_plain,
            held_to_plain=c.gate_plain, within_plain_tol=ok,
            max_abs_err_f32_plain=abs32, max_rel_err_f32_plain=rel32,
            atol_f32_plain=atol32, rtol_f32_plain=rtol32,
            library_max_abs_diff=lib_err, atol=tol, rtol=tol,
            match=(ok or not c.gate_plain) and ok32, flops=c.flops,
            bytes=c.n_bytes, exps=c.exps, reps=c.reps,
            launch=c.note))
    del outs, cases
    torch.cuda.empty_cache()
    entries = []
    for name, recs in records.items():
        head = next((r for r in recs if r["library_ms"] is not None),
                    recs[0])   # F3 for flash (SDPA's case), else the first
        src, replaces = KERNEL_SOURCES[name]
        entries.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=counts[name], max_abs_err=head["max_abs_err"],
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"],
            match=all(r["match"] for r in recs), atol=head["atol"],
            rtol=head["rtol"], case=head["case"], cases=recs))
    return entries


# --------------------------------------------------------- profiling ----
# host synchronisations in a trace: the runtime calls that wait for the
# device, and the aten operators whose result the host reads from the
# device (``.item()``, ``bool()``, ``int()`` and ``.tolist()`` of a 0-d
# tensor end in ``_local_scalar_dense``; ``nonzero`` reads its count), all
# counted on the host's side of the trace; and, as information only, the
# device's copies to the host, whose records vary between runs of one
# code (11.5 or 13.0 a round in phase 11)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
DEVICE_READS = ("aten::_local_scalar_dense", "aten::nonzero")
GATED_SYNCS = ("sync calls", "device reads")


def profiled(fn):
    """Run ``fn()`` under the profiler between two synchronisations;
    returns the wall time and the trace's device time by kernel, the idle
    share's inputs and the host's waits: the device-side events (kernels,
    copies, fills), which run one at a time on the one stream, summed by
    name, and the counts of ``SYNC_CALLS`` runtime calls, of
    ``DEVICE_READS`` operators and of device-to-host copies (the two
    ``torch.cuda.synchronize`` calls around ``fn`` excluded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    syncs = {"sync calls": -2, "device reads": 0, "DtoH copies": 0}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
            syncs["DtoH copies"] += "DtoH" in e.name
        else:
            syncs["sync calls"] += e.name in SYNC_CALLS
            syncs["device reads"] += e.name in DEVICE_READS
    rows = sorted(((k, t, n) for k, (t, n) in by_name.items()),
                  key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    return wall_us, busy_us, rows, syncs


def profile_rounds(driver, cfg, lay, st, oracle, stream, n_rounds):
    """:func:`profiled` over ``n_rounds`` rounds of ``driver``."""
    return profiled(lambda: driver(cfg, lay, st, oracle, stream, n_rounds,
                                   device="cuda"))


# the port's protocol kernels as the trace names them
OURS = ("batched_probe_kernel", "hash_probe_kernel", "fused_commit_kernel")


def print_profile(label, n_rounds, wall_us, busy_us, rows, syncs, note=""):
    """The breakdown, and per round the host synchronisations and each of
    ``OURS``' CUDA launches; returns the latter two. ``note`` ends the
    first and the last line."""
    print(f"profile, {label}: {n_rounds} rounds, wall {wall_us / 1e3:.3f} "
          f"ms, device busy {busy_us / 1e3:.3f} ms (idle share "
          f"{1 - busy_us / wall_us:.3f}){note}")
    shown = rows[:14] + [r for r in rows[14:]
                         if any(k in r[0] for k in OURS)]
    for key, t_us, count in shown:
        print(f"  {t_us / 1e3:9.3f} ms  {count:6d}x  {key[:70]}")
    launches = {k: sum(n for name, _, n in rows if k in name) / n_rounds
                for k in OURS}
    per_round = {k: v / n_rounds for k, v in syncs.items()}
    print(f"  per round: CUDA launches {launches}; host synchronisations "
          f"{per_round} ({', '.join(SYNC_CALLS)} calls; "
          f"{', '.join(DEVICE_READS)} operators; device-to-host copies)"
          f"{note}")
    return launches, per_round


def print_round_times(label, rounds, commits, what, note=""):
    q = torch.tensor(rounds[1:] or rounds, dtype=torch.float64) * 1e3
    print(f"round time, {label}: first {rounds[0] * 1e3:.3f} ms, then "
          f"median {q.median():.3f} ms, min {q.min():.3f}, max "
          f"{q.max():.3f} over {len(q)} rounds (host clock); "
          f"{commits / sum(rounds):.1f} committed {what}/s{note}")
    return q.median().item()


# ------------------------------------------------------- durability ----
# the settings of the reference's kill bench (bench_tpcc_scaling.py --kill)
DURABLE_GC = dict(gc_interval=2, max_txn_time=1)


class DurableProbe:
    """While active, times what the durability path does through the
    modules ``tpcc`` calls: each checkpoint save (bytes and seconds), the
    restore, the replay of the table and of the vector (seconds, the device
    synchronised), and each GC sweep (device time with the GPU held while
    it is queued, and the overflow slots whose deleted bit it set that were
    live before). It keeps the last sweep's log and safe vector."""

    def __init__(self):
        self.saves, self.restores, self.replays, self.sweeps = [], [], [], []
        self.reclaimed = 0
        self.last_log = self.last_safe = None

    def __enter__(self):
        self.orig = [(snapshot, "save"), (snapshot, "restore"),
                     (wal, "replay"), (wal, "replay_vector"),
                     (gc_ops, "gc_round")]
        self.orig = [(m, n, getattr(m, n)) for m, n in self.orig]
        fns = dict(save=self._save, restore=self._restore,
                   replay=functools.partial(self._replay, "table"),
                   replay_vector=functools.partial(self._replay, "vector"),
                   gc_round=self._gc_round)
        for m, n, fn in self.orig:
            setattr(m, n, functools.partial(fns[n], fn))
        return self

    def __exit__(self, *exc):
        for m, n, fn in self.orig:
            setattr(m, n, fn)

    def _save(self, fn, path, params, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(path, params, *a, **k)
        self.saves.append((sum(t.numel() * t.element_size()
                               for t in snapshot_leaves(params)),
                           time.perf_counter() - t0))

    def _restore(self, fn, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        self.restores.append(time.perf_counter() - t0)
        return out

    def _replay(self, what, fn, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        self.replays.append((what, time.perf_counter() - t0))
        return out

    def _gc_round(self, fn, table, vec, log, now, max_txn_time):
        was = hdr_ops.is_deleted(table.ovf_hdr)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        out = fn(table, vec, log, now, max_txn_time)
        end.record()
        torch.cuda.synchronize()
        self.sweeps.append(start.elapsed_time(end))
        self.reclaimed += int((hdr_ops.is_deleted(table.ovf_hdr)
                               & ~was).sum())
        self.last_log = clone(log)
        self.last_safe = gc_ops.safe_vector(log, now, max_txn_time)
        return out


def snapshot_leaves(tree):
    return [t for _, t in snapshot._items(tree)]


def resolved_entries(j):
    """Replica 0's entries in append order with the undetermined ones
    dropped (the ring holds the whole run), and the count of those."""
    pos = torch.arange(j.capacity, device=j.used.device)[None, :]
    written = pos < j.used[:, None]
    keep = j.resolved[0] & written
    return ([getattr(j, f)[0][keep] for f in wal.ENTRY_FIELDS],
            int((~j.resolved[0] & written).sum()))


def reclaimed_rings_probe(table, probe):
    """(c): ``hash_probe`` over a directory of every record whose overflow
    ring the run touched (its ring cursor moved, or it holds a live
    version), under the last sweep's safe vector, each snapshot of its log
    and the final vector, against the plain version: reads must be served
    from the overflow ring, and the probed rings must hold reclaimed
    slots. Returns ``(max_abs_err, summary)``."""
    dead = hdr_ops.is_deleted(table.ovf_hdr)
    touched = rows_of((~dead).any(dim=1) | (table.ovf_next != 0))
    check(touched.numel() > 0, "no overflow ring was touched")
    n = touched.numel()
    n_buckets = 1 << max(6, (2 * n - 1).bit_length())
    d, placed = ht.insert(ht.init(n_buckets, device=touched.device),
                          touched.to(torch.int32), touched.to(torch.int32),
                          max_probes=64)
    check(bool((placed >= 0).all()), "reclaimed-ring directory overflowed")
    q = touched.to(torch.int32)
    log = probe.last_log
    vecs = [("safe vector", probe.last_safe)] + [
        (f"snapshot at round {int(t)}", v)
        for t, v in zip(log.times.tolist(), log.vecs) if t >= 0]
    err, src = 0, [0, 0, 0]
    kw = dict(max_probes=64)
    for label, vec in vecs:
        args = (d.keys, d.vals, table, vec.contiguous(), q)
        ker = probe_ops.hash_probe(*args, **kw)
        plain = probe_ref.hash_probe_ref(*args, **kw)
        torch.cuda.synchronize()
        err = max(err, same(ker, plain, f"hash_probe (reclaimed rings, "
                                        f"{label})"))
        check_gather(args, kw, ker, f"hash_probe (reclaimed rings, {label})")
        for i in range(3):
            src[i] += int((ker[1] & (ker[2] == i)).sum())
    n_reclaimed_rings = int((dead[touched].any(dim=1)
                             & (table.ovf_next[touched] != 0)).sum())
    check(src[2] > 0, f"no read was served from an overflow ring: src0/1/2 "
                      f"{src}")
    check(n_reclaimed_rings > 0, "no probed ring holds a reclaimed slot")
    return err, (f"{n} records over {len(vecs)} snapshots, found src0/1/2 "
                 f"{src}, {n_reclaimed_rings} rings with reclaimed slots")


def run_durable_phase(cfg, plain_cfg, lay, st0, oracle, draws, smi):
    """Phase 9 (see the module docstring). Returns ``(launches of the
    kernel run, hash_probe's max_abs_err in (c), the run's round
    times)``."""
    n = len(draws)
    kill = tpcc.FailureInjector(kill_round=(n // 2) | 1, in_flight=True)
    st_plain0, st_kill0 = clone(st0), clone(st0)
    runs = {}
    for label, c, st, failure in (("kernels", cfg, st0, None),
                                  ("plain", plain_cfg, st_plain0, None),
                                  ("killed", cfg, st_kill0, kill)):
        jnl = tpcc.make_journal(c, oracle, capacity_rounds=n + 2,
                                device="cuda")
        driver = functools.partial(
            tpcc.run_mixed_rounds, journal=jnl, failure=failure,
            **DURABLE_GC)
        with tempfile.TemporaryDirectory() as d, DurableProbe() as probe, \
                SubRounds() as sub:
            reset_launch_counts()
            st, stats, rounds = timed_run(
                functools.partial(driver, checkpoint_dir=d), c, lay, st,
                oracle, lambda r: draws[r], n)
            launches = launch_counts()
        runs[label] = (st, stats, rounds, jnl, probe, sub, launches)
    st_a, stats_a, rounds_a, jnl_a, probe_a, sub_a, launches_a = \
        runs["kernels"]
    st_p, stats_p, _, jnl_p, _, sub_p, _ = runs["plain"]
    st_b, stats_b, _, jnl_b, probe_b, _, _ = runs["killed"]

    # (a) the kernel path against the plain path
    check([x for x, _, _ in sub_a.log] == [x for x, _, _ in sub_p.log],
          "the durable runs ran different sub-rounds")
    for i, ((x, ok, _), (_, op, _)) in enumerate(zip(sub_a.log, sub_p.log)):
        same(ok, op, f"durable sub-round {i} ({x}) outcomes")
    for f in stats_a._fields:
        a, b = getattr(stats_a, f), getattr(stats_p, f)
        check(a == b or (a != a and b != b), f"durable statistic {f} "
                                             f"differs")
    for f, a, b in zip(wal.Journal._fields, jnl_a, jnl_p):
        check(torch.equal(a, b), f"durable journal leaf {f} differs")
    same(st_a, st_p, "durable final state")
    for x in ("neworder_round", "payment_round", "delivery_round"):
        per_call = sub_a.launches(x)
        check(bool(per_call) and all(
            d["batched_probe"] == 1 and d["fused_commit"] == 1
            for d in per_call),
            f"{x}: the kernels did not launch once in every durable "
            f"sub-round: {per_call}")
    check(stats_a.gc_sweeps == n // DURABLE_GC["gc_interval"],
          f"{stats_a.gc_sweeps} GC sweeps in {n} rounds")
    check(probe_a.reclaimed > 0, "no GC sweep reclaimed an overflow slot")
    check(len(probe_a.saves) == 1 + stats_a.gc_sweeps,
          f"{len(probe_a.saves)} checkpoints for {stats_a.gc_sweeps} sweeps")
    print(f"durable path (a): {n} mix rounds, GC every "
          f"{DURABLE_GC['gc_interval']} (E = {DURABLE_GC['max_txn_time']}), "
          f"journal of {jnl_a.capacity} entries a thread, launches "
          f"{launches_a}; kernels and plain path identical in "
          f"{len(sub_a.log)} sub-rounds, the statistics, every journal leaf "
          f"and the final state; gc_sweeps {stats_a.gc_sweeps}, reclaim_traj "
          f"{stats_a.reclaim_traj}, {probe_a.reclaimed} overflow slots "
          f"reclaimed, ovf_reads {stats_a.ovf_reads}, ovf_peak "
          f"{stats_a.ovf_peak}, commits {stats_a.total_commits}/"
          f"{stats_a.total_attempts}")

    # (b) killed and recovered against (a)
    (rep,) = stats_b.recovery
    check(rep.checkpoint_round < rep.kill_round,
          f"checkpoint round {rep.checkpoint_round} not before the kill "
          f"at {rep.kill_round}")
    check(rep.undetermined > 0, "no undetermined intent at the kill")
    same(st_b, st_a, "recovered final state (with its vector)")
    for f in stats_a._fields:
        a, b = getattr(stats_a, f), getattr(stats_b, f)
        check(f == "recovery" or a == b or (a != a and b != b),
              f"recovered statistic {f} differs")
    for f in wal.ENTRY_FIELDS:
        x = getattr(jnl_b, f)
        check(bool((x == x[:1]).all()), f"journal replicas differ in {f} "
                                        f"after rereplicate")
    (ea, ua), (eb, ub) = resolved_entries(jnl_a), resolved_entries(jnl_b)
    check(ua == 0 and ub == rep.undetermined,
          f"undetermined entries {ua}, {ub} for {rep.undetermined}")
    for f, a, b in zip(wal.ENTRY_FIELDS, ea, eb):
        check(torch.equal(a, b), f"recovered journal entries differ in {f}")
    check(int((jnl_b.used - jnl_a.used).sum()) == ub,
          "the journal cursors differ by more than the undetermined intents")
    print(f"durable path (b): killed at round {rep.kill_round} with "
          f"intents in flight, restored the checkpoint of round "
          f"{rep.checkpoint_round}, replayed {rep.replayed_entries} entries, "
          f"skipped {rep.undetermined} undetermined, released "
          f"{rep.released_locks} locks; final state, vector, statistics "
          f"and resolved journal entries identical to (a)")

    # (c) hash_probe over the rings GC reclaimed
    err, summary = reclaimed_rings_probe(st_a.nam.table, probe_a)
    print(f"durable path (c): hash_probe on reclaimed overflow rings: "
          f"{summary}: bit-identical, gathered versions equal lookup + "
          f"read_visible")

    for b, sec in probe_a.saves:
        print(f"checkpoint save (a): {b} B in {sec:.4f} s "
              f"({b / sec / 1e9:.3f} GB/s) | {smi}")
    for b, sec in probe_b.saves:
        print(f"checkpoint save (b): {b} B in {sec:.4f} s | {smi}")
    print(f"recovery (b): restore {probe_b.restores[0]:.4f} s, replay "
          + ", ".join(f"{w} {sec:.4f} s" for w, sec in probe_b.replays)
          + f", {rep.replayed_entries} entries replayed, recovery_seconds "
          f"{rep.recovery_seconds:.4f} | {smi}")
    print("GC sweep device time (a): " + ", ".join(
        f"{ms:.4f} ms" for ms in probe_a.sweeps) + f" | {smi}")
    return launches_a, err, rounds_a, stats_a.total_commits


# ---------------------------------------------------- sharded store ----
def shard_config(n_shards):
    """NAM-DB §7's deployment (``bench_tpcc_scaling.py:105-108``): 50
    warehouses and 60 execution threads a memory server, the rest as
    ``SLICE``."""
    return dataclasses.replace(SLICE, n_warehouses=50 * n_shards,
                               n_threads=60 * n_shards)


def pool_bytes_per_record(cfg):
    """A record's bytes in the pool: the current header and payload, K old
    and KO overflow versions, and the two ring counters."""
    version = 8 + 4 * tpcc.WIDTH
    return version * (1 + cfg.n_old_versions + cfg.n_overflow) + 8


def unplaced(st, R, n_slots):
    """``st`` trimmed to the real records and vector slots (views)."""
    nam = st.nam
    return st._replace(nam=nam._replace(
        table=mvcc.VersionedTable(*(t[:R] for t in nam.table)),
        oracle_state=nam.oracle_state._replace(
            vec=nam.oracle_state.vec[:n_slots])))


class KernelCalls:
    """While active, keeps the arguments of every ``batched_probe`` and
    ``fused_commit`` call (tensors by reference) and, before each commit
    call, the rows of its table its requests touch (and, once, the
    vector), so :meth:`restore` puts the round's commit state back."""

    def __enter__(self):
        self.probes, self.decides, self.applies, self.saved = [], [], [], []
        self.vec = None
        self.orig = probe_ops.batched_probe, commit_ops.fused_commit

        def probe(*a, **k):
            self.probes.append((a, k))
            return self.orig[0](*a, **k)

        def commit(*a, **k):
            table, vec = a[0], a[1]
            touched = torch.where(a[5], a[2], 0).long()
            self.saved.append((table, touched,
                               [t[touched].clone() for t in table[:5]]))
            if self.vec is None:
                self.vec = (vec, vec.clone())
            (self.decides if k.get("decide_only") else self.applies).append(
                (a, k))
            return self.orig[1](*a, **k)

        probe_ops.batched_probe, commit_ops.fused_commit = probe, commit
        return self

    def __exit__(self, *exc):
        probe_ops.batched_probe, commit_ops.fused_commit = self.orig

    def restore(self):
        for table, touched, rows in self.saved:
            for t, r in zip(table[:5], rows):
                t.index_copy_(0, touched, r)
        self.vec[0].copy_(self.vec[1])


def decide_work(args):
    """Bytes the decide-only launch must move: each request's slot,
    priority, transaction and active flag; the expected header and the
    header, ring counter and ring victim of each active request; the
    failure counts written. It reads no transaction input and no payload."""
    Q, T = args[2].shape[0], args[9].shape[0]
    n_act = int(args[5].sum())
    return Q * 13 + n_act * (8 + 20) + T * 4, Q * 4 + n_act * 7 + T, \
        3 * n_act


def active_lanes(a):
    """A ``fused_commit`` call's arguments with its active requests only,
    in their order (so each slot elects the same request): a lane that is
    not active bids, counts and writes nothing, so the launch decides and
    writes what the full-width one does. Every server's launch spans all
    the round's requests, the other servers' lanes inactive."""
    i = torch.nonzero(a[5]).squeeze(1)
    return tuple(a[:2]) + tuple(x[i] for x in a[2:9]) + tuple(a[9:])


def mesh_kernel_records(calls, smi, n_time=100):
    """Each server's probe, decide and apply launch of the kept round held
    against its plain twin (the decide launch must write nothing) and
    timed, and each commit launch again on its active lanes alone (held
    to the full-width result); returns ``{name: (max_abs_err, (ms,
    host_ms, plain_ms, work), extra)}`` with the times the mean over the
    servers, ``extra`` the lane counts and the active-lane times."""
    S = len(calls.decides)
    check(len(calls.probes) == S == len(calls.applies),
          f"the kept round made {len(calls.probes)} probe, {S} decide and "
          f"{len(calls.applies)} apply calls")
    out = {}
    errs, times = [], []
    for a, k in calls.probes:
        ker = probe_ops.batched_probe(*a, **k)
        plain = probe_ref.batched_probe_ref(*a, **k)
        torch.cuda.synchronize()
        errs.append(same(ker, plain, "batched_probe (mesh, locate-only)"))
        launch = probe_ops.prepare(*a, **k)
        times.append((time_events(launch, n_time, hold=True),
                      time_host(launch, 20),
                      time_events(lambda: probe_ref.batched_probe_ref(
                          *a, **k), 10),
                      probe_work(a, k, plain)))
    out["batched_probe"] = (max(errs), times)
    narrow = {"decide": [], "apply": []}

    errs, times = [], []
    for (a, k), (table, touched, _) in zip(calls.decides, calls.saved):
        calls.restore()
        before = [t[touched].clone() for t in table[:5]] + [a[1].clone()]
        ker = commit_ops.fused_commit(*a, decide_only=True)
        torch.cuda.synchronize()
        after = [t[touched] for t in table[:5]] + [a[1]]
        check(all(torch.equal(x, y) for x, y in zip(before, after)),
              "a decide-only launch wrote the table or the vector")
        check(ker.granted is None and ker.do_install is None,
              "a decide-only launch returned a decision")
        plain = commit_ref.fused_commit_ref(*a, decide_only=True)
        errs.append(same(ker.fails, plain.fails, "fused_commit (decide)"))
        launch = commit_ops.prepare(*a, decide_only=True)
        times.append((time_events(launch, n_time, hold=True),
                      time_host(launch, 20),
                      time_events(lambda: commit_ref.fused_commit_ref(
                          *a, decide_only=True), 10),
                      decide_work(a)))
        c = active_lanes(a)
        same(commit_ops.fused_commit(*c, decide_only=True).fails,
             ker.fails, "fused_commit (decide) on the active lanes alone")
        narrow["decide"].append((c[2].shape[0], time_events(
            commit_ops.prepare(*c, decide_only=True), n_time, hold=True)))
    out["decide"] = (max(errs), times)

    errs, times = [], []
    for a, k in calls.applies:
        calls.restore()
        table, touched = a[0], torch.where(a[5], a[2], 0).long()

        def state():
            return [t[touched].clone() for t in table[:5]] + [a[1].clone()]
        ker = commit_ops.fused_commit(*a)
        torch.cuda.synchronize()
        ker_state = state()
        calls.restore()
        plain = commit_ref.fused_commit_ref(*a)
        errs.append(max(same(ker_state, state(), "fused_commit (apply) "
                                                  "state"),
                        same(tuple(ker[2:]), tuple(plain[2:]),
                             "fused_commit (apply) outputs")))
        calls.restore()
        launch = commit_ops.prepare(*a)
        ms = time_events(launch, max(1, n_time // 4), before=calls.restore,
                         hold=True)
        host_ms = time_host(launch, 20, before=calls.restore)
        plain_ms = time_events(lambda: commit_ref.fused_commit_ref(*a), 10,
                               before=calls.restore)
        calls.restore()
        times.append((ms, host_ms, plain_ms, commit_work(a, plain)))
        c = active_lanes(a)
        narrow["apply"].append((c[2].shape[0], compact_commit(
            calls, a, c, ker_state, state, ker.committed, n_time)))
    calls.restore()
    out["apply"] = (max(errs), times)
    for name, (_, ts) in out.items():
        print(f"{name} (mesh), per server: " + ", ".join(
            f"{t[0] * 1e3:.2f} us" for t in ts) + f" on the device (CUDA "
            f"events) | {smi}")
    for name, ns in narrow.items():
        print(f"{name} (mesh) on the active lanes alone, per server: "
              + ", ".join(f"{ms * 1e3:.2f} us ({q} of "
                          f"{calls.applies[0][0][2].shape[0]} lanes)"
                          for q, ms in ns)
              + f" on the device (CUDA events) | {smi}")
    mean = lambda ts, i: sum(t[i] for t in ts) / len(ts)
    extra = {"batched_probe": dict(lanes=calls.probes[0][0][4].shape[0])}
    for name, ns in narrow.items():
        extra[name] = dict(lanes=calls.applies[0][0][2].shape[0],
                           active_lanes=[q for q, _ in ns],
                           active_lanes_ms=mean(ns, 1))
    return {name: (err, (mean(ts, 0), mean(ts, 1), mean(ts, 2), tuple(
        sum(t[3][j] for t in ts) // len(ts) for j in range(3))), extra[name])
        for name, (err, ts) in out.items()}


def compact_commit(calls, a, c, full_state, state, committed, n_time):
    """The apply launch ``a`` again on its active lanes ``c`` alone: its
    rows, vector and commit decisions must equal the full-width launch's
    (``full_state``, ``committed``). Returns its time (CUDA events, rows
    restored before every launch)."""
    calls.restore()
    out = commit_ops.fused_commit(*c)
    torch.cuda.synchronize()
    same(full_state, state(), "fused_commit (apply) on the active lanes "
                              "alone, state")
    same(out.committed, committed, "fused_commit (apply) on the active "
                                   "lanes alone, decisions")
    calls.restore()
    ms = time_events(commit_ops.prepare(*c), max(1, n_time // 4),
                     before=calls.restore, hold=True)
    calls.restore()
    return ms


def single_commit_time(calls, n_time=100):
    """The single-server ``fused_commit`` of the kept round (CUDA events,
    its rows restored before every launch), at full width and on its
    active lanes alone: ``(ms, active_lanes, active_lanes_ms)``."""
    check(len(calls.applies) == 1, "the single-server round made "
                                   f"{len(calls.applies)} commit calls")
    a, _ = calls.applies[0]
    table, touched = a[0], torch.where(a[5], a[2], 0).long()

    def state():
        return [t[touched].clone() for t in table[:5]] + [a[1].clone()]
    calls.restore()
    ker = commit_ops.fused_commit(*a)
    torch.cuda.synchronize()
    full_state = state()
    calls.restore()
    launch = commit_ops.prepare(*a)
    ms = time_events(launch, max(1, n_time // 4), before=calls.restore,
                     hold=True)
    c = active_lanes(a)
    return ms, c[2].shape[0], compact_commit(calls, a, c, full_state, state,
                                             ker.committed, n_time)


class LoseServer:
    """While active, ``recover_from_failure`` first overwrites the dead
    server's view of the pool and its journal replica with ``-1`` words
    (``True`` masks): its memory is really lost."""

    def __enter__(self):
        self.orig = tpcc.recover_from_failure

        def lost(cfg, lay, st, engine, jnl, ckpt, failure, **k):
            dead = failure.dead_server
            for t in store.shard_view(st.nam.table, dead,
                                      engine.shard_records):
                t.fill_(-1)
            for f in wal.ENTRY_FIELDS:
                x = getattr(jnl, f)
                x[dead].fill_(True if x.dtype == torch.bool else -1)
            return self.orig(cfg, lay, st, engine, jnl, ckpt, failure, **k)
        tpcc.recover_from_failure = lost
        return self

    def __exit__(self, *exc):
        tpcc.recover_from_failure = self.orig


class KeepGrowth:
    """While active, keeps what ``scale_out`` returns (the grown journal
    and engine replace the caller's)."""

    def __enter__(self):
        self.orig, self.out = tpcc.scale_out, None

        def keep(*a, **k):
            self.out = self.orig(*a, **k)
            return self.out
        tpcc.scale_out = keep
        return self

    def __exit__(self, *exc):
        tpcc.scale_out = self.orig


def same_stats(a, b, what, skip=()):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        check(f in skip or x == y or (x != x and y != y),
              f"{what}: statistic {f} differs")


def same_logs(a, b, what):
    """Two ``SubRounds`` logs ran the same sub-rounds with the same
    outcomes."""
    check([x for x, _, _ in a] == [x for x, _, _ in b],
          f"{what}: the runs ran other sub-rounds")
    for i, ((x, p, _), (_, q, _)) in enumerate(zip(a, b)):
        err = max_abs_err(p, q)
        check(err == 0, f"{what}: sub-round {i} ({x}) outcomes differ (max "
                        f"|diff| {err})")


def run_shard_phase(args, dev, smi):
    """Phase 10 (see the module docstring). Returns ``(records,
    launches)``: ``{name: (max_abs_err, timing)}`` of the locate-only
    probe, the decide and the apply launch, and the launch counts of (a)'s
    run with the kernels."""
    S, n = args.shards, args.shard_rounds
    check(S >= 2 and S % 2 == 0, f"--shards {S}: (c) grows from S/2 servers")
    cfg = shard_config(S)
    plain_cfg = dataclasses.replace(cfg, fused_commit=False,
                                    batched_probe=False)
    T = cfg.n_threads
    lay = tpcc.make_layout(cfg)
    R = lay.catalog.total_records
    per_rec = pool_bytes_per_record(cfg)
    print(f"sharded store: {S} memory servers x (50 warehouses, 60 threads): "
          f"{cfg.n_warehouses} warehouses, {cfg.n_items} items, "
          f"{cfg.customers_per_district} customers a district, {T} threads; "
          f"pool from the catalog {R} records x {per_rec} B = "
          f"{R * per_rec / 1e9:.3f} GB ({-(-R // S)} records a server), "
          f"directory {tpcc.directory_buckets(cfg, lay)} buckets", flush=True)
    t_phase = t0 = time.perf_counter()
    oracle_1 = VectorOracle(T)
    oracle_m = PartitionedVectorOracle(T, n_parts=S)
    _, st0 = tpcc.init_tpcc(
        cfg, oracle_1, torch.Generator(device=dev).manual_seed(args.seed + 10),
        device=dev)
    torch.cuda.synchronize()
    check(st0.nam.table.n_records == R and sum(
        t.numel() * t.element_size() for t in st0.nam.table) == R * per_rec,
        "the loaded pool is not the catalog's")
    draw = workload.mixed_stream(
        cfg, torch.Generator(device=dev).manual_seed(args.seed + 11))
    draws = [draw(r) for r in range(n)]
    print(f"sharded store: load {time.perf_counter() - t0:.2f} s | {smi}")

    def deploy(c, n_shards=S):
        """A clone of the loaded state over ``n_shards`` servers, its engine
        and journal (a replica a server)."""
        o = PartitionedVectorOracle(T, n_parts=n_shards)
        engine = tpcc.make_mixed_engine(c, lay, n_shards, o,
                                        shard_vector=True, with_journal=True)
        st = tpcc.distribute_state(engine, clone(st0))
        jnl = store.shard_journal(n_shards, tpcc.make_journal(
            c, o, capacity_rounds=n + 2, n_replicas=n_shards, device=dev))
        return o, engine, st, jnl

    # ---- (a) the mesh mix against the plain path and one server --------
    t0 = time.perf_counter()
    runs = {}
    for label, c, mesh in (("mesh, kernels", cfg, True),
                           ("mesh, plain", plain_cfg, True),
                           ("one server, kernels", cfg, False),
                           ("one server, plain", plain_cfg, False)):
        if mesh:
            oracle, engine, st, jnl = deploy(c)
        else:
            oracle, engine, st = oracle_1, None, clone(st0)
            jnl = tpcc.make_journal(c, oracle, capacity_rounds=n + 2,
                                    n_replicas=S, device=dev)
        driver = functools.partial(tpcc.run_mixed_rounds, engine=engine,
                                   journal=jnl, **DURABLE_GC)
        reset_launch_counts()
        with SubRounds(mesh=mesh) as sub:
            st, stats, rounds = timed_run(driver, c, lay, st, oracle,
                                          lambda r: draws[r], n)
        runs[label] = dict(st=st, stats=stats, rounds=rounds, jnl=jnl,
                           sub=sub, launches=launch_counts(decide=True),
                           oracle=oracle)
    mk = runs["mesh, kernels"]
    for label, run in runs.items():
        same_logs(mk["sub"].log, run["sub"].log,
                  f"sharded mix, {label} against the mesh with kernels")
        same_stats(mk["stats"], run["stats"], f"sharded mix, {label}")
        for f, a, b in zip(wal.Journal._fields, mk["jnl"], run["jnl"]):
            check(torch.equal(a, b), f"sharded journal leaf {f} differs, "
                                     f"{label}")
        same(unplaced(mk["st"], R, T), unplaced(run["st"], R, T),
             f"sharded final state, {label}")
    for x in ("neworder_round", "payment_round", "delivery_round"):
        per_call = mk["sub"].launches(x)
        check(bool(per_call) and all(
            d["batched_probe"] == S and d["fused_commit"] == 2 * S
            and d["fused_commit_decide"] == S for d in per_call),
            f"{x}: not {S} probe and {S} decide + {S} apply launches in "
            f"every sub-round over the servers: {per_call}")
    stats = mk["stats"]
    check(stats.total_commits > 0, "no transaction committed on the mesh")
    check(stats.gc_sweeps == n // DURABLE_GC["gc_interval"],
          f"{stats.gc_sweeps} GC sweeps in {n} rounds")
    print(f"sharded (a): {n} mix rounds over {S} servers, launches "
          f"{mk['launches']}; kernels and plain path over the servers and "
          f"the single-server driver with and without kernels identical in "
          f"{len(mk['sub'].log)} sub-rounds, the statistics, every journal "
          f"leaf ({S} replicas) and the final state; commits "
          f"{stats.commits}, gc_sweeps {stats.gc_sweeps}, reclaim_traj "
          f"{stats.reclaim_traj}")
    for label, run in runs.items():
        print_round_times(f"sharded mix, {label}", run["rounds"],
                          run["stats"].total_commits, "transactions")
    print(f"sharded (a): {time.perf_counter() - t0:.2f} s | {smi}")
    del runs["one server, kernels"]

    # ---- the kept round: each server's launches against their twins ----
    # on the plain runs' final states, equal to (a)'s, which (b) and (c)
    # are held against
    t0 = time.perf_counter()
    mesh, one = runs.pop("mesh, plain"), runs.pop("one server, plain")
    engine = tpcc.make_mixed_engine(cfg, lay, S, oracle_m, shard_vector=True)
    no_draw = workload.neworder_stream(
        cfg, torch.Generator(device=dev).manual_seed(args.seed + 12))
    inp = no_draw(0)
    with KernelCalls() as calls:
        tpcc.neworder_round_distributed(cfg, lay, mesh["st"], oracle_m,
                                        engine, inp, round_no=n)
    records = mesh_kernel_records(calls, smi)
    calls.restore()
    with KernelCalls() as calls_1:
        tpcc.neworder_round(cfg, lay, one["st"], oracle_1, inp, round_no=n)
    single_ms, single_q, single_narrow = single_commit_time(calls_1)
    print(f"fused_commit (one server, the same round's inputs, Q = "
          f"{calls_1.applies[0][0][2].shape[0]}): {single_ms * 1e3:.2f} us "
          f"on the device, {single_narrow * 1e3:.2f} us on its {single_q} "
          f"active lanes alone; over {S} servers a decide "
          f"{records['decide'][1][0] * 1e3:.2f} us and an apply "
          f"{records['apply'][1][0] * 1e3:.2f} us a server | {smi}")

    # host synchronisations and CUDA launches a round, for both engines
    for label, eng, st, o in (("sharded mix, kernels", engine, mesh["st"],
                               oracle_m),
                              ("one-server mix at the same scale, kernels",
                               None, one["st"], oracle_1)):
        driver = functools.partial(tpcc.run_mixed_rounds, engine=eng)
        print_profile(label, 2, *profile_rounds(
            driver, cfg, lay, st, o, workload.mixed_stream(
                cfg, torch.Generator(device=dev).manual_seed(args.seed + 13)),
            2))
    del mesh, one, calls, calls_1
    print(f"sharded kernels and profile: {time.perf_counter() - t0:.2f} s "
          f"| {smi}")

    # ---- (b) a killed server ------------------------------------------
    t0 = time.perf_counter()
    kill = tpcc.FailureInjector(kill_round=(n // 2) | 1, dead_server=S - 1,
                                in_flight=True)
    oracle, engine, st, jnl = deploy(cfg)
    with tempfile.TemporaryDirectory() as d, DurableProbe() as probe, \
            LoseServer():
        st, stats_b = tpcc.run_mixed_rounds(
            cfg, lay, st, oracle, lambda r: draws[r], n, engine=engine,
            journal=jnl, checkpoint_dir=d, failure=kill, device="cuda",
            **DURABLE_GC)
    (rep,) = stats_b.recovery
    check(rep.checkpoint_round < rep.kill_round and rep.undetermined > 0,
          f"the kill left no undetermined intent after a checkpoint: {rep}")
    same(st, mk["st"], "sharded recovered final state")
    same_stats(mk["stats"], stats_b, "sharded recovered run",
               skip=("recovery",))
    for f in wal.ENTRY_FIELDS:
        x = getattr(jnl, f)
        check(bool((x == x[:1]).all()), f"journal replicas differ in {f} "
                                        f"after rereplicate")
    (ea, ua), (eb, ub) = resolved_entries(mk["jnl"]), resolved_entries(jnl)
    check(ua == 0 and ub == rep.undetermined,
          f"undetermined entries {ua}, {ub} for {rep.undetermined}")
    for f, a, b in zip(wal.ENTRY_FIELDS, ea, eb):
        check(torch.equal(a, b), f"recovered journal entries differ in {f}")
    print(f"sharded (b): server {rep.dead_server} of {S} killed at round "
          f"{rep.kill_round} with intents in flight, its view and replica "
          f"overwritten; restored the checkpoint of round "
          f"{rep.checkpoint_round}, replayed {rep.replayed_entries} "
          f"entries, skipped {rep.undetermined} undetermined, released "
          f"{rep.released_locks} locks; state, statistics and resolved "
          f"journal entries identical to (a)")
    for b, sec in probe.saves:
        print(f"sharded checkpoint save (b): {b} B in {sec:.4f} s | {smi}")
    print(f"sharded recovery (b): restore {probe.restores[0]:.4f} s, replay "
          + ", ".join(f"{w} {sec:.4f} s" for w, sec in probe.replays)
          + f", recovery_seconds {rep.recovery_seconds:.4f} | {smi}")
    print(f"sharded (b): {time.perf_counter() - t0:.2f} s | {smi}")
    del st, jnl

    # ---- (c) scale-out: born on S/2 servers, grown to S at round 3 ------
    t0 = time.perf_counter()
    oracle, engine, st, jnl = deploy(cfg, S // 2)
    growth = tpcc.MeshGrowth(grow_round=3, new_shards=S)
    with tempfile.TemporaryDirectory() as d, KeepGrowth() as grown:
        st, stats_c = tpcc.run_mixed_rounds(
            cfg, lay, st, oracle, lambda r: draws[r], n, engine=engine,
            journal=jnl, checkpoint_dir=d, growth=growth, device="cuda",
            **DURABLE_GC)
    (rep_c,) = stats_c.growth
    check(rep_c.moved_slots > 0 and rep_c.moved_buckets > 0,
          f"the scale-out moved no slot or bucket: {rep_c}")
    same(unplaced(st, R, T), unplaced(mk["st"], R, T),
         "grown final state")
    same_stats(mk["stats"], stats_c, "grown run", skip=("growth",))
    for f, a, b in zip(wal.Journal._fields, mk["jnl"], grown.out[1]):
        check(torch.equal(a, b), f"grown journal leaf {f} differs")
    print(f"sharded (c): grown {rep_c.old_shards} -> {rep_c.new_shards} "
          f"servers at round {rep_c.grow_round} from the checkpoint of round "
          f"{rep_c.checkpoint_round}, {rep_c.replayed_entries} entries "
          f"replayed, {rep_c.moved_slots} slots and {rep_c.moved_buckets} "
          f"buckets moved, migration_seconds {rep_c.migration_seconds:.4f}; "
          f"state, statistics and journal identical to the run born on "
          f"{S} | {smi}")
    print(f"sharded (c): {time.perf_counter() - t0:.2f} s | {smi}")
    print(f"sharded store phase: {time.perf_counter() - t_phase:.2f} s | "
          f"{smi}")
    return records, mk["launches"], st0


# ---------------------------------------------------- timestamp oracles ----
# phase 11 (c): rounds of the synthetic stream, its hot records (the
# pool's first), and each transaction's read and write set
SI_ROUNDS, SI_HOT, SI_RS, SI_WS = 16, 2048, 8, 4
WRITE_ROUNDS = ("neworder_round", "payment_round", "delivery_round")


def with_oracle(st, oracle, dev):
    """A clone of the loaded state ``st`` under ``oracle``: the pool does
    not depend on the oracle, so this is ``init_tpcc`` under it."""
    st = clone(st)
    return st._replace(nam=st.nam._replace(oracle_state=oracle.init(dev)))


def oracle_note(oracle, state):
    """The oracle's state in a few words."""
    if isinstance(oracle, NaiveOracleAdapter):
        g = state.gc
        return (f"counter {int(u64(g.cts))} against capacity "
                f"{oracle.inner.capacity}, rts {int(u64(g.rts))}, "
                f"{int(g.bitmap.sum())} bits set")
    return f"{oracle.n_slots} slots summing to " \
        f"{tsoracle.snapshot_summary(state.vec)}"


def per_write_call(sub, n_probe, n_commit, what):
    """Both kernels launched ``n_probe`` and ``n_commit`` times in every
    write sub-round of ``sub``'s log (and some ran)."""
    per_call = [(x, d) for x, _, d in sub.log if x in WRITE_ROUNDS]
    check(bool(per_call) and all(
        d["batched_probe"] == n_probe and d["fused_commit"] == n_commit
        for _, d in per_call),
        f"{what}: not {n_probe} probe and {n_commit} commit launches in "
        f"every write sub-round: {per_call}")


def run_oracle_mix(args, dev, smi, cfg, plain_cfg, lay, st_load):
    """Phase 11 (a) (see the module docstring). Returns each oracle's
    launch counts."""
    n, T = args.oracle_rounds, cfg.n_threads
    gen = lambda k: torch.Generator(device=dev).manual_seed(args.seed + k)
    draw, pdraw = (workload.mixed_stream(cfg, gen(k)) for k in (20, 21))
    draws = [draw(r) for r in range(n)]
    pdraws = [pdraw(r) for r in range(2)]
    oracles = {"vector": VectorOracle(T),
               "compressed": CompressedVectorOracle(T, threads_per_server=T),
               "naive": NaiveOracleAdapter(T, capacity=1 << 16)}
    launches, profiles, medians, ref = {}, {}, {}, None
    for name, oracle in oracles.items():
        t0 = time.perf_counter()
        st_k = with_oracle(st_load, oracle, dev)
        st_p = clone(st_k)
        reset_launch_counts()
        with SubRounds() as sub_k:
            st_k, stats_k, rounds_k = timed_run(
                tpcc.run_mixed_rounds, cfg, lay, st_k, oracle,
                lambda r: draws[r], n)
        launches[name] = launch_counts()
        with SubRounds() as sub_p:
            st_p, stats_p, rounds_p = timed_run(
                tpcc.run_mixed_rounds, plain_cfg, lay, st_p, oracle,
                lambda r: draws[r], n)
        what = f"oracle mix ({name})"
        same_logs(sub_k.log, sub_p.log, f"{what}, kernels against plain")
        same_stats(stats_k, stats_p, what)
        same(st_k, st_p, f"{what}, final state with the oracle's")
        per_write_call(sub_k, 1, 1, what)
        del st_p
        # across oracles: the vector oracle's decisions and payloads (the
        # headers differ by design: a server's slot, or slot 0)
        if ref is None:
            ref = (sub_k.log, st_k.nam.table.cur_data.clone(), stats_k)
        else:
            same_logs(sub_k.log, ref[0], f"{what} against the vector oracle")
            check(torch.equal(st_k.nam.table.cur_data, ref[1]),
                  f"{what}: payloads differ from the vector oracle's")
            same_stats(stats_k, ref[2], f"{what} against the vector oracle",
                       skip=("ops",))
        check(stats_k.total_commits > 0, f"{what}: nothing committed")
        print(f"oracle mix ({name}): {n} rounds, launches {launches[name]}; "
              f"kernels and plain path identical in {len(sub_k.log)} "
              f"sub-rounds, the statistics and the final state with the "
              f"oracle's; commits {stats_k.commits}"
              + ("" if name == "vector" else
                 ", decisions and payloads equal the vector oracle's")
              + f"; {oracle_note(oracle, st_k.nam.oracle_state)} | {smi}")
        medians[name] = [print_round_times(
            f"oracle mix ({name}), {label}", rounds, stats_k.total_commits,
            "transactions", f" | {smi}")
            for label, rounds in (("kernels", rounds_k), ("plain", rounds_p))]
        profiles[name] = print_profile(
            f"oracle mix ({name})", 2, *profile_rounds(
                tpcc.run_mixed_rounds, cfg, lay, st_k, oracle,
                lambda r: pdraws[r], 2), note=f" | {smi}")
        del st_k
        print(f"oracle mix ({name}): {time.perf_counter() - t0:.2f} s | "
              f"{smi}")
    for name, (cuda, syncs) in profiles.items():
        base = profiles["vector"][1]
        check(all(syncs[k] <= base[k] for k in GATED_SYNCS),
              f"oracle mix ({name}): more host synchronisations a round "
              f"({', '.join(GATED_SYNCS)}) than under the vector oracle: "
              f"{syncs} against {base}")
    print("oracle mix, round medians (kernels, plain; ms, host clock): "
          + ", ".join(f"{k} {a:.3f}, {b:.3f}" for k, (a, b) in
                      medians.items())
          + "; host syncs a round: "
          + ", ".join(f"{k} {v[1]}" for k, v in profiles.items())
          + f" | {smi}")
    return {f"oracle_mix_{k}": v for k, v in launches.items()}


def run_oracle_shards(args, dev, smi, st0):
    """Phase 11 (b) on phase 10's loaded pool ``st0``. Returns the
    launch counts of the run over the servers with the kernels."""
    S, n = args.shards, args.shard_rounds
    cfg = shard_config(S)
    plain_cfg = dataclasses.replace(cfg, fused_commit=False,
                                    batched_probe=False)
    lay = tpcc.make_layout(cfg)
    R, T = lay.catalog.total_records, cfg.n_threads
    oracle = CompressedVectorOracle(T, threads_per_server=T // S)
    draw = workload.mixed_stream(
        cfg, torch.Generator(device=dev).manual_seed(args.seed + 22))
    draws = [draw(r) for r in range(n)]
    t0 = time.perf_counter()
    runs = {}
    for label, c, mesh in (("mesh, kernels", cfg, True),
                           ("mesh, plain", plain_cfg, True),
                           ("one server, kernels", cfg, False)):
        st, engine = with_oracle(st0, oracle, dev), None
        jnl = tpcc.make_journal(c, oracle, capacity_rounds=n + 2,
                                n_replicas=S, device=dev)
        if mesh:
            engine = tpcc.make_mixed_engine(c, lay, S, oracle,
                                            shard_vector=False,
                                            with_journal=True)
            st = tpcc.distribute_state(engine, st)
            jnl = store.shard_journal(S, jnl)
        driver = functools.partial(tpcc.run_mixed_rounds, engine=engine,
                                   journal=jnl, **DURABLE_GC)
        reset_launch_counts()
        with SubRounds(mesh=mesh) as sub:
            st, stats, rounds = timed_run(driver, c, lay, st, oracle,
                                          lambda r: draws[r], n)
        runs[label] = dict(st=st, stats=stats, rounds=rounds, jnl=jnl,
                           sub=sub, launches=launch_counts(decide=True))
    mk = runs["mesh, kernels"]
    for label, run in runs.items():
        same_logs(mk["sub"].log, run["sub"].log,
                  f"oracle shards, {label} against the mesh with kernels")
        same_stats(mk["stats"], run["stats"], f"oracle shards, {label}")
        for f, a, b in zip(wal.Journal._fields, mk["jnl"], run["jnl"]):
            check(torch.equal(a, b), f"oracle shards: journal leaf {f} "
                                     f"differs, {label}")
        same(unplaced(mk["st"], R, oracle.n_slots),
             unplaced(run["st"], R, oracle.n_slots),
             f"oracle shards, final state, {label}")
    per_write_call(mk["sub"], S, 2 * S, "oracle shards")
    check(mk["stats"].total_commits > 0, "oracle shards: nothing committed")
    print(f"oracle shards: {n} mix rounds of CompressedVectorOracle({T}, "
          f"threads_per_server={T // S}) ({oracle.n_slots} slots, the vector "
          f"replicated) over {S} servers, launches {mk['launches']}; "
          f"kernels and plain path over the servers and the one-server "
          f"driver identical in {len(mk['sub'].log)} sub-rounds, the "
          f"statistics, every journal leaf and the final state; commits "
          f"{mk['stats'].commits}; "
          f"{oracle_note(oracle, mk['st'].nam.oracle_state)} | {smi}")
    for label, run in runs.items():
        print_round_times(f"oracle shards, {label}", run["rounds"],
                          run["stats"].total_commits, "transactions",
                          f" | {smi}")
    print(f"oracle shards: {time.perf_counter() - t0:.2f} s | {smi}")
    return {"oracle_sharded_compressed": mk["launches"]}


def si_stream(dev, seed, n_rounds, T):
    """``n_rounds`` batches of ``T`` transactions over the pool's first
    ``SI_HOT`` records, as ``tests/_si_common.gen_batch`` builds them:
    distinct reads a transaction, distinct write refs into them, every
    written ref a masked read."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *shape: torch.rand(shape, generator=gen, device=dev)
    out = []
    for _ in range(n_rounds):
        slots = rand(T, SI_HOT).argsort(dim=1)[:, :SI_RS]
        read_mask = rand(T, SI_RS) < 0.9
        wref = rand(T, SI_RS).argsort(dim=1)[:, :SI_WS]
        write_mask = rand(T, SI_WS) < 0.7
        read_mask.scatter_(1, wref, read_mask.gather(1, wref) | write_mask)
        out.append(si.TxnBatch(
            tid=torch.arange(T, dtype=torch.int32, device=dev),
            read_slots=slots.to(torch.int32), read_mask=read_mask,
            write_ref=wref.to(torch.int32), write_mask=write_mask))
    return out


def si_compute(rh, rd, vec):
    return rd[:, :SI_WS, :] + 1


def run_si_rounds(args, dev, smi, T, table0):
    """Phase 11 (c) over a clone of the loaded pool ``table0``. Returns
    the launch counts of the kernel runs."""
    t0 = time.perf_counter()
    batches = si_stream(dev, args.seed + 23, SI_ROUNDS, T)
    oracle = VectorOracle(T)
    launches = {}
    for k in (0, 2):
        runs = []
        for kern in (True, False):
            reset_launch_counts()
            t1 = time.perf_counter()
            out = si.run_rounds(clone(table0), oracle, oracle.init(dev),
                                lambda r: batches[r], si_compute, SI_ROUNDS,
                                staleness=k, fused_commit=kern,
                                batched_probe=kern)
            torch.cuda.synchronize()
            runs.append((out, time.perf_counter() - t1, launch_counts()))
        (ker, sec_k, n_k), (plain, sec_p, _) = runs
        check(n_k["batched_probe"] == n_k["fused_commit"] == SI_ROUNDS,
              f"run_rounds (staleness {k}): not one launch of each kernel "
              f"a round: {n_k}")
        same(ker, plain, f"run_rounds (staleness {k})")
        launches[f"si_run_rounds_staleness_{k}"] = n_k
        print(f"si.run_rounds, staleness {k}: {SI_ROUNDS} rounds of {T} "
              f"transactions ({SI_RS} reads, {SI_WS} writes over {SI_HOT} "
              f"records), launches {n_k}; kernels and plain path identical "
              f"(outcomes, table, vector); committed "
              f"{int(ker[2].sum())}, missed {int(ker[3].sum())}; "
              f"{sec_k * 1e3:.3f} ms with the kernels, {sec_p * 1e3:.3f} "
              f"plain (host clock) | {smi}")
        del runs, ker, plain
    # a 2-stale snapshot against the fresh one from each round's shared
    # start (the reference's test_staleness_only_adds_aborts)
    table, state = clone(table0), oracle.init(dev)
    hist = state.vec.expand(3, T).clone()
    extra = fresh_commits = 0
    for r, b in enumerate(batches):
        stale = si.run_round(
            clone(table), oracle, clone(state), b, si_compute,
            rts_vec=tsoracle.staleness_window(hist, 2),
            fused_commit=True, batched_probe=True)
        fresh = si.run_round(table, oracle, state, b, si_compute,
                             fused_commit=True, batched_probe=True)
        check(not bool((stale.committed & ~fresh.committed).any()),
              f"run_rounds: the stale snapshot committed a transaction the "
              f"fresh one aborted in round {r}")
        extra += int((fresh.committed & ~stale.committed).sum())
        fresh_commits += int(fresh.committed.sum())
        mvcc.version_mover(table)
        hist = torch.cat([state.vec[None], hist[:-1]])
    check(extra > 0, "the stale snapshot never added an abort")
    print(f"si.run_round, 2-stale against fresh from each round's shared "
          f"start: the stale commits a subset in all {SI_ROUNDS} rounds, "
          f"{extra} extra aborts against {fresh_commits} fresh commits | "
          f"{smi}")
    print(f"si.run_rounds phase: {time.perf_counter() - t0:.2f} s | {smi}")
    return launches


# ---------------------------------------------------- the serve path ----
# examples/serve_lm.py's traffic at full width: 8 slots, pages of 16 tokens
# (serve/engine.py:34), a pool of 1,024 pages, room for 4,352 tokens a
# sequence (the 4,100-token prompt and its new tokens), EOS token 1
SERVE_ECFG = serve_engine.EngineConfig(max_seqs=8, page_size=16,
                                       n_pages=1024, max_len=4352, eos=1)
SERVE_REQUESTS, SERVE_MAX_NEW, SERVE_LONG = 12, 16, 4100
# (config, layers): the depth cut to what one card holds beside two
# engines' pools and the checks' float32 copies: 8 mixtral layers are
# 40.5 GB of bf16 weights (56 would be 281 GB); 4 gemma2 layers are two
# units of its local/global pair
SERVE_CONFIGS = (("mixtral-8x22b", 8), ("gemma2-27b", 4))
# the plain engine replays the kernel engine's expert choices (each MoE
# layer takes the experts the kernel engine's same call chose, weighted by
# its own router's probabilities), so the two differ by the kernels'
# arithmetic alone: every row of logits of an admission or a decode step,
# and every written position of every layer's K/V, against the plain
# engine's, the relative RMS of their difference at most SERVE_RRMS. The
# plain router's own other choices change nothing downstream then; where
# one differs from the kernel engine's (another expert, or another side of
# a capacity), at its first such layer the plain router's probability of
# the expert it chose minus that of the expert the kernel engine chose at
# most SERVE_ROUTER_TIE, or its plain rank at most SERVE_EDGE_RANKS from
# the capacity's edge (0: the last kept or the first dropped), and at most
# SERVE_DIVERTED_ADMIT of an admission's prompt tokens; a step's lanes (at
# most 8) are counted, not bounded (6 of 8 at seed 1). Each limit is about
# twice the larger reading of seeds 0 and 1 on the card
# (``scripts/lockstep_seeds.py --phase 12 0 1``, PERF.md §6).
SERVE_RRMS = {"logits": 0.035, "kv": 0.03}
SERVE_ROUTER_TIE = 0.03
SERVE_EDGE_RANKS = 32
SERVE_DIVERTED_ADMIT = 0.4
# greedy tokens must agree where the plain path's top-1/top-2 margin
# exceeds this many times the position's max |logit difference|
SERVE_MARGIN = 4.0
SERVE_KERNELS = ("flash_attention", "paged_attention", "moe_gmm")
# each serve kernel's functions as the trace names them
SERVE_TRACE = {"flash_attention": "flash_", "paged_attention": "paged_",
               "moe_gmm": "gmm_", "mamba_scan": "scan_kernel<"}
# each LM kernel's ops module
LM_OPS = {"flash_attention": flash_ops, "paged_attention": paged_ops,
          "moe_gmm": moe_ops, "mamba_scan": mamba_ops}
SERVE_PROFILE_STEPS = 4


def serve_prompts(seed, vocab):
    """``make_prompts(seed)``'s 12 prompts of 32-1,024 tokens, the ninth
    (the first of wave 2) replaced by one of 4,100, past the 4,096 window
    and past the 64 pages (1,024 tokens) one admission maps a sequence
    (``kvcache.MAX_PAGES_PER_ALLOC``)."""
    prompts = make_prompts(seed, SERVE_REQUESTS, vocab, min_len=32,
                           max_len=1024)
    prompts[SERVE_ECFG.max_seqs] = make_prompts(seed + 1, 1, vocab,
                                                SERVE_LONG, SERVE_LONG)[0]
    return prompts


def waves(prompts):
    """``(request ids, prompts)`` of each admission, ``max_seqs`` at a time
    (``examples/serve_lm.py``)."""
    n = SERVE_ECFG.max_seqs
    return [(list(range(i, min(i + n, len(prompts)))), prompts[i:i + n])
            for i in range(0, len(prompts), n)]


class ServeShadow:
    """While active, records the first and the last call of each serve
    kernel's wrapper in the current step of the kernel engine (``tag``
    "k"); the first ``decode_attention`` of the current step of either
    engine (``tag`` "k" or "p"): the kernel engine's plain sub-batch and
    the plain engine's whole batch, both at the first layer; every MoE
    layer's router probabilities and expert choices
    (``moe.top_k_choices``) and the prefill's final hidden states
    (``forward_hidden``) of either engine. Each MoE layer of the plain
    engine (tag "p") takes the expert choices of the kernel engine's same
    call, weighted by its own router's probabilities; ``routes["p"]``
    keeps the choices its router made."""

    SITES = ((flash_ops, "flash_attention"), (paged_ops, "paged_attention"),
             (moe_ops, "moe_gmm"), (model_common, "decode_attention"),
             (moe_mod, "top_k_choices"), (serve_engine, "forward_hidden"))

    def __init__(self):
        self.tag = None
        self.calls = {}          # kernel -> [first, last] (args, kw, out)
        self.first_plain = {}    # tag -> first decode_attention output
        self.routes = {"k": [], "p": []}   # tag -> (probs, ids) a MoE layer
        self.hidden = {}         # tag -> the prefill's final hidden states

    def __enter__(self):
        self.orig = {n: getattr(m, n) for m, n in self.SITES}
        for m, n in self.SITES:
            setattr(m, n, self._wrap(n))
        return self

    def __exit__(self, *exc):
        for m, n in self.SITES:
            setattr(m, n, self.orig[n])

    def step(self, tag):
        self.tag = tag
        self.first_plain.pop(tag, None)
        self.routes[tag] = []
        if tag == "k":
            self.calls = {}

    def call_key(self, name, args, kw):
        """The key of a kernel call in ``calls``: the kernel's name."""
        return name

    def _record(self, name):
        fn = self.orig[name]

        def call(*args, **kw):
            out = fn(*args, **kw)
            if self.tag is None:
                return out
            if name == "decode_attention":
                self.first_plain.setdefault(self.tag, out)
            elif name == "top_k_choices":
                self.routes[self.tag].append((args[0], out[1]))
            elif name == "forward_hidden":
                self.hidden[self.tag] = out[0]
            elif self.tag == "k":
                rec = (args, kw, out)
                key = self.call_key(name, args, kw)
                self.calls.setdefault(key, [rec, rec])[1] = rec
            return out
        return call

    def _wrap(self, name):
        call = self._record(name)
        if name != "top_k_choices":
            return call

        def replay(probs, k):
            vals, idx = call(probs, k)
            if self.tag != "p":
                return vals, idx
            idx = self.routes["k"][len(self.routes["p"]) - 1][1]
            return probs.gather(-1, idx), idx
        return replay


def dispatch_rank(idx, capacity_factor, E):
    """The rank [T, k] of each choice inside its expert and the capacity
    ``C`` of ``moe.apply_moe`` for expert ids ``idx`` [T, k]: a choice is
    kept where its rank is below ``C``."""
    T, k = idx.shape
    C = max(1, int(capacity_factor * T * k / E))
    onehot = torch.nn.functional.one_hot(idx.reshape(-1), E)
    rank = (onehot.cumsum(0) - onehot).gather(1, idx.reshape(-1, 1))
    return rank.reshape(T, k), C


def dispatch_firsts(cfg, shadow, capacity_factor, rows, held, share_limit,
                    res, what, tie=SERVE_ROUTER_TIE, where="admission"):
    """Each token's first MoE layer at which the plain router's own
    dispatch differs from the kernel path's (another expert, or another
    side of a capacity), host int [rows, T // rows], ``n_layers`` where
    none. ``held`` host bool [rows, T // rows]: the tokens gated (prompt
    positions, live lanes). Each held token's first difference is held to
    ``tie`` or ``SERVE_EDGE_RANKS``, and their share to ``share_limit``
    (the largest share is kept by ``where``: an admission or a step)."""
    rk, rp = shadow.routes["k"], shadow.routes["p"]
    check(len(rk) == len(rp), f"{what}: MoE layers {len(rk)} != {len(rp)}")
    per = []                      # per layer: differs, chose, margin, edge
    for (_, a), (probs, b) in zip(rk, rp):
        ra, C = dispatch_rank(a, capacity_factor, cfg.n_experts)
        rb, _ = dispatch_rank(b, capacity_factor, cfg.n_experts)
        chose = a != b
        side = (ra < C) != (rb < C)
        j = chose.int().argmax(dim=1, keepdim=True)
        margin = probs.gather(1, b.gather(1, j)) - probs.gather(
            1, a.gather(1, j))
        edge = torch.where(rb >= C, rb - C, C - 1 - rb)
        edge = torch.where(side, edge, -1).amax(dim=1)
        gap = probs.topk(cfg.top_k + 1, dim=1).values
        per.append(torch.stack([
            (chose.any(dim=1) | side.any(dim=1)).float(),
            chose.any(dim=1).float(), margin[:, 0], edge.float(),
            gap[:, -2] - gap[:, -1]]))
    L = len(per)
    d, chose, margin, edge, gap = torch.stack(per, dim=1).cpu().numpy()
    first = np.where(d.any(axis=0), d.argmax(axis=0), L).reshape(rows, -1)
    f = first.reshape(-1)
    on = held.reshape(-1) & (f < L)
    t = np.flatnonzero(on)
    at = f[t]
    flip = chose[at, t] > 0
    m, e = margin[at, t], edge[at, t]
    if flip.any():
        res["tie"] = max(res["tie"], float(m[flip].max()))
    res["tie_n"] += int(flip.sum())
    if (~flip).any():
        res["edge"] = max(res["edge"], int(e[~flip].max()))
    res["edge_n"] += int((~flip).sum())
    hg = gap[:, held.reshape(-1)]
    res["gaps"] += hg.size
    res["gaps_under"] += int((hg <= tie).sum())
    over = flip & (m > tie)
    check(not over.any(), f"{what}: tokens {t[over].tolist()[:8]} first "
                          f"take another expert where the plain router's "
                          f"margin is {m[over].tolist()[:8]} (limit {tie})")
    over = ~flip & (e > SERVE_EDGE_RANKS)
    check(not over.any(), f"{what}: tokens {t[over].tolist()[:8]} first "
                          f"change sides of a capacity {e[over].tolist()[:8]}"
                          f" ranks from its edge (limit {SERVE_EDGE_RANKS})")
    share = float(on.sum()) / max(1, int(held.sum()))
    res["share"][where] = max(res["share"].get(where, 0.0), share)
    check(share <= share_limit,
          f"{what}: {int(on.sum())} of {int(held.sum())} tokens dispatched "
          f"otherwise than on the plain path (limit share {share_limit})")
    return first


def serve_call_work(name, args, kw):
    """``(bytes, seconds)``: what the function of one serve or model call
    must move, and its operations at the peak rate of their type, as
    phase 8 counts them (the scan's flops at ``F32_FLOPS``, or its
    exponentials at ``EXP_PER_S`` where they take longer; the others' at
    ``BF16_FLOPS``)."""
    if name == "flash_attention":
        q, k, v = args
        B, Sq, Hq, D = q.shape
        pairs = flash_pairs(Sq, k.shape[1], kw.get("causal", True),
                            kw.get("window"))
        return (2 * _nbytes(q) + _nbytes(k, v),
                4.0 * D * pairs * B * Hq / BF16_FLOPS)
    if name == "paged_attention":
        q, k_pool, _, pt, kl = args
        n_keys, n_rows, n_entries = paged_work(q, k_pool, pt, kl,
                                               kw["window"])
        row_bytes = k_pool.shape[2] * k_pool.shape[3] * k_pool.element_size()
        return (2 * _nbytes(q) + 2 * n_rows * row_bytes + 4 * n_entries
                + _nbytes(kl),
                4.0 * q.shape[2] * q.shape[1] * n_keys / BF16_FLOPS)
    if name == "mamba_scan":
        flops, n_bytes, exps = scan_work(args, kw.get("return_state", False))
        return n_bytes, max(flops / F32_FLOPS, exps / EXP_PER_S)
    x, wg, wi, wo = args
    E, C, D = x.shape
    return (2 * _nbytes(x) + _nbytes(wg, wi, wo),
            2.0 * E * C * D * wi.shape[2] * 3 / BF16_FLOPS)


def serve_bound(n_bytes, op_seconds):
    """``(bound ms, bound by)`` of :func:`serve_call_work`'s terms."""
    terms = {"bytes": n_bytes / HBM_BYTES_PER_S, "operations": op_seconds}
    by = max(terms, key=terms.get)
    return terms[by] * 1e3, by


# the names of a kernel's outputs where it returns more than one
OUTPUTS = {"mamba_scan": ("y", "h_last")}


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def check_serve_calls(shadow, res, what):
    """Each recorded kernel call's outputs (the scan's y and last state)
    against its plain version's, in the output's dtype (``tolerance.TOL``)
    and on float32 copies of its inputs (``F32_PLAIN_RTOL``,
    ``F32_PLAIN_ATOL_RMS``); one plain version is alive at a time."""
    shadow.tag = None

    def tol(name, o):
        return tolerance.TOL[name][str(o.dtype).split(".")[-1]]

    def held32(o, p):
        atol = tolerance.F32_PLAIN_ATOL_RMS * rms(p)
        return (*held_to(o, p, atol, tolerance.F32_PLAIN_RTOL), atol)
    for site, (first, last) in shadow.calls.items():
        name = site.split(" ")[0]     # the kernel of a call's key
        plain_fn = LM_PLAIN[name]
        names = OUTPUTS.get(name, ("out",))
        for args, kw, out in ((first,) if first is last else (first, last)):
            outs = as_tuple(out)
            errs = [held_to(o, p, tol(name, o), tol(name, o)) for o, p in
                    zip(outs, as_tuple(plain_fn(*args, **kw)))]
            errs32 = [held32(o, p) for o, p in zip(outs, as_tuple(plain_fn(
                *[a.float() if a.is_floating_point() else a for a in args],
                **kw)))]
            e = res["calls"].setdefault(site, dict(checked=0))
            e["checked"] += 1
            for j, ((abs_err, rel_err, ok),
                    (abs32, rel32, ok32, atol32)) in enumerate(
                        zip(errs, errs32)):
                check(ok and ok32, f"{what}: {site}'s {names[j]} differs "
                                   f"from its plain version (max abs "
                                   f"{abs_err}, rel {rel_err}; float32 "
                                   f"plain max abs {abs32}, rel {rel32}, "
                                   f"atol {atol32:.3g})")
                sfx = f"_{names[j]}" if j else ""
                for key, v in ((f"max_abs_err{sfx}", abs_err),
                               (f"max_abs_err_f32_plain{sfx}", abs32)):
                    e[key] = max(e.get(key, 0.0), v)
    torch.cuda.empty_cache()


def serve_int_state(st):
    """The engine state's integer leaves (the tokens apart)."""
    return (st.meta.hdr, st.meta.refcount, st.table.page_table,
            st.table.kv_len, st.table.active, st.done, st.epoch)


def check_lockstep_state(ks, ps, res, what, slots=()):
    """The integer state bit for bit; the KV pools at every written
    position of the ``slots``: the first layer's bit for bit (its K/V
    come from the embeddings through the same operations on both paths),
    every layer's within a relative RMS difference of
    ``SERVE_RRMS["kv"]``; the share of values outside the bf16 rule
    (``tolerance.LM_TOL``) is recorded."""
    same(serve_int_state(ks), serve_int_state(ps), f"{what}: engine state")
    if not len(slots):
        return
    t = ps.table
    kv_len = t.kv_len.cpu().numpy()
    pt = t.page_table.cpu().numpy()
    ps_ = SERVE_ECFG.page_size
    pages, offs = [], []
    for s in slots:
        pos = np.arange(kv_len[s])
        pos = pos[pt[s, pos // ps_] >= 0]
        pages.append(pt[s, pos // ps_])
        offs.append(pos % ps_)
    page = torch.as_tensor(np.concatenate(pages), device=t.kv_len.device)
    off = torch.as_tensor(np.concatenate(offs), device=page.device)
    tol = tolerance.LM_TOL["bfloat16"]
    limit = SERVE_RRMS["kv"]
    for layer, (dk, dp) in enumerate(zip(ks.data, ps.data)):
        for a, b in ((dk.k, dp.k), (dk.v, dp.v)):
            a, b = a[page, off], b[page, off]
            if layer == 0:
                check(torch.equal(a, b), f"{what}: the first layer's KV "
                                         f"pool differs")
            d = a.float() - b.float()
            rr = rms(d) / rms(b)
            out = float((d.abs() > tol + tol * b.float().abs()).float()
                        .mean())
            res["pool_err"] = max(res["pool_err"], float(d.abs().max()))
            res["pool_rrms"] = max(res["pool_rrms"], rr)
            res["pool_out"] = max(res["pool_out"], out)
            check(rr <= limit, f"{what}: layer {layer}'s KV pool: relative "
                               f"RMS difference {rr:.4g} > {limit}")


def margin_gate(lk, lp, rows, reqs, res, what):
    """Greedy tokens equal where the plain path's top-1/top-2 margin
    exceeds ``SERVE_MARGIN`` times the row's max |logit difference|;
    counts the tested positions by request."""
    lk, lp = lk[rows].float(), lp[rows].float()
    d = lk - lp
    top2 = lp.topk(2, dim=-1).values
    tested = (top2[:, 0] - top2[:, 1]) > SERVE_MARGIN * d.abs().amax(dim=-1)
    agree = lk.argmax(dim=-1) == lp.argmax(dim=-1)
    check(bool((agree | ~tested).all()), f"{what}: a greedy token differs "
                                         f"where the margin tests it")
    for r, t in zip(reqs, tested.tolist()):
        res["tested"][r] = res["tested"].get(r, 0) + int(t)
    res["positions"] += len(rows)


def rrms_gate(lk, lp, rows, res, what, limit):
    """The relative RMS of the logits' difference over ``rows`` at most
    ``limit``, noting where the largest was."""
    res["rows"] += len(rows)
    d = lk[rows].float() - lp[rows].float()
    rrms = rms(d) / rms(lp[rows])
    if rrms > res["rrms"]:
        res["rrms"], res["rrms_at"] = rrms, what
    check(rrms <= limit, f"{what}: logits' relative RMS difference "
                         f"{rrms:.4g} > {limit} over the rows {rows}")


def prompt_margins(cfg, model, shadow, lens, reqs, res, what):
    """The margin gate at every prompt position of an admission (teacher
    forced by the prompt itself), from both engines' final hidden states,
    128 rows of logits at a time."""
    hk, hp = shadow.hidden["k"], shadow.hidden["p"]
    for i, (n, r) in enumerate(zip(lens, reqs)):
        for j in range(0, n, 128):
            m = min(128, n - j)
            margin_gate(*(transformer.lm_head(h[i, j:j + m], model.embed,
                                              cfg.logit_softcap)
                          for h in (hk, hp)),
                        list(range(m)), [r] * m, res, what)


def contract_holds(table):
    """Host bool [B]: every page below ``ceil((kv_len + 1) / page)`` is
    mapped, the paged kernel's contract (no window narrows it here)."""
    pt = table.page_table
    need = -(-(table.kv_len.long() + 1) // SERVE_ECFG.page_size)
    col = torch.arange(pt.shape[1], device=pt.device)[None]
    return ((pt >= 0) | (col >= need[:, None])).all(dim=1).cpu().numpy()


def serve_lockstep(cfg, model, prompts):
    """Gates 1-4: the kernel engine and the plain engine in lockstep, the
    plain engine's tokens and ``done`` copied into the kernel engine after
    every admission and step, its MoE layers on the kernel engine's
    expert choices (:class:`ServeShadow`); every row of logits and every
    written K/V position within ``SERVE_RRMS``; the plain router's own
    other choices bounded (:func:`dispatch_firsts`); each kernel's first
    and last call of every admission and step against its plain version;
    the plain sub-batch's lanes against the contract."""
    ke = serve_engine.Engine(cfg, model, SERVE_ECFG, kernels=True)
    pe = serve_engine.Engine(cfg, model, SERVE_ECFG, kernels=False)
    ks, ps = ke.init_state(), pe.init_state()
    res = dict(admits=0, steps=0, paged_steps=0, rrms=0.0, rrms_at="",
               pool_err=0.0, pool_rrms=0.0, pool_out=0.0, tested={},
               calls={}, mixed_steps=0, plain_lanes=0, sub_batch_err=0.0,
               rows=0, positions=0, diverged_tokens=0, tie=0.0, tie_n=0,
               edge=-1, edge_n=0, share={}, gaps=0, gaps_under=0)
    L = cfg.n_layers
    force = lambda k, p: k._replace(tokens=p.tokens.clone(),  # noqa: E731
                                    done=p.done.clone())
    reset_launch_counts()
    with ServeShadow() as shadow:
        for w, (reqs, wave) in enumerate(waves(prompts)):
            shadow.step("k")
            ks, lk, sid = ke.admit_logits(ks, wave)
            shadow.step("p")
            ps, lp, _ = pe.admit_logits(ps, wave)
            shadow.tag = None
            what = f"{cfg.name} wave {w + 1} admission"
            slots = sid.tolist()
            lens = [len(p) for p in wave]
            if cfg.n_experts:
                S = shadow.routes["p"][0][1].shape[0] // len(slots)
                held = np.arange(S)[None] < np.array(lens)[:, None]
                first = dispatch_firsts(cfg, shadow, cfg.capacity_factor,
                                        len(slots), held,
                                        SERVE_DIVERTED_ADMIT, res, what)
                res["diverged_tokens"] += int((first[held] < L).sum())
            check_serve_calls(shadow, res, what)
            prompt_margins(cfg, model, shadow, lens, reqs, res, what)
            rrms_gate(lk, lp, list(range(len(slots))), res, what,
                      SERVE_RRMS["logits"])
            ps = pe.sample_first(ps, lp, sid)
            ks = force(ke.sample_first(ks, lk, sid), ps)
            check_lockstep_state(ks, ps, res, what, slots)
            res["admits"] += 1
            req_of = dict(zip(slots, reqs))
            for i in range(SERVE_MAX_NEW - 1):
                if bool((ps.done | ~ps.table.active).all()):
                    break
                what = f"{cfg.name} wave {w + 1} step {i + 1}"
                shadow.step("k")
                ks, lk = ke.decode_logits(ks)
                shadow.step("p")
                ps, lp = pe.decode_logits(ps)
                shadow.tag = None
                holds = contract_holds(ps.table)
                for win, (good, bad) in ke.last_split.items():
                    check(list(good) == list(holds.nonzero()[0]),
                          f"{what}: the engine's kernel lanes {list(good)} "
                          f"(window {win}) are not the contract's "
                          f"{list(holds.nonzero()[0])}")
                res["paged_steps"] += bool(holds.any())
                bad = (~holds).nonzero()[0]
                if len(bad):
                    # the first layer's inputs are the same in both
                    # engines: the plain sub-batch must give the plain
                    # engine's rows there
                    ob = shadow.first_plain["k"]
                    op = shadow.first_plain["p"][torch.as_tensor(
                        bad, device=ob.device)]
                    tol = tolerance.LM_TOL["bfloat16"]
                    err, _, ok = held_to(ob, op, tol, tol)
                    check(ok, f"{what}: the plain sub-batch differs from "
                              f"the plain engine (max abs {err})")
                    res["sub_batch_err"] = max(res["sub_batch_err"], err)
                    res["plain_lanes"] += len(bad)
                    res["mixed_steps"] += bool(holds.any())
                live = (ps.table.active & ~ps.done).cpu().numpy()
                rows = live.nonzero()[0].tolist()
                if cfg.n_experts:
                    first = dispatch_firsts(
                        cfg, shadow, max(2.0, cfg.capacity_factor),
                        len(live), live[:, None], 1.0, res, what,
                        where="step")[:, 0]
                    res["diverged_tokens"] += int(((first < L) & live).sum())
                check_serve_calls(shadow, res, what)
                margin_gate(lk, lp, rows, [req_of[r] for r in rows], res,
                            what)
                rrms_gate(lk, lp, rows, res, what, SERVE_RRMS["logits"])
                ks, ps = ke.sample(ks, lk), pe.sample(ps, lp)
                ks = force(ks, ps)
                check_lockstep_state(ks, ps, res, what, rows)
                res["steps"] += 1
            # stragglers are forced done at the wave's budget and released
            ks = ke.release_finished(ks._replace(done=ks.done
                                                 | ks.table.active))
            ps = pe.release_finished(ps._replace(done=ps.done
                                                 | ps.table.active))
            check_lockstep_state(ks, ps, res, f"{cfg.name} wave {w + 1} "
                                              f"release")
    res["launches"] = {n: launch_counts()[n] for n in SERVE_KERNELS}
    return res


def call_bounds(fn, names=SERVE_KERNELS):
    """Run ``fn()`` with the wrappers of the kernels ``names`` recording
    the bound of every call's work; returns ``{name: [(bound ms, bound
    by), ...]}``."""
    out = {n: [] for n in names}
    mods = {n: LM_OPS[n] for n in names}
    orig = {n: getattr(m, n) for n, m in mods.items()}

    def wrap(name):
        def call(*args, **kw):
            out[name].append(serve_bound(*serve_call_work(name, args, kw)))
            return orig[name](*args, **kw)
        return call
    try:
        for n, m in mods.items():
            setattr(m, n, wrap(n))
        fn()
    finally:
        for n, m in mods.items():
            setattr(m, n, orig[n])
    return out


def serve_timed(cfg, model, prompts, kernels):
    """The traffic through one engine: prefill ms of each wave, each
    decode step's ms (host clock, synchronised), the tokens decoded; then
    wave 1's admission and ``SERVE_PROFILE_STEPS`` decode steps again from
    a fresh state under the profiler, and once more (the engine is
    deterministic) with each kernel call's bound recorded."""
    eng = serve_engine.Engine(cfg, model, SERVE_ECFG, kernels=kernels)
    st = eng.init_state()
    prefill, steps, n_tokens = [], [], 0
    for _, wave in waves(prompts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = eng.admit(st, wave)
        torch.cuda.synchronize()
        prefill.append((time.perf_counter() - t0) * 1e3)
        for _ in range(SERVE_MAX_NEW - 1):
            if bool((st.done | ~st.table.active).all()):
                break
            t0 = time.perf_counter()
            st = eng.decode_step(st)
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t0) * 1e3)
            n_tokens += int((st.table.active & ~st.done).sum())
        st = eng.release_finished(st._replace(done=st.done
                                              | st.table.active))
    del st
    box = [eng.init_state()]
    wave = waves(prompts)[0][1]

    def admit():
        box[0] = eng.admit(box[0], wave)

    def decode():
        for _ in range(SERVE_PROFILE_STEPS):
            box[0] = eng.decode_step(box[0])
    reset_launch_counts()
    admit_prof = profiled(admit)
    admit_calls = launch_counts()
    reset_launch_counts()
    dec = profiled(decode)
    dec_calls = launch_counts()
    box[0] = eng.init_state()
    admit_bounds = call_bounds(admit)
    decode_bounds = call_bounds(decode)
    del box
    torch.cuda.empty_cache()
    return dict(prefill_ms=prefill, step_ms=steps, tokens=n_tokens,
                prefill_profile=admit_prof, prefill_calls=admit_calls,
                prefill_bounds=admit_bounds, decode_profile=dec,
                decode_calls=dec_calls, decode_bounds=decode_bounds)


def per_call_us(profile, calls, name):
    """A wrapper call's device time in a profile: its kernel functions'
    time over the wrapper's calls."""
    rows = profile[2]
    t = sum(t for k, t, _ in rows if SERVE_TRACE[name] in k)
    return t / calls[name] if calls[name] else None


def record_kernel_times(label, t, names, recs, phase8, smi):
    """Each kernel of ``names`` in the prefill and the decode profile of
    ``t`` (:func:`serve_timed`'s or :func:`model_timed`'s): its device
    time a call and the mean bound of the same calls (as many as were
    profiled), into ``recs[name]``; a line each, beside phase 8's case."""
    for name in names:
        for where in ("prefill", "decode"):
            prof, calls = t[f"{where}_profile"], t[f"{where}_calls"]
            us = None if prof is None else per_call_us(prof, calls, name)
            if us is None:
                continue
            b = t[f"{where}_bounds"][name]
            check(len(b) == calls[name], f"{label}: {name} in {where}: "
                                         f"{len(b)} calls bounded, "
                                         f"{calls[name]} profiled")
            b_ms = sum(ms for ms, _ in b) / len(b)
            by = [w for _, w in b]
            b_by = max(set(by), key=by.count)
            recs[name].update({f"{where}_ms": us / 1e3,
                               f"{where}_calls_profiled": calls[name],
                               f"{where}_bound_ms": b_ms,
                               f"{where}_bound_by": b_by})
            p8 = phase8.get(name)
            print(f"{label}: {name} in {where}: {us / 1e3:.4f} ms a call "
                  f"(device, {calls[name]} calls), bound {b_ms:.4f} ms "
                  f"({b_by}), the mean over the same calls, "
                  f"{100 * b_ms / (us / 1e3):.1f} % of it"
                  + (f"; phase 8 {p8['case']}: {p8['ms']:.4f} ms, bound "
                     f"{p8['bound_ms']:.4f} ms" if p8 else "")
                  + f" | {smi}", flush=True)


@torch.no_grad()
def run_serve_phase(args, dev, smi, lm_records):
    """Phase 12 over ``SERVE_CONFIGS``; returns each serve kernel's
    launches and per-call times by config."""
    out = {n: {} for n in SERVE_KERNELS}
    phase8 = {r["name"]: r for r in lm_records}
    for arch, n_layers in SERVE_CONFIGS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_arch(arch), n_layers=n_layers)
        torch.cuda.reset_peak_memory_stats()
        model = transformer.init_params(
            cfg, torch.Generator(device=dev).manual_seed(args.seed + 12),
            dev)
        prompts = serve_prompts(args.seed + 12, cfg.vocab)
        n_weights = sum(p.numel() * p.element_size()
                        for p in model.parameters())
        print(f"serve {arch}: {n_layers} of {get_arch(arch).n_layers} "
              f"layers, weights {n_weights / 1e9:.3f} GB (bf16, random "
              f"from the seed), prompts {[len(p) for p in prompts]}",
              flush=True)
        res = serve_lockstep(cfg, model, prompts)
        want = {"flash_attention": n_layers * res["admits"],
                "paged_attention": n_layers * res["paged_steps"],
                "moe_gmm": n_layers * (res["admits"] + res["steps"])
                if cfg.n_experts else 0}
        check(res["launches"] == want, f"serve {arch}: launches "
                                       f"{res['launches']}, expected {want}")
        short = [r for r in range(len(prompts))
                 if res["tested"].get(r, 0) < 1]
        check(not short, f"serve {arch}: requests {short} have no position "
                         f"whose margin tests the greedy token")
        check(res["mixed_steps"] > 0, f"serve {arch}: no step served "
                                      f"contract lanes beside kernel lanes")
        print(f"serve {arch} MoE dispatch: on the kernel engine's expert "
              f"choices; the plain router chose otherwise for "
              f"{res['diverged_tokens']} tokens (the largest share "
              f"{res['share']}, limit {SERVE_DIVERTED_ADMIT} an "
              f"admission); at its "
              f"first differing layer, {res['tie_n']} took another expert "
              f"at a plain router margin of at most {res['tie']:.4g} (limit "
              f"{SERVE_ROUTER_TIE}; "
              f"{res['gaps_under'] / max(1, res['gaps']):.4g} of all held "
              f"tokens' top-{cfg.top_k} margins are that small), "
              f"{res['edge_n']} changed sides of a capacity at most "
              f"{res['edge']} ranks from its edge (limit "
              f"{SERVE_EDGE_RANKS}); every written K/V position: the first "
              f"layer's bit-identical, every layer's relative RMS "
              f"difference at most {res['pool_rrms']:.4g} (limit "
              f"{SERVE_RRMS['kv']}), max abs {res['pool_err']:.4g}, at most "
              f"{res['pool_out']:.4g} of a layer's values outside atol = "
              f"rtol = {tolerance.LM_TOL['bfloat16']}")
        print(f"serve {arch} lockstep: {res['admits']} admissions, "
              f"{res['steps']} decode steps ({res['paged_steps']} with a "
              f"kernel lane, {res['mixed_steps']} with plain sub-batch "
              f"lanes beside them, {res['plain_lanes']} lane-steps on the "
              f"plain sub-batch, first-layer max abs "
              f"{res['sub_batch_err']:.4g} from the plain engine); launches "
              f"{res['launches']} = expected; integer state bit-identical "
              f"at every step; logits' relative RMS difference max "
              f"{res['rrms']:.4g} (at {res['rrms_at']}, limit "
              f"{SERVE_RRMS['logits']}, over all {res['rows']} rows); "
              f"greedy tokens "
              f"equal at {sum(res['tested'].values())} of "
              f"{res['positions']} positions the margin tests (per request "
              f"{[res['tested'].get(r, 0) for r in range(len(prompts))]}); "
              f"kernel calls against their plain versions: {res['calls']}"
              f" | {smi}", flush=True)
        for name, n in res["launches"].items():
            out[name][arch] = dict(launches=n)
        for kernels in (True, False):
            label = "kernels" if kernels else "plain"
            t = serve_timed(cfg, model, prompts, kernels)
            steps = torch.tensor(t["step_ms"], dtype=torch.float64)
            syncs = {k: v / SERVE_PROFILE_STEPS
                     for k, v in t["decode_profile"][3].items()}
            wall, busy = t["decode_profile"][:2]
            awall, abusy = t["prefill_profile"][:2]
            print(f"serve {arch}, {label}: prefill "
                  f"{[round(x, 3) for x in t['prefill_ms']]} ms per wave; "
                  f"decode step median {steps.median():.3f} ms (min "
                  f"{steps.min():.3f}, max {steps.max():.3f}, {len(steps)} "
                  f"steps); {t['tokens'] / steps.sum() * 1e3:.1f} decoded "
                  f"tokens/s; host syncs a step {syncs}; idle share over "
                  f"{SERVE_PROFILE_STEPS} profiled steps "
                  f"{1 - busy / wall:.4f} (wave 1 admission: "
                  f"{1 - abusy / awall:.4f}) | {smi}", flush=True)
            per = SERVE_PROFILE_STEPS
            for key, t_us, n in t["decode_profile"][2][:6]:
                print(f"  decode, {label}: {t_us / 1e3 / per:8.3f} ms a "
                      f"step, {n / per:6.1f}x  {key[:70]}")
            if not kernels:
                continue
            record_kernel_times(f"serve {arch}", t, SERVE_KERNELS,
                                {n: out[n][arch] for n in SERVE_KERNELS},
                                phase8, smi)
        print(f"serve {arch}: max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; phase "
              f"{time.perf_counter() - t0:.2f} s | {smi}", flush=True)
        del model
        torch.cuda.empty_cache()
    return out


# ------------------------------------------- the recurrent models ----
# phase 13's traffic: B prompts of PROMPT tokens (not a multiple of the
# scan's 64-step chunk, so its pad path runs), then STEPS greedy decode
# steps through Model.prefill / decode_step
RECURRENT_B, RECURRENT_PROMPT, RECURRENT_STEPS = 4, 1000, 16
# jamba's depth cut to one pattern unit (7 mamba layers, attention at 3,
# MoE at the odd positions): 26 GB of bf16 weights (32 layers: 104 GB)
JAMBA_LAYERS = 8
# the plain path replays the kernel path's expert choices, so the two
# differ by the kernels' arithmetic alone: every row of logits and every
# layer's state and K/V is held, to a relative RMS difference of at most
# JAMBA_RRMS, about twice the largest of seeds 0 and 1 on the card
# (logits 0.0156, conv 0.0142, SSM 0.0267, K/V 0.00726;
# scripts/lockstep_seeds.py --phase 13 0 1, PERF.md §6). The
# plain router's own other choices change nothing downstream then; they
# are held to JAMBA_ROUTER_TIE (about twice 0.00966) and, over a
# prefill's 4,000 tokens, to SERVE_DIVERTED_ADMIT; a step's 4 lanes are
# counted, not bounded.
JAMBA_RRMS = {"logits": 0.03, "mamba.conv": 0.03, "mamba.ssm": 0.05,
              "attn": 0.015}
JAMBA_ROUTER_TIE = 0.02
RECURRENT_KERNELS = ("flash_attention", "moe_gmm", "mamba_scan")
# one xlstm unit in float32, the card against the CPU: relative RMS of the
# logits and every cache leaf, after prompts of the traffic's first 128
# tokens and after its whole prompts. float32 itself drifts from exact
# arithmetic as the sLSTM's sequence grows: on the CPU, float32 against
# float64 reaches 5.5e-6 (sLSTM c) at 128 tokens and 1.1e-4 at 1,000, a
# bfloat16 run 0.047 and 0.35 (scripts/xlstm_unit_precision.py, PERF.md
# §6). Each limit sits between the two readings of its length.
XLSTM_UNIT_RRMS = {128: 1e-4, RECURRENT_PROMPT: 1e-3}
RECURRENT_PROFILE_STEPS = 4


class ModelShadow(ServeShadow):
    """:class:`ServeShadow` over ``Model.prefill`` / ``decode_step``: the
    first and last call of each of ``RECURRENT_KERNELS`` (tag "k"), every
    MoE layer's routes (the plain path's on the kernel path's expert
    choices) and the prefill's final hidden states (either tag)."""

    SITES = ((flash_ops, "flash_attention"), (moe_ops, "moe_gmm"),
             (mamba_ops, "mamba_scan"), (moe_mod, "top_k_choices"),
             (transformer, "forward_hidden"))


def lm_launches():
    """The launches of ``RECURRENT_KERNELS``."""
    return {n: COUNTERS[n].launches for n in RECURRENT_KERNELS}


def state_leaves(slot, kind):
    """``{name: tensor}`` of a cache slot's state (K/V [B, S, Hkv, Dh] for
    attention)."""
    if kind == "attn":
        return {"k": slot.k, "v": slot.v}
    st = getattr(slot, kind)
    return {f"{kind}.{f}": getattr(st, f) for f in st._fields}


def check_model_states(cfg, ck, cp, res, what, limits=None):
    """Each layer's cache on the kernel path against the plain path's:
    every value finite, the first layer's conv state or K/V bit for bit
    (they precede every kernel), every leaf within a relative RMS difference
    of ``limits`` of its kind (``JAMBA_RRMS`` by default; ``"attn"`` for
    K/V)."""
    limits = limits or JAMBA_RRMS
    for i, (layer, sk, sp) in enumerate(zip(
            [s.kind for s in layer_specs(cfg)], ck.slots, cp.slots)):
        for name, a in state_leaves(sk, layer).items():
            b = state_leaves(sp, layer)[name]
            check(bool(torch.isfinite(a.float()).all()),
                  f"{what}: layer {i}'s {name} is not finite")
            if i == 0 and name in ("mamba.conv", "k", "v"):
                check(torch.equal(a, b), f"{what}: the first layer's {name} "
                                         f"differs")
            key = "attn" if layer == "attn" else name
            rr = rms(a.float() - b.float()) / max(rms(b), 1e-30)
            res["states"][key] = max(res["states"].get(key, 0.0), rr)
            res["held"][key] = res["held"].get(key, 0) + 1
            check(rr <= limits[key], f"{what}: layer {i}'s {name}: "
                                     f"relative RMS difference {rr:.4g} > "
                                     f"{limits[key]}")


def layer_specs(cfg):
    """The layer specs of ``cfg`` in execution order."""
    unit = cfg.unit()
    return [unit[i % len(unit)] for i in range(cfg.n_layers)]


def moe_layers(cfg):
    """The number of ``cfg``'s MoE layers."""
    return sum(s.mlp == "moe" for s in layer_specs(cfg))


def recurrent_lockstep(cfg, model, tokens):
    """The jamba gates: the kernel path (``kernels=True``) and the plain
    path of ``Model.prefill`` and ``decode_step`` in lockstep on one
    model, both fed the plain path's greedy tokens, the plain path's MoE
    layers on the kernel path's expert choices (:class:`ModelShadow`).
    Each kernel's first and last call of the prefill and of every step
    against its plain version (the scan's y and last state within
    ``MAMBA_TOL``); the launches as counted; ``kv_len`` equal; every
    layer's cache and every row of logits within ``JAMBA_RRMS``; the
    plain router's own other choices bounded (:func:`dispatch_firsts`);
    greedy tokens where the margin tests them, at every prompt position
    too."""
    m = api.build(cfg)
    B, S = tokens.shape
    max_len = S + RECURRENT_STEPS + 1
    res = dict(admits=0, steps=0, rrms=0.0, tested={}, calls={}, rows=0,
               positions=0, diverged_tokens=0, tie=0.0, tie_n=0, edge=-1,
               edge_n=0, share={}, gaps=0, gaps_under=0, states={},
               held={}, rrms_at="")
    Lm = moe_layers(cfg)
    reqs = list(range(B))
    reset_launch_counts()
    with ModelShadow() as shadow:
        shadow.step("k")
        hk, ck = m.prefill(model, {"tokens": tokens}, max_len, kernels=True)
        shadow.step("p")
        hp, cp = m.prefill(model, {"tokens": tokens}, max_len, kernels=False)
        shadow.tag = None
        what = f"{cfg.name} prefill"
        kinds = [s.kind for s in layer_specs(cfg)]
        want = {"flash_attention": kinds.count("attn"), "moe_gmm": Lm,
                "mamba_scan": kinds.count("mamba")}
        got = lm_launches()
        check(got == want, f"{what}: launches {got}, expected {want}")
        res["prefill_launches"] = got
        check(set(shadow.calls) == set(RECURRENT_KERNELS),
              f"{what}: kernel calls recorded {sorted(shadow.calls)}")
        f = dispatch_firsts(cfg, shadow, cfg.capacity_factor, B,
                            np.ones((B, S), bool), SERVE_DIVERTED_ADMIT, res,
                            what, tie=JAMBA_ROUTER_TIE, where="prefill")
        res["diverged_tokens"] += int((f < Lm).sum())
        check_serve_calls(shadow, res, what)
        prompt_margins(cfg, model, shadow, [S] * B, reqs, res, what)
        same(ck.kv_len, cp.kv_len, f"{what}: kv_len")
        check_model_states(cfg, ck, cp, res, what)
        lk, lp = (transformer.lm_head(h, model.embed, cfg.logit_softcap)
                  for h in (hk, hp))
        rrms_gate(lk, lp, reqs, res, what, JAMBA_RRMS["logits"])
        res["admits"] += 1
        tok = lp.argmax(dim=-1).to(torch.int32)
        for step in range(RECURRENT_STEPS):
            what = f"{cfg.name} step {step + 1}"
            before = lm_launches()
            shadow.step("k")
            lk, ck = m.decode_step(model, ck, tok, kernels=True)
            shadow.step("p")
            lp, cp = m.decode_step(model, cp, tok, kernels=False)
            shadow.tag = None
            got = {n: c - before[n] for n, c in lm_launches().items()}
            want = {"flash_attention": 0, "moe_gmm": Lm, "mamba_scan": 0}
            check(got == want, f"{what}: launches {got}, expected {want}")
            fs = dispatch_firsts(cfg, shadow, max(2.0, cfg.capacity_factor),
                                 B, np.ones((B, 1), bool), 1.0, res, what,
                                 tie=JAMBA_ROUTER_TIE, where="step")
            res["diverged_tokens"] += int((fs < Lm).sum())
            check_serve_calls(shadow, res, what)
            same(ck.kv_len, cp.kv_len, f"{what}: kv_len")
            check_model_states(cfg, ck, cp, res, what)
            margin_gate(lk, lp, reqs, reqs, res, what)
            rrms_gate(lk, lp, reqs, res, what, JAMBA_RRMS["logits"])
            tok = lp.argmax(dim=-1).to(torch.int32)
            res["steps"] += 1
    res["launches"] = lm_launches()
    del ck, cp
    torch.cuda.empty_cache()
    return res


def prompt_len(cfg, batch):
    """The positions a prefill of ``batch`` fills: its tokens, behind the
    patches of a prefix-LM."""
    return batch["tokens"].shape[1] + (cfg.prefix_len if cfg.is_prefix_lm
                                       else 0)


def model_timed(cfg, model, batch, kernels, names=(),
                profile_prefill=True):
    """The traffic ``batch`` through ``Model.prefill`` / ``decode_step``
    alone: the prefill's ms twice (the first a warm-up) and each decode
    step's ms (host clock, synchronised); then a prefill (unless
    ``profile_prefill`` is False) and ``RECURRENT_PROFILE_STEPS`` steps
    under the profiler, and once more with the bound of each call of the
    kernels ``names`` recorded."""
    m = api.build(cfg)
    max_len = prompt_len(cfg, batch) + RECURRENT_STEPS + 1
    prefill, steps = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h, cache = m.prefill(model, batch, max_len, kernels=kernels)
        torch.cuda.synchronize()
        prefill.append((time.perf_counter() - t0) * 1e3)
    tok = transformer.lm_head(h, model.embed, cfg.logit_softcap) \
        .argmax(dim=-1).to(torch.int32)
    for _ in range(RECURRENT_STEPS):
        t0 = time.perf_counter()
        logits, cache = m.decode_step(model, cache, tok, kernels=kernels)
        tok = logits.argmax(dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t0) * 1e3)
    box = {}

    def pre():
        box["cache"] = m.prefill(model, batch, max_len, kernels=kernels)[1]

    def dec():
        for _ in range(RECURRENT_PROFILE_STEPS):
            box["cache"] = m.decode_step(model, box["cache"], tok,
                                         kernels=kernels)[1]
    reset_launch_counts()
    if profile_prefill:
        pre_prof = profiled(pre)
    else:
        pre()
        pre_prof = None
    pre_calls = launch_counts()
    reset_launch_counts()
    dec_prof = profiled(dec)
    dec_calls = launch_counts()
    pre_bounds = call_bounds(pre, names) if names else {}
    dec_bounds = call_bounds(dec, names) if names else {}
    del box, cache
    torch.cuda.empty_cache()
    return dict(prefill_ms=prefill, step_ms=steps, prefill_profile=pre_prof,
                prefill_calls=pre_calls, prefill_bounds=pre_bounds,
                decode_profile=dec_prof, decode_calls=dec_calls,
                decode_bounds=dec_bounds)


def print_model_times(label, t, smi):
    """Print :func:`model_timed`'s times and the top of its profiles;
    returns the median decode step's ms."""
    steps = torch.tensor(t["step_ms"], dtype=torch.float64)
    wall, busy = t["decode_profile"][:2]
    syncs = {k: v / RECURRENT_PROFILE_STEPS
             for k, v in t["decode_profile"][3].items()}
    pre = ""
    if t["prefill_profile"] is not None:
        pwall, pbusy = t["prefill_profile"][:2]
        pre = f" (prefill: {1 - pbusy / pwall:.4f})"
    print(f"{label}: prefill {[round(x, 3) for x in t['prefill_ms']]} ms "
          f"(the first a warm-up); decode step median {steps.median():.3f} "
          f"ms (min {steps.min():.3f}, max {steps.max():.3f}, {len(steps)} "
          f"steps); host syncs a step {syncs}; idle share over "
          f"{RECURRENT_PROFILE_STEPS} profiled steps {1 - busy / wall:.4f}"
          f"{pre} | {smi}", flush=True)
    for where in ("prefill", "decode"):
        if t[f"{where}_profile"] is None:
            continue
        n = 1 if where == "prefill" else RECURRENT_PROFILE_STEPS
        for key, t_us, c in t[f"{where}_profile"][2][:5]:
            print(f"  {where}, {label}: {t_us / 1e3 / n:8.3f} ms a "
                  f"{'prefill' if n == 1 else 'step'}, {c / n:7.1f}x  "
                  f"{key[:70]}")
    return float(steps.median())


def recurrent_tokens(seed, vocab, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, vocab, (RECURRENT_B, RECURRENT_PROMPT),
                         generator=gen, device=dev, dtype=torch.int32)


def run_jamba(args, dev, smi, phase8):
    """Phase 13 (a): jamba-v0.1-52b at full width, one unit deep."""
    full = get_arch("jamba-v0.1-52b")
    cfg = dataclasses.replace(full, n_layers=JAMBA_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    model = api.build(cfg).init(
        torch.Generator(device=dev).manual_seed(args.seed + 13), device=dev)
    tokens = recurrent_tokens(args.seed + 13, cfg.vocab, dev)
    n_weights = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"{cfg.name}: {JAMBA_LAYERS} of {full.n_layers} layers "
          f"{[f'{s.kind}/{s.mlp}' for s in layer_specs(cfg)]}, "
          f"weights {n_weights / 1e9:.3f} GB (bf16, random from the seed), "
          f"{RECURRENT_B} prompts of {RECURRENT_PROMPT} tokens, "
          f"{RECURRENT_STEPS} steps", flush=True)
    res = recurrent_lockstep(cfg, model, tokens)
    check(res["calls"].get("mamba_scan", {}).get("checked", 0) >= 2,
          f"{cfg.name}: the prefill's scan calls were not checked")
    short = [r for r in range(RECURRENT_B) if res["tested"].get(r, 0) < 1]
    check(not short, f"{cfg.name}: prompts {short} have no position whose "
                     f"margin tests the greedy token")
    print(f"{cfg.name} lockstep: prefill launches "
          f"{res['prefill_launches']}, then {moe_layers(cfg)} "
          f"moe_gmm a step ({res['steps']} steps), totals "
          f"{res['launches']} = expected; kv_len equal; kernel calls "
          f"against their plain versions {res['calls']}; the first "
          f"layer's conv state bit-identical; on the kernel path's expert "
          f"choices, every state and K/V held: relative RMS difference "
          f"max {res['states']} over {res['held']} layer checks (limits "
          f"{JAMBA_RRMS}); logits' relative RMS difference "
          f"max {res['rrms']:.4g} (at {res['rrms_at']}, limit "
          f"{JAMBA_RRMS['logits']}) over {res['rows']} rows; greedy tokens "
          f"equal at "
          f"{sum(res['tested'].values())} of {res['positions']} positions "
          f"the margin tests (per prompt "
          f"{[res['tested'].get(r, 0) for r in range(RECURRENT_B)]}); "
          f"the plain router chose otherwise for {res['diverged_tokens']} "
          f"tokens (the largest share {res['share']}; "
          f"{res['tie_n']} at a margin of at most {res['tie']:.4g}, limit "
          f"{JAMBA_ROUTER_TIE}, "
          f"{res['edge_n']} at most {res['edge']} ranks from a capacity's "
          f"edge) | {smi}",
          flush=True)
    out = {}
    for kernels in (True, False):
        label = f"{cfg.name}, {'kernels' if kernels else 'plain'}"
        t = model_timed(cfg, model, {"tokens": tokens}, kernels,
                        RECURRENT_KERNELS if kernels else ())
        med = print_model_times(label, t, smi)
        key = "kernels" if kernels else "plain"
        out[f"{key}_prefill_ms"] = t["prefill_ms"][-1]
        out[f"{key}_step_ms"] = med
        if kernels:
            recs = {n: out.setdefault(n, dict(launches=res["launches"][n]))
                    for n in RECURRENT_KERNELS}
            record_kernel_times(cfg.name, t, RECURRENT_KERNELS, recs, phase8,
                                smi)
    print(f"{cfg.name}: max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB | {smi}",
          flush=True)
    del model
    torch.cuda.empty_cache()
    return out


def rel_rms(a, b):
    return rms(a.float().cpu() - b.float().cpu()) / max(rms(b.float().cpu()),
                                                        1e-30)


def run_xlstm(args, dev, smi):
    """Phase 13 (b): xlstm-350m, full width and depth, plain (no kernel
    serves mLSTM or sLSTM), timed; then one unit in float32 on the card
    against the CPU on the same weights and tokens."""
    cfg = get_arch("xlstm-350m")
    model = api.build(cfg).init(
        torch.Generator(device=dev).manual_seed(args.seed + 14), device=dev)
    tokens = recurrent_tokens(args.seed + 14, cfg.vocab, dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {cfg.n_layers} layers, {n_params / 1e6:.1f} M "
          f"parameters (bf16, random from the seed), {RECURRENT_B} prompts "
          f"of {RECURRENT_PROMPT} tokens, {RECURRENT_STEPS} steps",
          flush=True)
    t = model_timed(cfg, model, {"tokens": tokens}, True,
                    profile_prefill=False)
    counts = [t["prefill_calls"], t["decode_calls"]]
    check(not any(v for c in counts for v in c.values()),
          f"{cfg.name}: a kernel launched on a path without one: {counts}")
    out = dict(prefill_ms=t["prefill_ms"][-1],
               step_ms=print_model_times(f"{cfg.name}, plain", t, smi))
    del model
    torch.cuda.empty_cache()
    # one unit, float32, the card against the CPU
    unit = dataclasses.replace(cfg, n_layers=cfg.unit_len, dtype="float32")
    m = api.build(unit)
    card = m.init(torch.Generator(device=dev).manual_seed(args.seed + 15),
                  device=dev)
    cpu = transformer.Transformer(unit, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    out["unit_f32_rrms"] = {}
    for n_tok, limit in XLSTM_UNIT_RRMS.items():
        t0 = time.perf_counter()
        worst = unit_against_cpu(unit, card, cpu, tokens[:, :n_tok], limit)
        print(f"{cfg.name}, one unit (mLSTM + sLSTM) in float32, the card "
              f"against the CPU ({RECURRENT_B} prompts of {n_tok} tokens, "
              f"{RECURRENT_STEPS} steps, {time.perf_counter() - t0:.2f} s): "
              f"relative RMS difference at most "
              f"{({k: float(f'{v:.3g}') for k, v in worst.items()})} "
              f"(limit {limit}) | {smi}", flush=True)
        out["unit_f32_rrms"][n_tok] = worst
    del card, cpu
    torch.cuda.empty_cache()
    return out


def unit_against_cpu(unit, card, cpu, tokens, limit):
    """``tokens`` through ``Model.prefill`` and ``RECURRENT_STEPS`` decode
    steps of one float32 unit on the card and its copy on the CPU, each fed
    the CPU's greedy tokens: the logits and every cache leaf after the
    prefill and every step within a relative RMS difference of ``limit``.
    Returns the largest of each."""
    m = api.build(unit)
    dev = card.embed.device
    worst = {}

    def hold(a, b, what):
        rr = rel_rms(a, b)
        worst[what] = max(worst.get(what, 0.0), rr)
        check(rr <= limit, f"{unit.name} unit, float32, card against the "
                           f"CPU, prompts of {tokens.shape[1]}: {what}: "
                           f"relative RMS difference {rr:.3g} > {limit}")

    def caches(cg, cc, what):
        same(cg.kv_len.cpu(), cc.kv_len, f"{what}: kv_len")
        for i, (s, kind) in enumerate(zip(
                cg.slots, [s.kind for s in layer_specs(unit)])):
            sc = cc.slots[i]
            for name, a in state_leaves(s, kind).items():
                hold(a, state_leaves(sc, kind)[name], name)

    max_len = tokens.shape[1] + RECURRENT_STEPS + 1
    hg, cg = m.prefill(card, {"tokens": tokens}, max_len)
    hc, cc = m.prefill(cpu, {"tokens": tokens.cpu()}, max_len)
    caches(cg, cc, "prefill")
    tok = transformer.lm_head(hc, cpu.embed, unit.logit_softcap) \
        .argmax(dim=-1).to(torch.int32)
    hold(transformer.lm_head(hg, card.embed, unit.logit_softcap),
         transformer.lm_head(hc, cpu.embed, unit.logit_softcap), "logits")
    for step in range(RECURRENT_STEPS):
        lg, cg = m.decode_step(card, cg, tok.to(dev))
        lc, cc = m.decode_step(cpu, cc, tok)
        hold(lg, lc, "logits")
        caches(cg, cc, f"step {step + 1}")
        tok = lc.argmax(dim=-1).to(torch.int32)
    return worst


@torch.no_grad()
def run_recurrent_phase(args, dev, smi, lm_records):
    """Phase 13: the recurrent and hybrid models through ``Model.prefill``
    / ``decode_step``. Returns jamba's record of each of
    ``RECURRENT_KERNELS`` and the timings of both models."""
    torch.backends.cuda.matmul.allow_tf32 = False
    jamba = run_jamba(args, dev, smi, {r["name"]: r for r in lm_records})
    xlstm = run_xlstm(args, dev, smi)
    return jamba, xlstm


# ---------------------------------- the encoder-decoder and prefix-LM ----
# phase 14's traffic through Model.prefill / decode_step at full width and
# depth: whisper-medium, ENCDEC_B clips of its 1,500-frame (30 s) window as
# stub embeddings, 0.1·N(0, 1) as the reference's data pipeline makes them,
# and a 4-token start-of-transcript prompt; paligemma-3b, ENCDEC_B images
# of 256 patch embeddings (0.1·N(0, 1)) and 32 text tokens; then
# RECURRENT_STEPS (16) greedy decode steps
ENCDEC_B = 8
ENCDEC_PROMPT = {"whisper-medium": 4, "paligemma-3b": 32}
# neither model has experts, so the kernel path and the plain path differ
# by the kernels' arithmetic alone: every row of logits, each layer's K/V
# ("attn") and whisper's encoder output ("enc_kv") within these relative
# RMS differences, about twice the larger reading of seeds 0 and 1 on the
# card (scripts/lockstep_seeds.py --phase 14 0 1, PERF.md §6)
ENCDEC_RRMS = {"logits": 0.045, "attn": 0.045, "enc_kv": 0.06}
ENCDEC_REPS = 20      # CUDA-event launches timed per kind of flash call


class EncdecShadow(ServeShadow):
    """:class:`ServeShadow` over ``Model.prefill`` / ``decode_step`` of an
    encoder-decoder or prefix-LM: the first and last ``flash_attention``
    call of each kind (tag "k"), keyed ``flash_attention (kind)``, and how
    many of each ran since the last ``step("k")`` (``kinds``); the
    prefill's final hidden states (either tag). The kind is the function
    the call runs inside: ``encode`` (the encoder), ``cross_attend`` (the
    cross-attention, at ``stage`` "prefill" or "decode"),
    ``prefix_attention`` (its causal or its prefix-block launch), else
    the decoder's self-attention."""

    SITES = ((flash_ops, "flash_attention"), (transformer, "forward_hidden"),
             (transformer, "encode"), (transformer, "cross_attend"),
             (model_blocks, "prefix_attention"))
    CONTEXTS = ("encode", "cross_attend", "prefix_attention")

    def __init__(self):
        super().__init__()
        self.within, self.kinds, self.stage = [], {}, "prefill"

    def step(self, tag):
        super().step(tag)
        if tag == "k":
            self.kinds = {}

    def call_key(self, name, args, kw):
        where = self.within[-1] if self.within else None
        kind = {"encode": "encoder",
                "cross_attend": f"cross, {self.stage}",
                "prefix_attention": "prefix, causal" if kw.get("causal")
                else "prefix, block"}.get(where, "decoder self")
        key = f"{name} ({kind})"
        self.kinds[key] = self.kinds.get(key, 0) + 1
        return key

    def _wrap(self, name):
        if name not in self.CONTEXTS:
            return super()._wrap(name)
        fn = self.orig[name]

        def call(*args, **kw):
            self.within.append(name)
            try:
                return fn(*args, **kw)
            finally:
                self.within.pop()
        return call


def encdec_kinds(cfg, stage):
    """``{flash_attention (kind): launches}`` of a prefill or a decode
    step of ``cfg``."""
    L, key = cfg.n_layers, "flash_attention ({})".format
    if cfg.is_prefix_lm:
        return {key("prefix, causal"): L, key("prefix, block"): L} \
            if stage == "prefill" else {}
    if stage == "decode":
        return {key("cross, decode"): L}
    return {key("encoder"): cfg.encoder_layers, key("decoder self"): L,
            key("cross, prefill"): L}


def encdec_launches(cfg, stage, what):
    """The launches since the last reset are ``stage``'s kinds' and none
    of another kernel."""
    want = {n: 0 for n in WRAPPERS}
    want["flash_attention"] = sum(encdec_kinds(cfg, stage).values())
    got = launch_counts()
    check(got == want, f"{what}: launches {got}, expected {want}")


def encdec_lockstep(cfg, model, batch):
    """The phase-14 gates: the kernel path and the plain path
    (``kernels=False``) of ``Model.prefill`` and ``decode_step`` in
    lockstep on one model, both fed the plain path's greedy tokens: each
    kind's launches as counted and no other kernel; each kind's first and
    last call of the prefill and of every step against its plain version;
    ``kv_len`` equal; the first layer's K/V bit for bit, every layer's,
    whisper's encoder output and every row of logits within
    ``ENCDEC_RRMS``; greedy tokens where the margin tests them, at every
    prompt position too. Returns the counts, the largest differences and
    the first call of each kind (for its timing)."""
    m = api.build(cfg)
    B, S = batch["tokens"].shape[0], prompt_len(cfg, batch)
    max_len = S + RECURRENT_STEPS + 1
    res = dict(admits=0, steps=0, rrms=0.0, rrms_at="", tested={}, calls={},
               rows=0, positions=0, states={}, held={}, enc_kv=None,
               kinds={}, first_calls={})
    reqs = list(range(B))

    def gates(shadow, stage, what):
        encdec_launches(cfg, stage, what)
        check(shadow.kinds == encdec_kinds(cfg, stage),
              f"{what}: flash calls by kind {shadow.kinds}, expected "
              f"{encdec_kinds(cfg, stage)}")
        for key, n in shadow.kinds.items():
            res["kinds"][key] = res["kinds"].get(key, 0) + n
            res["first_calls"].setdefault(key, shadow.calls[key][0])
        check_serve_calls(shadow, res, what)

    with EncdecShadow() as shadow:
        reset_launch_counts()
        shadow.step("k")
        hk, ck = m.prefill(model, batch, max_len, kernels=True)
        shadow.step("p")
        hp, cp = m.prefill(model, batch, max_len, kernels=False)
        shadow.tag = None
        what = f"{cfg.name} prefill"
        gates(shadow, "prefill", what)
        prompt_margins(cfg, model, shadow, [S] * B, reqs, res, what)
        same(ck.kv_len, cp.kv_len, f"{what}: kv_len")
        check_model_states(cfg, ck, cp, res, what, ENCDEC_RRMS)
        for a, b in zip(ck.enc_kv, cp.enc_kv):
            check(a.shape == (B, cfg.encoder_seq, cfg.d_model)
                  and bool(torch.isfinite(a.float()).all()),
                  f"{what}: the encoder output {tuple(a.shape)} is not "
                  f"finite at full length")
            res["enc_kv"] = rms(a.float() - b.float()) / rms(b)
            check(res["enc_kv"] <= ENCDEC_RRMS["enc_kv"],
                  f"{what}: the encoder output's relative RMS difference "
                  f"{res['enc_kv']:.4g} > {ENCDEC_RRMS['enc_kv']}")
        lk, lp = (transformer.lm_head(h, model.embed, cfg.logit_softcap)
                  for h in (hk, hp))
        rrms_gate(lk, lp, reqs, res, what, ENCDEC_RRMS["logits"])
        res["admits"] += 1
        tok = lp.argmax(dim=-1).to(torch.int32)
        shadow.stage = "decode"
        for step in range(RECURRENT_STEPS):
            what = f"{cfg.name} step {step + 1}"
            reset_launch_counts()
            shadow.step("k")
            lk, ck = m.decode_step(model, ck, tok, kernels=True)
            shadow.step("p")
            lp, cp = m.decode_step(model, cp, tok, kernels=False)
            shadow.tag = None
            gates(shadow, "decode", what)
            same(ck.kv_len, cp.kv_len, f"{what}: kv_len")
            check_model_states(cfg, ck, cp, res, what, ENCDEC_RRMS)
            margin_gate(lk, lp, reqs, reqs, res, what)
            rrms_gate(lk, lp, reqs, res, what, ENCDEC_RRMS["logits"])
            tok = lp.argmax(dim=-1).to(torch.int32)
            res["steps"] += 1
    del ck, cp
    torch.cuda.empty_cache()
    return res


def flash_kind_times(first_calls, smi, label):
    """Each kind's first call of the lockstep relaunched with CUDA events
    (the GPU held while they queue), beside its bound, its plain version
    and SDPA on the same inputs; returns ``{kind: record}``."""
    out = {}
    for key, (args, kw, ker_out) in first_calls.items():
        q, k, v = args
        causal = kw.get("causal", True)
        launch = flash_ops.prepare(q, k, v, **kw)
        launch()
        time_events(launch, ENCDEC_REPS, hold=True)   # warm-up, not kept
        ms = time_events(launch, ENCDEC_REPS, hold=True)
        plain_ms = time_events(lambda: flash_ref.flash_attention_ref(
            q, k, v, **kw), 2)
        qt, kt, vt = (t.transpose(1, 2) for t in args)

        def lib():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        lib_err = float((lib().transpose(1, 2).float()
                         - ker_out.float()).abs().max())
        lib()
        lib_ms = time_events(lib, ENCDEC_REPS, hold=True)
        n_bytes, op_s = serve_call_work("flash_attention", args, kw)
        bound_ms, bound_by = serve_bound(n_bytes, op_s)
        B, Sq, Hq, D = q.shape
        print(f"{label}: {key}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
              f"causal {causal}: {ms:.4f} ms a call (CUDA events, GPU held, "
              f"{ENCDEC_REPS} launches), bound {bound_ms:.4f} ms "
              f"({bound_by}; {flash_pairs(Sq, k.shape[1], causal, None)} "
              f"visible pairs a head, {n_bytes / 1e6:.3f} MB), "
              f"{100 * bound_ms / ms:.1f} % of it; SDPA {lib_ms:.4f} ms "
              f"(max abs {lib_err:.3g} from the kernel); plain "
              f"{plain_ms:.4f} ms | {smi}", flush=True)
        out[key.split("(")[1][:-1]] = dict(
            ms=ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms,
            plain_ms=plain_ms, library_max_abs_diff=lib_err,
            shape=dict(q=list(q.shape), k=list(k.shape), causal=causal))
    return out


def encdec_batch(cfg, seed, dev):
    """Phase 14's traffic for ``cfg``: ``ENCDEC_B`` prompts of
    ``ENCDEC_PROMPT`` tokens and the stub frontend's embeddings."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    batch = {"tokens": torch.randint(
        0, cfg.vocab, (ENCDEC_B, ENCDEC_PROMPT[cfg.name]), generator=gen,
        device=dev, dtype=torch.int32)}
    for name, n, on in (("frames", cfg.encoder_seq, cfg.is_encdec),
                        ("patches", cfg.prefix_len, cfg.is_prefix_lm)):
        if on:
            batch[name] = (0.1 * torch.randn(
                ENCDEC_B, n, cfg.d_model, generator=gen, device=dev)) \
                .to(cfg.param_dtype)
    return batch


def encdec_model(arch, seed, dev):
    """``arch`` at full width and depth, bf16 weights from ``seed``, and
    its traffic."""
    cfg = get_arch(arch)
    model = api.build(cfg).init(
        torch.Generator(device=dev).manual_seed(seed), device=dev)
    return cfg, model, encdec_batch(cfg, seed, dev)


def run_encdec_model(args, dev, smi, arch, phase8):
    """Phase 14 for one model: the lockstep, then both paths timed."""
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, batch = encdec_model(arch, args.seed + 14, dev)
    n_weights = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"{cfg.name}: {cfg.n_layers} layers"
          + (f" and {cfg.encoder_layers} encoder layers over "
             f"{cfg.encoder_seq} frames" if cfg.is_encdec else
             f" behind {cfg.prefix_len} patches")
          + f", weights {n_weights / 1e9:.3f} GB (bf16, random from the "
          f"seed), {ENCDEC_B} prompts of {ENCDEC_PROMPT[arch]} tokens, "
          f"{RECURRENT_STEPS} steps", flush=True)
    res = encdec_lockstep(cfg, model, batch)
    short = [r for r in range(ENCDEC_B) if res["tested"].get(r, 0) < 1]
    check(not short, f"{cfg.name}: prompts {short} have no position whose "
                     f"margin tests the greedy token")
    launches = sum(res["kinds"].values())
    print(f"{cfg.name} lockstep: flash_attention launches by kind "
          f"{res['kinds']} (a prefill {encdec_kinds(cfg, 'prefill')}, a "
          f"step {encdec_kinds(cfg, 'decode')}), no other kernel; kv_len "
          f"equal; kernel calls against their plain versions "
          f"{res['calls']}; the first layer's K/V bit-identical, every "
          f"layer's relative RMS difference max {res['states']} over "
          f"{res['held']} layer checks"
          + (f", the encoder output's {res['enc_kv']:.4g}"
             if res["enc_kv"] is not None else "")
          + f" (limits {ENCDEC_RRMS}); logits' relative RMS difference max "
          f"{res['rrms']:.4g} (at {res['rrms_at']}) over {res['rows']} "
          f"rows; greedy tokens equal at {sum(res['tested'].values())} of "
          f"{res['positions']} positions the margin tests (per prompt "
          f"{[res['tested'].get(r, 0) for r in range(ENCDEC_B)]}) | {smi}",
          flush=True)
    rec = dict(launches=launches, launches_by_kind=res["kinds"],
               kinds=flash_kind_times(res["first_calls"], smi, cfg.name))
    del res
    for kernels in (True, False):
        key = "kernels" if kernels else "plain"
        t = model_timed(cfg, model, batch, kernels,
                        ("flash_attention",) if kernels else ())
        rec[f"{key}_prefill_ms"] = t["prefill_ms"][-1]
        rec[f"{key}_step_ms"] = print_model_times(f"{cfg.name}, {key}", t,
                                                  smi)
        if kernels:
            record_kernel_times(cfg.name, t, ("flash_attention",),
                                {"flash_attention": rec}, phase8, smi)
    print(f"{cfg.name}: max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; "
          f"{time.perf_counter() - t0:.2f} s | {smi}", flush=True)
    del model, batch
    torch.cuda.empty_cache()
    return rec


@torch.no_grad()
def run_encdec_phase(args, dev, smi, lm_records):
    """Phase 14: the encoder-decoder and prefix-LM models through
    ``Model.prefill`` / ``decode_step``. Returns ``flash_attention``'s
    record of each."""
    torch.backends.cuda.matmul.allow_tf32 = False
    phase8 = {r["name"]: r for r in lm_records}
    return {arch: run_encdec_model(args, dev, smi, arch, phase8)
            for arch in ENCDEC_PROMPT}


# ----------------------------------------------------------- training ----
# phase 15: granite-3-8b at full width (d 4,096, 32 heads over 8 KV heads
# of 128, d_ff 12,800, vocab 49,155), TRAIN_LAYERS of its 40 layers, bf16
# weights from --seed; the data, step and optimizer settings of the issue
# that sized it (8 sequences of 1,024 tokens in 2 microbatches, baseline
# policy: nothing_saveable)
TRAIN_ARCH = "granite-3-8b"
TRAIN_LAYERS = 8
TRAIN_DATA = dict(seq_len=1024, global_batch=8)
TRAIN_MICRO = 2
TRAIN_OPT = dict(lr=3e-4, warmup_steps=8, total_steps=24)
TRAIN_STEPS = 24
TRAIN_PROFILE_STEPS = 2
# (b) one float32 layer at the same width, B = 2, S = 128, on the card and
# on the host CPU with the same weights and batch: the loss and every
# gradient leaf within this relative RMS difference, about twice the
# larger reading of seeds 0 and 1 (2.442e-6 and 2.367e-6, the CPU's pass
# on all but two host threads; PERF.md §6, scripts/lockstep_seeds.py
# --phase 15 0 1); the microbatched gradients against one batch on the
# card within the same limit (1.209e-6 and 1.237e-6)
TRAIN_UNIT = dict(seq_len=128, global_batch=2)
TRAIN_UNIT_RRMS = 5e-6
# (c) examples/train_lm_torch.py's scenario at its 10m preset
RECOVERY = dict(steps=60, fail_at=35, preset="10m", ckpt_every=20)
# the device time a train step spends in each of these (the plain
# attention, the cross-entropy and the optimizer), forward, recompute and
# backward
TRAIN_RANGES = {"attention": (model_common, "chunked_attention"),
                "cross-entropy": (model_common, "chunked_cross_entropy"),
                "optimizer": (train_opt, "apply")}
# matrix-product kernels as cuBLAS and CUTLASS name them
GEMM_NAMES = ("gemm", "Gemm", "GEMM", "cutlass", "xmma", "nvjet", "cublas")


class TrainRanges:
    """While active, each function of ``TRAIN_RANGES`` runs inside a
    ``record_function`` range of its label."""

    def __enter__(self):
        self.saved = {}
        for label, (mod, name) in TRAIN_RANGES.items():
            fn = getattr(mod, name)
            self.saved[label] = fn

            def ranged(*a, _fn=fn, _label=label, **kw):
                with torch.profiler.record_function(_label):
                    return _fn(*a, **kw)
            setattr(mod, name, ranged)
        return self

    def __exit__(self, *exc):
        for label, (mod, name) in TRAIN_RANGES.items():
            setattr(mod, name, self.saved[label])


def _labels_of(cpu, labels):
    """The label of each host event of the raw trace ``cpu``: its nearest
    enclosing ``labels`` range, or, in the backward pass, the range its
    forward operator ran under (matched by thread and autograd sequence
    number), else None. Nesting is rebuilt per thread from the events'
    intervals."""
    parent = [-1] * len(cpu)
    threads = {}
    for i, e in enumerate(cpu):
        threads.setdefault(e.start_thread_id(), []).append(i)
    for idx in threads.values():
        idx.sort(key=lambda i: (cpu[i].start_ns(), -cpu[i].end_ns()))
        stack = []
        for i in idx:
            while stack and cpu[stack[-1]].end_ns() <= cpu[i].start_ns():
                stack.pop()
            parent[i] = stack[-1] if stack else -1
            stack.append(i)
    names = [e.name() for e in cpu]
    order = sorted(range(len(cpu)), key=lambda i: cpu[i].start_ns())
    rng = [None] * len(cpu)          # the nearest enclosing range
    for i in order:
        p = parent[i]
        rng[i] = names[i] if names[i] in labels else (
            rng[p] if p >= 0 else None)
    fwd = {(cpu[i].start_thread_id(), cpu[i].sequence_nr()): rng[i]
           for i in range(len(cpu)) if rng[i] and cpu[i].sequence_nr() >= 0
           and not names[i].startswith("autograd::")}
    label = [None] * len(cpu)
    for i in order:
        if names[i] in labels:
            label[i] = names[i]
            continue
        if names[i].startswith("autograd::engine::evaluate_function"):
            e = cpu[i]
            hit = fwd.get((e.fwd_thread_id() or e.start_thread_id(),
                           e.sequence_nr()))
            if hit:
                label[i] = hit
                continue
        p = parent[i]
        label[i] = label[p] if p >= 0 else None
    return label


def train_profile(fn):
    """``fn`` under the profiler with :class:`TrainRanges`: the wall time,
    the device's busy time, the matrix products' device time, each
    range's device time (a kernel counts for the label of the host event
    that launched it, :func:`_labels_of`) with its three costliest
    kernels, and the host syncs, all in us.
    It reads the raw trace: building the profiler's event tree takes
    longer than the steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with TrainRanges(), profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.profiler.kineto_results.events()
    cpu = [e for e in events if e.device_type() != DeviceType.CUDA]
    label = _labels_of(cpu, set(TRAIN_RANGES))
    by_corr = {e.correlation_id(): label[i] for i, e in enumerate(cpu)
               if e.correlation_id()}
    busy = gemm = 0.0
    ranges, kernels = {}, {}
    syncs = {"sync calls": -2, "device reads": 0, "DtoH copies": 0}
    for e in events:
        name = e.name()
        if e.device_type() != DeviceType.CUDA:
            syncs["sync calls"] += name in SYNC_CALLS
            syncs["device reads"] += name in DEVICE_READS
            continue
        if name in TRAIN_RANGES:   # a range's span on the device
            continue
        t = e.duration_ns() / 1e3
        busy += t
        gemm += t * any(k in name for k in GEMM_NAMES)
        syncs["DtoH copies"] += "DtoH" in name
        lab = by_corr.get(e.linked_correlation_id())
        ranges[lab] = ranges.get(lab, 0.0) + t
        kernels[lab, name] = kernels.get((lab, name), 0.0) + t
    top = {lab: sorted(((t, k) for (l_, k), t in kernels.items()
                        if l_ == lab), reverse=True)[:3] for lab in ranges}
    return dict(wall_us=wall_us, busy_us=busy, gemm_us=gemm, ranges=ranges,
                top=top, syncs=syncs)


def train_work(cfg, n_tokens, seq_len):
    """Matrix-product flops of one train step under ``nothing_saveable``
    (forward, its recompute and a backward of twice the forward), the
    chunked attention's full square of scores and values included (its
    masked chunks are computed), and the bytes the optimizer must move
    (each parameter read and written, its float32 gradient read, m and v
    read and written)."""
    d, f = cfg.d_model, cfg.d_ff
    dh = cfg.d_head
    per_tok = cfg.n_layers * (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * dh
                              + cfg.n_heads * dh * d + 3 * d * f) \
        + cfg.vocab * d
    attn = cfg.n_layers * 4 * seq_len * cfg.n_heads * dh * n_tokens
    fwd = 2 * n_tokens * per_tok + attn
    n_params = cfg.n_params()
    return 4 * fwd, n_params * (2 * 2 + 4 + 4 * 4)


def run_train_full_width(args, dev, smi):
    """Phase 15 (a). Returns the record printed."""
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    m = api.build(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = m.init(torch.Generator(device=dev).manual_seed(args.seed + 15),
                    device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    dcfg = train_data.DataConfig(vocab=cfg.vocab, seed=args.seed + 15,
                                 **TRAIN_DATA)
    ocfg = train_opt.AdamWConfig(**TRAIN_OPT)
    perf_policy.set_policy("baseline")
    step = trainstep.make_train_step(m, ocfg, TRAIN_MICRO)
    ostate = train_opt.init(params)
    torch.cuda.synchronize()
    print(f"train {TRAIN_ARCH}: {TRAIN_LAYERS} of "
          f"{get_arch(TRAIN_ARCH).n_layers} layers (depth only), "
          f"{n_params / 1e9:.4f} B parameters (bf16, random from the "
          f"seed), AdamW moments {2 * 4 * n_params / 1e9:.3f} GB; set-up "
          f"{time.perf_counter() - t0:.2f} s | {smi}", flush=True)
    reset_launch_counts()
    losses, gnorms, ms = [], [], []
    state = [params, ostate]

    def run(i):
        batch = train_data.make_batch(dcfg, i, arch=cfg, device=dev)
        state[0], state[1], met = step(*state, batch)
        return met
    # the last TRAIN_PROFILE_STEPS of the steps run under the profiler
    n_timed = TRAIN_STEPS - TRAIN_PROFILE_STEPS
    for i in range(n_timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        met = run(i)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
    profiled_mets = []
    t0 = time.perf_counter()
    prof = train_profile(lambda: profiled_mets.extend(
        run(i) for i in range(n_timed, TRAIN_STEPS)))
    prof_s = time.perf_counter() - t0
    losses += [float(m_["loss"]) for m_ in profiled_mets]
    gnorms += [float(m_["grad_norm"]) for m_ in profiled_mets]
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(len(losses) == TRAIN_STEPS, f"train: {len(losses)} steps ran")
    check(all(np.isfinite(losses)) and all(np.isfinite(gnorms)),
          f"train: a loss or gradient norm is not finite: {losses} "
          f"{gnorms}")
    check(np.mean(losses[-4:]) < losses[0],
          f"train: the mean of the last 4 losses "
          f"{np.mean(losses[-4:]):.4f} is not below the first "
          f"{losses[0]:.4f}")
    lm = {n: launches[n] for n in LM_PLAIN}
    check(not any(lm.values()), f"train: an LM kernel launched on the "
                                f"train path: {lm}")
    tokens = TRAIN_DATA["global_batch"] * TRAIN_DATA["seq_len"]
    med = float(np.median(ms[1:]))
    flops, opt_bytes = train_work(cfg, tokens, TRAIN_DATA["seq_len"])
    print(f"train {TRAIN_ARCH}: {TRAIN_STEPS} steps, losses "
          f"{[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 3) for x in gnorms]}; LM kernel launches {lm}",
          flush=True)
    print(f"train {TRAIN_ARCH}: step median {med:.3f} ms over steps 2-"
          f"{n_timed} (first {ms[0]:.3f}, min {min(ms[1:]):.3f}, max "
          f"{max(ms[1:]):.3f}; host clock, synchronised), "
          f"{tokens / med * 1e3:.1f} tokens/s; matrix products "
          f"{flops / 1e12:.2f} TFLOP a step (bound "
          f"{flops / BF16_FLOPS * 1e3:.3f} ms at the bf16 peak, "
          f"{flops / med / 1e9:.1f} TFLOP/s achieved); optimizer bytes "
          f"{opt_bytes / 1e9:.2f} GB (bound "
          f"{opt_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms); "
          f"max_memory_allocated {peak / 1e9:.3f} GB | {smi}", flush=True)
    n = TRAIN_PROFILE_STEPS
    ranges = {k if k else "the rest": round(v / 1e3 / n, 3)
              for k, v in prof["ranges"].items()}
    idle = 1 - prof["busy_us"] / prof["wall_us"]
    syncs = {k: v / n for k, v in prof["syncs"].items()}
    print(f"train {TRAIN_ARCH}, profile of the last {n} steps: wall "
          f"{prof['wall_us'] / 1e3 / n:.3f} ms a step, device busy "
          f"{prof['busy_us'] / 1e3 / n:.3f} ms (idle share {idle:.4f}); "
          f"matrix-product kernels {prof['gemm_us'] / 1e3 / n:.3f} ms a "
          f"step; device ms a step by range (forward, recompute and "
          f"backward; its matrix products included) {ranges}; host syncs "
          f"a step {syncs} (make_batch's copies to the card); profiling "
          f"{prof_s:.2f} s | {smi}", flush=True)
    for lab, rows in prof["top"].items():
        print(f"  {lab or 'the rest'}: " + "; ".join(
            f"{t / 1e3 / n:.3f} ms a step {k[:60]}" for t, k in rows))
    del params, ostate, step, state, profiled_mets
    torch.cuda.empty_cache()
    return dict(step_ms=med, tokens_per_s=tokens / med * 1e3,
                peak_gb=peak / 1e9, idle_share=idle, losses=losses,
                launches=lm)


def train_rrms(a, b):
    """The relative RMS difference of ``a`` from ``b``, on their device."""
    a, b = a.double(), b.double()
    return (a - b).square().mean().sqrt() / b.square().mean().sqrt() \
        .clamp(min=1e-30)


def unit_grads(m, model, batch, n_micro, remat=None):
    """``trainstep.grads_and_loss`` of ``m.train_loss`` (under the remat
    policy ``remat``, none by default) on the model's device."""
    fn = m.train_loss if remat is None else trainstep.remat(m.train_loss,
                                                            remat)
    return trainstep.grads_and_loss(fn, model, batch, n_micro,
                                    model.embed.device)


def run_train_unit(args, dev, smi, limit=TRAIN_UNIT_RRMS, hold=None,
                   during=None):
    """Phase 15 (b): one float32 layer at full width on the card and the
    host CPU. Returns the largest relative RMS difference of the loss
    and the gradients (card against CPU, and microbatches against one
    batch on the card), and what ``during`` returned: a function run on
    this thread while the CPU's pass runs on another, with two of the
    host's threads left to it (phase 15 runs (c) there, whose launches
    keep one core busy). ``hold(name, value)`` takes each reading instead
    of the gate (``scripts/lockstep_seeds.py``)."""
    import threading
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "train unit: TF32 is on")
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=1,
                              dtype="float32")
    m = api.build(cfg)
    card = m.init(torch.Generator(device=dev).manual_seed(args.seed + 151),
                  device=dev)
    cpu = transformer.Transformer(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    batch = train_data.make_batch(train_data.DataConfig(
        vocab=cfg.vocab, seed=args.seed + 151, **TRAIN_UNIT), 0,
        device="cpu")
    box = {}

    def cpu_pass():
        try:
            t0 = time.perf_counter()
            box["cpu"] = unit_grads(m, cpu, batch, 1)
            box["secs"] = time.perf_counter() - t0
        except BaseException as exc:      # re-raised on the main thread
            box["error"] = exc
    threads = torch.get_num_threads()
    if during is not None:
        torch.set_num_threads(max(1, threads - 2))
    worker = threading.Thread(target=cpu_pass)
    worker.start()
    worst = {}

    def gate(what, ref, other):
        rr = max(float(train_rrms(a, b)) for a, b in [(other[0], ref[0])]
                 + [(other[1][n], ref[1][n]) for n in ref[1]])
        worst[what] = rr
        if hold is not None:
            hold(what, rr)
        else:
            check(rr <= limit, f"train unit, float32: {what}: relative "
                               f"RMS difference {rr:.3g} > {limit}")
    try:
        on_card = unit_grads(m, card, batch, 1)
        gate("2 microbatches against 1, card", on_card,
             unit_grads(m, card, batch, 2))
        for pol in trainstep.REMAT_POLICIES:
            loss, grads = unit_grads(m, card, batch, 1, pol)
            bad = [n for n, g in grads.items() if not torch.equal(
                g, on_card[1][n])]
            check(torch.equal(loss, on_card[0]) and not bad,
                  f"train unit: remat {pol} differs from no remat on the "
                  f"card (loss {float(loss)} against {float(on_card[0])}; "
                  f"leaves {bad[:4]})")
        out = during() if during is not None else None
    finally:
        worker.join()
        torch.set_num_threads(threads)
    if "error" in box:
        raise box["error"]
    on_cpu = (box["cpu"][0], {n: g.to(dev) for n, g in box["cpu"][1].items()})
    gate("card against the CPU", on_cpu, on_card)
    print(f"train unit ({TRAIN_ARCH}, 1 layer, float32, B "
          f"{TRAIN_UNIT['global_batch']}, S {TRAIN_UNIT['seq_len']}; TF32 "
          f"off): largest relative RMS difference of the loss and the "
          f"{len(on_card[1])} gradient leaves: "
          f"{ {k: float(f'{v:.4g}') for k, v in worst.items()} } (limit "
          f"{limit}); the remat policies {list(trainstep.REMAT_POLICIES)} "
          f"bit-identical to no remat on the card; the CPU's pass "
          f"{box['secs']:.2f} s | {smi}", flush=True)
    del card, cpu, on_card, on_cpu
    torch.cuda.empty_cache()
    return worst, out


def train_example():
    """``examples/train_lm_torch.py`` as a module."""
    import importlib.util
    path = Path(__file__).resolve().parent / "examples" / "train_lm_torch.py"
    spec = importlib.util.spec_from_file_location("train_lm_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_train_recovery(dev, smi):
    """Phase 15 (c): the example's failure and recovery, exact."""
    ex = train_example()
    lines = []
    t0 = time.perf_counter()
    diff, l_fail, l_ref = ex.run(RECOVERY["steps"], RECOVERY["fail_at"],
                                 RECOVERY["preset"], RECOVERY["ckpt_every"],
                                 dev, lines.append)
    secs = time.perf_counter() - t0
    check(diff == 0.0 and l_fail == l_ref,
          f"train recovery: the recovered run differs from the "
          f"uninterrupted one (max |param diff| {diff}, final losses "
          f"{l_fail[-1]} and {l_ref[-1]})")
    recovered = [s for s in lines if "recovered at step" in s]
    check(bool(recovered), "train recovery: no recovery ran")
    rates = [s.strip() for s in lines if "ms/step" in s]
    print(f"train recovery (examples/train_lm_torch.py, preset "
          f"{RECOVERY['preset']}, {RECOVERY['steps']} steps, failure at "
          f"{RECOVERY['fail_at']}, a checkpoint every "
          f"{RECOVERY['ckpt_every']}): {recovered[0].strip()}; max |param "
          f"diff| {diff} (bit-identical), final loss {l_ref[-1]:.4f} "
          f"(first {l_ref[0]:.4f}); both runs {secs:.2f} s; the last "
          f"step counts of A and B: {rates[len(rates) // 2 - 1]}; "
          f"{rates[-1]} | {smi}", flush=True)
    return diff


def run_train_phase(args, dev, smi):
    """Phase 15: training on the card, deterministic algorithms on (and
    no filling of uninitialised memory: the path reads none, and a read
    would show as a difference in (c))."""
    import torch.utils.deterministic as det
    torch.use_deterministic_algorithms(True)
    fill, det.fill_uninitialized_memory = det.fill_uninitialized_memory, \
        False
    prev = perf_policy.current()
    secs = {}
    try:
        t0 = time.perf_counter()
        full = run_train_full_width(args, dev, smi)
        secs["(a)"] = time.perf_counter() - t0
        # (c) on this thread while (b)'s CPU pass runs on another
        t0 = time.perf_counter()
        unit, diff = run_train_unit(args, dev, smi, during=lambda: (
            run_train_recovery(dev, smi)))
        secs["(b) with (c)"] = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
        det.fill_uninitialized_memory = fill
        perf_policy.set_policy(prev)
    print("training phase by part: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in secs.items()) + f" | {smi}")
    return dict(full, unit_rrms=unit, recovery_diff=diff)


# --------------------------- the launch/ analogues (phase 16) ----
LAUNCH_ARCH = "mixtral-8x22b"
LAUNCH_T = 8192                  # (b): tokens of one sharded dispatch
LAUNCH_MESHES = ((4, 1), (2, 2))  # ("data", "model")
LAUNCH_CF = 1.25                 # (b): mixtral's capacity factor
LAUNCH_CF_DROPS = 1.0            # (b): one that drops choices here
LAUNCH_REPS = 5                  # CUDA-event calls timed a dispatch
LAUNCH_PREFILL = dict(n_layers=2, B=8, S=1024)   # (c)
DRYRUN_SWEEP_S = 60.0            # print the full fits table within this


def dryrun_cells():
    """(label, cfg, shape, microbatches) of the cells the card measures:
    phase 15's step, and phase 12's mixtral at its depth over 8 sequences
    of 1,024 tokens (prefill, and a decode step over a 1,024-position
    cache)."""
    granite = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    mixtral = dataclasses.replace(get_arch(LAUNCH_ARCH),
                                  n_layers=dict(SERVE_CONFIGS)[LAUNCH_ARCH])
    return (("phase 15 train step", granite,
             ShapeConfig("phase15", TRAIN_DATA["seq_len"],
                         TRAIN_DATA["global_batch"], "train"), TRAIN_MICRO),
            ("phase 12 prefill", mixtral,
             ShapeConfig("phase12_prefill", 1024, 8, "prefill"), 1),
            ("phase 12 decode step", mixtral,
             ShapeConfig("phase12_decode", 1024, 8, "decode"), 1))


def run_dryrun_part(smi, train):
    """Phase 16 (a): the dry run on this host's CPU, on meta tensors, of
    the cells the card measures (counts on the H100 spec constants, not
    card times), phase 15's measured step as a share of the bf16 peak,
    and ``fits_one_card`` of every architecture × shape."""
    prev = perf_policy.current()
    perf_policy.set_policy("baseline")
    try:
        for label, cfg, shape, n_micro in dryrun_cells():
            rec = launch_dryrun.count_cell(cfg, shape, make_host_mesh(),
                                           n_micro)
            mem, roof = rec["memory"], rec["roofline"]
            parts = {k: round(v / 1e9, 3) for k, v in mem.items()
                     if k not in ("argument_bytes", "fits_one_card")}
            if shape.kind == "train":
                train_rec = rec
            print(f"dry run, {label} ({cfg.name}, {cfg.n_layers} layers, "
                  f"{shape.global_batch} x {shape.seq_len} tokens"
                  + (f", {n_micro} microbatches" if shape.kind == "train"
                     else "") + f"): counted {rec['hlo_flops'] / 1e12:.4f} "
                  f"TFLOP, model {rec['model_flops_total'] / 1e12:.4f} TFLOP "
                  f"(useful share {rec['useful_flops_ratio']:.4f}), unfused "
                  f"bytes {rec['hlo_bytes'] / 1e9:.3f} GB, argument bytes "
                  f"{mem['argument_bytes'] / 1e9:.3f} GB ({parts} GB), "
                  f"fits_one_card {mem['fits_one_card']}; on the H100 spec "
                  f"constants compute {roof['compute_s'] * 1e3:.3f} ms, "
                  f"memory {roof['memory_s'] * 1e3:.3f} ms "
                  f"({roof['dominant']}); counts on meta in "
                  f"{rec['dryrun_s']:.2f} s, not card times | {smi}",
                  flush=True)
    finally:
        perf_policy.set_policy(prev)
    rec = train_rec
    step_s = train["step_ms"] / 1e3
    print(f"phase 15's measured median step {train['step_ms']:.3f} ms "
          f"(this run): counted FLOPs {rec['hlo_flops'] / step_s / 1e12:.1f} "
          f"TFLOP/s = {100 * rec['hlo_flops'] / step_s / BF16_FLOPS:.2f} % "
          f"of the bf16 peak; model FLOPs (6 N T) "
          f"{rec['model_flops_total'] / step_s / 1e12:.1f} TFLOP/s = "
          f"{100 * rec['model_flops_total'] / step_s / BF16_FLOPS:.2f} % "
          f"(mfu) | {smi}", flush=True)
    t0 = time.perf_counter()
    fits = launch_dryrun.fits_table()
    secs = time.perf_counter() - t0
    if secs <= DRYRUN_SWEEP_S:
        print(f"fits_one_card (argument bytes of the whole cell at full "
              f"depth against 80 GB; {secs:.2f} s on meta):")
        for arch in dict.fromkeys(a for a, _ in fits):
            print(f"  {arch}: " + ", ".join(
                f"{s} {'n/a' if fits[arch, s] is None else fits[arch, s]}"
                for s in SHAPES))
    else:
        print(f"fits_one_card sweep took {secs:.2f} s > {DRYRUN_SWEEP_S} "
              f"s: the table is in PERF.md (the CLI's)")


def launch_moe(p, x, mesh_shape, cf, kernels=True):
    """``moe.apply_moe`` under the opt policy (set by the caller) and the
    shape-only mesh ``mesh_shape`` (None: no mesh, the global
    dispatch)."""
    ctx = Mesh(("data", "model"), mesh_shape) if mesh_shape \
        else contextlib.nullcontext()
    with ctx:
        return moe_mod.apply_moe(p, x, top_k=2, capacity_factor=cf,
                                 kernels=kernels)


def counted(fn):
    """``(fn(), moe_gmm launches it made)``."""
    n = moe_ops.moe_gmm.launches
    out = fn()
    torch.cuda.synchronize()
    return out, moe_ops.moe_gmm.launches - n


@torch.no_grad()
def run_sharded_moe_part(p, x, smi, phase8):
    """Phase 16 (b): the sharded dispatch at mixtral width, T tokens,
    under the opt policy: dropless, bit for bit against the global kernel
    path on a (4, 1) mesh; at ``LAUNCH_CF`` and ``LAUNCH_CF_DROPS``
    against its plain path on every mesh; one ``moe_gmm`` launch a model
    slice a call; the dispatches timed with CUDA events. Returns the
    kernel record's additions."""
    E = p.router.shape[1]
    dropless = E / 2
    (yg, sg), ng = counted(lambda: launch_moe(p, x, None, dropless))
    check(ng == 1, f"global dispatch: {ng} moe_gmm launches")
    for shape in LAUNCH_MESHES:
        (ys, ss), ns = counted(lambda: launch_moe(p, x, shape, dropless))
        check(ns == shape[1], f"sharded dispatch {shape}: {ns} moe_gmm "
                              f"launches, expected {shape[1]}")
        same(ss.load, sg.load, f"sharded dispatch {shape}: load")
        check(float(ss.dropped_fraction) == float(sg.dropped_fraction) == 0,
              f"sharded dispatch {shape}: drops at a dropless capacity")
        if shape[1] == 1:
            check(torch.equal(ys, yg), f"sharded dispatch {shape}: y is not "
                                       f"bit-identical to the global one")
            note = "bit-identical to the global kernel path"
        else:
            tol = tolerance.LM_TOL["bfloat16"]
            err, rel, ok = held_to(ys, yg, tol, tol)
            check(ok, f"sharded dispatch {shape}: y max abs {err} from the "
                      f"global kernel path")
            note = (f"max abs {err:.4g} from the global kernel path (the "
                    f"{shape[1]} F-slices' bf16 partials are summed, as the "
                    f"reference's psum_scatter sums them: not bit-exact)")
        print(f"sharded moe {LAUNCH_ARCH} T={x.shape[0]}, mesh {shape}, "
              f"dropless (cf {dropless}): {ns} moe_gmm launch(es), load "
              f"equal, {note} | {smi}", flush=True)
        del ys
    del yg
    torch.cuda.empty_cache()
    res = {}
    for shape in LAUNCH_MESHES:
        for cf in (LAUNCH_CF, LAUNCH_CF_DROPS):
            (yk, sk), nk = counted(lambda: launch_moe(p, x, shape, cf))
            (yp, sp), npl = counted(lambda: launch_moe(p, x, shape, cf,
                                                       kernels=False))
            what = f"sharded dispatch {shape}, cf {cf}"
            check((nk, npl) == (shape[1], 0), f"{what}: launches {nk}, "
                                              f"plain {npl}")
            same(sk.load, sp.load, f"{what}: load")
            drop = float(sk.dropped_fraction)
            check(drop == float(sp.dropped_fraction), f"{what}: dropped "
                  f"{drop} against plain {float(sp.dropped_fraction)}")
            check(drop > 0 or cf != LAUNCH_CF_DROPS, f"{what}: no choice "
                                                     f"dropped")
            tol = tolerance.LM_TOL["bfloat16"]
            err, rel, ok = held_to(yk, yp, tol, tol)
            check(ok, f"{what}: y max abs {err} from its plain path")
            res[shape, cf] = dict(max_abs_err=err, dropped_fraction=drop)
            print(f"sharded moe {LAUNCH_ARCH}, mesh {shape}, cf {cf}: "
                  f"{nk} moe_gmm launch(es), dropped {drop:.6f}, load and "
                  f"drops equal to the plain path's, y max abs {err:.4g} "
                  f"(rel {rel:.4g}, tolerance {tol}) | {smi}", flush=True)
            del yk, yp
    torch.cuda.empty_cache()
    times = {}
    for label, shape, kern in (("global", None, True),
                               ("sharded (4, 1)", (4, 1), True),
                               ("sharded (2, 2)", (2, 2), True),
                               ("sharded (4, 1) plain", (4, 1), False)):
        times[label] = time_events(
            lambda: launch_moe(p, x, shape, LAUNCH_CF, kern), LAUNCH_REPS)
    # the (4, 1) mesh's grouped FFN alone: its moe_gmm launch over every
    # shard's buckets, beside its bound, its plain version and phase 8's
    with ModelShadow() as shadow:
        shadow.step("k")
        launch_moe(p, x, (4, 1), LAUNCH_CF)
        shadow.tag = None
    args, kw, _ = shadow.calls["moe_gmm"][0]
    rows, (wg, wi, wo) = args[0], args[1:4]
    Er, R, D = rows.shape
    flops = 2.0 * Er * R * D * wi.shape[2] * 3
    b_ms, b_by = serve_bound(2 * _nbytes(rows) + _nbytes(wg, wi, wo),
                             flops / BF16_FLOPS)
    k_ms = time_events(lambda: moe_ops.moe_gmm(*args, **kw), LAUNCH_REPS)
    p_ms = time_events(lambda: moe_ref.moe_gmm_ref(*args, **kw), 2)
    del shadow
    print(f"sharded moe {LAUNCH_ARCH}, cf {LAUNCH_CF}: dispatch ms a call "
          f"(CUDA events, {LAUNCH_REPS} calls) "
          + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
          + f"; its moe_gmm launch over [E, |dp|·C_l, D] = "
          f"{list(rows.shape)}: {k_ms:.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by}), {100 * b_ms / k_ms:.1f} % of it, plain {p_ms:.4f} "
          f"ms; phase 8 {phase8['case']}: {phase8['ms']:.4f} ms | {smi}",
          flush=True)
    return dict(ms=k_ms, bound_ms=b_ms, plain_ms=p_ms, bound_by=b_by,
                rows=list(rows.shape), dispatch_ms=times,
                capacity_factor=LAUNCH_CF,
                max_abs_err=max(r["max_abs_err"] for r in res.values()),
                against_plain={f"mesh {m} cf {cf}": r
                               for (m, cf), r in res.items()})


@torch.no_grad()
def run_sharded_prefill_part(cfg, model, smi):
    """Phase 16 (c): ``Model.prefill`` under the opt policy and a (4, 1)
    mesh, the kernel path against the plain path on the kernel path's
    expert choices (phase 12's rule: K/V and the last position's logits
    within ``SERVE_RRMS``, the first layer's K/V bit for bit, every
    kernel call against its plain version). Returns the launches."""
    m = api.build(cfg)
    L = cfg.n_layers
    gen = torch.Generator(device=model.embed.device).manual_seed(16)
    tokens = torch.randint(0, cfg.vocab, (LAUNCH_PREFILL["B"],
                                          LAUNCH_PREFILL["S"]),
                           generator=gen, device=model.embed.device,
                           dtype=torch.int32)
    res = dict(rrms=0.0, rrms_at="", rows=0, calls={}, states={}, held={})
    sharded = moe_mod.apply_moe_sharded
    routed = []
    moe_mod.apply_moe_sharded = lambda *a, **kw: routed.append(1) \
        or sharded(*a, **kw)
    reset_launch_counts()
    try:
        with ModelShadow() as shadow, \
                Mesh(("data", "model"), LAUNCH_MESHES[0]):
            shadow.step("k")
            hk, ck = m.prefill(model, {"tokens": tokens},
                               LAUNCH_PREFILL["S"])
            launches = lm_launches()
            shadow.step("p")
            hp, cp = m.prefill(model, {"tokens": tokens},
                               LAUNCH_PREFILL["S"], kernels=False)
            shadow.tag = None
    finally:
        moe_mod.apply_moe_sharded = sharded
    what = f"{cfg.name} prefill under opt, mesh {LAUNCH_MESHES[0]}"
    want = {"flash_attention": L, "moe_gmm": moe_layers(cfg),
            "mamba_scan": 0}
    check(launches == want, f"{what}: launches {launches}, expected {want}")
    check(lm_launches() == want, f"{what}: the plain path launched")
    check(len(routed) == 2 * moe_layers(cfg), f"{what}: the sharded "
          f"dispatch ran {len(routed)} times, not once a MoE layer a path")
    check_serve_calls(shadow, res, what)
    same(ck.kv_len, cp.kv_len, f"{what}: kv_len")
    check_model_states(cfg, ck, cp, res, what, {"attn": SERVE_RRMS["kv"]})
    lk, lp = (transformer.lm_head(h, model.embed, cfg.logit_softcap)
              for h in (hk, hp))
    rrms_gate(lk, lp, list(range(lk.shape[0])), res, what,
              SERVE_RRMS["logits"])
    print(f"{what}: {LAUNCH_PREFILL['B']} prompts of {LAUNCH_PREFILL['S']} "
          f"tokens, {L} of {get_arch(cfg.name).n_layers} layers; launches "
          f"{launches}; the plain path on the kernel path's expert "
          f"choices: K/V relative RMS {res['states']} (limit "
          f"{SERVE_RRMS['kv']}, the first layer's bit-identical), logits "
          f"{res['rrms']:.4g} (limit {SERVE_RRMS['logits']}); kernel calls "
          f"against their plain versions: {res['calls']} | {smi}",
          flush=True)
    return launches


def run_launch_phase(args, dev, smi, train, phase8_moe):
    """Phase 16: the dry run (a), the sharded MoE dispatch at mixtral
    width (b) and a mixtral prefill that reaches it (c). Returns the
    ``moe_gmm`` record's additions."""
    t0 = time.perf_counter()
    run_dryrun_part(smi, train)
    secs = {"(a)": time.perf_counter() - t0}
    prev = perf_policy.current()
    perf_policy.set_policy("opt")
    try:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_arch(LAUNCH_ARCH),
                                  n_layers=LAUNCH_PREFILL["n_layers"])
        model = transformer.init_params(
            cfg, torch.Generator(device=dev).manual_seed(args.seed + 16), dev)
        gen = torch.Generator(device=dev).manual_seed(args.seed + 160)
        x = torch.randn(LAUNCH_T, cfg.d_model, generator=gen, device=dev) \
            .bfloat16()
        sharded = run_sharded_moe_part(model.layers[0].moe, x, smi,
                                       phase8_moe)
        del x
        secs["(b)"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        launches = run_sharded_prefill_part(cfg, model, smi)
        secs["(c)"] = time.perf_counter() - t0
    finally:
        perf_policy.set_policy(prev)
    del model
    torch.cuda.empty_cache()
    print("launch phase by part: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in secs.items()) + f" | {smi}")
    return dict(sharded, sharded_prefill_launches=launches["moe_gmm"])


# ------------------------------- the protocol analyzer (phase 17) ----
def run_k3_part(smi):
    """Phase 17 (a): K3 on the built functions, at every block shape the
    wrappers launched in this process (phases 3-16 and (c))."""
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    points = kernel_audit.launched(COUNTERS)
    unseen = set(_build.KERNELS) - {p.library for p in points}
    check(not unseen, f"K3 on the card: no launch recorded of {unseen}")
    findings, rows = kernel_audit.card_k3(optin, points)
    print(f"K3: shared_memory_per_block_optin {optin} B, _cuda.MAX_SMEM "
          f"{_cuda.MAX_SMEM} B, {kernel_audit.REGS_PER_SM} "
          f"registers an SM | {smi}")
    for r in rows:
        p = r.spec
        print(f"  {p.library}: {p.function} [{p.label}]: shared "
              f"{r.static_smem} static + {p.smem} dynamic = {r.smem} B "
              f"(margin {optin - r.smem} B, "
              f"{100 * (optin - r.smem) / optin:.1f} %); {r.registers} registers × {p.threads} threads = "
              f"{r.registers_a_block} (margin "
              f"{kernel_audit.REGS_PER_SM - r.registers_a_block})")
    check(not findings, "K3 on the card: "
          + "; ".join(f.render() for f in findings))


def run_graph_part(args, dev, smi):
    """Phase 17 (b): A1-A4 over the entry points and a new-order
    sub-round at phase 2's scale, on CUDA tensors."""
    t0 = time.perf_counter()
    findings, reports = graph_audit.audit_tree(dev)
    for r in reports:
        print(f"  graph audit {r.name}: {r.status} {r.detail} {r.n_ops} ops, "
              f"{r.n_findings} active findings, tags "
              f"{ {k: v['from'] for k, v in r.tags.items()} }")
        check(r.status == "ok", f"graph audit: {r.name} failed: {r.detail}")
    t_entry = time.perf_counter() - t0
    cfg = dataclasses.replace(SLICE, fused_commit=False, batched_probe=False)
    oracle = VectorOracle(cfg.n_threads)
    t0 = time.perf_counter()
    lay, st = tpcc.init_tpcc(
        cfg, oracle, torch.Generator(device=dev).manual_seed(args.seed + 17),
        device=dev)
    inp = workload.neworder_stream(
        cfg, torch.Generator(device=dev).manual_seed(args.seed + 170))(0)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    tbl = st.nam.table
    out = {}

    def sub_round():
        out["round"] = tpcc.neworder_round(cfg, lay, st, oracle, inp)

    t0 = time.perf_counter()
    fs, rep = graph_audit.audit_callable(
        sub_round, name="tpcc.neworder_round", expects_locks=True,
        sources=(st.nam.oracle_state.vec, tbl.cur_hdr, tbl.old_hdr,
                 tbl.ovf_hdr))
    torch.cuda.synchronize()
    t_round = time.perf_counter() - t0
    findings += fs
    committed = int(out["round"].committed.sum())
    print(f"  graph audit tpcc.neworder_round ({cfg.n_warehouses} "
          f"warehouses, {cfg.n_threads} threads, unfused): {rep.n_ops} ops, {rep.n_findings} active findings, "
          f"tags { {k: v['from'] for k, v in rep.tags.items()} }; "
          f"{committed} of {cfg.n_threads} committed")
    for f in findings:
        print(f"  {f.render()}")
    active = [f for f in findings if not f.suppressed]
    check(not active, "graph audit: active findings: "
          + "; ".join(f.render() for f in active))
    print(f"graph audit: entry points {t_entry:.2f} s, load {t_load:.2f} s, "
          f"the sub-round under the audit {t_round:.2f} s | {smi}")
    del st, lay, tbl, out
    torch.cuda.empty_cache()


def run_sanitize_part(smi):
    """Phase 17 (c): the kernels' run checks."""
    t0 = time.perf_counter()
    findings, results = sanitize.run_all()
    for r in results:
        print(f"  run check {r.kernel}: {r.launches} launches, margins "
              f"{'intact' if r.margins_intact else 'OVERWRITTEN'}, poisons "
              f"{'agree' if r.poisons_agree else 'DIFFER'}, repeats "
              f"{'agree' if r.repeats_agree else 'DIFFER'}, plain "
              f"{r.plain or 'held'}")
    check(not findings, "kernel run checks: "
          + "; ".join(f.render() for f in findings))
    print(f"kernel run checks: {len(results)} kernels, "
          f"{time.perf_counter() - t0:.2f} s | {smi}")


def run_analysis_phase(args, dev, smi):
    """Phase 17: the analyzer's card-only parts; (c) first, so that (a)
    also sees the run checks' launches (and has some when the phase runs
    alone)."""
    run_sanitize_part(smi)
    run_graph_part(args, dev, smi)
    run_k3_part(smi)


# -------------------------------------------------------------- main ----
def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=32,
                    help="new-order rounds of phase 4")
    ap.add_argument("--mix-rounds", type=int, default=32,
                    help="full-mix rounds of phase 5")
    ap.add_argument("--probe-rounds", type=int, default=8,
                    help="full-mix rounds of the hash_probe path (phase 6)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile-rounds", type=int, default=4)
    ap.add_argument("--durable-rounds", type=int, default=8,
                    help="journalled, checkpointed, GC-on mix rounds of "
                         "phase 9 (killed at round (n // 2) | 1)")
    ap.add_argument("--shards", type=int, default=4,
                    help="memory servers of phase 10 (50 warehouses and "
                         "60 threads each)")
    ap.add_argument("--shard-rounds", type=int, default=8,
                    help="full-mix rounds of phase 10 over the servers")
    ap.add_argument("--oracle-rounds", type=int, default=32,
                    help="full-mix rounds of phase 11 (a) under each "
                         "timestamp oracle")
    ap.add_argument("--lm-reps", type=int, default=20,
                    help="launches timed per LM case of phase 8 (half for "
                         "attention prefill, a quarter for the expert FFN)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"card: {smi} | {kind} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs)}")
    check(sorted(logs) == sorted(KERNEL_SOURCES),
          f"built {sorted(logs)}, expected {sorted(KERNEL_SOURCES)}")
    for name, log in logs.items():
        for fn, regs, spill in ptxas_functions(log):
            print(f"  {name}: {fn}: {regs} registers, spill stores/loads "
                  f"{spill} bytes")
    for name in TC_KERNELS:
        counts = sass_mma_counts(name)
        for fn, n in counts.items():
            print(f"  {name}: {fn}: {n} tensor-core MMA instructions (SASS)")
        tc = {fn: n for fn, n in counts.items() if "_tc_" in fn}
        check(tc and all(tc.values()), f"{name}: a bf16 route function has "
                                       f"no tensor-core MMA: {counts}")

    # ---- 2. load ----------------------------------------------------------
    cfg = SLICE
    plain_cfg = dataclasses.replace(cfg, fused_commit=False,
                                    batched_probe=False)
    oracle = VectorOracle(cfg.n_threads)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lay, st = tpcc.init_tpcc(
        cfg, oracle, torch.Generator(device=dev).manual_seed(args.seed),
        device=dev)
    torch.cuda.synchronize()
    R = lay.catalog.total_records
    pool_bytes = sum(t.numel() * t.element_size() for t in st.nam.table)
    print(f"load: {time.perf_counter() - t0:.2f} s, R={R} records, "
          f"pool {pool_bytes / 1e9:.3f} GB, directory "
          f"{st.directory.n_buckets} buckets, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB", flush=True)
    st_mix = clone(st)              # the mix starts from the loaded state
    st_load = clone(st)             # and so do phase 11's runs

    def stream(seed):
        return workload.neworder_stream(
            cfg, torch.Generator(device=dev).manual_seed(seed))

    def mix_stream(seed):
        return workload.mixed_stream(
            cfg, torch.Generator(device=dev).manual_seed(seed))

    # ---- 3. kernels against their plain versions ---------------------------
    (p_args, p_kw), (c_args, c_kw) = capture_round(
        cfg, lay, clone(st), oracle, stream(args.seed + 100), 4)
    report = {}
    for label, pa in (("real", p_args), ("adversarial",
                                         adversarial_probe(p_args))):
        ker = probe_ops.batched_probe(*pa, **p_kw)
        plain = probe_ref.batched_probe_ref(*pa, **p_kw)
        torch.cuda.synchronize()
        err = same(ker, plain, f"batched_probe ({label})")
        print(f"batched_probe {label}: Q={pa[4].shape[0]} found "
              f"{int(ker[1].sum())} src0/1/2 "
              f"{[int((ker[2] == s).sum()) for s in range(3)]} slot<0 "
              f"{int((ker[0] < 0).sum())}: bit-identical")
        report["batched_probe"] = max(report.get("batched_probe", 0), err)
    for label, ca in (("real", c_args), ("adversarial",
                                         adversarial_commit(c_args))):
        ker = commit_without_sync(clone(ca))
        plain = commit_ref.fused_commit_ref(*clone(ca))
        torch.cuda.synchronize()
        err = same(flat_commit(ker), flat_commit(plain),
                   f"fused_commit ({label})")
        lat = commit_lattice(ca, ker)
        print(f"fused_commit {label}: Q={ca[2].shape[0]} active "
              f"{int(ca[5].sum())} {lat}: bit-identical, no host sync")
        if label == "adversarial":
            check(all(lat.values()), f"adversarial commit case does not "
                                     f"reach every outcome: {lat}")
            WS = ca[2].shape[0] // ca[9].shape[0]
            f1 = [(slot, bool(ker.granted[lane]), bool(ker.do_install[lane]))
                  for lane, slot, _ in f1_lanes(WS, ca[0].n_records)]
            print(f"fused_commit F1 lanes (slot, granted, do_install): {f1}")
            check(f1[1][1], "the out-of-range lane of the winning priority "
                            "was not granted")
        report["fused_commit"] = max(report.get("fused_commit", 0), err)

    # ---- 4. new-order path: kernels vs the plain path -----------------------
    st_plain = clone(st)
    reset_launch_counts()
    st_k, stats_k, rounds_k = timed_run(tpcc.run_neworder_rounds, cfg, lay,
                                        st, oracle, stream(args.seed + 1),
                                        args.rounds)
    no_launches = launch_counts()
    st_p, stats_p, rounds_p = timed_run(tpcc.run_neworder_rounds, plain_cfg,
                                        lay, st_plain, oracle,
                                        stream(args.seed + 1), args.rounds)
    check(no_launches["batched_probe"] > 0 and no_launches["fused_commit"] > 0,
          f"a kernel did not launch on the new-order path: {no_launches}")
    check(stats_k.commits > 0, "no transaction committed")
    same(stats_k.committed, stats_p.committed, "per-round commits")
    same(stats_k.missed, stats_p.missed, "per-round snapshot misses")
    same(st_k, st_p, "new-order final state")
    check(tuple(stats_k.ops) == tuple(stats_p.ops)
          and stats_k[1:5] == stats_p[1:5], "run statistics differ")
    del st_plain, st_p
    print(f"new-order path: {args.rounds} rounds, launches {no_launches}, "
          f"commits {stats_k.commits}/{stats_k.attempts} (abort rate "
          f"{stats_k.abort_rate:.4f}, snapshot misses "
          f"{stats_k.snapshot_misses}); kernels and plain path identical")
    for label, rounds, stats in (("new-order, kernels", rounds_k, stats_k),
                                 ("new-order, plain", rounds_p, stats_p)):
        print_round_times(label, rounds, stats.commits, "new-orders")

    # ---- 5. mix path: kernels vs the plain path ------------------------------
    st_mix_plain = clone(st_mix)
    reset_launch_counts()
    with SubRounds() as sub_k:
        st_mk, mstats_k, mrounds_k = timed_run(
            tpcc.run_mixed_rounds, cfg, lay, st_mix, oracle,
            mix_stream(args.seed + 3), args.mix_rounds)
    mix_launches = launch_counts()
    with SubRounds() as sub_p:
        st_mp, mstats_p, mrounds_p = timed_run(
            tpcc.run_mixed_rounds, plain_cfg, lay, st_mix_plain, oracle,
            mix_stream(args.seed + 3), args.mix_rounds)
    check(mix_launches["batched_probe"] > 0 and mix_launches["fused_commit"]
          > 0, f"a kernel did not launch on the mix path: {mix_launches}")
    same_logs(sub_k.log, sub_p.log, "mix, kernels against plain")
    same(st_mk, st_mp, "mix final state")
    for f in mstats_k._fields:
        a, b = getattr(mstats_k, f), getattr(mstats_p, f)
        check(a == b or (a != a and b != b), f"mix statistic {f} differs")
    del st_mix_plain, st_mp
    names = workload.TXN_TYPES
    check(all(mstats_k.attempts[n] > 0 for n in names),
          f"a transaction type never ran: {mstats_k.attempts}")
    check(mstats_k.delivered > 0, "no delivery delivered an order")
    check(any(bool(o[1].any()) for n, o, _ in sub_k.log
              if n == "orderstatus_round"),
          "no order-status found an order")
    for n in ("payment_round", "delivery_round"):
        per_call = sub_k.launches(n)
        check(bool(per_call) and all(
            d["batched_probe"] == 1 and d["fused_commit"] == 1
            for d in per_call),
            f"{n}: the kernels did not launch once in every sub-round: "
            f"{per_call}")
    sub_launches = {n[:-len("_round")]: {
        k: sum(d[k] for d in sub_k.launches(n))
        for k in ("batched_probe", "fused_commit")} for n in OUTCOMES}
    wall_m = sum(mrounds_k)
    print(f"mix path: {args.mix_rounds} rounds, launches {mix_launches} "
          f"(by sub-round {sub_launches}); kernels and plain path "
          f"identical in {len(sub_k.log)} sub-rounds")
    print(f"mix: attempts {mstats_k.attempts}, commits {mstats_k.commits}, "
          f"retries {mstats_k.retries}, snapshot misses "
          f"{mstats_k.snapshot_misses}, contention aborts "
          f"{mstats_k.contention_aborts}, delivered {mstats_k.delivered}, "
          f"abort rate {mstats_k.abort_rate:.4f}, new-order share "
          f"{tpcc.neworder_share(mstats_k):.4f}")
    for label, rounds, stats in (("mix, kernels", mrounds_k, mstats_k),
                                 ("mix, plain", mrounds_p, mstats_p)):
        print_round_times(label, rounds, stats.total_commits,
                          "transactions")
    print(f"mix, kernels: {mstats_k.commits['neworder'] / wall_m:.1f} "
          f"committed new-orders/s, "
          + ", ".join(f"{n} {mstats_k.commits[n] / wall_m:.1f}/s"
                      for n in names[1:]))

    # ---- 6. hash_probe path: the mix's read-only keys ----------------------
    reset_launch_counts()
    with ProbeShadow() as shadow:
        st_pr, _ = tpcc.run_mixed_rounds(cfg, lay, st_mk, oracle,
                                         mix_stream(args.seed + 4),
                                         args.probe_rounds, device="cuda")
    torch.cuda.synchronize()
    probe_launches = launch_counts()
    check(probe_launches["hash_probe"] > 0,
          f"hash_probe did not launch on its path: {probe_launches}")
    check(probe_launches["hash_probe"] == shadow.calls,
          f"hash_probe launched {probe_launches['hash_probe']} times for "
          f"{shadow.calls} reads with keyed lanes")
    check(shadow.found > 0, "no read-only key found a version")
    print(f"hash_probe path: {args.probe_rounds} mix rounds, "
          f"{probe_launches['hash_probe']} launches over {shadow.lanes} keys "
          f"{shadow.kinds}: found {shadow.found}, missing keys "
          f"{shadow.missing}, src0/1/2 {shadow.src}; (a) bit-identical to "
          f"the plain version, gathered versions equal the rounds' reads")
    report["hash_probe"] = shadow.err
    d = st_pr.directory
    q_a, vec_a = shadow.largest
    a_args = (d.keys, d.vals, st_pr.nam.table, vec_a, q_a)
    a_kw = dict(max_probes=tpcc.DIR_PROBES)
    b_args, b_kw = probe_bench_case(dev)
    # (c) over every key of the path and the rewritten records, on the
    # final state, and over the rewritten records with the newest write of
    # one hidden
    tw_keys, tw_vec = rewritten_records(
        st_pr.nam.table, d.keys, d.vals, oracle.read(st_pr.nam.oracle_state))
    every = (d.keys, d.vals, st_pr.nam.table, shadow.last_vec,
             torch.cat(shadow.queries + [tw_keys]))
    cases = [("b: probe bench point", b_args, b_kw)] + [
        (f"c: adversarial, {name}", adversarial_hash_probe(every, older),
         a_kw) for name, older in OLDER_SNAPSHOTS.items()] + [
        ("c: adversarial, rewritten records, newest write of one hidden",
         (d.keys, d.vals, st_pr.nam.table, tw_vec, every[4]), a_kw)]
    src_c = [0, 0, 0]
    for label, pa, kw in cases:
        ker = probe_ops.hash_probe(*pa, **kw)
        plain = probe_ref.hash_probe_ref(*pa, **kw)
        torch.cuda.synchronize()
        report["hash_probe"] = max(report["hash_probe"],
                                   same(ker, plain, f"hash_probe ({label})"))
        check_gather(pa, kw, ker, f"hash_probe ({label})")
        if label.startswith("c"):
            for i in range(3):
                src_c[i] += int((ker[1] & (ker[2] == i)).sum())
        print(f"hash_probe ({label}): {probe_summary(ker)}: bit-identical, "
              f"gathered versions equal lookup + read_visible")
    check(src_c[1] > 0 and src_c[2] > 0, f"the adversarial snapshots did "
          f"not serve reads from both rings: found src0/1/2 {src_c}")

    # ---- 7. timings ---------------------------------------------------------
    timed = time_kernels(p_args, p_kw, c_args)
    floors = time_launch_floor()
    print("launch floor (CUDA events, GPU held while queued): " + ", ".join(
        f"{k} {v * 1e3:.2f} us" for k, v in floors.items()))
    kernels = [kernel_record(
        n, mix_launches[n], {"neworder": no_launches[n],
                             "mix": mix_launches[n]}, report[n], timed[n],
        " (one new-order round's inputs)")
        for n in ("batched_probe", "fused_commit")]
    for k in kernels:
        k["launch_floor_ms"] = floors
    kernels.append(kernel_record(
        "hash_probe", probe_launches["hash_probe"],
        {"mix_readonly_keys": probe_launches["hash_probe"]},
        report["hash_probe"], time_hash_probe(a_args, a_kw),
        f" (the widest read-only launch, Q={q_a.shape[0]})"))
    bench = kernel_record("hash_probe", 0, {}, report["hash_probe"],
                          time_hash_probe(b_args, b_kw),
                          f" (probe bench point, Q={b_args[4].shape[0]})")
    kernels[-1]["bench_point"] = {k: bench[k] for k in (
        "ms", "host_ms", "plain_ms", "bound_ms", "bound_by", "bytes",
        "random_sectors", "sector_bound_ms")}

    # ---- breakdown of a few more rounds (device time by kernel) -------------
    if args.profile_rounds:
        per_round = {}
        for path, driver, st_, draw in (
                ("new-order", tpcc.run_neworder_rounds, st_k,
                 stream(args.seed + 2)),
                ("mix", tpcc.run_mixed_rounds, st_pr,
                 mix_stream(args.seed + 5))):
            per_round[path] = print_profile(
                path, args.profile_rounds, *profile_rounds(
                    driver, cfg, lay, st_, oracle, draw,
                    args.profile_rounds))
        no_cuda = per_round["new-order"][0]
        check(no_cuda["fused_commit_kernel"] == 1.0
              and no_cuda["batched_probe_kernel"] == 1.0,
              f"a new-order round did not launch each kernel once: "
              f"{no_cuda}")
        for k in kernels[:2]:
            k["per_round"] = {p: dict(cuda_launches=l, host_syncs=h)
                              for p, (l, h) in per_round.items()}

    # ---- 8. the LM kernels on their entry points -----------------------------
    t0 = time.perf_counter()
    kernels.extend(run_lm_phase(dev, args.seed + 8, args.lm_reps))
    print(f"LM phase: {time.perf_counter() - t0:.2f} s")

    # ---- 9. the durability path: GC, the journal, checkpoints, recovery ----
    t0 = time.perf_counter()
    del st_k, st_mk
    durable_draw = mix_stream(args.seed + 9)
    draws = [durable_draw(r) for r in range(args.durable_rounds)]
    durable_launches, err, drounds, dcommits = run_durable_phase(
        cfg, plain_cfg, lay, st_pr, oracle, draws, smi)
    report["hash_probe"] = max(report["hash_probe"], err)
    for k in kernels:
        if k["name"] == "hash_probe":
            k["max_abs_err"] = report["hash_probe"]
            k["match"] = report["hash_probe"] == 0
        if k["name"] in ("batched_probe", "fused_commit"):
            k["launches_by_path"]["durable_mix"] = durable_launches[k["name"]]
    # a round's time holds its GC sweep and checkpoint, when it has them
    every = DURABLE_GC["gc_interval"]
    for label, pick in (("journal only", lambda r: (r + 1) % every),
                        ("with a GC sweep and a checkpoint",
                         lambda r: not (r + 1) % every)):
        q = [t * 1e3 for r, t in enumerate(drounds) if r and pick(r)]
        if q:
            print(f"round time, durable mix, kernels, {label}: median "
                  f"{torch.tensor(q, dtype=torch.float64).median():.3f} ms "
                  f"over {len(q)} rounds (host clock; the first round left "
                  f"out) | {smi}")
    print(f"durable mix, kernels: {dcommits / sum(drounds):.1f} committed "
          f"transactions/s over its {len(drounds)} rounds")
    print_round_times("mix (phase 5), kernels", mrounds_k,
                      mstats_k.total_commits, "transactions")
    print(f"durable phase: {time.perf_counter() - t0:.2f} s | {smi}")

    # ---- 10. the sharded store: memory servers on a leading shard axis ----
    del st, st_mix, st_pr, p_args, c_args
    torch.cuda.empty_cache()
    shard, shard_launches, st_shard = run_shard_phase(args, dev, smi)
    for key, base, label, n_l in (
            ("batched_probe", "batched_probe", "locate-only",
             shard_launches["batched_probe"]),
            ("decide", "fused_commit", "decide",
             shard_launches["fused_commit_decide"]),
            ("apply", "fused_commit", "apply",
             shard_launches["fused_commit"]
             - shard_launches["fused_commit_decide"])):
        err, timing, extra = shard[key]
        rec = kernel_record(base, n_l, {"sharded_mix": n_l}, err, timing,
                            f" (mesh, {label}, mean over the "
                            f"{args.shards} servers)")
        rec["name"] = f"{base} (mesh, {label})"
        rec.update(extra)
        kernels.append(rec)

    # ---- 11. the timestamp oracles ------------------------------------
    t0 = time.perf_counter()
    paths = run_oracle_mix(args, dev, smi, cfg, plain_cfg, lay, st_load)
    paths.update(run_oracle_shards(args, dev, smi, st_shard))
    del st_shard
    paths.update(run_si_rounds(args, dev, smi, cfg.n_threads,
                               st_load.nam.table))
    for k in kernels:
        if k["name"] in ("batched_probe", "fused_commit"):
            k["launches_by_path"].update(
                {p: n[k["name"]] for p, n in paths.items()})
    print(f"oracle phase: {time.perf_counter() - t0:.2f} s | {smi}")

    # ---- 12. the serve path ---------------------------------------------
    t0 = time.perf_counter()
    del st_load
    torch.cuda.empty_cache()
    lm = [k for k in kernels if k["name"] in LM_PLAIN]
    serve = run_serve_phase(args, dev, smi, lm)
    for k in lm:
        if k["name"] not in serve:
            continue
        by_cfg = serve[k["name"]]
        k["launches_by_path"] = {
            "ops_entry": k["launches"],
            "serve": sum(r["launches"] for r in by_cfg.values())}
        k["serve"] = by_cfg
    print(f"serve phase: {time.perf_counter() - t0:.2f} s | {smi}")

    # ---- 13. the recurrent and hybrid models ------------------------------
    t0 = time.perf_counter()
    jamba, xlstm = run_recurrent_phase(args, dev, smi, lm)
    for k in kernels:
        rec = jamba.get(k["name"])
        if rec is None:
            continue
        by_path = k.setdefault("launches_by_path",
                               {"ops_entry": k["launches"]})
        by_path["serve"] = by_path.get("serve", 0) + rec["launches"]
        k.setdefault("serve", {})["jamba-v0.1-52b"] = rec
    print(f"recurrent phase: {time.perf_counter() - t0:.2f} s | {smi}")

    # ---- 14. the encoder-decoder and prefix-LM models ---------------------
    t0 = time.perf_counter()
    encdec = run_encdec_phase(args, dev, smi, lm)
    for k in kernels:
        if k["name"] != "flash_attention":
            continue
        for arch, rec in encdec.items():
            k["launches_by_path"]["serve"] += rec["launches"]
            k["serve"][arch] = rec
    print(f"encoder-decoder phase: {time.perf_counter() - t0:.2f} s | {smi}")

    # ---- 15. training ----------------------------------------------------
    t0 = time.perf_counter()
    del encdec
    torch.cuda.empty_cache()
    train = run_train_phase(args, dev, smi)
    print(f"training phase: {time.perf_counter() - t0:.2f} s | {smi}")

    # ---- 16. the launch/ analogues: the dry run, the sharded dispatch ----
    t0 = time.perf_counter()
    moe_rec = next(k for k in kernels if k["name"] == "moe_gmm")
    phase8_moe = {"case": moe_rec["case"], "ms": moe_rec["ms"]}
    launch = run_launch_phase(args, dev, smi, train, phase8_moe)
    moe_rec["launches_by_path"]["sharded_prefill"] = \
        launch.pop("sharded_prefill_launches")
    moe_rec["sharded_dispatch"] = launch
    print(f"launch phase: {time.perf_counter() - t0:.2f} s | {smi}")

    # ---- 17. the protocol analyzer's card-only parts ----------------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    run_analysis_phase(args, dev, smi)
    print(f"analysis phase: {time.perf_counter() - t0:.2f} s | {smi}")

    print(f"max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.3f}"
          f" GB; {time.perf_counter() - t_start:.2f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)

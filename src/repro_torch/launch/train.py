"""One-card training launcher (``repro/launch/train.py``).

Builds the model, runs the microbatched, rematerialised train step under
the chosen PerfPolicy, journals the data order (each step's number,
written before the step runs) and writes async checkpoints in the
reference's tree (``train/checkpoint.py``); ``--resume`` restores the
last checkpoint and replays the journal's tail from its step, which
``make_batch`` regenerates exactly, then trains on to ``--steps``.

The reference's ``--mesh`` (host, pod or multipod) builds a GSPMD device
mesh and shards the parameters and moments over it; one card has no
mesh, so the flag has no analogue here. It runs on the card unless
``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
        --reduced --steps 20 --device cpu
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import policy as perf
from repro_torch._device import resolve_device
from repro_torch.configs import ARCH_IDS, get_arch, reduced
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models import api
from repro_torch.train import checkpoint, optimizer as opt
from repro_torch.train.trainstep import make_train_step

JOURNAL = "journal.log"


def journal_tail(ckpt_dir: str, start: int) -> list:
    """The journalled steps at or after ``start``: what a restart from a
    checkpoint at ``start`` replays."""
    path = os.path.join(ckpt_dir, JOURNAL)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [s for s in (int(x) for x in f) if s >= start]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-3-8b", choices=ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-sized config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro", type=int, default=2)
    ap.add_argument("--policy", default="baseline",
                    choices=list(perf.POLICIES))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    perf.set_policy(args.policy)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    model = api.build(cfg)
    ocfg = opt.AdamWConfig(total_steps=args.steps)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    ostate = opt.init(params)
    start = 0
    if args.resume and checkpoint.exists(args.ckpt_dir):
        params, ostate, meta = checkpoint.restore(args.ckpt_dir, params,
                                                  ostate)
        start = meta["step"]
        tail = journal_tail(args.ckpt_dir, start)
        print(f"[train] resumed from step {start}; replaying the journal's "
              f"{len(tail)} steps after it, then on to {args.steps}")
    step_fn = make_train_step(model, ocfg, n_microbatches=args.micro,
                              device=dev)
    journal = None
    if args.ckpt_dir:
        os.makedirs(args.ckpt_dir, exist_ok=True)
        journal = open(os.path.join(args.ckpt_dir, JOURNAL), "a")

    ckpt_thread = None
    t0 = time.time()
    for i in range(start, args.steps):
        if journal is not None:     # the statement before its writes
            journal.write(f"{i}\n")
            journal.flush()
        batch = make_batch(dcfg, i, arch=cfg, device=dev)
        params, ostate, metrics = step_fn(params, ostate, batch)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            if ckpt_thread is not None:
                ckpt_thread.join()
            ckpt_thread = checkpoint.save_async(args.ckpt_dir, params,
                                                ostate, step=i + 1)
        if (i + 1) % 10 == 0 or i + 1 == args.steps:
            dt = (time.time() - t0) / max(1, i + 1 - start)
            print(f"[train] step {i + 1:5d} "
                  f"loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"{dt * 1e3:.0f} ms/step")
    if ckpt_thread is not None:
        ckpt_thread.join()
    if journal is not None:
        journal.close()
    print("[train] done")


if __name__ == "__main__":
    main()

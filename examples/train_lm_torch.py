"""End-to-end training with NAM-DB-style fault tolerance, on the PyTorch
port (the counterpart of ``examples/train_lm.py``).

Trains an LM (default: a ~10M-parameter member of the granite family;
``--preset 100m`` gives the ~100M-parameter version) with:

  * the microbatched, rematerialised train step
    (``repro_torch.train.trainstep``),
  * a per-step journal of the data order, written before the step (paper
    §6.2: replay needs only the read snapshot and the statement),
  * async checkpoints every ``--ckpt-every`` steps
    (``repro_torch.train.checkpoint``: the leaves are copied to the host
    and written on a background thread while training goes on),
  * a simulated failure at ``--fail-at``: the parameters and moments are
    thrown away, recovered from the last checkpoint plus a replay of the
    journal's tail, and training continues; the final parameters must
    equal an uninterrupted run's bit for bit.

It runs on the card unless ``--device cpu`` is given. On the card, exact
replay needs deterministic algorithms: the script sets
``CUBLAS_WORKSPACE_CONFIG`` before torch starts CUDA and turns
``torch.use_deterministic_algorithms`` on.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 60 --fail-at 35
"""
import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_batch  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.train import checkpoint, optimizer as opt  # noqa: E402
from repro_torch.train.trainstep import make_train_step  # noqa: E402

PRESETS = {
    # ~10M params: a few hundred steps in minutes on one CPU core
    "10m": dict(d_model=256, n_layers=4, d_ff=1024, vocab=4096,
                n_heads=4, n_kv_heads=2, seq=128, batch=8),
    # ~100M params
    "100m": dict(d_model=768, n_layers=12, d_ff=2048, vocab=32768,
                 n_heads=12, n_kv_heads=4, seq=256, batch=8),
}


def preset_config(preset):
    p = PRESETS[preset]
    return reduced(get_arch("granite-3-8b"), d_model=p["d_model"],
                   n_layers=p["n_layers"], d_ff=p["d_ff"], vocab=p["vocab"],
                   n_heads=p["n_heads"], n_kv_heads=p["n_kv_heads"])


def train(steps, fail_at, preset, ckpt_every, workdir, device=None,
          log=print):
    """One run; returns ``(params, losses)``. With ``fail_at`` the run
    loses its state after that step and recovers it from the checkpoint
    and the journal."""
    dev = resolve_device(device)
    p = PRESETS[preset]
    cfg = preset_config(preset)
    model = api.build(cfg)

    def fresh():
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        return params, opt.init(params)
    params, ostate = fresh()
    n_params = sum(x.numel() for x in params.parameters())
    log(f"arch={cfg.name} (reduced/{preset}) params={n_params / 1e6:.1f}M "
        f"on {dev}")
    ocfg = opt.AdamWConfig(lr=3e-4, warmup_steps=20, total_steps=steps)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=p["seq"],
                      global_batch=p["batch"])
    step_fn = make_train_step(model, ocfg, n_microbatches=2, device=dev)

    wal_path = os.path.join(workdir, "wal.log")      # the journal
    ckpt_path = os.path.join(workdir, "ckpt")
    wal = open(wal_path, "a")
    ckpt_thread = None
    losses, t0, i = [], time.time(), 0
    while i < steps:
        # §6.2: journal the statement (the data-order step) BEFORE the
        # step's writes
        wal.write(f"{i}\n")
        wal.flush()
        batch = make_batch(dcfg, i, device=dev)      # deterministic by step
        params, ostate, metrics = step_fn(params, ostate, batch)
        losses.append(float(metrics["loss"]))
        if (i + 1) % ckpt_every == 0:
            # an async checkpoint: the leaves are copied, then written
            # while training goes on
            if ckpt_thread is not None:
                ckpt_thread.join()
            ckpt_thread = checkpoint.save_async(ckpt_path, params, ostate,
                                                step=i + 1)
        if fail_at is not None and i + 1 == fail_at:
            log(f"step {i + 1}: simulated compute-server failure (losing "
                f"the parameters and moments)")
            if ckpt_thread is not None:
                ckpt_thread.join()
            del params, ostate
            # ---- recovery: restore the checkpoint, replay the journal ----
            params, ostate = fresh()                 # the like-tree
            params, ostate, meta = checkpoint.restore(ckpt_path, params,
                                                      ostate)
            replay_from = meta["step"]
            with open(wal_path) as f:
                logged = [int(x) for x in f]
            tail = [s for s in logged if replay_from <= s < fail_at]
            log(f"  recovered at step {replay_from}; replaying "
                f"{len(tail)} journalled steps {tail[:6]}...")
            for s in tail:
                batch = make_batch(dcfg, s, device=dev)
                params, ostate, metrics = step_fn(params, ostate, batch)
            fail_at = None                 # continue from where it died
        if (i + 1) % 10 == 0:
            dt = (time.time() - t0) / (i + 1)
            log(f"step {i + 1:4d}  loss={losses[-1]:.4f}  "
                f"{dt * 1e3:.0f} ms/step")
        i += 1
    if ckpt_thread is not None:
        ckpt_thread.join()
    wal.close()
    return params, losses


@torch.no_grad()
def max_param_diff(a, b) -> float:
    """The largest absolute difference between two models' parameters."""
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a.parameters(), b.parameters()))


def run(steps, fail_at, preset, ckpt_every, device=None, log=print):
    """Run A (failure and recovery) and run B (uninterrupted); returns
    ``(max |param diff|, losses A, losses B)``."""
    with tempfile.TemporaryDirectory() as d1:
        log("=== run A: with a mid-run failure + recovery ===")
        p_fail, l_fail = train(steps, fail_at, preset, ckpt_every, d1,
                               device, log)
    with tempfile.TemporaryDirectory() as d2:
        log("\n=== run B: uninterrupted reference ===")
        p_ref, l_ref = train(steps, None, preset, ckpt_every, d2, device,
                             log)
    return max_param_diff(p_fail, p_ref), l_fail, l_ref


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--fail-at", type=int, default=35)
    ap.add_argument("--preset", choices=list(PRESETS), default="10m")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    torch.use_deterministic_algorithms(True)
    diff, l_fail, l_ref = run(args.steps, args.fail_at, args.preset,
                              args.ckpt_every, args.device)
    print(f"\nfinal loss: failed-run={l_fail[-1]:.4f} "
          f"reference={l_ref[-1]:.4f}")
    print(f"max |param diff| after recovery vs uninterrupted: {diff:.2e}")
    assert diff == 0.0, "recovery must be bit-identical (deterministic replay)"
    print("train_lm_torch OK — failure recovery is exact")


if __name__ == "__main__":
    main()

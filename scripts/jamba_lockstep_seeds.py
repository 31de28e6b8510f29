"""Phase 13's jamba lockstep of ``chip_smoke.py`` alone, once for each
seed given, on one H100: the readings its limits (``JAMBA_RRMS``,
``JAMBA_ROUTER_TIE``) are set from.

For each seed it draws jamba-v0.1-52b at full width, one unit (8 of 32
layers) deep, and runs ``chip_smoke.recurrent_lockstep`` on it: the
kernel path against the plain path on the kernel path's expert choices.
It prints every gate that fails and goes on, then the largest relative
RMS difference of the logits and of each state, the kernel calls
against their plain versions and the plain router's own other choices.
It exits 1 if a gate failed.

    python3 scripts/jamba_lockstep_seeds.py 0 1
"""
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

FAILED = []


def check(cond, msg):
    if not cond:
        FAILED.append(msg)
        print("gate failed:", msg[:400], flush=True)


def main(seeds):
    cs.check = check
    cs._build.build_all(cs.RECURRENT_KERNELS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(cs.get_arch("jamba-v0.1-52b"),
                              n_layers=cs.JAMBA_LAYERS)
    keep = ("rrms", "rrms_at", "rows", "states", "held", "calls",
            "diverged_tokens", "share", "tie", "tie_n", "edge", "edge_n",
            "launches")
    with torch.no_grad():
        for seed in seeds:
            t0 = time.perf_counter()
            # the weights and tokens phase 13 draws for --seed
            model = cs.api.build(cfg).init(
                torch.Generator(device=dev).manual_seed(seed + 13),
                device=dev)
            tokens = cs.recurrent_tokens(seed + 13, cfg.vocab, dev)
            res = cs.recurrent_lockstep(cfg, model, tokens)
            print(f"seed {seed} ({time.perf_counter() - t0:.1f} s): "
                  f"{ {k: res[k] for k in keep} }; greedy tokens tested "
                  f"{sum(res['tested'].values())} of {res['positions']} | "
                  f"{smi}", flush=True)
            del model
            torch.cuda.empty_cache()
    print(f"gates failed: {len(FAILED)}")
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main([int(a) for a in sys.argv[1:]] or [0]))

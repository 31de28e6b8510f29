"""The lockstep of one of ``chip_smoke.py``'s LM phases alone, once for
each seed given, on one H100: the readings its limits are set from.

    python3 scripts/lockstep_seeds.py --phase 12 0 1
    python3 scripts/lockstep_seeds.py --phase 13 0 1
    python3 scripts/lockstep_seeds.py --phase 14 0 1
    python3 scripts/lockstep_seeds.py --phase 15 0 1

Phase 12 (``SERVE_RRMS``, ``SERVE_ROUTER_TIE``, ``SERVE_EDGE_RANKS``,
``SERVE_DIVERTED_*``): for each seed, mixtral-8x22b and gemma2-27b at
``SERVE_CONFIGS``' depths through ``chip_smoke.serve_lockstep``, the
plain engine on the kernel engine's expert choices. Phase 13
(``JAMBA_RRMS``, ``JAMBA_ROUTER_TIE``): jamba-v0.1-52b at full width, one
unit (8 of 32 layers) deep, through ``chip_smoke.recurrent_lockstep``.
Phase 14 (``ENCDEC_RRMS``): whisper-medium and paligemma-3b at full width
and depth through ``chip_smoke.encdec_lockstep``. Phase 15
(``TRAIN_UNIT_RRMS``): one float32 granite-3-8b layer at full width on
the card and the host CPU through ``chip_smoke.run_train_unit``, under
deterministic algorithms and with the CPU's pass on the phase's threads,
whose readings it prints in place of the gate.
Each draws the weights
and traffic that ``chip_smoke.py --seed`` draws. It prints every gate
that fails and goes on, then each model's largest relative RMS
differences, the kernel calls against their plain versions and (phases
12-13) the plain router's own other choices. It exits 1 if a gate
failed.
"""
import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

FAILED = []
# what each phase's lockstep reports
KEEP = {12: ("rrms", "rrms_at", "rows", "pool_rrms", "pool_err", "pool_out",
             "calls", "diverged_tokens", "share", "tie", "tie_n", "edge",
             "edge_n", "launches"),
        13: ("rrms", "rrms_at", "rows", "states", "held", "calls",
             "diverged_tokens", "share", "tie", "tie_n", "edge", "edge_n",
             "launches"),
        14: ("rrms", "rrms_at", "rows", "states", "held", "enc_kv", "calls",
             "kinds")}
KERNELS = {12: cs.SERVE_KERNELS, 13: cs.RECURRENT_KERNELS,
           14: ("flash_attention",)}


def check(cond, msg):
    if not cond:
        FAILED.append(msg)
        print("gate failed:", msg[:400], flush=True)


def models(phase, seed, dev):
    """``(label, lockstep)`` of each model phase ``phase`` runs at
    ``--seed`` ``seed``, drawn one at a time."""
    gen = lambda s: torch.Generator(device=dev).manual_seed(s)  # noqa: E731
    if phase == 12:
        for arch, n_layers in cs.SERVE_CONFIGS:
            cfg = dataclasses.replace(cs.get_arch(arch), n_layers=n_layers)
            model = cs.transformer.init_params(cfg, gen(seed + 12), dev)
            prompts = cs.serve_prompts(seed + 12, cfg.vocab)
            yield arch, lambda: cs.serve_lockstep(cfg, model, prompts)
            del model
            torch.cuda.empty_cache()
    elif phase == 13:
        cfg = dataclasses.replace(cs.get_arch("jamba-v0.1-52b"),
                                  n_layers=cs.JAMBA_LAYERS)
        model = cs.api.build(cfg).init(gen(seed + 13), device=dev)
        tokens = cs.recurrent_tokens(seed + 13, cfg.vocab, dev)
        yield cfg.name, lambda: cs.recurrent_lockstep(cfg, model, tokens)
    else:
        for arch in cs.ENCDEC_PROMPT:
            cfg, model, batch = cs.encdec_model(arch, seed + 14, dev)
            yield arch, lambda: cs.encdec_lockstep(cfg, model, batch)
            del model, batch
            torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase", type=int, choices=sorted(KEEP) + [15],
                    default=13)
    ap.add_argument("seeds", type=int, nargs="*", default=[0])
    args = ap.parse_args(argv)
    cs.check = check
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    dev = torch.device("cuda")
    if args.phase == 15:        # no kernel runs on the train path
        torch.use_deterministic_algorithms(True)
        for seed in args.seeds:
            # during: the CPU's pass on the phase's threads (all but two)
            cs.run_train_unit(argparse.Namespace(seed=seed), dev, smi,
                              hold=lambda what, rr, s=seed: print(
                                  f"phase 15, seed {s}: {what}: relative "
                                  f"RMS difference {rr!r} | {smi}",
                                  flush=True), during=lambda: None)
        print(f"gates failed: {len(FAILED)}")
        return 1 if FAILED else 0
    cs._build.build_all(KERNELS[args.phase])
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        for seed in args.seeds:
            for label, lockstep in models(args.phase, seed, dev):
                t0 = time.perf_counter()
                res = lockstep()
                print(f"phase {args.phase}, seed {seed}, {label} "
                      f"({time.perf_counter() - t0:.1f} s): "
                      f"{ {k: res[k] for k in KEEP[args.phase]} }; greedy "
                      f"tokens tested {sum(res['tested'].values())} of "
                      f"{res['positions']} | {smi}", flush=True)
    print(f"gates failed: {len(FAILED)}")
    return 1 if FAILED else 0


if __name__ == "__main__":
    sys.exit(main())

"""Serving driver on the PyTorch port (the counterpart of
``examples/serve_lm.py``): batched requests through the NAM paged-KV
engine.

The engine's paged KV cache IS a NAM pool (DESIGN.md §3): pages are records
with 8-byte version headers, page allocation is a transactional insert, and
decode workers read a consistent snapshot — the paper's architecture applied
to LM serving. This example admits a batch of prompts, decodes with
continuous batching (finished sequences release pages that new requests
reuse), and prints pool/throughput stats. It runs on the card (with the
``flash_attention`` and ``paged_attention`` kernels) unless ``--device cpu``
is given.

    PYTHONPATH=src python examples/serve_lm_torch.py --requests 12 --max-new 24
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

The weights come from ``--seed``, the prompts from ``--seed + 1``.
"""
import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.data.pipeline import make_prompts  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serve.engine import Engine, EngineConfig  # noqa: E402


def engine_config(max_seqs: int) -> EngineConfig:
    return EngineConfig(max_seqs=max_seqs, page_size=16, n_pages=128,
                        max_len=128)


def run(engine, prompts, max_new: int):
    """Continuous batching over ``prompts`` on ``engine``: admit a wave of
    ``engine.ecfg.max_seqs``, decode up to ``max_new - 1`` steps (a wave
    stops early when every lane is done or inactive: a sequence that emits
    EOS stops earlier), force the stragglers done, release their pages,
    admit the next wave into the freed pages. Returns ``(wave lines,
    tokens decoded, each request's tokens)``: a request's tokens are its
    first (sampled at admission) and one more for every step that leaves
    it live, so the count is the sum of their lengths less one each."""
    ecfg = engine.ecfg
    state = engine.init_state()
    pending = list(prompts)
    lines, outs, total_new = [], [], 0
    while pending:
        admit_now = pending[:ecfg.max_seqs]
        pending = pending[ecfg.max_seqs:]
        slots = (~state.table.active).nonzero()[:, 0][:len(admit_now)]
        slots = slots.tolist()
        state = engine.admit(state, admit_now)
        toks = state.tokens.tolist()
        wave = [[toks[s]] for s in slots]
        for _ in range(max_new - 1):
            if bool((state.done | ~state.table.active).all()):
                break
            state = engine.decode_step(state)
            live = (state.table.active & ~state.done).tolist()
            toks = state.tokens.tolist()
            total_new += sum(live)
            for out, s in zip(wave, slots):
                if live[s]:
                    out.append(toks[s])
        outs += wave
        # truncate stragglers at the wave budget, free their pages
        state = state._replace(done=state.done | state.table.active)
        # PageMeta has no free_count, in the reference as here: always -1
        free_before = int(state.meta.free_count) \
            if hasattr(state.meta, "free_count") else -1
        state = engine.release_finished(state)
        lines.append(f"wave {len(lines) + 1}: admitted {len(admit_now)}, "
                     f"pool free pages before release: {free_before}")
    return lines, total_new, outs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-seqs", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="the weights' seed; the prompts take seed + 1")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduced(get_arch(args.arch))
    params = api.build(cfg).init(
        torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    prompts = make_prompts(args.seed + 1, args.requests, cfg.vocab,
                           min_len=4, max_len=20)
    print(f"arch={cfg.name} (reduced)  requests={len(prompts)}  "
          f"engine: {args.max_seqs} seqs x 128 pages")

    t0 = time.time()
    engine = Engine(cfg, params, engine_config(args.max_seqs), device=dev)
    lines, total_new, _ = run(engine, prompts, args.max_new)
    dt = time.time() - t0
    print("\n".join(lines))
    print(f"waves={len(lines)}  tokens decoded={total_new} in {dt:.1f}s "
          f"({total_new / max(dt, 1e-9):.1f} tok/s on {dev.type})")
    print("serve_lm OK — continuous batching with page reuse")


if __name__ == "__main__":
    main()

"""How far float32 and bfloat16 runs of one xlstm-350m unit drift from a
float64 run of the same unit, on the CPU.

One unit (mLSTM + sLSTM) of ``xlstm-350m`` at full width, random weights
from ``--seed``, goes through ``Model.prefill`` on ``--batch`` prompts and
``--steps`` greedy decode steps (every run fed the float64 run's tokens)
three times: in float64 (the port's own code, its float32 casts and
states kept at float64), in float32 and in bfloat16 (the float32 leaves
kept float32, as the port loads them). For each prompt length it prints the largest
relative RMS difference of the logits and of every cache leaf from the
float64 run, over the prefill and the steps. ``chip_smoke.py`` phase 13
holds the card's float32 unit to the CPU's at the same two lengths; this
script gives the readings its limits sit between.

    PYTHONPATH=src python scripts/xlstm_unit_precision.py [--lengths 128 1000]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.models import api, transformer


@contextlib.contextmanager
def float64_kept():
    """While active, ``Tensor.float()`` leaves float64 tensors as they
    are and ``torch.zeros``/``full``/``ones`` make float64 where asked for
    float32, so that the port's float32 casts and float32 states keep a
    float64 run float64."""
    orig = {n: getattr(torch, n) for n in ("zeros", "full", "ones")}
    orig_float = torch.Tensor.float

    def keep(t, *args, **kw):
        return t if t.dtype == torch.float64 else orig_float(t, *args, **kw)

    def widened(fn):
        def make(*args, **kw):
            if kw.get("dtype") is torch.float32:
                kw["dtype"] = torch.float64
            return fn(*args, **kw)
        return make
    torch.Tensor.float = keep
    for n, fn in orig.items():
        setattr(torch, n, widened(fn))
    try:
        yield
    finally:
        torch.Tensor.float = orig_float
        for n, fn in orig.items():
            setattr(torch, n, fn)


def leaves(cache, unit):
    """``{name: tensor}`` of every recurrent cache leaf."""
    out = {}
    for slot, spec in zip(cache.slots, unit.unit()):
        st = getattr(slot, spec.kind)
        out.update({f"{spec.kind}.{f}": getattr(st, f) for f in st._fields})
    return out


def rel_rms(a, b):
    d = (a.double() - b.double()).pow(2).mean().sqrt()
    return float(d / b.double().pow(2).mean().sqrt().clamp_min(1e-300))


def run(unit, model, tokens, steps, feed=None):
    """The logits and cache leaves after the prefill and each step; the
    tokens fed are ``feed`` or, where None, the run's own greedy ones."""
    m = api.build(unit)
    h, cache = m.prefill(model, {"tokens": tokens},
                         tokens.shape[1] + steps + 1)
    logits = transformer.lm_head(h, model.embed, unit.logit_softcap)
    seen, fed = [(logits, leaves(cache, unit))], []
    for step in range(steps):
        tok = (logits.argmax(dim=-1).to(torch.int32) if feed is None
               else feed[step])
        fed.append(tok)
        logits, cache = m.decode_step(model, cache, tok)
        seen.append((logits, leaves(cache, unit)))
    return seen, fed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--lengths", type=int, nargs="+", default=[128, 1000])
    args = ap.parse_args(argv)
    torch.manual_seed(args.seed)
    cfg = get_arch("xlstm-350m")
    unit = dataclasses.replace(cfg, n_layers=cfg.unit_len, dtype="float32")
    f32 = api.build(unit).init(torch.Generator().manual_seed(args.seed),
                               device="cpu")
    f64 = transformer.Transformer(unit, device="cpu").double()
    f64.load_state_dict({k: v.double() for k, v in f32.state_dict().items()})
    bf = dataclasses.replace(unit, dtype="bfloat16")
    b16 = transformer.Transformer(bf, device="cpu")
    b16.load_state_dict(f32.state_dict())
    tokens = torch.randint(0, cfg.vocab, (args.batch, max(args.lengths)),
                           generator=torch.Generator().manual_seed(
                               args.seed + 1), dtype=torch.int32)
    report = {}
    with torch.no_grad():
        for n in args.lengths:
            t0 = time.perf_counter()
            with float64_kept():
                ref, feed = run(unit, f64, tokens[:, :n], args.steps)
            wide = {t.dtype for lg, st in ref for t in (lg, *st.values())}
            if wide != {torch.float64}:
                raise SystemExit(f"the float64 run made {wide}")
            for name, u, model in (("float32", unit, f32),
                                   ("bfloat16", bf, b16)):
                seen, _ = run(u, model, tokens[:, :n], args.steps, feed)
                worst = {}
                for (lg, st), (lr, sr) in zip(seen, ref):
                    for key, a, b in [("logits", lg, lr)] + [
                            (k, st[k], sr[k]) for k in sr]:
                        worst[key] = max(worst.get(key, 0.0), rel_rms(a, b))
                report.setdefault(n, {})[name] = worst
                print(f"xlstm-350m unit, {name} against float64 on the CPU, "
                      f"{args.batch} prompts of {n} tokens and {args.steps} "
                      f"steps: largest relative RMS difference "
                      f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} }",
                      flush=True)
            print(f"  ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps(report))


if __name__ == "__main__":
    main()

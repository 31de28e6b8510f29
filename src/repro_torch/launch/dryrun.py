"""The dry run (``repro/launch/dryrun.py``): count every (arch × shape ×
mesh) cell's real step on ``meta`` tensors, with no allocation.

For each cell this builds the REAL step (``train/trainstep.
make_train_step`` with AdamW, remat and microbatches; ``Model.prefill``
or ``Model.decode_step`` on the plain path, ``kernels=False``, which is
what the reference lowers too) on the shape-only inputs of
``Model.param_shapes`` / ``input_specs`` / ``cache_specs``, runs it under
the dispatch-level op counter (``launch/hlostats.py``) inside the
shape-only mesh (``launch/mesh.py``), and records:

  * ``hlo_flops``, ``hlo_bytes`` — the step's matrix-product FLOPs and
    unfused bytes, as one card dispatches the whole step;
  * ``memory`` — the argument bytes one chip of the mesh would hold of
    the parameters, the AdamW moments, the batch and the cache under the
    partition rules (``launch/sharding.py``), and ``fits_one_card``:
    whether they fit one H100's 80 GB;
  * ``roofline`` — ``compute_s`` and ``memory_s``, the step's FLOPs and
    bytes spread evenly over the mesh's chips, each an H100 SXM5 at its
    data-sheet rates, and the ``dominant`` one. There is no collective
    term: the counted program is one card's, which exchanges nothing; the
    reference's wire bytes come from the partitioned HLO, which has no
    one-card counterpart;
  * ``model_flops_total`` — 6·N_active·tokens to train, 2·N_active·tokens
    to prefill (the forward alone; the reference counts 6·N there too)
    and 2·N_active·B a decode step — with ``useful_flops_ratio`` and
    ``roofline_fraction`` as the reference defines them;
  * the dry run's own seconds.

These are counts against spec constants, not times on a card.

Results land in ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x22b \\
      --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh all
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch import policy as perf
from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.configs.base import SHAPES, shape_applies
from repro_torch.convert import lm_tree
from repro_torch.launch import hlostats
from repro_torch.launch import sharding as shp
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import api
from repro_torch.train import optimizer as opt
from repro_torch.train.trainstep import make_train_step

# NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU data sheet): dense bf16
# tensor-core FLOP/s, HBM3 bytes/s and device memory
PEAK_FLOPS = 989.4e12
HBM_BW = 3.35e12
CARD_BYTES = 80e9

MESHES = {"card": make_host_mesh,
          "pod": lambda: make_production_mesh(multi_pod=False),
          "multipod": lambda: make_production_mesh(multi_pod=True)}
OUT_DIR = "experiments/dryrun_torch"


def memory(model, shape, mesh):
    """``(record, step inputs)``: the argument bytes one chip of ``mesh``
    holds of each part of the cell's step, and the meta inputs of the
    step: ``(params, opt_state, batch)`` to train, ``(params, batch)`` to
    prefill, ``(params, cache, token)`` to decode."""
    cfg = model.cfg
    params = model.param_shapes()
    ptree = shp.param_tree(params)
    pspec = shp.param_pspecs(ptree, mesh)
    rec = {"params": shp.per_device_bytes(ptree, pspec, mesh)}
    inputs = model.input_specs(shape)
    bspec = shp.batch_pspecs(cfg, shape, mesh)
    if shape.kind == "train":
        ostate = opt.init(params)
        moments = opt.AdamWState(
            step=ostate.step,
            m=lm_tree(ostate.m, cfg.unit_len, shp.shape_of, shp.stack_shapes),
            v=lm_tree(ostate.v, cfg.unit_len, shp.shape_of, shp.stack_shapes))
        rec["moments"] = shp.per_device_bytes(moments,
                                              shp.opt_pspecs(pspec), mesh)
        rec["batch"] = shp.per_device_bytes(inputs, bspec, mesh)
        args = (params, ostate, inputs)
    elif shape.kind == "prefill":
        rec["batch"] = shp.per_device_bytes(inputs, bspec, mesh)
        args = (params, inputs)
    else:
        cache = model.cache_specs(shape)
        ctree = shp.cache_tree(cfg, cache)
        rec["cache"] = shp.per_device_bytes(
            ctree, shp.cache_pspecs(cfg, ctree, shape, mesh), mesh)
        rec["batch"] = shp.per_device_bytes(inputs, bspec, mesh)
        args = (params, cache, inputs["token"])
    rec["argument_bytes"] = sum(rec.values())
    rec["fits_one_card"] = rec["argument_bytes"] <= CARD_BYTES
    return rec, args


def step_fn(model, shape, n_micro):
    """The cell's real step on the plain path."""
    if shape.kind == "train":
        return make_train_step(model, opt.AdamWConfig(),
                               n_microbatches=n_micro, device="meta")
    if shape.kind == "prefill":
        return lambda params, batch: model.prefill(
            params, batch, shape.seq_len, kernels=False)
    return lambda params, cache, token: model.decode_step(
        params, cache, token, kernels=False)


def model_flops(cfg, shape) -> float:
    """6·N_active·tokens to train, 2·N_active·tokens to prefill,
    2·N_active·B a decode step."""
    n = cfg.n_active_params()
    if shape.kind in ("decode", "long_decode"):
        return 2 * n * shape.global_batch
    return (6 if shape.kind == "train" else 2) * n * shape.seq_len \
        * shape.global_batch


def count_cell(cfg, shape, mesh, n_micro: int = 4, counted=None) -> dict:
    """The record of one cell's step (module docstring): ``cfg`` an
    ``ArchConfig``, ``shape`` a ``ShapeConfig``, ``mesh`` a shape-only
    mesh; under the current policy. ``counted``, a dict, keeps each
    step's ``Stats`` for the next mesh: the mesh changes the step only
    through ``moe.apply_moe``'s sharded dispatch, which a policy without
    ``constrain_activations`` never takes."""
    model = api.build(cfg)
    key = (cfg, shape, n_micro)
    t0 = time.perf_counter()
    with mesh:
        mem, args = memory(model, shape, mesh)
        st = None if counted is None else counted.get(key)
        if st is None:
            _, st = hlostats.count(step_fn(model, shape, n_micro), *args)
        if counted is not None \
                and not perf.current().constrain_activations:
            counted[key] = st
    seconds = time.perf_counter() - t0
    n = mesh.size
    t_compute = st.flops / (n * PEAK_FLOPS)
    t_memory = st.hbm_bytes / (n * HBM_BW)
    useful = model_flops(cfg, shape)
    return {
        "status": "ok", "n_chips": n, "dryrun_s": seconds,
        "hlo_flops": st.flops, "hlo_bytes": st.hbm_bytes,
        "top_ops": hlostats.top_ops(st),
        "memory": mem,
        "roofline": {"compute_s": t_compute, "memory_s": t_memory,
                     "dominant": "compute" if t_compute >= t_memory
                     else "memory"},
        "model_flops_total": useful,
        "useful_flops_ratio": useful / max(st.flops, 1.0),
        "roofline_fraction": (useful / (n * PEAK_FLOPS))
        / max(t_compute, t_memory, 1e-30),
    }


def fits_table() -> dict:
    """``{(arch, shape): fits_one_card, or None where the shape does not
    apply}`` on one card, over every architecture at full depth and every
    shape of ``SHAPES``, from the argument bytes alone (no step is
    counted)."""
    mesh = make_host_mesh()
    out = {}
    with mesh:
        for arch_id in ARCH_IDS:
            model = api.build(get_arch(arch_id))
            for name, shape in SHAPES.items():
                out[arch_id, name] = memory(model, shape, mesh)[0][
                    "fits_one_card"] if shape_applies(model.cfg, shape)[0] \
                    else None
    return out


def run_cell(arch_id: str, shape_name: str, mesh_name: str,
             n_micro: int = 4, out_dir: str = OUT_DIR,
             policy_name: str = "baseline", counted=None):
    """Count one cell of ``SHAPES`` and the mesh ``mesh_name`` under the
    policy ``policy_name``, and write its record (``counted``: as
    :func:`count_cell`'s)."""
    arch = get_arch(arch_id)
    shape = SHAPES[shape_name]
    ok, reason = shape_applies(arch, shape)
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
           "policy": policy_name, "status": "skip", "reason": reason}
    if ok:
        prev = perf.current()
        perf.set_policy(policy_name)
        try:
            rec.update(count_cell(arch, shape, MESHES[mesh_name](), n_micro,
                                  counted))
        finally:
            perf.set_policy(prev)
        r, mem = rec["roofline"], rec["memory"]
        print(f"[dryrun] {arch_id} × {shape_name} × {mesh_name}: OK "
              f"{rec['dryrun_s']:.1f}s flops={rec['hlo_flops']:.4g} bytes="
              f"{rec['hlo_bytes']:.4g} compute={r['compute_s']:.4g}s "
              f"mem={r['memory_s']:.4g}s dominant={r['dominant']} "
              f"useful={rec['useful_flops_ratio']:.3f} args/chip="
              f"{mem['argument_bytes'] / 1e9:.3f} GB fits_one_card="
              f"{mem['fits_one_card']}", flush=True)
    else:
        print(f"[dryrun] {arch_id} × {shape_name} × {mesh_name}: {reason}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch_id}__{shape_name}__"
                                    f"{mesh_name}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def table(out_dir: str = OUT_DIR, mesh_name: str = "card") -> str:
    """A markdown table of the records in ``out_dir``: an architecture a
    row, a shape a column, each cell the counted and the model TFLOP, the
    argument GB one chip of ``mesh_name`` holds and ``fits_one_card``."""
    rows = [f"| arch ({mesh_name}) | " + " | ".join(SHAPES) + " |",
            "| --- |" + " --- |" * len(SHAPES)]
    for arch_id in ARCH_IDS:
        cells = []
        for shape_name in SHAPES:
            path = os.path.join(out_dir, f"{arch_id}__{shape_name}__"
                                         f"{mesh_name}.json")
            if not os.path.exists(path):
                cells.append("not run")
                continue
            with open(path) as f:
                rec = json.load(f)
            if rec["status"] != "ok":
                cells.append("skip")
                continue
            mem = rec["memory"]
            cells.append(f"{rec['hlo_flops'] / 1e12:.4g} / "
                         f"{rec['model_flops_total'] / 1e12:.4g}; "
                         f"{mem['argument_bytes'] / 1e9:.4g} GB "
                         f"{'fits' if mem['fits_one_card'] else 'no'}")
        rows.append(f"| {arch_id} | " + " | ".join(cells) + " |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="card",
                    choices=list(MESHES) + ["all"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--micro", type=int, default=4)
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--policy", default="baseline",
                    help="PerfPolicy name from repro_torch.policy.POLICIES")
    ap.add_argument("--table", action="store_true",
                    help="print the records in --out as a markdown table "
                         "(for --mesh; card by default) and stop")
    args = ap.parse_args(argv)
    if args.table:
        print(table(args.out, "card" if args.mesh == "all" else args.mesh))
        return

    archs = ARCH_IDS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = list(MESHES) if args.mesh == "all" else [args.mesh]
    failures = []
    for arch_id in archs:
        for shape_name in shapes:
            counted = {}
            for mesh_name in meshes:
                try:
                    run_cell(arch_id, shape_name, mesh_name,
                             n_micro=args.micro, out_dir=args.out,
                             policy_name=args.policy, counted=counted)
                except Exception:
                    failures.append((arch_id, shape_name, mesh_name))
                    print(f"[dryrun] FAIL {arch_id} × {shape_name} × "
                          f"{mesh_name}")
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"dry-run failures: {failures}")
    print("[dryrun] ALL CELLS OK")


if __name__ == "__main__":
    main()

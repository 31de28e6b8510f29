"""Quickstart on the PyTorch port (the counterpart of
``examples/quickstart.py``).

Runs the paper's full Snapshot-Isolation protocol (timestamp-vector
oracle, MVCC record store, CAS validate+lock, in-place install) as one
vectorised "round" of concurrent transaction threads, then a one-step tour
of the LM side (build an assigned architecture, take one batch's loss).
It runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.configs import get_arch, reduced  # noqa: E402
from repro_torch.core import mvcc, si  # noqa: E402
from repro_torch.core.tsoracle import VectorOracle  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_batch  # noqa: E402
from repro_torch.models import api  # noqa: E402

N_ACCOUNTS, WIDTH, T = 64, 2, 16          # T concurrent transaction threads
ROUNDS = 8


def transfer(read_hdr, read_data, ts_vec):
    """Local transaction logic: move 10 from src to dst."""
    out = read_data.to(torch.int32).clone()
    out[:, 0, 0] -= 10                    # debit  src
    out[:, 1, 0] += 10                    # credit dst
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. A tiny NAM pool: 64 bank accounts, 100 units each, 4 old versions.
    table = mvcc.init_table(N_ACCOUNTS, payload_width=WIDTH, n_old=4,
                            device=dev)
    table.cur_data[:, 0] = 100
    oracle = VectorOracle(n_threads=T)    # the paper's scalable T_R vector
    state = oracle.init(dev)

    # 2. Transfer 10 units between random account pairs, SI-transactionally.
    #    Each thread reads 2 records and writes both: a distributed txn.
    gen = torch.Generator(device=dev).manual_seed(0)
    committed_total, aborted_total = 0, 0
    for rnd in range(ROUNDS):
        src = torch.randint(0, N_ACCOUNTS, (T,), generator=gen, device=dev)
        dst = (src + 1 + torch.randint(0, N_ACCOUNTS - 1, (T,),
                                       generator=gen, device=dev)) \
            % N_ACCOUNTS
        batch = si.TxnBatch(
            tid=torch.arange(T, dtype=torch.int32, device=dev),
            read_slots=torch.stack([src, dst], dim=1).to(torch.int32),
            read_mask=torch.ones((T, 2), dtype=torch.bool, device=dev),
            write_ref=torch.arange(2, dtype=torch.int32, device=dev)
            .expand(T, 2).contiguous(),
            write_mask=torch.ones((T, 2), dtype=torch.bool, device=dev))
        res = si.run_round(table, oracle, state, batch, transfer)
        table, state = res.table, res.oracle_state
        n_c = int(res.committed.sum())
        committed_total += n_c
        aborted_total += T - n_c
        print(f"round {rnd}: committed {n_c:2d}/{T}   "
              f"T_R head={[int(x) for x in state.vec[:6]]}")

    # SI invariant: money is conserved no matter which transactions aborted.
    total = int(table.cur_data[:, 0].sum())
    if total != N_ACCOUNTS * 100:
        raise SystemExit(f"conservation broken: sum of balances {total}")
    print(f"\nconservation holds: sum of balances = {total} "
          f"({committed_total} committed, {aborted_total} aborted)")

    # 3. The LM side: every assigned architecture is one `--arch` flag away.
    cfg = reduced(get_arch("granite-3-8b"))
    model = api.build(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(1),
                        device=dev)
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4), 0, device=dev)
    with torch.no_grad():
        loss = model.train_loss(params, batch)
    print(f"\n{cfg.name} (reduced, {cfg.n_layers}L/{cfg.d_model}d): "
          f"one-batch loss = {float(loss):.3f}  "
          f"(~ln V = {math.log(cfg.vocab):.3f})")
    print("quickstart OK")


if __name__ == "__main__":
    main()

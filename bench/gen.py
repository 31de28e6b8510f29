"""The benchmark's own TPC-C input generator, frozen.

A copy of the draws of ``repro_torch.db.workload`` as they stood when the
benchmark was defined (``gen_mixed``, ``gen_neworder`` and what they call),
so that a change to the program cannot change the traffic it is measured
on. It returns the program's input records (``workload.MixedInputs``,
``workload.NewOrderInputs``): the program takes only the generated tensors.

:func:`horizon` draws every round a run may use during set-up, on the
device, from the run's seed; the driver's ``draw(r)`` then only indexes it
(:func:`Horizon.draw`). The configuration gives the sizes and the share of
distributed new-orders (``dist_degree``); the traffic file gives the
driver and, for the mix, the type weights (``mix``, default TPC-C's
45/43/4/4/4). Warehouses, districts, customers and items are uniform, 15 %
of payments remote.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

MIX = {"neworder": 0.45, "payment": 0.43, "orderstatus": 0.04,
       "delivery": 0.04, "stocklevel": 0.04}
TXN_TYPES = ("neworder", "payment", "orderstatus", "delivery", "stocklevel")
MAX_OL = 15


def _randint(gen, lo, hi, shape):
    return torch.randint(lo, hi, shape, generator=gen, device=gen.device,
                         dtype=torch.int32)


def _rand(gen, shape):
    return torch.rand(shape, generator=gen, device=gen.device)


def _gumbel(gen, shape):
    return -torch.log(torch.empty(shape, device=gen.device).exponential_(
        generator=gen))


def _categorical(gen, logits, n: int):
    return (logits[None, :] + _gumbel(gen, (n, logits.shape[0]))).argmax(
        dim=1).to(torch.int32)


def mix_logits(mix=None, *, device=None) -> torch.Tensor:
    mix = MIX if mix is None else mix
    p = torch.tensor([float(mix.get(t, 0.0)) for t in TXN_TYPES],
                     dtype=torch.float32, device=device)
    return torch.log(p.clamp(min=1e-30))


def _draw_w(gen, n, n_warehouses):
    return _randint(gen, 0, n_warehouses, (n,))


def _draw_d(gen, n):
    return _randint(gen, 0, 10, (n,))


def _other_warehouse(gen, w_id, n_warehouses: int, shape):
    rw = _randint(gen, 0, max(n_warehouses - 1, 1), shape)
    w = w_id.reshape(w_id.shape + (1,) * (len(shape) - w_id.dim()))
    return torch.where(rw >= w, rw + 1, rw).clamp(0, n_warehouses - 1)


def gen_neworder(wl, gen, n, n_warehouses, n_items, customers, dist_degree):
    """One round of new-order inputs (``wl`` is the program's ``workload``
    module, whose records the program takes)."""
    w_id = _draw_w(gen, n, n_warehouses)
    d_id = _draw_d(gen, n)
    c_id = _randint(gen, 0, customers, (n,))
    ol_cnt = _randint(gen, 5, MAX_OL + 1, (n,))
    item_ids = torch.topk(_gumbel(gen, (n, n_items)), MAX_OL,
                          dim=1).indices.to(torch.int32)
    is_dist = _rand(gen, (n,)) < dist_degree / 100.0
    remote_w = _other_warehouse(gen, w_id, n_warehouses, (n, MAX_OL))
    line_remote = _rand(gen, (n, MAX_OL)) < 0.5
    line_remote[:, 0] = True
    is_remote = is_dist[:, None] & line_remote & (n_warehouses > 1)
    supply_w = torch.where(is_remote, remote_w, w_id[:, None])
    qty = _randint(gen, 1, 11, (n, MAX_OL))
    return wl.NewOrderInputs(w_id=w_id, d_id=d_id, c_id=c_id, ol_cnt=ol_cnt,
                             item_ids=item_ids, supply_w=supply_w, qty=qty,
                             is_remote=is_remote)


def gen_mixed(wl, gen, n, n_warehouses, n_items, customers, dist_degree,
              mix_lg):
    """One round of the full mix: each thread's type, and every type's
    inputs for every thread."""
    txn_type = _categorical(gen, mix_lg, n)
    no = gen_neworder(wl, gen, n, n_warehouses, n_items, customers,
                      dist_degree)
    w = _draw_w(gen, n, n_warehouses)
    d = _draw_d(gen, n)
    c = _randint(gen, 0, customers, (n,))
    remote = (_rand(gen, (n,)) < 0.15) & (n_warehouses > 1)
    rw = _other_warehouse(gen, w, n_warehouses, (n,))
    pay = wl.PaymentInputs(w_id=w, d_id=d, c_id=c,
                           c_w_id=torch.where(remote, rw, w),
                           amount=_randint(gen, 100, 500000, (n,)))
    w = _draw_w(gen, n, n_warehouses)
    os_ = wl.OrderStatusInputs(w_id=w, d_id=_draw_d(gen, n),
                               c_id=_randint(gen, 0, customers, (n,)))
    w = _draw_w(gen, n, n_warehouses)
    dl = wl.DeliveryInputs(w_id=w, d_id=_draw_d(gen, n),
                           carrier=_randint(gen, 1, 11, (n,)))
    w = _draw_w(gen, n, n_warehouses)
    sl = wl.StockLevelInputs(w_id=w, d_id=_draw_d(gen, n),
                             threshold=_randint(gen, 10, 21, (n,)))
    return wl.MixedInputs(txn_type=txn_type, neworder=no, payment=pay,
                          orderstatus=os_, delivery=dl, stocklevel=sl)


def _stack(rounds):
    """A list of (nested) NamedTuples of tensors as one of stacked
    tensors, round first."""
    first = rounds[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(rounds)
    return type(first)(*(_stack([r[i] for r in rounds])
                         for i in range(len(first))))


def _index(tree, r):
    if isinstance(tree, torch.Tensor):
        return tree[r]
    return type(tree)(*(_index(t, r) for t in tree))


class Horizon(NamedTuple):
    """Every round's inputs, stacked round first on the device."""
    rounds: object
    n_rounds: int

    def draw(self, r: int):
        if not 0 <= r < self.n_rounds:
            raise RuntimeError(f"round {r} is past the draw horizon of "
                               f"{self.n_rounds} rounds")
        return _index(self.rounds, r)


def round_source(wl, cfg: dict, traffic: dict, gen: torch.Generator):
    """``draw(r)`` of fresh rounds of the traffic, one generator call
    sequence a round, as the program's ``mixed_stream`` /
    ``neworder_stream`` make them."""
    W, T = cfg["n_warehouses"], cfg["n_threads"]
    items, cust = cfg["n_items"], cfg["customers_per_district"]
    dd = float(cfg["dist_degree"])
    if traffic["driver"] == "neworder":
        return lambda r: gen_neworder(wl, gen, T, W, items, cust, dd)
    mix_lg = mix_logits(traffic.get("mix"), device=gen.device)
    return lambda r: gen_mixed(wl, gen, T, W, items, cust, dd, mix_lg)


def horizon(wl, cfg: dict, traffic: dict, seed: int, n_rounds: int,
            device) -> Horizon:
    """``n_rounds`` rounds drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(draw_seed(seed))
    src = round_source(wl, cfg, traffic, gen)
    return Horizon(rounds=_stack([src(r) for r in range(n_rounds)]),
                   n_rounds=n_rounds)


def draw_seed(seed: int) -> int:
    """The generator seed of the draws (the load takes ``seed`` itself):
    any whole number maps into the generator's 64-bit seed range."""
    return (int(seed) * 2 + 1) % (1 << 63)


def load_seed(seed: int) -> int:
    return (int(seed) * 2) % (1 << 63)

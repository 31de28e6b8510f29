"""TPC-C new-order input generation with an explicit ``torch.Generator``.

The draws follow the reference distributions: uniform warehouse, district,
customer and order-line count; distinct items per order by Gumbel top-k
over the item popularity logits (uniform or zipf(α)); ``dist_degree`` % of
orders source each line remotely with probability ½ (at least the first).
The random bits differ from any other generator's; tests that compare with
the reference feed its draws in through a ``draw(round)`` callable instead.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class NewOrderInputs(NamedTuple):
    w_id: torch.Tensor       # int32 [T] home warehouse
    d_id: torch.Tensor       # int32 [T] district 0..9
    c_id: torch.Tensor       # int32 [T] customer
    ol_cnt: torch.Tensor     # int32 [T] 5..15 items
    item_ids: torch.Tensor   # int32 [T, 15]
    supply_w: torch.Tensor   # int32 [T, 15] (== w_id unless remote)
    qty: torch.Tensor        # int32 [T, 15] 1..10
    is_remote: torch.Tensor  # bool  [T, 15]


Draw = Callable[[int], NewOrderInputs]


def zipf_logits(n_items: int, alpha: Optional[float], *,
                device) -> torch.Tensor:
    """Log-probabilities of item popularity (rank-ordered)."""
    if alpha is None:
        return torch.zeros((n_items,), dtype=torch.float32, device=device)
    ranks = torch.arange(1, n_items + 1, dtype=torch.float32, device=device)
    return -alpha * torch.log(ranks)


def gen_neworder(gen: torch.Generator, n_txns: int, n_warehouses: int,
                 n_items: int, customers_per_district: int,
                 home_w: Optional[torch.Tensor], dist_degree: float,
                 item_logits: torch.Tensor, max_ol: int = 15
                 ) -> NewOrderInputs:
    """Sample a batch of new-order transactions on ``item_logits.device``."""
    dev = item_logits.device

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)

    w_id = randint(0, n_warehouses, (n_txns,)) if home_w is None \
        else home_w.to(torch.int32).expand(n_txns).clone()
    d_id = randint(0, 10, (n_txns,))
    c_id = randint(0, customers_per_district, (n_txns,))
    ol_cnt = randint(5, max_ol + 1, (n_txns,))
    # Gumbel noise is -log of a unit exponential draw
    expo = torch.empty((n_txns, n_items), device=dev).exponential_(
        generator=gen)
    gumbel = -torch.log(expo)
    item_ids = torch.topk(item_logits[None, :] + gumbel, max_ol,
                          dim=1).indices.to(torch.int32)
    is_dist = rand((n_txns,)) < dist_degree / 100.0
    remote_w = randint(0, max(n_warehouses - 1, 1), (n_txns, max_ol))
    remote_w = torch.where(remote_w >= w_id[:, None], remote_w + 1, remote_w)
    remote_w = remote_w.clamp(0, n_warehouses - 1)
    line_remote = rand((n_txns, max_ol)) < 0.5
    line_remote[:, 0] = True
    is_remote = is_dist[:, None] & line_remote & (n_warehouses > 1)
    supply_w = torch.where(is_remote, remote_w, w_id[:, None])
    qty = randint(1, 11, (n_txns, max_ol))
    return NewOrderInputs(w_id=w_id, d_id=d_id, c_id=c_id, ol_cnt=ol_cnt,
                          item_ids=item_ids, supply_w=supply_w, qty=qty,
                          is_remote=is_remote)


def neworder_stream(cfg, gen: torch.Generator) -> Draw:
    """A ``draw(round)`` source of fresh new-order batches for a TPC-C
    configuration, on the generator's device."""
    logits = zipf_logits(cfg.n_items, cfg.skew_alpha, device=gen.device)

    def draw(round_no: int) -> NewOrderInputs:
        return gen_neworder(gen, cfg.n_threads, cfg.n_warehouses,
                            cfg.n_items, cfg.customers_per_district, None,
                            cfg.dist_degree, logits)
    return draw

"""TPC-C input generation with an explicit ``torch.Generator``.

The draws follow the reference distributions: each thread's transaction
type from the 45/43/4/4/4 mix (TPC-C v5.11 §5.2.3); uniform warehouse,
district, customer and order-line count, or zipf(α) hot warehouses and a
hot district under a :class:`Skew`; distinct items per order by Gumbel
top-k over the item popularity logits (uniform or zipf(α));
``dist_degree`` % of new-orders source each line remotely with probability
½ (at least the first); 15 % remote payment customers by default. The
random bits differ from any other generator's; tests that compare with the
reference feed its draws in through a ``draw(round)`` callable instead.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

# standard TPC-C mix (§7: new-order is "up to 45% of the benchmark")
MIX = {"neworder": 0.45, "payment": 0.43, "orderstatus": 0.04,
       "delivery": 0.04, "stocklevel": 0.04}

# canonical type order: the integer id of a transaction type everywhere
TXN_TYPES = ("neworder", "payment", "orderstatus", "delivery", "stocklevel")


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


def _randint(gen, lo, hi, shape):
    return torch.randint(lo, hi, shape, generator=gen, device=gen.device,
                         dtype=torch.int32)


def _rand(gen, shape):
    return torch.rand(shape, generator=gen, device=gen.device)


def _gumbel(gen, shape):
    """Standard Gumbel noise: -log of a unit exponential draw."""
    return -torch.log(torch.empty(shape, device=gen.device).exponential_(
        generator=gen))


def _categorical(gen, logits, n: int):
    """``n`` draws from the categorical distribution ``softmax(logits)``
    (Gumbel-max), int32."""
    # the argmax of the noised logits is the categorical draw itself
    # analysis: safe(W03): float logits plus Gumbel noise — no sentinels
    return (logits[None, :] + _gumbel(gen, (n, logits.shape[0]))).argmax(
        dim=1).to(torch.int32)


def mix_logits(mix=None, *, device=None) -> torch.Tensor:
    """Log-probabilities over :data:`TXN_TYPES` for ``mix`` (default MIX)."""
    mix = MIX if mix is None else mix
    p = torch.tensor([float(mix.get(t, 0.0)) for t in TXN_TYPES],
                     dtype=torch.float32, device=device)
    return torch.log(p.clamp(min=1e-30))


def sample_mix(gen: torch.Generator, n_txns: int, mix=None) -> torch.Tensor:
    """Per-thread transaction types, int32 [n_txns] into TXN_TYPES."""
    return _categorical(gen, mix_logits(mix, device=gen.device), n_txns)


def zipf_logits(n_items: int, alpha: Optional[float], *,
                device) -> torch.Tensor:
    """Log-probabilities of item popularity (rank-ordered)."""
    if alpha is None:
        return torch.zeros((n_items,), dtype=torch.float32, device=device)
    ranks = torch.arange(1, n_items + 1, dtype=torch.float32, device=device)
    return -alpha * torch.log(ranks)


class Skew(NamedTuple):
    """Zipfian access-skew knobs: hot warehouses, a hot district and the
    remote-payment fraction. ``None`` fields mean the uniform TPC-C
    default."""
    wh_logits: Optional[torch.Tensor] = None   # float32 [n_warehouses]
    d_logits: Optional[torch.Tensor] = None    # float32 [10]
    remote_frac: float = 0.15                  # payment remote-customer prob


def make_skew(n_warehouses: int, *, wh_alpha: Optional[float] = None,
              hot_district_mass: Optional[float] = None,
              remote_frac: float = 0.15, device=None) -> Skew:
    """zipf(α) warehouse popularity, district 0 drawn with probability
    ``hot_district_mass``, and the payment remote-customer fraction."""
    wh_logits = None if wh_alpha is None \
        else zipf_logits(n_warehouses, wh_alpha, device=device)
    d_logits = None
    if hot_district_mass is not None:
        p = torch.full((10,), (1.0 - hot_district_mass) / 9.0,
                       dtype=torch.float32, device=device)
        p[0] = hot_district_mass
        d_logits = torch.log(p.clamp(min=1e-30))
    return Skew(wh_logits=wh_logits, d_logits=d_logits,
                remote_frac=remote_frac)


def _draw_w(gen, n_txns: int, n_warehouses: int,
            home_w: Optional[torch.Tensor], skew: Optional[Skew]):
    """Warehouse draw: pinned home > zipfian popularity > uniform."""
    if home_w is not None:
        return torch.as_tensor(home_w, device=gen.device).to(
            torch.int32).expand(n_txns).clone()
    if skew is not None and skew.wh_logits is not None:
        return _categorical(gen, skew.wh_logits.to(gen.device), n_txns)
    return _randint(gen, 0, n_warehouses, (n_txns,))


def _draw_d(gen, n_txns: int, skew: Optional[Skew]):
    """District draw: hot-district skew or the uniform spec default."""
    if skew is not None and skew.d_logits is not None:
        return _categorical(gen, skew.d_logits.to(gen.device), n_txns)
    return _randint(gen, 0, 10, (n_txns,))


def _other_warehouse(gen, w_id, n_warehouses: int, shape):
    """A warehouse drawn uniformly among those other than ``w_id``."""
    rw = _randint(gen, 0, max(n_warehouses - 1, 1), shape)
    w = w_id.reshape(w_id.shape + (1,) * (len(shape) - w_id.dim()))
    return torch.where(rw >= w, rw + 1, rw).clamp(0, n_warehouses - 1)


def gen_neworder(gen: torch.Generator, n_txns: int, n_warehouses: int,
                 n_items: int, customers_per_district: int,
                 home_w: Optional[torch.Tensor], dist_degree: float,
                 item_logits: torch.Tensor, max_ol: int = 15,
                 skew: Optional[Skew] = None) -> NewOrderInputs:
    """Sample a batch of new-order transactions on the generator's device
    (``item_logits`` must be there too)."""
    w_id = _draw_w(gen, n_txns, n_warehouses, home_w, skew)
    d_id = _draw_d(gen, n_txns, skew)
    c_id = _randint(gen, 0, customers_per_district, (n_txns,))
    ol_cnt = _randint(gen, 5, max_ol + 1, (n_txns,))
    item_ids = torch.topk(item_logits[None, :]
                          + _gumbel(gen, (n_txns, n_items)), max_ol,
                          dim=1).indices.to(torch.int32)
    is_dist = _rand(gen, (n_txns,)) < dist_degree / 100.0
    remote_w = _other_warehouse(gen, w_id, n_warehouses, (n_txns, max_ol))
    line_remote = _rand(gen, (n_txns, max_ol)) < 0.5
    line_remote[:, 0] = True
    is_remote = is_dist[:, None] & line_remote & (n_warehouses > 1)
    supply_w = torch.where(is_remote, remote_w, w_id[:, None])
    qty = _randint(gen, 1, 11, (n_txns, max_ol))
    return NewOrderInputs(w_id=w_id, d_id=d_id, c_id=c_id, ol_cnt=ol_cnt,
                          item_ids=item_ids, supply_w=supply_w, qty=qty,
                          is_remote=is_remote)


class PaymentInputs(NamedTuple):
    w_id: torch.Tensor     # int32 [T]
    d_id: torch.Tensor     # int32 [T]
    c_id: torch.Tensor     # int32 [T]
    c_w_id: torch.Tensor   # int32 [T] customer's warehouse (15 % remote)
    amount: torch.Tensor   # int32 [T] cents


def gen_payment(gen: torch.Generator, n_txns: int, n_warehouses: int,
                customers_per_district: int,
                home_w: Optional[torch.Tensor] = None,
                skew: Optional[Skew] = None) -> PaymentInputs:
    w_id = _draw_w(gen, n_txns, n_warehouses, home_w, skew)
    d_id = _draw_d(gen, n_txns, skew)
    c_id = _randint(gen, 0, customers_per_district, (n_txns,))
    rf = 0.15 if skew is None else skew.remote_frac
    remote = (_rand(gen, (n_txns,)) < rf) & (n_warehouses > 1)
    rw = _other_warehouse(gen, w_id, n_warehouses, (n_txns,))
    return PaymentInputs(w_id=w_id, d_id=d_id, c_id=c_id,
                         c_w_id=torch.where(remote, rw, w_id),
                         amount=_randint(gen, 100, 500000, (n_txns,)))


class OrderStatusInputs(NamedTuple):
    w_id: torch.Tensor
    d_id: torch.Tensor
    c_id: torch.Tensor


def gen_orderstatus(gen: torch.Generator, n_txns: int, n_warehouses: int,
                    customers_per_district: int,
                    home_w: Optional[torch.Tensor] = None,
                    skew: Optional[Skew] = None) -> OrderStatusInputs:
    w_id = _draw_w(gen, n_txns, n_warehouses, home_w, skew)
    return OrderStatusInputs(
        w_id=w_id, d_id=_draw_d(gen, n_txns, skew),
        c_id=_randint(gen, 0, customers_per_district, (n_txns,)))


class DeliveryInputs(NamedTuple):
    w_id: torch.Tensor
    d_id: torch.Tensor
    carrier: torch.Tensor    # int32 [T] carrier id 1..10


def gen_delivery(gen: torch.Generator, n_txns: int, n_warehouses: int,
                 home_w: Optional[torch.Tensor] = None,
                 skew: Optional[Skew] = None) -> DeliveryInputs:
    w_id = _draw_w(gen, n_txns, n_warehouses, home_w, skew)
    return DeliveryInputs(w_id=w_id, d_id=_draw_d(gen, n_txns, skew),
                          carrier=_randint(gen, 1, 11, (n_txns,)))


class StockLevelInputs(NamedTuple):
    w_id: torch.Tensor
    d_id: torch.Tensor
    threshold: torch.Tensor  # int32 [T] low-stock threshold 10..20


def gen_stocklevel(gen: torch.Generator, n_txns: int, n_warehouses: int,
                   home_w: Optional[torch.Tensor] = None,
                   skew: Optional[Skew] = None) -> StockLevelInputs:
    w_id = _draw_w(gen, n_txns, n_warehouses, home_w, skew)
    return StockLevelInputs(w_id=w_id, d_id=_draw_d(gen, n_txns, skew),
                            threshold=_randint(gen, 10, 21, (n_txns,)))


class MixedInputs(NamedTuple):
    """One round of the full mix: per-thread types plus every type's
    inputs for every thread (a thread runs only its own type's)."""
    txn_type: torch.Tensor   # int32 [T] — index into TXN_TYPES
    neworder: NewOrderInputs
    payment: PaymentInputs
    orderstatus: OrderStatusInputs
    delivery: DeliveryInputs
    stocklevel: StockLevelInputs


MixedDraw = Callable[[int], MixedInputs]


def gen_mixed(gen: torch.Generator, n_txns: int, n_warehouses: int,
              n_items: int, customers_per_district: int,
              home_w: Optional[torch.Tensor], dist_degree: float,
              item_logits: torch.Tensor, mix=None,
              skew: Optional[Skew] = None) -> MixedInputs:
    """Sample one round of the full TPC-C mix (45/43/4/4/4 by default)."""
    return MixedInputs(
        txn_type=sample_mix(gen, n_txns, mix),
        neworder=gen_neworder(gen, n_txns, n_warehouses, n_items,
                              customers_per_district, home_w, dist_degree,
                              item_logits, skew=skew),
        payment=gen_payment(gen, n_txns, n_warehouses,
                            customers_per_district, home_w, skew),
        orderstatus=gen_orderstatus(gen, n_txns, n_warehouses,
                                    customers_per_district, home_w, skew),
        delivery=gen_delivery(gen, n_txns, n_warehouses, home_w, skew),
        stocklevel=gen_stocklevel(gen, n_txns, n_warehouses, home_w, skew))


def mixed_stream(cfg, gen: torch.Generator, *, mix=None,
                 skew: Optional[Skew] = None, home_w=None,
                 dist_degree: Optional[float] = None) -> MixedDraw:
    """A ``draw(round)`` source of fresh full-mix rounds for a TPC-C
    configuration, on the generator's device. ``mix``, ``skew``, pinned
    ``home_w`` and ``dist_degree`` (default ``cfg.dist_degree``) shape the
    draws as the reference driver's arguments of those names do."""
    logits = zipf_logits(cfg.n_items, cfg.skew_alpha, device=gen.device)
    dd = cfg.dist_degree if dist_degree is None else dist_degree

    def draw(round_no: int) -> MixedInputs:
        return gen_mixed(gen, cfg.n_threads, cfg.n_warehouses, cfg.n_items,
                         cfg.customers_per_district, home_w, dd, logits, mix,
                         skew)
    return draw


def neworder_stream(cfg, gen: torch.Generator) -> Draw:
    """A ``draw(round)`` source of fresh new-order batches for a TPC-C
    configuration, on the generator's device."""
    logits = zipf_logits(cfg.n_items, cfg.skew_alpha, device=gen.device)

    def draw(round_no: int) -> NewOrderInputs:
        return gen_neworder(gen, cfg.n_threads, cfg.n_warehouses,
                            cfg.n_items, cfg.customers_per_district, None,
                            cfg.dist_degree, logits)
    return draw

"""TPC-C over the NAM store (paper §7), on one memory server or on several.

One round executes one transaction per execution thread through the SI
protocol (``core/si.py``): new-order alone (:func:`run_neworder_rounds`) or
the full five-transaction mix (:func:`run_mixed_rounds`), where each type
runs as a sub-round over the threads that drew it. With an ``engine``
(:func:`make_distributed_engine`, :func:`make_mixed_engine`) the rounds run
over the pool range-partitioned on memory servers
(``store.distributed_round``, the servers a leading shard axis on one
device), with the results of the single-server rounds. The schema keeps the
reference's encodings: every column is an int32 word of an 8-word payload,
the contended hot spots are the district's ``d_next_o_id`` and the
warehouse row that payment writes, and inserts go to thread-private
extends (§5.3) as conflict-free installs.

Entry points (:func:`init_tpcc`, :func:`run_neworder_rounds`,
:func:`run_mixed_rounds`) run on the card unless ``device="cpu"`` is
passed.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch._u32 import gidx, to_i32, u64
from repro_torch.checkpoint import snapshot
from repro_torch.core import cas, gc as gc_ops, hashtable as ht, \
    header as hdr_ops, locality, mvcc, netmodel, rangeindex as ri, si, \
    store, wal
from repro_torch.core.catalog import Catalog
from repro_torch.core.si import TxnBatch
from repro_torch.core.tsoracle import VectorOracle, VectorState
from repro_torch.db import workload

WIDTH = 8          # unified payload width (int32 words)
MAX_OL = 15
DISTRICTS = 10

W_COL = {"tax": 0, "ytd": 1}
D_COL = {"tax": 0, "ytd": 1, "next_o_id": 2, "next_deliv": 3}
C_COL = {"balance": 0, "ytd_payment": 1, "payment_cnt": 2, "delivery_cnt": 3}
S_COL = {"quantity": 0, "ytd": 1, "order_cnt": 2, "remote_cnt": 3}
I_COL = {"price": 0, "im_id": 1}
O_COL = {"c_id": 0, "carrier": 1, "ol_cnt": 2, "entry_d": 3, "o_id": 4,
         "d_key": 5}
OL_COL = {"i_id": 0, "supply_w": 1, "quantity": 2, "amount": 3,
          "delivery_d": 4}
H_COL = {"amount": 0, "c_id": 1, "w_id": 2}

MAX_O_PER_DISTRICT = 1 << 14  # o_id key-space per district for index keys


@dataclasses.dataclass(frozen=True)
class TPCCConfig:
    n_warehouses: int = 4
    customers_per_district: int = 32
    n_items: int = 512
    n_threads: int = 16
    orders_per_thread: int = 128     # extend size for order inserts
    dist_degree: float = 10.0        # % distributed new-orders
    skew_alpha: Optional[float] = None
    n_old_versions: int = 2
    n_overflow: int = 2
    layout: str = "table_major"      # or "warehouse_major" (§7.3 locality)
    key_addressed: bool = False      # §5.2: item/stock reads by index key
    fused_commit: bool = False       # write side through kernels.commit
    batched_probe: bool = False      # read side through kernels.hash_probe


class TPCCLayout(NamedTuple):
    """Slot layout of the unified pool: ``table_major`` lays tables back to
    back; ``warehouse_major`` packs one block per warehouse (its records, a
    read-only item replica and the insert extends of its threads)."""
    catalog: Catalog
    order_base: int
    ol_base: int
    no_base: int
    hist_base: int
    mode: str = "table_major"
    block: int = 0
    d_off: int = 0
    c_off: int = 0
    s_off: int = 0
    i_off: int = 0
    o_off: int = 0
    ol_off: int = 0
    no_off: int = 0
    h_off: int = 0
    tpw: int = 1


class TPCCState(NamedTuple):
    nam: store.NAMStore
    order_index: ri.RangeIndex
    hist_cursor: torch.Tensor                 # int32 [n_threads]
    directory: Optional[ht.HashTable] = None  # iff cfg.key_addressed


def make_layout(cfg: TPCCConfig) -> TPCCLayout:
    if cfg.layout == "warehouse_major":
        return _make_wh_layout(cfg)
    cat = Catalog(n_servers=cfg.n_warehouses)
    cat.create_table("warehouse", cfg.n_warehouses, WIDTH, 2)
    cat.create_table("district", cfg.n_warehouses * DISTRICTS, WIDTH, 4)
    cat.create_table("customer", cfg.n_warehouses * DISTRICTS
                     * cfg.customers_per_district, WIDTH, 4)
    cat.create_table("stock", cfg.n_warehouses * cfg.n_items, WIDTH, 4)
    cat.create_table("item", cfg.n_items, WIDTH, 2)
    n_orders = cfg.n_threads * cfg.orders_per_thread
    o = cat.create_table("orders", n_orders, WIDTH, 6)
    ol = cat.create_table("order_line", n_orders * MAX_OL, WIDTH, 5)
    no = cat.create_table("new_order", n_orders, WIDTH, 2)
    h = cat.create_table("history", n_orders, WIDTH, 3)
    return TPCCLayout(catalog=cat, order_base=o.base, ol_base=ol.base,
                      no_base=no.base, hist_base=h.base)


def _make_wh_layout(cfg: TPCCConfig) -> TPCCLayout:
    if cfg.n_threads % cfg.n_warehouses:
        raise ValueError("warehouse_major needs n_threads divisible by "
                         "n_warehouses (threads are homed per warehouse)")
    tpw = cfg.n_threads // cfg.n_warehouses
    opt = cfg.orders_per_thread
    d_off = 1
    c_off = d_off + DISTRICTS
    s_off = c_off + DISTRICTS * cfg.customers_per_district
    i_off = s_off + cfg.n_items
    o_off = i_off + cfg.n_items
    ol_off = o_off + tpw * opt
    no_off = ol_off + tpw * opt * MAX_OL
    h_off = no_off + tpw * opt
    block = h_off + tpw * opt
    cat = Catalog(n_servers=cfg.n_warehouses)
    cat.create_table("wh_block", cfg.n_warehouses * block, WIDTH, 6)
    return TPCCLayout(catalog=cat, order_base=-1, ol_base=-1, no_base=-1,
                      hist_base=-1, mode="warehouse_major", block=block,
                      d_off=d_off, c_off=c_off, s_off=s_off, i_off=i_off,
                      o_off=o_off, ol_off=ol_off, no_off=no_off, h_off=h_off,
                      tpw=tpw)


# ------------------------------------------------------------- slot math ----
# Arguments are int32 tensors (or Python ints); results are int32 tensors.
def _i32(x):
    return torch.as_tensor(x).to(torch.int32)


def w_slot(lay, w):
    if lay.mode == "warehouse_major":
        return _i32(w) * lay.block
    return _i32(lay.catalog["warehouse"].base + _i32(w))


def d_slot(lay, w, d):
    if lay.mode == "warehouse_major":
        return _i32(w) * lay.block + lay.d_off + d
    return _i32(lay.catalog["district"].base + _i32(w) * DISTRICTS + d)


def c_slot(lay, cfg, w, d, c):
    if lay.mode == "warehouse_major":
        return _i32(w) * lay.block + lay.c_off \
            + d * cfg.customers_per_district + c
    return _i32(lay.catalog["customer"].base
                + (_i32(w) * DISTRICTS + d) * cfg.customers_per_district + c)


def s_slot(lay, cfg, w, i):
    if lay.mode == "warehouse_major":
        return _i32(w) * lay.block + lay.s_off + i
    return _i32(lay.catalog["stock"].base + _i32(w) * cfg.n_items + i)


def i_slot(lay, i, w=None):
    """Item read. Warehouse-major reads the executing warehouse's local
    replica, so ``w`` is required there."""
    if lay.mode == "warehouse_major":
        assert w is not None, "warehouse_major item reads need the home w"
        return _i32(w) * lay.block + lay.i_off + i
    return _i32(lay.catalog["item"].base + _i32(i))


def _tid_home(cfg, tid):
    tid = _i32(tid)
    return tid % cfg.n_warehouses, tid // cfg.n_warehouses


def o_slot_ext(lay, cfg, tid, local):
    """Order-insert extend slot of thread ``tid`` at cursor ``local``."""
    if lay.mode == "warehouse_major":
        w, r = _tid_home(cfg, tid)
        return w * lay.block + lay.o_off + r * cfg.orders_per_thread + local
    return lay.order_base + _i32(tid) * cfg.orders_per_thread + local


def no_slot_ext(lay, cfg, tid, local):
    if lay.mode == "warehouse_major":
        w, r = _tid_home(cfg, tid)
        return w * lay.block + lay.no_off + r * cfg.orders_per_thread + local
    return lay.no_base + _i32(tid) * cfg.orders_per_thread + local


def h_slot_ext(lay, cfg, tid, local):
    if lay.mode == "warehouse_major":
        w, r = _tid_home(cfg, tid)
        return w * lay.block + lay.h_off + r * cfg.orders_per_thread + local
    return lay.hist_base + _i32(tid) * cfg.orders_per_thread + local


def ol_slots_of_order(lay, cfg, oslot):
    """First order-line slot of the order stored at ``oslot``."""
    oslot = _i32(oslot)
    if lay.mode == "warehouse_major":
        blk = oslot // lay.block
        k = oslot - blk * lay.block - lay.o_off
        return blk * lay.block + lay.ol_off + k * MAX_OL
    return lay.ol_base + (oslot - lay.order_base) * MAX_OL


def order_key(w, d, o_id):
    """Order secondary-index key (a uint32 word; fits int32 at any
    supported scale)."""
    return ((w * DISTRICTS + d) * MAX_O_PER_DISTRICT + o_id).to(torch.int32)


# ------------------------------------------------------- §6.2 WAL journal ----
# Sub-round sequence numbers within one mixed round: the journal stamps each
# entry (round, seq) so that replay breaks ties of equal T in the engine's
# order (the write sub-rounds run in this order, each insert group right
# after its sub-round's SI commit).
_JSEQ_NEWORDER, _JSEQ_NEWORDER_INS, _JSEQ_PAYMENT, _JSEQ_PAYMENT_INS, \
    _JSEQ_DELIVERY = range(5)
JOURNAL_WS = 2 + MAX_OL   # widest logged statement: the new-order insert
#   group (order + new-order + up to 15 order lines in one entry)
JOURNAL_APPENDS_PER_ROUND = 5   # every executed write sub-round appends
#   one entry a thread (inactive lanes log an empty write mask)


def make_journal(cfg: TPCCConfig, oracle: VectorOracle, *,
                 capacity_rounds: int, n_replicas: int = 2,
                 device=None) -> wal.Journal:
    """A §6.2 journal for the mixed driver on ``device`` (default
    ``cuda``): a round appends at most :data:`JOURNAL_APPENDS_PER_ROUND`
    entries a thread, so the ring covers ``capacity_rounds`` rounds (a
    checkpoint interval plus slack for in-flight intents)."""
    return wal.init_journal(
        cfg.n_threads, JOURNAL_APPENDS_PER_ROUND * capacity_rounds,
        oracle.n_slots, JOURNAL_WS, WIDTH, n_replicas=n_replicas,
        device=device)


# --------------------------------------------------- §5.2 hash directory ----
# Key encodings: per-table tag in the top bits, dense rank below (uint32
# words, built in int64 and narrowed).
DIR_TAG_STOCK = 1 << 29
DIR_TAG_ITEM = 2 << 29
DIR_TAG_CUSTOMER = 3 << 29
DIR_PROBES = 32   # shared by the build and every lookup


def _key(tag, rank):
    k = tag | (torch.as_tensor(rank).to(torch.int64) & 0xFFFFFFFF)
    return torch.where(k >= 1 << 31, k - (1 << 32), k).to(torch.int32)


def stock_key(cfg: TPCCConfig, w, i):
    return _key(DIR_TAG_STOCK, _i64(w) * cfg.n_items + _i64(i))


def item_key(cfg: TPCCConfig, lay: TPCCLayout, w, i):
    """Item lookup key; warehouse-major names the executing warehouse's
    replica."""
    if lay.mode == "warehouse_major":
        return _key(DIR_TAG_ITEM, _i64(w) * cfg.n_items + _i64(i))
    return _key(DIR_TAG_ITEM, _i64(i))


def customer_key(cfg: TPCCConfig, w, d, c):
    rank = (_i64(w) * DISTRICTS + _i64(d)) * cfg.customers_per_district \
        + _i64(c)
    return _key(DIR_TAG_CUSTOMER, rank)


def _i64(x):
    return torch.as_tensor(x).to(torch.int64)


def directory_buckets(cfg: TPCCConfig, lay: TPCCLayout) -> int:
    """Next power of two ≥ 2× the entry count (load factor ≤ 0.5)."""
    items = cfg.n_warehouses * cfg.n_items \
        if lay.mode == "warehouse_major" else cfg.n_items
    entries = items + cfg.n_warehouses * cfg.n_items \
        + cfg.n_warehouses * DISTRICTS * cfg.customers_per_district
    b = 64
    while b < 2 * entries:
        b *= 2
    return b


def build_tpcc_directory(cfg: TPCCConfig, lay: TPCCLayout, *,
                         device) -> ht.HashTable:
    """Load the §5.2 hash index over every item/stock/customer record."""
    W_, I, D, C = cfg.n_warehouses, cfg.n_items, DISTRICTS, \
        cfg.customers_per_district
    ar = lambda n: torch.arange(n, dtype=torch.int32, device=device)
    wi_w = ar(W_).repeat_interleave(I)
    wi_i = ar(I).repeat(W_)
    keys = [stock_key(cfg, wi_w, wi_i)]
    slots = [s_slot(lay, cfg, wi_w, wi_i)]
    if lay.mode == "warehouse_major":
        keys.append(item_key(cfg, lay, wi_w, wi_i))
        slots.append(i_slot(lay, wi_i, wi_w))
    else:
        keys.append(item_key(cfg, lay, 0, ar(I)))
        slots.append(i_slot(lay, ar(I)))
    cw = ar(W_).repeat_interleave(D * C)
    cd = ar(D).repeat_interleave(C).repeat(W_)
    cc = ar(C).repeat(W_ * D)
    keys.append(customer_key(cfg, cw, cd, cc))
    slots.append(c_slot(lay, cfg, cw, cd, cc))
    return store.build_directory(
        torch.cat(keys), torch.cat([s.to(torch.int32) for s in slots]),
        directory_buckets(cfg, lay), max_probes=DIR_PROBES)


# ---------------------------------------------------------------- loader ----
def _insert_slots(cfg, lay, device):
    """Every slot of the insert regions (orders, new-order, history,
    order lines) of the warehouse-major layout."""
    tids = torch.arange(cfg.n_threads, dtype=torch.int32, device=device)[:, None]
    locs = torch.arange(cfg.orders_per_thread, dtype=torch.int32,
                        device=device)[None, :]
    osl = o_slot_ext(lay, cfg, tids, locs)
    olsl = (ol_slots_of_order(lay, cfg, osl)[:, :, None]
            + torch.arange(MAX_OL, device=device)).reshape(-1)
    return torch.cat([osl.reshape(-1),
                      no_slot_ext(lay, cfg, tids, locs).reshape(-1),
                      h_slot_ext(lay, cfg, tids, locs).reshape(-1),
                      olsl.to(torch.int32)])


def init_tpcc(cfg: TPCCConfig, oracle: VectorOracle,
              generator: Optional[torch.Generator] = None, *,
              device=None) -> Tuple[TPCCLayout, TPCCState]:
    """Load the TPC-C pool on ``device`` (default ``cuda``). Random columns
    (taxes, prices, stock quantities) come from ``generator`` (a generator
    on that device, seed 0 when omitted)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    lay = make_layout(cfg)
    nam = store.init_store(lay.catalog, oracle, n_old=cfg.n_old_versions,
                           n_overflow=cfg.n_overflow, width=WIDTH,
                           n_insert_regions=1, device=dev)
    data = nam.table.cur_data
    W, I, D = cfg.n_warehouses, cfg.n_items, DISTRICTS
    ar = lambda n: torch.arange(n, dtype=torch.int32, device=dev)
    rint = lambda lo, hi, n: torch.randint(lo, hi, (n,), generator=generator,
                                           device=dev, dtype=torch.int32)

    data[w_slot(lay, ar(W)).long(), W_COL["tax"]] = rint(0, 2000, W)
    dsl = d_slot(lay, ar(W).repeat_interleave(D), ar(D).repeat(W))
    data[dsl.long(), D_COL["tax"]] = rint(0, 2000, W * D)
    price = rint(100, 10000, I)
    if lay.mode == "warehouse_major":   # identical read-only replica per wh
        isl = i_slot(lay, ar(I)[None, :], ar(W)[:, None])
        data[isl.long(), I_COL["price"]] = price.expand(W, I)
    else:
        data[i_slot(lay, ar(I)).long(), I_COL["price"]] = price
    ssl = s_slot(lay, cfg, ar(W).repeat_interleave(I), ar(I).repeat(W))
    data[ssl.long(), S_COL["quantity"]] = rint(10, 101, W * I)

    # insert regions start non-existent (deleted current versions)
    if lay.mode == "warehouse_major":
        store.mark_slots_deleted(nam, _insert_slots(cfg, lay, dev))
    else:
        for name in ("orders", "order_line", "new_order", "history"):
            spec = lay.catalog[name]
            store.mark_region_deleted(nam, spec.base, spec.count)

    idx = ri.build(torch.zeros((0,), dtype=torch.int32, device=dev),
                   torch.zeros((0,), dtype=torch.int32, device=dev),
                   capacity=cfg.n_threads * cfg.orders_per_thread,
                   delta_capacity=4 * cfg.n_threads)
    directory = build_tpcc_directory(cfg, lay, device=dev) \
        if cfg.key_addressed else None
    return lay, TPCCState(
        nam=nam, order_index=idx,
        hist_cursor=torch.zeros((cfg.n_threads,), dtype=torch.int32,
                                device=dev),
        directory=directory)


def _insert_install(tbl, slots, tid_slots, cts, data, mask):
    """Conflict-free install into thread-private extends (inserts)."""
    return mvcc.install(tbl, slots, hdr_ops.pack(tid_slots, cts), data,
                        mask).table


# ------------------------------------------------------------- new-order ----
class NewOrderResult(NamedTuple):
    state: TPCCState
    committed: torch.Tensor
    snapshot_miss: torch.Tensor
    o_id: torch.Tensor
    ops: si.OpCounts
    batch: TxnBatch
    vis: si.VisStats
    journal: Optional[wal.Journal] = None


def _neworder_batch(cfg: TPCCConfig, lay: TPCCLayout,
                    inp: workload.NewOrderInputs, active=None):
    """Read-set (RS=33): [district, warehouse, customer, item*15,
    stock*15]; write-set (WS=16): district (d_next_o_id++) + up to 15
    stocks. With ``cfg.key_addressed`` the item and stock reads carry their
    §5.2 index keys. Returns ``(batch, keyed)``."""
    T = inp.w_id.shape[0]
    dev = inp.w_id.device
    act = torch.ones((T,), dtype=torch.bool, device=dev) if active is None \
        else active
    line = torch.arange(MAX_OL, device=dev)[None, :]
    line_mask = (line < inp.ol_cnt[:, None]) & act[:, None]
    dsl = d_slot(lay, inp.w_id, inp.d_id)
    wsl = w_slot(lay, inp.w_id)
    csl = c_slot(lay, cfg, inp.w_id, inp.d_id, inp.c_id)
    isl = i_slot(lay, inp.item_ids, inp.w_id[:, None])
    ssl = s_slot(lay, cfg, inp.supply_w, inp.item_ids)
    read_slots = torch.cat([dsl[:, None], wsl[:, None], csl[:, None], isl,
                            ssl], dim=1).to(torch.int32)
    read_mask = torch.cat([act[:, None].expand(T, 3), line_mask, line_mask],
                          dim=1)
    write_ref = torch.cat(
        [torch.zeros((T, 1), dtype=torch.int32, device=dev),
         (18 + line).to(torch.int32).expand(T, MAX_OL)], dim=1)
    write_mask = torch.cat([act[:, None], line_mask], dim=1)
    batch = TxnBatch(tid=torch.arange(T, dtype=torch.int32, device=dev),
                     read_slots=read_slots, read_mask=read_mask,
                     write_ref=write_ref, write_mask=write_mask)
    keyed = None
    if cfg.key_addressed:
        ikeys = item_key(cfg, lay, inp.w_id[:, None], inp.item_ids)
        skeys = stock_key(cfg, inp.supply_w, inp.item_ids)
        zk = torch.zeros((T, 3), dtype=torch.int32, device=dev)
        zm = torch.zeros((T, 3), dtype=torch.bool, device=dev)
        keyed = si.KeyedReads(
            keys=torch.cat([zk, ikeys, skeys], dim=1),
            mask=torch.cat([zm, line_mask, line_mask], dim=1))
    return batch, keyed


def _neworder_new_data(rd, inp: workload.NewOrderInputs):
    """The new-order write-set: bump d_next_o_id, restock + count stocks."""
    dist = rd[:, 0, :].clone()
    dist[:, D_COL["next_o_id"]] += 1
    stocks = rd[:, 18:, :].clone()
    q = stocks[:, :, S_COL["quantity"]]
    newq = torch.where(q - inp.qty >= 10, q - inp.qty, q - inp.qty + 91)
    stocks[:, :, S_COL["quantity"]] = newq
    stocks[:, :, S_COL["ytd"]] += inp.qty
    stocks[:, :, S_COL["order_cnt"]] += 1
    stocks[:, :, S_COL["remote_cnt"]] += inp.is_remote.to(torch.int32)
    return torch.cat([dist[:, None, :], stocks], dim=1)


def _neworder_inserts(cfg: TPCCConfig, lay: TPCCLayout, st: TPCCState,
                      oracle: VectorOracle, tbl, vec, committed, read_data,
                      inp: workload.NewOrderInputs, round_no, journal=None):
    """Order, new-order and order-line inserts into thread-private extends
    plus the order secondary index, within the transaction boundary; with
    a journal, the insert group is logged as one entry."""
    T = inp.w_id.shape[0]
    dev = inp.w_id.device
    line = torch.arange(MAX_OL, device=dev)[None, :]
    line_mask = line < inp.ol_cnt[:, None]
    tids = torch.arange(T, dtype=torch.int32, device=dev)
    o_id = read_data[:, 0, D_COL["next_o_id"]]
    slot_ids = oracle.slot_of_thread(tids)
    cts = vec[gidx(slot_ids, vec.shape[0])]   # committed threads' new cts
    cur = st.nam.extends.cursor[:, 0]
    local = cur.clamp(0, cfg.orders_per_thread - 1)
    oslot = o_slot_ext(lay, cfg, tids, local)
    noslot = no_slot_ext(lay, cfg, tids, local)
    olslot = ol_slots_of_order(lay, cfg, oslot)[:, None] + line
    can_insert = committed & (cur < cfg.orders_per_thread)

    odata = torch.zeros((T, WIDTH), dtype=torch.int32, device=dev)
    odata[:, O_COL["c_id"]] = inp.c_id
    odata[:, O_COL["carrier"]] = -1
    odata[:, O_COL["ol_cnt"]] = inp.ol_cnt
    odata[:, O_COL["entry_d"]] = round_no
    odata[:, O_COL["o_id"]] = o_id
    odata[:, O_COL["d_key"]] = inp.w_id * DISTRICTS + inp.d_id
    tbl = _insert_install(tbl, oslot, slot_ids, cts, odata, can_insert)

    nodata = torch.zeros((T, WIDTH), dtype=torch.int32, device=dev)
    nodata[:, 0] = o_id
    nodata[:, 1] = inp.w_id * DISTRICTS + inp.d_id
    tbl = _insert_install(tbl, noslot, slot_ids, cts, nodata, can_insert)

    price = read_data[:, 3:18, I_COL["price"]]
    oldata = torch.zeros((T, MAX_OL, WIDTH), dtype=torch.int32, device=dev)
    oldata[:, :, OL_COL["i_id"]] = inp.item_ids
    oldata[:, :, OL_COL["supply_w"]] = inp.supply_w
    oldata[:, :, OL_COL["quantity"]] = inp.qty
    oldata[:, :, OL_COL["amount"]] = price * inp.qty
    oldata[:, :, OL_COL["delivery_d"]] = -1
    tbl = _insert_install(
        tbl, olslot.reshape(-1),
        slot_ids[:, None].expand(T, MAX_OL).reshape(-1),
        cts[:, None].expand(T, MAX_OL).reshape(-1),
        oldata.reshape(-1, WIDTH),
        (can_insert[:, None] & line_mask).reshape(-1))

    if journal is not None:
        # one entry for the whole group: its slots are disjoint (private
        # extends), so replaying it as one install equals the three above.
        # T is the vector after the sub-round: the inserts carry its commit
        # timestamps and replay right after it (tie broken by seq)
        jslots = torch.cat([oslot[:, None], noslot[:, None],
                            olslot.to(torch.int32)], dim=1)
        jhdr = hdr_ops.pack(slot_ids, cts)[:, None, :].expand(T, 2 + MAX_OL,
                                                              2)
        jdata = torch.cat([odata[:, None, :], nodata[:, None, :], oldata],
                          dim=1)
        jmask = torch.cat([can_insert[:, None], can_insert[:, None],
                           can_insert[:, None] & line_mask], dim=1)
        wal.append_intent(
            journal, tids, vec[:journal.ts_vec.shape[-1]],
            *wal.pad_writes(journal, jslots, jhdr, jdata,
                            jmask),
            round_no=round_no, seq=_JSEQ_NEWORDER_INS)
        wal.append_outcome(journal, tids, can_insert)

    okey = order_key(inp.w_id, inp.d_id, o_id)
    idx = ri.insert(st.order_index, okey, oslot, mask=can_insert)
    cursor = st.nam.extends.cursor.clone()
    cursor[:, 0] += can_insert.to(torch.int32)
    return tbl, idx, store.ExtendState(cursor=cursor), o_id


def neworder_round(cfg: TPCCConfig, lay: TPCCLayout, st: TPCCState,
                   oracle: VectorOracle, inp: workload.NewOrderInputs,
                   rts_vec=None, round_no=0, active=None,
                   journal=None) -> NewOrderResult:
    """One batched round of new-order transactions through SI. The pool
    and the vector of ``st`` are updated in place, and so is ``journal``
    (the §6.2 WAL) when one is given."""
    batch, keyed = _neworder_batch(cfg, lay, inp, active)
    out = si.run_round(st.nam.table, oracle, st.nam.oracle_state, batch,
                       lambda rh, rd, vec: _neworder_new_data(rd, inp),
                       rts_vec=rts_vec, active=active,
                       directory=st.directory if keyed is not None else None,
                       keyed=keyed, dir_max_probes=DIR_PROBES,
                       journal=journal, journal_round=round_no,
                       journal_seq=_JSEQ_NEWORDER,
                       fused_commit=cfg.fused_commit,
                       batched_probe=cfg.batched_probe)
    tbl, idx, extends, o_id = _neworder_inserts(
        cfg, lay, st, oracle, out.table, out.oracle_state.vec, out.committed,
        out.read_data, inp, round_no, journal=journal)
    nam = st.nam._replace(table=tbl, oracle_state=out.oracle_state,
                          extends=extends)
    return NewOrderResult(
        state=st._replace(nam=nam, order_index=idx),
        committed=out.committed, snapshot_miss=out.snapshot_miss, o_id=o_id,
        ops=out.ops, batch=batch, vis=out.vis, journal=journal)


# ------------------------------------------- new-order over the NAM mesh ----
class DistEngine(NamedTuple):
    """A TPC-C executor over ``n_shards`` memory servers: ``round_fn`` is
    the ``store.distributed_round`` executor of the new-order logic over
    the padded pool (and the vector when ``shard_vector``), each server
    owning ``shard_records`` contiguous rows. ``gc_fn`` is the per-server
    §5.3 sweep; ``n_dir_buckets > 0`` makes ``round_fn`` key-addressed
    (§5.2); ``with_journal`` makes the executors take and return the §6.2
    journal (one replica a server)."""
    round_fn: Callable
    n_shards: int
    shard_records: int
    shard_vector: bool
    gc_fn: Callable
    n_dir_buckets: int
    with_journal: bool

    @property
    def placement(self) -> locality.Placement:
        return locality.Placement(n_servers=self.n_shards,
                                  shard_records=self.shard_records)


def make_distributed_engine(cfg: TPCCConfig, lay: TPCCLayout, n_shards: int,
                            oracle: VectorOracle, *,
                            shard_vector: bool = False,
                            with_journal: bool = False) -> DistEngine:
    """The new-order engine over ``n_shards`` memory servers; the
    kernel flags come from ``cfg``."""
    shard_records = -(-lay.catalog.total_records // n_shards)
    n_dir = directory_buckets(cfg, lay) if cfg.key_addressed else 0
    round_fn, _ = store.distributed_round(
        n_shards, oracle,
        lambda rh, rd, vec, aux: _neworder_new_data(rd, aux),
        shard_records, shard_vector=shard_vector, n_dir_buckets=n_dir,
        dir_max_probes=DIR_PROBES, with_journal=with_journal,
        fused_commit=cfg.fused_commit, batched_probe=cfg.batched_probe)
    gc_fn = store.distributed_gc_round(n_shards, shard_vector=shard_vector,
                                       n_vec_slots=oracle.n_slots)
    return DistEngine(round_fn=round_fn, n_shards=n_shards,
                      shard_records=shard_records, shard_vector=shard_vector,
                      gc_fn=gc_fn, n_dir_buckets=n_dir,
                      with_journal=with_journal)


def distribute_state(engine: DistEngine, st: TPCCState) -> TPCCState:
    """The loaded single-server state as the deployment over the engine's
    servers: the pool padded (new tensors unless the servers divide it; free
    the input's then), the vector padded when partitioned, the directory's
    bucket ranges checked."""
    tbl, _ = store.pad_table(st.nam.table, engine.n_shards)
    tbl = store.shard_table(engine.n_shards, tbl)
    vec = st.nam.oracle_state.vec
    if engine.shard_vector:
        vec = store.shard_vector(engine.n_shards, vec)
    directory = st.directory
    if directory is not None and engine.n_dir_buckets:
        directory = store.shard_directory(engine.n_shards, directory)
    return st._replace(nam=st.nam._replace(
        table=tbl, oracle_state=st.nam.oracle_state._replace(vec=vec)),
        directory=directory)


class MixedEngine(NamedTuple):
    """The five-transaction mix's executors over the memory servers: the
    new-order :class:`DistEngine` (``base``), one ``distributed_round``
    executor a further write type, and one ``distributed_readonly_round``
    executor the read-only types share. The placement fields are
    ``base``'s."""
    base: DistEngine
    payment_fn: Callable
    delivery_fn: Callable
    readonly_fn: Callable

    round_fn = property(lambda self: self.base.round_fn)
    n_shards = property(lambda self: self.base.n_shards)
    shard_records = property(lambda self: self.base.shard_records)
    shard_vector = property(lambda self: self.base.shard_vector)
    gc_fn = property(lambda self: self.base.gc_fn)
    n_dir_buckets = property(lambda self: self.base.n_dir_buckets)
    with_journal = property(lambda self: self.base.with_journal)
    placement = property(lambda self: self.base.placement)


def make_mixed_engine(cfg: TPCCConfig, lay: TPCCLayout, n_shards: int,
                      oracle: VectorOracle, *, shard_vector: bool = False,
                      with_journal: bool = False) -> MixedEngine:
    """The mix's executors over ``n_shards`` memory servers (the new-order
    one is :func:`make_distributed_engine`'s)."""
    base = make_distributed_engine(cfg, lay, n_shards, oracle,
                                   shard_vector=shard_vector,
                                   with_journal=with_journal)
    write_fn = lambda new_data: store.distributed_round(
        n_shards, oracle, lambda rh, rd, vec, aux: new_data(rd, aux),
        base.shard_records, shard_vector=shard_vector,
        with_journal=with_journal, fused_commit=cfg.fused_commit,
        batched_probe=cfg.batched_probe)[0]
    return MixedEngine(
        base=base, payment_fn=write_fn(_payment_new_data),
        delivery_fn=write_fn(_delivery_new_data),
        readonly_fn=store.distributed_readonly_round(
            n_shards, base.shard_records, n_dir_buckets=base.n_dir_buckets,
            dir_max_probes=DIR_PROBES))


def _n_probes(batch: TxnBatch, keyed, active):
    """§5.2 index probes of a round: the expression ``si.run_round``
    charges."""
    if keyed is None:
        return 0
    act = _active_or_ones(batch.tid.shape[0], active, batch.tid.device)
    return (keyed.mask & batch.read_mask & act[:, None]).sum()


def _dist_ops(oracle, batch: TxnBatch, out, tbl, active,
              keyed=None) -> si.OpCounts:
    """Op accounting of a round over the servers: the ``si.count_ops``
    call of the single-server round."""
    return si.count_ops(oracle, batch, out.txn_found, out.from_current,
                        out.n_installs, out.n_releases, out.committed.sum(),
                        tbl.payload_width, n_txns=_n_active(batch, active),
                        active=active,
                        n_index_probes=_n_probes(batch, keyed, active))


def _dist_vis(batch: TxnBatch, out, active) -> si.VisStats:
    """Visibility accounting of a round over the servers: the
    ``si.vis_stats`` fold of the single-server round."""
    return si.vis_stats(batch.read_mask, out.read_found, out.from_current,
                        out.from_ovf, active)


def _journal_kw(journal, round_no, seq):
    return dict(journal=journal, round_no=round_no, seq=seq) \
        if journal is not None else {}


def neworder_round_distributed(cfg: TPCCConfig, lay: TPCCLayout,
                               st: TPCCState, oracle: VectorOracle,
                               engine: DistEngine,
                               inp: workload.NewOrderInputs, round_no=0,
                               active=None, journal=None) -> NewOrderResult:
    """One new-order round through the engine's servers: the results of
    :func:`neworder_round`. Updates ``st`` (and ``journal``) in place."""
    batch, keyed = _neworder_batch(cfg, lay, inp, active)
    kw = _journal_kw(journal, round_no, _JSEQ_NEWORDER)
    if keyed is not None:
        kw.update(directory=st.directory, read_keys=keyed.keys,
                  key_mask=keyed.mask)
    tbl, vec, out = engine.round_fn(st.nam.table, st.nam.oracle_state.vec,
                                    batch, inp, active, **kw)[:3]
    ops = _dist_ops(oracle, batch, out, tbl, active, keyed)
    tbl, idx, extends, o_id = _neworder_inserts(
        cfg, lay, st, oracle, tbl, vec, out.committed, out.read_data, inp,
        round_no, journal=journal)
    nam = st.nam._replace(table=tbl,
                          oracle_state=st.nam.oracle_state._replace(vec=vec),
                          extends=extends)
    return NewOrderResult(
        state=st._replace(nam=nam, order_index=idx),
        committed=out.committed, snapshot_miss=out.snapshot_miss, o_id=o_id,
        ops=ops, batch=batch, vis=_dist_vis(batch, out, active),
        journal=journal)


# ------------------------------------------------------ sustained-run GC ----
def _gc_init(oracle, engine, gc_interval: int, gc_snapshots: int, device):
    """The GC thread's §5.3 snapshot log of a driver run: one, or one a
    memory server of ``engine`` (None when GC is off)."""
    if gc_interval <= 0:
        return None
    if engine is None:
        return gc_ops.init_log(gc_snapshots, oracle.n_slots, device=device)
    return store.init_shard_logs(engine.n_shards, gc_snapshots,
                                 oracle.n_slots, device=device)


def _gc_sweep(lay, st: TPCCState, engine, log, now, max_txn_time) -> float:
    """One GC-thread step over the pool (snapshot T_R, safe vector, sweep,
    lazy truncation), on every server of ``engine`` when given, in place.
    Returns the reclaimable fraction of the real records (not the
    padding)."""
    tbl = st.nam.table
    if engine is None:
        gc_ops.gc_round(tbl, st.nam.oracle_state.vec, log, now,
                        max_txn_time)
    else:
        engine.gc_fn(tbl, st.nam.oracle_state.vec, log, now, max_txn_time)
    return float(gc_ops.reclaimable_fraction(
        tbl, n_records=lay.catalog.total_records))


# ----------------------------------------------------- retry-queue driver ----
def _merge_retries(pending, fresh, retry_mask, T: int):
    """§7.4 retry queue: threads with a pending abort re-enter with their
    original inputs; everyone else takes fresh work. Inputs are (nested)
    NamedTuples of [T, ...] tensors."""
    if pending is None:
        return fresh

    def merge(p, f):
        if isinstance(f, torch.Tensor):
            return torch.where(retry_mask.reshape((T,) + (1,) * (f.dim() - 1)),
                               p, f)
        return type(f)(*(merge(a, b) for a, b in zip(p, f)))
    return merge(pending, fresh)


class NewOrderRunStats(NamedTuple):
    """Aggregates of a multi-round run under the §7.4 retry discipline."""
    committed: torch.Tensor     # bool [n_rounds, T]
    attempts: int
    commits: int
    retries: int
    abort_rate: float
    ops: si.OpCounts            # summed over rounds (Python floats)
    local_fraction: float       # mean over rounds; nan when not measured
    missed: torch.Tensor        # bool [n_rounds, T]
    snapshot_misses: int = 0
    contention_aborts: int = 0
    ovf_reads: int = 0
    gc_sweeps: int = 0
    reclaim_traj: tuple = ()
    ovf_peak: int = 0


def run_neworder_rounds(cfg: TPCCConfig, lay: TPCCLayout, st: TPCCState,
                        oracle: VectorOracle, draw: workload.Draw,
                        n_rounds: int, *, home_w=None,
                        engine: Optional[DistEngine] = None,
                        locality_mode: Optional[str] = None,
                        move_versions: bool = True,
                        gc_interval: int = 0, max_txn_time: int = 4,
                        gc_snapshots: int = 8, device=None):
    """Closed-loop driver: each thread runs new-orders back to back, and an
    aborted transaction re-enters the next round with its original inputs
    (§7.4). ``draw(round)`` supplies fresh inputs. ``device`` (default
    ``cuda``) must be where ``st`` lives.

    ``engine=None`` runs on one memory server; with a :class:`DistEngine`
    every round runs over its servers (``st`` from
    :func:`distribute_state`). ``locality_mode`` (``"aware"`` or
    ``"oblivious"``) measures the machine-local access share of the run
    under that §7.3 routing (the mean over rounds); under the
    warehouse-major layout it needs ``home_w`` = the thread homes the
    draws were pinned to.

    ``gc_interval > 0`` turns on sustained execution (§5.3): every
    ``gc_interval`` rounds the GC thread snapshots the vector into a log of
    ``gc_snapshots``, marks the versions no snapshot ``max_txn_time``
    rounds old can read and truncates them; the version mover then only
    advances into reclaimed overflow slots (``reuse_only``). The round
    counter is the wall clock.

    Returns ``(state, NewOrderRunStats)``; the pool is updated in place.
    """
    dev = resolve_device(device)
    if st.nam.table.cur_hdr.device.type != dev.type:
        raise ValueError(f"state lives on {st.nam.table.cur_hdr.device}, "
                         f"not on {dev}")
    T = cfg.n_threads
    _check_layout_homes(cfg, lay, home_w, locality_mode)
    placement = engine.placement if engine is not None else \
        locality.Placement(n_servers=1,
                           shard_records=lay.catalog.total_records)
    local = []
    retry_mask = torch.zeros((T,), dtype=torch.bool, device=dev)
    pending = None
    committed_rounds, missed_rounds = [], []
    attempts = commits = retries = 0
    snapshot_misses = contention_aborts = ovf_reads = ovf_peak = 0
    ops_sum = [0.0] * len(si.OpCounts._fields)
    use_gc = gc_interval > 0
    gc_log = _gc_init(oracle, engine, gc_interval, gc_snapshots, dev)
    reclaim_traj = []

    for r in range(n_rounds):
        inp = _merge_retries(pending, draw(r), retry_mask, T)
        if engine is None:
            out = neworder_round(cfg, lay, st, oracle, inp, round_no=r)
        else:
            out = neworder_round_distributed(cfg, lay, st, oracle, engine,
                                             inp, round_no=r)
        st = out.state
        if move_versions:
            mvcc.version_mover(st.nam.table, reuse_only=use_gc)
        if use_gc and (r + 1) % gc_interval == 0:
            frac = _gc_sweep(lay, st, engine, gc_log, r, max_txn_time)
            reclaim_traj.append((r, frac))

        c, miss = out.committed, out.snapshot_miss
        committed_rounds.append(c)
        missed_rounds.append(miss)
        n_c, n_miss = int(c.sum()), int(miss.sum())
        attempts += T
        commits += n_c
        retries += T - n_c
        snapshot_misses += n_miss
        contention_aborts += T - n_c - n_miss
        ovf_reads += int(out.vis.n_ovf)
        ovf_peak = max(ovf_peak, int(st.nam.table.ovf_next.max()))
        for i, f in enumerate(out.ops):
            ops_sum[i] += float(f)
        if locality_mode is not None:
            srv = locality.route_transactions(
                locality_mode, placement, d_slot(lay, inp.w_id, inp.d_id),
                out.batch.tid, T)
            local.append(locality.local_fraction(
                placement, srv, out.batch.read_slots, out.batch.read_mask))
        retry_mask = ~c
        pending = inp

    retries -= int(retry_mask.sum())
    fracs = torch.stack(local).tolist() if local else []
    stats = NewOrderRunStats(
        committed=torch.stack(committed_rounds), attempts=attempts,
        commits=commits, retries=retries,
        abort_rate=1.0 - commits / max(1, attempts),
        ops=si.OpCounts(*ops_sum),
        local_fraction=sum(fracs) / len(fracs) if fracs else float("nan"),
        missed=torch.stack(missed_rounds), snapshot_misses=snapshot_misses,
        contention_aborts=contention_aborts, ovf_reads=ovf_reads,
        gc_sweeps=len(reclaim_traj), reclaim_traj=tuple(reclaim_traj),
        ovf_peak=ovf_peak)
    return st, stats


# --------------------------------------------------------------- helpers ----
def _active_or_ones(T: int, active, device):
    return torch.ones((T,), dtype=torch.bool, device=device) \
        if active is None else active


def _n_active(batch: TxnBatch, active):
    """Transactions actually executed this (sub-)round — op accounting."""
    if active is None:
        return torch.as_tensor(batch.tid.shape[0])
    return active.sum()


def _safe_order_slot(lay: TPCCLayout, cfg: TPCCConfig) -> int:
    """A valid order slot (thread 0's first extend) for lanes with none."""
    return int(o_slot_ext(lay, cfg, 0, 0))


def _lines(device):
    return torch.arange(MAX_OL, dtype=torch.int32, device=device)


# --------------------------------------------------------------- payment ----
class PaymentResult(NamedTuple):
    state: TPCCState
    committed: torch.Tensor
    ops: si.OpCounts
    batch: TxnBatch
    snapshot_miss: torch.Tensor  # bool [T]
    vis: si.VisStats
    journal: Optional[wal.Journal] = None


def _payment_batch(cfg: TPCCConfig, lay: TPCCLayout,
                   inp: workload.PaymentInputs, active=None) -> TxnBatch:
    """RS=WS=3: [warehouse, district, customer] — all written."""
    T = inp.w_id.shape[0]
    dev = inp.w_id.device
    act = _active_or_ones(T, active, dev)
    read_slots = torch.stack(
        [w_slot(lay, inp.w_id), d_slot(lay, inp.w_id, inp.d_id),
         c_slot(lay, cfg, inp.c_w_id, inp.d_id, inp.c_id)], dim=1)
    mask = act[:, None].expand(T, 3)
    return TxnBatch(
        tid=torch.arange(T, dtype=torch.int32, device=dev),
        read_slots=read_slots.to(torch.int32), read_mask=mask,
        write_ref=torch.arange(3, dtype=torch.int32, device=dev)[None, :]
        .expand(T, 3), write_mask=mask)


def _payment_new_data(rd, inp: workload.PaymentInputs):
    """The payment write-set: w/d ytd += amount, debit the customer."""
    w, d, c = rd[:, 0, :].clone(), rd[:, 1, :].clone(), rd[:, 2, :].clone()
    w[:, W_COL["ytd"]] += inp.amount
    d[:, D_COL["ytd"]] += inp.amount
    c[:, C_COL["balance"]] -= inp.amount
    c[:, C_COL["ytd_payment"]] += inp.amount
    c[:, C_COL["payment_cnt"]] += 1
    return torch.stack([w, d, c], dim=1)


def _payment_insert(cfg, lay, st: TPCCState, oracle, tbl, vec, committed,
                    inp: workload.PaymentInputs, round_no=0, journal=None):
    """History insert into the thread-private extend, logged with a
    journal. Returns the table and the advanced history cursor."""
    T = inp.w_id.shape[0]
    dev = inp.w_id.device
    tids = torch.arange(T, dtype=torch.int32, device=dev)
    slot_ids = oracle.slot_of_thread(tids)
    cts = vec[gidx(slot_ids, vec.shape[0])]
    cur = st.hist_cursor
    hslot = h_slot_ext(lay, cfg, tids, cur.clamp(0, cfg.orders_per_thread - 1))
    can = committed & (cur < cfg.orders_per_thread)
    hdata = torch.zeros((T, WIDTH), dtype=torch.int32, device=dev)
    hdata[:, H_COL["amount"]] = inp.amount
    hdata[:, H_COL["c_id"]] = inp.c_id
    hdata[:, H_COL["w_id"]] = inp.w_id
    tbl = _insert_install(tbl, hslot, slot_ids, cts, hdata, can)
    if journal is not None:
        wal.append_intent(
            journal, tids, vec[:journal.ts_vec.shape[-1]],
            *wal.pad_writes(journal, hslot[:, None].to(torch.int32),
                            hdr_ops.pack(slot_ids, cts)[:, None, :],
                            hdata[:, None, :], can[:, None]),
            round_no=round_no, seq=_JSEQ_PAYMENT_INS)
        wal.append_outcome(journal, tids, can)
    return tbl, cur + can.to(torch.int32)


def payment_round_distributed(cfg: TPCCConfig, lay: TPCCLayout, st: TPCCState,
                              oracle: VectorOracle, engine,
                              inp: workload.PaymentInputs, active=None,
                              round_no=0, journal=None) -> PaymentResult:
    """Payment through the engine's servers: the results of
    :func:`payment_round`."""
    batch = _payment_batch(cfg, lay, inp, active)
    tbl, vec, out = engine.payment_fn(
        st.nam.table, st.nam.oracle_state.vec, batch, inp, active,
        **_journal_kw(journal, round_no, _JSEQ_PAYMENT))[:3]
    ops = _dist_ops(oracle, batch, out, tbl, active)
    tbl, hist_cursor = _payment_insert(cfg, lay, st, oracle, tbl, vec,
                                       out.committed, inp, round_no=round_no,
                                       journal=journal)
    nam = st.nam._replace(
        table=tbl, oracle_state=st.nam.oracle_state._replace(vec=vec))
    return PaymentResult(
        state=st._replace(nam=nam, hist_cursor=hist_cursor),
        committed=out.committed, ops=ops, batch=batch,
        snapshot_miss=out.snapshot_miss, vis=_dist_vis(batch, out, active),
        journal=journal)


def payment_round(cfg: TPCCConfig, lay: TPCCLayout, st: TPCCState,
                  oracle: VectorOracle, inp: workload.PaymentInputs,
                  rts_vec=None, active=None, round_no=0,
                  journal=None) -> PaymentResult:
    """One batched round of payments through SI. The pool and the vector
    of ``st`` are updated in place, and so is ``journal`` when given."""
    batch = _payment_batch(cfg, lay, inp, active)
    out = si.run_round(st.nam.table, oracle, st.nam.oracle_state, batch,
                       lambda rh, rd, vec: _payment_new_data(rd, inp),
                       rts_vec=rts_vec, active=active,
                       journal=journal, journal_round=round_no,
                       journal_seq=_JSEQ_PAYMENT,
                       fused_commit=cfg.fused_commit,
                       batched_probe=cfg.batched_probe)
    tbl, hist_cursor = _payment_insert(cfg, lay, st, oracle, out.table,
                                       out.oracle_state.vec, out.committed,
                                       inp, round_no=round_no,
                                       journal=journal)
    nam = st.nam._replace(table=tbl, oracle_state=out.oracle_state)
    return PaymentResult(
        state=st._replace(nam=nam, hist_cursor=hist_cursor),
        committed=out.committed, ops=out.ops, batch=batch,
        snapshot_miss=out.snapshot_miss, vis=out.vis, journal=journal)


# ----------------------------------------------------- read-only queries ----
def _latest_order_of(idx: ri.RangeIndex, w_id, d_id):
    """Latest order slot of (w, d) via the order index, with the
    key-ownership check (an empty district must not surface another
    district's latest order). Returns ``(oslot, found)``."""
    d_key = u64(torch.atleast_1d(torch.as_tensor(w_id)) * DISTRICTS
                + torch.as_tensor(d_id))
    hi = to_i32((d_key + 1) * MAX_O_PER_DISTRICT)
    k, oslot, idx_found = ri.lookup_max_below(idx, hi)
    return oslot, idx_found & (u64(k) // MAX_O_PER_DISTRICT == d_key)


def orderstatus(cfg: TPCCConfig, lay: TPCCLayout, st: TPCCState,
                oracle: VectorOracle, w_id, d_id, c_id):
    """Read-only: a customer and the latest order of its district
    (``w_id``/``d_id``/``c_id`` int32 tensors on the state's device).
    Returns ``(customer VisibleRead, order VisibleRead, found)``."""
    vec = oracle.read(st.nam.oracle_state)
    csl = c_slot(lay, cfg, w_id, d_id, c_id)
    cust = mvcc.read_visible(st.nam.table, torch.atleast_1d(csl), vec)
    oslot, found = _latest_order_of(st.order_index, w_id, d_id)
    ordr = mvcc.read_visible(st.nam.table, torch.where(found, oslot, 0), vec)
    return cust, ordr, found


class ReadOnlyRoundResult(NamedTuple):
    """One batched round of a read-only type: snapshot reads only, never
    validated (§1.2), op-counted. ``result`` is per transaction: the
    latest-order payload (orderstatus) or the low-stock count
    (stocklevel)."""
    result: torch.Tensor
    found: torch.Tensor          # bool [T]
    ops: si.OpCounts
    read_slots: torch.Tensor
    read_mask: torch.Tensor


def _snapshot_read(st: TPCCState, engine, vec, slots, mask, keys=None,
                   key_mask=None):
    """Visible reads of ``slots`` [T, A]: through the memory servers'
    ``readonly_fn`` when an engine is given (``found`` is then True where
    ``mask`` is not), else from the single pool by the ``hashtable.lookup``
    + ``mvcc.read_visible`` path. ``keys``/``key_mask`` resolve the marked
    reads through ``st.directory`` (§5.2); a directory miss reads as not
    found. Returns ``(data [T, A, W], found [T, A], from_current [T,
    A])``."""
    if engine is not None:
        out = engine.readonly_fn(st.nam.table, st.nam.oracle_state.vec,
                                 slots, mask, directory=st.directory,
                                 read_keys=keys, key_mask=key_mask)
        return out.read_data, out.found, out.from_current
    T, A = slots.shape
    flat = slots.reshape(-1)
    key_ok = torch.ones(flat.shape, dtype=torch.bool, device=flat.device)
    if keys is not None:
        kvals, kfound = ht.lookup(st.directory, keys.reshape(-1),
                                  max_probes=DIR_PROBES)
        km = key_mask.reshape(-1)
        flat = torch.where(km, torch.where(kfound, kvals, 0), flat)
        key_ok = ~km | kfound
    vr = mvcc.read_visible(st.nam.table, flat, vec)
    W = st.nam.table.payload_width
    return (vr.data.reshape(T, A, W), (vr.found & key_ok).reshape(T, A),
            (vr.from_current & key_ok).reshape(T, A))


def orderstatus_round(cfg: TPCCConfig, lay: TPCCLayout, st: TPCCState,
                      oracle: VectorOracle, inp: workload.OrderStatusInputs,
                      *, engine=None, active=None) -> ReadOnlyRoundResult:
    """Batched order-status: the customer (by key when
    ``cfg.key_addressed``), the district's latest order and its order lines
    (a dependent read: the line count comes out of the order payload),
    through the memory servers of ``engine`` when given."""
    T = inp.w_id.shape[0]
    dev = inp.w_id.device
    act = _active_or_ones(T, active, dev)
    vec = oracle.read(st.nam.oracle_state)
    csl = c_slot(lay, cfg, inp.w_id, inp.d_id, inp.c_id)
    oslot, found = _latest_order_of(st.order_index, inp.w_id, inp.d_id)
    found = found & act
    slots = torch.stack([csl, torch.where(found, oslot, 0)], dim=1) \
        .to(torch.int32)
    mask = torch.stack([act, found], dim=1)
    keys = kmask = None
    n_probes = 0
    if cfg.key_addressed:   # the order rides the range index, resolved
        keys = torch.stack(
            [customer_key(cfg, inp.w_id, inp.d_id, inp.c_id),
             torch.zeros((T,), dtype=torch.int32, device=dev)], dim=1)
        kmask = torch.stack(
            [act, torch.zeros((T,), dtype=torch.bool, device=dev)], dim=1)
        n_probes = (kmask & mask).sum()
    data, _, fcur = _snapshot_read(st, engine, vec, slots, mask, keys, kmask)
    order = data[:, 1, :]
    olslot = ol_slots_of_order(
        lay, cfg, torch.where(found, oslot, _safe_order_slot(lay, cfg))
    )[:, None] + _lines(dev)
    line_mask = (_lines(dev)[None, :] < order[:, O_COL["ol_cnt"], None]) \
        & found[:, None]
    _, _, ol_cur = _snapshot_read(st, engine, vec, olslot, line_mask)
    slots = torch.cat([slots, olslot], dim=1)
    mask = torch.cat([mask, line_mask], dim=1)
    fcur = torch.cat([fcur, ol_cur], dim=1)
    ops = si.count_readonly_ops(oracle, mask, fcur, act.sum(),
                                st.nam.table.payload_width,
                                n_index_probes=n_probes)
    return ReadOnlyRoundResult(result=order, found=found, ops=ops,
                               read_slots=slots, read_mask=mask)


def _distinct_low(low, items, n_items: int):
    """Per row, the number of distinct ``items`` where ``low`` holds — the
    reference's scatter-max into ``[T, n_items]`` with ``mode="drop"``:
    negative ids wrap once, ids still out of range go to a sink column."""
    idx = torch.where(low, items, n_items).to(torch.int64)
    idx = torch.where(idx < 0, idx + n_items, idx)
    idx = torch.where((idx >= 0) & (idx < n_items), idx, n_items)
    marked = torch.zeros(idx.shape[:-1] + (n_items + 1,), dtype=torch.int32,
                         device=idx.device)
    marked.scatter_(-1, idx, 1)
    return marked[..., :n_items].sum(dim=-1).to(torch.int32)


def stocklevel_round(cfg: TPCCConfig, lay: TPCCLayout, st: TPCCState,
                     oracle: VectorOracle, inp: workload.StockLevelInputs,
                     *, engine=None, active=None,
                     last_n: int = 8) -> ReadOnlyRoundResult:
    """Batched stock-level: distinct items with low stock among the last
    ``last_n`` orders' lines of (w, d) — a dependent-read chain (district →
    index scan → order lines → stocks, by key when ``cfg.key_addressed``),
    through the memory servers of ``engine`` when given."""
    T = inp.w_id.shape[0]
    dev = inp.w_id.device
    act = _active_or_ones(T, active, dev)
    vec = oracle.read(st.nam.oracle_state)
    dsl = d_slot(lay, inp.w_id, inp.d_id).to(torch.int32)
    ddata, _, dcur = _snapshot_read(st, engine, vec, dsl[:, None],
                                    act[:, None])
    next_o = ddata[:, 0, D_COL["next_o_id"]]
    lo = order_key(inp.w_id, inp.d_id, (next_o - last_n).clamp(min=0))
    hi = order_key(inp.w_id, inp.d_id, next_o)
    k, oslots, _ = ri.range_scan(st.order_index, lo, hi, max_results=last_n)
    valid = (k != ri.SENTINEL) & (oslots >= 0) & act[:, None]
    oslots = torch.where(valid, oslots, _safe_order_slot(lay, cfg))
    ol = (ol_slots_of_order(lay, cfg, oslots.reshape(-1))[:, None]
          + _lines(dev)).reshape(T, last_n * MAX_OL)
    ol_mask = valid.repeat_interleave(MAX_OL, dim=1)
    ol_data, ol_found, ol_cur = _snapshot_read(st, engine, vec, ol, ol_mask)
    ol_ok = ol_found & ol_mask
    items = ol_data[:, :, OL_COL["i_id"]]
    w_bc = inp.w_id[:, None].expand_as(items)
    safe_items = torch.where(ol_ok, items, 0)
    ssl = s_slot(lay, cfg, w_bc, safe_items)
    skeys = skmask = None
    n_probes = 0
    if cfg.key_addressed:   # stocks are fetched by key (§5.2)
        skeys, skmask = stock_key(cfg, w_bc, safe_items), ol_ok
        n_probes = (skmask & ol_ok).sum()
    s_data, s_found, s_cur = _snapshot_read(st, engine, vec, ssl, ol_ok,
                                            skeys, skmask)
    low = ol_ok & s_found \
        & (s_data[:, :, S_COL["quantity"]] < inp.threshold[:, None])
    counts = _distinct_low(low, items, cfg.n_items)
    mask = torch.cat([act[:, None], ol_mask, ol_ok], dim=1)
    fcur = torch.cat([dcur, ol_cur, s_cur], dim=1)
    slots = torch.cat([dsl[:, None], ol, ssl], dim=1)
    ops = si.count_readonly_ops(oracle, mask, fcur, act.sum(),
                                st.nam.table.payload_width,
                                n_index_probes=n_probes)
    return ReadOnlyRoundResult(result=counts, found=act, ops=ops,
                               read_slots=slots, read_mask=mask)


def stocklevel(cfg: TPCCConfig, lay: TPCCLayout, st: TPCCState,
               oracle: VectorOracle, w_id, d_id, threshold: int,
               last_n: int = 20):
    """Read-only: distinct items in the last ``last_n`` orders' lines of
    one district (``w_id``/``d_id`` 0-d int32 tensors on the state's
    device) whose stock is below ``threshold``; an int32 0-d tensor."""
    vec = oracle.read(st.nam.oracle_state)
    tbl = st.nam.table
    dev = tbl.cur_hdr.device
    dist = mvcc.read_visible(tbl, torch.atleast_1d(d_slot(lay, w_id, d_id)),
                             vec)
    next_o = dist.data[0, D_COL["next_o_id"]]
    lo = order_key(w_id, d_id, (next_o - last_n).clamp(min=0))
    hi = order_key(w_id, d_id, next_o)
    k, oslots, _ = ri.range_scan(st.order_index, lo[None], hi[None],
                                 max_results=last_n)
    oslots = torch.where(oslots[0] >= 0, oslots[0],
                         _safe_order_slot(lay, cfg))
    ol = (ol_slots_of_order(lay, cfg, oslots)[:, None]
          + _lines(dev)[None, :]).reshape(-1)
    olr = mvcc.read_visible(tbl, ol, vec)
    items = olr.data[:, OL_COL["i_id"]]
    ol_ok = olr.found & (k[0] != ri.SENTINEL).repeat_interleave(MAX_OL)
    stk = mvcc.read_visible(
        tbl, s_slot(lay, cfg, torch.as_tensor(w_id).expand_as(items), items),
        vec)
    low = ol_ok & stk.found & (stk.data[:, S_COL["quantity"]] < threshold)
    return _distinct_low(low, items, cfg.n_items)


# -------------------------------------------------------------- delivery ----
class DeliveryResult(NamedTuple):
    state: TPCCState
    committed: torch.Tensor      # bool [T] — outcome (vacuous if no order)
    delivered: torch.Tensor      # bool [T] — committed AND an order found
    ops: si.OpCounts
    batch: TxnBatch
    snapshot_miss: torch.Tensor  # bool [T]
    vis: si.VisStats
    journal: Optional[wal.Journal] = None


class DeliveryAux(NamedTuple):
    carrier: torch.Tensor     # int32 [T]
    line_mask: torch.Tensor   # bool [T, MAX_OL] — the order's real lines


def _delivery_prepare(cfg: TPCCConfig, lay: TPCCLayout, st: TPCCState,
                      vec, inp: workload.DeliveryInputs, active=None):
    """Locate the oldest undelivered order of (w, d) with snapshot
    pre-reads (district cursor → index → order payload), then build the SI
    batch. Read-set (RS=3+15): [district, order, customer, order lines];
    write-set (WS=3): district cursor, order carrier, customer balance.
    Returns ``(batch, aux, found)``."""
    T = inp.w_id.shape[0]
    dev = inp.w_id.device
    act = _active_or_ones(T, active, dev)
    tbl = st.nam.table
    dsl = d_slot(lay, inp.w_id, inp.d_id).to(torch.int32)
    pre = mvcc.read_visible(tbl, dsl, vec)
    deliv_o = pre.data[:, D_COL["next_deliv"]]
    has_order = deliv_o < pre.data[:, D_COL["next_o_id"]]
    okey = order_key(inp.w_id, inp.d_id, deliv_o)
    k, oslot, idx_found = ri.lookup_max_below(st.order_index,
                                              to_i32(u64(okey) + 1))
    found = idx_found & (k == okey) & has_order & act
    oslot = torch.where(found, oslot, _safe_order_slot(lay, cfg))
    ordr = mvcc.read_visible(tbl, oslot, vec)
    c_id = ordr.data[:, O_COL["c_id"]]
    ol_cnt = ordr.data[:, O_COL["ol_cnt"]]
    csl = c_slot(lay, cfg, inp.w_id, inp.d_id, torch.where(found, c_id, 0))
    olslot = ol_slots_of_order(lay, cfg, oslot)[:, None] + _lines(dev)
    line_mask = (_lines(dev)[None, :] < ol_cnt[:, None]) & found[:, None]
    read_slots = torch.cat([dsl[:, None], oslot[:, None], csl[:, None],
                            olslot], dim=1).to(torch.int32)
    read_mask = torch.cat([act[:, None], found[:, None], found[:, None],
                           line_mask], dim=1)
    batch = TxnBatch(
        tid=torch.arange(T, dtype=torch.int32, device=dev),
        read_slots=read_slots, read_mask=read_mask,
        write_ref=torch.arange(3, dtype=torch.int32, device=dev)[None, :]
        .expand(T, 3), write_mask=found[:, None].expand(T, 3))
    aux = DeliveryAux(carrier=inp.carrier.to(torch.int32).expand(T),
                      line_mask=line_mask)
    return batch, aux, found


def _delivery_new_data(rd, aux: DeliveryAux):
    """The delivery write-set: advance the district's delivery cursor,
    stamp the carrier, credit the customer with the order's line amounts
    (an int32 sum that wraps as the reference's does)."""
    d, o, c = rd[:, 0, :].clone(), rd[:, 1, :].clone(), rd[:, 2, :].clone()
    d[:, D_COL["next_deliv"]] += 1
    o[:, O_COL["carrier"]] = aux.carrier
    amount = to_i32(torch.where(aux.line_mask, rd[:, 3:, OL_COL["amount"]],
                                0).sum(dim=1))
    c[:, C_COL["balance"]] += amount
    c[:, C_COL["delivery_cnt"]] += 1
    return torch.stack([d, o, c], dim=1)


def _delivery_preread_ops(ops: si.OpCounts, n_active, payload_width):
    """Charge the two dependent snapshot pre-reads (district cursor, order
    payload) that locate the order before the SI round."""
    n_pre = 2 * n_active
    return ops._replace(record_reads=ops.record_reads + n_pre,
                        bytes_moved=ops.bytes_moved
                        + n_pre * (8 + 4 * payload_width))


def delivery_round(cfg: TPCCConfig, lay: TPCCLayout, st: TPCCState,
                   oracle: VectorOracle, inp: workload.DeliveryInputs,
                   rts_vec=None, active=None, round_no=0,
                   journal=None) -> DeliveryResult:
    """Deliver the oldest undelivered order of (w, d): bump the district's
    delivery cursor, stamp the order's carrier, credit the customer. The
    pre-reads locate the order; the SI round re-reads and validates the
    district version, so a race aborts. Updates ``st`` in place, and
    ``journal`` when given."""
    vec = oracle.read(st.nam.oracle_state) if rts_vec is None else rts_vec
    batch, aux, found = _delivery_prepare(cfg, lay, st, vec, inp, active)
    out = si.run_round(st.nam.table, oracle, st.nam.oracle_state, batch,
                       lambda rh, rd, v: _delivery_new_data(rd, aux),
                       rts_vec=rts_vec, active=active,
                       journal=journal, journal_round=round_no,
                       journal_seq=_JSEQ_DELIVERY,
                       fused_commit=cfg.fused_commit,
                       batched_probe=cfg.batched_probe)
    nam = st.nam._replace(table=out.table, oracle_state=out.oracle_state)
    ops = _delivery_preread_ops(out.ops, _n_active(batch, active),
                                out.table.payload_width)
    return DeliveryResult(
        state=st._replace(nam=nam), committed=out.committed,
        delivered=out.committed & found, ops=ops, batch=batch,
        snapshot_miss=out.snapshot_miss, vis=out.vis, journal=journal)


def delivery_round_distributed(cfg: TPCCConfig, lay: TPCCLayout,
                               st: TPCCState, oracle: VectorOracle, engine,
                               inp: workload.DeliveryInputs, active=None,
                               round_no=0, journal=None) -> DeliveryResult:
    """Delivery through the engine's servers: the results of
    :func:`delivery_round` (the pre-reads gather from the whole padded
    pool, as the reference's gather from the sharded one)."""
    vec = oracle.read(st.nam.oracle_state)
    batch, aux, found = _delivery_prepare(cfg, lay, st, vec, inp, active)
    tbl, nvec, out = engine.delivery_fn(
        st.nam.table, st.nam.oracle_state.vec, batch, aux, active,
        **_journal_kw(journal, round_no, _JSEQ_DELIVERY))[:3]
    ops = _delivery_preread_ops(_dist_ops(oracle, batch, out, tbl, active),
                                _n_active(batch, active), tbl.payload_width)
    nam = st.nam._replace(
        table=tbl, oracle_state=st.nam.oracle_state._replace(vec=nvec))
    return DeliveryResult(
        state=st._replace(nam=nam), committed=out.committed,
        delivered=out.committed & found, ops=ops, batch=batch,
        snapshot_miss=out.snapshot_miss, vis=_dist_vis(batch, out, active),
        journal=journal)


# ------------------------------------------- §6.2 failure injection ----------
class FailureInjector(NamedTuple):
    """Kill memory server ``dead_server`` at the start of round
    ``kill_round`` of :func:`run_mixed_rounds` (§6.2): its memory is lost;
    the system restores the last checkpoint, replays the surviving
    journals, releases abandoned locks and resumes. ``in_flight`` also
    simulates the §3.2 crash window: the round's new-order lanes have
    locked their write-sets and logged their intents when the failure hits,
    and their outcomes never land; the driver re-executes the round after
    the recovery with the same draw."""
    kill_round: int
    dead_server: int = 0
    in_flight: bool = True


class RecoveryReport(NamedTuple):
    """What one §6.2 recovery did (on ``MixedRunStats.recovery``)."""
    kill_round: int
    dead_server: int
    checkpoint_round: int    # round after which the restored ckpt was taken
    replayed_entries: int    # committed journal entries re-installed
    undetermined: int        # intent-without-outcome entries replay skipped
    released_locks: int      # abandoned locks the monitor released
    recovery_seconds: float  # wall clock: halt to workload resumed


def _mem_state(st: TPCCState, jnl: wal.Journal):
    """What a checkpoint covers: the pool, the vector and the journal's
    append counts at the cut (``used``, replay's ``since``)."""
    return {"table": st.nam.table, "vec": st.nam.oracle_state.vec,
            "used": jnl.used}


def _inflight_intents(cfg: TPCCConfig, lay: TPCCLayout, st: TPCCState,
                      jnl: wal.Journal, inp: workload.MixedInputs,
                      round_no: int):
    """The crash window, in place: the round's new-order lanes (of the
    merged inputs ``inp``) lock their write-sets and log their intents;
    the failure hits before any outcome lands."""
    batch, _ = _neworder_batch(cfg, lay, inp.neworder, inp.txn_type == 0)
    tbl = st.nam.table
    RS = batch.read_slots.shape[1]
    wref = batch.write_ref.clamp(0, RS - 1).to(torch.int64)
    wslots = batch.read_slots.gather(1, wref)
    req_active = batch.write_mask.reshape(-1)
    req_slots = wslots.reshape(-1)
    # at a round boundary nothing is locked: every arbitration winner locks
    expected = tbl.cur_hdr[gidx(torch.where(req_active, req_slots, 0),
                                tbl.n_records)]
    prio = batch.tid[:, None].expand(batch.write_mask.shape).reshape(-1)
    # analysis: safe(W01): deliberate crash window — locks stay abandoned
    cas.arbitrate(tbl.cur_hdr, req_slots, expected, prio, req_active)
    # the intent lands on every replica, the outcome never does; the
    # payload is irrelevant, since these entries never replay
    wal.append_intent(
        jnl, batch.tid, st.nam.oracle_state.vec[:jnl.ts_vec.shape[-1]],
        *wal.pad_writes(jnl, wslots,
                        torch.zeros(wslots.shape + (2,), dtype=torch.int32,
                                    device=wslots.device),
                        torch.zeros(wslots.shape + (WIDTH,),
                                    dtype=torch.int32, device=wslots.device),
                        batch.write_mask),
        round_no=round_no, seq=_JSEQ_NEWORDER)


def _check_recoverable(st: TPCCState):
    """Recovery rebuilds the vector alone (from the checkpoint and the
    commit records), so the oracle's state must be the vector alone."""
    if not isinstance(st.nam.oracle_state, VectorState):
        raise ValueError(
            f"§6.2 recovery rebuilds a VectorState, not the "
            f"{type(st.nam.oracle_state).__name__} of this oracle (the "
            f"naive adapter's global counter and ctsList are not in the "
            f"checkpoint or the journal)")


def recover_from_failure(cfg: TPCCConfig, lay: TPCCLayout, st: TPCCState,
                         engine, jnl: wal.Journal, checkpoint_dir: str,
                         failure: FailureInjector, *, use_gc: bool,
                         move_versions: bool = True):
    """§6.2 recovery of the dead memory server: restore the last checkpoint
    onto the state's device, replay the surviving journal replicas onto it
    (ordered by the logged T, the version mover at round boundaries),
    rebuild the vector from the checkpoint's and the commit records,
    release abandoned locks, re-replicate the journal (in place).

    With an ``engine`` only the dead server's rows (its view of the padded
    pool) take the replayed reconstruction; the surviving servers keep
    their live memory, which still holds the locks of in-flight
    (undetermined) transactions — the monitor's to release. ``engine=None``
    is one server, whose whole pool is rebuilt. Returns ``(state,
    RecoveryReport)``; the state holds the rebuilt vector (and, on one
    server, the restored table)."""
    _check_recoverable(st)
    t0 = time.perf_counter()
    dead = failure.dead_server
    n_rep = jnl.n_replicas
    if engine is not None and dead >= engine.n_shards:
        raise ValueError(f"dead_server {dead} outside the "
                         f"{engine.n_shards}-server mesh")
    survivors = torch.ones((n_rep,), dtype=torch.bool)
    survivors[dead % n_rep] = False
    rep = 0 if dead % n_rep else 1    # first surviving replica

    ckpt, _, manifest = snapshot.restore(checkpoint_dir, _mem_state(st, jnl))
    since = ckpt["used"]
    tbl = wal.replay(jnl, ckpt["table"], survivors=survivors, since=since,
                     reuse_only=use_gc, move_versions=move_versions)
    vec = wal.replay_vector(jnl, ckpt["vec"], survivors=survivors,
                            since=since)
    replayable, undetermined = wal.entry_status(jnl, rep, since=since)
    if engine is not None:
        # only the dead server's rows are lost: the replayed reconstruction
        # replaces them in the survivors' live memory
        Rs = engine.shard_records
        for live, rec in zip(store.shard_view(st.nam.table, dead, Rs),
                             store.shard_view(tbl, dead, Rs)):
            live.copy_(rec)
        tbl = st.nam.table
    n_locked = int(hdr_ops.is_locked(tbl.cur_hdr).sum())
    # the monitor scans every thread's journal: any unresolved intent in
    # the live window marks an abandoned transaction whose locks must go
    wal.release_abandoned_locks(
        jnl, tbl, torch.arange(cfg.n_threads, device=jnl.used.device),
        replica=rep)
    wal.rereplicate(jnl, survivors)
    if engine is not None:
        store.shard_table(engine.n_shards, tbl)
        store.shard_journal(engine.n_shards, jnl)
        if engine.shard_vector:
            vec = store.shard_vector(engine.n_shards, vec)
    st = st._replace(nam=st.nam._replace(
        table=tbl, oracle_state=st.nam.oracle_state._replace(vec=vec)))
    report = RecoveryReport(
        kill_round=failure.kill_round, dead_server=dead,
        checkpoint_round=int(manifest["extra"].get("round", -1)),
        replayed_entries=int(replayable.sum()),
        undetermined=int(undetermined.sum()),
        released_locks=n_locked - int(hdr_ops.is_locked(tbl.cur_hdr).sum()),
        recovery_seconds=time.perf_counter() - t0)
    return st, report


# ------------------------------------------------------- online scale-out ----
class MeshGrowth(NamedTuple):
    """Grow the engine to ``new_shards`` memory servers at the start of
    round ``grow_round`` of :func:`run_mixed_rounds` (online scale-out,
    §4.3): a planned §6.2 failover — checkpoint epoch, journal replay,
    repartition, cutover. The workload keeps its retry queues and draws."""
    grow_round: int
    new_shards: int


class ScaleOutReport(NamedTuple):
    """What one online expansion did (on ``MixedRunStats.growth``)."""
    grow_round: int
    old_shards: int
    new_shards: int
    checkpoint_round: int    # round after which the migration ckpt was taken
    replayed_entries: int    # journal entries replayed over the window
    moved_slots: int         # pool slots that changed owning server
    moved_buckets: int       # §5.2 directory buckets that changed owner
    migration_seconds: float  # wall clock: halt to workload resumed


def scale_out(cfg: TPCCConfig, lay: TPCCLayout, st: TPCCState,
              oracle: VectorOracle, engine, jnl: wal.Journal,
              checkpoint_dir: str, growth: MeshGrowth, *, use_gc: bool,
              move_versions: bool = True, gc_log=None):
    """Online expansion onto more memory servers (§4.3), on the device.

    1. **Checkpoint epoch.** Restore the last checkpoint and replay the
       journal onto it (every replica is live): the state of every record
       at the join point.
    2. **Repartition.** The moved record ranges
       (``locality.moved_slots``), vector slots and directory buckets
       (``hashtable.moved_buckets``, counted) change owner; moved ranges
       take the replayed reconstruction, the rest keeps its live memory.
    3. **Cutover.** The pool trimmed to R and re-padded, the vector
       re-padded, the journal grown to a replica a server and the snapshot
       logs copied (``store.expand_mesh``), the executors rebuilt, and the
       new epoch checkpointed, so a later failure restores its shapes.

    Returns ``(state, journal, engine, gc_log, ScaleOutReport)``: a new
    journal (the caller's keeps the old replicas) and new tensors for the
    pool and the vector."""
    t0 = time.perf_counter()
    old_n, new_n = engine.n_shards, growth.new_shards
    if new_n <= old_n:
        raise ValueError(f"scale_out grows the mesh: new_shards ({new_n}) "
                         f"must exceed the current {old_n}")
    R, n_slots = lay.catalog.total_records, oracle.n_slots
    dev = st.nam.table.cur_hdr.device

    # ---- 1. checkpoint epoch + migration-window replay -------------------
    ckpt, _, manifest = snapshot.restore(checkpoint_dir, _mem_state(st, jnl))
    since = ckpt["used"]
    recon_tbl = wal.replay(jnl, ckpt["table"], since=since,
                           reuse_only=use_gc, move_versions=move_versions)
    recon_vec = wal.replay_vector(jnl, ckpt["vec"], since=since)
    replayable, _ = wal.entry_status(jnl, 0, since=since)

    # ---- 2. repartition: moved ranges take the replayed reconstruction ---
    new_placement = locality.Placement(n_servers=new_n,
                                       shard_records=-(-R // new_n))
    moved = locality.moved_slots(engine.placement, new_placement, R,
                                 device=dev)
    tbl = mvcc.VersionedTable(*(
        torch.where(moved.reshape((-1,) + (1,) * (live.dim() - 1)),
                    rec[:R], live[:R])
        for live, rec in zip(st.nam.table, recon_tbl)))
    del recon_tbl
    sl = torch.arange(n_slots, device=dev)
    vec_moved = sl // -(-n_slots // old_n) != sl // -(-n_slots // new_n)
    vec = torch.where(vec_moved, recon_vec[:n_slots],
                      st.nam.oracle_state.vec[:n_slots])
    n_moved_buckets = int(ht.moved_buckets(
        engine.n_dir_buckets, old_n, new_n, device=dev).sum()) \
        if engine.n_dir_buckets else 0

    # ---- 3. cutover: re-place onto the grown mesh, rebuild executors -----
    make = make_mixed_engine if isinstance(engine, MixedEngine) \
        else make_distributed_engine
    new_engine = make(cfg, lay, new_n, oracle,
                      shard_vector=engine.shard_vector,
                      with_journal=engine.with_journal)
    tbl, vec, directory, jnl, gc_log = store.expand_mesh(
        new_n, tbl, vec, n_records=R, vector_sharded=engine.shard_vector,
        directory=st.directory if engine.n_dir_buckets else None,
        journal=jnl, gc_logs=gc_log)
    st = st._replace(
        nam=st.nam._replace(
            table=tbl, oracle_state=st.nam.oracle_state._replace(vec=vec)),
        directory=directory if directory is not None else st.directory)
    snapshot.save(checkpoint_dir, _mem_state(st, jnl),
                  extra={"round": growth.grow_round - 1, "n_shards": new_n})
    report = ScaleOutReport(
        grow_round=growth.grow_round, old_shards=old_n, new_shards=new_n,
        checkpoint_round=int(manifest["extra"].get("round", -1)),
        replayed_entries=int(replayable.sum()),
        moved_slots=int(moved.sum()), moved_buckets=n_moved_buckets,
        migration_seconds=time.perf_counter() - t0)
    return st, jnl, new_engine, gc_log, report


# ----------------------------------------------------- mixed-round driver ----
class MixedRunStats(NamedTuple):
    """Aggregates of a full five-transaction-mix run (§7: new-order is
    reported out of the total). Per-type dicts are keyed by the names in
    ``workload.TXN_TYPES``."""
    attempts: dict              # executed txns (incl. retries)
    commits: dict
    retries: dict               # aborted txns re-entered later
    ops: dict                   # si.OpCounts of Python floats
    total_attempts: int
    total_commits: int
    abort_rate: float           # 1 - commits/attempts
    local_fraction: float       # access-weighted machine-local share
    delivered: int              # deliveries that found and delivered
    snapshot_misses: dict = None
    contention_aborts: dict = None
    ovf_reads: dict = None      # reads served by the overflow region
    gc_sweeps: int = 0
    reclaim_traj: tuple = ()    # ((round, reclaimable_fraction), ...)
    ovf_peak: int = 0           # max overflow ring position observed
    recovery: tuple = ()        # (RecoveryReport, ...), one a failure
    growth: tuple = ()          # (ScaleOutReport, ...), one an expansion


def _check_layout_homes(cfg: TPCCConfig, lay: TPCCLayout, home_w,
                        locality_mode):
    """Under the warehouse-major layout a thread's insert extends live in
    block ``tid % n_warehouses``; a locality measurement needs transactions
    to execute there, so any other ``home_w`` is rejected."""
    if locality_mode is None or lay.mode != "warehouse_major":
        return
    expected = locality.thread_homes(cfg.n_threads, cfg.n_warehouses)
    if home_w is None or not bool(
            (torch.as_tensor(home_w).to(torch.int32).cpu() == expected)
            .all()):
        raise ValueError(
            "measuring locality under the warehouse_major layout requires "
            "home_w = locality.thread_homes(n_threads, n_warehouses): "
            "thread tid's insert extends live in block tid % n_warehouses")


def run_mixed_rounds(cfg: TPCCConfig, lay: TPCCLayout, st: TPCCState,
                     oracle: VectorOracle, draw: workload.MixedDraw,
                     n_rounds: int, *, home_w=None,
                     engine: Optional[MixedEngine] = None,
                     locality_mode: Optional[str] = None,
                     move_versions: bool = True, stock_last_n: int = 8,
                     gc_interval: int = 0, max_txn_time: int = 4,
                     gc_snapshots: int = 8,
                     journal: Optional[wal.Journal] = None,
                     checkpoint_dir: Optional[str] = None,
                     failure: Optional[FailureInjector] = None,
                     growth: Optional[MeshGrowth] = None,
                     device=None):
    """Closed-loop driver for the full TPC-C mix.

    Each round ``draw(round)`` gives every thread its transaction type and
    inputs; the round runs five type-homogeneous sub-rounds (new-order,
    payment, delivery, then the read-only order-status and stock-level)
    over the threads of each type, and skips a type no thread drew. The
    §7.4 retry queue is per type: an aborted write transaction re-enters
    the next round with its original type and inputs. Read-only types never
    validate and never abort. ``locality_mode`` (``"aware"`` or
    ``"oblivious"``) measures the machine-local access share; under the
    warehouse-major layout it needs ``home_w`` = the thread homes the
    draws were pinned to. ``device`` (default ``cuda``) must be where
    ``st`` lives. ``engine=None`` runs on one memory server; with a
    :class:`MixedEngine` every sub-round runs over its servers (``st``
    from :func:`distribute_state`).

    ``gc_interval``, ``max_txn_time`` and ``gc_snapshots`` are the §5.3
    knobs of :func:`run_neworder_rounds`: one GC sweep every
    ``gc_interval`` rounds, after all five sub-rounds. ``journal`` turns
    the §6.2 WAL on: every write sub-round logs its intents before it
    installs and its outcomes after the decision, in place (with an
    engine, build it ``with_journal`` and give the journal a replica a
    server). ``checkpoint_dir`` then checkpoints the pool, the vector and
    the journal's cursors before round 0 and after every GC sweep, so
    replay never spans a truncation. ``failure`` kills a memory server at
    the start of its ``kill_round`` and runs :func:`recover_from_failure`
    before the round; the reports are ``MixedRunStats.recovery``.
    ``growth`` grows the engine onto more servers at the start of its
    ``grow_round`` (:func:`scale_out`, which needs the journal and the
    checkpoints; the caller's journal keeps the old replicas from then on);
    the reports are ``MixedRunStats.growth``. With
    ``failure.in_flight`` the driver calls ``draw(kill_round)`` twice (the
    crash window, then the round itself), so ``draw`` must be a pure
    function of the round: the driver raises if the two draws differ.

    Returns ``(state, MixedRunStats)``; the pool is updated in place (after
    a recovery, the returned state holds the restored tensors).
    """
    dev = resolve_device(device)
    if st.nam.table.cur_hdr.device.type != dev.type:
        raise ValueError(f"state lives on {st.nam.table.cur_hdr.device}, "
                         f"not on {dev}")
    T = cfg.n_threads
    _check_layout_homes(cfg, lay, home_w, locality_mode)
    placement = engine.placement if engine is not None else \
        locality.Placement(n_servers=1,
                           shard_records=lay.catalog.total_records)
    names = workload.TXN_TYPES
    tids = torch.arange(T, dtype=torch.int32, device=dev)
    # per sub-round counters stay on the device until the end of the run:
    # [executed, committed, aborted, snapshot misses, overflow reads, ops…]
    rows = {n: [] for n in names}
    delivered, ovf_peaks, local = [], [], []
    pending_type = torch.full((T,), -1, dtype=torch.int32, device=dev)
    pending = None
    use_gc = gc_interval > 0
    gc_log = _gc_init(oracle, engine, gc_interval, gc_snapshots, dev)
    reclaim_traj, recovery, growth_reports = [], [], []
    jnl = journal
    if failure is not None:
        if jnl is None or checkpoint_dir is None:
            raise ValueError("failure injection needs a journal and a "
                             "checkpoint_dir: §6.2 recovery replays the "
                             "surviving journals onto the last checkpoint")
        _check_recoverable(st)
    if jnl is not None and engine is not None and not engine.with_journal:
        raise ValueError("journaling through the mesh needs an engine "
                         "built with with_journal=True")
    if growth is not None:
        if engine is None or jnl is None or checkpoint_dir is None:
            raise ValueError("online scale-out needs a mesh engine, a "
                             "journal and a checkpoint_dir: §4.3 migration "
                             "replays the journal onto the last checkpoint")
        if not 0 <= growth.grow_round < n_rounds:
            raise ValueError(f"grow_round {growth.grow_round} outside the "
                             f"{n_rounds}-round run")
        if growth.new_shards <= engine.n_shards:
            raise ValueError(f"new_shards ({growth.new_shards}) must exceed "
                             f"the current mesh ({engine.n_shards})")
    if jnl is not None and checkpoint_dir is not None:
        snapshot.save(checkpoint_dir, _mem_state(st, jnl),
                      extra={"round": -1})

    def acc(name, act, committed, ops, snap_miss=None, vis=None):
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        aborted = act & ~committed
        rows[name].append(torch.stack([
            act.sum(), committed.sum(), aborted.sum(),
            zero if snap_miss is None else (snap_miss & act).sum(),
            zero if vis is None else vis.n_ovf.to(torch.int64),
            *(torch.as_tensor(f, device=dev).to(torch.int64)
              for f in ops)]))
        return aborted

    def acc_local(w_id, d_id, slots, mask):
        if locality_mode is not None:
            srv = locality.route_transactions(
                locality_mode, placement, d_slot(lay, w_id, d_id), tids, T)
            local.append(torch.stack([
                locality.local_fraction(placement, srv, slots, mask)
                .to(torch.float64), mask.sum().to(torch.float64)]))

    for r in range(n_rounds):
        crash_draw = None
        if failure is not None and r == failure.kill_round:
            if failure.in_flight:
                crash_draw = draw(r)
                _inflight_intents(cfg, lay, st, jnl, _merge_retries(
                    pending, crash_draw, pending_type >= 0, T), r)
            st, rep = recover_from_failure(
                cfg, lay, st, engine, jnl, checkpoint_dir, failure,
                use_gc=use_gc, move_versions=move_versions)
            recovery.append(rep)
        if growth is not None and r == growth.grow_round:
            st, jnl, engine, gc_log, grep = scale_out(
                cfg, lay, st, oracle, engine, jnl, checkpoint_dir, growth,
                use_gc=use_gc, move_versions=move_versions, gc_log=gc_log)
            placement = engine.placement
            growth_reports.append(grep)
        fresh = draw(r)
        if crash_draw is not None and not _same_inputs(crash_draw, fresh):
            raise ValueError(
                f"draw({r}) gave other inputs on its second call: with "
                f"an in-flight failure draw must be a pure function of "
                f"the round")
        inp = _merge_retries(pending, fresh, pending_type >= 0, T)
        ttype = inp.txn_type
        n_of = torch.bincount(ttype.to(torch.int64),
                              minlength=len(names)).tolist()
        aborted = torch.zeros((T,), dtype=torch.bool, device=dev)

        # ---- write transactions, one type-homogeneous sub-round each ----
        if n_of[0]:
            act = ttype == 0
            if engine is None:
                out = neworder_round(cfg, lay, st, oracle, inp.neworder,
                                     round_no=r, active=act, journal=jnl)
            else:
                out = neworder_round_distributed(
                    cfg, lay, st, oracle, engine, inp.neworder, round_no=r,
                    active=act, journal=jnl)
            st = out.state
            aborted |= acc("neworder", act, out.committed, out.ops,
                           out.snapshot_miss, out.vis)
            acc_local(inp.neworder.w_id, inp.neworder.d_id,
                      out.batch.read_slots, out.batch.read_mask)
        if n_of[1]:
            act = ttype == 1
            if engine is None:
                pay = payment_round(cfg, lay, st, oracle, inp.payment,
                                    active=act, round_no=r, journal=jnl)
            else:
                pay = payment_round_distributed(
                    cfg, lay, st, oracle, engine, inp.payment, active=act,
                    round_no=r, journal=jnl)
            st = pay.state
            aborted |= acc("payment", act, pay.committed, pay.ops,
                           pay.snapshot_miss, pay.vis)
            acc_local(inp.payment.w_id, inp.payment.d_id,
                      pay.batch.read_slots, pay.batch.read_mask)
        if n_of[3]:
            act = ttype == 3
            if engine is None:
                dl = delivery_round(cfg, lay, st, oracle, inp.delivery,
                                    active=act, round_no=r, journal=jnl)
            else:
                dl = delivery_round_distributed(
                    cfg, lay, st, oracle, engine, inp.delivery, active=act,
                    round_no=r, journal=jnl)
            st = dl.state
            aborted |= acc("delivery", act, dl.committed, dl.ops,
                           dl.snapshot_miss, dl.vis)
            delivered.append(dl.delivered.sum())
            acc_local(inp.delivery.w_id, inp.delivery.d_id,
                      dl.batch.read_slots, dl.batch.read_mask)

        # ---- read-only transactions: snapshot reads, never abort ---------
        if n_of[2]:
            act = ttype == 2
            ro = orderstatus_round(cfg, lay, st, oracle, inp.orderstatus,
                                   engine=engine, active=act)
            acc("orderstatus", act, act, ro.ops)
            acc_local(inp.orderstatus.w_id, inp.orderstatus.d_id,
                      ro.read_slots, ro.read_mask)
        if n_of[4]:
            act = ttype == 4
            sl = stocklevel_round(cfg, lay, st, oracle, inp.stocklevel,
                                  engine=engine, active=act,
                                  last_n=stock_last_n)
            acc("stocklevel", act, act, sl.ops)
            acc_local(inp.stocklevel.w_id, inp.stocklevel.d_id,
                      sl.read_slots, sl.read_mask)

        pending_type = torch.where(aborted, ttype, -1)
        pending = inp
        if move_versions:
            mvcc.version_mover(st.nam.table, reuse_only=use_gc)
        if use_gc and (r + 1) % gc_interval == 0:
            frac = _gc_sweep(lay, st, engine, gc_log, r, max_txn_time)
            reclaim_traj.append((r, frac))
            if jnl is not None and checkpoint_dir is not None:
                # a checkpoint at every sweep: replay from the last one
                # never spans a truncation
                snapshot.save(checkpoint_dir, _mem_state(st, jnl),
                              extra={"round": r})
        ovf_peaks.append(st.nam.table.ovf_next.max())

    attempts, commits, retries = {}, {}, {}
    snapshot_misses, contention_aborts, ovf_reads, ops = {}, {}, {}, {}
    left = torch.bincount((pending_type + 1).to(torch.int64),
                          minlength=len(names) + 1).tolist()[1:]
    for i, n in enumerate(names):
        tot = torch.stack(rows[n]).sum(dim=0).tolist() if rows[n] \
            else [0] * (5 + len(si.OpCounts._fields))
        attempts[n], commits[n] = tot[0], tot[1]
        # the last round's aborts never re-entered a later round
        retries[n] = tot[2] - left[i]
        snapshot_misses[n] = tot[3]
        contention_aborts[n] = tot[2] - tot[3]
        ovf_reads[n] = tot[4]
        ops[n] = si.OpCounts(*(float(f) for f in tot[5:]))
    lf_local = lf_total = 0.0
    for frac, n_acc in (torch.stack(local).tolist() if local else ()):
        lf_local += frac * n_acc
        lf_total += n_acc
    total_attempts = sum(attempts.values())
    total_commits = sum(commits.values())
    stats = MixedRunStats(
        attempts=attempts, commits=commits, retries=retries, ops=ops,
        total_attempts=total_attempts, total_commits=total_commits,
        abort_rate=1.0 - total_commits / max(1, total_attempts),
        local_fraction=lf_local / lf_total if lf_total else float("nan"),
        delivered=int(torch.stack(delivered).sum()) if delivered else 0,
        snapshot_misses=snapshot_misses,
        contention_aborts=contention_aborts, ovf_reads=ovf_reads,
        gc_sweeps=len(reclaim_traj), reclaim_traj=tuple(reclaim_traj),
        ovf_peak=max([0] + torch.stack(ovf_peaks).tolist())
        if ovf_peaks else 0, recovery=tuple(recovery),
        growth=tuple(growth_reports))
    return st, stats


def _same_inputs(a, b) -> bool:
    """Whether two (nested) NamedTuples of tensors hold equal values."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return all(_same_inputs(x, y) for x, y in zip(a, b))


# extra conflict-free extend installs per commit, invisible to OpCounts:
# new-order inserts order + new-order + ~10 order lines + index entry;
# payment appends one history record
EXTRA_INSTALLS = {"neworder": 13.0, "payment": 1.0}
READ_ONLY_TYPES = ("orderstatus", "stocklevel")


def mixed_profiles(stats: MixedRunStats):
    """Per-type cost-model profiles and the attempt-share-weighted mix
    profile that feeds ``netmodel.namdb_throughput``."""
    per_type = {
        n: netmodel.profile_from_ops(
            stats.ops[n], stats.attempts[n],
            extra_installs=EXTRA_INSTALLS.get(n, 0.0)
            * stats.commits[n] / max(1, stats.attempts[n]),
            read_only=n in READ_ONLY_TYPES)
        for n in workload.TXN_TYPES}
    total = max(1, stats.total_attempts)
    shares = {n: stats.attempts[n] / total for n in workload.TXN_TYPES}
    return per_type, netmodel.combine_profiles(per_type, shares)


def neworder_share(stats: MixedRunStats) -> float:
    """New-order commits as a fraction of all commits (the paper's 6.5 M
    of 14.5 M split)."""
    return stats.commits["neworder"] / max(1, stats.total_commits)

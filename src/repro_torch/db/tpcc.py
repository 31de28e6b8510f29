"""TPC-C new-order over the NAM store (paper §7), single memory server.

One round executes one new-order transaction per execution thread through
the SI protocol (``core/si.py``). The schema keeps the reference's
encodings: every column is an int32 word of an 8-word payload, the
contended hot spot is the district's ``d_next_o_id``, and inserts go to
thread-private extends (§5.3) as conflict-free installs.

Entry points (:func:`init_tpcc`, :func:`run_neworder_rounds`) run on the
card unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch._u32 import gidx
from repro_torch.core import hashtable as ht, header as hdr_ops, mvcc, \
    rangeindex as ri, si, store
from repro_torch.core.catalog import Catalog
from repro_torch.core.si import TxnBatch
from repro_torch.core.tsoracle import VectorOracle
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
                      inp: workload.NewOrderInputs, round_no):
    """Order, new-order and order-line inserts into thread-private extends
    plus the order secondary index, within the transaction boundary."""
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

    okey = order_key(inp.w_id, inp.d_id, o_id)
    idx = ri.insert(st.order_index, okey, oslot, mask=can_insert)
    cursor = st.nam.extends.cursor.clone()
    cursor[:, 0] += can_insert.to(torch.int32)
    return tbl, idx, store.ExtendState(cursor=cursor), o_id


def neworder_round(cfg: TPCCConfig, lay: TPCCLayout, st: TPCCState,
                   oracle: VectorOracle, inp: workload.NewOrderInputs,
                   rts_vec=None, round_no=0, active=None) -> NewOrderResult:
    """One batched round of new-order transactions through SI. The pool
    and the vector of ``st`` are updated in place."""
    batch, keyed = _neworder_batch(cfg, lay, inp, active)
    out = si.run_round(st.nam.table, oracle, st.nam.oracle_state, batch,
                       lambda rh, rd, vec: _neworder_new_data(rd, inp),
                       rts_vec=rts_vec, active=active,
                       directory=st.directory if keyed is not None else None,
                       keyed=keyed, dir_max_probes=DIR_PROBES,
                       fused_commit=cfg.fused_commit,
                       batched_probe=cfg.batched_probe)
    tbl, idx, extends, o_id = _neworder_inserts(
        cfg, lay, st, oracle, out.table, out.oracle_state.vec, out.committed,
        out.read_data, inp, round_no)
    nam = st.nam._replace(table=tbl, oracle_state=out.oracle_state,
                          extends=extends)
    return NewOrderResult(
        state=st._replace(nam=nam, order_index=idx),
        committed=out.committed, snapshot_miss=out.snapshot_miss, o_id=o_id,
        ops=out.ops, batch=batch, vis=out.vis)


# ----------------------------------------------------- retry-queue driver ----
def _merge_retries(pending, fresh, retry_mask, T: int):
    """§7.4 retry queue: threads with a pending abort re-enter with their
    original inputs; everyone else takes fresh work."""
    if pending is None:
        return fresh
    return type(fresh)(*(
        torch.where(retry_mask.reshape((T,) + (1,) * (f.dim() - 1)), p, f)
        for p, f in zip(pending, fresh)))


class NewOrderRunStats(NamedTuple):
    """Aggregates of a multi-round run under the §7.4 retry discipline."""
    committed: torch.Tensor     # bool [n_rounds, T]
    attempts: int
    commits: int
    retries: int
    abort_rate: float
    ops: si.OpCounts            # summed over rounds (Python floats)
    local_fraction: float       # nan: no locality measurement on this path
    missed: torch.Tensor        # bool [n_rounds, T]
    snapshot_misses: int = 0
    contention_aborts: int = 0
    ovf_reads: int = 0
    gc_sweeps: int = 0
    reclaim_traj: tuple = ()
    ovf_peak: int = 0


def run_neworder_rounds(cfg: TPCCConfig, lay: TPCCLayout, st: TPCCState,
                        oracle: VectorOracle, draw: workload.Draw,
                        n_rounds: int, *, move_versions: bool = True,
                        device=None):
    """Closed-loop driver on one memory server: each thread runs new-orders
    back to back, and an aborted transaction re-enters the next round with
    its original inputs (§7.4). ``draw(round)`` supplies fresh inputs.
    ``device`` (default ``cuda``) must be where ``st`` lives.

    Returns ``(state, NewOrderRunStats)``; the pool is updated in place.
    """
    dev = resolve_device(device)
    if st.nam.table.cur_hdr.device.type != dev.type:
        raise ValueError(f"state lives on {st.nam.table.cur_hdr.device}, "
                         f"not on {dev}")
    T = cfg.n_threads
    retry_mask = torch.zeros((T,), dtype=torch.bool, device=dev)
    pending = None
    committed_rounds, missed_rounds = [], []
    attempts = commits = retries = 0
    snapshot_misses = contention_aborts = ovf_reads = ovf_peak = 0
    ops_sum = [0.0] * len(si.OpCounts._fields)

    for r in range(n_rounds):
        inp = _merge_retries(pending, draw(r), retry_mask, T)
        out = neworder_round(cfg, lay, st, oracle, inp, round_no=r)
        st = out.state
        if move_versions:
            mvcc.version_mover(st.nam.table)

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
        retry_mask = ~c
        pending = inp

    retries -= int(retry_mask.sum())
    stats = NewOrderRunStats(
        committed=torch.stack(committed_rounds), attempts=attempts,
        commits=commits, retries=retries,
        abort_rate=1.0 - commits / max(1, attempts),
        ops=si.OpCounts(*ops_sum), local_fraction=float("nan"),
        missed=torch.stack(missed_rounds), snapshot_misses=snapshot_misses,
        contention_aborts=contention_aborts, ovf_reads=ovf_reads,
        ovf_peak=ovf_peak)
    return st, stats

"""Plain PyTorch TPC-C under NAM-DB's round semantics: the benchmark's
reference.

It imports nothing of the program. It rebuilds the pool from the seed the
program's load was given and runs the same rounds on the same inputs, with
the semantics the configuration states:

* A round runs the threads' transactions in type-homogeneous sub-rounds
  (new-order, payment, delivery, then the read-only order-status and
  stock-level), each over the threads that drew the type; a type no thread
  drew is skipped.
* A write sub-round (Snapshot Isolation through the timestamp vector, one
  slot a thread): read the vector; read the newest version of every record
  in the read-set that is visible under it and not deleted (the current
  version, else the K-slot old ring newest first, else the overflow ring);
  a transaction missing a read aborts. Its commit timestamp is its slot +
  1. Each written record goes to the lowest thread id among the
  transactions that write it this sub-round, and only if the header it read
  is still installed (compare-and-swap of the whole header), and only if
  the old-ring slot the current version would move to is free (moved). A
  transaction commits when every write is granted: the old current version
  moves to the ring, the new one is installed, the slot takes the commit
  timestamp. Inserts go to the thread's own extent slots, after the commit,
  stamped with the new vector entry.
* Read-only sub-rounds read the newest visible versions and never abort.
* After a round, the version mover copies each record's oldest unmoved old
  version into the overflow ring, at most one a record, and with GC on only
  into a reclaimed (deleted) overflow slot. Every ``gc_interval`` rounds the
  GC thread logs the vector with the round number, takes the element-wise
  max of the logged vectors at least ``max_txn_time`` rounds old, and
  deletes every overflow version that an older visible version beside a
  newer visible one makes unreachable (then zeroes it).
* An aborted write transaction re-enters the next round with its inputs
  (the retry queue); each driver call starts with an empty queue and an
  empty GC log, its rounds numbered from 0.
* The order index keeps the ``4 · n_threads`` smallest order keys ever
  inserted (it never merges into a larger base).

Headers are held as (meta, commit timestamp) int32 pairs, meta = thread id
<< 3 | moved << 2 | deleted << 1 | locked. Every timestamp of these runs
stays below 2^31, so signed comparisons are the protocol's unsigned ones.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

LOCKED, DELETED, MOVED = 1, 2, 4
WIDTH, MAX_OL, DISTRICTS = 8, 15, 10
MAX_O = 1 << 14                      # order ids a district key spans
SENTINEL = (1 << 32) - 1             # an empty order-index entry
# payload columns
W_TAX, W_YTD = 0, 1
D_TAX, D_YTD, D_NEXT_O, D_NEXT_DELIV = 0, 1, 2, 3
C_BAL, C_YTD_PAY, C_PAY_CNT, C_DELIV_CNT = 0, 1, 2, 3
S_QTY, S_YTD, S_ORDER_CNT, S_REMOTE_CNT = 0, 1, 2, 3
I_PRICE = 0
O_C_ID, O_CARRIER, O_OL_CNT, O_ENTRY_D, O_O_ID, O_D_KEY = 0, 1, 2, 3, 4, 5
OL_I_ID, OL_SUPPLY_W, OL_QTY, OL_AMOUNT, OL_DELIV_D = 0, 1, 2, 3, 4
TYPES = ("neworder", "payment", "orderstatus", "delivery", "stocklevel")


class Layout(NamedTuple):
    """Table-major slots of the pool: the tables back to back."""
    W: int
    C: int
    I: int
    T: int
    opt: int
    district: int
    customer: int
    stock: int
    item: int
    orders: int
    order_line: int
    new_order: int
    history: int
    R: int

    @staticmethod
    def of(cfg: dict) -> "Layout":
        W, C, I, T = (cfg["n_warehouses"], cfg["customers_per_district"],
                      cfg["n_items"], cfg["n_threads"])
        opt = cfg["orders_per_thread"]
        sizes = [W, W * DISTRICTS, W * DISTRICTS * C, W * I, I, T * opt,
                 T * opt * MAX_OL, T * opt, T * opt]
        bases = [0]
        for n in sizes:
            bases.append(bases[-1] + n)
        return Layout(W, C, I, T, opt, *bases[1:9], R=bases[9])

    def w(self, w):
        return w

    def d(self, w, d):
        return self.district + w * DISTRICTS + d

    def c(self, w, d, c):
        return self.customer + (w * DISTRICTS + d) * self.C + c

    def s(self, w, i):
        return self.stock + w * self.I + i

    def i(self, i):
        return self.item + i

    def ol_of(self, oslot):
        return self.order_line + (oslot - self.orders) * MAX_OL


def _i64(x):
    return x.to(torch.int64)


class RefTPCC:
    """The reference's database: the pool, the vector, the extents'
    cursors and the order index, on ``device``."""

    def __init__(self, cfg: dict, device, *, grant_all: bool = False):
        """``grant_all`` breaks the stated guarantee that a write-write
        conflict never commits twice: every write is granted (the control
        of the comparison)."""
        self.cfg, self.dev = cfg, torch.device(device)
        self.lay = L = Layout.of(cfg)
        self.K, self.KO = cfg["n_old_versions"], cfg["n_overflow"]
        self.T = L.T
        self.grant_all = grant_all
        R, K, KO, dev = L.R, self.K, self.KO, self.dev
        z = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)
        self.cur_meta, self.cur_cts, self.cur_data = z(R), z(R), z(R, WIDTH)
        self.old_meta = torch.full((R, K), MOVED, dtype=torch.int32,
                                   device=dev)
        self.old_cts, self.old_data = z(R, K), z(R, K, WIDTH)
        self.nw = z(R)
        self.ovf_meta = torch.full((R, KO), DELETED, dtype=torch.int32,
                                   device=dev)
        self.ovf_cts, self.ovf_data = z(R, KO), z(R, KO, WIDTH)
        self.on = z(R)
        self.vec = z(L.T)
        self.o_cursor, self.h_cursor = z(L.T), z(L.T)
        D = 4 * L.T
        self.idx_keys = torch.full((D,), SENTINEL, dtype=torch.int64,
                                   device=dev)
        self.idx_vals = torch.full((D,), -1, dtype=torch.int64, device=dev)
        self.tids = torch.arange(L.T, device=dev)

    # ------------------------------------------------------------ load ----
    def load(self, seed: int):
        """The initial columns from the load's seed: warehouse and district
        taxes, item prices and stock quantities, drawn in that order; the
        insert extents start deleted."""
        L, dev = self.lay, self.dev
        g = torch.Generator(device=dev).manual_seed(seed)
        rint = lambda lo, hi, n: torch.randint(lo, hi, (n,), generator=g,
                                               device=dev, dtype=torch.int32)
        W, I = L.W, L.I
        self.cur_data[0:W, W_TAX] = rint(0, 2000, W)
        self.cur_data[L.district:L.customer, D_TAX] = rint(0, 2000,
                                                           W * DISTRICTS)
        self.cur_data[L.item:L.item + I, I_PRICE] = rint(100, 10000, I)
        self.cur_data[L.stock:L.item, S_QTY] = rint(10, 101, W * I)
        self.cur_meta[L.orders:] = DELETED
        return self

    # ------------------------------------------------------ visibility ----
    def _visible(self, meta, cts, vec):
        tid = (meta >> 3).clamp(max=vec.shape[0] - 1).long()
        return (cts <= vec[tid]) & ((meta & DELETED) == 0)

    def read(self, slots, vec):
        """The newest version of each slot visible under ``vec``: (meta,
        cts, data, found)."""
        s = slots.long()
        cm, cc, cd = self.cur_meta[s], self.cur_cts[s], self.cur_data[s]
        cur_ok = self._visible(cm, cc, vec)
        meta, cts, data, found = cm.clone(), cc.clone(), cd.clone(), cur_ok
        todo = ~found
        if not bool(todo.any()):
            return meta, cts, data, found
        for ring, nxt, n in ((("old_meta", "old_cts", "old_data"), self.nw,
                              self.K),
                             (("ovf_meta", "ovf_cts", "ovf_data"), self.on,
                              self.KO)):
            rm, rc, rd = (getattr(self, a) for a in ring)
            for age in range(n):
                pos = torch.remainder(nxt[s].long() - 1 - age, n)
                m, c = rm[s, pos], rc[s, pos]
                ok = self._visible(m, c, vec) & todo
                if ring[0] == "old_meta":   # a never-written old slot
                    ok &= ~((c == 0) & ((m >> 3) == 0) & ((m & MOVED) != 0))
                meta = torch.where(ok, m, meta)
                cts = torch.where(ok, c, cts)
                data = torch.where(ok[:, None], rd[s, pos], data)
                found = found | ok
                todo = todo & ~ok
        return meta, cts, data, found

    # -------------------------------------------------------- installs ----
    def _install(self, slots, tid, cts, data, mask):
        """Install new current versions at the masked slots whose next
        old-ring slot is free; returns which did."""
        s = slots.long()
        pos = torch.remainder(self.nw[s].long(), self.K)
        free = (self.old_meta[s, pos] & MOVED) != 0
        do = mask & free
        s, pos = s[do], pos[do]
        self.old_meta[s, pos] = self.cur_meta[s] & ~(LOCKED | MOVED)
        self.old_cts[s, pos] = self.cur_cts[s]
        self.old_data[s, pos] = self.cur_data[s]
        self.nw[s] += 1
        self.cur_meta[s] = (tid[do] << 3).to(torch.int32)
        self.cur_cts[s] = cts[do].to(torch.int32)
        self.cur_data[s] = data[do]
        return do

    def si_round(self, read_slots, read_mask, write_ref, write_mask,
                 compute, active):
        """One write sub-round. Returns (committed, snapshot_miss,
        read_data)."""
        T, RS = read_slots.shape
        WS = write_ref.shape[1]
        vec = self.vec.clone()
        meta, cts, data, found = self.read(read_slots.reshape(-1), vec)
        meta, cts = meta.reshape(T, RS), cts.reshape(T, RS)
        data, found = data.reshape(T, RS, WIDTH), found.reshape(T, RS)
        txn_found = (found | ~read_mask).all(dim=1)
        new = compute(data)
        txn_ok = txn_found & active
        new_cts = vec + 1
        ref = write_ref.long()
        ws = read_slots.long().gather(1, ref).reshape(-1)
        exp_m = meta.gather(1, ref).reshape(-1)
        exp_c = cts.gather(1, ref).reshape(-1)
        req = (write_mask & txn_ok[:, None]).reshape(-1)
        tid = self.tids[:, None].expand(T, WS).reshape(-1)
        if self.grant_all:
            effective = req.clone()
        else:
            owner = torch.full((self.lay.R,), T, dtype=torch.int64,
                               device=self.dev)
            owner.scatter_reduce_(0, ws[req], tid[req], "amin")
            won = req & (owner[ws] == tid)
            granted = won & (exp_m == self.cur_meta[ws]) \
                & (exp_c == self.cur_cts[ws]) \
                & ((self.cur_meta[ws] & LOCKED) == 0)
            pos = torch.remainder(self.nw[ws].long(), self.K)
            effective = granted & ((self.old_meta[ws, pos] & MOVED) != 0)
        fails = torch.zeros(T, dtype=torch.int64, device=self.dev)
        fails.index_add_(0, tid, (req & ~effective).long())
        committed = txn_ok & (fails == 0)
        do = effective & committed[tid]
        self._install(ws, tid, new_cts[tid], new.reshape(-1, WIDTH), do)
        self.vec = torch.where(committed, torch.maximum(self.vec, new_cts),
                               self.vec)
        return committed, ~txn_found, data

    # ---------------------------------------------------- order index ----
    def _index_insert(self, keys, vals, mask):
        k = torch.cat([self.idx_keys, torch.where(mask, keys, SENTINEL)])
        v = torch.cat([self.idx_vals, torch.where(mask, vals, -1)])
        order = torch.sort(k, stable=True).indices[:self.idx_keys.shape[0]]
        self.idx_keys, self.idx_vals = k[order], v[order]

    def _max_below(self, hi):
        """Largest indexed key < ``hi`` per query: (key, val, found)."""
        ok = (self.idx_keys[None, :] < hi[:, None]) \
            & (self.idx_keys[None, :] != SENTINEL)
        masked = torch.where(ok, self.idx_keys[None, :], -1)
        best = masked.argmax(dim=1)
        found = ok.any(dim=1)
        return (torch.where(found, self.idx_keys[best], 0),
                torch.where(found, self.idx_vals[best], -1), found)

    def _scan(self, lo, hi, n):
        """The ``n`` smallest indexed keys in ``[lo, hi)`` per query:
        (keys, vals), SENTINEL / -1 padded."""
        k = self.idx_keys[None, :]
        ok = (k >= lo[:, None]) & (k < hi[:, None])
        keys = torch.where(ok, k, SENTINEL)
        order = torch.sort(keys, dim=1, stable=True).indices[:, :n]
        vals = torch.where(ok, self.idx_vals[None, :], -1)
        return keys.gather(1, order), vals.gather(1, order)

    # ------------------------------------------------------ sub-rounds ----
    def _safe_oslot(self):
        return self.lay.orders

    def neworder(self, inp, act, round_no):
        L, T, dev = self.lay, self.T, self.dev
        w, d, c = _i64(inp.w_id), _i64(inp.d_id), _i64(inp.c_id)
        items, supply = _i64(inp.item_ids), _i64(inp.supply_w)
        line = torch.arange(MAX_OL, device=dev)
        lines = (line[None, :] < inp.ol_cnt[:, None]) & act[:, None]
        slots = torch.cat([L.d(w, d)[:, None], L.w(w)[:, None],
                           L.c(w, d, c)[:, None], L.i(items),
                           L.s(supply, items)], dim=1)
        rmask = torch.cat([act[:, None].expand(T, 3), lines, lines], dim=1)
        wref = torch.cat([torch.zeros((T, 1), dtype=torch.int64, device=dev),
                          (18 + line)[None, :].expand(T, MAX_OL)], dim=1)
        wmask = torch.cat([act[:, None], lines], dim=1)

        def compute(rd):
            dist = rd[:, 0].clone()
            dist[:, D_NEXT_O] += 1
            st = rd[:, 18:].clone()
            q = st[:, :, S_QTY] - inp.qty
            st[:, :, S_QTY] = torch.where(q >= 10, q, q + 91)
            st[:, :, S_YTD] += inp.qty
            st[:, :, S_ORDER_CNT] += 1
            st[:, :, S_REMOTE_CNT] += inp.is_remote.to(torch.int32)
            return torch.cat([dist[:, None], st], dim=1)

        committed, miss, rd = self.si_round(slots, rmask, wref, wmask,
                                            compute, act)
        # inserts: order, new-order and order lines in the thread's extents
        o_id = rd[:, 0, D_NEXT_O]
        cts = self.vec
        cur = self.o_cursor
        local = _i64(cur.clamp(0, L.opt - 1))
        oslot = L.orders + self.tids * L.opt + local
        noslot = L.new_order + self.tids * L.opt + local
        olslot = L.ol_of(oslot)[:, None] + line[None, :]
        can = committed & (cur < L.opt)
        d_key = (inp.w_id * DISTRICTS + inp.d_id).to(torch.int32)
        zero = lambda *s: torch.zeros(s, dtype=torch.int32, device=dev)
        od = zero(T, WIDTH)
        od[:, O_C_ID], od[:, O_CARRIER], od[:, O_OL_CNT] = inp.c_id, -1, \
            inp.ol_cnt
        od[:, O_ENTRY_D], od[:, O_O_ID], od[:, O_D_KEY] = round_no, o_id, \
            d_key
        nd = zero(T, WIDTH)
        nd[:, 0], nd[:, 1] = o_id, d_key
        ld = zero(T, MAX_OL, WIDTH)
        ld[:, :, OL_I_ID], ld[:, :, OL_SUPPLY_W] = inp.item_ids, inp.supply_w
        ld[:, :, OL_QTY] = inp.qty
        ld[:, :, OL_AMOUNT] = rd[:, 3:18, I_PRICE] * inp.qty
        ld[:, :, OL_DELIV_D] = -1
        self._install(oslot, self.tids, cts, od, can)
        self._install(noslot, self.tids, cts, nd, can)
        line_in = line[None, :] < inp.ol_cnt[:, None]   # the order's lines
        self._install(olslot.reshape(-1),
                      self.tids[:, None].expand(T, MAX_OL).reshape(-1),
                      cts[:, None].expand(T, MAX_OL).reshape(-1),
                      ld.reshape(-1, WIDTH),
                      (can[:, None] & line_in).reshape(-1))
        okey = ((_i64(inp.w_id) * DISTRICTS + _i64(inp.d_id)) * MAX_O
                + _i64(o_id))
        self._index_insert(okey, oslot, can)
        self.o_cursor = cur + can.to(torch.int32)
        return {"committed": committed, "snapshot_miss": miss,
                "o_id": torch.where(committed, o_id, 0)}

    def payment(self, inp, act, round_no):
        L, T, dev = self.lay, self.T, self.dev
        w, d = _i64(inp.w_id), _i64(inp.d_id)
        slots = torch.stack([L.w(w), L.d(w, d),
                             L.c(_i64(inp.c_w_id), d, _i64(inp.c_id))], dim=1)
        mask = act[:, None].expand(T, 3)
        wref = torch.arange(3, device=dev)[None, :].expand(T, 3)

        def compute(rd):
            out = rd.clone()
            out[:, 0, W_YTD] += inp.amount
            out[:, 1, D_YTD] += inp.amount
            out[:, 2, C_BAL] -= inp.amount
            out[:, 2, C_YTD_PAY] += inp.amount
            out[:, 2, C_PAY_CNT] += 1
            return out

        committed, miss, _ = self.si_round(slots, mask, wref, mask, compute,
                                           act)
        cur = self.h_cursor
        hslot = L.history + self.tids * L.opt + _i64(cur.clamp(0, L.opt - 1))
        can = committed & (cur < L.opt)
        hd = torch.zeros((T, WIDTH), dtype=torch.int32, device=dev)
        hd[:, 0], hd[:, 1], hd[:, 2] = inp.amount, inp.c_id, inp.w_id
        self._install(hslot, self.tids, self.vec, hd, can)
        self.h_cursor = cur + can.to(torch.int32)
        return {"committed": committed, "snapshot_miss": miss}

    def delivery(self, inp, act, round_no):
        L, T, dev = self.lay, self.T, self.dev
        w, d = _i64(inp.w_id), _i64(inp.d_id)
        vec = self.vec.clone()
        dsl = L.d(w, d)
        _, _, dd, _ = self.read(dsl, vec)
        deliv_o = dd[:, D_NEXT_DELIV]
        has_order = deliv_o < dd[:, D_NEXT_O]
        okey = (w * DISTRICTS + d) * MAX_O + _i64(deliv_o)
        k, v, idx_found = self._max_below(okey + 1)
        found = idx_found & (k == okey) & has_order & act
        oslot = torch.where(found, v, self._safe_oslot())
        _, _, od, _ = self.read(oslot, vec)
        c_id = _i64(torch.where(found, od[:, O_C_ID], 0))
        line = torch.arange(MAX_OL, device=dev)
        lines = (line[None, :] < od[:, O_OL_CNT, None]) & found[:, None]
        slots = torch.cat([dsl[:, None], oslot[:, None],
                           L.c(w, d, c_id)[:, None],
                           L.ol_of(oslot)[:, None] + line[None, :]], dim=1)
        rmask = torch.cat([act[:, None], found[:, None], found[:, None],
                           lines], dim=1)
        wref = torch.arange(3, device=dev)[None, :].expand(T, 3)
        wmask = found[:, None].expand(T, 3)

        def compute(rd):
            out = rd[:, :3].clone()
            out[:, 0, D_NEXT_DELIV] += 1
            out[:, 1, O_CARRIER] = inp.carrier
            amt = torch.where(lines, _i64(rd[:, 3:, OL_AMOUNT]), 0).sum(1)
            amt = ((amt + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)
            out[:, 2, C_BAL] += amt
            out[:, 2, C_DELIV_CNT] += 1
            return out

        committed, miss, _ = self.si_round(slots, rmask, wref, wmask,
                                           compute, act)
        return {"committed": committed, "delivered": committed & found,
                "snapshot_miss": miss}

    def orderstatus(self, inp, act, round_no):
        w, d = _i64(inp.w_id), _i64(inp.d_id)
        d_key = w * DISTRICTS + d
        k, oslot, found = self._max_below((d_key + 1) * MAX_O)
        found = found & (k // MAX_O == d_key) & act
        _, _, od, _ = self.read(torch.where(found, oslot, 0), self.vec)
        return {"found": found,
                "result": torch.where(found[:, None], od, 0)}

    def stocklevel(self, inp, act, round_no, last_n):
        L, T, dev = self.lay, self.T, self.dev
        w, d = _i64(inp.w_id), _i64(inp.d_id)
        vec = self.vec
        _, _, dd, _ = self.read(L.d(w, d), vec)
        next_o = _i64(dd[:, D_NEXT_O])
        base = (w * DISTRICTS + d) * MAX_O
        keys, oslots = self._scan(base + (next_o - last_n).clamp(min=0),
                                  base + next_o, last_n)
        valid = (keys != SENTINEL) & (oslots >= 0) & act[:, None]
        oslots = torch.where(valid, oslots, self._safe_oslot())
        line = torch.arange(MAX_OL, device=dev)
        ol = (L.ol_of(oslots)[:, :, None] + line).reshape(T, -1)
        ol_mask = valid.repeat_interleave(MAX_OL, dim=1)
        _, _, old, ol_found = self.read(ol.reshape(-1), vec)
        ok = ol_found.reshape(T, -1) & ol_mask
        items = _i64(old.reshape(T, -1, WIDTH)[:, :, OL_I_ID])
        safe = torch.where(ok, items, 0)
        _, _, sd, s_found = self.read(
            L.s(w[:, None].expand_as(safe), safe).reshape(-1), vec)
        low = ok & s_found.reshape(T, -1) \
            & (sd.reshape(T, -1, WIDTH)[:, :, S_QTY]
               < inp.threshold[:, None])
        # distinct low-stock items a row: mark each in a row of all items
        n = L.I
        marks = torch.zeros((T, n + 1), dtype=torch.int32, device=dev)
        marks.scatter_(1, torch.where(low, items, n), 1)
        counts = marks[:, :n].sum(dim=1)
        return {"result": torch.where(act, counts, 0)}

    # ----------------------------------------------------- background ----
    def version_mover(self, reuse_only: bool):
        """Move each record's oldest unmoved old version to the overflow
        ring (one a record)."""
        unmoved = (self.old_meta & MOVED) == 0
        rows = torch.nonzero(unmoved.any(dim=1)).squeeze(1)
        if rows.numel() == 0:
            return
        K, KO = self.K, self.KO
        nw = self.nw[rows].long()
        src = torch.full_like(rows, -1)
        for age in reversed(range(K)):      # the oldest unmoved one wins
            pos = torch.remainder(nw + age, K)
            src = torch.where(unmoved[rows, pos], pos, src)
        dst = torch.remainder(self.on[rows].long(), KO)
        if reuse_only:
            ok = (self.ovf_meta[rows, dst] & DELETED) != 0
            rows, src, dst = rows[ok], src[ok], dst[ok]
        self.ovf_meta[rows, dst] = self.old_meta[rows, src] & ~DELETED
        self.ovf_cts[rows, dst] = self.old_cts[rows, src]
        self.ovf_data[rows, dst] = self.old_data[rows, src]
        self.on[rows] = ((dst + 1) % KO).to(torch.int32)
        self.old_meta[rows, src] |= MOVED

    def gc(self, log, now: int, max_txn_time: int):
        """One GC step: log the vector, derive the safe vector, delete
        (and zero) the overflow versions no snapshot can reach."""
        times, vecs = log
        unused = [i for i, t in enumerate(times) if t < 0]
        i = unused[0] if unused else min(range(len(times)),
                                         key=lambda j: times[j])
        times[i], vecs[i] = now, self.vec.clone()
        old = [v for t, v in zip(times, vecs)
               if t >= 0 and t <= now - max_txn_time]
        safe = torch.stack(old).max(dim=0).values if old \
            else torch.zeros_like(self.vec)
        live = (self.ovf_meta & DELETED) == 0
        rows = torch.nonzero(live.sum(dim=1) >= 2).squeeze(1)
        if rows.numel() == 0:
            return
        m, c = self.ovf_meta[rows], self.ovf_cts[rows]
        vis = self._visible(m, c, safe)
        newest = torch.where(vis, c, -1).max(dim=1, keepdim=True).values
        doomed = vis & (c < newest)
        r, k = torch.nonzero(doomed, as_tuple=True)
        r = rows[r]
        self.ovf_meta[r, k] = DELETED
        self.ovf_cts[r, k] = 0
        self.ovf_data[r, k] = 0


def _merge(pending, fresh, mask):
    if isinstance(fresh, torch.Tensor):
        return torch.where(mask.reshape((-1,) + (1,) * (fresh.dim() - 1)),
                           pending, fresh)
    return type(fresh)(*(_merge(p, f, mask) for p, f in zip(pending, fresh)))


def run_mixed(db: RefTPCC, draw, n_rounds: int, *, gc_interval: int,
              max_txn_time: int, gc_snapshots: int, stock_last_n: int):
    """One driver call over the mix. Returns (stats dict, log): the log
    holds each executed sub-round's outcomes, in order."""
    T = db.T
    log, sums = [], {n: [0, 0, 0, 0] for n in TYPES}
    delivered = 0
    pending, ptype = None, torch.full((T,), -1, dtype=torch.int32,
                                      device=db.dev)
    gc_log = ([-1] * gc_snapshots, [None] * gc_snapshots)
    n_gc = 0
    for r in range(n_rounds):
        fresh = draw(r)
        inp = fresh if pending is None else _merge(pending, fresh, ptype >= 0)
        tt = inp.txn_type
        aborted = torch.zeros((T,), dtype=torch.bool, device=db.dev)
        for name, ti in (("neworder", 0), ("payment", 1), ("delivery", 3),
                         ("orderstatus", 2), ("stocklevel", 4)):
            act = tt == ti
            if not bool(act.any()):
                continue
            sub = getattr(inp, name)
            if name == "stocklevel":
                out = db.stocklevel(sub, act, r, stock_last_n)
            else:
                out = getattr(db, name)(sub, act, r)
            log.append((name, out))
            s = sums[name]
            s[0] += int(act.sum())
            if "committed" in out:
                ab = act & ~out["committed"]
                aborted |= ab
                s[1] += int((act & out["committed"]).sum())
                s[2] += int(ab.sum())
                s[3] += int((out["snapshot_miss"] & act).sum())
            else:
                s[1] += int(act.sum())
            if name == "delivery":
                delivered += int(out["delivered"].sum())
        ptype = torch.where(aborted, tt, -1)
        pending = inp
        db.version_mover(reuse_only=gc_interval > 0)
        if gc_interval > 0 and (r + 1) % gc_interval == 0:
            db.gc(gc_log, r, max_txn_time)
            n_gc += 1
    left = [int((ptype == i).sum()) for i in range(len(TYPES))]
    stats = {"delivered": delivered, "gc_sweeps": n_gc}
    for i, n in enumerate(TYPES):
        a, c, ab, miss = sums[n]
        stats[f"attempts.{n}"] = a
        stats[f"commits.{n}"] = c
        stats[f"retries.{n}"] = ab - left[i]
        stats[f"snapshot_misses.{n}"] = miss
        stats[f"contention_aborts.{n}"] = ab - miss
    return stats, log


def run_neworder(db: RefTPCC, draw, n_rounds: int, *, gc_interval: int,
                 max_txn_time: int, gc_snapshots: int, **_):
    """One driver call of new-orders alone. Returns (stats dict, log)."""
    T = db.T
    log, committed_rounds, missed_rounds = [], [], []
    pending, retry = None, torch.zeros((T,), dtype=torch.bool, device=db.dev)
    gc_log = ([-1] * gc_snapshots, [None] * gc_snapshots)
    n_gc = attempts = commits = retries = misses = 0
    act = torch.ones((T,), dtype=torch.bool, device=db.dev)
    for r in range(n_rounds):
        fresh = draw(r)
        inp = fresh if pending is None else _merge(pending, fresh, retry)
        out = db.neworder(inp, act, r)
        log.append(("neworder", out))
        c, miss = out["committed"], out["snapshot_miss"]
        committed_rounds.append(c)
        missed_rounds.append(miss)
        n_c = int(c.sum())
        attempts += T
        commits += n_c
        retries += T - n_c
        misses += int(miss.sum())
        db.version_mover(reuse_only=gc_interval > 0)
        if gc_interval > 0 and (r + 1) % gc_interval == 0:
            db.gc(gc_log, r, max_txn_time)
            n_gc += 1
        retry = ~c
        pending = inp
    retries -= int(retry.sum())
    stats = {"attempts": attempts, "commits": commits, "retries": retries,
             "snapshot_misses": misses,
             "contention_aborts": attempts - commits - misses,
             "gc_sweeps": n_gc,
             "committed": torch.stack(committed_rounds),
             "missed": torch.stack(missed_rounds)}
    return stats, log


DRIVERS = {"mixed": run_mixed, "neworder": run_neworder}

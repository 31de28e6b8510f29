"""Calibrated InfiniBand/RDMA analytical cost model (DESIGN.md §5).

A copy of the reference's pure-Python ``repro/core/netmodel.py``, kept in
the port so that nothing here imports the reference package. Wall-clock
throughput of a 56-node InfiniBand FDR 4x cluster cannot be measured on one
card. Every protocol decision (aborts, lock arbitration, visibility,
staleness) is executed for real by the protocol code; this module turns the
*measured op counts and abort rates* into throughput curves with a
min-of-capacity-caps model whose constants are calibrated once against
anchor numbers the paper itself reports (and Mellanox Connect-IB specs):

  anchor 1: naive oracle plateaus ≈ 2 M t-trx/s (paper Fig. 6)       → ATOMIC_SAME_LINE_RATE
  anchor 2: basic vector oracle ≈ 20 M t-trx/s at 160 threads        → ORACLE_BW (bidirectional)
  anchor 3: bg-reader variant  ≈ 36 M t-trx/s                        → WRITE_OP_RATE
  anchor 4: compressed variant ≈ 80 M t-trx/s (latency-bound loop)   → RDMA_READ_LAT
  anchor 5: both optimizations ≈ 135 M t-trx/s                       → LOCAL_CAS_RATE
  anchor 6: §1.1 back-of-envelope: 3 × 10 GbE servers, 6 KB/txn → ~29 k txn/s (sanity)

The five capacity dimensions are structural, not fitted: NIC small-message op
rate, NIC same-address atomic serialization (the RNIC latch), port bandwidth,
closed-loop latency (threads / round-trip), and host CPU for two-sided
message handling. Which cap binds is an *output* of the model.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class IBConstants:
    # Mellanox Connect-IB, FDR 4x (56 Gb/s)
    PORT_BW: float = 6.8e9            # B/s unidirectional
    ORACLE_BW: float = 13.6e9         # B/s — bidirectional accounting (cal. anchor 2)
    READ_OP_RATE: float = 137e6       # small-message one-sided reads /s (Mellanox spec)
    WRITE_OP_RATE: float = 36.8e6     # signaled writes /s (cal. anchor 3)
    ATOMIC_SAME_LINE_RATE: float = 2.2e6  # F&A on one address (cal. anchor 1)
    ATOMIC_DEGRADE: float = 0.012     # extra latch queuing per client > knee
    ATOMIC_KNEE: int = 20             # clients before degradation (paper obs.)
    RDMA_READ_LAT: float = 2.0e-6     # s, loaded one-sided read (cal. anchor 4)
    RDMA_WRITE_LAT: float = 1.0e-6
    LOCAL_ACCESS_LAT: float = 0.1e-6  # local memory instead of RDMA (§7.3)
    PROTO_OP_CPU: float = 2.5e-6      # s CPU per record op that locality can
    # NOT remove: visibility check against T_R, old-version-buffer scan,
    # header decode, write-set bookkeeping (cal. anchor 7: §7.3 locality ≈30%)
    LOCAL_CAS_RATE: float = 16.9e6    # contended local CAS per server (cal. anchor 5)
    IPOIB_MSG_CPU: float = 15e-6      # s CPU per two-sided message (TCP/IP stack)
    CORES: int = 16                   # 2× 8-core Xeons (cluster A)
    ETH10_BW: float = 1.25e9          # §1.1 example


C = IBConstants()


# ---------------------------------------------------------------------------
# §1.1 sanity anchor
# ---------------------------------------------------------------------------
def intro_example_throughput(n_servers: int = 3, bytes_per_txn: float = 6144.0,
                             bw: float = C.ETH10_BW,
                             tcp_efficiency: float = 0.143) -> float:
    """'~29k distributed transactions per second' (paper §1.1).

    Idealized wire math gives ``bw / bytes_per_txn ≈ 203 k``; the paper's
    stated ~29 k implies ≈14 % effective utilization once TCP/IP framing,
    per-message kernel work and duplex asymmetry are paid — that efficiency
    is the calibrated constant here (anchor 6), and is consistent with the
    IPOIB_MSG_CPU constant used for the two-sided baseline.
    """
    del n_servers  # every txn touches all three servers: network-wide cost
    return tcp_efficiency * bw / bytes_per_txn


# ---------------------------------------------------------------------------
# Exp-2: timestamp-oracle variants (paper Fig. 6)
# ---------------------------------------------------------------------------
def oracle_throughput(variant: str, n_clients: int, n_threads_per_client: int,
                      threads_per_server_slot: int = 20,
                      prefetch_amortization: int = 64) -> float:
    """t-trx/s for one oracle design at a given client count.

    variant ∈ {naive, vector, vector_bg, vector_compressed, vector_both}.
    """
    n_threads = n_clients * n_threads_per_client
    if variant == "naive":
        # one F&A per t-trx on ONE address — the RNIC latch serializes; above
        # the knee, retries/queuing degrade it (paper: >20 clients declines)
        base = C.ATOMIC_SAME_LINE_RATE
        over = max(0, n_threads - C.ATOMIC_KNEE)
        return base / (1.0 + C.ATOMIC_DEGRADE * over)

    vec_entries = n_threads if variant in ("vector", "vector_bg") else \
        max(1, n_threads // threads_per_server_slot)
    read_bytes = 4.0 * vec_entries
    amort = prefetch_amortization if variant in ("vector_bg", "vector_both") \
        else 1
    reads_per = 1.0 / amort          # bg fetch thread amortizes vector reads
    writes_per = 1.0
    if variant in ("vector_compressed", "vector_both"):
        # threads of one server coalesce slot updates: local CAS + one write
        writes_per = 1.0 / threads_per_server_slot

    cap_bw = C.ORACLE_BW / (reads_per * read_bytes + writes_per * 4.0)
    cap_read = C.READ_OP_RATE / max(reads_per, 1e-9)
    cap_write = C.WRITE_OP_RATE / writes_per
    # closed-loop latency bound: each thread runs t-trxs back to back
    lat = reads_per * C.RDMA_READ_LAT + writes_per * C.RDMA_WRITE_LAT \
        + 0.15e-6  # local work: generate cts, bump
    if variant in ("vector_compressed", "vector_both"):
        lat += 1.0 / C.LOCAL_CAS_RATE * n_threads_per_client / \
            threads_per_server_slot  # shared-slot CAS queue per server
    cap_lat = n_threads / lat
    cap_cas = C.LOCAL_CAS_RATE * n_clients \
        if variant in ("vector_compressed", "vector_both") else math.inf
    return min(cap_bw, cap_read, cap_write, cap_lat, cap_cas)


# ---------------------------------------------------------------------------
# Exp-1/3: full-transaction throughput
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TxnProfile:
    """Measured per-transaction op counts (from si.OpCounts / TPC-C run)."""
    reads: float             # one-sided record reads (incl. index probes)
    cas: float
    installs: float          # write-set size
    bytes_read: float
    bytes_written: float
    logic_cpu: float = 20e-6  # local work: compile, build write-set, indexes
    log_writes: float = 2.0  # WAL journal writes (≥2 replicas)


def profile_from_ops(ops, attempts: int, *, extra_installs: float = 0.0,
                     read_only: bool = False) -> TxnProfile:
    """Measured per-attempt op counts (an ``si.OpCounts``-shaped record) of
    one transaction type → cost-model profile.

    ``extra_installs`` charges conflict-free extend inserts that the SI
    round's op counters do not see (e.g. new-order's order/order-line
    records). Read-only transactions burn less local CPU and write no WAL.
    """
    per = 1.0 / max(1, attempts)
    return TxnProfile(
        reads=float(ops.record_reads) * per,
        cas=float(ops.cas_ops) * per,
        installs=float(ops.writes) * per / 2 + extra_installs,
        bytes_read=float(ops.bytes_moved) * per * 0.6 + extra_installs * 40,
        bytes_written=float(ops.bytes_moved) * per * 0.4
        + extra_installs * 40,
        logic_cpu=5e-6 if read_only else 20e-6,
        log_writes=0.0 if read_only else 2.0)


def combine_profiles(profiles, shares) -> TxnProfile:
    """Attempt-share-weighted mix of per-type profiles (the paper's *total*
    throughput is over the whole transaction mix, §7)."""
    def mix(field):
        return sum(shares[n] * getattr(profiles[n], field) for n in profiles)
    return TxnProfile(
        reads=mix("reads"), cas=mix("cas"), installs=mix("installs"),
        bytes_read=mix("bytes_read"), bytes_written=mix("bytes_written"),
        logic_cpu=mix("logic_cpu"), log_writes=mix("log_writes"))


# Queueing inflation at 60 threads/server load: verbs queue at the NIC and
# two-sided index/catalog ops queue at server CPUs. Calibrated jointly with
# PROTO_OP_CPU to the paper's anchors thr=3.64 M @56 w/o locality (cap_lat =
# 1680 threads / (L*retry) ⇒ L ≈ 455 µs, the ≈0.5 ms new-order latency of
# Fig. 5) and ~6 M w/ locality — the locality *ratio* is governed by how much
# of L is wire latency vs. protocol CPU, which QF scales uniformly.
SERVER_QUEUE_FACTOR = 3.0


def txn_latency(p: TxnProfile, local_fraction: float = 0.0,
                serial_read_depth: float = 4.0) -> float:
    """Closed-loop latency of one transaction.

    Index traversals and key→address resolution serialize a few reads
    (``serial_read_depth``); the rest issue in parallel (Listing 1 parfor).
    Local accesses (locality optimization, §7.3) cost memory latency instead
    of a verb round trip — but the per-op *protocol* CPU (T_R visibility
    check, old-version-buffer scan, header decode) is paid either way, which
    is exactly why the paper measures only ~30 % benefit from locality.
    """
    r_lat = (1 - local_fraction) * C.RDMA_READ_LAT \
        + local_fraction * C.LOCAL_ACCESS_LAT + C.PROTO_OP_CPU
    w_lat = (1 - local_fraction) * C.RDMA_WRITE_LAT \
        + local_fraction * C.LOCAL_ACCESS_LAT + C.PROTO_OP_CPU
    base = (p.reads * r_lat                            # read-set fetches
            + serial_read_depth * r_lat                # dependent/index reads
            + 2.0 * w_lat                              # CAS round + install
            + p.log_writes * C.RDMA_WRITE_LAT * 0.0    # unsignaled, off path
            + p.logic_cpu)
    return base * SERVER_QUEUE_FACTOR


def namdb_throughput(p: TxnProfile, n_servers: int, threads_per_server: int,
                     abort_rate: float, local_fraction: float = 0.0,
                     mem_fraction: float = 0.5) -> float:
    """NAM-DB txns/s at ``n_servers`` total machines (Fig. 4 model).

    Capacity caps: closed-loop latency (threads / L), per-memory-server NIC
    bandwidth and op rate. Aborted transactions are retried immediately
    (§7.4) so effective cost per committed txn inflates by 1/(1-abort).
    """
    n_compute = max(1, int(n_servers * (1 - mem_fraction)))
    n_memory = max(1, n_servers - n_compute)
    threads = n_compute * threads_per_server
    L = txn_latency(p, local_fraction)
    retry = 1.0 / max(1e-3, 1.0 - abort_rate)
    cap_lat = threads / (L * retry)
    remote = 1.0 - local_fraction
    cap_bw = n_memory * C.PORT_BW / (
        (p.bytes_read + p.bytes_written) * remote * retry + 1e-9)
    cap_ops = n_memory * C.READ_OP_RATE / (
        (p.reads + p.cas + 2 * p.installs) * remote * retry + 1e-9)
    cap_cpu = n_compute * C.CORES / ((p.logic_cpu + 2e-6) * retry)
    return min(cap_lat, cap_bw, cap_ops, cap_cpu)


def traditional_throughput(p: TxnProfile, n_servers: int,
                           threads_per_server: int, abort_rate: float,
                           distributed_fraction: float = 1.0) -> float:
    """Two-sided / shared-nothing SI baseline (red line, Fig. 4).

    Every remote record touch costs a request+response message *handled by a
    CPU*; coordination (prepare/commit) adds per-participant messages. The
    per-message CPU burn is what caps and then degrades it: queueing delay
    grows with utilization, latency inflates aborts, aborts inflate retries.
    """
    # participants of a distributed txn grow with cluster size (items spread
    # over more partitions as warehouses spread)
    participants = 1.0 + min(10.0, 0.15 * n_servers)
    local_work = 30e-6
    msgs = distributed_fraction * participants * 6.0   # reads + 2PC rounds
    cpu_per_txn = local_work + msgs * C.IPOIB_MSG_CPU
    cap_cpu = n_servers * C.CORES / cpu_per_txn
    # distributed txns hold locks across message round trips: convoying and
    # induced aborts grow super-linearly with cluster size (the paper's
    # "throughput even degrades when using more than 10 machines")
    convoy = 1.0 + (n_servers / 12.0) ** 2 * distributed_fraction
    retry = 1.0 / max(1e-3, 1.0 - min(0.6, abort_rate * convoy))
    return cap_cpu / convoy / retry


def hstore_like_throughput(distributed_fraction: float,
                           n_servers: int = 7) -> float:
    """H-Store anchor numbers (§7.3): 11 k/s perfectly partitioned, 900/s at
    100 % distributed — single-threaded partition executors that stall on any
    cross-partition coordination."""
    base = 11_000.0
    floor = 900.0
    penalty = base / floor - 1.0
    return base / (1.0 + penalty * distributed_fraction)

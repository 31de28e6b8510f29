"""Database catalog (paper §6.1): table and index names → pool regions.

Layouts are static during a run, so the catalog is plain Python: each
table is a contiguous slot range of the unified record pool. The catalog
is hash-partitioned over the memory servers and cached by compute servers;
a per-server version counter (:class:`CatalogState`, uint32 words in int32
storage) invalidates the caches: DDL bumps it, and a thread refreshes its
entries when the counter moved.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch

from repro_torch._u32 import to_i32, u64


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """One table or index region inside the unified record pool."""
    name: str
    base: int          # first record slot in the pool
    count: int         # number of record slots
    width: int         # payload width in int32 words
    n_columns: int     # logical columns packed into the payload
    kind: str = "table"  # "table" | "hash_index" | "range_index"

    @property
    def end(self) -> int:
        return self.base + self.count

    def slot(self, local_id):
        """Global pool slot of a local record id (the &_r operator)."""
        return self.base + local_id


class CatalogState(NamedTuple):
    version: torch.Tensor  # int32 [n_servers] — per-server alter counters


@dataclasses.dataclass
class Catalog:
    specs: Dict[str, TableSpec] = dataclasses.field(default_factory=dict)
    n_servers: int = 1
    _next_base: int = 0

    def create_table(self, name: str, count: int, width: int,
                     n_columns: Optional[int] = None,
                     kind: str = "table") -> TableSpec:
        spec = TableSpec(name=name, base=self._next_base, count=count,
                         width=width, n_columns=n_columns or width, kind=kind)
        self.specs[name] = spec
        self._next_base += count
        return spec

    @property
    def total_records(self) -> int:
        return self._next_base

    def __getitem__(self, name: str) -> TableSpec:
        return self.specs[name]

    def server_of(self, name: str) -> int:
        """Hash partitioning of catalog entries over memory servers."""
        return hash(name) % self.n_servers

    # ---- the version-counter protocol ------------------------------------
    def init_state(self, *, device=None) -> CatalogState:
        return CatalogState(version=torch.zeros(
            (self.n_servers,), dtype=torch.int32, device=device))

    def alter(self, state: CatalogState, name: str) -> CatalogState:
        """DDL on ``name`` bumps its server's counter (a new state)."""
        v = u64(state.version)
        v[self.server_of(name)] += 1
        return CatalogState(version=to_i32(v))

    def needs_refresh(self, state: CatalogState, cached: CatalogState):
        """A compute server's check before it compiles a transaction."""
        return state.version != cached.version

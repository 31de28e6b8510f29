"""Shape-only device meshes (``repro/launch/mesh.py``).

The reference builds ``jax.sharding.Mesh`` objects over real (or forced
host) devices; a function, never at import. The port's :class:`Mesh` has
axis names and sizes and no devices: one card holds every shard, as the
store's memory servers are a leading axis of one pool. A mesh is what the
partition rules (``launch/sharding.py``) divide shapes by, and, entered
as a context (``with mesh:``), what ``models/common._mesh_axes``, ``_dp``
and ``_axis_size`` read, as the reference's read ``thread_resources``:
under the ``opt`` policy ``moe.apply_moe`` then dispatches per data
shard (``moe.apply_moe_sharded``), the shards a leading axis of one
tensor on the one card.

Single pod: 16×16 = 256 chips, axes ("data", "model"). Multi-pod:
2×16×16 = 512 chips, axes ("pod", "data", "model"); the pod axis rides
with data (:func:`dp_axes`).
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, Optional, Tuple

# the live meshes of each thread, innermost last (the reference's
# ``thread_resources`` is per thread too)
_LIVE = threading.local()


def _live_meshes() -> list:
    if not hasattr(_LIVE, "meshes"):
        _LIVE.meshes = []
    return _LIVE.meshes


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis names and their sizes; ``with mesh:`` makes it the live mesh
    of the calls inside."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        assert len(self.axis_names) == len(self.axis_sizes), self

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """The number of chips (shards) of the mesh."""
        return math.prod(self.axis_sizes)

    def size_of(self, names) -> int:
        """The product of the sizes of an axis name or a tuple of them."""
        names = names if isinstance(names, tuple) else (names,)
        return math.prod(self.shape[a] for a in names)

    def __enter__(self):
        _live_meshes().append(self)
        return self

    def __exit__(self, *exc):
        _live_meshes().pop()


def current() -> Optional[Mesh]:
    """This thread's innermost live mesh, or None."""
    meshes = _live_meshes()
    return meshes[-1] if meshes else None


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(model_axis: int = 1) -> Mesh:
    """The one card's mesh: (1, ``model_axis``) over ("data", "model")
    (the reference's spreads whatever devices exist; here that is one)."""
    return Mesh(("data", "model"), (1, model_axis))


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (pod rides with data when present)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)

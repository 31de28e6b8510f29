"""Checkpoints of a tree of tensors (paper §6.2): save, save_async, restore.

The format is the reference's: one ``.npy`` per leaf and a JSON manifest
(leaf paths, shapes, dtypes, step, commit vector, ``extra``), written last
and atomically (``os.replace``), so a manifest that exists names only
complete leaves. A tree is any nesting of dicts (keys in sorted order),
NamedTuples, lists and tuples over tensors (or numpy arrays); ``None``
holds no leaf. Leaf paths are the reference's key strings
(``['table'].cur_hdr``). A bfloat16 leaf is stored as its 16-bit words,
with its logical dtype in the manifest.

The port updates its pool **in place**, so a checkpoint must not read a
tensor after it returns: :func:`save` has written every leaf when it
returns, and :func:`save_async` copies every leaf to host memory before it
returns, so a later round cannot tear the checkpoint its background write
is still writing.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch._tree import items as _items, rebuild as _rebuild
from repro_torch._u32 import np_to_i32


def _host(leaf) -> torch.Tensor:
    """A host copy of a leaf that shares no memory with it."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(leaf, copy=True))


def _host_tree(tree):
    return _rebuild(tree, iter([_host(leaf) for _, leaf in _items(tree)]))


def save(path: str, params, opt_state=None, *, step: int = 0,
         commit_vector=None, extra: Optional[Dict[str, Any]] = None) -> None:
    """Write the trees ``params`` (and ``opt_state``) under ``path``."""
    os.makedirs(path, exist_ok=True)
    manifest = {"step": int(step), "leaves": {}, "extra": extra or {}}
    if commit_vector is not None:
        manifest["commit_vector"] = np.asarray(
            commit_vector.cpu() if isinstance(commit_vector, torch.Tensor)
            else commit_vector).tolist()
    trees = {"params": params}
    if opt_state is not None:
        trees["opt"] = opt_state
    for name, tree in trees.items():
        for key, leaf in _items(tree):
            t = leaf.detach().cpu() if isinstance(leaf, torch.Tensor) \
                else torch.from_numpy(np.asarray(leaf))
            if t.dtype == torch.bfloat16:
                dtype_name = "bfloat16"
                arr = t.view(torch.int16).numpy().view(np.uint16)
            else:
                arr = t.numpy()
                dtype_name = arr.dtype.name
            safe = "".join(c if c.isalnum() else "_" for c in key)
            fname = f"{name}__{safe}.npy"
            np.save(os.path.join(path, fname), arr)
            manifest["leaves"][f"{name}/{key}"] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype_name}
    tmp = os.path.join(path, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(path, "manifest.json"))  # atomic commit


def save_async(path: str, params, opt_state=None, **kw) -> threading.Thread:
    """Copy every leaf to host memory on the calling thread, then write on
    a background thread; the caller may change its tensors as soon as this
    returns. ``join()`` the thread to wait for the manifest."""
    params = _host_tree(params)
    if opt_state is not None:
        opt_state = _host_tree(opt_state)
    t = threading.Thread(target=save, args=(path, params, opt_state),
                         kwargs=kw, daemon=True)
    t.start()
    return t


def restore(path: str, like_params, like_opt=None, *, shardings=None
            ) -> Tuple[Any, Any, Dict[str, Any]]:
    """Load the trees saved under ``path`` into the structure of
    ``like_params`` (and ``like_opt``); each leaf takes the dtype of the
    matching ``like`` leaf and lands on its device. Returns ``(params, opt,
    manifest)``. ``shardings`` re-places the reference's leaves on a mesh
    and has no analogue on one card: it must be ``None``."""
    if shardings is not None:
        raise NotImplementedError(
            "restore: shardings has no analogue on one card; leaves land "
            "on the device of their like leaf")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    def load_tree(name, like):
        leaves = []
        for key, leaf in _items(like):
            meta = manifest["leaves"][f"{name}/{key}"]
            arr = np.load(os.path.join(path, meta["file"]))
            shape = tuple(leaf.shape)
            if tuple(arr.shape) != shape:
                raise ValueError(
                    f"checkpoint leaf {name}/{key} has shape "
                    f"{tuple(arr.shape)} but the live structure expects "
                    f"{shape} — the checkpoint was written under a "
                    f"different deployment (e.g. a pre-scale-out shard "
                    f"count); re-checkpoint after the topology change")
            if meta["dtype"] == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:   # a uint32 leaf of the reference keeps its bits
                t = torch.from_numpy(np_to_i32(arr))
            if isinstance(leaf, torch.Tensor):
                t = t.to(device=leaf.device, dtype=leaf.dtype)
            leaves.append(t)
        return _rebuild(like, iter(leaves))

    params = load_tree("params", like_params)
    opt = load_tree("opt", like_opt) if like_opt is not None else None
    return params, opt, manifest

"""Training checkpoints: a model's parameters and its ``AdamWState``
through ``checkpoint/snapshot.py``, in the reference's tree.

The parameters are saved in ``convert.lm_params_to_numpy``'s layout
(stacked over pattern units, bfloat16 kept) and the moments in the same
layout under ``.m`` and ``.v``, so every leaf path is the reference's key
string (``params/['u0']['attn']['wq']``, ``opt/.m['embed']``) and the
reference's ``snapshot.restore`` reads a checkpoint the port wrote into
the reference's trees. ``save_async`` copies every leaf to the host before
it returns, which the train step's in-place update needs.
"""
from __future__ import annotations

import os
import threading

from repro_torch import convert
from repro_torch.checkpoint import snapshot
from repro_torch.train import optimizer as opt


def save_async(path: str, params, opt_state: opt.AdamWState, *,
               step: int) -> threading.Thread:
    """Write ``params`` (a ``Transformer``) and ``opt_state`` under
    ``path`` on a background thread; ``join()`` it to wait for the
    manifest."""
    return snapshot.save_async(
        path, convert.lm_params_to_tree(params),
        convert.adamw_state_to_tree(params, opt_state), step=step)


def exists(path) -> bool:
    return bool(path) and os.path.exists(os.path.join(path, "manifest.json"))


def restore(path: str, params, opt_state: opt.AdamWState):
    """Load the checkpoint under ``path`` into ``params`` (in place) and
    a new ``AdamWState`` on the parameters' device. Returns ``(params,
    opt_state, manifest)``; ``manifest["step"]`` is the checkpoint's
    step."""
    like_p = convert.lm_params_to_tree(params)
    like_o = convert.adamw_state_to_tree(params, opt_state)
    tree, otree, manifest = snapshot.restore(path, like_p, like_o)
    convert.lm_params_load_tree(params, tree)
    dev = params.embed.device
    return params, convert.adamw_state_from_numpy(params, otree, dev), \
        manifest

"""Trees of tensors: any nesting of dicts (keys in sorted order, as JAX
flattens them), NamedTuples, lists and tuples over leaves; ``None`` holds
no leaf. Key strings are the reference's (``jax.tree_util.keystr``):
``['u0']['attn']['wq']``, ``.m['embed']``."""
from __future__ import annotations


def items(tree, path=""):
    """``(key string, leaf)`` of every leaf, in the reference's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in items(tree[k],
                                                         f"{path}[{k!r}]")]
    if hasattr(tree, "_fields"):
        return [kv for f in tree._fields for kv in items(getattr(tree, f),
                                                         f"{path}.{f}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree) for kv in items(x,
                                                               f"{path}[{i}]")]
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in items(tree)]


def rebuild(tree, new_leaves):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``new_leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        out = {k: rebuild(tree[k], new_leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if hasattr(tree, "_fields"):
        return type(tree)(*(rebuild(getattr(tree, f), new_leaves)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(rebuild(x, new_leaves) for x in tree)
    return next(new_leaves)


def tmap(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree of ``rest`` (the same structure)."""
    others = [leaves(t) for t in rest]
    return rebuild(tree, iter([fn(*xs) for xs in zip(leaves(tree),
                                                     *others)]))

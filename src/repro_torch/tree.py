"""Trees of tensors, the port's pytrees: nested dicts, lists, tuples and
NamedTuples (``AdamWState``, ``SSMState``) with tensors (or any other
object) at the leaves."""

from __future__ import annotations


def _is_named(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def map_tree(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in a tree of that structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_named(tree):
        return type(tree)(*(map_tree(fn, *vs) for vs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)


def leaves(tree) -> list:
    """The leaves of ``tree`` in its order (dicts by insertion)."""
    return [leaf for _, leaf in items(tree)]


def items(tree, prefix: str = "") -> list:
    """(key path, leaf) for every leaf: dict keys, list and tuple indices
    and NamedTuple field names joined by "/" (``opt/m/blocks/attn/wq``)."""
    if isinstance(tree, dict):
        kids = tree.items()
    elif _is_named(tree):
        kids = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        kids = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [kv for k, v in kids
            for kv in items(v, f"{prefix}/{k}" if prefix else str(k))]


def unflatten(tree, values) -> object:
    """``tree`` with its leaves replaced, in order, by ``values``."""
    it = iter(values)
    out = map_tree(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out

"""Trees of tensors as JAX's tree utilities see them.

A tree is nested dicts, tuples (NamedTuples included: ``TrainState``,
``AdamWState``), lists and ``None`` (a node without leaves); anything else
is a leaf.  The training stack walks parameter, gradient and optimizer
trees with these, and the checkpoint names each leaf by the reference's
path string (``_flatten_with_paths`` in ``repro/ckpt/manager.py``): a dict
key or a sequence index as it is, a NamedTuple field as ``.name``, joined
by ``/`` (``.params/embed/table``).  Dict keys keep their insertion order
here (JAX sorts them); nothing that uses these depends on the order.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple


def _children(node) -> List[Tuple[str, Any]]:
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [("." + f, getattr(node, f)) for f in node._fields]
    return [(str(i), v) for i, v in enumerate(node)]


def _is_node(node) -> bool:
    return isinstance(node, (dict, tuple, list))


def _rebuild(like, items: List[Any]):
    if isinstance(like, dict):
        return dict(zip(like.keys(), items))
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*items)
    return type(like)(items)


def leaves(tree) -> List[Any]:
    """The leaves in order; ``None`` has none."""
    if tree is None:
        return []
    if _is_node(tree):
        return [x for _, c in _children(tree) for x in leaves(c)]
    return [tree]


def flatten_with_paths(tree) -> Dict[str, Any]:
    """{path string: leaf}, with the reference checkpoint's keys."""
    out: Dict[str, Any] = {}

    def walk(node, prefix: str):
        if node is None:
            return
        if not _is_node(node):
            out[prefix] = node
            return
        for k, c in _children(node):
            walk(c, f"{prefix}/{k}" if prefix else k)

    walk(tree, "")
    return out


def unflatten(like, values: Iterator[Any]):
    """A tree shaped like ``like`` whose leaves are taken from ``values``
    in ``leaves(like)``'s order."""
    if like is None:
        return None
    if _is_node(like):
        return _rebuild(like, [unflatten(c, values)
                               for _, c in _children(like)])
    return next(values)


def map_(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    tree of ``rest`` (same structure), as ``jax.tree.map``."""
    flats = [leaves(tree)] + [leaves(t) for t in rest]
    if any(len(f) != len(flats[0]) for f in flats):
        raise ValueError(f"trees of {[len(f) for f in flats]} leaves")
    return unflatten(tree, iter([fn(*xs) for xs in zip(*flats)]))

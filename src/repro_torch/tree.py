"""The port's one walk over nested containers of tensors, in
``jax.tree_util``'s order: dicts in sorted key order, tuples, lists and
NamedTuples in field order, ``None`` an empty node; anything else is a
leaf. The round's graph carry (``engine/graph.py``), the optimizers and
the checkpoint (``checkpoint/io.py``) all walk a state with it, so a
leaf's position is the same in the three and in the reference.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _keyed_children(node) -> List[Tuple[Any, str, Any]]:
    """(key, key path piece, child) of an inner node: the dict key, field
    name or index, and the piece as ``jax.tree_util.keystr`` writes it:
    ``['k']``, ``.field`` or ``[i]``."""
    if isinstance(node, dict):
        return [(k, f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f, f".{f}", v) for f, v in zip(node._fields, node)]
    return [(i, f"[{i}]", v) for i, v in enumerate(node)]


def _children(node) -> List[Tuple[str, Any]]:
    return [(piece, v) for _, piece, v in _keyed_children(node)]


def _is_node(x) -> bool:
    return x is None or isinstance(x, (dict, tuple, list))


def _walk_paths(node, path, out):
    if node is None:
        return None
    if not _is_node(node):
        out.append((path, node))
        return "*"
    defs = [_walk_paths(v, path + p, out) for p, v in _children(node)]
    if isinstance(node, dict):
        return (dict, [k for k in sorted(node)], defs)
    return (type(node), None, defs)


def flatten_with_paths(tree) -> Tuple[List[Tuple[str, Any]], Any]:
    """([(key path, leaf)], treedef): the leaves in walk order. (The walks
    here are module functions, not recursive closures: a closure that
    calls itself is a reference cycle, which would hold the leaves, a
    model's weights, until the garbage collector runs.)"""
    out: List[Tuple[str, Any]] = []
    treedef = _walk_paths(tree, "", out)
    return out, treedef


def _walk_keys(node, keys, out):
    if node is None:
        return
    if not _is_node(node):
        out.append((keys, node))
        return
    for k, _, v in _keyed_children(node):
        _walk_keys(v, keys + (k,), out)


def flatten_with_keys(tree) -> List[Tuple[Tuple[Any, ...], Any]]:
    """[(keys, leaf)] in walk order: ``keys`` is the tuple of dict keys,
    field names and indices from the root to the leaf (what a JAX key
    path's entries hold)."""
    out: List[Tuple[Tuple[Any, ...], Any]] = []
    _walk_keys(tree, (), out)
    return out


def flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, treedef) in walk order."""
    leaves, treedef = flatten_with_paths(tree)
    return [leaf for _, leaf in leaves], treedef


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def _build(d, it):
    if d is None:
        return None
    if d == "*":
        return next(it)
    kind, keys, defs = d
    kids = [_build(c, it) for c in defs]
    if kind is dict:
        return dict(zip(keys, kids))
    if issubclass(kind, tuple) and hasattr(kind, "_fields"):
        return kind(*kids)
    return kind(kids)


def unflatten(treedef, leaves: List[Any]):
    """The tree of ``treedef`` with ``leaves`` in walk order."""
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees ``rest`` of the
    same structure."""
    flat, treedef = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])

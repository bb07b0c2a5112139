"""Nested dicts, lists and tuples of tensors, in the JAX package's leaf order.

``jax.tree_util`` visits a dict's keys sorted (``b10`` before ``b2``),
lists and tuples in order, a NamedTuple's fields in order (the
optimizer state ``AdamWState(step, m, v)``), and gives ``None`` no
leaf.  The engine's
page payloads and the checkpoint files both depend on that order, so
every flatten in the port goes through these helpers
(``torch.utils._pytree`` keeps dicts in insertion order).
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = [
    "tree_flatten", "tree_leaves", "tree_map", "tree_map_with_path",
    "tree_unflatten",
]

#: the structure :func:`tree_flatten` returns: ``"*"`` for a leaf,
#: ``None`` for ``None``, ``(dict, keys, children)`` and
#: ``(list | tuple | a NamedTuple class, children)`` for containers
TreeDef = Any


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree``, in ``jax.tree_util.tree_leaves`` order."""
    return tree_flatten(tree)[0]


def tree_flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    """``(leaves, treedef)``, as ``jax.tree_util.tree_flatten`` orders
    them; :func:`tree_unflatten` inverts it."""
    leaves: List[Any] = []
    treedef = _walk(tree, leaves)
    return leaves, treedef


def _walk(x: Any, leaves: List[Any]) -> TreeDef:
    """Append ``x``'s leaves to ``leaves``; return its treedef.  A
    module-level function, not a closure: a recursive closure is a
    reference cycle that would keep every leaf alive until the cycle
    collector runs (gigabytes of weights at full width)."""
    if x is None:
        return None
    if isinstance(x, dict):
        keys = sorted(x)
        return (dict, keys, [_walk(x[k], leaves) for k in keys])
    if isinstance(x, (list, tuple)):
        return (type(x), [_walk(t, leaves) for t in x])
    leaves.append(x)
    return "*"


def tree_unflatten(treedef: TreeDef, leaves: List[Any]) -> Any:
    """Rebuild the structure ``treedef`` describes from ``leaves``."""
    return _build(treedef, iter(leaves))


def _rebuild(kind: type, children: List[Any]) -> Any:
    """A list or tuple of ``children``; a NamedTuple takes them as its
    fields (its constructor takes no iterable)."""
    if issubclass(kind, tuple) and hasattr(kind, "_fields"):
        return kind(*children)
    return kind(children)


def _build(d: TreeDef, it) -> Any:
    """The tree ``d`` describes, its leaves drawn from ``it`` (a
    module-level function for the reason :func:`_walk` gives)."""
    if d is None:
        return None
    if d == "*":
        return next(it)
    if d[0] is dict:
        return {k: _build(c, it) for k, c in zip(d[1], d[2])}
    return _rebuild(d[0], [_build(c, it) for c in d[1]])


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` applied to every leaf; containers keep their type (and a
    dict its key order), ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return _rebuild(type(tree), [tree_map(fn, t) for t in tree])
    return fn(tree)


def tree_map_with_path(fn: Callable, tree: Any) -> Any:
    """``fn(path, leaf)`` applied to every leaf, as :func:`tree_map`
    applies ``fn(leaf)``.  ``path`` is the tuple of keys from the root:
    dict keys, list and tuple indices, and a NamedTuple's field names
    (JAX's ``DictKey``, ``SequenceKey`` and ``GetAttrKey``)."""
    return _map_with_path(fn, tree, ())


def _map_with_path(fn: Callable, x: Any, path: Tuple) -> Any:
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        keys = getattr(x, "_fields", None) or range(len(x))
        return _rebuild(type(x), [_map_with_path(fn, t, path + (k,))
                                  for k, t in zip(keys, x)])
    return fn(path, x)

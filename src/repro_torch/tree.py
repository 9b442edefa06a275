"""Parameter trees: nested dicts, lists and tuples of tensors.

The port's counterpart of the ``jax.tree`` functions the training code
uses.  Leaves are visited as ``jax.tree`` visits them: dict entries in
sorted key order, list and tuple items in order, and ``None`` is an
empty subtree (no leaf).
"""

from __future__ import annotations

_MISSING = object()


def leaves(tree) -> list:
    """The leaves of ``tree`` in traversal order."""
    out = []
    _collect(tree, out)
    return out


# The walks recurse through module-level functions: a nested function
# that calls itself is a reference cycle, and its cell would keep the
# leaves alive until the cyclic collector ran (a whole layer of weights,
# drawn to be cut onto a mesh and freed).

def _collect(node, out) -> None:
    if isinstance(node, dict):
        for k in sorted(node):
            _collect(node[k], out)
    elif isinstance(node, (list, tuple)):
        for v in node:
            _collect(v, out)
    elif node is not None:
        out.append(node)


def _build(node, it):
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)([_build(v, it) for v in node])
    if node is None:
        return None
    leaf = next(it, _MISSING)
    if leaf is _MISSING:
        raise ValueError("fewer leaves than the template holds")
    return leaf


def unflatten(template, new_leaves):
    """A tree shaped like ``template`` whose leaves are ``new_leaves``,
    in :func:`leaves` order."""
    it = iter(new_leaves)
    out = _build(template, it)
    if next(it, _MISSING) is not _MISSING:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn, tree):
    """``fn`` over the leaves of ``tree``, in a tree of its shape."""
    return unflatten(tree, [fn(x) for x in leaves(tree)])

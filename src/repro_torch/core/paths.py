"""Param-tree paths, spelled and ordered as the reference spells them.

The reference flattens param pytrees with JAX, which visits dict keys in
SORTED order and names a leaf by its key string (``"['l0']['b']"``,
normalised to ``"/l0/b"``). The arena layout follows that order, so the
port must walk trees the same way: ``nn.Module`` registration order (``w``
before ``b``) would give a different layout and silently different
buckets. Trees here are nested ``dict``s (and lists/tuples) of tensors.

Checkpoint manifests name leaves by the unnormalised key string, in which
JAX spells a NamedTuple field as ``.name`` (``".opt_state.m['l0']['b']"``):
``keystr_leaves`` and ``map_keystrs`` walk trees with that spelling.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Tuple

PyTree = Any


def normalize_path(keystr: str) -> str:
    """Key string ``"['a']['b'].k"`` -> ``"/a/b/k"``."""
    s = re.sub(r"\['([^']+)'\]", r"/\1", keystr)
    s = s.replace(".", "/").replace("[", "/").replace("]", "")
    return s


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(f"['{k}']", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return []


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def _leaves(tree: PyTree, children: Callable, name: Callable
            ) -> List[Tuple[str, Any]]:
    """[(name(key string), leaf)] walking nodes by `children`; ``None`` is
    an empty subtree, as in JAX."""
    out: List[Tuple[str, Any]] = []

    def walk(prefix, t):
        if t is None:
            return
        if _is_node(t):
            for k, v in children(t):
                walk(prefix + k, v)
        else:
            out.append((name(prefix), t))

    walk("", tree)
    return out


def leaves_with_paths(tree: PyTree) -> List[Tuple[str, Any]]:
    """[(normalised path, leaf)] in the reference's flattening order."""
    return _leaves(tree, _children, normalize_path)


def by_path(tree: PyTree) -> Dict[str, Any]:
    return dict(leaves_with_paths(tree))


def _rebuild(node, children: list):
    """A list or tuple like `node` (a NamedTuple keeps its type) holding
    `children`."""
    if hasattr(node, "_fields"):
        return type(node)(*children)
    return type(node)(children)


def map_with_paths(fn: Callable[[str, Any], Any], tree: PyTree) -> PyTree:
    """Rebuild `tree` with every leaf replaced by ``fn(path, leaf)``."""

    def walk(prefix, t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(prefix + f"['{k}']", t[k]) for k in t}
        if isinstance(t, (list, tuple)):
            return _rebuild(t, [walk(prefix + f"[{i}]", v)
                                for i, v in enumerate(t)])
        return fn(normalize_path(prefix), t)

    return walk("", tree)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Leafwise ``fn(leaf, *matching leaves of rest)`` over same-shaped
    trees."""
    others = [by_path(r) for r in rest]
    return map_with_paths(lambda p, x: fn(x, *(o[p] for o in others)), tree)


def fill_paths(tree: PyTree, values: Dict[str, Any]) -> PyTree:
    """Rebuild `tree` with every leaf, and every ``None`` node, whose path
    is in `values` replaced by that value (the arena-resident wrapper keeps
    None at the paths its buckets hold)."""

    def walk(prefix, t):
        if isinstance(t, dict):
            return {k: walk(prefix + f"['{k}']", t[k]) for k in t}
        if isinstance(t, (list, tuple)):
            return _rebuild(t, [walk(prefix + f"[{i}]", v)
                                for i, v in enumerate(t)])
        return values.get(normalize_path(prefix), t)

    return walk("", tree)


def _keyed_children(tree) -> List[Tuple[str, Any]]:
    """Children with JAX's key strings: dict keys sorted, ``['k']``;
    NamedTuple fields ``.name``; list and tuple items ``[i]``."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if hasattr(tree, "_fields"):
        return [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return []


def keystr_leaves(tree: PyTree) -> List[Tuple[str, Any]]:
    """[(key string, leaf)] spelled and ordered as
    ``jax.tree_util.tree_flatten_with_path`` + ``keystr`` give them."""
    return _leaves(tree, _keyed_children, str)


def map_keystrs(fn: Callable[[str, Any], Any], tree: PyTree) -> PyTree:
    """Rebuild `tree` with every leaf replaced by ``fn(key string, leaf)``
    (the ``keystr_leaves`` spelling); ``None`` stays ``None``."""

    def walk(prefix, t):
        if t is None:
            return None
        if not _is_node(t):
            return fn(prefix, t)
        kids = {k: walk(prefix + k, v) for k, v in _keyed_children(t)}
        if isinstance(t, dict):
            return {k: kids[f"[{k!r}]"] for k in t}
        return _rebuild(t, list(kids.values()))

    return walk("", tree)

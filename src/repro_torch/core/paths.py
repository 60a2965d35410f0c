"""Param-tree paths, spelled and ordered as the reference spells them.

The reference flattens param pytrees with JAX, which visits dict keys in
SORTED order and names a leaf by its key string (``"['l0']['b']"``,
normalised to ``"/l0/b"``). The arena layout follows that order, so the
port must walk trees the same way: ``nn.Module`` registration order (``w``
before ``b``) would give a different layout and silently different
buckets. Trees here are nested ``dict``s (and lists/tuples) of tensors.
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


def leaves_with_paths(tree: PyTree) -> List[Tuple[str, Any]]:
    """[(normalised path, leaf)] in the reference's flattening order.
    ``None`` is an empty subtree, as in JAX."""
    out: List[Tuple[str, Any]] = []

    def walk(prefix, t):
        if t is None:
            return
        if _is_node(t):
            for k, v in _children(t):
                walk(prefix + k, v)
        else:
            out.append((normalize_path(prefix), t))

    walk("", tree)
    return out


def by_path(tree: PyTree) -> Dict[str, Any]:
    return dict(leaves_with_paths(tree))


def map_with_paths(fn: Callable[[str, Any], Any], tree: PyTree) -> PyTree:
    """Rebuild `tree` with every leaf replaced by ``fn(path, leaf)``."""

    def walk(prefix, t):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(prefix + f"['{k}']", t[k]) for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(prefix + f"[{i}]", v)
                           for i, v in enumerate(t))
        return fn(normalize_path(prefix), t)

    return walk("", tree)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """Leafwise ``fn(leaf, *matching leaves of rest)`` over same-shaped
    trees."""
    others = [by_path(r) for r in rest]
    return map_with_paths(lambda p, x: fn(x, *(o[p] for o in others)), tree)

"""Trees of tensors: nested dicts, lists and tuples, and dataclasses whose
fields are trees (the port's stand-in for JAX pytrees).  ``None`` is an
empty subtree, as in JAX."""
from __future__ import annotations

import dataclasses


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``tree_map`` order."""
    out = []
    tree_map(out.append, tree)
    return out


def flatten_with_paths(tree, prefix: str = "") -> dict:
    """{path: leaf} with the reference checkpoint's keys: dict keys and
    list indices joined by ``/``, a dataclass field as ``.name`` (what
    ``jax.tree_util`` prints for a registered dataclass)."""
    out = {}

    def walk(t, path):
        if t is None:
            return
        if isinstance(t, dict):
            for k in t:
                walk(t[k], f"{path}/{k}" if path else str(k))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}" if path else str(i))
        elif dataclasses.is_dataclass(t):
            for f in dataclasses.fields(t):
                walk(getattr(t, f.name), f"{path}/.{f.name}" if path
                     else f".{f.name}")
        else:
            out[path] = t

    walk(tree, prefix)
    return out


def unflatten_like(like, flat: dict):
    """The tree shaped like ``like`` whose leaves are ``flat[path]``."""
    paths = iter(flatten_with_paths(like))
    return tree_map(lambda _: flat[next(paths)], like)

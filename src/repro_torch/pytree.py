"""Pytrees of tensors in the reference's layout: nested dicts and lists
whose leaves are tensors, walked as ``jax.tree_util`` walks them (dict
keys sorted, list and tuple items in order, ``None`` holds no leaf), and
each leaf named by ``jax.tree_util.keystr``'s spelling of its path
(``[0]['table']``, ``[1]['m']['bot'][0]['w']``).

A module's parameters map onto the reference's params pytree through its
:func:`layout`: one :class:`Leaf` per reference leaf, naming the module
parameters it holds.  A leaf of stacked layers (the LM's
``dense_layers``, which the reference stacks on a leading axis and scans)
names one parameter a layer; :func:`module_tree` stacks them and
:func:`load_module_tree` writes the slices back.  A module without a
``reference_layout`` method maps each dotted parameter name onto nested
dicts.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, \
    Sequence, Tuple

import torch
from torch import nn

Path = Tuple[Any, ...]


def keystr(path: Path) -> str:
    """``jax.tree_util.keystr`` of a path of dict keys (str) and sequence
    indices (int): ``("bot", 0, "w")`` -> ``['bot'][0]['w']``."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)


def flatten_with_path(tree: Any, path: Path = ()) -> List[Tuple[Path, Any]]:
    """The (path, leaf) pairs of ``tree`` in ``jax.tree_util``'s order."""
    if tree is None:
        return []
    if isinstance(tree, Mapping):
        return [pl for k in sorted(tree)
                for pl in flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in flatten_with_path(v, path + (i,))]
    return [(path, tree)]


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def is_logical(v) -> bool:
    """A leaf of a logical-axes tree (param, cache and optimizer-state
    specs): a tuple of names, tuples and Nones."""
    return isinstance(v, tuple) and not isinstance(v, torch.Size) and all(
        isinstance(a, (str, tuple, type(None))) for a in v)


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``fn`` over the leaves of ``tree`` and of the same-shaped ``rest``,
    in a tree of ``tree``'s structure; a node of ``tree`` for which
    ``is_leaf`` holds is a leaf (``jax.tree.map``'s ``is_leaf``)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf)
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def unflatten(template: Any, new_leaves: Sequence[Any]) -> Any:
    """``template``'s structure with ``new_leaves`` in flatten order."""
    it = iter(new_leaves)

    def build(tree):
        if tree is None:
            return None
        if isinstance(tree, Mapping):
            built = {k: build(tree[k]) for k in sorted(tree)}
            return {k: built[k] for k in tree}
        if isinstance(tree, (list, tuple)):
            out = [build(v) for v in tree]
            return tuple(out) if isinstance(tree, tuple) else out
        return next(it)

    return build(template)


def from_paths(items: Sequence[Tuple[Path, Any]]) -> Any:
    """A nested tree from (path, leaf) pairs: str keys make dicts, int
    keys lists (indices 0..n-1)."""
    root: Dict = {}
    for path, leaf in items:
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


# -- modules -----------------------------------------------------------------


class Leaf(NamedTuple):
    """One reference leaf: its ``path``, the module parameters that hold
    it (``names``) and whether they are layers stacked on a new leading
    axis (else ``names`` has one entry)."""

    path: Path
    names: Tuple[str, ...]
    stacked: bool = False


def _dotted(name: str) -> Path:
    return tuple(int(p) if p.isdigit() else p for p in name.split("."))


def layout(model: nn.Module) -> List[Leaf]:
    """``model.reference_layout()``, or one leaf per parameter at its
    dotted name's path."""
    fn = getattr(model, "reference_layout", None)
    if fn is not None:
        return fn()
    return [Leaf(_dotted(n), (n,)) for n, _ in model.named_parameters()]


def stacked_layout(prefix: str, blocks: Sequence[nn.Module]) -> List[Leaf]:
    """The leaves of layers stacked under ``prefix``: each parameter of a
    block, one name a layer."""
    if not blocks:
        return []
    return [Leaf((prefix,) + _dotted(n),
                 tuple(f"{prefix}.{i}.{n}" for i in range(len(blocks))),
                 True)
            for n, _ in blocks[0].named_parameters()]


def module_tree(model: nn.Module,
                named: Optional[Mapping[str, torch.Tensor]] = None) -> Any:
    """The reference-layout tree of ``named`` (default: the module's
    parameters, detached): a leaf of one parameter is that tensor (so it
    shares the parameter's storage); a stacked leaf is a new tensor."""
    if named is None:
        named = {n: p.detach() for n, p in model.named_parameters()}
    items = []
    for leaf in layout(model):
        ts = [named[n] for n in leaf.names]
        items.append((leaf.path, torch.stack(ts) if leaf.stacked else ts[0]))
    return from_paths(items)


def load_module_tree(model: nn.Module, tree: Any) -> None:
    """Write a reference-layout ``tree`` into the module's parameters, in
    place (a leaf that already is the parameter's storage is skipped)."""
    params = dict(model.named_parameters())
    by_path = dict(flatten_with_path(tree))
    with torch.no_grad():
        for leaf in layout(model):
            src = by_path[leaf.path]
            for i, n in enumerate(leaf.names):
                dst = params[n]
                part = src[i] if leaf.stacked else src
                if part.data_ptr() == dst.data_ptr() and \
                        part.shape == dst.shape and part.dtype == dst.dtype:
                    continue
                if tuple(part.shape) != tuple(dst.shape):
                    raise ValueError(f"{keystr(leaf.path)}: shape "
                                     f"{tuple(part.shape)} for parameter {n} "
                                     f"{tuple(dst.shape)}")
                dst.copy_(part)

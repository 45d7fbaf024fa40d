"""Structure mapping over feature trees (the port's `jax.tree_util`).

Feature and output trees here are `TensorSpecStruct`s, mappings,
tuples/lists (named tuples too), dataclass instances (a `TrainState`),
or single leaves (numpy arrays, torch tensors, or anything else).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Mapping


def _is_struct(node: Any) -> bool:
  return hasattr(node, "to_flat_dict") and hasattr(node, "from_flat_dict")


def map_structure(fn: Callable, tree: Any, *rest: Any) -> Any:
  """Applies `fn` leaf-wise over `tree` (and same-shaped `rest`)."""
  if _is_struct(tree):
    flats = [t.to_flat_dict() for t in (tree,) + rest]
    return type(tree).from_flat_dict(
        {k: fn(*(f[k] for f in flats)) for k in flats[0]})
  if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
    return dataclasses.replace(tree, **{
        f.name: map_structure(fn, getattr(tree, f.name),
                              *(getattr(r, f.name) for r in rest))
        for f in dataclasses.fields(tree) if f.init})
  if isinstance(tree, Mapping):
    return type(tree)(
        (k, map_structure(fn, tree[k], *(r[k] for r in rest)))
        for k in tree)
  if isinstance(tree, (tuple, list)):
    out = [map_structure(fn, *items) for items in zip(tree, *rest)]
    return type(tree)(out) if not hasattr(tree, "_fields") \
        else type(tree)(*out)
  return fn(tree, *rest)


def leaves(tree: Any) -> List[Any]:
  """The leaves of `tree` in structure order."""
  out: List[Any] = []
  map_structure(out.append, tree)
  return out

"""Frozen dataclasses that are JAX pytrees.

`dataclass` makes a frozen dataclass and registers it with
`jax.tree_util.register_dataclass`: fields declared with
`field(pytree_node=False)` become static metadata kept in the treedef
(shapes, capacities, flags), every other field is a pytree child.
`.replace(**changes)` returns a copy with some fields changed.
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """dataclasses.field with a `pytree_node` flag (False = static)."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls=None, **kwargs):
    """Decorator: frozen dataclass registered as a pytree."""
    if cls is None:
        return lambda c: dataclass(c, **kwargs)
    kwargs.setdefault("frozen", True)
    dc = dataclasses.dataclass(cls, **kwargs)
    fields = [f for f in dataclasses.fields(dc) if f.init]
    data = [f.name for f in fields if f.metadata.get("pytree_node", True)]
    meta = [f.name for f in fields if not f.metadata.get("pytree_node", True)]
    jax.tree_util.register_dataclass(dc, data_fields=data, meta_fields=meta)
    dc.replace = _replace
    return dc

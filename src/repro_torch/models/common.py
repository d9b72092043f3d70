"""Minimal parameter-spec system (the port's ``models/common.py``).

Models are described as nested dicts/lists of ``ParamSpec`` (shape + logical
axes + init), exactly like the JAX package. From one spec tree we derive
``init_params`` (tensors), ``shape_structs`` (meta tensors for the dry-run:
no memory) and ``logical_axes`` (the same tree of logical axis names,
consumed by ``repro_torch.sharding`` to place DTensors). Random leaves draw from an explicit
``torch.Generator``; torch cannot reproduce ``jax.random``, so parity tests
load the JAX package's weights through ``repro_torch.weights`` instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple                  # logical axis names per dim (None = replicated dim)
    init: str = "normal"         # normal | zeros | ones
    scale: Optional[float] = None  # default: 1/sqrt(fan_in)
    dtype: Any = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts/lists (None and empty
    containers pass through), zipping same-structured ``rest`` trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):             # a NamedTuple (AdamWState)
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def tree_paths(tree, prefix=()):
    """(path, leaf) pairs of a tree of dicts, lists and NamedTuples, the
    path its dict keys, list indices and ``.``-prefixed field names joined
    by ``/`` and dict keys visited sorted: the keys and order of the JAX
    package's ``tree_flatten_with_path`` over the same tree (so a JAX
    trainer's ``opt/.step``). None and empty containers have no leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (str(k),))
    elif hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from tree_paths(v, prefix + (f".{k}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def init_params(gen: Optional[torch.Generator], spec_tree, dtype=None,
                device="cuda"):
    """Materialize a spec tree into tensors on ``device``. ``dtype`` overrides
    the spec dtype; normal leaves draw f32 from ``gen`` (scaled by
    ``1/sqrt(fan_in)`` unless the spec gives a scale) and are then cast."""
    def make(spec: ParamSpec):
        dt = dtype or spec.dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=device)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
        scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
        x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return x.mul_(scale).to(dt)
    return tree_map(make, spec_tree)


def stack_specs(spec_tree, n: int, axis_name: Optional[str] = "layers"):
    """Add a leading stacking dim (one slice per layer period)."""
    return tree_map(
        lambda s: ParamSpec((n,) + tuple(s.shape), (axis_name,) + tuple(s.axes),
                            s.init, s.scale, s.dtype), spec_tree)


def shape_structs(spec_tree, dtype=None):
    """Meta tensors of each spec's shape and dtype (``dtype`` overrides):
    the dry-run's stand-ins, which never touch device memory."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype or s.dtype,
                                          device="meta"), spec_tree)


def logical_axes(spec_tree):
    """Tree of logical-axis tuples, same structure as the param tree."""
    return tree_map(lambda s: tuple(s.axes), spec_tree)


def param_bytes(spec_tree, bytes_per_el=4) -> int:
    return sum(math.prod(s.shape) * bytes_per_el
               for s in tree_leaves(spec_tree))


def param_count(spec_tree) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(spec_tree))


class ShardCtx:
    """Sharding-constraint injector threaded through model code.

    ``shard(x, ("batch", None, "heads"))`` redistributes a DTensor ``x`` to
    the placements the logical-axis rules give on the mesh (the JAX
    package's ``with_sharding_constraint``). Without rules or a mesh, or on
    a plain tensor, it returns ``x`` itself."""

    def __init__(self, rules=None, mesh=None):
        self.rules = rules
        self.mesh = mesh

    def __call__(self, x, axes):
        if self.rules is None or self.mesh is None:
            return x
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        from repro_torch.sharding.rules import placements_for, spec_for
        spec = spec_for(self.rules, axes, self.mesh, tuple(x.shape))
        return x.redistribute(self.mesh, placements_for(spec, self.mesh))


NO_SHARD = ShardCtx()

"""Logical-axis sharding rules (MaxText-style) with divisibility fallback.

A *rule set* maps logical axis names (attached to every ParamSpec dim and
every activation constraint in model code) to mesh dimensions. ``spec_for``
resolves a tuple of logical names into a per-dimension spec in the JAX
package's ``PartitionSpec`` form (a tuple of None, a mesh dimension's name
or a tuple of names), dropping mesh dimensions that do not divide the
tensor dimension (replicate instead of pad) and never using a mesh
dimension twice in one spec, so one rule set serves every (arch x shape x
mesh) cell. ``placements_for`` turns that spec into DTensor placements, one
per mesh dimension.
"""
from __future__ import annotations

from typing import Optional, Sequence

# ---- activation rules (used by ShardCtx inside model code) ----
ACT_RULES = {
    "batch": ("pod", "data"),
    "embed": None,
    "seq": None,          # residual-stream sequence dim; "model" = Megatron SP
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "vocab": "model",
    "cache_seq": None,
}

# sequence-parallel residual stream: layer-boundary activations (and the
# remat residuals the backward pass keeps alive) shard over 'model'
SP_ACT = dict(ACT_RULES, seq="model")

# ---- parameter rules ----
TP_RULES = {            # tensor parallel only; weights replicated over data
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "experts_v": None,
    "vocab": "model",
    "layers": None,
    "batch": ("pod", "data"),
    "cache_seq": None,
}
FSDP_RULES = dict(TP_RULES, embed=("pod", "data"))   # + shard d_model rows over data

# long-context decode: shard the KV-cache sequence over data (batch=1 cells)
LONG_CTX_ACT = dict(ACT_RULES, cache_seq="data")
LONG_CTX_PARAM = dict(TP_RULES, cache_seq="data")
LONG_CTX_FSDP = dict(FSDP_RULES, cache_seq="data")


def mesh_dims(mesh) -> dict:
    """{dimension name: size} of a ``DeviceMesh``, of any object with the
    JAX mesh's ``axis_names`` and ``shape`` mapping, or of such a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: mesh.shape[a] for a in mesh.axis_names}


def spec_for(rules: dict, axes: Sequence[Optional[str]], mesh,
             shape: Optional[Sequence[int]] = None) -> tuple:
    """Resolve logical axes -> a per-dimension spec under ``rules`` on
    ``mesh`` (the rules of the JAX package's ``spec_for``)."""
    dims = mesh_dims(mesh)
    used: set[str] = set()
    parts = []
    for i, name in enumerate(axes):
        rule = rules.get(name) if name is not None else None
        if rule is None:
            parts.append(None)
            continue
        cand = (rule,) if isinstance(rule, str) else tuple(rule)
        cand = tuple(a for a in cand if a in dims and a not in used)
        # longest prefix that fits the dim. Uneven sharding (dim % size != 0)
        # is allowed as long as every extra axis still has at least one row
        # per shard (dim >= prod); otherwise replicate.
        take: list[str] = []
        prod = 1
        for a in cand:
            sz = dims[a]
            if shape is not None and shape[i] < prod * sz:
                break
            take.append(a)
            prod *= sz
        if not take:
            parts.append(None)
        else:
            used.update(take)
            parts.append(tuple(take) if len(take) > 1 else take[0])
    return tuple(parts)


def placements_for(spec: Sequence, mesh) -> tuple:
    """One DTensor placement per mesh dimension: ``Shard(i)`` where the
    spec puts that dimension on tensor dimension ``i``, else
    ``Replicate()``. A tensor dimension over two mesh dimensions, such as
    ``("pod", "data")``, is two ``Shard(i)``: DTensor splits it over the
    mesh dimensions in mesh order, so the one that comes first in the mesh
    ("pod") is the outer split, and the device at (pod a, data b) holds
    piece ``a * data + b``, the piece GSPMD gives it. A spec that lists the
    mesh dimensions of a tensor dimension out of mesh order raises
    ``ValueError`` (no DTensor placement splits that way). A mesh
    dimension of size 1 splits nothing: it is ``Replicate()`` (the same
    layout, and DTensor will not flatten a dimension of size 1 that it
    holds sharded, as a one-row batch on a (1, 1) mesh would be)."""
    from torch.distributed.tensor import Replicate, Shard
    dims = mesh_dims(mesh)
    names = list(dims)
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        order = [names.index(a) for a in group]
        if order != sorted(order):
            raise ValueError(f"spec {tuple(spec)} splits dimension {i} over "
                             f"{group}, out of the mesh's order {names}")
        for j in order:
            if dims[names[j]] > 1:
                out[j] = Shard(i)
    return tuple(out)


def _map_leaves(fn, tree, axes):
    """``fn(leaf, axes)`` over the leaves of a tree of dicts, lists and
    NamedTuples, ``axes`` the same tree with a tuple of logical names at
    each leaf (so the tuples are not walked into)."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, axes[k]) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, v, a) for v, a in zip(tree, axes)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, a) for v, a in zip(tree, axes))
    if tree is None:
        return None
    return fn(tree, axes)


def tree_shardings(rules: dict, axes_tree, mesh, struct_tree):
    """Map a logical-axes tree + a tree of tensors (or anything with a
    ``shape``) -> a tree of ``(mesh, placements)``."""
    def one(struct, axes):
        return mesh, placements_for(
            spec_for(rules, axes, mesh, tuple(struct.shape)), mesh)
    return _map_leaves(one, struct_tree, axes_tree)


def replicated(mesh):
    """``(mesh, placements)`` of a tensor every device holds whole."""
    from torch.distributed.tensor import Replicate
    return mesh, tuple(Replicate() for _ in mesh_dims(mesh))


def local_slices(shape: Sequence[int], mesh, placements,
                 coordinate: Optional[Sequence[int]] = None) -> tuple:
    """The slice of a tensor of ``shape`` that the device at
    ``coordinate`` (default this rank's, ``mesh.get_coordinate()``) holds
    under ``placements``: DTensor's chunking, the mesh dimensions taken in
    order, each ``Shard(i)`` cutting the current extent of dimension i into
    ``ceil(extent / n)`` pieces (the last ones shorter or empty)."""
    from torch.distributed.tensor import Shard
    dims = list(mesh_dims(mesh).values())
    coord = mesh.get_coordinate() if coordinate is None else coordinate
    start = [0] * len(shape)
    size = list(shape)
    for j, p in enumerate(placements):
        if isinstance(p, Shard):
            i = p.dim % len(shape)
            chunk = -(-size[i] // dims[j])
            lo = min(coord[j] * chunk, size[i])
            start[i] += lo
            size[i] = max(0, min(chunk, size[i] - lo))
    return tuple(slice(a, a + n) for a, n in zip(start, size))


def from_local(local, mesh, placements, shape):
    """The DTensor of global ``shape`` (contiguous) whose shard on this
    rank is ``local`` (its ``local_slices`` under ``placements``)."""
    from torch.distributed.tensor import DTensor
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=tuple(shape), stride=tuple(reversed(stride)))

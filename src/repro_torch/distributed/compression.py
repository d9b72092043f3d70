"""Gradient compression for cross-replica reduction.

int8 quantized all-reduce: per-tensor symmetric scale -> int8 payload ->
all-reduce in int32 (exact sum of quantized values) -> dequantize. Cuts
gradient-sync bytes 4x vs f32 / 2x vs bf16. ``quantize_int8`` and
``dequantize_int8`` give the JAX package's bits (``torch.round`` and
``jnp.round`` both round half to even). ``group`` is a ``torch.distributed``
process group (a mesh dimension's: ``mesh.get_group("data")``), None for
the default group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.common import tree_map


def _scale(x):
    return torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0


def _quantize(x, scale):
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_int8(x):
    scale = _scale(x)
    return _quantize(x, scale), scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compressed_psum(x, group=None):
    """The sum of ``x`` over ``group`` with an int8 payload.

    The scale itself is max-reduced first (one float) so every rank
    quantizes onto a common grid and the int32 sum is exact."""
    scale = _scale(x).clone()
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    total = _quantize(x, scale).to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.to(torch.float32) * scale


def compressed_pmean(x, group=None):
    n = torch.tensor(float(dist.get_world_size(group)), dtype=torch.float32,
                     device=x.device)
    return compressed_psum(x, group) / n


def tree_compressed_pmean(tree, group=None):
    return tree_map(lambda g: compressed_pmean(g, group), tree)

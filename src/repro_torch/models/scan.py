"""Recurrent scans in checkpointed chunks (the JAX package's per-chunk
``jax.checkpoint`` inside ``lax.scan``).

``scan_chunks(fn, state, xs, n)`` runs ``fn(state, xs_chunk, *consts) ->
(state, ys_chunk)`` over the n equal chunks of ``xs`` along dim 1 and
concatenates the chunks' outputs along dim 1. Where autograd records, each
chunk runs under ``torch.utils.checkpoint`` (non-reentrant), so the
backward keeps the chunk-boundary states and recomputes one chunk at a
time, instead of keeping every step's state. Without autograd it is a plain
loop over the chunks, bit for bit the same computation.

Under a dry-run trace (``launch.optrace.OpTrace``, which sets ``TRACE``) a
scan of n > 3 chunks runs three: chunk 0 and chunk n-1 as they are, and
between them chunk 1 counted for chunks 1 .. n-2 (its forward, and where
autograd records its recompute and backward, under the trace's
``repeat(n - 2)`` scope, through ``_Repeated``), the counterpart of
``launch/hlo.py`` multiplying a ``while`` body by its trip count. The first
and last chunks are traced on their own because they differ from the
middle ones in the backward: chunk 0's input state is the scan's initial
state, which needs no gradient, and the last chunk's output state gets no
gradient from a next chunk (which sets the placements of a middle chunk's
incoming state gradient on a mesh). The outputs keep their full shapes,
and the boundary states the real backward would hold are allocated
(empty) so the trace's live bytes stay those of the real program.
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

# set by ``launch.optrace.OpTrace`` while it traces a step (an object with
# ``once_a_chunk`` and a ``repeat(k)`` context manager), else None
TRACE = None


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _records(*trees) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for tree in trees for t in _tensors(tree))


def _piece(xs, i: int, c: int):
    return tuple(None if a is None else a[:, i * c:(i + 1) * c] for a in xs)


def _cat(ys):
    return ys[0] if len(ys) == 1 else pytree.tree_map(
        lambda *a: torch.cat(a, dim=1), *ys)


def _run(fn, state, xs, consts):
    if _records(state, xs, consts):
        return torch.utils.checkpoint.checkpoint(fn, state, xs, *consts,
                                                 use_reentrant=False)
    return fn(state, xs, *consts)


def scan_chunks(fn, state, xs, n: int, consts=()):
    """``fn`` over the ``n`` chunks of ``xs`` (a tuple of (B, S, ...)
    tensors or None, S a multiple of n) from ``state`` (a tree of
    tensors); ``consts`` (tensors the step reads, such as weights) are
    passed to every chunk as they are. Returns (state, ys), ys the chunks'
    outputs (a tree of (B, c, ...) tensors) joined along dim 1."""
    S = next(a.shape[1] for a in xs if a is not None)
    c = S // n
    if TRACE is not None and TRACE.once_a_chunk and n > 3:
        return _traced(fn, state, xs, n, c, consts)
    ys = []
    for i in range(n):
        state, y = _run(fn, state, _piece(xs, i, c), consts)
        ys.append(y)
    return state, _cat(ys)


def _traced(fn, state, xs, n, c, consts):
    """Chunk 0, chunk 1 counted n - 2 times, chunk n-1 (see the module
    docstring). The outputs of chunks 2 .. n-2 are chunk 1's, repeated:
    the trace reads shapes and counts, never values."""
    state, y0 = _run(fn, state, _piece(xs, 0, c), consts)
    with TRACE.repeat(n - 2):           # a slice may gather on a mesh
        x1 = _piece(xs, 1, c)
    if _records(state, x1, consts):
        flat, spec = pytree.tree_flatten((state, x1, consts))
        out = _Repeated.apply(fn, spec, n - 2, *flat)
        state, y1 = pytree.tree_unflatten(list(out[1:]), out[0])
    else:
        with TRACE.repeat(n - 2):
            state, y1 = fn(state, x1, *consts)
    tiled = pytree.tree_map(lambda a: _Tile.apply(a, n - 2), y1)
    state, y_last = _run(fn, state, _piece(xs, n - 1, c), consts)
    return state, _cat([y0, tiled, y_last])


class _Tile(torch.autograd.Function):
    """y repeated k times along dim 1; the gradient is that of the first
    copy (chunk 1's own), the one ``_Repeated`` counts k times."""

    @staticmethod
    def forward(ctx, y, k):
        ctx.c = y.shape[1]
        return torch.cat([y] * k, dim=1)

    @staticmethod
    def backward(ctx, g):
        return g[:, :ctx.c], None


class _Repeated(torch.autograd.Function):
    """One chunk whose forward, recompute and backward the trace counts
    ``k`` times: a checkpoint written out, run inside ``TRACE.repeat(k)``.
    It also holds k - 1 empty copies of the input state: with its own
    input state, the boundary states the real backward keeps for the k
    chunks it stands for."""

    @staticmethod
    def forward(ctx, fn, spec, k, *flat):
        ctx.fn, ctx.spec, ctx.k = fn, spec, k
        ctx.save_for_backward(*[t if isinstance(t, torch.Tensor) else None
                                for t in flat])
        state, xs, consts = pytree.tree_unflatten(list(flat), spec)
        ctx.boundaries = [[torch.empty_like(t) for t in _tensors(state)]
                          for _ in range(k - 1)]
        with TRACE.repeat(k):
            state, y = fn(state, xs, *consts)
        out, ospec = pytree.tree_flatten((state, y))
        return (ospec, *out)

    @staticmethod
    def backward(ctx, _spec, *grads):
        flat = list(ctx.saved_tensors)
        leaves = [t.detach().requires_grad_(t.requires_grad)
                  if isinstance(t, torch.Tensor) else t for t in flat]
        state, xs, consts = pytree.tree_unflatten(leaves, ctx.spec)
        with TRACE.repeat(ctx.k), torch.enable_grad():
            out = pytree.tree_leaves(ctx.fn(state, xs, *consts))
            wrt = [t for t in leaves
                   if isinstance(t, torch.Tensor) and t.requires_grad]
            got = iter(torch.autograd.grad(
                out, wrt, [torch.zeros_like(o) if g is None else g
                           for o, g in zip(out, grads)], allow_unused=True))
        ctx.boundaries = None
        return (None, None, None) + tuple(
            next(got) if isinstance(t, torch.Tensor) and t.requires_grad
            else None for t in leaves)

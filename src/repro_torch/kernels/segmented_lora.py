"""Segmented multi-adapter LoRA (SGMV): the CUDA kernel's wrapper plus the
host-side helpers that sort a co-batch by adapter.

The vFM executor co-batches requests from many tasks over one shared backbone
pass and applies per-task LoRA deltas: y[t] += x[t] @ A[a(t)] @ B[a(t)]. The
batch is sorted by adapter id and each adapter segment padded to a block
multiple, so every ``block_t`` block of rows touches exactly ONE adapter
(``csrc/segmented_lora.cu``: a shrink kernel computes h = x_blk @ A over
splits of d, an expand kernel sums the splits and writes h @ B). The
sentinel id ``>= num_adapters`` means "no adapter" (base-model request):
zero delta.

The host helpers (``sort_by_adapter``, ``segment_metadata``,
``SegmentMetaCache``, ``padded_tokens``) are copies of the JAX package's.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build

_RANKS = (4, 8, 16, 32, 64)
_MIN_SPLIT = 64                  # rows of d a shrink CTA takes at least
_MAX_SPLITS = 16                 # partials the expand loads at once
_WORKSPACE: dict = {}            # device index -> f32 scratch
_OUTGROWN: list = []             # earlier workspaces a captured graph may use


def _lib():
    lib = build.load("segmented_lora")
    if not getattr(lib, "_typed", False):
        lib.sgmv_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
            + [ctypes.c_void_p]
        lib.sgmv_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def d_splits(num_blocks: int, d: int, sms: int) -> tuple[int, int]:
    """(number of splits, rows per split) of the shrink's d axis for
    ``num_blocks`` token blocks on ``sms`` SMs: about one shrink CTA per SM
    when the blocks are few (decode), one split once the blocks alone fill
    the card (pooled); each split a multiple of 8 rows and at least
    ``_MIN_SPLIT``, and at most ``_MAX_SPLITS`` (the expand sums every
    block's partials: up to 16 are one round of loads). Shapes only: no
    host sync."""
    n = max(1, min(sms // max(num_blocks, 1), d // _MIN_SPLIT, _MAX_SPLITS))
    split_len = 8 * -(-(-(-d // n)) // 8)
    return -(-d // split_len), split_len


def _workspace(device, n: int):
    """At least ``n`` f32 of shrink partials: one buffer per device, kept
    between calls (the port launches on one stream at a time, eager calls
    and graph replays alike, so one call's expand has read it before the
    next call's shrink writes), grown on demand. Allocating per call would
    add host time to every one of a step's K1 calls. A graph captured with
    the buffer bakes its address, so an outgrown buffer is kept, never
    freed; and the buffer is never allocated during a capture (it would
    come from that graph's private pool): an executable's eager first call
    sizes it for its key before the capture."""
    ws = _WORKSPACE.get(device.index)
    if ws is None or ws.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the segmented_lora workspace must be sized by "
                               "an eager call before a capture")
        if ws is not None:
            _OUTGROWN.append(ws)
        ws = _WORKSPACE[device.index] = torch.empty(
            (max(n, 1 << 16),), dtype=torch.float32, device=device)
    return ws


def segmented_lora(x, block_adapter, a_w, b_w, *, block_t: int):
    """Launch the SGMV kernel. x: (T, d) bf16 CUDA, T % block_t == 0;
    block_adapter: (T // block_t,) int32; a_w: (NA, d, r) f32;
    b_w: (NA, r, out) f32. Returns the delta (T, out) bf16."""
    T, d = x.shape
    na, d_a, r = a_w.shape
    out = b_w.shape[-1]
    if x.device.type != "cuda":
        raise ValueError("segmented_lora kernel takes CUDA tensors")
    if x.dtype != torch.bfloat16 or a_w.dtype != torch.float32 \
            or b_w.dtype != torch.float32:
        raise TypeError(f"segmented_lora kernel takes bf16 x and f32 A/B, got "
                        f"{x.dtype}, {a_w.dtype}, {b_w.dtype}")
    if d_a != d or tuple(b_w.shape[:2]) != (na, r) or r not in _RANKS:
        raise ValueError(f"bad shapes x{tuple(x.shape)} A{tuple(a_w.shape)} "
                         f"B{tuple(b_w.shape)} (rank must be one of {_RANKS})")
    if T % block_t or block_t % 4 or 256 % ((block_t // 4) * (r // 4)):
        raise ValueError(f"T={T} must be a multiple of block_t={block_t}, "
                         f"block_t a multiple of 4, and (block_t/4)*(r/4) "
                         f"must divide 256")
    nb = T // block_t
    if block_adapter.shape != (nb,) or block_adapter.dtype != torch.int32:
        raise ValueError("block_adapter must be (T // block_t,) int32")
    for t in (x, block_adapter, a_w, b_w):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError("segmented_lora kernel takes contiguous tensors "
                             "on one device")
    if a_w.data_ptr() % 16 or x.data_ptr() % 16 or d % 8:
        raise ValueError("x and A must be 16-byte aligned and d a multiple "
                         "of 8 (read as 16-byte vectors)")
    y = torch.empty((T, out), dtype=x.dtype, device=x.device)
    if nb == 0:
        return y
    nsplit, split_len = d_splits(nb, d, build.sm_count(x.device.index or 0))
    stream = build.current_stream(x.device.index or 0)
    ws = _workspace(x.device, nb * nsplit * block_t * r)
    err = _lib().sgmv_launch(x.data_ptr(), block_adapter.data_ptr(),
                             a_w.data_ptr(), b_w.data_ptr(), y.data_ptr(),
                             ws.data_ptr(), nb, d, r, out, na, block_t,
                             nsplit, split_len, stream)
    build.LAUNCHES["segmented_lora"] += 1
    build.check(err, "segmented_lora")
    return y


# ---------------- host-side helpers (copies of the JAX package's) ----------------

def sort_by_adapter(adapter_ids, num_adapters: int, block_t: int = 128,
                    max_tokens: int | None = None):
    """Build (permutation, block_adapter, padded_T) so each ``block_t`` block
    maps to one adapter (one stable argsort + one ``np.unique``). Returns
    numpy arrays; ``perm`` holds -1 for pad rows."""
    adapter_ids = np.asarray(adapter_ids)
    n = len(adapter_ids)
    order = np.argsort(adapter_ids, kind="stable")
    uniq, counts = np.unique(adapter_ids, return_counts=True)
    padded = -(-counts // block_t) * block_t           # per-segment block pad
    blocks = np.repeat(uniq, padded // block_t)
    total = int(padded.sum())
    # destination of each sorted row: its segment's start + rank within it
    seg_starts = np.concatenate([[0], np.cumsum(padded)[:-1]])
    src_starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    perm = np.full(total, -1, np.int64)
    perm[np.repeat(seg_starts - src_starts, counts) + np.arange(n)] = order
    if max_tokens is not None:
        if total > max_tokens:
            raise ValueError(f"{total} sorted tokens exceed max_tokens={max_tokens}")
        blocks = np.concatenate(
            [blocks, np.full((max_tokens - total) // block_t, num_adapters)])
        perm = np.concatenate([perm, np.full(max_tokens - total, -1)])
        total = max_tokens
    return (perm.astype(np.int32), blocks.astype(np.int32), total)


def segment_metadata(adapter_ids, num_adapters: int, block_t: int = 128,
                     max_tokens: int | None = None):
    """Serve-path metadata, built ONCE per co-batch and reused by every
    attention sublayer: ``(perm, inv, block_adapter)`` numpy arrays. ``perm``
    gathers the flat token stream into sorted, block-padded order (pad rows
    clamped to token 0: their deltas are computed and then dropped);
    ``inv`` gathers the kernel output back to token order."""
    raw_perm, blocks, total = sort_by_adapter(
        adapter_ids, num_adapters, block_t=block_t, max_tokens=max_tokens)
    real = raw_perm >= 0
    inv = np.zeros(len(adapter_ids), np.int32)
    inv[raw_perm[real]] = np.nonzero(real)[0].astype(np.int32)
    perm = np.where(real, raw_perm, 0).astype(np.int32)
    return perm, inv, blocks


class SegmentMetaCache:
    """Memoizes ``segment_metadata`` per batch *composition* (raw id bytes
    plus the static shape inputs), FIFO-evicted at ``maxsize``. ``builds``
    counts misses: steady-state decode must keep it flat."""

    def __init__(self, maxsize: int = 128):
        self._cache: dict = {}
        self.maxsize = maxsize
        self.builds = 0

    def get(self, adapter_ids, num_adapters: int, block_t: int,
            max_tokens: int | None):
        ids = np.ascontiguousarray(np.asarray(adapter_ids, np.int32))
        key = (ids.tobytes(), num_adapters, block_t, max_tokens)
        hit = self._cache.get(key)
        if hit is None:
            self.builds += 1
            hit = segment_metadata(ids, num_adapters, block_t=block_t,
                                   max_tokens=max_tokens)
            if len(self._cache) >= self.maxsize:
                self._cache.pop(next(iter(self._cache)))
            self._cache[key] = hit
        return hit


def padded_tokens(n_tokens: int, max_segments: int, block_t: int) -> int:
    """Tight static bound on the sorted/padded token count when up to
    ``max_segments`` adapter segments each pad to a block multiple:
    ``((n - s)//bt + s) * bt`` with ``s = min(max_segments, n)``."""
    s = min(max_segments, max(n_tokens, 1))
    return (max(0, n_tokens - s) // block_t + s) * block_t

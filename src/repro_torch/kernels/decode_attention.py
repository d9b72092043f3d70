"""Float-cache GQA flash-decode: the CUDA kernel's wrapper (K5).

Every single-token attention against a bf16 cache runs here: the decoder's
cross-attention decode of an encoder-decoder stack (per-slot encoder K/V,
every row at its full length) and the self-attention decode of a float
dense pool (``DecodeEngine(kv_quant=False)``). ``csrc/decode_attention.cu``
reads the cache in the model layout (B, S, KV, hd) through its strides.
When the (row, kv head) pairs are too few to fill the card, the wrapper
splits the positions over several CTAs, which the kernel launches as one
thread-block cluster per pair and merges, in split order, through
distributed shared memory. The split depends on the shapes only, never on
the lengths, so choosing it needs no host sync.

A piece of a cache split over its sequence (``key_offset``, the global
position of its first key) attends the part of the global range that it
holds; with ``return_lse`` the call returns f32 output and each head's
log-sum-exp, which ``ref.merge_partials`` combines across the pieces.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build

_HEAD_DIMS = (32, 64, 80, 128)
_GROUPS = (1, 2, 4, 7, 8)
_MIN_SPLIT = 256            # positions per split at least (8 chunks of 32)
_MAX_SPLITS = 8             # a pair's splits are one cluster: portable size
_CTAS_PER_SM = 2            # the split stops at this many CTAs an SM


def _lib():
    lib = build.load("decode_attention")
    if not getattr(lib, "_typed", False):
        lib.decode_attention_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
            + [ctypes.c_int64] * 6 + [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_float, ctypes.c_void_p])
        lib.decode_attention_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def splits(pairs: int, S: int, sms: int) -> tuple[int, int]:
    """(number of splits, positions per split) for ``pairs`` (row, kv head)
    CTAs over ``S`` positions: ``build.key_splits`` in chunks of 32, at
    least ``_MIN_SPLIT`` positions a split and at most ``_MAX_SPLITS``
    splits, and no more CTAs than ``_CTAS_PER_SM`` an SM, so that the grid
    runs in one wave."""
    return build.key_splits(pairs, S, 32,
                            max(_MIN_SPLIT, -(-S // _MAX_SPLITS)), sms,
                            slots=_CTAS_PER_SM * sms)


def decode_attention(q, k, v, lengths, *, window: Optional[int] = None,
                     key_offset: int = 0, return_lse: bool = False):
    """Launch the float flash-decode kernel.

    q: (B, H, hd) bf16 CUDA, contiguous; k/v: (B, S, KV, hd) bf16 with any
    strides but a unit hd stride and 16-byte aligned rows (a view into a
    pool is taken as is); lengths: (B,) int32 CUDA, read on the device.
    H = KV * G with G in (1, 2, 4, 7, 8), hd in (32, 64, 80, 128).
    Returns (B, H, hd) bf16. A row with no valid position returns zeros.
    ``key_offset``: the global position of local key 0 (a piece of a
    cache split over its sequence); the call attends global positions
    [max(0, len - window), len) that lie in [key_offset, key_offset + S).
    ``return_lse``: return (o (B, H, hd) f32, lse (B, H) f32), lse the
    natural log-sum-exp of the scaled scores the call saw (-inf, with o
    0, where it saw none)."""
    if q.device.type != "cuda":
        raise ValueError("decode_attention kernel takes CUDA tensors")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"decode_attention kernel takes bf16 {name}, got "
                            f"{t.dtype}")
    B, H, hd = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != hd or \
            tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k/v must be (B={B}, S, KV, hd={hd}) alike, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    S, KV = k.shape[1], k.shape[2]
    G = H // max(KV, 1)
    if H % KV or hd not in _HEAD_DIMS or G not in _GROUPS:
        raise ValueError(f"unsupported H={H}, KV={KV}, hd={hd} (hd in "
                         f"{_HEAD_DIMS}, H/KV in {_GROUPS})")
    for t in (k, v):
        if t.stride(3) != 1 or t.data_ptr() % 16 or \
                any(s % 8 for s in t.stride()[:3]):
            raise ValueError("K/V rows must have unit hd stride and be "
                             "16-byte aligned")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if tuple(lengths.shape) != (B,) or lengths.dtype != torch.int32 or \
            lengths.device != q.device or not lengths.is_contiguous():
        raise ValueError(f"lengths must be a contiguous ({B},) int32 tensor "
                         f"on {q.device}, got {lengths.dtype} "
                         f"{tuple(lengths.shape)} on {lengths.device}")
    if not 0 <= key_offset < 2 ** 31 - S:
        raise ValueError(f"key_offset {key_offset} out of range")
    out = torch.empty_like(q)
    out_f32 = lse = None
    if return_lse:
        out_f32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.empty((B, H), dtype=torch.float32, device=q.device)
    if B == 0 or S == 0:
        return (out_f32.zero_(), lse.fill_(-math.inf)) if return_lse else \
            out.zero_()
    nsplit, split_len = splits(B * KV, S,
                               build.sm_count(q.device.index or 0))
    stream = build.current_stream(q.device.index or 0)
    err = _lib().decode_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), None if out_f32 is None else out_f32.data_ptr(),
        None if lse is None else lse.data_ptr(), B, KV, G, S, hd, nsplit,
        split_len, *k.stride()[:3], *v.stride()[:3],
        -1 if window is None else int(window), int(key_offset),
        1.0 / math.sqrt(hd), stream)
    build.LAUNCHES["decode_attention"] += 1
    build.check(err, "decode_attention")
    return (out_f32, lse) if return_lse else out

"""int8-KV flash-decode: ``quantize_kv`` and the CUDA kernel's wrapper.

Decode is bound by the bytes of the KV cache. Storing K/V as int8 with a
per-(batch, kv-head) symmetric scale halves them; ``csrc/
decode_attention_int8.cu`` dequantizes in registers, so device memory only
ever streams int8. The error per element is at most scale/2.

A piece of a cache split over its sequence (``key_offset``, the global
position of its first key) attends the part of the global range that it
holds; with ``return_lse`` the call returns f32 output and each head's
log-sum-exp, which ``models.attention.merge_partials`` combines across the
pieces (K5's conventions).

Two kernel bodies compute the function (``plan`` picks one from shapes
only, so choosing needs no host sync and a CUDA graph captures it): one CTA
per (row, kv head) pair (``csrc/int8_decode.cuh``), where the pairs fill
the card and a row's span is one or two of that body's rounds; and the
split body (``csrc/int8_split_decode.cuh``), whose CTAs each take a share
of a pair's keys and, for more than one split, a second launch that merges
their partials in split order.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional

import torch

from repro_torch.kernels import build

_HEAD_DIMS = (32, 64, 80, 128)
_GROUPS = (1, 2, 4, 6, 7, 8)
_MIN_SPLIT = 256            # keys a split at least
_CTAS_PER_SM = 2            # the splits stop at this many CTAs an SM
_META_SMS = 132             # an H100's SMs: the dry-run's plan (meta tensors)

# calls by body: "cta" (one CTA a pair), "split" (the split body, one split)
# and "merge" (several splits and the merge launch); read by chip_smoke to
# show which bodies a run went through
PATHS: collections.Counter = collections.Counter()


def _round_keys(hd: int, G: int) -> int:
    """Keys one round of the one-CTA body covers (``Tile<HD, G>`` in
    ``csrc/int8_decode.cuh``: kDepth passes of a CTA pass)."""
    dpl = 16 if G <= 1 else (8 if G == 2 else 4)
    lpa = hd // dpl
    lpp = next(n for n in (2, 4, 8, 16, 32) if lpa <= n)
    depth = 6 if G in (6, 7) else min(96 // dpl, 8)
    return depth * (32 // lpp) * 4


def pass_keys(hd: int) -> int:
    """Keys one pass of a split-body CTA covers (``SplitTile<HD>::PASS``:
    4 warps of 16, 32 or 64 keys)."""
    return 4 * 16 * (1 if hd >= 128 else 2 if hd >= 64 else 4)


@functools.lru_cache(maxsize=None)
def plan(B: int, KV: int, G: int, hd: int, S: int, window: Optional[int],
         sms: int) -> tuple[str, int]:
    """(body, splits) for a call on ``B`` rows of a (B, KV, S, hd) cache.

    The span a row can attend is ``min(window, S)`` with a window, else
    ``S``; it is split over CTAs by ``build.key_splits`` (at most
    ``_CTAS_PER_SM`` CTAs an SM over the grid, so one wave; each split a
    multiple of a CTA pass and at least ``_MIN_SPLIT`` keys). One split
    over a span of at most two of the one-CTA body's rounds keeps that
    body ("cta"); anything else runs the split body ("split" with one
    split, "merge" with several). Shapes only, never lengths. The
    constants and the boundary come from ``tools/k3_plan.py`` (``PERF.md``
    §6)."""
    span = S if window is None or window <= 0 else min(int(window), S)
    n, _ = build.key_splits(B * KV, span, pass_keys(hd), _MIN_SPLIT, sms,
                            slots=_CTAS_PER_SM * sms)
    if n == 1 and span <= 2 * _round_keys(hd, G):
        return "cta", 1
    return ("split" if n == 1 else "merge"), n


def workspace_floats(B: int, KV: int, G: int, hd: int, nsplit: int) -> int:
    """f32 elements of the partials of ``nsplit`` > 1 splits: each CTA's
    G x hd accumulator and G (max, sum) pairs."""
    return B * KV * nsplit * G * (hd + 2) if nsplit > 1 else 0


def quantize_kv(k, v):
    """k, v: (B, KV, S, hd) float -> (k_q, v_q int8, k_scale, v_scale (B, KV)).
    Symmetric: scale = max|x| / 127 (at least 1e-8 / 127), codes clipped to
    +-127."""
    def q(x):
        scale = torch.clamp(x.abs().amax(dim=(2, 3)), min=1e-8) / 127.0
        xq = torch.clamp(torch.round(x / scale[:, :, None, None]), -127, 127)
        return xq.to(torch.int8), scale.float()
    kq, ks = q(k.float())
    vq, vs = q(v.float())
    return kq, vq, ks, vs


def _lib():
    lib = build.load("decode_attention_int8")
    if not getattr(lib, "_typed", False):
        lib.decode_int8_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
            + [ctypes.c_int64] * 6 + [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_float, ctypes.c_void_p])
        lib.decode_int8_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def decode_attention_int8(q, k_q, v_q, k_scale, v_scale, lengths, *,
                          window: Optional[int] = None, key_offset: int = 0,
                          return_lse: bool = False):
    """Launch the int8 flash-decode kernel.

    q: (B, H, hd) bf16 CUDA, contiguous; k_q/v_q: (B, KV, S, hd) int8 with
    any strides but a unit hd stride and 16-byte aligned rows (the model
    layout's transposed view is taken as is, never copied); k_scale/v_scale:
    (B, KV) f32 (callers guard free slots' unwritten zeros); lengths: (B,)
    int32. Returns (B, H, hd) in q's dtype. ``key_offset``: the global
    position of local key 0 (a piece of a cache split over its sequence);
    the call attends global positions [max(0, len - window), len) that lie
    in [key_offset, key_offset + S). ``return_lse``: return (o (B, H, hd)
    f32, lse (B, H) f32), lse the natural log-sum-exp of the scaled scores
    the call saw (-inf, with o 0, where it saw none); o rounds to the bf16
    output of a call without it."""
    B, H, hd = q.shape
    _, KV, S, _ = k_q.shape
    if q.device.type != "cuda":
        raise ValueError("decode_attention_int8 kernel takes CUDA tensors")
    if q.dtype != torch.bfloat16 or k_q.dtype != torch.int8 \
            or v_q.dtype != torch.int8:
        raise TypeError(f"decode_attention_int8 kernel takes bf16 q and int8 "
                        f"K/V, got {q.dtype}, {k_q.dtype}, {v_q.dtype}")
    G = H // max(KV, 1)
    if H % KV or hd not in _HEAD_DIMS or G not in _GROUPS:
        raise ValueError(f"unsupported H={H}, KV={KV}, hd={hd} (hd in "
                         f"{_HEAD_DIMS}, H/KV in {_GROUPS})")
    if tuple(v_q.shape) != tuple(k_q.shape) or k_q.shape[0] != B:
        raise ValueError("k_q/v_q must be (B, KV, S, hd) alike")
    for t in (k_q, v_q):
        if t.stride(3) != 1 or t.data_ptr() % 16 or \
                any(s % 16 for s in t.stride()[:3]):
            raise ValueError("K/V rows must have unit hd stride and be "
                             "16-byte aligned")
    for t, shape, dt in ((k_scale, (B, KV), torch.float32),
                         (v_scale, (B, KV), torch.float32),
                         (lengths, (B,), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"expected contiguous {dt} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("q must be contiguous and 16-byte aligned")
    if lengths.device != q.device:
        raise ValueError(f"lengths must be on {q.device}, got "
                         f"{lengths.device}")
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
    index = q.device.index or 0
    body, nsplit = plan(B, KV, G, hd, S, window, build.sm_count(index))
    work = None
    if body == "merge":
        work = torch.empty(workspace_floats(B, KV, G, hd, nsplit),
                           dtype=torch.float32, device=q.device)
    stream = build.current_stream(index)
    err = _lib().decode_int8_launch(
        q.data_ptr(), k_q.data_ptr(), v_q.data_ptr(), k_scale.data_ptr(),
        v_scale.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if out_f32 is None else out_f32.data_ptr(),
        None if lse is None else lse.data_ptr(),
        None if work is None else work.data_ptr(), B, KV, G, S, hd,
        0 if body == "cta" else nsplit, *k_q.stride()[:3], *v_q.stride()[:3],
        -1 if window is None else int(window), int(key_offset),
        1.0 / math.sqrt(hd), stream)
    build.LAUNCHES["decode_attention_int8"] += 1
    PATHS[body] += 1
    build.check(err, "decode_attention_int8")
    return (out_f32, lse) if return_lse else out

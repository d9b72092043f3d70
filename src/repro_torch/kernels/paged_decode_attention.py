"""Paged int8-KV flash-decode: the CUDA kernel's wrapper (K4).

The paged pool keeps one arena of fixed-size int8 pages shared by every
decode slot, with a per-(page, kv-head) scale pair and a per-slot page
table, so a stream holds only the pages its tokens occupy.
``csrc/paged_decode_attention.cu`` gathers each stream's pages through its
table row inside the kernel and dequantizes in registers: device memory
only ever streams the int8 pages a stream holds. It reads the arena in the
model layout ``(P, ps, KV, hd)`` through its strides, never a transposed
copy.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention_int8 import _GROUPS, _HEAD_DIMS


def _lib():
    lib = build.load("paged_decode_attention")
    if not getattr(lib, "_typed", False):
        lib.paged_decode_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
            + [ctypes.c_int64] * 6 + [ctypes.c_int, ctypes.c_float,
                                      ctypes.c_void_p])
        lib.paged_decode_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(t, shape, dtype, name):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def paged_decode_attention(q, k_pages, v_pages, k_scale, v_scale, page_table,
                           lengths, *, window: Optional[int] = None):
    """Launch the paged int8 flash-decode kernel.

    q: (B, H, hd) bf16 CUDA, contiguous; k_pages/v_pages: (P, ps, KV, hd)
    int8 arena in the model layout, any page/position/head strides but a
    unit hd stride and 16-byte aligned rows; k_scale/v_scale: (P, KV) f32;
    page_table: (B, MP) int32 (entries past a stream's last page are never
    read; the caller keeps them 0); lengths: (B,) int32. Returns (B, H, hd)
    in q's dtype."""
    B, H, hd = q.shape
    P, ps, KV, _ = k_pages.shape
    if q.device.type != "cuda":
        raise ValueError("paged_decode_attention kernel takes CUDA tensors")
    if q.dtype != torch.bfloat16 or k_pages.dtype != torch.int8 \
            or v_pages.dtype != torch.int8:
        raise TypeError(f"paged_decode_attention kernel takes bf16 q and int8 "
                        f"pages, got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    G = H // max(KV, 1)
    if H % KV or hd not in _HEAD_DIMS or G not in _GROUPS:
        raise ValueError(f"unsupported H={H}, KV={KV}, hd={hd} (hd in "
                         f"{_HEAD_DIMS}, H/KV in {_GROUPS})")
    if tuple(v_pages.shape) != tuple(k_pages.shape) or k_pages.shape[3] != hd:
        raise ValueError("k_pages/v_pages must be (P, ps, KV, hd) alike")
    for t in (k_pages, v_pages):
        if t.stride(3) != 1 or t.data_ptr() % 16 or \
                any(s % 16 for s in t.stride()[:3]):
            raise ValueError("page rows must have unit hd stride and be "
                             "16-byte aligned")
    if page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(f"page_table must be (B={B}, MP), got "
                         f"{tuple(page_table.shape)}")
    MP = page_table.shape[1]
    _check(q, (B, H, hd), torch.bfloat16, "q")
    _check(k_scale, (P, KV), torch.float32, "k_scale")
    _check(v_scale, (P, KV), torch.float32, "v_scale")
    _check(page_table, (B, MP), torch.int32, "page_table")
    _check(lengths, (B,), torch.int32, "lengths")
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")
    out = torch.empty_like(q)
    stream = build.current_stream(q.device.index or 0)
    err = _lib().paged_decode_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), B, KV, G, P, ps, MP, hd,
        k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
        -1 if window is None else int(window), 1.0 / math.sqrt(hd), stream)
    build.LAUNCHES["paged_decode_attention"] += 1
    build.check(err, "paged_decode_attention")
    return out

"""The speculative verify window on the paged int8 pool: the CUDA kernel's
wrapper (K4 over T window positions).

A verify step scores the T = spec_k + 1 positions of every stream's window
in one forward, and window position j attends ``base_len + j + 1`` keys.
``csrc/paged_verify_attention.cu`` runs the body K4's plan picks at the
same shapes (``paged_decode_attention.plan``), so that each position's
output is bit-identical to a K4 call's at its length: where K4 keeps its
one-CTA body, one CTA per (row, kv head, position), that body in a leaner
register form so that six CTAs share an SM; elsewhere K4's split body, one
walk over a cell's pages for all T positions, their G T heads the rows of
the tensor-core products, each masked at its own length (the JAX package's
XLA path gathers the pages once for all T positions; its Pallas path
unrolls T single-token calls). The arena is read in the model layout
``(P, ps, KV, hd)`` through its strides. One launch a call, or two (the
split body, then the merge of its cells).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels import paged_decode_attention as k4
from repro_torch.kernels.decode_attention_int8 import _GROUPS, _HEAD_DIMS


def _lib():
    lib = build.load("paged_verify_attention")
    if not getattr(lib, "_typed", False):
        lib.paged_verify_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
            + [ctypes.c_int64] * 10 + [ctypes.c_int, ctypes.c_float,
                                       ctypes.c_void_p])
        lib.paged_verify_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(t, shape, dtype, name):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)}, "
                         f"got {t.dtype} {tuple(t.shape)}")


def paged_verify_attention(q, k_pages, v_pages, k_scale, v_scale, page_table,
                           base_len, *, window: Optional[int] = None):
    """Launch the verify-window kernel.

    q: (B, T, H, hd) bf16 CUDA, contiguous; k_pages/v_pages: (P, ps, KV, hd)
    int8 arena in the model layout (unit hd stride, 16-byte aligned rows);
    k_scale/v_scale: (P, KV) f32; page_table: (B, MP) int32; base_len: (B,)
    int32, window position j attending ``base_len + j + 1`` keys. Returns
    (B, T, H, hd) in q's dtype, each position bit-identical to
    ``paged_decode_attention`` at its length."""
    B, T, H, hd = q.shape
    P, ps, KV, _ = k_pages.shape
    if q.device.type != "cuda":
        raise ValueError("paged_verify_attention kernel takes CUDA tensors")
    if q.dtype != torch.bfloat16 or k_pages.dtype != torch.int8 \
            or v_pages.dtype != torch.int8:
        raise TypeError(f"paged_verify_attention kernel takes bf16 q and int8 "
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
    _check(q, (B, T, H, hd), torch.bfloat16, "q")
    _check(k_scale, (P, KV), torch.float32, "k_scale")
    _check(v_scale, (P, KV), torch.float32, "v_scale")
    _check(page_table, (B, MP), torch.int32, "page_table")
    _check(base_len, (B,), torch.int32, "base_len")
    if q.data_ptr() % 16:
        raise ValueError("q must be 16-byte aligned")
    out = torch.empty_like(q)
    index = q.device.index or 0
    sp = k4.split_for(B, KV, G, hd, MP * ps, window, T,
                      build.sm_count(index))
    work = None
    if sp.work:
        work = torch.empty(sp.work, dtype=torch.float32, device=q.device)
    stream = build.current_stream(index)
    err = _lib().paged_verify_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(),
        base_len.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), B, KV, G, T, P, ps, MP,
        hd, sp.cell, sp.nsplit, k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        v_pages.stride(0), v_pages.stride(1), v_pages.stride(2), q.stride(0),
        q.stride(1), out.stride(0), out.stride(1),
        -1 if window is None else int(window), 1.0 / math.sqrt(hd), stream)
    build.LAUNCHES["paged_verify_attention"] += 1
    build.LAUNCHES[f"paged_verify_attention/{sp.body}"] += 1
    build.check(err, "paged_verify_attention")
    return out

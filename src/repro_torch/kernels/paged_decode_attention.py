"""Paged int8-KV flash-decode: the CUDA kernel's wrapper (K4).

The paged pool keeps one arena of fixed-size int8 pages shared by every
decode slot, with a per-(page, kv-head) scale pair and a per-slot page
table, so a stream holds only the pages its tokens occupy.
``csrc/paged_decode_attention.cu`` gathers each stream's pages through its
table row inside the kernel and dequantizes in registers: device memory
only ever streams the int8 pages a stream holds. It reads the arena in the
model layout ``(P, ps, KV, hd)`` through its strides, never a transposed
copy.

Two kernel bodies compute the function, picked by ``plan`` from shapes
only (no host sync; a CUDA graph captures the choice): one CTA per (row,
kv head) pair (``csrc/int8_decode.cuh``), where the pairs fill the card
over short spans (stablelm's and whisper's pools), and the split body
(``csrc/int8_split_decode.cuh``), whose CTAs each take one cell of a grid
of absolute positions (``cell`` keys) of a pair's pages, with a second
launch that merges the cells in order where a row meets several. The
verify window (``paged_verify_attention``) takes the same plan, so that
each of its positions keeps K4's bits at its length.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention_int8 import (_GROUPS, _HEAD_DIMS,
                                                       _round_keys)

_CELL_KEYS = 64             # a cell is whole CTA passes of 4 warps x 16 keys
_MIN_CELL = 256             # keys a cell at least
_MAX_CELL = 8192            # and at most (its share of the table row is staged)
_CTAS_PER_SM = 2            # the cells a row meets stop at this many CTAs an SM
_META_SMS = 132             # an H100's SMs: the dry-run's plan (meta tensors)


class Split(NamedTuple):
    """What one call of K4 or the verify window launches."""
    body: str       # "cta" (one CTA a pair; the verify window: a position),
                    # "split" (the split body, one cell) or "merge" (several
                    # cells, then the merge launch)
    nsplit: int     # cells a pair walks; 0 for the one-CTA body
    cell: int       # keys a cell; 0 for the one-CTA body
    work: int       # f32 elements of the cells' partials; 0 for one cell


def cells_met(span: int, S: int, cell: int, windowed: bool) -> int:
    """The most cells of ``cell`` keys of the grid over [0, S) that the
    range of one row can meet: a window's range of ``span`` keys starts
    anywhere, so it meets one cell more than ``span / cell`` (at most every
    cell); without a window a range starts at 0."""
    total = -(-S // cell)
    if not windowed:
        return total
    return max(1, min(total, (span - 1) // cell + 2))


@functools.lru_cache(maxsize=None)
def plan(B: int, KV: int, G: int, hd: int, S: int, window: Optional[int],
         sms: int) -> tuple[str, int]:
    """(body, cell keys) for K4 on ``B`` rows of a table of ``S`` = MP * ps
    positions: ("cta", 0), the one-CTA body, or ("split", cell), the
    split body over cells of ``cell`` keys.

    A row attends ``span`` = min(window, S) positions with a window, else
    S. Enough cells a pair for at most ``_CTAS_PER_SM`` CTAs an SM over the
    grid (one wave), counting the extra cell a window's range meets; each
    cell a multiple of a CTA pass (64 keys), between ``_MIN_CELL`` and
    ``_MAX_CELL`` keys. One cell a pair over at most two of the one-CTA
    body's rounds keeps that body. Shapes only, never lengths. The
    constants come from ``tools/k3_plan.py`` (``PERF.md`` §6)."""
    windowed = window is not None and 0 < int(window) < S
    span = min(int(window), S) if windowed else S
    want = max(1, _CTAS_PER_SM * sms // max(B * KV, 1)) \
        if span >= 2 * _MIN_CELL else 1
    if want == 1 and span <= 2 * _round_keys(hd, G):
        return "cta", 0
    cell = _CELL_KEYS * max(1, -(-_MIN_CELL // _CELL_KEYS))
    while cells_met(span, S, cell, windowed) > want and cell < _MAX_CELL \
            and cell < S:
        cell += _CELL_KEYS
    return "split", cell


def cells(S: int, window: Optional[int], T: int, cell: int) -> int:
    """Cells a pair of the split body walks: those that the union of T
    successive positions' ranges (K4: T 1; the verify window's T, one more
    key each) can meet, on a table of ``S`` positions."""
    windowed = window is not None and 0 < int(window) < S
    span = min(int(window), S) if windowed else S
    return cells_met(span + T - 1, S, cell, windowed)


def workspace_floats(B: int, KV: int, rows: int, hd: int, nsplit: int) -> int:
    """f32 elements of the partials of ``nsplit`` > 1 cells: each CTA's 16
    rows (``rows`` = T G rows a pair, in tiles of 16) of hd accumulators
    and a (max, sum) pair."""
    tiles = -(-rows // 16)
    return B * KV * nsplit * tiles * 16 * (hd + 2) if nsplit > 1 else 0


def split_for(B: int, KV: int, G: int, hd: int, S: int,
              window: Optional[int], T: int, sms: int) -> Split:
    """The launch of a call of T window positions (K4: T 1) on ``B`` rows
    of a table of ``S`` positions, by ``plan``: the one decision that K4,
    the verify window and their meta paths share. Not cached, so that a
    plan replaced for a measurement takes effect."""
    body, cell = plan(B, KV, G, hd, S, window, sms)
    if body == "cta":
        return Split("cta", 0, 0, 0)
    n = cells(S, window, T, cell)
    return Split("split" if n == 1 else "merge", n, cell,
                 workspace_floats(B, KV, T * G, hd, n))


def _lib():
    lib = build.load("paged_decode_attention")
    if not getattr(lib, "_typed", False):
        lib.paged_decode_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
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
    index = q.device.index or 0
    sp = split_for(B, KV, G, hd, MP * ps, window, 1, build.sm_count(index))
    work = None
    if sp.work:
        work = torch.empty(sp.work, dtype=torch.float32, device=q.device)
    stream = build.current_stream(index)
    err = _lib().paged_decode_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), B, KV, G, P, ps, MP, hd,
        sp.cell, sp.nsplit,
        k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        v_pages.stride(0), v_pages.stride(1), v_pages.stride(2),
        -1 if window is None else int(window), 1.0 / math.sqrt(hd), stream)
    build.LAUNCHES["paged_decode_attention"] += 1
    build.LAUNCHES[f"paged_decode_attention/{sp.body}"] += 1
    build.check(err, "paged_decode_attention")
    return out

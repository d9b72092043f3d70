"""GQA prefill flash attention: the CUDA kernel's wrapper (K2).

Every attention over a whole prompt runs here: the pooled forward (causal,
Sq = Sk), the full admission prefill (``kv_len`` masks the bucket's right
pads) and the chunked admission's tail prefill (``kv_len`` plus a prefix
operand: the mapped shared pages' K/V, attended in front of the tail's own
keys and masked past ``prefix_len``). ``csrc/flash_attention.cu`` reads
every operand in the model layout (B, S, heads, hd) through its strides and
walks the prefix as a second key segment, so nothing is transposed or
concatenated on the way in. Both of its products run on the tensor cores.
When the (query tile, kv head, row) CTAs are too few to fill the card
(whisper's cross-attention prefill at one row), the wrapper cuts the key
axis into splits (``splits``, from the shapes alone: no host sync) and the
kernel merges their partials in a second pass.

Training (the task API's fine-tuning through ``kernels.ops``) asks the
forward for each row's log-sum-exp as well (``with_lse``) and takes the
gradient with ``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``):
P recomputed from the log-sum-exp on the tensor cores, no atomics. Its plan
(``_bwd_plan``, shapes only) takes one fused launch where every key of a
(row, kv head) fits one CTA (Sk <= 64: moment-large's training) and
otherwise a dQ pass and a dK/dV pass, each walk split over a cluster of up
to 8 CTAs where the grid is short of the card's SMs.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

_HEAD_DIMS = (32, 64, 80, 128)
_ROWS = 64                  # (query, head) rows per CTA: 64 // G queries
_TILE = 32                  # keys per shared-memory tile of the kernel
_MIN_SPLIT = 128            # keys per split at least (four tiles)
_BWD_KEYS = 64              # backward: keys a CTA holds (the fused bound)
_BWD_QTILE = 32             # backward: queries a dK/dV tile
_BWD_SMS = 132              # the H100 SXM's SMs: the plan fills one wave
_BWD_MAX_SPLIT = 8          # the portable thread-block cluster size


def _lib():
    lib = build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
            + [ctypes.c_int64] * 15 + [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _bwd_lib():
    lib = build.load("flash_attention_bwd")
    if not getattr(lib, "_typed", False):
        lib.flash_attention_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
            + [ctypes.c_int64] * 15 + [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_float]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.flash_attention_bwd_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def splits(B: int, Sq: int, H: int, KV: int, keys: int,
           sms: int) -> tuple[int, int]:
    """(number of splits, keys per split) of the key axis [0, ``keys``)
    (prefix and new keys together) for a (B, Sq, H) query block over KV kv
    heads on ``sms`` SMs: ``build.key_splits`` over the kernel's (query
    tile, kv head, row) CTAs (``_ROWS // G`` queries a tile), in key
    tiles, at least ``_MIN_SPLIT`` keys a split."""
    ctas = -(-Sq // (_ROWS // (H // KV))) * KV * B
    return build.key_splits(ctas, keys, _TILE, _MIN_SPLIT, sms)


def _bwd_split(ctas: int, items: int, per_sm: int) -> int:
    """CTAs a backward walk of ``items`` is split over, for a pass of
    ``ctas`` CTAs of which ``per_sm`` fit an SM: as many as keep the pass in
    one wave of ``_BWD_SMS`` SMs, at most ``_BWD_MAX_SPLIT`` and two items
    a split."""
    return max(1, min(_BWD_MAX_SPLIT, per_sm * _BWD_SMS // max(ctas, 1),
                      items // 2))


def _bwd_plan(B: int, Sq: int, Sk: int, KV: int, G: int, hd: int,
              causal: bool, window: Optional[int]) -> tuple[bool, int, int]:
    """(fused, dq_splits, dkv_splits) of ``flash_attention_bwd`` for these
    shapes, from the shapes and constants alone (never the data or the
    card). Where every key of a (row, kv head) fits one CTA (Sq <= Sk <=
    ``_BWD_KEYS``) the backward is one fused launch; otherwise two passes,
    the dQ pass's key walk split over ``dq_splits`` CTAs (one cluster) and
    the dK/dV pass's (head, query tile) walk over ``dkv_splits``, each
    where its (tile, kv head, row) CTAs fall short of a wave (either pass
    holds three CTAs an SM to hd 64, else two).
    A window bounds the keys a query tile sees; causality is not counted
    (a tile's walk length varies along the diagonal)."""
    if Sq <= Sk <= _BWD_KEYS:
        return True, 1, 1
    seen = Sk if window is None else min(Sk, int(window) + _ROWS // G)
    dq_ctas = -(-Sq // (_ROWS // G)) * KV * B
    dkv_ctas = -(-Sk // _BWD_KEYS) * KV * B
    qseen = Sq if window is None else min(Sq, int(window) + _BWD_KEYS)
    return (False,
            _bwd_split(dq_ctas, -(-seen // _TILE), 3 if hd <= 64 else 2),
            _bwd_split(dkv_ctas, G * -(-qseen // _BWD_QTILE),
                       3 if hd <= 64 else 2))


def _rows_ok(t, name):
    """Unit hd stride and 16-byte aligned head rows (the kernel's 16-byte
    vector loads), any batch/position/head strides."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention kernel takes bf16 {name}, got "
                        f"{t.dtype}")
    if t.stride(3) != 1 or t.data_ptr() % 16 or \
            any(s % 8 for s in t.stride()[:3]):
        raise ValueError(f"{name}: head rows must have unit hd stride and be "
                         f"16-byte aligned, got strides {t.stride()}")


def _lengths(t, B, name):
    if t is None:
        return None
    if tuple(t.shape) != (B,) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a ({B},) CUDA tensor, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.to(torch.int32).contiguous()


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, kv_len=None, prefix_k=None,
                    prefix_v=None, prefix_len=None, with_lse: bool = False):
    """Launch the prefill flash-attention kernel.

    q: (B, Sq, H, hd) bf16 CUDA; k, v: (B, Sk, KV, hd) bf16, H = KV * G
    with 1 <= G <= 64 (a CTA holds 64 // G queries) and hd in (32, 64,
    80, 128); every operand read by
    strides (unit hd stride, 16-byte aligned rows). ``kv_len``/
    ``prefix_len``: (B,) integer CUDA tensors, read on the device.
    ``prefix_k``/``prefix_v``: (B, Sp, KV, hd) bf16, with ``prefix_len``
    and without a window. Returns (B, Sq, H, hd) bf16, contiguous. A query
    row with no valid key returns zeros. With more than one key split
    (``splits``), f32 partials go to scratch allocated here. ``with_lse``
    returns (out, lse) instead: lse (B, H, Sq) f32, each row's natural
    log-sum-exp of its scaled scores (-inf for a row with no valid key),
    for ``flash_attention_bwd``; the output's bits are the same."""
    if q.device.type != "cuda":
        raise ValueError("flash_attention kernel takes CUDA tensors")
    B, Sq, H, hd = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != hd or \
            tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k/v must be (B={B}, Sk, KV, hd={hd}) alike, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    Sk, KV = k.shape[1], k.shape[2]
    G = H // max(KV, 1)
    if KV == 0 or H % KV or not 1 <= G <= _ROWS or hd not in _HEAD_DIMS:
        raise ValueError(f"unsupported H={H}, KV={KV}, hd={hd} (hd in "
                         f"{_HEAD_DIMS}, 1 <= H/KV <= {_ROWS})")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _rows_ok(t, name)
    kv_len = _lengths(kv_len, B, "kv_len")
    if prefix_k is not None:
        if prefix_v is None or prefix_len is None:
            raise ValueError("prefix_k needs prefix_v and prefix_len")
        if window is not None:
            raise ValueError("a sliding window over a prefix is unsupported")
        if prefix_k.dim() != 4 or prefix_k.shape[0] != B or \
                tuple(prefix_k.shape[2:]) != (KV, hd) or \
                tuple(prefix_v.shape) != tuple(prefix_k.shape):
            raise ValueError(f"prefix_k/prefix_v must be (B={B}, Sp, KV={KV}, "
                             f"hd={hd}) alike, got {tuple(prefix_k.shape)} "
                             f"and {tuple(prefix_v.shape)}")
        _rows_ok(prefix_k, "prefix_k")
        _rows_ok(prefix_v, "prefix_v")
        prefix_len = _lengths(prefix_len, B, "prefix_len")
        Sp = prefix_k.shape[1]
        pk, pv = prefix_k, prefix_v
        pks, pvs = prefix_k.stride()[:3], prefix_v.stride()[:3]
    else:
        Sp, pk, pv, prefix_len = 0, None, None, None
        pks = pvs = (0, 0, 0)
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if B == 0 or Sq == 0:
        return (out, lse) if with_lse else out
    nsplit, split_len = splits(B, Sq, H, KV, Sp + Sk,
                               build.sm_count(q.device.index or 0))
    part_m = part_l = part_acc = None
    if nsplit > 1:
        n = B * Sq * H * nsplit
        part = torch.empty((n * (hd + 2),), dtype=torch.float32,
                           device=q.device)
        part_m, part_l, part_acc = part[:n], part[n:2 * n], part[2 * n:]
    stream = build.current_stream(q.device.index or 0)

    def ptr(t):
        return None if t is None else t.data_ptr()
    err = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(pk), ptr(pv),
        ptr(kv_len), ptr(prefix_len), out.data_ptr(), ptr(part_m),
        ptr(part_l), ptr(part_acc), ptr(lse), B, Sq, Sk, Sp, KV, G, hd,
        nsplit,
        split_len, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *pks,
        *pvs, int(causal), -1 if window is None else int(window),
        1.0 / math.sqrt(hd), stream)
    build.LAUNCHES["flash_attention"] += 1
    build.check(err, "flash_attention")
    return (out, lse) if with_lse else out


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: Optional[int] = None, kv_len=None):
    """Launch the gradient kernels of ``flash_attention`` (no prefix):
    q, k, v as the forward took them, ``out`` and ``lse`` what it returned
    with ``with_lse``, ``dout`` (B, Sq, H, hd) the output's gradient (made
    contiguous where its rows break the 16-byte rule). Returns (dq, dk, dv),
    bf16 contiguous in q's, k's and v's shapes, computed in f32; two calls
    give the same bits. A row with no valid key gets zero gradients. One
    launch (``_bwd_plan``'s fused path) or two; the split passes take a
    (B, H, Sq) f32 scratch for D, allocated here."""
    if q.device.type != "cuda":
        raise ValueError("flash_attention_bwd kernel takes CUDA tensors")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // max(KV, 1)
    if tuple(v.shape) != tuple(k.shape) or KV == 0 or H % KV or \
            not 1 <= G <= _ROWS or hd not in _HEAD_DIMS:
        raise ValueError(f"unsupported q {tuple(q.shape)}, k/v "
                         f"{tuple(k.shape)}/{tuple(v.shape)}")
    if tuple(out.shape) != tuple(q.shape) or \
            tuple(dout.shape) != tuple(q.shape) or \
            tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32 or \
            not lse.is_contiguous():
        raise ValueError("out/dout must be q's shape and lse (B, H, Sq) f32 "
                         "contiguous")
    if dout.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_bwd takes a bf16 dout, got "
                        f"{dout.dtype}")
    if dout.stride(3) != 1 or dout.data_ptr() % 16 or \
            any(s % 8 for s in dout.stride()[:3]):
        dout = dout.contiguous()
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (out, "out")):
        _rows_ok(t, name)
    kv_len = _lengths(kv_len, B, "kv_len")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if B == 0 or Sq == 0 or Sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    fused, dq_splits, dkv_splits = _bwd_plan(B, Sq, Sk, KV, G, hd, causal,
                                             window)
    dsum = None if fused else torch.empty((B, H, Sq), dtype=torch.float32,
                                          device=q.device)
    err = _bwd_lib().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(),
        None if kv_len is None else kv_len.data_ptr(),
        None if dsum is None else dsum.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, KV, G, hd,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], *dout.stride()[:3], int(causal),
        -1 if window is None else int(window), 1.0 / math.sqrt(hd),
        int(fused), dq_splits, dkv_splits,
        build.current_stream(q.device.index or 0))
    build.LAUNCHES["flash_attention_bwd"] += 1
    build.check(err, "flash_attention_bwd")
    return dq, dk, dv

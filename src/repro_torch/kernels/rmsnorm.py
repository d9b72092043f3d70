"""RMS norm: the CUDA kernel's wrapper (``csrc/rmsnorm.cu``).

The JAX package's ``models/layers.py::rmsnorm`` is plain jnp (XLA fuses
it; no Pallas kernel). The port has a kernel for it because PyTorch's f32
mean on the card reduces in an order that follows the number of rows:
the same row normalised in a 40-row verify forward and in an 8-row decode
step could differ in its last bit. The kernel gives each row one warp and
a fixed reduction order that depends on d alone, so a row's output bits
depend on the row, ``w`` and ``eps`` only. One launch per call.

``rmsnorm_bwd`` is its gradient for training (through ``kernels.ops``):
one launch that reads x and dy once, dx one warp a row in the forward's
order (row-invariant the same way) and, when the weight needs it, dw's
partial rows summed in a fixed order by a second, small launch (no
atomics). Its plan (``_bwd_plan``) is a function of the shapes alone.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_BWD_WARPS = 8              # backward: rows (warps) a CTA holds at once
_BWD_SMS = 132              # the H100 SXM's SMs
_BWD_CTAS_PER_SM = 2        # backward: CTAs a wave gives each SM
_BWD_SMEM = 160 << 10       # backward: most shared memory a CTA takes


def _lib():
    lib = build.load("rmsnorm")
    if not getattr(lib, "_typed", False):
        lib.rmsnorm_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
            + [ctypes.c_int64, ctypes.c_float, ctypes.c_void_p])
        lib.rmsnorm_launch.restype = ctypes.c_int
        lib.rmsnorm_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
            + [ctypes.c_int64] * 2 + [ctypes.c_float] + [ctypes.c_int] * 2
            + [ctypes.c_void_p])
        lib.rmsnorm_bwd_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def _row_view(t, d):
    """``t`` as (rows, d) (a view where its dims allow one), or None where
    its rows break the kernels' rule: unit element stride, 16-byte aligned
    rows."""
    t2 = t.reshape(-1, d)
    if t2.stride(1) != 1 or t2.data_ptr() % 16 or t2.stride(0) % 8:
        return None
    return t2


def _bwd_plan(rows: int, d: int) -> tuple[int, int, int]:
    """(warps a CTA, rows a warp, CTAs) of ``rmsnorm_bwd`` for ``rows`` x
    ``d``, from the shapes and constants alone (never the data or the
    card): ``_BWD_WARPS`` warps, halved while w and a dw slice a warp
    would pass ``_BWD_SMEM`` of shared memory; enough rows a warp that the
    CTAs fit one wave of ``_BWD_CTAS_PER_SM`` a CTA an SM (on the card
    fewer warps a CTA, or more CTAs, were slower: PERF.md). CTA b's warp v
    takes rows b * warps * T + t * warps + v, t < T. dw's summation order
    follows the plan, so its bits depend on (rows, d) and the data
    only."""
    warps = _BWD_WARPS
    while warps > 1 and 4 * d * (1 + warps) > _BWD_SMEM:
        warps //= 2
    per_warp = max(1, -(-rows // (warps * _BWD_SMS * _BWD_CTAS_PER_SM)))
    return warps, per_warp, -(-rows // (warps * per_warp))


def rmsnorm(w, x, eps: float = 1e-5):
    """Launch the kernel: x (..., d) bf16 CUDA, w (d,) f32 (the models'
    dtypes) -> (..., d) bf16. The leading dims are flattened to rows (a
    view where they allow one); every row must be 16-byte aligned."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError("rmsnorm kernel takes CUDA tensors on one device")
    if x.dtype != torch.bfloat16 or w.dtype != torch.float32:
        raise TypeError(f"rmsnorm kernel takes bf16 x and f32 w, got "
                        f"{x.dtype}, {w.dtype}")
    d = x.shape[-1]
    if w.shape != (d,) or not w.is_contiguous() or d % 8:
        raise ValueError(f"rmsnorm: w must be contiguous ({d},) and d a "
                         f"multiple of 8; got w {tuple(w.shape)}")
    x2 = _row_view(x, d)
    if x2 is None:
        raise ValueError("rmsnorm: rows must have a unit element stride and "
                         "be 16-byte aligned")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    stream = build.current_stream(x.device.index or 0)
    err = _lib().rmsnorm_launch(x2.data_ptr(), w.data_ptr(), out.data_ptr(),
                                x2.shape[0], d, x2.stride(0), float(eps),
                                stream)
    build.LAUNCHES["rmsnorm"] += 1
    build.check(err, "rmsnorm")
    return out


def rmsnorm_bwd(w, x, dy, eps: float = 1e-5, need_dw: bool = True):
    """Launch the gradient kernel of ``rmsnorm`` for x (..., d) bf16 CUDA,
    w (d,) f32 and the output's gradient ``dy`` (x's shape and dtype; made
    contiguous where its rows break the 16-byte rule). Returns (dx, dw): dx
    in x's shape and dtype, computed in f32; dw (d,) f32, or None without
    ``need_dw`` (then one launch). Two calls give the same bits."""
    if x.device.type != "cuda" or w.device != x.device or \
            dy.device != x.device:
        raise ValueError("rmsnorm_bwd kernel takes CUDA tensors on one "
                         "device")
    if x.dtype != torch.bfloat16 or dy.dtype != torch.bfloat16 or \
            w.dtype != torch.float32:
        raise TypeError(f"rmsnorm_bwd kernel takes bf16 x and dy and f32 w, "
                        f"got {x.dtype}, {dy.dtype}, {w.dtype}")
    d = x.shape[-1]
    if w.shape != (d,) or not w.is_contiguous() or w.data_ptr() % 16 or \
            d % 8 or dy.shape != x.shape:
        raise ValueError(f"rmsnorm_bwd: w must be contiguous ({d},) and "
                         f"16-byte aligned, d a multiple of 8 and dy x's "
                         f"shape; got w {tuple(w.shape)}, dy "
                         f"{tuple(dy.shape)}")
    x2 = _row_view(x, d)
    if x2 is None:
        raise ValueError("rmsnorm_bwd: x's rows must have a unit element "
                         "stride and be 16-byte aligned")
    dy2 = _row_view(dy, d)
    if dy2 is None:
        dy2 = dy.contiguous().view(-1, d)
    rows = x2.shape[0]
    warps, per_warp, ctas = _bwd_plan(rows, d)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dw = part = None
    if need_dw:
        dw = torch.empty((d,), dtype=torch.float32, device=x.device)
        part = torch.empty((ctas, d), dtype=torch.float32, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()
    err = _lib().rmsnorm_bwd_launch(
        x2.data_ptr(), dy2.data_ptr(), w.data_ptr(), dx.data_ptr(), ptr(dw),
        ptr(part), rows, d, x2.stride(0), dy2.stride(0), float(eps), warps,
        per_warp, build.current_stream(x.device.index or 0))
    build.LAUNCHES["rmsnorm_bwd"] += 1
    build.check(err, "rmsnorm_bwd")
    return dx, dw

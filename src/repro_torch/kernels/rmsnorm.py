"""RMS norm: the CUDA kernel's wrapper (``csrc/rmsnorm.cu``).

The JAX package's ``models/layers.py::rmsnorm`` is plain jnp (XLA fuses
it; no Pallas kernel). The port has a kernel for it because PyTorch's f32
mean on the card reduces in an order that follows the number of rows:
the same row normalised in a 40-row verify forward and in an 8-row decode
step could differ in its last bit. The kernel gives each row one warp and
a fixed reduction order that depends on d alone, so a row's output bits
depend on the row, ``w`` and ``eps`` only. One launch per call.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def _lib():
    lib = build.load("rmsnorm")
    if not getattr(lib, "_typed", False):
        lib.rmsnorm_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
            + [ctypes.c_int64, ctypes.c_float, ctypes.c_void_p])
        lib.rmsnorm_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


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
    x2 = x.reshape(-1, d)
    if x2.stride(1) != 1 or x2.data_ptr() % 16 or x2.stride(0) % 8:
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

"""Kernel entry points of the port, in the model layout.

Each op launches its hand-written CUDA kernel for CUDA tensors and uses the
plain PyTorch version in ``kernels.ref`` only for tensors that lie on the
CPU (the tests); any other device raises. There is no fallback: a CUDA
tensor reaches the kernel or an error. ``LAUNCHES`` counts kernel launches
per kernel name.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import decode_attention as _float
from repro_torch.kernels import decode_attention_int8 as _int8
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_decode_attention as _paged
from repro_torch.kernels import segmented_lora as _sgmv

LAUNCHES = build.LAUNCHES
reset_launches = build.reset_launches


def _route(x) -> str:
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")
    return kind


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_chunk: int = 1024,
                    kv_chunk: int = 1024, kv_len=None, prefix_k=None,
                    prefix_v=None, prefix_len=None):
    """Prefill GQA attention in the model layout (kernel K2): q (B, Sq, H,
    hd), k/v (B, Sk, KV, hd), optional ``kv_len`` (B,) and prefix operand
    (B, Sp, KV, hd) with ``prefix_len`` (B,) — the semantics of
    ``ref.flash_attention_ref``. ``q_chunk``/``kv_chunk`` tile the plain
    version only; the kernel has its own tiles."""
    if _route(q) == "cuda":
        return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                      kv_len=kv_len, prefix_k=prefix_k,
                                      prefix_v=prefix_v,
                                      prefix_len=prefix_len)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   q_chunk=q_chunk, kv_chunk=kv_chunk,
                                   kv_len=kv_len, prefix_k=prefix_k,
                                   prefix_v=prefix_v, prefix_len=prefix_len)


def gather_prefix_kv(k_pages, v_pages, k_scale, v_scale, page_table):
    """Dequantized prefix K/V gather, model layout (chunked prefill).

    k_pages/v_pages: (num_pages, ps, KV, hd) int8 arena; k_scale/v_scale:
    (num_pages, KV) per-page scales; page_table: (B, P) prefix pages
    (positions past a row's true prefix length may point at the trash page:
    the attention mask hides them). Returns float32 (k, v), each
    (B, P * ps, KV, hd), ready for ``flash_attention(prefix_k=...,
    prefix_v=...)``. Plain tensor code on every device, as in the JAX
    package: the gathered block is a handful of pages per admission, and
    the arena is read through the page vector, never transposed."""
    B, P = page_table.shape
    _, ps, KV, hd = k_pages.shape
    pt = page_table.to(device=k_pages.device, dtype=torch.long)

    def gather(pages, scale):
        g = pages[pt].float()                          # (B, P, ps, KV, hd)
        g = g * scale[pt][:, :, None, :, None]
        return g.reshape(B, P * ps, KV, hd)

    return gather(k_pages, k_scale), gather(v_pages, v_scale)


def quantize_kv(k, v):
    """Symmetric per-(batch, kv-head) int8 KV quantization, model layout.

    k, v: (B, S, KV, hd) float -> (k_q, v_q (B, S, KV, hd) int8,
    k_scale, v_scale (B, KV) f32). Plain tensor code on every device: it runs
    once per admission, outside the decode loop."""
    kq, vq, ks, vs = _int8.quantize_kv(k.transpose(1, 2), v.transpose(1, 2))
    return kq.transpose(1, 2), vq.transpose(1, 2), ks, vs


def decode_attention(q, k_cache, v_cache, lengths, *,
                     window: Optional[int] = None):
    """Float-cache GQA decode attention, model layout (kernel K5).

    q: (B, H, hd); k_cache/v_cache: (B, S, KV, hd) in the cache dtype (any
    S; views into a pool are read in place); lengths: (B,) valid lengths
    -> (B, H, hd) in q's dtype. Positions [max(0, len - window), len) are
    attended; the probabilities round to the cache dtype before P·V, as in
    the JAX package's jnp ``models.attention.decode_attention``."""
    if _route(q) == "cuda":
        return _float.decode_attention(q, k_cache, v_cache, lengths,
                                       window=window)
    return ref.decode_attention_ref(q, k_cache.transpose(1, 2),
                                    v_cache.transpose(1, 2), lengths,
                                    window=window, p_dtype=v_cache.dtype)


def decode_attention_int8(q, k_q, v_q, k_scale, v_scale, lengths, *,
                          window: Optional[int] = None):
    """int8-KV decode attention, model layout.

    q: (B, H, hd); k_q/v_q: (B, S, KV, hd) int8; k_scale/v_scale: (B, KV);
    lengths: (B,) -> (B, H, hd). The kernel reads the cache through a
    head-major view of the model layout, never a copy."""
    kh = k_q.transpose(1, 2)
    vh = v_q.transpose(1, 2)
    if _route(q) == "cuda":
        return _int8.decode_attention_int8(q, kh, vh, k_scale, v_scale,
                                           lengths, window=window)
    return ref.decode_attention_int8_ref(q, kh, vh, k_scale, v_scale, lengths,
                                         window=window)


def paged_decode_attention(q, k_pages, v_pages, k_scale, v_scale, page_table,
                           lengths, *, window: Optional[int] = None):
    """Paged int8-KV decode attention, model layout.

    q: (B, H, hd); k_pages/v_pages: (P, ps, KV, hd) int8 arena; k_scale/
    v_scale: (P, KV) per-page scales; page_table: (B, MP) int32 (rows of
    different streams may map the same page: copy-on-write prefix sharing;
    the read needs no change); lengths: (B,) -> (B, H, hd). The kernel reads
    the arena through its model-layout strides; the plain version gathers
    through a head-major view. Neither copies the arena."""
    if _route(q) == "cuda":
        return _paged.paged_decode_attention(q, k_pages, v_pages, k_scale,
                                             v_scale, page_table, lengths,
                                             window=window)
    return ref.paged_decode_attention_ref(q, k_pages.transpose(1, 2),
                                          v_pages.transpose(1, 2), k_scale,
                                          v_scale, page_table, lengths,
                                          window=window)


def segmented_lora(x, block_adapter, a_w, b_w, *, block_t: int = 128):
    """x: (T, d) adapter-sorted; b_w: (NA, r, out) -> LoRA delta (T, out)."""
    if _route(x) == "cuda":
        return _sgmv.segmented_lora(x, block_adapter, a_w, b_w,
                                    block_t=block_t)
    return ref.segmented_lora_ref(x, block_adapter, a_w, b_w, block_t)

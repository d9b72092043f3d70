"""Plain PyTorch versions of the kernels (the port's ``kernels/ref.py``).

Each mirrors its JAX oracle in ``kernels/ref.py`` of the JAX package, in the
same (kernel, head-major) layouts. ``kernels.ops`` uses them for tensors that
lie on the CPU; ``chip_smoke.py`` holds the CUDA kernels against them on the
card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k, v, lengths, *, window: Optional[int] = None):
    """q: (B, H, hd); k, v: (B, KV, S, hd); lengths: (B,). -> (B, H, hd)."""
    B, H, hd = q.shape
    _, KV, S, _ = k.shape
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgd,bksd->bkgs", qf, k.float()) * scale
    pos = torch.arange(S, device=q.device)[None]
    lengths = lengths.to(q.device)
    mask = pos < lengths[:, None]
    if window is not None:
        mask &= pos >= (lengths[:, None] - window)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    return o.reshape(B, H, hd).to(q.dtype)


def decode_attention_int8_ref(q, k_q, v_q, k_scale, v_scale, lengths, *,
                              window: Optional[int] = None):
    """int8-KV decode: dequantize, then the f32 decode reference.

    q: (B, H, hd); k_q/v_q: (B, KV, S, hd) int8; k_scale/v_scale: (B, KV);
    lengths: (B,). -> (B, H, hd)."""
    k = k_q.float() * k_scale[:, :, None, None]
    v = v_q.float() * v_scale[:, :, None, None]
    return decode_attention_ref(q, k, v, lengths, window=window)


def paged_decode_attention_ref(q, k_pages, v_pages, k_scale, v_scale,
                               page_table, lengths, *,
                               window: Optional[int] = None):
    """Paged int8-KV decode: gather pages through the table, dequantize each
    with its own scale, then the f32 decode reference.

    q: (B, H, hd); k_pages/v_pages: (num_pages, KV, ps, hd) int8 (any
    strides: the model layout's transposed view is taken as is); k_scale/
    v_scale: (num_pages, KV); page_table: (B, MP) int; lengths: (B,).
    -> (B, H, hd). Only the gathered pages are materialized."""
    B = q.shape[0]
    _, KV, ps, hd = k_pages.shape
    MP = page_table.shape[1]
    pt = page_table.to(device=q.device, dtype=torch.long)

    def gather(pages, scale):
        g = pages[pt].float()                          # (B, MP, KV, ps, hd)
        g = g * scale[pt][..., None, None]             # per-page dequant
        return g.transpose(1, 2).reshape(B, KV, MP * ps, hd)

    return decode_attention_ref(q, gather(k_pages, k_scale),
                                gather(v_pages, v_scale), lengths,
                                window=window)


def segmented_lora_ref(x, block_adapter, a_w, b_w, block_size: int):
    """Multi-adapter LoRA delta on an adapter-sorted batch.

    x: (T, d), each ``block_size`` block of rows belongs to ONE adapter;
    block_adapter: (T // block_size,) adapter id per block (an id >= NA
    means "no adapter" -> zero delta); a_w: (NA, d, r); b_w: (NA, r, out).
    Returns the delta (T, out) in x's dtype, accumulated in f32."""
    T, d = x.shape
    na = a_w.shape[0]
    out_dim = b_w.shape[-1]
    nb = T // block_size
    xb = x.reshape(nb, block_size, d).float()
    aid = block_adapter.to(device=x.device, dtype=torch.long)
    valid = aid < na
    aid_c = torch.clamp(aid, max=na - 1)
    h = torch.bmm(xb, a_w[aid_c].float())
    y = torch.bmm(h, b_w[aid_c].float())
    y = torch.where(valid[:, None, None], y, torch.zeros_like(y))
    return y.reshape(T, out_dim).to(x.dtype)

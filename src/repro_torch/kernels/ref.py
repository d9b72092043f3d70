"""Plain PyTorch versions of the kernels (the port's ``kernels/ref.py``).

Each mirrors its JAX oracle in ``kernels/ref.py`` of the JAX package, in the
same (kernel, head-major) layouts, except ``flash_attention_ref``: it is the
JAX package's jnp ``models.attention.flash_attention`` (``kv_len`` and the
prefix operand), in the model layout; and ``decode_attention_ref`` with
``p_dtype`` is the jnp ``models.attention.decode_attention``; and
``rmsnorm``, the jnp ``models/layers.py::rmsnorm`` (no Pallas kernel: the
port's kernel exists for its row invariance on the card). ``kernels.ops``
uses them for tensors that lie on the CPU; ``chip_smoke.py`` holds the CUDA
kernels against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _chunk(n: int, target: int) -> int:
    c = min(n, target)
    while n % c:
        c -= 1
    return c


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None, q_chunk: int = 1024,
                        kv_chunk: int = 1024, kv_len=None, prefix_k=None,
                        prefix_v=None, prefix_len=None):
    """Online-softmax GQA prefill attention in the MODEL layout: the JAX
    package's jnp ``models.attention.flash_attention``, a superset of the
    Pallas kernel's function (which takes neither ``kv_len`` nor a prefix).

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd), H % KV == 0. Returns
    (B, Sq, H, hd) in q's dtype. Q/K positions align at the end (q is the
    suffix of the keys). ``kv_len`` (B,): key positions at or past a row's
    length are masked. ``prefix_k``/``prefix_v`` (B, Sp, KV, hd) with
    ``prefix_len`` (B,): keys at positions [0, Sp) ahead of ``k``, masked at
    or past ``prefix_len``; no window with a prefix. Scores and the
    accumulator are f32; the probabilities round to the value dtype before
    the P·V product, as in JAX. A row whose keys are all masked yields the
    mean of the masked values, as JAX does (exp(NEG_INF - NEG_INF) = 1)."""
    B, Sq, H, hd = q.shape
    Sk_new = k.shape[1]
    dev = q.device
    if prefix_k is not None:
        if prefix_v is None or prefix_len is None:
            raise ValueError("prefix_k needs prefix_v and prefix_len")
        if window is not None:
            raise ValueError("a sliding window over a prefix is unsupported")
        Sp = prefix_k.shape[1]
        k = torch.cat([prefix_k.to(k.dtype), k], dim=1)
        v = torch.cat([prefix_v.to(v.dtype), v], dim=1)
        tail_ok = torch.arange(Sk_new, device=dev)[None] < \
            kv_len.to(dev)[:, None] if kv_len is not None else \
            torch.ones((B, Sk_new), dtype=torch.bool, device=dev)
        key_valid = torch.cat([torch.arange(Sp, device=dev)[None]
                               < prefix_len.to(dev)[:, None], tail_ok], dim=1)
    elif kv_len is not None:
        key_valid = torch.arange(Sk_new, device=dev)[None] < \
            kv_len.to(dev)[:, None]
    else:
        key_valid = None
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qc, kc = _chunk(Sq, q_chunk), _chunk(Sk, kv_chunk)
    scale = 1.0 / math.sqrt(hd)
    q_off = Sk - Sq
    qr = q.reshape(B, Sq // qc, qc, KV, G, hd)
    kr = k.reshape(B, Sk // kc, kc, KV, hd)
    vr = v.reshape(B, Sk // kc, kc, KV, hd)
    chunks = []
    for qi in range(Sq // qc):
        qblk = qr[:, qi].float()                          # (B, qc, KV, G, hd)
        q_pos = q_off + qi * qc + torch.arange(qc, device=dev)
        m = torch.full((B, KV, G, qc), NEG_INF, device=dev)
        l = torch.zeros((B, KV, G, qc), device=dev)
        acc = torch.zeros((B, KV, G, qc, hd), device=dev)
        for ki in range(Sk // kc):
            vblk = vr[:, ki]
            k_pos = ki * kc + torch.arange(kc, device=dev)
            s = torch.einsum("bqkgd,bskd->bkgqs", qblk,
                             kr[:, ki].float()) * scale
            mask = torch.ones((qc, kc), dtype=torch.bool, device=dev)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                mask &= (q_pos[:, None] - k_pos[None, :]) < window
            mask = mask[None, None, None]                 # (1, 1, 1, qc, kc)
            if key_valid is not None:
                vmask = key_valid[:, ki * kc:(ki + 1) * kc]
                mask = mask & vmask[:, None, None, None]
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            # p rounds to the value dtype before the product, as in JAX
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(vblk.dtype).float(), vblk.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B, KV, G, qc, hd)
        chunks.append(out.permute(0, 3, 1, 2, 4))         # (B, qc, KV, G, hd)
    return torch.cat(chunks, dim=1).reshape(B, Sq, H, hd).to(q.dtype)


def decode_attention_ref(q, k, v, lengths, *, window: Optional[int] = None,
                         p_dtype=None, key_offset: int = 0,
                         return_lse: bool = False):
    """q: (B, H, hd); k, v: (B, KV, S, hd); lengths: (B,). -> (B, H, hd).

    Scores, softmax and the P·V accumulation in f32. ``p_dtype``: round the
    probabilities to that dtype before the P·V product — with the cache's
    dtype this is the JAX package's jnp ``models.attention.
    decode_attention``, the function the float flash-decode kernel (K5)
    computes; without it, the f32 oracle the int8 references reuse. A row
    with no valid position yields the mean of the masked values, as JAX
    does.

    ``key_offset``: k/v are a piece of a longer cache whose key 0 sits at
    global position ``key_offset``; the window and lengths are global.
    ``return_lse``: return (o (B, H, hd) f32, lse (B, H) f32), lse the
    natural log-sum-exp of the scaled scores of the valid keys; a row with
    none gives o = 0 and lse = -inf (K5's outputs with ``return_lse``,
    which ``models.attention.merge_partials`` combines)."""
    B, H, hd = q.shape
    _, KV, S, _ = k.shape
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qf = q.reshape(B, KV, G, hd).float()
    s = torch.einsum("bkgd,bksd->bkgs", qf, k.float()) * scale
    pos = key_offset + torch.arange(S, device=q.device)[None]
    lengths = lengths.to(q.device)
    mask = pos < lengths[:, None]
    if window is not None:
        mask &= pos >= (lengths[:, None] - window)
    mask = mask[:, None, None]
    if return_lse:
        lse = torch.logsumexp(torch.where(mask, s, -math.inf), dim=-1)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    if p_dtype is not None:
        p = p.to(p_dtype).float()
    if return_lse:
        p = p * mask.any(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    if return_lse:
        return o.reshape(B, H, hd), lse.reshape(B, H)
    return o.reshape(B, H, hd).to(q.dtype)


def decode_attention_int8_ref(q, k_q, v_q, k_scale, v_scale, lengths, *,
                              window: Optional[int] = None,
                              key_offset: int = 0, return_lse: bool = False):
    """int8-KV decode: dequantize, then the f32 decode reference.

    q: (B, H, hd); k_q/v_q: (B, KV, S, hd) int8; k_scale/v_scale: (B, KV);
    lengths: (B,). -> (B, H, hd). ``key_offset`` and ``return_lse`` as in
    ``decode_attention_ref`` (a piece of a cache split over its sequence:
    (o f32, lse) for ``models.attention.merge_partials``)."""
    k = k_q.float() * k_scale[:, :, None, None]
    v = v_q.float() * v_scale[:, :, None, None]
    return decode_attention_ref(q, k, v, lengths, window=window,
                                key_offset=key_offset, return_lse=return_lse)


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


def paged_verify_attention_ref(q, k_pages, v_pages, k_scale, v_scale,
                               page_table, base_len, *,
                               window: Optional[int] = None):
    """The speculative verify window: T single-token paged reads at the
    successive lengths ``base_len + j + 1``.

    q: (B, T, H, hd); k_pages/v_pages: (num_pages, KV, ps, hd) int8 (any
    strides); k_scale/v_scale: (num_pages, KV); page_table: (B, MP);
    base_len: (B,). -> (B, T, H, hd)."""
    T = q.shape[1]
    base_len = base_len.to(q.device)
    return torch.stack([paged_decode_attention_ref(
        q[:, j], k_pages, v_pages, k_scale, v_scale, page_table,
        base_len + (j + 1), window=window) for j in range(T)], dim=1)


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


def rmsnorm(w, x, eps: float = 1e-5):
    """The JAX package's ``models/layers.py::rmsnorm``: normalize in f32,
    scale by ``w`` in f32, return in ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)

"""GQA attention: prefill (pooled forward, full and chunked admission,
encoder self-attention, decoder cross-attention) and decode.

``flash_attention`` keeps the JAX package's jnp function's signature and
layout (``kv_len``, the prefix operand of a chunked admission) and goes
through the hand-written prefill kernel K2 (``kernels.ops.flash_attention``);
its plain version is ``kernels.ref.flash_attention_ref``. Decode against a
float cache (``decode_attention``: the cross-attention decode and the float
dense pool) goes through K5, against the dense int8 pool through K3 and
against the paged int8 arena through K4 (``kernels.ops``); the speculative
verify window (``self_attention_verify``) through K4's verify-window kernel,
which walks each stream's pages once for all window positions.

The cache is updated IN PLACE: a serving pool is allocated once and every
prefill/decode writes into its slices, where the JAX package returns a new
(donated) cache. Functions return the same cache dict they were given.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.common import ParamSpec
from repro_torch.models.layers import apply_rope


# ---------------- specs ----------------

def attn_spec(cfg, cross: bool = False) -> dict:
    """Projection weights; the qkv bias (qwen2-style configs) is never on
    a cross-attention sublayer."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    spec = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias and not cross:
        spec["bq"] = ParamSpec((h, hd), ("heads", "head_dim"), init="zeros")
        spec["bk"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), init="zeros")
        spec["bv"] = ParamSpec((kv, hd), ("kv_heads", "head_dim"), init="zeros")
    return spec


# ---------------- prefill attention (kernel K2) ----------------

def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_chunk: int = 1024,
                    kv_chunk: int = 1024, kv_len=None, prefix_k=None,
                    prefix_v=None, prefix_len=None):
    """Online-softmax GQA attention, the JAX function's signature and layout.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd), H % KV == 0. Returns
    (B, Sq, H, hd). Q/K positions align at the end (q is the suffix when
    Sq < Sk). ``kv_len`` (B,): key positions at or past a row's length are
    masked (right-padded variable-length prefill). ``prefix_k``/``prefix_v``
    (B, Sp, KV, hd) with ``prefix_len`` (B,): precomputed prefix K/V (the
    mapped shared pages of a chunked admission) that the queries attend to
    in front of their own keys, masked at or past ``prefix_len``; the
    prefix is cast to the keys' dtype first, as in JAX (the pages mode
    gathers f32). Runs the prefill kernel (``kernels.ops.flash_attention``)
    on the card; ``q_chunk``/``kv_chunk`` tile the plain version only."""
    from repro_torch.kernels import ops
    if prefix_k is not None:
        prefix_k, prefix_v = prefix_k.to(k.dtype), prefix_v.to(v.dtype)
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               q_chunk=q_chunk, kv_chunk=kv_chunk,
                               kv_len=kv_len, prefix_k=prefix_k,
                               prefix_v=prefix_v, prefix_len=prefix_len)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     window: Optional[int] = None):
    """Single-token attention against a float KV cache, the JAX function's
    signature and layout, through the float flash-decode kernel K5
    (``kernels.ops.decode_attention``; plain version ``kernels.ref.
    decode_attention_ref`` with ``p_dtype``).

    q: (B, H, hd); caches: (B, S, KV, hd); cache_len: (B,) valid lengths."""
    from repro_torch.kernels import ops
    return ops.decode_attention(q, k_cache, v_cache, cache_len, window=window)


# ---------------- full layer ops ----------------

def _proj(x, w):
    """x: (B, S, d) @ w: (d, heads, hd) -> (B, S, heads, hd) in x's dtype."""
    d, nh, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, nh * hd)).reshape(
        x.shape[0], x.shape[1], nh, hd)


def qkv_project(p, x, cfg, pos=None, rope: bool = True, lora=None,
                adapter_idx=None, lora_impl: str = "gather", lora_seg=None):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if lora is not None and adapter_idx is not None:
        from repro_torch.models.lora import qv_lora
        q, v = qv_lora(x, lora, adapter_idx, q, v, impl=lora_impl, seg=lora_seg)
    if rope and pos is not None:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    return q, k, v


def out_project(p, attn_out, dtype):
    H, hd, d = p["wo"].shape
    B, S = attn_out.shape[:2]
    return attn_out.reshape(B, S, H * hd).to(dtype) @ \
        p["wo"].to(dtype).reshape(H * hd, d)


def self_attention(p, x, cfg, *, causal=True, pos=None, lora=None,
                   adapter_idx=None, lora_impl="gather", lora_seg=None,
                   seq_lens=None, prefix=None, prefix_len=None):
    """Full-sequence self attention (prefill / pooled forward).
    Returns (out, (k, v)); ``seq_lens`` (B,) masks right-padding keys.

    ``prefix``: optional dict(k, v) of precomputed (B, Sp, KV, hd) prefix
    K/V (a chunked admission's mapped shared pages) that the queries attend
    to in ADDITION to this dispatch's own K/V; ``prefix_len`` (B,) true
    prefix lengths. The returned (k, v) stay tail-only: the cache stores
    only what this dispatch computed."""
    q, k, v = qkv_project(p, x, cfg, pos=pos, lora=lora,
                          adapter_idx=adapter_idx, lora_impl=lora_impl,
                          lora_seg=lora_seg)
    pk, pv = (None, None) if prefix is None else (prefix["k"], prefix["v"])
    o = flash_attention(q, k, v, causal=causal, window=cfg.sliding_window,
                        kv_len=seq_lens, prefix_k=pk, prefix_v=pv,
                        prefix_len=prefix_len)
    return out_project(p, o, x.dtype), (k, v)


def cross_attention(p, x, enc_kv, cfg):
    """Decoder cross-attention over precomputed encoder K/V (B, S_enc, KV,
    hd): every query sees every frame (K2, not causal; no RoPE, no LoRA)."""
    q = _proj(x, p["wq"])
    k, v = enc_kv
    o = flash_attention(q, k.to(x.dtype), v.to(x.dtype), causal=False)
    return out_project(p, o, x.dtype)


def quantize_token(x, scale):
    """One token's K or V (B, KV, hd) into int8 codes at the slot's fixed
    per-(B, KV) scale (already epsilon-guarded)."""
    return torch.clamp(torch.round(x.float() / scale[:, :, None]),
                       -127, 127).to(torch.int8)


def self_attention_decode(p, x, cache, cfg, *, pos=None, lora=None,
                          adapter_idx=None, lora_impl="gather", lora_seg=None):
    """One-step decode. x: (B, 1, d); cache: dict(k, v, len[, k_scale,
    v_scale]) of views into the pool, updated in place. Returns (out, cache).

    With ``k_scale``/``v_scale`` the cache is the dense int8 pool: the new
    token's K/V quantize into the scales fixed at admission and attention
    runs through the int8 flash-decode kernel, so the cache is only ever
    streamed as int8. With ``page_table`` it is the paged int8 arena
    (``_paged_decode``). Otherwise it is a float pool, attended through the
    float flash-decode kernel (``decode_attention``)."""
    q, k, v = qkv_project(p, x, cfg, pos=pos, lora=lora,
                          adapter_idx=adapter_idx, lora_impl=lora_impl,
                          lora_seg=lora_seg)
    if "page_table" in cache:
        return _paged_decode(p, x, q, k, v, cache, cfg)
    B, S = x.shape[0], cache["k"].shape[1]
    # insert position. A free pool slot keeps stepping and its length grows
    # past S; JAX drops such an out-of-range write, torch would raise, so the
    # write is clamped into the free row's own last position (garbage that
    # the next admission overwrites). Live rows always have len < S.
    idx = torch.clamp(cache["len"], max=S - 1).long()
    bidx = torch.arange(B, device=x.device)
    new_len = (cache["len"] + 1).to(cache["len"].dtype)
    if "k_scale" in cache:
        from repro_torch.kernels import ops
        # scales are per (B, KV), fixed at prefill; epsilon-guard free slots
        # whose scales were never written (their rows are masked anyway)
        ks = torch.clamp(cache["k_scale"], min=1e-8)
        vs = torch.clamp(cache["v_scale"], min=1e-8)
        cache["k"][bidx, idx] = quantize_token(k[:, 0], ks)
        cache["v"][bidx, idx] = quantize_token(v[:, 0], vs)
        o = ops.decode_attention_int8(q[:, 0].contiguous(), cache["k"],
                                      cache["v"], ks, vs, new_len,
                                      window=cfg.sliding_window).to(x.dtype)
    else:
        cache["k"][bidx, idx] = k[:, 0].to(cache["k"].dtype)
        cache["v"][bidx, idx] = v[:, 0].to(cache["v"].dtype)
        o = decode_attention(q[:, 0].contiguous(), cache["k"], cache["v"],
                             new_len, window=cfg.sliding_window)
    cache["len"].copy_(new_len)
    return out_project(p, o[:, None], x.dtype), cache


def _paged_decode(p, x, q, k, v, cache, cfg):
    """Paged int8 pool: the new token lands in arena page
    ``page_table[b, len // ps]`` at offset ``len % ps``. The FIRST token of
    a page quantizes with the row's admission-era running scale and stamps
    it as the page scale (a recycled page's stale scale never leaks in);
    later tokens reuse the page's stamped scale, so the page's earlier codes
    keep dequantizing right. The row's decode-era |K|/|V| maxima update
    ``k_max``/``v_max`` for the engine's scale refresh. Attention gathers
    through the page table (kernel K4).

    A free pool row keeps stepping with an all-trash table, and a finished
    row may step once more: their lengths can pass the table's width. The
    column is clamped to the last one (JAX's gather returns a fill value
    there and its scatter drops the write; a CUDA gather would fault), so
    such a write lands in page 0, the trash page, or in the finished
    stream's own last page, which is never a shared prompt page. Several
    rows may write page 0 at once; the order is unspecified, and page 0 is
    never read below a live stream's length."""
    from repro_torch.kernels import ops
    ptab = cache["page_table"]
    ps, mp = cache["k"].shape[1], ptab.shape[1]
    idx = cache["len"].long()
    bidx = torch.arange(x.shape[0], device=x.device)
    page = ptab[bidx, torch.clamp(idx // ps, max=mp - 1)].long()
    off = idx % ps
    fresh = (off == 0)[:, None]
    ks = torch.clamp(torch.where(fresh, cache["slot_k_scale"],
                                 cache["k_scale"][page]), min=1e-8)
    vs = torch.clamp(torch.where(fresh, cache["slot_v_scale"],
                                 cache["v_scale"][page]), min=1e-8)
    kf, vf = k[:, 0].float(), v[:, 0].float()
    cache["k"][page, off] = quantize_token(kf, ks)
    cache["v"][page, off] = quantize_token(vf, vs)
    cache["k_scale"][page] = ks
    cache["v_scale"][page] = vs
    torch.maximum(cache["k_max"], kf.abs().amax(dim=-1), out=cache["k_max"])
    torch.maximum(cache["v_max"], vf.abs().amax(dim=-1), out=cache["v_max"])
    new_len = (cache["len"] + 1).to(cache["len"].dtype)
    o = ops.paged_decode_attention(q[:, 0].contiguous(), cache["k"],
                                   cache["v"], cache["k_scale"],
                                   cache["v_scale"], ptab, new_len,
                                   window=cfg.sliding_window).to(x.dtype)
    cache["len"].copy_(new_len)
    return out_project(p, o[:, None], x.dtype), cache


def self_attention_verify(p, x, cache, cfg, *, pos=None, lora=None,
                          adapter_idx=None, lora_impl="gather",
                          lora_seg=None):
    """Speculative verify window: T = k + 1 positions through the paged
    pool, in place. x: (B, T, d): position 0 embeds the slot's last sampled
    token (what a plain decode step would feed), positions 1..k the drafted
    continuation. Returns (out (B, T, d), cache).

    Every window position's K/V is written into the slot's pages with
    exactly the scale a sequential walk of T single-token steps would use:
    a position reuses the page's stamped scale only if it lands in the page
    that already holds token ``len - 1`` (only the window's first page can
    predate the window); any other position is the first write to a fresh
    page, or follows one, and quantizes with the slot's running scale, which
    the sequential walk stamps at offset 0 and reuses for the rest of that
    page. A row's positions in one page write equal scale values, so the
    duplicate page indices of the scale write carry one value each and the
    unordered ``index_put_`` is exact. Attention then reads position j
    against keys ``0..len+j`` (``ops.paged_verify_attention``).

    ``len`` advances by T; ``k_max``/``v_max`` take the window's running
    maxima, and the per-position stacks ``k_cmax``/``v_cmax`` (B, T, KV),
    buffers the caller put in the cache, receive them at every position, so
    that the engine can roll ``len`` and the trackers back to each slot's
    commit point. Rejected positions' codes and fresh-page scale stamps lie
    past the rolled-back length, where the next write overwrites them:
    rollback frees no page.

    As in ``_paged_decode``, a free row (an all-trash table) or a finished
    row stepping on may run past the table's width: the column is clamped
    to the last one, so such writes land in the trash page or the stream's
    own last page."""
    from repro_torch.kernels import ops
    if "page_table" not in cache:
        raise ValueError("the speculative verify window needs the paged pool")
    q, k, v = qkv_project(p, x, cfg, pos=pos, lora=lora,
                          adapter_idx=adapter_idx, lora_impl=lora_impl,
                          lora_seg=lora_seg)
    B, T = x.shape[:2]
    ptab = cache["page_table"]
    ps, mp = cache["k"].shape[1], ptab.shape[1]
    idx = cache["len"].long()                              # (B,)
    pos_abs = idx[:, None] + torch.arange(T, device=x.device)[None]
    col = pos_abs // ps
    bidx = torch.arange(B, device=x.device)[:, None]
    page = ptab[bidx, torch.clamp(col, max=mp - 1)].long()  # (B, T)
    off = pos_abs % ps
    in_old = (col == ((idx - 1) // ps)[:, None])[..., None]
    ks = torch.clamp(torch.where(in_old, cache["k_scale"][page],
                                 cache["slot_k_scale"][:, None]), min=1e-8)
    vs = torch.clamp(torch.where(in_old, cache["v_scale"][page],
                                 cache["slot_v_scale"][:, None]), min=1e-8)
    kf, vf = k.float(), v.float()                          # (B, T, KV, hd)
    kq = torch.clamp(torch.round(kf / ks[..., None]), -127, 127).to(torch.int8)
    vq = torch.clamp(torch.round(vf / vs[..., None]), -127, 127).to(torch.int8)
    pf, of = page.reshape(-1), off.reshape(-1)
    cache["k"][pf, of] = kq.reshape((B * T,) + kq.shape[2:])
    cache["v"][pf, of] = vq.reshape((B * T,) + vq.shape[2:])
    cache["k_scale"][pf] = ks.reshape(B * T, -1)
    cache["v_scale"][pf] = vs.reshape(B * T, -1)
    k_cmax = torch.maximum(torch.cummax(kf.abs().amax(dim=-1), dim=1).values,
                           cache["k_max"][:, None])
    v_cmax = torch.maximum(torch.cummax(vf.abs().amax(dim=-1), dim=1).values,
                           cache["v_max"][:, None])
    cache["k_cmax"].copy_(k_cmax)
    cache["v_cmax"].copy_(v_cmax)
    cache["k_max"].copy_(k_cmax[:, -1])
    cache["v_max"].copy_(v_cmax[:, -1])
    o = ops.paged_verify_attention(q.contiguous(), cache["k"], cache["v"],
                                   cache["k_scale"], cache["v_scale"], ptab,
                                   cache["len"], window=cfg.sliding_window)
    cache["len"].copy_((cache["len"] + T).to(cache["len"].dtype))
    return out_project(p, o.to(x.dtype), x.dtype), cache

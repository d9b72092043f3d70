"""Config-driven block dispatcher: attention sublayers (optionally followed
by a cross-attention over an encoder's output), Mamba, mLSTM and sLSTM
sublayers, each optionally followed by a dense or MoE feed-forward.

A model is ``num_periods`` repetitions of a *period* of sublayers; parameters
and caches carry a leading ``num_periods`` axis, as in the JAX package, and
``models.lm`` loops over it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import ATTN, MAMBA, MLSTM, SLSTM, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import xlstm as xl
from repro_torch.models.common import ParamSpec
from repro_torch.models.layers import rmsnorm, rmsnorm_spec
from repro_torch.models.mlp import mlp, mlp_spec
from repro_torch.models.moe import moe_ffn, moe_spec


@dataclasses.dataclass(frozen=True)
class SubLayer:
    kind: str
    has_moe: bool
    has_ffn: bool
    has_cross: bool = False


def period_len(cfg: ModelConfig) -> int:
    base = len(cfg.block_pattern) if cfg.block_pattern else 1
    if cfg.uses_moe:
        base = math.lcm(base, cfg.moe_every)
    if cfg.num_layers % base:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers, period {base}")
    return base


def period_layout(cfg: ModelConfig, cross: bool = False) -> list[SubLayer]:
    """The period's sublayers; ``cross`` gives each a cross-attention over
    the encoder output (the decoder of an encoder-decoder stack). xLSTM
    blocks carry their own up/down projections: no feed-forward follows
    them."""
    out = []
    for pos in range(period_len(cfg)):
        kind = cfg.blocks[pos]
        has_ffn = cfg.d_ff > 0 and kind not in (MLSTM, SLSTM)
        has_moe = has_ffn and cfg._layer_has_moe(pos)
        out.append(SubLayer(kind, has_moe, has_ffn, cross))
    return out


# ---------------- specs ----------------

_MIXERS = {ATTN: ("attn", attn.attn_spec), MAMBA: ("mamba", mam.mamba_spec),
           MLSTM: ("mlstm", xl.mlstm_spec), SLSTM: ("slstm", xl.slstm_spec)}


def sublayer_spec(cfg: ModelConfig, lay: SubLayer) -> dict:
    name, spec_fn = _MIXERS[lay.kind]
    spec: dict = {"ln1": rmsnorm_spec(cfg.d_model), name: spec_fn(cfg)}
    if lay.has_cross:
        spec["ln_x"] = rmsnorm_spec(cfg.d_model)
        spec["cross"] = attn.attn_spec(cfg, cross=True)
    if lay.has_ffn:
        spec["ln2"] = rmsnorm_spec(cfg.d_model)
        spec["ffn"] = moe_spec(cfg) if lay.has_moe else mlp_spec(cfg)
    return spec


def recurrent_cache_spec(cfg: ModelConfig, kind: str, batch: int) -> dict:
    """The fixed-size per-row state of a recurrent sublayer: Mamba's conv
    window (bf16) and SSM state, mLSTM's matrix memory, normalizer and
    stabilizer, sLSTM's four vectors (f32). Zeros in the pool; a prefill
    starts from ``*_init_state``, not from these."""
    f32 = torch.float32
    if kind == MAMBA:
        di = cfg.mamba_expand * cfg.d_model
        return {
            "conv": ParamSpec((batch, cfg.mamba_d_conv - 1, di),
                              ("batch", None, "mlp"), init="zeros",
                              dtype=torch.bfloat16),
            "ssm": ParamSpec((batch, di, cfg.mamba_d_state),
                             ("batch", "mlp", None), init="zeros", dtype=f32),
        }
    dix = int(cfg.xlstm_proj_factor * cfg.d_model)
    h = cfg.num_heads
    if kind == MLSTM:
        return {
            "C": ParamSpec((batch, h, dix // h, dix // h),
                           ("batch", "heads", None, None), init="zeros",
                           dtype=f32),
            "n": ParamSpec((batch, h, dix // h), ("batch", "heads", None),
                           init="zeros", dtype=f32),
            "m": ParamSpec((batch, h), ("batch", "heads"), init="zeros",
                           dtype=f32),
        }
    if kind == SLSTM:
        return {k: ParamSpec((batch, dix), ("batch", "mlp"), init="zeros",
                             dtype=f32) for k in ("c", "n", "h", "m")}
    raise ValueError(f"unknown block kind {kind}")


def sublayer_cache_spec(cfg: ModelConfig, lay: SubLayer, batch: int,
                        s_max: int, enc_len: int = 0, kv_quant: bool = False,
                        paged: bool = False, page_size: int = 16,
                        num_pages: int = 0) -> Optional[dict]:
    """Decode cache of one sublayer.

    Dense: one (batch, s_max) region per row; ``kv_quant`` stores int8 K/V
    with per-(batch, kv-head) scales written at prefill admission.

    ``paged`` (int8 only): one arena of ``num_pages`` pages of
    ``page_size`` positions shared by every row, addressed through a
    per-row ``page_table`` (arena page ids; entries past a stream's last
    page stay 0, the trash page). Scales are per (page, kv-head);
    ``slot_k_scale``/``slot_v_scale`` are each row's admission-era running
    scales (decode appends quantize into them and stamp them on fresh
    pages), ``k_max``/``v_max`` the row's decode-era magnitude maxima for
    the engine's scale refresh. ``s_max`` bounds the table width
    (``ceil(s_max / page_size)``), not the memory held.

    A sublayer with a cross-attention carries ``ck``/``cv``: the encoder
    output's K/V, bf16, ``enc_len`` frames per row, written once at
    admission and read by every decode step — per-slot state beside either
    pool (dense bf16 sidecars next to the paged arena).

    A recurrent sublayer carries its fixed-size state on either pool
    (``recurrent_cache_spec``): nothing of it is paged or quantized."""
    if lay.kind != ATTN:
        return recurrent_cache_spec(cfg, lay.kind, batch)
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    cross = {}
    if lay.has_cross:
        for name in ("ck", "cv"):
            cross[name] = ParamSpec(
                (batch, enc_len, kv, hd),
                ("batch", "cache_seq", "kv_heads", None), init="zeros",
                dtype=torch.bfloat16)
    if paged:
        if not kv_quant or num_pages <= 0:
            raise ValueError("a paged pool is int8 (kv_quant=True) with "
                             "num_pages > 0")
        mp = -(-s_max // page_size)
        spec = {
            "k": ParamSpec((num_pages, page_size, kv, hd),
                           (None, None, "kv_heads", None), init="zeros",
                           dtype=torch.int8),
            "v": ParamSpec((num_pages, page_size, kv, hd),
                           (None, None, "kv_heads", None), init="zeros",
                           dtype=torch.int8),
            "page_table": ParamSpec((batch, mp), ("batch", None),
                                    init="zeros", dtype=torch.int32),
            "len": ParamSpec((batch,), ("batch",), init="zeros",
                             dtype=torch.int32),
        }
        for name in ("k_scale", "v_scale"):
            spec[name] = ParamSpec((num_pages, kv), (None, "kv_heads"),
                                   init="zeros", dtype=torch.float32)
        for name in ("slot_k_scale", "slot_v_scale", "k_max", "v_max"):
            spec[name] = ParamSpec((batch, kv), ("batch", "kv_heads"),
                                   init="zeros", dtype=torch.float32)
        return {**spec, **cross}
    kv_dt = torch.int8 if kv_quant else torch.bfloat16
    spec = {
        "k": ParamSpec((batch, s_max, kv, hd), ("batch", "cache_seq", "kv_heads", None),
                       init="zeros", dtype=kv_dt),
        "v": ParamSpec((batch, s_max, kv, hd), ("batch", "cache_seq", "kv_heads", None),
                       init="zeros", dtype=kv_dt),
        "len": ParamSpec((batch,), ("batch",), init="zeros", dtype=torch.int32),
    }
    if kv_quant:
        for name in ("k_scale", "v_scale"):
            spec[name] = ParamSpec((batch, kv), ("batch", "kv_heads"),
                                   init="zeros", dtype=torch.float32)
    return {**spec, **cross}


# ---------------- apply ----------------

def _ffn_apply(p, x, cfg: ModelConfig, lay: SubLayer, seq_lens=None,
               aux=None):
    """The feed-forward after a mixer: dense, or MoE with the pads of a
    right-padded prefill (``seq_lens``) kept out of routing. The MoE aux
    loss is appended to ``aux`` where a list is given (training, the JAX
    package's ``loss_fn``), else dropped, as on the serving path."""
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if lay.has_moe:
        valid = None if seq_lens is None else \
            torch.arange(x.shape[1], device=x.device)[None] < seq_lens[:, None]
        out, a = moe_ffn(p["ffn"], h, k=cfg.experts_per_token,
                         dispatch=cfg.moe_dispatch, valid=valid)
        if aux is not None:
            aux.append(a)
        return x + out
    return x + mlp(p["ffn"], h)


def _recurrent_apply(p, x, h, cfg: ModelConfig, lay: SubLayer, mode: str,
                     cache, seq_lens, aux=None):
    """A Mamba, mLSTM or sLSTM sublayer. Outside decode the scan starts
    from its initial state (zeros; the xLSTM stabilizer ``m`` at -1e30),
    never from the pool's zeroed cache, and a given cache receives the
    state at each row's true length (a prefill)."""
    if mode not in ("full", "decode"):
        raise ValueError(f"a {lay.kind} sublayer has no {mode!r} mode")
    decode = mode == "decode"
    lens = None if decode else seq_lens
    if lay.kind == MAMBA:
        if decode:
            out, (conv, ssm) = mam.mamba_decode(p["mamba"], h, cfg,
                                                cache["conv"], cache["ssm"])
        else:
            out, (conv, ssm) = mam.mamba_forward(p["mamba"], h, cfg,
                                                 seq_lens=lens)
        state = {"conv": conv, "ssm": ssm}
    else:
        fwd = xl.mlstm_forward if lay.kind == MLSTM else xl.slstm_forward
        out, state = fwd(p[lay.kind], h, cfg,
                         state=dict(cache) if decode else None,
                         seq_lens=lens)
    if cache is not None:        # in place: executables read the pool
        for k, v in state.items():
            cache[k].copy_(v)
    x = x + out
    if lay.has_ffn:
        x = _ffn_apply(p, x, cfg, lay, seq_lens=lens, aux=aux)
    return x


def _fill_cache(cache, k, v, seq_lens):
    """Prefill: write the prompt's K/V into the (B, s_max) cache in place —
    quantized per (row, kv head) on an int8 cache — zeroing the rest, and
    set the per-row lengths."""
    S = k.shape[1]
    if seq_lens is not None:
        # zero the pad positions: the int8 scales are taken over all of S
        valid = torch.arange(S, device=k.device)[None] < seq_lens[:, None]
        k = k * valid[..., None, None].to(k.dtype)
        v = v * valid[..., None, None].to(v.dtype)
    cache["k"].zero_()
    cache["v"].zero_()
    if "k_scale" in cache:
        from repro_torch.kernels import ops
        kq, vq, ks, vs = ops.quantize_kv(k, v)
        cache["k"][:, :S] = kq
        cache["v"][:, :S] = vq
        cache["k_scale"].copy_(ks)
        cache["v_scale"].copy_(vs)
    else:
        cache["k"][:, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :S] = v.to(cache["v"].dtype)
    if seq_lens is None:
        cache["len"].fill_(S)
    else:
        cache["len"].copy_(seq_lens.to(cache["len"].dtype))


def sublayer_apply(p, x, cfg: ModelConfig, lay: SubLayer, *, mode: str,
                   cache=None, pos=None, pos3=None, causal=True, enc_out=None,
                   cross_len=None, lora=None, adapter_idx=None,
                   lora_impl: str = "gather", lora_seg=None, seq_lens=None,
                   prefix=None, prefix_len=None, aux=None):
    """Apply one sublayer. mode: 'full' (pooled forward / prefill),
    'decode' or 'verify' (the speculative window: T positions at rope
    positions ``len + arange(T)`` through the paged pool,
    ``attention.self_attention_verify``). A given cache is a dict of views
    that is updated in place (prefill fills it, decode appends one token,
    verify appends the window).

    ``prefix``/``prefix_len``: chunked shared-prefix prefill — a dict(k, v)
    of precomputed (B, Sp, KV, hd) prefix K/V this sublayer's queries
    attend to in front of their own keys (``attention.self_attention``).
    The cache fill stores only the tail's K/V: the prefix already lives in
    the paged arena.

    A cross-attention sublayer projects ``enc_out`` (B, S_enc, d) into its
    K/V in 'full' mode (and persists them in the cache's ``ck``/``cv`` on a
    prefill); in 'decode' mode it reads them back from the cache with
    ``cross_len`` (B,) valid frames, every row at its full length.

    ``pos3`` (B, S, 3): M-RoPE position streams (an M-RoPE config; else
    ignored). A decode or verify step without them takes text positions, t
    = h = w = the RoPE position, as the JAX package does.

    A recurrent sublayer (Mamba, mLSTM, sLSTM; 'full' and 'decode' only)
    updates its fixed-size state in the cache (``_recurrent_apply``). A MoE
    feed-forward routes the pads of a 'full' prefill out (``seq_lens``);
    after a decode or verify step it takes no validity mask. ``aux``, a
    list (training only), receives the MoE aux loss of its feed-forward."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if lay.kind != ATTN:
        return _recurrent_apply(p, x, h, cfg, lay, mode, cache, seq_lens,
                                aux)
    if mode == "decode":
        if pos is None:
            pos = cache["len"][:, None]                   # rope position
        if pos3 is None and cfg.mrope_sections is not None:
            pos3 = pos[..., None].expand(*pos.shape, 3)   # text: t = h = w
        out, _ = attn.self_attention_decode(
            p["attn"], h, cache, cfg, pos=pos, pos3=pos3, lora=lora,
            adapter_idx=adapter_idx, lora_impl=lora_impl, lora_seg=lora_seg)
    elif mode == "verify":
        if lay.has_cross:
            raise ValueError("the verify window has no encoder-decoder mode")
        if pos is None:
            pos = cache["len"][:, None] + torch.arange(
                x.shape[1], device=x.device)[None]
        if pos3 is None and cfg.mrope_sections is not None:
            pos3 = pos[..., None].expand(*pos.shape, 3)   # text: t = h = w
        out, _ = attn.self_attention_verify(
            p["attn"], h, cache, cfg, pos=pos, pos3=pos3, lora=lora,
            adapter_idx=adapter_idx, lora_impl=lora_impl, lora_seg=lora_seg)
    elif mode == "full":
        out, (k, v) = attn.self_attention(
            p["attn"], h, cfg, causal=causal, pos=pos, pos3=pos3, lora=lora,
            adapter_idx=adapter_idx, lora_impl=lora_impl, lora_seg=lora_seg,
            seq_lens=seq_lens, prefix=prefix, prefix_len=prefix_len)
        if cache is not None:
            _fill_cache(cache, k, v, seq_lens)
    else:
        raise ValueError(f"unknown mode {mode!r}")
    x = x + out
    if lay.has_cross:
        hx = rmsnorm(p["ln_x"], x, cfg.norm_eps)
        if mode == "decode":
            q = attn._proj(hx, p["cross"]["wq"])[:, 0].contiguous()
            o = attn.decode_attention(q, cache["ck"], cache["cv"], cross_len)
            x = x + attn.out_project(p["cross"], o[:, None], hx.dtype)
        else:
            ck = attn._proj(enc_out, p["cross"]["wk"])
            cv = attn._proj(enc_out, p["cross"]["wv"])
            if cache is not None:                         # persist for decode
                cache["ck"].copy_(ck)
                cache["cv"].copy_(cv)
            x = x + attn.cross_attention(p["cross"], hx, (ck, cv), cfg)
    if lay.has_ffn:
        x = _ffn_apply(p, x, cfg, lay,
                       seq_lens=seq_lens if mode == "full" else None, aux=aux)
    return x

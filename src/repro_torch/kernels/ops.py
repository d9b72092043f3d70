"""Kernel entry points of the port, in the model layout.

Each op launches its hand-written CUDA kernel for CUDA tensors and uses the
plain PyTorch version in ``kernels.ref`` only for tensors that lie on the
CPU (the tests); any other device raises. There is no fallback: a CUDA
tensor reaches the kernel or an error. ``LAUNCHES`` counts kernel launches
per kernel name.

Gradients: where autograd records (grad mode on and an input that requires
grad), ``flash_attention`` and ``rmsnorm`` on CUDA tensors go through
``_FlashAttentionFn`` / ``_RMSNormFn``, whose backward is a kernel too
(``flash_attention_bwd``, ``rmsnorm_bwd``); otherwise they launch exactly
as before (no log-sum-exp, nothing saved), so the serving executables are
unchanged. On the CPU the plain versions are differentiable as they are:
their autograd is the plain version of each backward. The kernels without
a backward (K1, K3, K4, the verify window, K5) and ``gather_prefix_kv``
raise ``ValueError`` on an input that requires grad, on either device,
rather than cut the graph: none of them lies on a training path.

Meshes: ``flash_attention`` and ``rmsnorm`` given DTensors run through
``local_map`` (``_local_flash``, ``_local_rmsnorm``): each rank's kernel
(and, where autograd records, its backward kernel) sees plain tensors, its
local shard, never a DTensor. The other kernels serve on one device and
refuse a DTensor.

Meta tensors (the dry-run, ``launch.optrace``): every wrapper returns
outputs of its kernel's shapes and dtypes (K2 with its log-sum-exp) and
reports the kernel's own FLOPs and bytes to ``META_WORK`` (the formulas of
the bounds ``chip_smoke.py`` holds each kernel's time against, counted for
full lengths: a meta tensor has no data); it never runs the plain version.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels import decode_attention as _float
from repro_torch.kernels import decode_attention_int8 as _int8
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_decode_attention as _paged
from repro_torch.kernels import paged_verify_attention as _verify
from repro_torch.kernels import rmsnorm as _rmsnorm
from repro_torch.kernels import segmented_lora as _sgmv

LAUNCHES = build.LAUNCHES
reset_launches = build.reset_launches

# set by ``launch.optrace`` while it traces a step: called as
# ``META_WORK(kernel name, flops, bytes)`` for each kernel call on meta tensors
META_WORK = None


def _route(x) -> str:
    """"cpu" (the plain version), "cuda" (the kernel) or "meta" (the
    kernel's shapes and work, only while ``launch.optrace`` traces: a meta
    tensor outside a trace gets no kernel)."""
    kind = x.device.type
    if kind not in ("cpu", "cuda", "meta") or (
            kind == "meta" and META_WORK is None):
        raise ValueError(f"no kernel for device {x.device}")
    return kind


def _dtensor(t) -> bool:
    """True for a DTensor (a plain tensor answers without an import)."""
    if t is None or type(t) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _no_dtensor(name: str, *ts):
    if any(_dtensor(t) for t in ts):
        raise ValueError(f"{name} serves on one device: it takes no DTensor")


def _meta_work(name: str, flops: float, nbytes: float):
    if META_WORK is not None:
        META_WORK(name, float(flops), float(nbytes))


def _visible(Sq: int, Sk: int, Sp: int, causal: bool, window) -> tuple:
    """(visible (query, key) pairs of one row and head, keys any query
    reads) for full lengths: queries at the last Sq of Sp + Sk positions,
    ``flash_visible``'s masks in closed form."""
    import numpy as np
    n = Sp + Sk
    qpos = np.arange(n - Sq, n, dtype=np.int64)
    hi = qpos + 1 if causal else np.full(Sq, n, dtype=np.int64)
    lo = np.maximum(qpos - int(window) + 1, 0) if window is not None else \
        np.zeros(Sq, dtype=np.int64)
    pairs = int(np.maximum(hi - lo, 0).sum())
    keys = int(min(n, hi.max()) - max(0, lo.min())) if Sq else 0
    return pairs, keys


def _k2(q, k, v, causal, window, kv_len, prefix_k=None, prefix_v=None,
        prefix_len=None, with_lse=False):
    """K2's forward on CUDA tensors, or its meta shapes and work."""
    if q.device.type != "meta":
        return _flash.flash_attention(q, k, v, causal=causal, window=window,
                                      kv_len=kv_len, prefix_k=prefix_k,
                                      prefix_v=prefix_v,
                                      prefix_len=prefix_len,
                                      with_lse=with_lse)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    Sp = 0 if prefix_k is None else prefix_k.shape[1]
    pairs, keys = _visible(Sq, Sk, Sp, causal, window)
    es = q.element_size()
    _meta_work("flash_attention", 4.0 * hd * H * B * pairs,
               2 * es * B * Sq * H * hd + 2 * es * B * keys * KV * hd + 8 * B)
    out = torch.empty(q.shape, dtype=q.dtype, device="meta")
    if not with_lse:
        return out
    return out, torch.empty((B, H, Sq), dtype=torch.float32, device="meta")


def _k2_bwd(q, k, v, out, lse, dout, causal, window, kv_len):
    if q.device.type != "meta":
        return _flash.flash_attention_bwd(q, k, v, out, lse, dout,
                                          causal=causal, window=window,
                                          kv_len=kv_len)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    pairs, _ = _visible(Sq, Sk, 0, causal, window)
    es = q.element_size()
    _meta_work("flash_attention_bwd", 10.0 * hd * H * B * pairs,
               es * (4 * B * Sq * H * hd + 4 * B * Sk * KV * hd)
               + 4 * B * H * Sq)
    return tuple(torch.empty(t.shape, dtype=t.dtype, device="meta")
                 for t in (q, k, v))


def _rms(w, x, eps):
    if x.device.type != "meta":
        return _rmsnorm.rmsnorm(w, x, eps)
    d = x.shape[-1]
    rows = x.numel() // d
    _meta_work("rmsnorm", 4.0 * rows * d,
               2 * x.element_size() * rows * d + 4 * d)
    return torch.empty(x.shape, dtype=x.dtype, device="meta")


def _rms_bwd(w, x, dy, eps, need_dw):
    if x.device.type != "meta":
        return _rmsnorm.rmsnorm_bwd(w, x, dy, eps, need_dw=need_dw)
    d = x.shape[-1]
    rows = x.numel() // d
    _meta_work("rmsnorm_bwd", 10.0 * rows * d,
               3 * x.element_size() * rows * d + 4 * d * (2 if need_dw else 1))
    dx = torch.empty(x.shape, dtype=x.dtype, device="meta")
    return dx, (torch.empty(w.shape, dtype=w.dtype, device="meta")
                if need_dw else None)


def _records(*ts) -> bool:
    """True where autograd would record an op on ``ts`` (None skipped)."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _no_grad_path(name: str, *ts):
    """Refuse an input that requires grad: ``name`` has no backward."""
    if _records(*ts):
        raise ValueError(f"{name} has no backward: it serves only, so it "
                         f"takes no input that requires grad")


class _FlashAttentionFn(torch.autograd.Function):
    """K2 with its gradient: the forward keeps each row's log-sum-exp,
    the backward launches ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, kv_len):
        out, lse = _k2(q, k, v, causal, window, kv_len, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, kv_len)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, kv_len = ctx.saved_tensors
        dq, dk, dv = _k2_bwd(q, k, v, out, lse, dout, ctx.causal,
                             ctx.window, kv_len)
        return dq, dk, dv, None, None, None


class _RMSNormFn(torch.autograd.Function):
    """The rmsnorm kernel with its gradient (``rmsnorm_bwd``); dw only
    where ``w`` requires grad."""

    @staticmethod
    def forward(ctx, w, x, eps):
        ctx.save_for_backward(w, x)
        ctx.eps = eps
        return _rms(w, x, eps)

    @staticmethod
    def backward(ctx, dy):
        w, x = ctx.saved_tensors
        dx, dw = _rms_bwd(w, x, dy, ctx.eps, ctx.needs_input_grad[0])
        return dw, dx, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, q_chunk: int = 1024,
                    kv_chunk: int = 1024, kv_len=None, prefix_k=None,
                    prefix_v=None, prefix_len=None):
    """Prefill GQA attention in the model layout (kernel K2): q (B, Sq, H,
    hd), k/v (B, Sk, KV, hd), optional ``kv_len`` (B,) and prefix operand
    (B, Sp, KV, hd) with ``prefix_len`` (B,) — the semantics of
    ``ref.flash_attention_ref``. ``q_chunk``/``kv_chunk`` tile the plain
    version only; the kernel has its own tiles. Where autograd records, a
    CUDA call takes the kernel's gradient; the prefix operand (serving
    only) is refused there on either device. DTensors run through
    ``local_map`` (``_local_flash``)."""
    if _dtensor(q):
        if prefix_k is not None:
            raise ValueError("flash_attention's prefix operand serves on one "
                             "device: no DTensor path")
        return _local_flash(q, k, v, causal, window, kv_len)
    grad = _records(q, k, v, prefix_k, prefix_v)
    if grad and prefix_k is not None:
        raise ValueError("flash_attention's prefix operand is serving-only: "
                         "no gradient through it")
    if _route(q) != "cpu":
        if grad:
            return _FlashAttentionFn.apply(q, k, v, causal, window, kv_len)
        return _k2(q, k, v, causal, window, kv_len, prefix_k, prefix_v,
                   prefix_len)
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
    _no_grad_path("gather_prefix_kv", k_pages, v_pages, k_scale, v_scale)
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
                     window: Optional[int] = None, key_offset: int = 0,
                     return_lse: bool = False):
    """Float-cache GQA decode attention, model layout (kernel K5).

    q: (B, H, hd); k_cache/v_cache: (B, S, KV, hd) in the cache dtype (any
    S; views into a pool are read in place); lengths: (B,) valid lengths
    -> (B, H, hd) in q's dtype. Positions [max(0, len - window), len) are
    attended; the probabilities round to the cache dtype before P·V, as in
    the JAX package's jnp ``models.attention.decode_attention``.
    ``key_offset`` (an int): the cache is a piece of a longer one whose
    key 0 sits at that global position; only the global positions it holds
    are attended. ``return_lse``: return (o (B, H, hd) f32 normalised over
    those keys, lse (B, H) f32 their natural log-sum-exp; o = 0 and lse =
    -inf where the piece holds none), for ``models.attention.
    merge_partials``."""
    _no_grad_path("decode_attention (K5)", q, k_cache, v_cache)
    _no_dtensor("decode_attention (K5)", q, k_cache, v_cache)
    if _route(q) == "meta":
        B, H, hd = q.shape
        S, KV = k_cache.shape[1], k_cache.shape[2]
        n = B * (S if window is None else min(S, int(window)))
        o_size = 4 if return_lse else q.element_size()
        _meta_work("decode_attention", 4.0 * n * H * hd,
                   (q.element_size() + o_size) * B * H * hd
                   + 2 * k_cache.element_size() * n * KV * hd + 4 * B
                   + (4 * B * H if return_lse else 0))
        if return_lse:
            return (torch.empty(q.shape, dtype=torch.float32, device="meta"),
                    torch.empty((B, H), dtype=torch.float32, device="meta"))
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    if _route(q) == "cuda":
        return _float.decode_attention(q, k_cache, v_cache, lengths,
                                       window=window, key_offset=key_offset,
                                       return_lse=return_lse)
    return ref.decode_attention_ref(q, k_cache.transpose(1, 2),
                                    v_cache.transpose(1, 2), lengths,
                                    window=window, p_dtype=v_cache.dtype,
                                    key_offset=key_offset,
                                    return_lse=return_lse)


def decode_attention_int8(q, k_q, v_q, k_scale, v_scale, lengths, *,
                          window: Optional[int] = None, key_offset: int = 0,
                          return_lse: bool = False):
    """int8-KV decode attention, model layout (kernel K3).

    q: (B, H, hd); k_q/v_q: (B, S, KV, hd) int8; k_scale/v_scale: (B, KV);
    lengths: (B,) -> (B, H, hd). The kernel reads the cache through a
    head-major view of the model layout, never a copy. ``key_offset`` (an
    int): the cache is a piece of a longer one whose key 0 sits at that
    global position; only the global positions it holds are attended.
    ``return_lse``: return (o (B, H, hd) f32 normalised over those keys,
    lse (B, H) f32 their natural log-sum-exp; o = 0 and lse = -inf where
    the piece holds none), for ``models.attention.merge_partials``."""
    _no_grad_path("decode_attention_int8 (K3)", q, k_scale, v_scale)
    _no_dtensor("decode_attention_int8 (K3)", q, k_q, v_q)
    if _route(q) == "meta":
        B, H, hd = q.shape
        S, KV = k_q.shape[1], k_q.shape[2]
        n = B * (S if window is None else min(S, int(window)))
        o_size = 4 if return_lse else 2
        # the split body's partials, written and read once (an H100's plan)
        _, nsplit = _int8.plan(B, KV, H // KV, hd, S, window, _int8._META_SMS)
        _meta_work("decode_attention_int8", 4.0 * n * H * hd,
                   (2 + o_size) * B * H * hd + 2 * n * KV * hd
                   + 2 * 4 * B * KV + 4 * B + (4 * B * H if return_lse else 0)
                   + 2 * 4 * _int8.workspace_floats(B, KV, H // KV, hd,
                                                    nsplit))
        if return_lse:
            return (torch.empty(q.shape, dtype=torch.float32, device="meta"),
                    torch.empty((B, H), dtype=torch.float32, device="meta"))
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    kh = k_q.transpose(1, 2)
    vh = v_q.transpose(1, 2)
    if _route(q) == "cuda":
        return _int8.decode_attention_int8(q, kh, vh, k_scale, v_scale,
                                           lengths, window=window,
                                           key_offset=key_offset,
                                           return_lse=return_lse)
    return ref.decode_attention_int8_ref(q, kh, vh, k_scale, v_scale, lengths,
                                         window=window, key_offset=key_offset,
                                         return_lse=return_lse)


def paged_decode_attention(q, k_pages, v_pages, k_scale, v_scale, page_table,
                           lengths, *, window: Optional[int] = None):
    """Paged int8-KV decode attention, model layout.

    q: (B, H, hd); k_pages/v_pages: (P, ps, KV, hd) int8 arena; k_scale/
    v_scale: (P, KV) per-page scales; page_table: (B, MP) int32 (rows of
    different streams may map the same page: copy-on-write prefix sharing;
    the read needs no change); lengths: (B,) -> (B, H, hd). The kernel reads
    the arena through its model-layout strides; the plain version gathers
    through a head-major view. Neither copies the arena."""
    _no_grad_path("paged_decode_attention (K4)", q, k_scale, v_scale)
    _no_dtensor("paged_decode_attention (K4)", q, k_pages, v_pages)
    if _route(q) == "meta":
        B, H, hd = q.shape
        _, ps, KV, _ = k_pages.shape
        MP = page_table.shape[1]
        n = B * MP * ps if window is None else B * min(MP * ps, int(window))
        pages = -(-n // ps)
        _meta_work("paged_decode_attention", 4.0 * n * H * hd,
                   2 * pages * ps * KV * hd + 2 * 4 * pages * KV
                   + 4 * B * MP + 2 * 2 * B * H * hd + 4 * B)
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    if _route(q) == "cuda":
        return _paged.paged_decode_attention(q, k_pages, v_pages, k_scale,
                                             v_scale, page_table, lengths,
                                             window=window)
    return ref.paged_decode_attention_ref(q, k_pages.transpose(1, 2),
                                          v_pages.transpose(1, 2), k_scale,
                                          v_scale, page_table, lengths,
                                          window=window)


def paged_verify_attention(q, k_pages, v_pages, k_scale, v_scale,
                           page_table, base_len, *,
                           window: Optional[int] = None):
    """The speculative verify window through the paged pool, model layout.

    q: (B, T, H, hd), the T = k + 1 window positions' queries; window
    position j sits at absolute position ``base_len + j`` and attends
    ``base_len + j + 1`` keys, so every position's K/V must already be in
    the arena; k_pages/v_pages: (P, ps, KV, hd) int8; k_scale/v_scale:
    (P, KV); page_table: (B, MP) int32; base_len: (B,) -> (B, T, H, hd).
    The kernel walks each stream's pages once for all T positions; the
    plain version is T single-token reads."""
    _no_grad_path("paged_verify_attention", q, k_scale, v_scale)
    _no_dtensor("paged_verify_attention", q, k_pages, v_pages)
    if _route(q) == "meta":
        B, T, H, hd = q.shape
        _, ps, KV, _ = k_pages.shape
        MP = page_table.shape[1]
        n = B * MP * ps if window is None else B * min(MP * ps, int(window))
        pages = -(-n // ps)
        _meta_work("paged_verify_attention", 4.0 * T * n * H * hd,
                   2 * pages * ps * KV * hd + 2 * 4 * pages * KV
                   + 4 * B * MP + 2 * 2 * B * T * H * hd + 4 * B)
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    if _route(q) == "cuda":
        return _verify.paged_verify_attention(q, k_pages, v_pages, k_scale,
                                              v_scale, page_table, base_len,
                                              window=window)
    return ref.paged_verify_attention_ref(q, k_pages.transpose(1, 2),
                                          v_pages.transpose(1, 2), k_scale,
                                          v_scale, page_table, base_len,
                                          window=window)


def segmented_lora(x, block_adapter, a_w, b_w, *, block_t: int = 128):
    """x: (T, d) adapter-sorted; b_w: (NA, r, out) -> LoRA delta (T, out).
    Serving only (the gather path carries a gradient): an input that
    requires grad raises."""
    _no_grad_path("segmented_lora (K1)", x, a_w, b_w)
    _no_dtensor("segmented_lora (K1)", x, a_w, b_w)
    if _route(x) == "meta":
        T, d = x.shape
        na, _, r = a_w.shape
        out = b_w.shape[-1]
        blocks = block_adapter.numel()
        used = min(na, blocks)
        _meta_work("segmented_lora", 2.0 * T * r * (d + out),
                   2 * T * d + 2 * T * out + 4 * blocks
                   + 4 * used * (d * r + r * out))
        return torch.empty((T, out), dtype=x.dtype, device="meta")
    if _route(x) == "cuda":
        return _sgmv.segmented_lora(x, block_adapter, a_w, b_w,
                                    block_t=block_t)
    return ref.segmented_lora_ref(x, block_adapter, a_w, b_w, block_t)


def rmsnorm(w, x, eps: float = 1e-5):
    """RMS norm over the last dim: x (..., d) taken to f32, scaled by
    ``rsqrt(mean(x^2) + eps)`` and by ``w`` in f32, returned in x's dtype.
    The kernel's row outputs depend on the row alone, never on how many
    rows share the call (the plain version's f32 mean on the card does).
    Where autograd records, a CUDA call takes the kernel's gradient.
    DTensors run through ``local_map`` (``_local_rmsnorm``)."""
    if _dtensor(x) or _dtensor(w):
        return _local_rmsnorm(w, x, eps)
    if _route(x) != "cpu":
        if _records(w, x):
            return _RMSNormFn.apply(w, x, eps)
        return _rms(w, x, eps)
    return ref.rmsnorm(w, x, eps)


# ---------------- DTensors: the kernels on local shards ----------------

def _as_dtensor(t, mesh):
    """A plain tensor as a replicated DTensor on ``mesh`` (None stays)."""
    from torch.distributed.tensor import DTensor, Replicate
    if t is None or _dtensor(t):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _local_flash(q, k, v, causal, window, kv_len):
    """K2 on each rank's local heads and rows. q's placements are kept
    where they shard the batch (dim 0) or the heads (dim 2); any other
    placement becomes ``Replicate``. k and v take the same placements:
    ``heads`` and ``kv_heads`` both go to "model" under the rules, so each
    rank's q heads and kv heads stay in the same GQA groups (rank r holds
    q heads [r H/n, (r+1) H/n) and kv heads [r KV/n, (r+1) KV/n), and
    q head h reads kv head h // G in both numberings). That needs H and KV
    divisible by the head split n: ``sharding.padding.pad_for_tp`` makes
    them so, and an unpadded config raises ``ValueError``. ``kv_len``
    (B,) follows the batch split."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    k, v = _as_dtensor(k, mesh), _as_dtensor(v, mesh)
    pl = tuple(p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
               for p in q.placements)
    n = 1
    for i, p in enumerate(pl):
        if p == Shard(2):
            n *= mesh.size(i)
    H, KV = q.shape[2], k.shape[2]
    if H % n or KV % n:
        raise ValueError(f"K2 on a mesh: {H} q heads and {KV} kv heads over "
                         f"a {n}-way head split; pad the config with "
                         f"sharding.padding.pad_for_tp")
    lpl = None
    if kv_len is not None:
        kv_len = _as_dtensor(kv_len, mesh)
        lpl = tuple(Shard(0) if p == Shard(0) else Replicate() for p in pl)

    def local(ql, kl, vl, ll):
        return flash_attention(ql, kl, vl, causal=causal, window=window,
                               kv_len=ll)
    return local_map(local, out_placements=(pl,),
                     in_placements=(pl, pl, pl, lpl), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v, kv_len)


def _local_rmsnorm(w, x, eps):
    """The rmsnorm kernel on each rank's local rows with the whole ``d``:
    x keeps its placements but on its last dim (a ``Shard`` there, or a
    ``Partial``, becomes ``Replicate``); w, ``Shard`` over data along
    ``embed`` under ``FSDP_RULES``, is gathered to ``Replicate``. Each
    rank's dw sums its own rows only, so w's gradient is ``Partial`` on
    every mesh dimension that splits the rows. The output keeps only a
    split of dim 0 (the batch): a sequence split (the sequence-parallel
    residual stream) is gathered, as Megatron's sequence parallelism
    gathers the norm's output before the projections (every norm output
    feeds a matrix product, and DTensor cannot flatten (B, S) for it
    with S split)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = (x if _dtensor(x) else w).device_mesh
    x, w = _as_dtensor(x, mesh), _as_dtensor(w, mesh)
    last = x.ndim - 1
    pl = tuple(p if isinstance(p, Shard) and p.dim != last else Replicate()
               for p in x.placements)
    rep = tuple(Replicate() for _ in pl)
    dw = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in pl)

    def local(wl, xl):
        return rmsnorm(wl, xl, eps)
    y = local_map(local, out_placements=(pl,), in_placements=(rep, pl),
                  in_grad_placements=(dw, pl), device_mesh=mesh,
                  redistribute_inputs=True)(w, x)
    rows = tuple(p if p == Shard(0) else Replicate() for p in pl)
    return y if rows == pl else y.redistribute(mesh, rows)

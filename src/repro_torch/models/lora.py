"""Multi-adapter backbone LoRA (FMplex task customization, S-LoRA style).

Adapters attach to the q and v projections of every attention sublayer. A
*stack* holds all co-resident adapters of a physical FM: leaves are shaped
(num_periods, NA, ...). Each request carries ``adapter_idx`` (B,) int32 — the
sentinel NA (or anything larger) means "base model".

Two execution paths:
  * gather: per-request A/B gathered then applied (exact, f32);
  * segmented: adapter-sorted, block-padded tokens through the SGMV kernel
    (``kernels.ops.segmented_lora``), the serve path.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.models.common import ParamSpec, init_params, stack_specs, tree_map


def lora_sublayer_spec(cfg: ModelConfig, num_adapters: int, rank: int) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def mk(out):
        return {
            "a": ParamSpec((num_adapters, d, rank), ("adapters", "embed", None),
                           scale=0.05),
            "b": ParamSpec((num_adapters, rank, out),
                           ("adapters", None, "heads_flat"), init="zeros"),
        }
    return {"q": mk(h * hd), "v": mk(kv * hd)}


def lora_spec(cfg: ModelConfig, num_adapters: int, rank: int) -> list:
    """Per-sublayer stacked spec list matching ``lm.model_spec`` layers."""
    from repro_torch.models import blocks as blk
    nper = cfg.num_layers // blk.period_len(cfg)
    return [stack_specs(lora_sublayer_spec(cfg, num_adapters, rank), nper)
            if lay.kind == ATTN else {}
            for lay in blk.period_layout(cfg)]


def apply_lora_delta(x, a_stack, b_stack, adapter_idx):
    """Gather-based per-request LoRA delta, accumulated in f32.

    x: (B, S, d); a_stack: (NA, d, r); b_stack: (NA, r, out);
    adapter_idx: (B,) with >= NA meaning "no adapter". Returns (B, S, out)."""
    na = a_stack.shape[0]
    safe = torch.clamp(adapter_idx, max=na - 1).long()
    a = a_stack[safe].float()                             # (B, d, r)
    b = b_stack[safe].float()                             # (B, r, out)
    h = torch.bmm(x.float(), a)
    delta = torch.bmm(h, b).to(x.dtype)
    keep = (adapter_idx < na)[:, None, None]
    return torch.where(keep, delta, torch.zeros_like(delta))


def apply_lora_delta_segmented(x, a_stack, b_stack, seg):
    """Segmented (SGMV) per-token LoRA delta — the serve hot path.

    ``seg`` holds the per-batch metadata built once on the host: ``perm``
    (Tp,) gather into adapter-sorted block-padded order, ``inv`` (T,)
    gather back, ``block_adapter`` (Tp // block_t,) and ``block_t``."""
    from repro_torch.kernels import ops

    B, S, d = x.shape
    out = b_stack.shape[-1]
    x_sorted = x.reshape(B * S, d).index_select(0, seg["perm"])
    delta = ops.segmented_lora(x_sorted, seg["block_adapter"], a_stack,
                               b_stack, block_t=seg["block_t"])
    return delta.index_select(0, seg["inv"]).reshape(B, S, out)


def qv_lora(x, lora_sub: Optional[dict], adapter_idx, q, v,
            impl: str = "gather", seg: Optional[dict] = None):
    """Add LoRA deltas to projected q/v. q: (B,S,H,hd); v: (B,S,KV,hd)."""
    if not lora_sub or adapter_idx is None:
        return q, v
    B, S, H, hd = q.shape
    KV = v.shape[2]
    if impl == "segmented":
        if seg is None:
            raise ValueError("lora impl 'segmented' requires seg metadata "
                             "(perm/inv/block_adapter/block_t)")
        dq = apply_lora_delta_segmented(x, lora_sub["q"]["a"],
                                        lora_sub["q"]["b"], seg)
        dv = apply_lora_delta_segmented(x, lora_sub["v"]["a"],
                                        lora_sub["v"]["b"], seg)
    elif impl == "gather":
        dq = apply_lora_delta(x, lora_sub["q"]["a"], lora_sub["q"]["b"],
                              adapter_idx)
        dv = apply_lora_delta(x, lora_sub["v"]["a"], lora_sub["v"]["b"],
                              adapter_idx)
    else:
        raise ValueError(f"unknown lora impl {impl!r}")
    return q + dq.reshape(B, S, H, hd), v + dv.reshape(B, S, KV, hd)


def init_single_adapter(gen, cfg: ModelConfig, rank: int, device="cuda"):
    """One adapter's weights (NA=1 stack)."""
    return init_params(gen, lora_spec(cfg, 1, rank), device=device)


def stack_adapters(adapters: list):
    """Combine per-adapter trees (NA=1 each) into one NA=n stack."""
    return tree_map(lambda *xs: torch.cat(xs, dim=1), adapters[0], *adapters[1:])

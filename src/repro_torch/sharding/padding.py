"""TP-friendly head/vocab padding (Megatron-style, exact).

A tensor-parallel mesh wants head and vocab dims that divide its "model"
dimension. GQA configs like qwen2-7b (28 q heads, 4 kv heads) don't divide
a 16-way model dimension, so we apply the standard serving transformation:

* **KV expansion**: store each kv head ``r = tp / gcd(kv, tp)`` times so the
  expanded kv dim divides tp. Per-device cache bytes equal the classic
  "replicate KV within TP groups" scheme.
* **Q-group padding**: pad each kv group's q heads to a multiple of ``r`` so
  the padded-q -> expanded-kv mapping ``h -> h // (H'/KV')`` matches the
  original ``h -> h // G``. Pad heads have zero weights: zero q/k/v/o rows
  make them exact no-ops (outputs and gradients identically zero).
* **Vocab padding**: round the vocab to a multiple of 128; pad logits are
  masked to -1e30 in the loss (see ``lm.chunked_ce_loss``), so softmax is
  unchanged.

``pad_params`` converts real (unpadded) weights into padded weights for
correctness tests; the dry-run only needs the padded shapes.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs.base import ATTN, ModelConfig


def pad_for_tp(cfg: ModelConfig, tp: int) -> ModelConfig:
    if tp <= 1:
        return cfg
    over = {}
    has_attn = any(b == ATTN for b in cfg.blocks) or cfg.is_encoder_decoder
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if has_attn and (KV % tp != 0 or H % tp != 0) and KV < tp:
        r = tp // math.gcd(KV, tp)
        G = H // KV
        Gp = math.ceil(G / r) * r
        over["num_heads"] = KV * Gp
        over["num_kv_heads"] = KV * r
        over["head_dim"] = cfg.head_dim
    if cfg.vocab_size > 0 and cfg.vocab_size % tp != 0:
        over["vocab_size"] = math.ceil(cfg.vocab_size / 128) * 128
        over["true_vocab"] = cfg.vocab_size
    if not over:
        return cfg
    return dataclasses.replace(cfg, **over)


def _host(x) -> np.ndarray:
    """A leaf as numpy, bf16 through f32 (numpy has no bf16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def pad_params(params_small, cfg: ModelConfig, padded: ModelConfig):
    """Zero-pad real weights from ``cfg`` layout to ``padded`` layout.

    Only head/vocab dims change; q heads are padded *per kv group* and kv
    heads are replicated ``r`` times (values must be duplicated, not zeroed,
    so that expanded-cache attention matches). The padding is done in numpy;
    a torch leaf comes back a torch tensor of its dtype on its device."""
    G = cfg.num_heads // cfg.num_kv_heads
    r = padded.num_kv_heads // cfg.num_kv_heads

    def pad_q(arr, axis):
        shp = list(arr.shape)
        shp[axis] = padded.num_heads
        out = np.zeros(shp, arr.dtype)
        src = np.split(arr, cfg.num_kv_heads, axis=axis)
        dst = np.split(out, cfg.num_kv_heads, axis=axis)
        for s, d in zip(src, dst):
            sl = [slice(None)] * arr.ndim
            sl[axis] = slice(0, G)
            d[tuple(sl)] = s
        return np.concatenate(dst, axis=axis)

    def pad_np(keys, x):
        if "embed" in keys and x.ndim == 2 and x.shape[0] == cfg.vocab_size:
            out = np.zeros((padded.vocab_size, x.shape[1]), x.dtype)
            out[: cfg.vocab_size] = x
            return out
        if "head" in keys and x.ndim == 2 and x.shape[1] == cfg.vocab_size:
            out = np.zeros((x.shape[0], padded.vocab_size), x.dtype)
            out[:, : cfg.vocab_size] = x
            return out
        name = keys[-1] if keys else None
        # heads axis is always ndim-2: wq (..., d, H, hd), bq (..., H, hd)
        if name in ("wq", "bq") and x.shape[x.ndim - 2] == cfg.num_heads:
            return pad_q(x, x.ndim - 2)
        if name == "wo" and x.shape[x.ndim - 3] == cfg.num_heads:
            return pad_q(x, x.ndim - 3)
        if name in ("wk", "wv", "bk", "bv") and \
                x.shape[x.ndim - 2] == cfg.num_kv_heads:
            return np.repeat(x, r, axis=x.ndim - 2)
        return x

    def leaf(keys, x):
        out = pad_np(keys, _host(x))
        if isinstance(x, torch.Tensor):
            return torch.from_numpy(np.ascontiguousarray(out)).to(
                device=x.device, dtype=x.dtype)
        return out

    def walk(tree, keys):
        if isinstance(tree, dict):
            return {k: walk(v, keys + [k]) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, keys) for v in tree)
        if tree is None:
            return None
        return leaf(keys, tree)

    return walk(params_small, [])

"""Shared layers: RMSNorm, embeddings, RoPE (M-RoPE comes with the VLM slice)."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ParamSpec


# ---------------- norms ----------------

def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), init="ones")


def rmsnorm(w, x, eps: float = 1e-5):
    """Normalize in f32, scale by ``w`` in f32, return in ``x``'s dtype:
    the row-invariant kernel on the card, its plain version on the CPU
    (``kernels.ops.rmsnorm``)."""
    return ops.rmsnorm(w, x, eps)


# ---------------- embeddings ----------------

def embed_spec(vocab: int, d: int) -> ParamSpec:
    return ParamSpec((vocab, d), ("vocab", "embed"), scale=1.0)


def embed(tok_w, tokens):
    return tok_w[tokens]


def head_spec(d: int, vocab: int) -> ParamSpec:
    return ParamSpec((d, vocab), ("embed", "vocab"))


# ---------------- RoPE ----------------

def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, pos, theta: float = 10000.0):
    """x: (..., S, H, hd); pos: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)       # (hd/2,)
    angles = pos[..., None].float() * freqs              # (..., S, hd/2)
    angles = angles[..., None, :]                        # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)

"""Gated (SwiGLU) feed-forward."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models.common import NO_SHARD, ParamSpec


def mlp_spec(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi_gate": ParamSpec((d, f), ("embed", "mlp")),
        "wi_up": ParamSpec((d, f), ("embed", "mlp")),
        "wo": ParamSpec((f, d), ("mlp", "embed")),
    }


def mlp(p, x, shard=NO_SHARD):
    dt = x.dtype
    g = x @ p["wi_gate"].to(dt)
    u = x @ p["wi_up"].to(dt)
    h = shard(F.silu(g) * u, ("batch", None, "mlp"))
    return h @ p["wo"].to(dt)

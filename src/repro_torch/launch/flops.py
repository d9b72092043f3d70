"""Analytic MODEL_FLOPS per cell (the 6·N·D convention) for the useful-compute
ratio of the dry-run. N excludes the embedding table; MoE uses active params."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import lm
from repro_torch.models.common import param_count


def _counts(cfg: ModelConfig) -> tuple[int, int]:
    """(N_total, N_active) excluding the token-embedding table."""
    spec = lm.model_spec(cfg)
    n = param_count(spec)
    if "embed" in spec:
        n -= cfg.vocab_size * cfg.d_model
    n_active = n
    if cfg.uses_moe:
        moe_layers = sum(1 for i in range(cfg.num_layers) if cfg._layer_has_moe(i))
        per_expert = 3 * cfg.d_model * cfg.d_ff
        n_active = n - moe_layers * (cfg.num_experts - cfg.experts_per_token) * per_expert
    return n, n_active


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Global MODEL_FLOPS for one step of this cell."""
    _, n_active = _counts(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch

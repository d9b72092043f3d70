"""Assigned input-shape grid: 4 shapes × 10 archs = 40 cells.

``train_*`` traces ``train_step``; ``prefill_*`` traces ``prefill_step``;
``decode_*`` / ``long_*`` trace ``serve_step`` (one new token against a KV/state
cache of ``seq_len``). ``long_500k`` only applies to sub-quadratic archs.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

from repro_torch.configs.base import ModelConfig

Kind = Literal["train", "prefill", "decode"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: Kind
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) cell."""
    if shape.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only (representation) arch has no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch; 500k decode needs sub-quadratic attention"
    return True, ""


def grid(cfg: ModelConfig) -> list[tuple[ShapeSpec, bool, str]]:
    return [(s, *applicable(cfg, s)) for s in SHAPES.values()]

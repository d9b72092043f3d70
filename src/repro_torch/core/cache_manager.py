"""Per-sublayer cache plan: where each sublayer's serving state lives.

``CachePlan.for_config`` walks the period layout and declares, for every
sublayer, whether its state is paged, grows with decoded tokens, or carries
cross-attention sidecars. This slice ports the attention-only plan (the
dense int8 pool): recurrent and encoder-decoder stacks raise in
``models.blocks.period_layout``, and the capability flags the JAX engine
negotiates (prefix sharing, chunked prefill, speculation, spill) and the
fixed-size state-slot pool come with the slices that use them.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ATTN, MAMBA, MLSTM, SLSTM, ModelConfig

RECURRENT_KINDS = (MAMBA, MLSTM, SLSTM)


@dataclasses.dataclass(frozen=True)
class SublayerPlan:
    """Serving-state declaration for one sublayer of the period layout."""
    kind: str              # ATTN (other kinds come with later slices)
    paged: bool            # state lives in the shared int8 page arena
    grows: bool            # state grows with decoded tokens (attention KV)
    has_cross: bool        # per-slot encoder-output K/V rides beside it

    @property
    def fixed_state(self) -> bool:
        return self.kind in RECURRENT_KINDS or self.has_cross


@dataclasses.dataclass(frozen=True)
class CachePlan:
    """The whole stack's cache contract."""
    sublayers: tuple[SublayerPlan, ...]
    paged: bool                 # a page arena exists (>= 1 paged sublayer)

    @property
    def needs_state_slots(self) -> bool:
        return any(s.fixed_state for s in self.sublayers)

    @classmethod
    def for_config(cls, cfg: ModelConfig, paged: bool) -> "CachePlan":
        from repro_torch.models import blocks as blk
        layout = blk.period_layout(cfg)
        paged = bool(paged and any(lay.kind == ATTN for lay in layout))
        return cls(sublayers=tuple(
            SublayerPlan(kind=lay.kind, paged=paged, grows=lay.kind == ATTN,
                         has_cross=lay.has_cross) for lay in layout),
            paged=paged)

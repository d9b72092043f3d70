"""Per-sublayer cache plan: where each sublayer's serving state lives.

``CachePlan.for_config`` walks the period layout and declares, for every
sublayer, whether its state is paged, grows with decoded tokens, or carries
cross-attention sidecars, plus the capability flags the engine negotiates
against (as in the JAX package):

  * ``prefix_sharing_ok`` / ``chunked_prefill_ok``: shared pages capture
    attention KV only; a recurrent sublayer's state at the prefix boundary
    is stream-private, so sharing is for paged attention-only stacks;
  * ``speculative_ok``: draft rollback is a length/tracker reset on paged
    attention state, which recurrent state cannot do;
  * ``spill_resume_ok``: the stream spill captures pages and quantization
    trackers only.

This slice ports attention-only stacks (dense and paged int8 pools):
recurrent and encoder-decoder stacks raise in
``models.blocks.period_layout``, and the fixed-size state-slot pool comes
with the slice that serves them.
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
    """The whole stack's cache contract + negotiated capability flags."""
    sublayers: tuple[SublayerPlan, ...]
    paged: bool                 # a page arena exists (>= 1 paged sublayer)
    has_attention: bool
    has_recurrent: bool
    has_encoder: bool
    prefix_sharing_ok: bool
    chunked_prefill_ok: bool
    speculative_ok: bool
    spill_resume_ok: bool

    @property
    def needs_state_slots(self) -> bool:
        return any(s.fixed_state for s in self.sublayers)

    @classmethod
    def for_config(cls, cfg: ModelConfig, paged: bool) -> "CachePlan":
        from repro_torch.models import blocks as blk
        layout = blk.period_layout(cfg)
        has_attn = any(lay.kind == ATTN for lay in layout)
        has_rec = any(lay.kind in RECURRENT_KINDS for lay in layout)
        has_enc = cfg.is_encoder_decoder
        # a page arena only makes sense with attention KV to page
        paged = bool(paged and has_attn)
        subs = tuple(SublayerPlan(
            kind=lay.kind, paged=paged and lay.kind == ATTN,
            grows=lay.kind == ATTN, has_cross=lay.has_cross)
            for lay in layout)
        attn_only = not has_rec and not has_enc
        return cls(
            sublayers=subs, paged=paged, has_attention=has_attn,
            has_recurrent=has_rec, has_encoder=has_enc,
            prefix_sharing_ok=paged and attn_only,
            chunked_prefill_ok=paged and attn_only,
            speculative_ok=paged and attn_only,
            spill_resume_ok=paged and attn_only)

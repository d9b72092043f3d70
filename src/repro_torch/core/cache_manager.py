"""Per-sublayer cache plan and the fixed-size state-slot pool.

``CachePlan.for_config`` walks the period layout and declares, for every
sublayer, whether its state is paged, grows with decoded tokens, or carries
cross-attention sidecars, plus the capability flags the engine negotiates
against (as in the JAX package):

  * ``prefix_sharing_ok`` / ``chunked_prefill_ok``: shared pages capture
    attention KV only; a recurrent sublayer's state at the prefix boundary
    and a stream's encoder K/V are stream-private, so sharing is for paged
    attention-only stacks (on an encoder-decoder stack it demotes);
  * ``speculative_ok``: draft rollback is a length/tracker reset on paged
    attention state, which recurrent state cannot do, and the verify
    forward has no encoder-decoder mode;
  * ``spill_resume_ok``: the stream spill captures pages and quantization
    trackers only.

``StateSlotPool`` is the lifecycle of the fixed-size per-slot state (the
cross-attention K/V of an encoder-decoder stack; the state of every
recurrent sublayer: Mamba's conv window and SSM state, the mLSTM and sLSTM
cells): one state slot per live stream, allocated at admission and freed
on every exit path, strictly, with occupancy gauges. The tensors live in
the engine's pool (its batch axis is the slot).
``capture_dense_state``/``restore_dense_state`` carry the per-slot state
through an engine snapshot (``core.spill.EngineSnapshot``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ATTN, MAMBA, MLSTM, SLSTM, ModelConfig

RECURRENT_KINDS = (MAMBA, MLSTM, SLSTM)


@dataclasses.dataclass(frozen=True)
class SublayerPlan:
    """Serving-state declaration for one sublayer of the period layout."""
    kind: str              # ATTN, MAMBA, MLSTM or SLSTM
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
        layout = blk.period_layout(cfg, cross=cfg.is_encoder_decoder)
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


class StateSlotPool:
    """Lifecycle and gauges of the fixed-size per-slot serving state.

    One state slot per live stream, 1:1 with the engine's decode slots (the
    state tensors' batch axis). ``alloc`` and ``free`` are strict: a double
    allocation or a double free is an engine lifecycle bug and raises.
    ``note_deferral`` counts admissions refused on state-slot pressure."""

    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self._in_use = np.zeros((num_slots,), bool)
        self.peak_in_use = 0
        self.slot_deferrals = 0
        self.allocs = 0
        self.frees = 0

    def alloc(self, slot: int):
        if self._in_use[slot]:
            raise RuntimeError(f"state slot {slot} double-allocated")
        self._in_use[slot] = True
        self.allocs += 1
        self.peak_in_use = max(self.peak_in_use, self.in_use_count())

    def free(self, slot: int):
        if not self._in_use[slot]:
            raise RuntimeError(f"state slot {slot} double-freed")
        self._in_use[slot] = False
        self.frees += 1

    def note_deferral(self):
        self.slot_deferrals += 1

    def in_use(self, slot: int) -> bool:
        return bool(self._in_use[slot])

    def in_use_count(self) -> int:
        return int(self._in_use.sum())

    def available(self) -> int:
        return self.num_slots - self.in_use_count()

    def slots_in_use(self) -> set[int]:
        return {int(i) for i in np.nonzero(self._in_use)[0]}

    def gauges(self) -> dict:
        return {
            "state_slots_total": self.num_slots,
            "state_slots_in_use": self.in_use_count(),
            "state_slots_peak": self.peak_in_use,
            "state_slot_deferrals": self.slot_deferrals,
        }


def dense_state_keys(sub) -> list[str]:
    """Per-slot dense state keys of one pool sub: every key of a recurrent
    sub, the ``ck``/``cv`` sidecars of a cross-attention sub (beside a
    dense or paged attention cache), nothing for an attention cache's own
    K/V (the paged arena's pages and trackers are captured separately)."""
    if "k" in sub:
        return [k for k in ("ck", "cv") if k in sub]
    return sorted(sub)


def capture_dense_state(pool) -> list:
    """Host copies of the fixed-size per-slot state, one entry per pool sub
    (None when the sub has none): the snapshot's counterpart of the
    used-page capture. float32 numpy arrays (bf16 widens exactly; numpy has
    no bfloat16), always copies: the live engine runs on."""
    out = []
    for sub in pool:
        keys = dense_state_keys(sub)
        out.append({k: sub[k].to("cpu", torch.float32, copy=True).numpy()
                    for k in keys} if keys else None)
    return out


def restore_dense_state(pool, state) -> list:
    """Write a ``capture_dense_state`` payload back into ``pool`` IN PLACE
    (``copy_``, casting to each tensor's dtype): captured executables read
    these tensors where they lie. Returns ``pool``."""
    if state is None:
        return pool
    for sub, st in zip(pool, state):
        for k, v in (st or {}).items():
            sub[k].copy_(torch.from_numpy(np.asarray(v)))
    return pool

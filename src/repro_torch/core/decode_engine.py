"""Continuous-batching decode engine over a persistent int8 KV pool —
dense slot-contiguous or block-paged.

Autoregressive serving is where FMplex's co-location wins compound: every
decode step re-uses the shared backbone across all co-resident tasks, so the
per-step cost of multi-task isolation must be ~zero. The engine owns:

  * a **slot pool** — a fixed, bucketed number of decode slots backed by one
    persistent KV cache allocated ONCE. Two layouts:

      - *dense* (``paged=False``): one contiguous ``(num_slots, s_max)`` int8
        region per slot with per-(slot, kv-head) scales fixed at prefill
        admission, read through the int8 flash-decode kernel
        (``kernels.ops.decode_attention_int8``). Every stream reserves its
        worst-case length, so the slot count caps colocation.
      - *paged* (``paged=True``): one arena of ``total_pages`` pages of
        ``page_size`` int8 positions with per-(page, kv-head) scales, shared
        by every slot through a per-slot page table and read through the
        paged flash-decode kernel (``kernels.ops.paged_decode_attention``),
        which gathers pages through the table. Page 0 is the trash page:
        free slots keep stepping (static shapes) and their writes land
        there, never in a live stream's pages.

  * **the page lifecycle** (paged) — refcounted ownership with copy-on-write
    prefix sharing, as in the JAX package. A page is on the free list
    exactly when its refcount is 0. ``_take_pages`` pops from the free list
    (refcount 1); a joining stream whose prompt starts with a prefix another
    stream already admitted MAPS those pages (``_share_pages``, refcount
    +1) — the prefix registry holds one chained sha256 digest per full
    prompt page, seeded with the adapter identity — and ``_release_pages``
    (retire, preempt, bucket trim) decrements, freeing at 0 and dropping the
    page's registry entry. Only pages wholly covered by prompt tokens are
    registered and decode writes land at or past a stream's prompt length,
    so shared pages are immutable and the read path needs no change.
    Admission quantizes the prompt's K/V per (page, kv-head), so a shared
    page's codes equal what the joining stream's own prefill would have
    written: sharing is exact. The prompt/decode boundary page is stamped at
    the slot-wide admission scale; decode appends quantize into the slot's
    running scale for the first token of a fresh page (stamping it) and into
    the page's stamped scale after that, so a recycled page's stale scale
    never leaks into a new owner.
  * **chunked shared-prefix admission** (paged, ``chunked_prefill=True``,
    the default) — a prefix hit saves compute as well as memory: an
    admission whose prompt maps >= 1 registered page prefills ONLY its
    private tail. The *map phase* increments the shared pages' refcounts;
    the *tail-compute phase* runs the tail through ``_tail_prefill_fn``
    with the mapped prefix's K/V in front of the tail's own keys in every
    attention sublayer (absolute RoPE positions, causality and pad masking
    offset by the prefix length; the prefill kernel K2 walks the prefix as
    a second key segment). The prefix arrives either from the pages' FLOAT
    sidecars (``_page_float``: the pre-quantization K/V a full prefill
    computed, copied to the host once per admission — the tail then sees
    the values a full prefill would have seen) or, when a sidecar is gone,
    gathered from the int8 arena and dequantized per page
    (``kernels.ops.gather_prefix_kv``). Tail lengths bucket separately
    (powers of two of the page size), so sharer churn adds no shape key.
    The tail-page scatter quantizes like the full path and folds the mapped
    pages' scales into the slot-wide scale, the value a full prefill over
    the whole prompt computes. A quarantined tail rolls the map phase back.
    The full prefill remains the fallback when nothing is shareable or the
    free pages cannot cover the tail bucket. ``tail_tokens_computed``/
    ``prefill_tokens_saved`` count the split and ``admitted_log`` carries
    each admission's tail tokens, which the serve loop charges.
  * **memory-aware admission, deferral and preemption** (paged) — a join
    admits when a slot is free and free pages cover its prompt bucket (less
    the pages its prefix would map) plus a chunk of decode headroom for it
    and every live stream; otherwise it DEFERS into a pending queue that
    drains FIFO with a bounded lookahead (``pending_lookahead``; a small
    prompt may pass a blocked head only ``hol_skip_cap`` times in a row).
    Before each chunk every live stream is topped up to ``len + chunk``
    tokens of pages; when the free list runs dry the youngest live stream is
    PREEMPTED: its pages are released and it re-queues at the front with its
    generated tokens folded into the prompt. A deferred join that only fit
    thanks to a prefix discount whose sharer has since retired is STRANDED:
    it stays queued without blocking others, and only an engine with
    nothing live and nothing viable raises (``EngineWedged``).
  * **proactive scale refresh** (paged) — the decode step tracks each slot's
    decode-era |K|/|V| maxima (``k_max``/``v_max``); when one exceeds
    ``scale_refresh`` x the slot's admission range (a flag computed with the
    chunk and returned in its one host sync), the slot's private tail page
    is re-quantized in place into a wider scale.
  * **variable-length bucketed admission** — a prompt is right-padded to the
    smallest prompt-length bucket holding it (the bucket is a static shape
    key; the true length masks pads out of attention and the cache),
    producing the first token.
  * **chunked decode** — ``step_chunk`` advances every slot ``chunk`` steps
    (free slots step too, on garbage; their adapter id is the "no adapter"
    sentinel), with the q/v LoRA deltas of the co-batched tasks through the
    segmented (SGMV) kernel. The segment metadata is built once per slot
    *composition* and reused by every step and every layer.
  * **static shapes** — prefill is keyed on (adapter cap, prompt bucket),
    decode on (slots, adapter cap, chunk), the paged admission scatter on
    its page count: ``compile_count`` counts the executables, and
    steady-state churn, page allocation, deferral and preemption must not
    add any. Page ids, tables, lengths and slots are data, never keys:
    device tensors, staged into each executable's static buffers.
  * **captured executables** — every plane function is a
    ``core.graphs.Executable``: eager at its first call, captured as one
    CUDA graph at its second and replayed after, with the weights, the pool
    and the adapter stack baked in place (so the device page table is one
    persistent tensor, rewritten in place) and everything else staged.
    Sampling keys (``temperature > 0``) stay eager: they draw from per-slot
    generators.
  * **encoder-decoder stacks** (whisper) — a join carries the stream's
    encoder frames (``enc_feats``: exactly ``enc_len`` frames, zeros when
    omitted); the admission prefill encodes them and every decoder layer's
    cross-attention K/V land in the slot's ``ck``/``cv`` state, written
    once and read by every decode step (K5). That state is fixed-size per
    slot beside either pool, tracked by a ``StateSlotPool`` (allocated at
    admission, freed on retire, cancel, quarantine, deadline and
    preemption); prefix sharing and chunked prefill demote on such stacks
    (a stream's cross state is private), and a preempted stream re-prefills
    its folded prompt against its stored frames.
  * **failure semantics** — per-stream non-finite logits quarantine only
    that stream; deadlines cancel live streams at chunk entry (with the
    chunk clamped to a small ladder when a deadline is nearer than a full
    chunk) and shed expired pending entries; ``cancel`` unwinds a stream by
    rid wherever it lives.
  * **durability plane** (paged, ``spill_bytes > 0``; ``core.spill``) —
    losing device state may cost time, never tokens:

      - *spill on eviction*: a preemption victim's pages, page scales,
        slot scales, drift trackers, last token and generator state are
        copied to the host arena before its pages are released; a
        registered prefix page whose LAST sharer releases it spills the
        same way (with its float sidecar), keyed by its chained digest. An
        entry over the budget is skipped: losing the tier costs a
        re-prefill only.
      - *restore on re-entry*: a resume whose entry survived restores into
        fresh pages (``spill_resumes``, ``resume_costs``), no re-prefill;
        a join whose prompt chain continues into the arena restores those
        prefix pages and registers them again (``spill_prefix_hits``), on
        the full path and on the chunked tail path. The pending gate
        prices a spill-backed resume at its true page count.
      - *snapshot/restore*: ``snapshot()`` captures the whole logical state
        between chunks with one sha256 digest per used page;
        ``restore()`` rebuilds an engine from it. With
        ``reuse_jits_from`` it adopts the old engine's executables AND the
        tensors they bake (the pool, the device page table, the token
        buffer) and rewrites every element in place from the snapshot, so
        no graph is captured again and no second pool is allocated.

    The gather, page write-back and slot write-back are one executable
    each, at the fixed width ``pages_per_slot`` padded with the trash page.
    A page or entry whose digest does not match is never served: it counts
    in ``digest_failures`` and its streams recompute from their host-side
    tokens.

  * **self-speculative decoding** (paged, ``spec_k > 0``) — each step of
    a speculative chunk drafts up to ``spec_k`` tokens per slot from the
    slot's own history (the latest earlier occurrence of its current
    bigram: prompt lookup, no draft model), scores the ``spec_k + 1``
    window positions in ONE ``lm.verify_step`` forward through the paged
    pool (the verify-window kernel walks each stream's pages once for all
    positions), accepts the longest draft prefix the backbone itself emits
    and commits it plus one corrected token. Rollback is a length and
    tracker reset (``len``, ``k_max``/``v_max`` from the per-position
    running-max stacks): the rejected positions' codes sit past the
    committed length in decode-private pages and are overwritten later, so
    no page is freed. An exponential moving average of the committed tokens
    per slot-step demotes to plain dispatches below ``spec_disable_below``
    and re-probes with single-step speculative chunks whose interval backs
    off while they accept nothing. The plain planes see the page table at
    the width of a ``spec_k = 0`` engine: the device table is one storage
    whose first block is the plain-width table every plain executable
    bakes, followed by the headroom columns the speculative chunk joins
    back on. Each step's draft sentinel (one past the vocabulary) is
    clamped before the embedding gather.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import time
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.core import graphs
from repro_torch.core.cache_manager import (CachePlan, StateSlotPool,
                                            capture_dense_state,
                                            dense_state_keys,
                                            restore_dense_state)
from repro_torch.core.physical import PAD_SENTINEL, PhysicalFM, bucket_for, seg_to_device
from repro_torch.core.spill import (PAGE_KEYS, SLOT_KEYS, EngineSnapshot,
                                    HostSpillArena)
from repro_torch.models import lm

FREE = PAD_SENTINEL   # free-slot adapter sentinel (same as run_batch padding)
TRASH_PAGE = 0        # arena page absorbing free-slot garbage writes


class EngineWedged(ValueError):
    """A paged engine holds deferred joins that can never be admitted
    (stranded: the shared prefix they were admitted against was released)
    and nothing live or viable is left to change that. A ``ValueError`` as
    in the JAX package; the serve loop catches this class only, so any
    other error (a kernel's precondition, a device fault) propagates."""


def default_prompt_buckets(prompt_len: int) -> tuple[int, ...]:
    """2-3 admission buckets: quarter, half and full ``prompt_len``."""
    return tuple(sorted({max(1, prompt_len // 4),
                         max(1, prompt_len // 2), prompt_len}))


def make_sampler(temperature: float, top_k: int):
    """Token sampler: ``sample(logits (B, V), gens) -> (tokens (B,) int32,
    gens)`` where ``gens`` holds one ``torch.Generator`` per row, so
    co-batched streams sample independently. Greedy when ``temperature <=
    0`` (generators untouched); otherwise temperature-scaled categorical
    over the top-k logits."""
    if temperature <= 0:
        def sample(logits, gens):
            return torch.argmax(logits, dim=-1).to(torch.int32), gens
        return sample

    def sample(logits, gens):
        l = logits.float() / temperature
        if top_k > 0:
            kth = torch.topk(l, top_k, dim=-1).values[:, -1]
            l = torch.where(l >= kth[:, None], l, torch.full_like(l, -1e30))
        probs = torch.softmax(l, dim=-1)
        toks = [torch.multinomial(probs[i], 1, generator=gens[i])
                for i in range(probs.shape[0])]
        return torch.cat(toks).to(torch.int32), gens
    return sample


@dataclasses.dataclass
class DecodeSlot:
    """One occupied decode stream."""
    rid: int
    task_id: str
    adapter_slot: int
    max_new: int
    eos_id: Optional[int]
    tokens: list          # generated token ids (first one from prefill)
    t_join: float
    t_first: float        # wall time of the first generated token (TTFT end)
    prompt_tokens: int = 0   # TRUE (post-truncation) admitted prompt length
    done: bool = False
    prompt: Optional[np.ndarray] = None
    adapter_id: Optional[str] = None
    deadline: float = float("inf")        # wall-clock cancel point (inf: none)
    status: str = "ok"                    # terminal status (core.request)
    enc_feats: Optional[np.ndarray] = None   # enc-dec: encoder input frames


@dataclasses.dataclass
class _PendingJoin:
    """An admission request; on a paged pool it may wait in the FIFO
    pending queue (deferred, or a preempted stream to resume)."""
    task_id: str
    prompt: np.ndarray
    adapter_id: Optional[str]
    max_new_tokens: int
    rid: int
    eos_id: Optional[int]
    resume: Optional[DecodeSlot] = None   # preempted stream being re-admitted
    deadline: float = float("inf")
    status: str = "ok"                    # stamped when rejected terminally
    enc_feats: Optional[np.ndarray] = None   # enc-dec: encoder input frames


class DecodeEngine:
    """Slot-based continuous-batching token server bound to one PhysicalFM."""

    def __init__(self, fm: PhysicalFM, *, num_slots: int = 8,
                 prompt_len: Optional[int] = None, max_new: int = 32,
                 chunk: int = 4, kv_quant: bool = True,
                 eos_id: Optional[int] = None,
                 prompt_buckets: Optional[tuple] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 sample_seed: int = 0, paged: bool = False,
                 page_size: int = 16, total_pages: Optional[int] = None,
                 prefix_sharing: bool = True, scale_refresh: float = 2.0,
                 pending_lookahead: int = 4, hol_skip_cap: int = 4,
                 spill_bytes: int = 0,
                 spill_arena: Optional[HostSpillArena] = None,
                 deadline_clamp: bool = True,
                 chunked_prefill: bool = True,
                 spec_k: int = 0, spec_force_fill: bool = False,
                 spec_disable_below: float = 1.25,
                 spec_probe_every: int = 16,
                 enc_len: Optional[int] = None,
                 _adopt: Optional["DecodeEngine"] = None):
        """``_adopt`` (``restore`` only): a dead engine of the same
        configuration on the same FM whose pool, device page table and
        token buffer this engine takes over instead of allocating its own
        (its executables bake them)."""
        cfg = fm.cfg
        if cfg.vocab_size <= 0 or cfg.is_representation:
            raise ValueError("DecodeEngine serves generative decoder LMs "
                             "(vocab head required)")
        # per-sublayer cache plan: which sublayers page into the int8 arena,
        # which carry fixed-size per-slot state (the cross-attention K/V of
        # an encoder-decoder stack), and which serving planes the stack
        # supports; unsupported planes demote instead of failing mid-serve
        self.plan = CachePlan.for_config(cfg, paged)
        paged = self.plan.paged
        if paged and not kv_quant:
            raise ValueError("the paged arena is int8-only (kv_quant=True)")
        self.fm = fm
        self.cfg = cfg
        self.device = fm.device
        self.num_slots = bucket_for(num_slots)
        self.prompt_len = prompt_len or fm.input_len
        # enc-dec: the per-slot cross K/V is fixed-size state of enc_len
        # frames per slot, written at admission
        self.enc_len = int(enc_len) if enc_len is not None else \
            (self.prompt_len if cfg.is_encoder_decoder else 0)
        if prompt_buckets is None:
            prompt_buckets = default_prompt_buckets(self.prompt_len)
        self.prompt_buckets = tuple(sorted(set(int(b) for b in prompt_buckets)))
        self.prompt_len = self.prompt_buckets[-1]   # largest bucket is the cap
        self.max_new = max_new
        self.chunk = chunk
        self.kv_quant = kv_quant
        self.eos_id = eos_id
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self._sample = make_sampler(self.temperature, self.top_k)
        # one generator per slot, advanced in place by the sampler
        self._keys = [torch.Generator(device=self.device).manual_seed(
            sample_seed * 1_000_003 + i) for i in range(self.num_slots)]
        self.s_max = self.prompt_len + max_new + 1
        self.spec_k = int(spec_k)
        if self.spec_k > 0 and not self.plan.speculative_ok and \
                (self.plan.has_recurrent or self.plan.has_encoder):
            warnings.warn(
                "spec_k > 0 demoted to plain decode: speculative rollback is "
                "a length/tracker reset on paged attention KV only, and the "
                "verify forward has no encoder-decoder mode", RuntimeWarning,
                stacklevel=2)
            self.spec_k = 0
        if self.spec_k > 0 and not paged:
            raise ValueError("speculative decoding (spec_k > 0) requires "
                             "paged=True: its rollback relies on "
                             "decode-private pages past the committed length")
        # a speculative chunk can run the device length up to one chunk of
        # (k + 1)-token steps past a slot's nominal maximum before the host
        # truncates, so the table (and the arena sized from it) covers it
        spec_room = self.chunk * (self.spec_k + 1) if self.spec_k > 0 else 0
        self.paged = paged
        if paged:
            self.page_size = page_size
            self.pages_per_slot = -(-(self.s_max + spec_room) // page_size)
            # the width every plain plane's table has: a spec_k = 0 engine's
            self._plain_pages = -(-self.s_max // page_size)
            if total_pages is None:        # dense-equivalent memory + trash
                total_pages = 1 + self.num_slots * self.pages_per_slot
            if total_pages < 2:
                raise ValueError("need at least one usable page")
            self.total_pages = total_pages
            # host allocator state; the device page table is synced from
            # _ptab before any decode dispatch that follows a change
            self._free_pages = list(range(total_pages - 1, TRASH_PAGE, -1))
            self._ptab = np.zeros((self.num_slots, self.pages_per_slot),
                                  np.int32)
            if _adopt is not None:
                self.pool = _adopt.pool
                self._ptab_store, self._ptab_dev, self._ptab_spec = \
                    _adopt._ptab_store, _adopt._ptab_dev, _adopt._ptab_spec
            else:
                self.pool = lm.init_cache(cfg, self.num_slots,
                                          self.s_max + spec_room,
                                          kv_quant=True, paged=True,
                                          page_size=page_size,
                                          num_pages=total_pages,
                                          enc_len=self.enc_len or None,
                                          device=self.device)
                # the one device page table, rewritten in place by every
                # sync: one storage holding the plain-width table (every
                # attention sublayer's leaf is a broadcast view of it, so
                # every plain plane computes what a spec_k = 0 engine
                # computes) and behind it the speculative headroom columns
                n, w = self.num_slots, self._plain_pages
                self._ptab_store = torch.zeros(
                    (n * self.pages_per_slot,), dtype=torch.int32,
                    device=self.device)
                self._ptab_dev = self._ptab_store[:n * w].view(n, w)
                self._ptab_spec = self._ptab_store[n * w:].view(
                    n, self.pages_per_slot - w)
                for sub in self.pool:
                    if "page_table" in sub:
                        sub["page_table"] = self._ptab_dev.expand(
                            sub["page_table"].shape[0], -1, -1)
            self._held = np.zeros((self.num_slots,), np.int64)
            self._lens = np.zeros((self.num_slots,), np.int64)
            self._ptab_dirty = True
            self.deferrals = 0
            self.preemptions = 0
            # refcounted ownership + COW prefix sharing (module docstring);
            # demoted on stacks with stream-private state (plan)
            self.prefix_sharing = bool(prefix_sharing) and \
                self.plan.prefix_sharing_ok
            self._page_refs = np.zeros((total_pages,), np.int32)
            self._prefix_registry: dict[bytes, int] = {}   # key -> page id
            self._page_key: dict[int, bytes] = {}          # page id -> key
            self.prefix_hits = 0            # joins that mapped >= 1 page
            self.shared_pages_mapped = 0    # cumulative pages mapped, not copied
            # chunked shared-prefix prefill (module docstring): registered
            # prefix pages keep a host-side FLOAT sidecar (the bf16 prefill
            # K/V the page was quantized from); a page whose sidecar is gone
            # is attended dequantized from its int8 codes instead
            self.chunked_prefill = bool(chunked_prefill) and \
                self.prefix_sharing
            self._page_float: dict[int, list] = {}   # page id -> float K/V
            # assembled float-prefix operands per mapped page-id tuple:
            # sharers of one prefix reuse one host assembly and upload;
            # entries die with any constituent page (_release_pages)
            self._prefix_fp_cache: dict[tuple, list] = {}
            self._prefix_width = self._pages_for(self.prompt_len)
            tb = {min(page_size, self.prompt_len)}
            b = page_size
            while b < self.prompt_len:
                b *= 2
                tb.add(min(b, self.prompt_len))
            self.tail_buckets = tuple(sorted(tb))
            self.scale_refresh = float(scale_refresh)
            self.scale_refreshes = 0
            # bounded pending-queue lookahead (head-of-line fix)
            self.pending_lookahead = max(1, int(pending_lookahead))
            self.hol_skip_cap = max(1, int(hol_skip_cap))
            self._hol_skips = 0
            self.hol_bypasses = 0
            # host-RAM spill tier (module docstring, durability plane)
            self.spill = spill_arena if spill_arena is not None else (
                HostSpillArena(spill_bytes) if spill_bytes > 0 else None)
            if self.spill is not None and not self.plan.spill_resume_ok:
                warnings.warn(
                    "spill tier demoted: the stream spill captures pages and "
                    "quantization trackers only, not per-slot dense state "
                    "(the encoder's cross K/V): preemption falls back to the "
                    "lossless fold-and-re-prefill path", RuntimeWarning,
                    stacklevel=2)
                self.spill = None
        else:
            self.spill = None
            self.chunked_prefill = False    # needs the paged arena
            # the persistent pool: allocated once, updated in place
            self.pool = lm.init_cache(cfg, self.num_slots, self.s_max,
                                      kv_quant=kv_quant,
                                      enc_len=self.enc_len or None,
                                      device=self.device)
        # fixed-size per-slot state lifecycle (module docstring): one state
        # slot per live stream, allocated at admission, freed on every exit
        # path; the tensors themselves are the pool's ck/cv rows
        self.state_pool = StateSlotPool(self.num_slots) \
            if self.plan.needs_state_slots else None
        self.pending: collections.deque = collections.deque()
        self._tokens = _adopt._tokens if _adopt is not None else torch.zeros(
            (self.num_slots,), dtype=torch.int32, device=self.device)
        self.slots: list[Optional[DecodeSlot]] = [None] * self.num_slots
        self._slot_adapters = np.full((self.num_slots,), FREE, np.int32)
        # shape key -> graphs.Executable
        self._fn_prefill: dict[tuple, graphs.Executable] = {}
        self._fn_decode: dict[tuple, graphs.Executable] = {}
        self._fn_write: dict = {}      # dense: {None: fn}; paged: {npages: fn}
        self._fn_rescale: Optional[graphs.Executable] = None
        self._fn_gather: Optional[graphs.Executable] = None
        self._fn_page_restore: Optional[graphs.Executable] = None
        self._fn_slot_restore: Optional[graphs.Executable] = None
        self._seg_key = None        # composition signature of cached metadata
        self._seg_dev = None        # device-uploaded (perm, inv, blocks)
        self.steps = 0              # decode steps executed (all slots)
        self.last_chunk_s = 0.0
        self.rejected: list[_PendingJoin] = []   # terminally rejected joins
        # (rid, task, true_prompt_len, tail_tokens): tail_tokens is what the
        # prefill ACTUALLY computed — schedulers charge it, not true_len
        self.admitted_log: list[tuple[int, str, int, int]] = []
        self.admissions = 0
        self.tail_tokens_computed = 0   # prompt tokens actually prefilled
        self.prefill_tokens_saved = 0   # prompt tokens skipped (prefix mapped)
        self.quarantines = 0
        self.deadline_cancels = 0    # mid-flight (slot/resume) expirations
        self.deadline_sheds = 0      # pending entries expired unadmitted
        self.stranded_rejections = 0  # stranded entries terminally rejected
        self.cancels = 0
        # durability plane (spill tier, snapshot/restore)
        self.spilled_pages = 0       # pages copied to the host arena
        self.restored_pages = 0      # pages written back from the arena
        self.digest_failures = 0     # corrupted spill/snapshot pages caught
        self.spill_resumes = 0       # preempted streams resumed, no prefill
        self.spill_prefix_hits = 0   # joins that restored spilled prefix pages
        self.resume_costs: list[tuple[str, float]] = []  # (kind, seconds)
        self.deadline_clamp = bool(deadline_clamp)
        self._step_ema = 0.0
        self.deadline_clamps = 0
        self._decode_charges: collections.Counter = collections.Counter()
        # self-speculative decode plane (module docstring); spec_k parses
        # above, before the arena sizing it feeds
        self.spec_force_fill = bool(spec_force_fill)
        self.spec_disable_below = float(spec_disable_below)
        self.spec_probe_every = max(1, int(spec_probe_every))
        # the drafter's history: prompt + generated tokens never exceed
        # s_max, plus one dispatch's in-flight growth; one trash column
        # behind it takes the uncommitted positions' writes
        self._spec_hist_len = self.s_max + self.chunk * (self.spec_k + 1)
        self._spec_seg_key = None    # composition signature (spec metadata)
        self._spec_seg_dev = None
        self._spec_accept_ema = 0.0  # committed tokens per slot-step (EMA)
        self._spec_cool = 0          # plain dispatches since the last probe
        # re-probe interval: doubles after a dry probe, up to 16x the base
        self._spec_probe_interval = self.spec_probe_every
        self._spec_probe = False     # the current spec dispatch is a probe
        self._spec_task_stats: dict = {}   # task -> [proposed, accepted]
        self.draft_proposed = 0      # draft tokens sent to verification
        self.draft_accepted = 0      # draft tokens committed
        self.spec_dispatches = 0     # chunk dispatches through the spec fn
        self.spec_commits = 0        # tokens committed by spec dispatches
        self.spec_fallbacks = 0      # dispatches demoted to the plain fn

    # ---- occupancy ----
    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s is None]

    def active_count(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def pending_count(self) -> int:
        return len(self.pending)

    def pending_rids(self) -> list[int]:
        return [p.rid for p in self.pending]

    def pending_task_ids(self) -> list[str]:
        return [p.task_id for p in self.pending]

    def compile_count(self) -> int:
        """Executables of prefill (full and tail), decode (plain and
        speculative), pool writes, the scale refresh and the spill tier's
        gather and write-backs, one per shape key (each captured as a CUDA
        graph at its second call); steady state across join/leave churn,
        sharer joins of any tail length, page allocation, deferral,
        preemption, scale refresh, accept-rate swings and adapter churn
        within capacity must not grow this."""
        return (len(self._fn_prefill) + len(self._fn_decode)
                + len(self._fn_write)
                + sum(f is not None for f in (
                    self._fn_rescale, self._fn_gather, self._fn_page_restore,
                    self._fn_slot_restore)))

    # ---- page accounting (paged layout) ----
    def free_page_count(self) -> int:
        return len(self._free_pages) if self.paged else 0

    def used_page_count(self) -> int:
        if not self.paged:
            return 0
        return (self.total_pages - 1) - len(self._free_pages)

    def page_occupancy(self) -> float:
        """Fraction of usable (non-trash) pages held by streams."""
        if not self.paged:
            return 0.0
        return self.used_page_count() / max(self.total_pages - 1, 1)

    def _pages_for(self, tokens: int) -> int:
        return -(-max(tokens, 1) // self.page_size)

    def _headroom_tokens(self) -> int:
        """Decode headroom the allocator provisions per live stream per
        chunk: ``chunk`` tokens, or ``chunk * (spec_k + 1)`` on a
        speculative engine (each step may commit up to ``k + 1``). Static
        on ``spec_k``, never on the adaptive spec/plain state: the mode can
        flip between chunks and the provisioning must hold either way."""
        return self.chunk * (self.spec_k + 1 if self.spec_k > 0 else 1)

    def shared_page_count(self) -> int:
        """Physical pages currently mapped by more than one stream."""
        return int((self._page_refs > 1).sum()) if self.paged else 0

    def dedup_saved_pages(self) -> int:
        """Pages prefix sharing is saving right now: logical mappings minus
        physical pages (sum of max(refcount - 1, 0))."""
        if not self.paged:
            return 0
        return int(np.maximum(self._page_refs - 1, 0).sum())

    def logical_page_count(self) -> int:
        """Total page-table mappings across live slots — what the streams
        would hold physically without prefix sharing."""
        return int(self._held.sum()) if self.paged else 0

    def _imminent_page_need(self) -> int:
        """Pages the LIVE streams will allocate for their next chunk — the
        watermark an admission must clear on top of its own need."""
        need = 0
        for i, s in enumerate(self.slots):
            if s is not None and not s.done:
                need += max(0, self._pages_for(self._lens[i]
                                               + self._headroom_tokens())
                            - self._held[i])
        return need

    def _admission_need(self, prompt_tokens: int, prompt=None,
                        adapter_id: Optional[str] = None) -> int:
        """Free pages an admission must find: the prompt bucket's pages
        minus the pages its prefix would share (known only when the prompt
        is given), plus a chunk of decode headroom for the new stream and
        for every live one."""
        plen = self.bucket_for_prompt(min(max(prompt_tokens, 1),
                                          self.prompt_len))
        shared = len(self._match_prefix(adapter_id, prompt)) \
            if prompt is not None else 0
        return (self._pages_for(self._adm_s_max(plen)) - shared
                + self._pages_for(self._headroom_tokens())
                + self._imminent_page_need())

    def can_admit(self, prompt_tokens: Optional[int] = None, *,
                  prompt=None, adapter_id: Optional[str] = None) -> bool:
        """Would an admission of a ``prompt_tokens``-token prompt proceed
        right now? Dense: a free slot. Paged: a free slot, nothing already
        deferred ahead of it (FIFO), and free pages covering the prompt's
        bucket plus a chunk of decode headroom for it AND every live stream
        — the memory-aware gate ``ServeLoop`` consults before a prefill.
        The paged gate requires the prompt length (or the prompt, which
        also lets it discount the pages a shared prefix would map;
        ``adapter_id`` keys that registry lookup)."""
        if prompt is not None:
            prompt = np.asarray(prompt, np.int32).reshape(-1)
            if prompt_tokens is None:
                prompt_tokens = len(prompt)
        if self.paged and prompt_tokens is None:
            raise TypeError(
                "can_admit on a paged pool requires prompt_tokens (or "
                "prompt=): the memory gate cannot size an admission from "
                "a default 1-token estimate")
        if not self.free_slots():
            return False
        if self.state_pool is not None and self.state_pool.available() <= 0:
            # an admission needs a fixed-size state slot beside the decode
            # slot (1:1, counted apart so the gauge shows the pressure)
            self.state_pool.note_deferral()
            return False
        if not self.paged:
            return True
        if self.pending:
            return False
        return len(self._free_pages) >= self._admission_need(
            prompt_tokens, prompt=prompt, adapter_id=adapter_id)

    # ---- refcounted page allocator + prefix registry (paged layout) ----
    def _take_pages(self, n: int) -> np.ndarray:
        if len(self._free_pages) < n:
            raise RuntimeError(f"page allocator: {n} pages asked, "
                               f"{len(self._free_pages)} free")
        pages = np.array([self._free_pages.pop() for _ in range(n)], np.int32)
        self._page_refs[pages] = 1
        return pages

    def _share_pages(self, pages):
        for p in pages:
            self._page_refs[int(p)] += 1

    def _release_pages(self, pages):
        """Drop one reference per page; a page whose refcount reaches zero
        returns to the free list and falls out of the prefix registry, its
        float sidecar and every assembled prefix operand that holds it (the
        id may be recycled with new content). With a spill arena, a
        registered page losing its LAST sharer is first copied to the host
        (keyed by its chained digest, its sidecar with it): no allocation
        can rewrite it within this call."""
        spillable = []
        freed = set()
        for p in pages:
            p = int(p)
            r = self._page_refs[p] = self._page_refs[p] - 1
            if r < 0:
                raise RuntimeError(f"double free of page {p}")
            if r == 0:
                self._free_pages.append(p)
                freed.add(p)
                key = self._page_key.pop(p, None)
                if key is not None and self._prefix_registry.get(key) == p:
                    del self._prefix_registry[key]
                    if self.spill is not None:
                        spillable.append((p, key))
                        continue
                self._page_float.pop(p, None)
        if freed and self._prefix_fp_cache:
            self._prefix_fp_cache = {
                k: v for k, v in self._prefix_fp_cache.items()
                if not freed.intersection(k)}
        if spillable:
            self._spill_prefix_pages(spillable)

    def _release_slot_pages(self, slot: int):
        self._release_pages(self._ptab[slot, :self._held[slot]])
        self._ptab[slot] = TRASH_PAGE
        self._held[slot] = 0
        self._lens[slot] = 0
        self._ptab_dirty = True

    def _prefix_keys(self, adapter_id: Optional[str],
                     prompt: np.ndarray) -> list[bytes]:
        """One registry key per full page of ``prompt``: a CHAINED sha256
        digest (key_j = H(key_{j-1} || page_j bytes), seeded with the
        adapter identity), so hashing stays O(prompt bytes) while each
        digest commits to the whole prefix up to its page."""
        h = hashlib.sha256(b"\x00" if adapter_id is None
                           else b"\x01" + adapter_id.encode())
        ps = self.page_size
        keys = []
        for j in range(len(prompt) // ps):
            h.update(prompt[j * ps:(j + 1) * ps].tobytes())
            keys.append(h.digest())
        return keys

    def _match_prefix(self, adapter_id: Optional[str], prompt) -> list[int]:
        """Arena page ids of the longest registered page-aligned prefix of
        ``prompt`` under ``adapter_id`` (LoRA changes V, so prefixes only
        match within one adapter). Empty when sharing is off."""
        if not (self.paged and self.prefix_sharing) or prompt is None:
            return []
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) > self.prompt_len:       # join() left-truncates
            prompt = prompt[-self.prompt_len:]
        shared = []
        for key in self._prefix_keys(adapter_id, prompt):
            p = self._prefix_registry.get(key)
            if p is None:
                break
            shared.append(p)
        return shared

    def _register_prefix(self, adapter_id: Optional[str], prompt: np.ndarray,
                         slot: int, true_len: int, cache=None,
                         cache_page0: int = 0):
        """Publish the slot's FULL prompt pages (the only immutable ones —
        decode never writes below ``true_len``) for future joins to map. An
        existing registration for the same prefix wins (first writer); the
        duplicate page stays private to this slot.

        ``cache`` (chunked prefill only): the admission's FLOAT prefill
        cache, whose page ``j - cache_page0`` holds the pre-quantization K/V
        of registered page ``j``. Winning registrations keep that slice on
        the host (``_page_float``) so future sharers' tails attend the same
        values a full prefill would have seen."""
        if not self.prefix_sharing:
            return
        stash = []
        for j, key in enumerate(self._prefix_keys(adapter_id,
                                                  prompt[:true_len])):
            page = int(self._ptab[slot, j])
            if self._prefix_registry.setdefault(key, page) == page:
                self._page_key[page] = key
                if (self.chunked_prefill and cache is not None
                        and j >= cache_page0
                        and page not in self._page_float):
                    stash.append((j - cache_page0, page))
        if stash:
            # one device-to-host copy of the admission cache per attention
            # sublayer (K and V together), then host page slices: per-page
            # device reads would sync once per page
            ps = self.page_size
            host = [torch.stack([csub["k"][:, 0], csub["v"][:, 0]]).cpu()
                    for csub, psub in zip(cache, self.pool)
                    if "page_table" in psub]
            for rel, page in stash:
                self._page_float[page] = [
                    {"k": kv[0, :, rel * ps:(rel + 1) * ps].clone(),
                     "v": kv[1, :, rel * ps:(rel + 1) * ps].clone()}
                    for kv in host]

    def _sync_page_table(self):
        """Push the host page table into the one persistent device table
        (every attention layer reads it through a broadcast view, and every
        captured executable reads it where it lies: it never moves), laid
        out as the plain-width table, then the speculative headroom columns
        (``_ptab_dev``, ``_ptab_spec``: views of one storage). The
        copy goes through a fresh pinned buffer that the host never touches
        again, so the asynchronous upload cannot race the allocator's next
        mutation of ``_ptab``."""
        if not self._ptab_dirty:
            return
        w = self._plain_pages
        host = torch.from_numpy(np.concatenate([self._ptab[:, :w].ravel(),
                                                self._ptab[:, w:].ravel()]))
        if self.device.type == "cuda":
            host = host.pin_memory()
        self._ptab_store.copy_(host, non_blocking=True)
        self._ptab_dirty = False

    # ---- host-RAM spill tier (paged layout) ----
    def _paged_subs(self):
        return [sub for sub in self.pool if "page_table" in sub]

    def _gather_fn(self):
        """Capture of up to ``pages_per_slot`` pages plus one slot's running
        scales and drift trackers in one executable: the page vector is
        padded to the fixed width with the trash page, so spill traffic
        adds no shape key. ``page_idx`` (W,) and ``slot`` (1,) are device
        tensors."""
        if self._fn_gather is None:
            def gather(pool, page_idx, slot):
                out = []
                for sub in pool:
                    if "page_table" not in sub:
                        continue
                    d = {k: sub[k].index_select(1, page_idx)
                         for k in PAGE_KEYS}
                    d.update({k: sub[k].index_select(1, slot)[:, 0]
                              for k in SLOT_KEYS})
                    out.append(d)
                return out
            self._fn_gather = self._executable(gather, (0,))
        return self._fn_gather

    def _page_restore_fn(self):
        """Write-back of up to ``pages_per_slot`` pages' int8 codes and
        page scales, in place. Padded page ids point at the trash page
        (garbage by contract), so the padding's duplicate writes are
        harmless and the write is one shape key."""
        if self._fn_page_restore is None:
            def write(pool, data, page_idx):
                for sub, d in zip((s for s in pool if "page_table" in s),
                                  data):
                    for k in PAGE_KEYS:
                        sub[k].index_copy_(1, page_idx, d[k])
                return pool
            self._fn_page_restore = self._executable(write, (0,))
        return self._fn_page_restore

    def _slot_restore_fn(self):
        """Write-back of one slot's running scales, drift trackers and true
        length, in place: the second half of a spill resume. ``slot`` and
        ``true_len`` are (1,) device tensors."""
        if self._fn_slot_restore is None:
            def write(pool, state, slot, true_len):
                for sub, st in zip((s for s in pool if "page_table" in s),
                                   state):
                    for k in SLOT_KEYS:
                        sub[k].index_copy_(1, slot, st[k][:, None])
                    sub["len"].index_copy_(1, slot, true_len.to(
                        sub["len"].dtype).expand(sub["len"].shape[0], 1))
                return pool
            self._fn_slot_restore = self._executable(write, (0,))
        return self._fn_slot_restore

    def _capture_pages(self, pages: np.ndarray, slot: int) -> list:
        """``pages`` (and ``slot``'s running state) as host arrays: one
        padded gather, then one copy to the host per array, of the ``n``
        real pages only."""
        n = len(pages)
        idx = np.full((self.pages_per_slot,), TRASH_PAGE, np.int64)
        idx[:n] = pages
        dev = self._gather_fn()(self.pool, torch.as_tensor(
            idx, device=self.device), self._dev(slot))
        host = []
        for sub in dev:
            d = {k: _host(sub[k][:, :n]) for k in PAGE_KEYS}
            d.update({k: _host(sub[k]) for k in SLOT_KEYS})
            host.append(d)
        return host

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device; to a GPU through pinned
        memory (a non-blocking copy from a buffer the host never touches
        again), at the link's rate rather than a pageable copy's."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _restore_pages(self, blob: list, pages: np.ndarray):
        """Write captured page content back into arena pages ``pages``
        (freshly allocated, possibly other ids than at capture). Only the
        ``n`` real pages cross to the device; the padding to the fixed
        width is zeros made there."""
        n = len(pages)
        W = self.pages_per_slot
        idx = np.full((W,), TRASH_PAGE, np.int64)
        idx[:n] = pages
        data = []
        for sub in blob:
            d = {}
            for k in PAGE_KEYS:
                src = self._upload(np.asarray(sub[k])[:, :n])
                d[k] = src.new_zeros((src.shape[0], W) + src.shape[2:])
                d[k][:, :n] = src
            data.append(d)
        self.pool = self._page_restore_fn()(
            self.pool, data, torch.as_tensor(idx, device=self.device))

    def _spill_stream(self, slot: int, s: DecodeSlot):
        """Copy a preemption victim's whole KV state to the host before its
        pages are released: pages, scales, drift trackers, last token and
        its slot generator's state. A resume restores all of it."""
        n = int(self._held[slot])
        if n == 0:
            return
        blob = self._capture_pages(self._ptab[slot, :n], slot)
        meta = {
            "n_pages": n,
            "true_len": int(self._lens[slot]),
            "last_token": int(self._tokens[slot].item()),
            "key": self._keys[slot].get_state().numpy().copy(),
        }
        if self.spill.put(("stream", s.rid), blob, meta):
            self.spilled_pages += n

    def _drop_stream_spill(self, rid: int):
        if self.spill is not None:
            self.spill.pop(("stream", rid))

    def _try_spill_resume(self, req: _PendingJoin) -> Optional[int]:
        """Resume a preempted stream from its host spill: fresh pages, its
        codes, scales, trackers and generator state written back, the page
        table rebuilt and its prefix registered again, with no re-prefill.
        Returns the slot, or None to fall back to the re-prefill (no entry,
        a digest mismatch, or too few free pages for its true length)."""
        entry = self.spill.get(("stream", req.rid))
        if entry is None:
            return None
        if not entry.verify():
            self.spill.pop(("stream", req.rid))
            self.digest_failures += 1
            return None
        n = int(entry.meta["n_pages"])
        if len(self._free_pages) < n or not self.free_slots():
            return None
        t0 = time.perf_counter()
        self.spill.pop(("stream", req.rid))
        s = req.resume
        slot = self.free_slots()[0]
        pages = self._take_pages(n)
        true_len = int(entry.meta["true_len"])
        self._restore_pages(entry.blob, pages)
        state = [{k: torch.as_tensor(sub[k], device=self.device)
                  for k in SLOT_KEYS} for sub in entry.blob]
        self.pool = self._slot_restore_fn()(
            self.pool, state, self._dev(slot),
            self._dev(true_len, dtype=torch.int32))
        self._ptab[slot, :n] = pages
        self._held[slot] = n
        self._lens[slot] = true_len
        self._ptab_dirty = True
        self._tokens[slot] = int(entry.meta["last_token"])
        self._keys[slot].set_state(torch.from_numpy(entry.meta["key"]))
        self.slots[slot] = s
        self._slot_adapters[slot] = self.fm.adapters.index(req.adapter_id)
        self._seg_key = None
        # restored prompt pages sit at their original table positions, so
        # registering again publishes the prefix for future sharers
        if s.prompt is not None:
            self._register_prefix(s.adapter_id, np.asarray(s.prompt), slot,
                                  s.prompt_tokens)
        self.admissions += 1      # progress signal (watchdog); not re-logged
        self.spill_resumes += 1
        self.restored_pages += n
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # the cost is device time
        self.resume_costs.append(("spill", time.perf_counter() - t0))
        return slot

    def _spill_prefix_pages(self, pairs: list):
        """Copy last-sharer prefix pages to the host as they leave the
        registry, keyed by their chained digest, each with its float
        sidecar where it had one (as int16 bit patterns)."""
        pages = np.array([p for p, _ in pairs], np.int32)
        blob = self._capture_pages(pages, 0)    # slot state ignored
        for j, (p, key) in enumerate(pairs):
            per_page = [{k: sub[k][:, j:j + 1] for k in PAGE_KEYS}
                        for sub in blob]
            fp = self._page_float.pop(p, None)
            if fp is not None:
                for sub, f in zip(per_page, fp):
                    sub["kf"] = f["k"].view(torch.int16).numpy()
                    sub["vf"] = f["v"].view(torch.int16).numpy()
            if self.spill.put(("prefix", key), per_page, {}):
                self.spilled_pages += 1

    def _match_spilled_prefix(self, adapter_id: Optional[str], prompt,
                              skip: int) -> list:
        """Continue a prompt's digest chain past the live registry into the
        spill arena: (key, entry) pairs of consecutive spilled full pages
        from page index ``skip``. A digest mismatch ends the chain (the
        corrupt entry is dropped and counted)."""
        if self.spill is None or not (self.paged and self.prefix_sharing) \
                or prompt is None:
            return []
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) > self.prompt_len:
            prompt = prompt[-self.prompt_len:]
        out = []
        for j, key in enumerate(self._prefix_keys(adapter_id, prompt)):
            if j < skip:
                continue
            entry = self.spill.get(("prefix", key))
            if entry is None:
                break
            if not entry.verify():
                self.spill.pop(("prefix", key))
                self.digest_failures += 1
                break
            out.append((key, entry))
        return out

    @staticmethod
    def _spilled_blob(spilled: list) -> list:
        """The arena content of consecutive spilled prefix pages, one dict
        per paged sublayer group, pages along axis 1."""
        return [{k: np.concatenate([e.blob[j][k] for _, e in spilled],
                                   axis=1) for k in PAGE_KEYS}
                for j in range(len(spilled[0][1].blob))]

    # ---- static-shape planes ----
    def _dev(self, *vals, dtype=torch.long):
        """Host ints as a device tensor: a slot, page or length operand of
        an executable (data, never part of a shape key)."""
        return torch.tensor(vals, dtype=dtype, device=self.device)

    def _executable(self, fn, bake, sampled: bool = False):
        """A plane function as a ``graphs.Executable``. A ``sampled`` plane
        stays eager under ``temperature > 0``: it draws from per-slot
        generators a capture would bake."""
        return graphs.Executable(fn, bake=bake,
                                 capture=not (sampled and self.temperature > 0))

    def _impl(self, rows: int, cap: int) -> str:
        """LoRA path for a ``rows``-row co-batch, resolved from the slot
        bucket (not the live adapter count) so the choice is stable within
        each (rows, cap) shape key."""
        return self.fm.resolve_lora_impl(rows, num_adapters=cap)

    def _seg(self, impl, perm, inv, blocks):
        if impl != "segmented":
            return None
        return {"perm": perm, "inv": inv, "block_adapter": blocks,
                "block_t": self.fm.seg_block_t}

    def _adm_s_max(self, plen: int) -> int:
        """Admission-prefill cache length for one prompt bucket: the paged
        scatter needs a whole number of pages; dense scatters into s_max."""
        if self.paged:
            return self._pages_for(plen) * self.page_size
        return self.s_max

    def _prefill_fn(self, cap: int, plen: int):
        """Admission prefill for one prompt-length bucket: a one-row cache,
        filled and quantized per (row, kv head) for the dense pool, kept in
        float for the paged pool (its scatter quantizes per page, so a
        page's scale depends only on the tokens it covers). An
        encoder-decoder stack takes the stream's (1, enc_len, d) frames
        (``enc_embeds``; None otherwise) and fills the cross K/V state."""
        key = (cap, plen)
        if key not in self._fn_prefill:
            cfg, impl, sample = self.cfg, self._impl(1, cap), self._sample
            s_max, dev = self._adm_s_max(plen), self.device
            kvq = self.kv_quant and not self.paged
            enc_len = self.enc_len or None

            def run(params, tokens, true_len, enc_embeds, gens, lora_stack,
                    adapter_idx, perm, inv, blocks):
                cache = lm.init_cache(cfg, 1, s_max, kv_quant=kvq,
                                      enc_len=enc_len, device=dev)
                logits, cache = lm.prefill(
                    params, cfg, tokens=tokens, cache=cache, lora=lora_stack,
                    adapter_idx=adapter_idx, lora_impl=impl,
                    lora_seg=self._seg(impl, perm, inv, blocks),
                    seq_lens=true_len, enc_embeds=enc_embeds)
                first, gens = sample(logits, gens)
                return first, lm.finite_logits(logits), gens, cache

            self._fn_prefill[key] = self._executable(run, (0, 5), True)
        return self._fn_prefill[key]

    def _tail_prefill_fn(self, cap: int, tlen: int, mode: str = "float"):
        """Chunked shared-prefix admission prefill for one TAIL bucket: the
        model over only the prompt's private tail, its queries attending the
        mapped prefix in front of the tail's own fresh K/V. Two prefix
        sources, same attention plumbing:

          * ``mode="float"`` — the prefix K/V arrive as an operand assembled
            on the host from the pages' float sidecars: the values a full
            prefill computed, so the tail's logits and cache are those of
            the full path up to summation order;
          * ``mode="pages"`` — the prefix is gathered from the int8 arena
            through the prefix page vector and dequantized per page
            (``ops.gather_prefix_kv``), for pages whose sidecar is gone:
            correct to the quantization error.

        The true prefix and tail lengths are operands; only the tail bucket
        and the mode make a shape key."""
        key = ("tail", cap, tlen, mode)
        if key not in self._fn_prefill:
            cfg, impl, sample = self.cfg, self._impl(1, cap), self._sample
            # like the full paged admission, the tail cache stays float: the
            # tail-page scatter quantizes per page afterwards
            s_max = self._pages_for(tlen) * self.page_size
            dev = self.device
            paged_mask = ["page_table" in sub for sub in self.pool]

            def body(params, prefix, tokens, tail_len, prefix_len, gens,
                     lora_stack, adapter_idx, perm, inv, blocks):
                cache = lm.init_cache(cfg, 1, s_max, kv_quant=False,
                                      device=dev)
                # absolute positions: RoPE sees the tail behind the prefix
                pos = prefix_len[:, None] + torch.arange(
                    tokens.shape[1], device=dev)[None]
                logits, cache = lm.prefill(
                    params, cfg, tokens=tokens, cache=cache, lora=lora_stack,
                    adapter_idx=adapter_idx, lora_impl=impl,
                    lora_seg=self._seg(impl, perm, inv, blocks),
                    seq_lens=tail_len, pos=pos, prefix=prefix,
                    prefix_len=prefix_len)
                first, gens = sample(logits, gens)
                return first, lm.finite_logits(logits), gens, cache

            if mode == "float":
                bake = (0, 6)

                def run(params, prefix_fp, tokens, tail_len, prefix_len, gens,
                        lora_stack, adapter_idx, perm, inv, blocks):
                    it = iter(prefix_fp)
                    prefix = [next(it) if paged else None
                              for paged in paged_mask]
                    return body(params, prefix, tokens, tail_len, prefix_len,
                                gens, lora_stack, adapter_idx, perm, inv,
                                blocks)
            else:
                from repro_torch.kernels import ops
                bake = (0, 1, 7)

                def run(params, pool, tokens, tail_len, prefix_pages,
                        prefix_len, gens, lora_stack, adapter_idx, perm, inv,
                        blocks):
                    # dequantized prefix K/V per attention sublayer, gathered
                    # from the arena through the prefix page vector
                    # (positions past prefix_len point at the trash page and
                    # are masked out of attention)
                    prefix = []
                    for sub in pool:
                        if "page_table" not in sub:
                            prefix.append(None)
                            continue
                        per = [ops.gather_prefix_kv(
                            sub["k"][i], sub["v"][i], sub["k_scale"][i],
                            sub["v_scale"][i], prefix_pages[None])
                            for i in range(sub["k"].shape[0])]
                        prefix.append({"k": torch.stack([g[0] for g in per]),
                                       "v": torch.stack([g[1] for g in per])})
                    return body(params, prefix, tokens, tail_len, prefix_len,
                                gens, lora_stack, adapter_idx, perm, inv,
                                blocks)

            self._fn_prefill[key] = self._executable(run, bake, True)
        return self._fn_prefill[key]

    def _write_fn(self):
        """Admission scatter: copy the one-row prefill cache into the pool's
        slot (a (1,) device index) along the batch axis, in place."""
        if None not in self._fn_write:
            def write(pool, cache, slot):
                for psub, csub in zip(pool, cache):
                    for name, t in psub.items():
                        t.index_copy_(1, slot, csub[name])
                return pool
            self._fn_write[None] = self._executable(write, (0,))
        return self._fn_write[None]

    def _paged_write_fn(self, npages: int):
        """Paged admission scatter for one prompt bucket (``npages`` pages),
        in place: the one-row FLOAT prefill cache reshapes into pages, each
        page is quantized with its own per-(page, kv-head) scale (a pure
        function of the tokens it covers — what makes shared prefix pages
        bit-exact across streams), and pages scatter into the arena at the
        given page ids. Shared prefix positions arrive pointed at the trash
        page, so their (identical) content is discarded. The boundary page
        (``true_len // page_size``, the partial page decode appends into) is
        stamped at the slot-wide scale. The slot's running scales are set to
        the prompt-wide maximum, the drift trackers reset, and ``len`` is
        set to the true prompt length. Fixed-size per-slot state (the
        cross-attention ``ck``/``cv`` of an encoder-decoder stack) copies
        into the slot's row as it is. ``slot`` and ``true_len`` are (1,)
        device tensors."""
        if npages not in self._fn_write:
            ps = self.page_size

            def write(pool, cache, slot, page_idx, true_len):
                sel = (torch.arange(npages, device=page_idx.device)
                       == true_len // ps)[None, :, None]
                for psub, csub in zip(pool, cache):
                    kf = csub["k"][:, 0].float()           # (nper, S, kv, hd)
                    nper, _, kv, hd = kf.shape
                    kf = kf.reshape(nper, npages, ps, kv, hd)
                    vf = csub["v"][:, 0].float().reshape(nper, npages, ps,
                                                         kv, hd)
                    kmax = kf.abs().amax(dim=(2, 4))        # (nper, np, kv)
                    vmax = vf.abs().amax(dim=(2, 4))
                    # slot scales = prompt-wide max: the dense pool's per-row
                    # quantization range
                    slot_ks = torch.clamp(kmax.amax(dim=1), min=1e-8) / 127.0
                    slot_vs = torch.clamp(vmax.amax(dim=1), min=1e-8) / 127.0
                    ks = torch.where(sel, slot_ks[:, None, :], kmax / 127.0)
                    vs = torch.where(sel, slot_vs[:, None, :], vmax / 127.0)
                    psub["k"][:, page_idx] = quantize_pages(kf, ks)
                    psub["v"][:, page_idx] = quantize_pages(vf, vs)
                    psub["k_scale"][:, page_idx] = ks
                    psub["v_scale"][:, page_idx] = vs
                    _set_slot(psub, slot, slot_ks, slot_vs, true_len)
                    for name in dense_state_keys(psub):
                        psub[name].index_copy_(1, slot, csub[name])
                return pool

            self._fn_write[npages] = self._executable(write, (0,))
        return self._fn_write[npages]

    def _paged_tail_write_fn(self, npages: int):
        """Page scatter for a chunked (tail-only) admission, in place:
        quantize the tail's float cache per page like ``_paged_write_fn``,
        but

          * the prompt/decode boundary page index is an operand
            (``boundary = true_len // page_size - skip``, relative to the
            tail's first page; out of range when the prompt is
            page-aligned, as on the full path), and
          * the slot-wide running scales fold in the mapped prefix pages'
            stamped scales. A registered full page's scale is its own
            |K|max / 127 (it is never the boundary page), and max-then-divide
            equals divide-then-max for a positive constant, so the combined
            slot scale is the one a full prefill over the whole prompt
            computes.

        ``slot``, ``true_len``, ``boundary`` and ``prefix_np`` are (1,)
        device tensors."""
        key = ("tail", npages)
        if key not in self._fn_write:
            ps = self.page_size

            def write(pool, cache, slot, page_idx, true_len, boundary,
                      prefix_pages, prefix_np):
                W = prefix_pages.shape[0]
                pmask = (torch.arange(W, device=prefix_pages.device)
                         < prefix_np)[None, :, None]
                sel = (torch.arange(npages, device=page_idx.device)
                       == boundary)[None, :, None]
                for psub, csub in zip(pool, cache):
                    kf = csub["k"][:, 0].float()           # (nper, S, kv, hd)
                    nper, _, kv, hd = kf.shape
                    kf = kf.reshape(nper, npages, ps, kv, hd)
                    vf = csub["v"][:, 0].float().reshape(nper, npages, ps,
                                                         kv, hd)
                    kmax = kf.abs().amax(dim=(2, 4))        # (nper, np, kv)
                    vmax = vf.abs().amax(dim=(2, 4))
                    # prefix page scales (trash-padded entries masked to 0)
                    pks = torch.where(pmask, psub["k_scale"][:, prefix_pages],
                                      0.0)
                    pvs = torch.where(pmask, psub["v_scale"][:, prefix_pages],
                                      0.0)
                    slot_ks = torch.maximum(
                        torch.clamp(kmax.amax(dim=1), min=1e-8) / 127.0,
                        pks.amax(dim=1))
                    slot_vs = torch.maximum(
                        torch.clamp(vmax.amax(dim=1), min=1e-8) / 127.0,
                        pvs.amax(dim=1))
                    ks = torch.where(sel, slot_ks[:, None, :], kmax / 127.0)
                    vs = torch.where(sel, slot_vs[:, None, :], vmax / 127.0)
                    psub["k"][:, page_idx] = quantize_pages(kf, ks)
                    psub["v"][:, page_idx] = quantize_pages(vf, vs)
                    psub["k_scale"][:, page_idx] = ks
                    psub["v_scale"][:, page_idx] = vs
                    _set_slot(psub, slot, slot_ks, slot_vs, true_len)
                return pool

            self._fn_write[key] = self._executable(write, (0,))
        return self._fn_write[key]

    def _rescale_fn(self):
        """Proactive scale refresh for ONE (slot, tail page), each a (1,)
        device index, in place: bump the page and slot scales to cover the
        slot's observed decode-era |K|/|V| maxima (with 10% headroom) and
        rewrite the page's int8 codes from the old scale into the new
        one."""
        if self._fn_rescale is None:
            margin = 1.1 / 127.0

            def rescale(pool, slot, page):
                for sub in pool:
                    for c in ("k", "v"):
                        # (nper, 1, kv)
                        mx = sub[f"{c}_max"].index_select(1, slot) * margin
                        old = sub[f"{c}_scale"].index_select(1, page)
                        new = torch.maximum(old, mx)
                        r = torch.where(new > 0,
                                        old / torch.clamp(new, min=1e-12),
                                        torch.ones_like(new))
                        codes = torch.round(
                            sub[c].index_select(1, page).float()
                            * r[:, :, None, :, None])
                        sub[c].index_copy_(1, page, codes.to(sub[c].dtype))
                        sub[f"{c}_scale"].index_copy_(1, page, new)
                        slot_s = sub[f"slot_{c}_scale"]
                        slot_s.index_copy_(1, slot, torch.maximum(
                            slot_s.index_select(1, slot), mx))
                return pool

            self._fn_rescale = self._executable(rescale, (0,))
        return self._fn_rescale

    def _maybe_refresh_scales(self, over: np.ndarray):
        """Refresh the (always private) tail page of every slot the chunk's
        drift check flagged: its decode-era |K|/|V| maxima exceeded
        ``scale_refresh`` x the admission range."""
        if not self.paged or self.scale_refresh <= 0 or not over.any():
            return
        for i in np.nonzero(over)[0]:
            s = self.slots[i]
            # only a slot that has decoded past its prompt has a private
            # tail page to rewrite — shared prefix pages never are targets
            if s is None or s.done or self._lens[i] <= s.prompt_tokens:
                continue
            page = int(self._ptab[i, (self._lens[i] - 1) // self.page_size])
            self.pool = self._rescale_fn()(self.pool, self._dev(int(i)),
                                           self._dev(page))
            self.scale_refreshes += 1

    def _decode_fn(self, cap: int, chunk: int):
        """``chunk`` decode steps over every slot; returns (pool, last
        tokens, generators, tokens (slots, chunk), drift flags (slots,),
        finite flags (slots,)). The drift flag (paged, scale refresh on) is
        computed from the post-chunk trackers, so it rides the chunk's one
        host sync with the tokens."""
        key = (self.num_slots, cap, chunk)
        if key not in self._fn_decode:
            cfg, sample = self.cfg, self._sample
            impl = self._impl(self.num_slots, cap)
            nslots, dev = self.num_slots, self.device
            refresh_thr = self.scale_refresh * 127.0 \
                if self.paged and self.scale_refresh > 0 else None

            def run(params, pool, tokens, gens, lora_stack, adapter_idx,
                    perm, inv, blocks):
                seg = self._seg(impl, perm, inv, blocks)
                fin = torch.ones((nslots,), dtype=torch.bool, device=dev)
                out = []
                tok = tokens
                for _ in range(chunk):
                    logits, pool = lm.decode_step(
                        params, cfg, tokens=tok, cache=pool, lora=lora_stack,
                        adapter_idx=adapter_idx, lora_impl=impl, lora_seg=seg)
                    # a non-finite step anywhere in the chunk quarantines the
                    # stream; the flag rides the chunk's one host sync
                    fin = fin & lm.finite_logits(logits)
                    tok, gens = sample(logits, gens)
                    out.append(tok)
                drift = torch.zeros((nslots,), dtype=torch.bool, device=dev)
                if refresh_thr is not None:
                    for sub in pool:
                        o = (sub["k_max"] > refresh_thr * torch.clamp(
                            sub["slot_k_scale"], min=1e-8)) | \
                            (sub["v_max"] > refresh_thr * torch.clamp(
                                sub["slot_v_scale"], min=1e-8))
                        drift = drift | o.any(dim=2).any(dim=0)
                return pool, tok, gens, torch.stack(out, dim=1), drift, fin

            self._fn_decode[key] = self._executable(run, (0, 1, 4), True)
        return self._fn_decode[key]

    def _spec_decode_fn(self, cap: int, chunk: int):
        """``chunk`` draft -> verify -> accept steps over every slot (module
        docstring), unrolled as in ``_decode_fn``; keyed ``("spec", slots,
        cap, chunk, k)`` among the decode executables. Each step drafts up to
        ``spec_k`` tokens per slot from the slot's history, scores the
        ``k + 1`` window positions in one ``lm.verify_step``, samples every
        position, accepts the longest matching draft prefix (``m = 1 +
        sum(cumprod(match))`` tokens committed), rolls ``len`` and the drift
        trackers back to the commit point, and appends the committed tokens
        to the history, so later steps draft from them. Returns (pool, last
        tokens, generators, candidates (slots, chunk, k + 1), commits
        (slots, chunk), proposals (slots, chunk), drift flags, finite
        flags); a slot commits ``candidates[:, s, :commits[:, s]]`` at step
        s. ``hist`` (slots, H + 1) and ``hlen`` (slots,) are staged; column
        H is the trash column of the uncommitted positions' writes."""
        k = self.spec_k
        key = ("spec", self.num_slots, cap, chunk, k)
        if key not in self._fn_decode:
            cfg, sample = self.cfg, self._sample
            impl = self._impl(self.num_slots, cap)
            nslots, dev = self.num_slots, self.device
            refresh_thr = self.scale_refresh * 127.0 \
                if self.scale_refresh > 0 else None
            T = k + 1
            # the draft sentinel: one past the vocabulary. No sampled token
            # can equal it, so a filled position never matches and the step
            # commits exactly one token, the plain step's; it is clamped to
            # a valid row before the embedding gather (garbage compute where
            # JAX clips in its gather; an unclamped CUDA gather would fault)
            FILL = cfg.vocab_size
            force_fill = self.spec_force_fill
            H = self._spec_hist_len

            def draft_fn(tok, hist, hlen, ar_h, ar_k):
                """The latest earlier occurrence of the slot's current bigram
                (prev, tok) in its history, and the k tokens that followed
                it: (drafts (slots, k), proposals (slots,))."""
                if force_fill:
                    return (torch.full((nslots, k), FILL, dtype=torch.int32,
                                       device=dev),
                            torch.zeros((nslots,), dtype=torch.int32,
                                        device=dev))
                hv = hist[:, :H]
                prev = hv.gather(1, torch.clamp(hlen - 2, min=0)[:, None].long())
                mt = (hv[:, :-1] == prev) & (hv[:, 1:] == tok[:, None]) \
                    & (ar_h[None, :H - 1] + 1 < (hlen - 1)[:, None])
                has = mt.any(dim=1)
                jbest = (H - 2) - torch.argmax(
                    mt.flip(1).to(torch.int32), dim=1)
                src = jbest[:, None] + 2 + ar_k[None]
                cand = hv.gather(1, torch.clamp(src, max=H - 1))
                valid = has[:, None] & (src < hlen[:, None])
                draft = torch.where(valid, cand, torch.full_like(cand, FILL))
                return draft.to(torch.int32), valid.sum(dim=1).to(torch.int32)

            def run(params, pool, tokens, gens, hist, hlen, ptab, lora_stack,
                    adapter_idx, perm, inv, blocks):
                seg = self._seg(impl, perm, inv, blocks)
                ar_t = torch.arange(T, device=dev)
                ar_h = torch.arange(H + 1, device=dev)
                bidx = torch.arange(nslots, device=dev)
                # the verify forward's pool: the full-width table (the
                # plain-width block and the headroom columns joined once)
                # and the per-position running-max stacks it fills
                full = torch.cat(ptab, dim=1)
                wide = []
                for sub in pool:
                    nper, kv = sub["k_max"].shape[0], sub["k_max"].shape[2]
                    wide.append(dict(
                        sub, page_table=full.expand(nper, -1, -1),
                        k_cmax=torch.empty((nper, nslots, T, kv), device=dev),
                        v_cmax=torch.empty((nper, nslots, T, kv), device=dev)))
                fin = torch.ones((nslots,), dtype=torch.bool, device=dev)
                tok = tokens
                gs, ms, ps = [], [], []
                for _ in range(chunk):
                    draft, nprop = draft_fn(tok, hist, hlen, ar_h, ar_t[:k])
                    seq = torch.cat([tok[:, None], draft], dim=1)
                    logits, _ = lm.verify_step(
                        params, cfg, tokens=torch.clamp(seq, max=FILL - 1),
                        cache=wide, lora=lora_stack, adapter_idx=adapter_idx,
                        lora_impl=impl, lora_seg=seg)
                    # every window position sampled, each row's generator
                    # once per position in window order (greedy draws none)
                    cols = []
                    for j in range(T):
                        t_j, gens = sample(logits[:, j], gens)
                        cols.append(t_j)
                    g = torch.stack(cols, dim=1)                   # (B, T)
                    match = (draft == g[:, :k]).to(torch.int32)
                    m = 1 + torch.cumprod(match, dim=1).sum(dim=1)
                    tok = g.gather(1, (m - 1)[:, None].long())[:, 0]
                    # quarantine on committed positions only: the rejected
                    # tail conditions on wrong tokens and is discarded
                    fin = fin & (lm.finite_logits(logits)
                                 | (ar_t[None] >= m[:, None])).all(dim=1)
                    # rollback: len and the drift maxima back to the commit
                    # point's running values (the codes past it stay, to be
                    # overwritten)
                    sel = (m - 1).long()
                    for sub in wide:
                        sub["k_max"].copy_(sub["k_cmax"][:, bidx, sel])
                        sub["v_max"].copy_(sub["v_cmax"][:, bidx, sel])
                        sub["len"].copy_((sub["len"] - T + m[None]).to(
                            sub["len"].dtype))
                    # committed tokens join the history; the rest of the
                    # window writes the trash column
                    wpos = hlen[:, None] + ar_t[None]
                    wpos = torch.where((ar_t[None] < m[:, None]) & (wpos < H),
                                       wpos, torch.full_like(wpos, H))
                    hist.scatter_(1, wpos.long(), g.to(hist.dtype))
                    hlen = hlen + m.to(hlen.dtype)
                    gs.append(g)
                    ms.append(m.to(torch.int32))
                    ps.append(nprop)
                drift = torch.zeros((nslots,), dtype=torch.bool, device=dev)
                if refresh_thr is not None:
                    for sub in pool:
                        o = (sub["k_max"] > refresh_thr * torch.clamp(
                            sub["slot_k_scale"], min=1e-8)) | \
                            (sub["v_max"] > refresh_thr * torch.clamp(
                                sub["slot_v_scale"], min=1e-8))
                        drift = drift | o.any(dim=2).any(dim=0)
                return (pool, tok, gens, torch.stack(gs, dim=1),
                        torch.stack(ms, dim=1), torch.stack(ps, dim=1),
                        drift, fin)

            self._fn_decode[key] = self._executable(run, (0, 1, 6, 7), True)
        return self._fn_decode[key]

    def _spec_history(self):
        """The drafter's per-slot (history, length) from the host: prompt +
        generated tokens, right-padded to ``_spec_hist_len`` plus the trash
        column; position ``hlen - 1`` holds the pending token. Built per
        dispatch and staged into the executable: the device copy changes
        inside the chunk and is discarded (the host state stays the one
        source of truth across preemption and spill)."""
        H = self._spec_hist_len
        hist = np.zeros((self.num_slots, H + 1), np.int32)
        hlen = np.zeros((self.num_slots,), np.int32)
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            seq = np.concatenate([
                np.asarray(s.prompt if s.prompt is not None else [],
                           np.int64).reshape(-1),
                np.asarray(s.tokens, np.int64).reshape(-1)]).astype(
                    np.int32)[-H:]
            hist[i, :len(seq)] = seq
            hlen[i] = len(seq)
        return (torch.as_tensor(hist, device=self.device),
                torch.as_tensor(hlen, device=self.device))

    def _spec_dispatch_now(self) -> bool:
        """Adaptive spec/plain demotion: speculate while the accept EMA
        clears ``spec_disable_below`` committed tokens per slot-step (or has
        no reading yet); below it, dispatch the plain executable (counted in
        ``spec_fallbacks``) and re-probe speculatively after
        ``_spec_probe_interval`` plain dispatches. A probe is a one-step
        chunk (the chunk-1 key is in the warmed ladder), and each dry probe
        doubles the interval, up to 16x ``spec_probe_every``, so a workload
        that never accepts pays a vanishing probe tax and one that turns
        self-similar again is found within a bounded number of dispatches.
        Both executables are warmed: flipping adds no key."""
        self._spec_probe = False
        if self.spec_k <= 0 or not self.paged:
            return False
        if self._spec_accept_ema == 0.0 \
                or self._spec_accept_ema >= self.spec_disable_below:
            self._spec_cool = 0
            self._spec_probe_interval = self.spec_probe_every
            return True
        self._spec_cool += 1
        if self._spec_cool >= self._spec_probe_interval:
            self._spec_cool = 0
            self._spec_probe = True
            return True
        self.spec_fallbacks += 1
        return False

    def spec_task_accept_rates(self) -> dict:
        """Per task: drafted tokens accepted / proposed (tasks that
        proposed at least one)."""
        return {t: a / p for t, (p, a) in self._spec_task_stats.items()
                if p > 0}

    # ---- segment metadata (per composition, not per token) ----
    def _segments(self, cap: int):
        if self._impl(self.num_slots, cap) != "segmented":
            return None, None, None
        key = (self._slot_adapters.tobytes(), cap)
        if key != self._seg_key:
            self._seg_dev = seg_to_device(
                *self.fm.segment_meta(self._slot_adapters, cap, 1), self.device)
            self._seg_key = key
        return self._seg_dev

    def _spec_segments(self, cap: int):
        """Segment metadata of the verify co-batch: the composition of
        ``_segments`` with ``spec_k + 1`` tokens a slot (the window
        flattens row-major, as ``segment_meta`` repeats ids), memoized on
        the composition."""
        if self._impl(self.num_slots, cap) != "segmented":
            return None, None, None
        key = (self._slot_adapters.tobytes(), cap)
        if key != self._spec_seg_key:
            self._spec_seg_dev = seg_to_device(*self.fm.segment_meta(
                self._slot_adapters, cap, self.spec_k + 1), self.device)
            self._spec_seg_key = key
        return self._spec_seg_dev

    def _prefill_segments(self, adapter_slot: int, cap: int, plen: int):
        if self._impl(1, cap) != "segmented":
            return None, None, None
        ids = np.full((plen,), adapter_slot, np.int32)
        return seg_to_device(*self.fm.segment_meta(ids, cap, 1), self.device)

    def bucket_for_prompt(self, n: int) -> int:
        """Smallest admission bucket holding an n-token prompt."""
        for b in self.prompt_buckets:
            if n <= b:
                return b
        return self.prompt_buckets[-1]

    def bucket_for_tail(self, n: int) -> int:
        """Smallest tail bucket holding an n-token private tail (chunked
        admission). Tail buckets are powers of two of the page size, capped
        at ``prompt_len``: a shape key, so any mix of tail lengths across
        sharer churn reuses the same keys."""
        for b in self.tail_buckets:
            if n <= b:
                return b
        return self.tail_buckets[-1]

    # ---- serving surface ----
    def _norm_enc_feats(self, enc_feats) -> np.ndarray:
        """One stream's encoder input as the engine's fixed (enc_len,
        d_model) frames. ``None`` means zero frames (the stub frontend's
        silence), so callers without audio, the serve loop's warmup
        included, join unchanged. The frame count is strict: the encoder is
        bidirectional, so padding would change every encoder output."""
        d = self.cfg.d_model
        if enc_feats is None:
            return np.zeros((self.enc_len, d), np.float32)
        enc_feats = np.asarray(enc_feats, np.float32).reshape(-1, d)
        if enc_feats.shape[0] != self.enc_len:
            raise ValueError(
                f"enc_feats must carry exactly enc_len={self.enc_len} frames "
                f"(got {enc_feats.shape[0]}): the encoder is bidirectional, "
                f"padding is not transparent")
        return enc_feats

    def join(self, task_id: str, prompt: np.ndarray, *,
             adapter_id: Optional[str] = None, max_new_tokens: int = 8,
             rid: int = -1, eos_id: Optional[int] = None,
             deadline: Optional[float] = None,
             enc_feats: Optional[np.ndarray] = None) -> int:
        """Admit one request: prefill its prompt (LoRA applied), write its
        K/V into a free slot (paged: into freshly allocated pages, mapping a
        registered shared prefix), produce the first token. Returns the slot
        index.

        A full pool behaves per layout: the dense pool raises (its capacity
        is the static slot count); the paged pool DEFERS — the request
        queues FIFO and admits during a later ``step_chunk`` once a slot and
        enough free pages exist — and returns -1. A prompt that could not
        fit even an empty arena raises ``ValueError`` (a configuration
        error; deferring it would spin forever). Prompts longer than the
        largest bucket keep their LAST ``prompt_len`` tokens (with a
        warning); the decode budget clamps to the pool's ``max_new``.
        ``enc_feats``: an encoder-decoder stream's frames (see
        ``_norm_enc_feats``), validated here; ignored by decoder-only
        stacks."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self.cfg.is_encoder_decoder:
            enc_feats = self._norm_enc_feats(enc_feats)
        req = _PendingJoin(task_id=task_id, prompt=prompt,
                           adapter_id=adapter_id,
                           max_new_tokens=max_new_tokens, rid=rid,
                           eos_id=eos_id,
                           deadline=float("inf") if deadline is None
                           else float(deadline),
                           enc_feats=enc_feats
                           if self.cfg.is_encoder_decoder else None)
        if self.paged and not self.can_admit(len(prompt), prompt=prompt,
                                             adapter_id=adapter_id):
            if self._never_fits(req):
                plen = self.bucket_for_prompt(min(max(len(prompt), 1),
                                                  self.prompt_len))
                base = self._pages_for(self._adm_s_max(plen)) + \
                    self._pages_for(self._headroom_tokens())
                raise ValueError(
                    f"prompt needs {base} pages (bucket {plen} + chunk "
                    f"headroom) beyond any shared prefix but the arena "
                    f"only has {self.total_pages - 1} usable pages; raise "
                    f"total_pages or shrink prompt_buckets/chunk")
            self.pending.append(req)
            self.deferrals += 1
            return -1
        if not self.free_slots():
            raise RuntimeError("no free decode slots; step_chunk() first")
        return self._admit_now(req)

    def _admit_now(self, req: _PendingJoin) -> int:
        if req.resume is not None and self.spill is not None:
            slot = self._try_spill_resume(req)
            if slot is not None:
                return slot
        t_adm = time.perf_counter()
        prompt = req.prompt
        if len(prompt) > self.prompt_len:
            warnings.warn(
                f"prompt of {len(prompt)} tokens exceeds the engine's largest "
                f"admission bucket ({self.prompt_len}); left-truncating to "
                f"the last {self.prompt_len} tokens (context is lost — size "
                f"prompt_buckets to the workload)", RuntimeWarning,
                stacklevel=3)
            prompt = prompt[-self.prompt_len:]     # causal LM: suffix matters
        true_prompt = prompt
        true_len = max(1, len(prompt))
        plen = self.bucket_for_prompt(true_len)
        if len(prompt) < plen:                     # right-pad to the bucket
            prompt = np.concatenate(
                [prompt, np.zeros(plen - len(prompt), np.int32)])
        max_new_tokens = max(1, min(req.max_new_tokens, self.max_new))
        slot = self.free_slots()[0]
        cap = self.fm.adapters.capacity()
        aslot = self.fm.adapters.index(req.adapter_id)
        if self.paged and self.chunked_prefill:
            admitted = self._try_admit_tail(req, true_prompt, true_len, slot,
                                            cap, aslot, max_new_tokens, t_adm)
            if admitted is not None:
                return admitted
        perm, inv, blocks = self._prefill_segments(aslot, cap, plen)
        dev = self.device
        # the frames were normalized at join (a resume carries its own)
        enc = torch.as_tensor(req.enc_feats[None], device=dev) \
            if self.cfg.is_encoder_decoder else None
        first, fin, _, cache = self._prefill_fn(cap, plen)(
            self.fm.params, torch.as_tensor(prompt[None], device=dev),
            torch.full((1,), true_len, dtype=torch.int32, device=dev), enc,
            [self._keys[slot]], self.fm.adapters.stacked(),
            torch.full((1,), aslot, dtype=torch.int32, device=dev),
            perm, inv, blocks)
        # the prefill consumed real device work whether or not the stream
        # survives it — record the admission for token-level charging (a
        # resumed stream was charged at its first admission)
        self.admissions += 1
        self.tail_tokens_computed += true_len
        if req.resume is None:
            self.admitted_log.append((req.rid, req.task_id, true_len,
                                      true_len))
        # numeric health rides the admission's host sync: a non-finite
        # prefill quarantines right here — no pages allocated, no pool
        # write, no prefix registration (NaN K/V never enters the registry)
        fin_ok = bool(fin[0].item())
        if not fin_ok:
            self.quarantines += 1
        elif self.paged:
            self._write_pages(req, true_prompt, true_len, plen, slot, cache)
        else:
            self.pool = self._write_fn()(self.pool, cache, self._dev(slot))
        return self._finish_admission(req, slot, aslot, first, fin_ok,
                                      true_prompt, true_len, max_new_tokens,
                                      t_adm)

    def _write_pages(self, req: _PendingJoin, true_prompt: np.ndarray,
                     true_len: int, plen: int, slot: int, cache):
        """The paged half of an admission: map the registered shared prefix
        (copy-on-write: those positions scatter to the trash page, their
        content is already in the arena and others read it), restore the
        pages where the prompt's digest chain continues into the spill arena
        (their exact content replaces what the prefill recomputed: their
        positions scatter to the trash page too), allocate the rest, write,
        trim the bucket padding's pages, register the prompt's full
        pages."""
        npages = self._pages_for(self._adm_s_max(plen))
        shared = self._match_prefix(req.adapter_id, true_prompt)
        m = len(shared)
        spilled = self._match_spilled_prefix(req.adapter_id, true_prompt, m)
        k = len(spilled)
        priv = self._take_pages(npages - m)
        pages = priv
        if m:
            self._share_pages(shared)
            self.prefix_hits += 1
            self.shared_pages_mapped += m
            pages = np.concatenate([np.asarray(shared, np.int32), priv])
        if k:
            self._restore_pages(self._spilled_blob(spilled), priv[:k])
            for key, _ in spilled:
                self.spill.pop(("prefix", key))
            self.spill_prefix_hits += 1
            self.restored_pages += k
        scatter = pages.copy()
        scatter[:m + k] = TRASH_PAGE
        self.pool = self._paged_write_fn(npages)(
            self.pool, cache, self._dev(slot),
            torch.as_tensor(scatter, dtype=torch.long, device=self.device),
            self._dev(true_len, dtype=torch.int32))
        self._ptab[slot, :npages] = pages
        self._held[slot] = npages
        self._lens[slot] = true_len
        # trim: bucket padding beyond the true length wrote zero pages —
        # release them now (always private: the shared prefix never extends
        # past the prompt); decode growth re-allocates
        keep = self._pages_for(true_len)
        if keep < npages:
            self._release_pages(self._ptab[slot, keep:npages])
            self._ptab[slot, keep:npages] = TRASH_PAGE
            self._held[slot] = keep
        self._register_prefix(req.adapter_id, true_prompt, slot, true_len,
                              cache=cache)
        self._ptab_dirty = True

    def _try_admit_tail(self, req: _PendingJoin, true_prompt: np.ndarray,
                        true_len: int, slot: int, cap: int, aslot: int,
                        max_new_tokens: int, t_adm: float) -> Optional[int]:
        """Chunked shared-prefix admission: when the prompt's leading pages
        are in the arena (registered by a live sharer, or restorable from
        the prefix spill tier), MAP them and prefill only the private tail,
        whose queries attend the mapped prefix (float sidecars, or the int8
        pages dequantized). Returns the slot, or None to fall back to the
        full prefill (nothing shareable, or the tail bucket and the
        restores need more free pages than the arena has right now: the
        admission gate budgeted for the full path)."""
        ps = self.page_size
        shared = self._match_prefix(req.adapter_id, true_prompt)
        spilled = self._match_spilled_prefix(req.adapter_id, true_prompt,
                                             len(shared))
        # always leave >= 1 tail token: the first generated token needs a
        # real last-position forward pass, and the boundary page decode
        # appends into must be recomputed into a PRIVATE copy — a fully
        # registered page-aligned prompt re-prefills its last page
        skip = min(len(shared) + len(spilled), (true_len - 1) // ps)
        if skip < 1:
            return None
        m_eff = min(len(shared), skip)
        k_eff = skip - m_eff
        spilled = spilled[:k_eff]
        tail_len = true_len - skip * ps
        tbucket = self.bucket_for_tail(tail_len)
        npages = self._pages_for(tbucket)
        if len(self._free_pages) < k_eff + npages:
            return None
        # ---- map phase: shared pages ref++, spilled pages written back ----
        shared_eff = np.asarray(shared[:m_eff], np.int32)
        priv_restore = self._take_pages(k_eff)
        priv_tail = self._take_pages(npages)
        self._share_pages(shared_eff)
        if k_eff:
            # the entries are popped only after the numeric-health gate: a
            # quarantined admission must not cost the arena its prefix
            self._restore_pages(self._spilled_blob(spilled), priv_restore)
        prefix_ids = np.full((self._prefix_width,), TRASH_PAGE, np.int32)
        prefix_ids[:m_eff] = shared_eff
        prefix_ids[m_eff:skip] = priv_restore
        # ---- tail-compute phase ----
        tail = true_prompt[skip * ps:]
        if len(tail) < tbucket:
            tail = np.concatenate(
                [tail, np.zeros(tbucket - len(tail), np.int32)])
        perm, inv, blocks = self._prefill_segments(aslot, cap, tbucket)
        dev = self.device
        tokens = torch.as_tensor(tail[None], device=dev)
        tail_t = torch.full((1,), tail_len, dtype=torch.int32, device=dev)
        plen_t = torch.full((1,), skip * ps, dtype=torch.int32, device=dev)
        aidx = torch.full((1,), aslot, dtype=torch.int32, device=dev)
        # the float path when EVERY mapped page still has its sidecar (live
        # pages in _page_float, spilled ones carrying kf/vf); otherwise
        # attend the int8 arena content dequantized
        use_float = (all(int(p) in self._page_float for p in shared_eff)
                     and all("kf" in e.blob[0] for _, e in spilled))
        if use_float:
            # registered pages are immutable, so the mapped page ids fully
            # determine the operand; _release_pages drops an entry the
            # moment any member id frees
            fpkey = tuple(int(x) for x in prefix_ids[:skip])
            prefix_fp = self._prefix_fp_cache.get(fpkey)
            if prefix_fp is None:
                srcs = [self._page_float[int(p)] for p in shared_eff] + \
                    [_spilled_float(e) for _, e in spilled]
                prefix_fp = []
                for i in range(len(srcs[0])):
                    k0 = srcs[0][i]["k"]            # (nper, ps, kv, hd)
                    buf = torch.zeros((2, k0.shape[0], 1,
                                       self._prefix_width * ps)
                                      + tuple(k0.shape[2:]), dtype=k0.dtype)
                    for j, src in enumerate(srcs):
                        buf[0, :, 0, j * ps:(j + 1) * ps] = src[i]["k"]
                        buf[1, :, 0, j * ps:(j + 1) * ps] = src[i]["v"]
                    buf = buf.to(dev)              # one upload per sublayer
                    prefix_fp.append({"k": buf[0], "v": buf[1]})
                while len(self._prefix_fp_cache) >= 32:   # FIFO bound
                    self._prefix_fp_cache.pop(
                        next(iter(self._prefix_fp_cache)))
                self._prefix_fp_cache[fpkey] = prefix_fp
            first, fin, _, cache = self._tail_prefill_fn(
                cap, tbucket, "float")(
                self.fm.params, prefix_fp, tokens, tail_t, plen_t,
                [self._keys[slot]], self.fm.adapters.stacked(), aidx, perm,
                inv, blocks)
        else:
            first, fin, _, cache = self._tail_prefill_fn(
                cap, tbucket, "pages")(
                self.fm.params, self.pool, tokens, tail_t,
                torch.as_tensor(prefix_ids, dtype=torch.long, device=dev),
                plen_t, [self._keys[slot]], self.fm.adapters.stacked(), aidx,
                perm, inv, blocks)
        self.admissions += 1
        self.tail_tokens_computed += tail_len
        self.prefill_tokens_saved += skip * ps
        if req.resume is None:
            self.admitted_log.append((req.rid, req.task_id, true_len,
                                      tail_len))
        fin_ok = bool(fin[0].item())
        if not fin_ok:
            # quarantined tail: roll the map phase back — shared refcounts
            # drop to their pre-join values, restored and tail pages return
            # to the free list (none were registered, so nothing spills
            # again) and the untouched spill entries keep the prefix
            self.quarantines += 1
            self._release_pages(shared_eff)
            self._release_pages(priv_restore)
            self._release_pages(priv_tail)
        else:
            # restored prefix pages take their float sidecars back from the
            # blob, so they keep serving float-mode tails
            for pg, (_, e) in zip(priv_restore, spilled):
                if "kf" in e.blob[0]:
                    self._page_float[int(pg)] = _spilled_float(e)
            for key, _ in spilled:
                self.spill.pop(("prefix", key))
            if k_eff:
                self.spill_prefix_hits += 1
                self.restored_pages += k_eff
            if m_eff:
                self.prefix_hits += 1
                self.shared_pages_mapped += m_eff
            boundary = true_len // ps - skip
            self.pool = self._paged_tail_write_fn(npages)(
                self.pool, cache, self._dev(slot),
                torch.as_tensor(priv_tail, dtype=torch.long, device=dev),
                self._dev(true_len, dtype=torch.int32),
                self._dev(boundary),
                torch.as_tensor(prefix_ids, dtype=torch.long, device=dev),
                self._dev(skip))
            self._ptab[slot, :skip] = prefix_ids[:skip]
            self._ptab[slot, skip:skip + npages] = priv_tail
            self._held[slot] = skip + npages
            self._lens[slot] = true_len
            # trim tail-bucket padding beyond the true length (always
            # private pages; the prefix never extends past the prompt)
            keep = self._pages_for(true_len)
            if keep < skip + npages:
                self._release_pages(self._ptab[slot, keep:skip + npages])
                self._ptab[slot, keep:skip + npages] = TRASH_PAGE
                self._held[slot] = keep
            # a float-mode tail's cache carries the full path's values, so
            # its freshly registered pages earn sidecars of their own; a
            # pages-mode tail carries the prefix's dequantization error and
            # must not seed sidecars future sharers would trust
            self._register_prefix(req.adapter_id, true_prompt, slot,
                                  true_len,
                                  cache=cache if use_float else None,
                                  cache_page0=skip)
            self._ptab_dirty = True
        return self._finish_admission(req, slot, aslot, first, fin_ok,
                                      true_prompt, true_len, max_new_tokens,
                                      t_adm)

    def _finish_admission(self, req: _PendingJoin, slot: int, aslot: int,
                          first, fin_ok: bool, true_prompt: np.ndarray,
                          true_len: int, max_new_tokens: int,
                          t_adm: float) -> int:
        if self.state_pool is not None:
            # strict 1:1 with the decode slot: a double allocation is a
            # lifecycle bug (an exit path did not free), not backpressure
            self.state_pool.alloc(slot)
        self._tokens[slot] = first[0]
        now = time.perf_counter()
        tok0 = int(first[0].item())
        eos = self.eos_id if req.eos_id is None else req.eos_id
        if req.resume is not None:
            # a preempted stream resuming keeps its identity and latency
            # stamps and appends the re-prefill's token. s.prompt stays the
            # ORIGINAL prompt: s.tokens holds everything generated, so a
            # second preemption folds prompt + tokens without duplication
            s = req.resume
            s.tokens.append(tok0)
            s.done = (not fin_ok or len(s.tokens) >= s.max_new
                      or (s.eos_id is not None and tok0 == s.eos_id))
            if not fin_ok:
                s.status = "quarantined"
            self.slots[slot] = s
            # a stale spill entry (free pages or the budget forced the
            # re-prefill) no longer matches the stream once it decodes again
            self._drop_stream_spill(s.rid)
            self.resume_costs.append(("reprefill", now - t_adm))
        else:
            self.slots[slot] = DecodeSlot(
                rid=req.rid, task_id=req.task_id, adapter_slot=aslot,
                max_new=max_new_tokens, eos_id=eos, tokens=[tok0], t_join=now,
                t_first=now, prompt_tokens=true_len, prompt=true_prompt,
                adapter_id=req.adapter_id, deadline=req.deadline,
                status="ok" if fin_ok else "quarantined",
                done=(not fin_ok or max_new_tokens == 1
                      or (eos is not None and tok0 == eos)),
                enc_feats=req.enc_feats)
        self._slot_adapters[slot] = aslot
        self._seg_key = None                    # composition changed
        return slot

    def leave(self, slot: int) -> DecodeSlot:
        """Retire a slot (finished or cancelled) and free it for admission
        (paged: its page references are released)."""
        s = self.slots[slot]
        if s is None:
            raise ValueError(f"slot {slot} is free")
        self.slots[slot] = None
        self._slot_adapters[slot] = FREE
        self._seg_key = None                    # composition changed
        if self.paged:
            self._release_slot_pages(slot)
        if self.state_pool is not None:
            self.state_pool.free(slot)
        # keep the freed slot's cache length bounded while it idles
        for sub in self.pool:
            sub["len"][:, slot] = 0
        return s

    # ---- paged page-pressure handling ----
    def _preempt(self, slot: int):
        """Evict a live stream to reclaim its pages: it re-queues at the
        FRONT of the pending queue with its generated tokens folded into the
        prompt (re-admission re-prefills them, which also refreshes its int8
        scales). With a spill arena its pages, scales, trackers, last token
        and generator state are copied to the host first, and the resume
        writes them back: the same tokens and the same sampling stream as
        a run never preempted. The folded prompt stays the fallback for
        when the budget evicts the entry."""
        s = self.slots[slot]
        if self.spill is not None:
            self._spill_stream(slot, s)
        prompt = np.concatenate([
            np.asarray(s.prompt if s.prompt is not None else [], np.int32),
            np.asarray(s.tokens, np.int32)])
        self.slots[slot] = None
        self._slot_adapters[slot] = FREE
        self._seg_key = None
        self._release_slot_pages(slot)
        if self.state_pool is not None:
            # the re-admission re-prefills the folded prompt against the
            # stored frames, recomputing the same cross state
            self.state_pool.free(slot)
        for sub in self.pool:
            sub["len"][:, slot] = 0
        self.pending.appendleft(_PendingJoin(
            task_id=s.task_id, prompt=prompt, adapter_id=s.adapter_id,
            max_new_tokens=s.max_new, rid=s.rid, eos_id=s.eos_id, resume=s,
            enc_feats=s.enc_feats))
        self.preemptions += 1

    def _ensure_chunk_pages(self):
        """Top every live slot up to ``len + chunk`` tokens of pages before
        the chunk dispatches. When the free list runs dry, preempt the
        youngest live streams (least work redone) until it doesn't; a single
        stream that cannot fit is a configuration error."""
        while True:
            live = [i for i, s in enumerate(self.slots)
                    if s is not None and not s.done]
            preempted = False
            for i in live:
                if self.slots[i] is None:       # preempted by an earlier pass
                    continue
                need = self._pages_for(self._lens[i]
                                       + self._headroom_tokens()) \
                    - self._held[i]
                if need <= 0:
                    continue
                while need > len(self._free_pages):
                    victims = [j for j in live
                               if j != i and self.slots[j] is not None
                               and not self.slots[j].done]
                    if not victims:
                        raise RuntimeError(
                            f"paged pool exhausted: {need} pages needed for "
                            f"one stream, {len(self._free_pages)} free and "
                            f"nothing left to preempt (total_pages="
                            f"{self.total_pages} is too small)")
                    self._preempt(min(
                        victims, key=lambda j: len(self.slots[j].tokens)))
                    preempted = True
                pages = self._take_pages(need)
                h = self._held[i]
                self._ptab[i, h:h + need] = pages
                self._held[i] = h + need
                self._ptab_dirty = True
            if not preempted:
                return

    def _never_fits(self, req: _PendingJoin) -> bool:
        """True when the request cannot be admitted even into an EMPTY
        arena, counting the pages its prefix currently shares."""
        plen = self.bucket_for_prompt(min(max(len(req.prompt), 1),
                                          self.prompt_len))
        m = len(self._match_prefix(req.adapter_id, req.prompt))
        return (self._pages_for(self._adm_s_max(plen)) - m
                + self._pages_for(self._headroom_tokens())) \
            > self.total_pages - 1

    def _viable_pending(self) -> list[int]:
        """Pending indices that could fit the arena at its CURRENT sharing
        state. A deferred join admitted on a prefix discount whose sharer
        has since retired is STRANDED: it stays queued (a later admission
        re-registering its prefix would unstrand it) but is invisible to
        the drain and exempt from the head-of-line fairness cap."""
        return [i for i, r in enumerate(self.pending)
                if not self._never_fits(r)]

    def _spill_resume_need(self, req: _PendingJoin) -> Optional[int]:
        """Free pages a resume from its stream spill needs, or None when no
        usable entry exists (nothing spilled, evicted, or it could never fit
        an empty arena: the gate then prices the re-prefill). A spill resume
        restores the TRUE page count held at preemption, which can exceed
        the re-prefill bucket's estimate."""
        if self.spill is None or req.resume is None:
            return None
        entry = self.spill.peek(("stream", req.rid))
        if entry is None:
            return None
        n = int(entry.meta["n_pages"])
        hr = self._pages_for(self._headroom_tokens())
        if n + hr > self.total_pages - 1:
            return None
        return n + hr + self._imminent_page_need()

    def _next_admissible_pending(self) -> Optional[int]:
        """Index of the next deferred join the pool can take: the (viable)
        head, or — bounded lookahead — a smaller prompt within
        ``pending_lookahead`` viable entries of it whose pages ARE free
        while the head's are not. After ``hol_skip_cap`` consecutive
        bypasses the window collapses to the head alone until it admits."""
        if not self.pending or not self.free_slots():
            return None
        viable = self._viable_pending()
        window = 1 if self._hol_skips >= self.hol_skip_cap else \
            self.pending_lookahead
        for idx in viable[:window]:
            req = self.pending[idx]
            need = self._admission_need(len(req.prompt), prompt=req.prompt,
                                        adapter_id=req.adapter_id)
            spill_need = self._spill_resume_need(req)
            if spill_need is not None:
                # both resume paths must fit: the spill restore (its true
                # page count) and the re-prefill it falls back to on a
                # digest mismatch found at restore time
                need = max(need, spill_need)
            if len(self._free_pages) >= need:
                return idx
        return None

    def _drain_pending(self):
        """Admit deferred joins while slots and pages allow — FIFO with the
        bounded skip-ahead of ``_next_admissible_pending``. Bypassing a
        stranded entry never consumes the fairness budget."""
        while True:
            idx = self._next_admissible_pending()
            if idx is None:
                return
            req = self.pending[idx]
            bypassed_viable = any(not self._never_fits(self.pending[i])
                                  for i in range(idx))
            del self.pending[idx]
            if bypassed_viable:
                self._hol_skips += 1
                self.hol_bypasses += 1
            else:
                self._hol_skips = 0
            self._admit_now(req)

    # ---- failure semantics: deadlines, cancellation, terminal rejection ----
    def _reject_pending(self, p: _PendingJoin, status: str):
        p.status = status
        if p.resume is not None:
            p.resume.status = status
            p.resume.done = True
            self._drop_stream_spill(p.rid)
        self.rejected.append(p)

    def _expire_deadlines(self, now: float):
        """Live slots past their deadline are marked done
        (``deadline_cancelled``) and retire with their partial tokens;
        expired pending entries are terminally rejected — ``deadline_shed``
        if never admitted, ``deadline_cancelled`` for a preempted resume,
        ``rejected_stranded`` when the entry is stranded."""
        for s in self.slots:
            if s is not None and not s.done and s.deadline < now:
                s.done = True
                s.status = "deadline_cancelled"
                self.deadline_cancels += 1
        if not self.pending:
            return
        keep: collections.deque = collections.deque()
        for p in self.pending:
            if p.deadline >= now:
                keep.append(p)
            elif self._never_fits(p):
                self._reject_pending(p, "rejected_stranded")
                self.stranded_rejections += 1
            elif p.resume is not None:
                self._reject_pending(p, "deadline_cancelled")
                self.deadline_cancels += 1
            else:
                self._reject_pending(p, "deadline_shed")
                self.deadline_sheds += 1
        if len(keep) != len(self.pending):
            self.pending = keep

    def cancel(self, rid: int):
        """Client-cancel one stream by rid wherever it lives:
        ``("slot", DecodeSlot)`` for a live stream (retired through
        ``leave``: page references released), ``("pending", _PendingJoin)``
        for a deferred or preempted entry (popped; a preempted resume's
        pages were freed at preemption), ``None`` when the rid is not in
        the engine."""
        for i, s in enumerate(self.slots):
            if s is not None and s.rid == rid:
                s.done = True
                s.status = "cancelled"
                self.cancels += 1
                return ("slot", self.leave(i))
        for i, p in enumerate(self.pending):
            if p.rid == rid:
                del self.pending[i]
                p.status = "cancelled"
                if p.resume is not None:
                    p.resume.status = "cancelled"
                    p.resume.done = True
                    self._drop_stream_spill(p.rid)
                self.cancels += 1
                return ("pending", p)
        return None

    def shed_stranded(self) -> int:
        """Terminally reject every stranded pending entry (regardless of
        deadline) into ``rejected`` — the serve loop's way out when the
        engine would otherwise wedge. Returns the count."""
        if not self.paged:
            return 0
        keep: collections.deque = collections.deque()
        n = 0
        for p in self.pending:
            if self._never_fits(p):
                self._reject_pending(p, "rejected_stranded")
                self.stranded_rejections += 1
                n += 1
            else:
                keep.append(p)
        if n:
            self.pending = keep
        return n

    def take_rejected(self) -> list[_PendingJoin]:
        out, self.rejected = self.rejected, []
        return out

    def take_admitted(self) -> list[tuple[int, str, int, int]]:
        """Drain the (rid, task_id, true_prompt_len, tail_tokens) log — the
        serve loop charges prompt tokens from here, at actual admission."""
        out, self.admitted_log = self.admitted_log, []
        return out

    def take_decode_charges(self) -> dict:
        """Drain the committed-decode-token log, keyed ``(task_id, rid)``."""
        out = dict(self._decode_charges)
        self._decode_charges = collections.Counter()
        return out

    def _raise_if_wedged(self):
        """Nothing live, nothing viable, stranded joins pending: no future
        engine event can admit them, so drain() and the serve loop would
        spin forever. Raise instead."""
        if self.pending and self.active_count() == 0 \
                and not self._viable_pending():
            raise EngineWedged(
                f"{len(self.pending)} deferred prompt(s) no longer fit the "
                f"arena ({self.total_pages - 1} usable pages) — the shared "
                f"prefix they were admitted against was released and "
                f"nothing is left to free; raise total_pages or shrink "
                f"prompt_buckets/chunk")

    # ---- deadline overrun clamp ----
    def chunk_ladder(self) -> tuple[int, ...]:
        """The only chunk lengths the clamp dispatches: full, half, one."""
        return tuple(sorted({self.chunk, max(1, self.chunk // 2), 1},
                            reverse=True))

    def _effective_chunk(self, live: list[int], now: float) -> int:
        """Shrink the chunk to a ladder length when the nearest live deadline
        is closer than a full chunk (measured against the per-step EMA)."""
        if not self.deadline_clamp or self._step_ema <= 0.0:
            return self.chunk
        tight = min((self.slots[i].deadline for i in live), default=float("inf"))
        if tight == float("inf"):
            return self.chunk
        room = max(1, int(np.ceil((tight - now) / self._step_ema)))
        if room >= self.chunk:
            return self.chunk
        self.deadline_clamps += 1
        return next((c for c in self.chunk_ladder() if c <= room), 1)

    def warm_decode_ladder(self):
        """Dispatch every ladder chunk length twice against the idle pool
        (eager, then captured), so the deadline clamp adds no shape key and
        no capture mid-measurement. The garbage rows land in the trash page
        (paged) or in regions the next admission overwrites (dense)."""
        if self.active_count():
            raise RuntimeError("warm_decode_ladder must run on an idle engine")
        if self.paged:
            self._sync_page_table()
        cap = self.fm.adapters.capacity()
        perm, inv, blocks = self._segments(cap)
        adapters = torch.as_tensor(self._slot_adapters, device=self.device)
        for c in self.chunk_ladder():
            for _ in range(2):
                self.pool, self._tokens, _, _, _, _ = self._decode_fn(cap, c)(
                    self.fm.params, self.pool, self._tokens, self._keys,
                    self.fm.adapters.stacked(), adapters, perm, inv, blocks)

    def warm_chunked(self):
        """Run the chunked-admission planes twice, eager then captured (one
        tail prefill per mode and one tail-page scatter per tail bucket), so
        sharer joins add no shape key and no capture in steady state,
        whatever tail length they arrive with.
        The warm prefill attends only a masked-out prefix (zeros, or the
        trash page) and its outputs are discarded; it samples with a scratch
        generator, so no slot's generator advances and a warmed engine
        samples exactly as an unwarmed one. The warm scatter targets the
        trash page at slot 0 with a zero length (the idle-engine garbage
        contract of ``warm_decode_ladder``)."""
        if self.active_count():
            raise RuntimeError("warm_chunked must run on an idle engine")
        if not (self.paged and self.chunked_prefill):
            return
        cap = self.fm.adapters.capacity()
        aslot = self.fm.adapters.index(None)
        dev, ps = self.device, self.page_size
        prefix_ids = torch.full((self._prefix_width,), TRASH_PAGE,
                                dtype=torch.long, device=dev)
        # a zero float-prefix operand at the one shape every float-mode tail
        # call uses, in the sidecars' dtype
        warm_fp = [{"k": c["k"], "v": c["v"]}
                   for c, p in zip(lm.init_cache(
                       self.cfg, 1, self._prefix_width * ps, kv_quant=False,
                       device=dev), self.pool)
                   if "page_table" in p]
        zero = torch.zeros((1,), dtype=torch.int32, device=dev)
        aidx = torch.full((1,), aslot, dtype=torch.int32, device=dev)
        scratch = [torch.Generator(device=dev).manual_seed(0)]
        slot0, zero_l = self._dev(0), self._dev(0)
        for tb in self.tail_buckets:
            perm, inv, blocks = self._prefill_segments(aslot, cap, tb)
            tokens = torch.zeros((1, tb), dtype=torch.int32, device=dev)
            tail_t = torch.full((1,), tb, dtype=torch.int32, device=dev)
            npages = self._pages_for(tb)
            cache = lm.init_cache(self.cfg, 1, npages * ps, kv_quant=False,
                                  device=dev)
            for _ in range(2):
                self._tail_prefill_fn(cap, tb, "float")(
                    self.fm.params, warm_fp, tokens, tail_t, zero, scratch,
                    self.fm.adapters.stacked(), aidx, perm, inv, blocks)
                self._tail_prefill_fn(cap, tb, "pages")(
                    self.fm.params, self.pool, tokens, tail_t, prefix_ids,
                    zero, scratch, self.fm.adapters.stacked(), aidx, perm,
                    inv, blocks)
                self.pool = self._paged_tail_write_fn(npages)(
                    self.pool, cache, slot0,
                    torch.full((npages,), TRASH_PAGE, dtype=torch.long,
                               device=dev), zero, self._dev(-1), prefix_ids,
                    zero_l)

    def warm_speculative(self):
        """Dispatch the speculative executable of every ladder chunk length
        twice against the idle pool (eager, then captured), so spec/plain
        flips, probes and deadline clamps add no shape key and no capture
        in steady state. The idle-engine garbage contract of
        ``warm_decode_ladder``: every history is empty (the drafter proposes
        nothing), so each step commits one token, into the trash page."""
        if self.active_count():
            raise RuntimeError("warm_speculative must run on an idle engine")
        if self.spec_k <= 0 or not self.paged:
            return
        self._sync_page_table()
        cap = self.fm.adapters.capacity()
        perm, inv, blocks = self._spec_segments(cap)
        adapters = torch.as_tensor(self._slot_adapters, device=self.device)
        hist = torch.zeros((self.num_slots, self._spec_hist_len + 1),
                           dtype=torch.int32, device=self.device)
        hlen = torch.zeros((self.num_slots,), dtype=torch.int32,
                           device=self.device)
        for c in self.chunk_ladder():
            for _ in range(2):
                self.pool, self._tokens, *_ = self._spec_decode_fn(cap, c)(
                    self.fm.params, self.pool, self._tokens, self._keys,
                    hist, hlen, [self._ptab_dev, self._ptab_spec],
                    self.fm.adapters.stacked(), adapters, perm, inv, blocks)

    def warm_spill(self):
        """Run the spill tier's gather and write-backs twice (eager, then
        captured) so spills, spilled-prefix restores and spill resumes add
        no shape key and no capture in steady state. The round trip is a
        no-op: an empty capture reads only the trash page (garbage by
        contract), the write-back puts zeros into it, and slot 0's running
        state is written back to itself."""
        if self.active_count():
            raise RuntimeError("warm_spill must run on an idle engine")
        if self.spill is None or not self.paged:
            return
        none_ = np.empty((0,), np.int32)
        for _ in range(2):
            blob = self._capture_pages(none_, 0)
            self._restore_pages(blob, none_)
            state = [{k: torch.as_tensor(sub[k], device=self.device)
                      for k in SLOT_KEYS} for sub in blob]
            self.pool = self._slot_restore_fn()(
                self.pool, state, self._dev(0),
                self._dev(int(self._lens[0]), dtype=torch.int32))

    def step_chunk(self) -> list[DecodeSlot]:
        """Advance every occupied slot by up to ``chunk`` tokens; retire and
        return the slots that finished. Paged: streams already done retire
        FIRST (their pages fund deferred admissions and spare a live stream
        from preemption), then deferred admissions drain into the freed
        capacity, then live slots top up with pages for the chunk and the
        page table syncs. Entered with nothing occupied and only STRANDED
        deferred joins left, raises ``EngineWedged`` — checked on entry so
        the call that retires the last live stream still returns it.
        Deadlines are enforced first."""
        t0 = time.perf_counter()
        self._expire_deadlines(t0)
        if self.paged:
            self._raise_if_wedged()
        retired = [self.leave(i) for i, s in enumerate(self.slots)
                   if s is not None and s.done]
        if self.paged:
            self._drain_pending()
        live = [i for i, s in enumerate(self.slots)
                if s is not None and not s.done]
        if live and self.paged:
            self._ensure_chunk_pages()
            # preemption may have evicted members of the live set
            live = [i for i, s in enumerate(self.slots)
                    if s is not None and not s.done]
        finished = []
        if live:
            if self.paged:
                self._sync_page_table()
            eff = self._effective_chunk(live, t0)
            cap = self.fm.adapters.capacity()
            use_spec = self._spec_dispatch_now()
            if use_spec and self._spec_probe:
                eff = 1     # probes are single-step (_spec_dispatch_now)
            adapters = torch.as_tensor(self._slot_adapters, device=self.device)
            t_disp = time.perf_counter()
            if use_spec:
                perm, inv, blocks = self._spec_segments(cap)
                hist, hlen = self._spec_history()
                self.pool, self._tokens, _, out_g, out_m, out_p, drift, fin = \
                    self._spec_decode_fn(cap, eff)(
                        self.fm.params, self.pool, self._tokens, self._keys,
                        hist, hlen, [self._ptab_dev, self._ptab_spec],
                        self.fm.adapters.stacked(), adapters, perm, inv,
                        blocks)
                T = self.spec_k + 1
                parts = [out_g.reshape(self.num_slots, eff * T), out_m, out_p]
            else:
                perm, inv, blocks = self._segments(cap)
                self.pool, self._tokens, _, out, drift, fin = \
                    self._decode_fn(cap, eff)(
                        self.fm.params, self.pool, self._tokens, self._keys,
                        self.fm.adapters.stacked(), adapters, perm, inv,
                        blocks)
                parts = [out]
            # one host sync per chunk: tokens (speculative: candidates,
            # commits and proposals), finite and drift flags
            host = torch.cat([x.to(torch.int32) for x in parts]
                             + [fin[:, None].to(torch.int32),
                                drift[:, None].to(torch.int32)],
                             dim=1).cpu().numpy()
            fin, drift = host[:, -2] != 0, host[:, -1] != 0
            if use_spec:
                out_g = host[:, :eff * T].reshape(self.num_slots, eff, T)
                out_m = host[:, eff * T:eff * (T + 1)]
                out_p = host[:, eff * (T + 1):eff * (T + 2)]
            else:
                out = host[:, :eff]
            # per scan step: the deadline clamp reasons in steps either way,
            # and a speculative step's extra verify cost is what it must learn
            dt = (time.perf_counter() - t_disp) / eff
            self._step_ema = dt if self._step_ema == 0.0 \
                else 0.5 * self._step_ema + 0.5 * dt
            self.steps += eff
            if self.paged:
                for i, s in enumerate(self.slots):
                    if s is not None:
                        self._lens[i] += int(out_m[i].sum()) if use_spec \
                            else eff
            for i in live:
                s = self.slots[i]
                if use_spec:
                    committed = [int(t) for st in range(eff)
                                 for t in out_g[i, st, :out_m[i, st]]]
                    prop = int(out_p[i].sum())
                    self.spec_commits += len(committed)
                    self.draft_proposed += prop
                    self.draft_accepted += len(committed) - eff
                    ts = self._spec_task_stats.setdefault(s.task_id, [0, 0])
                    ts[0] += prop
                    ts[1] += len(committed) - eff
                else:
                    committed = [int(t) for t in out[i]]
                # fair-share accounting charges the tokens COMMITTED for the
                # stream (accepted + corrected), not chunk x slots
                self._decode_charges[(s.task_id, s.rid)] += len(committed)
                take = min(len(committed), s.max_new - len(s.tokens))
                for t in committed[:take]:
                    s.tokens.append(t)
                    if s.eos_id is not None and t == s.eos_id:
                        break
                # quarantine check only for LIVE slots: a free slot's garbage
                # row may legitimately go non-finite
                if not fin[i]:
                    s.done = True
                    s.status = "quarantined"
                    self.quarantines += 1
                    finished.append(i)
                elif len(s.tokens) >= s.max_new or (
                        s.eos_id is not None and s.tokens[-1] == s.eos_id):
                    s.done = True
                    finished.append(i)
            if use_spec:
                self.spec_dispatches += 1
                rate = sum(int(out_m[i].sum()) for i in live) \
                    / max(eff * len(live), 1)
                self._spec_accept_ema = rate if self._spec_accept_ema == 0.0 \
                    else 0.5 * self._spec_accept_ema + 0.5 * rate
                if self._spec_probe:
                    # a dry probe (1.0 committed a slot-step: nothing
                    # accepted) backs off; any accept restores the base
                    # cadence and lets the EMA drive re-promotion
                    self._spec_probe_interval = min(
                        self._spec_probe_interval * 2,
                        self.spec_probe_every * 16) if rate <= 1.0 \
                        else self.spec_probe_every
            self._maybe_refresh_scales(drift)
        retired += [self.leave(i) for i in finished]
        self.last_chunk_s = time.perf_counter() - t0
        return retired

    def drain(self) -> list[DecodeSlot]:
        """Step until every occupied slot retires (and, paged, every deferred
        admission has been served)."""
        out = []
        while self.active_count() or self.pending:
            out += self.step_chunk()
        return out

    # ---- engine snapshot / restore (durability plane) ----
    _COUNTERS = ("steps", "admissions", "deferrals", "preemptions",
                 "prefix_hits", "shared_pages_mapped", "scale_refreshes",
                 "hol_bypasses", "_hol_skips", "quarantines",
                 "deadline_cancels", "deadline_sheds", "stranded_rejections",
                 "cancels", "spilled_pages", "restored_pages",
                 "digest_failures", "spill_resumes", "spill_prefix_hits",
                 "deadline_clamps", "tail_tokens_computed",
                 "prefill_tokens_saved", "draft_proposed", "draft_accepted",
                 "spec_dispatches", "spec_commits", "spec_fallbacks")
    _EXECUTABLES = ("_fn_prefill", "_fn_decode", "_fn_write", "_fn_rescale",
                    "_fn_gather", "_fn_page_restore", "_fn_slot_restore")

    def _config_dict(self) -> dict:
        """Constructor kwargs that rebuild an identical engine."""
        return {
            "num_slots": self.num_slots, "max_new": self.max_new,
            "chunk": self.chunk, "kv_quant": self.kv_quant,
            "eos_id": self.eos_id, "prompt_buckets": self.prompt_buckets,
            "temperature": self.temperature, "top_k": self.top_k,
            "paged": True, "page_size": self.page_size,
            "total_pages": self.total_pages,
            "prefix_sharing": self.prefix_sharing,
            "scale_refresh": self.scale_refresh,
            "pending_lookahead": self.pending_lookahead,
            "hol_skip_cap": self.hol_skip_cap,
            "deadline_clamp": self.deadline_clamp,
            "chunked_prefill": self.chunked_prefill,
            "spec_k": self.spec_k,
            "spec_force_fill": self.spec_force_fill,
            "spec_disable_below": self.spec_disable_below,
            "spec_probe_every": self.spec_probe_every,
            "enc_len": self.enc_len,
        }

    def snapshot(self) -> EngineSnapshot:
        """The engine's whole logical state between chunks: the used pages'
        contents (copied to the host) with one sha256 digest per page, page
        tables, refcounts, the prefix registry, per-slot sampling,
        generator and deadline state, the pending queue and the counters.
        Deep copies: the live engine can keep running. The spill arena
        rides by reference (it is host RAM already). Paged pools only: the
        dense layout has no allocator state worth surviving a reset."""
        import copy
        if not self.paged:
            raise ValueError("snapshot/restore is a paged-arena feature")
        used = np.nonzero(self._page_refs > 0)[0].astype(np.int32)
        idx = torch.as_tensor(used.astype(np.int64), device=self.device)
        pages, slot_state = [], []
        for sub in self._paged_subs():
            pages.append({k: _host(sub[k].index_select(1, idx))
                          for k in PAGE_KEYS})
            slot_state.append({k: _host(sub[k]) for k in SLOT_KEYS})
        snap = EngineSnapshot(
            config=self._config_dict(),
            used_pages=used, pages=pages, page_digests={},
            slot_state=slot_state,
            ptab=self._ptab.copy(), held=self._held.copy(),
            lens=self._lens.copy(), page_refs=self._page_refs.copy(),
            slot_adapters=self._slot_adapters.copy(),
            tokens=_host(self._tokens),
            keys=np.stack([g.get_state().numpy() for g in self._keys]),
            slots=copy.deepcopy(self.slots),
            pending=copy.deepcopy(list(self.pending)),
            rejected=copy.deepcopy(self.rejected),
            registry=dict(self._prefix_registry),
            page_key=dict(self._page_key),
            counters={k: getattr(self, k) for k in self._COUNTERS},
            spill=self.spill,
            # fixed-size per-slot state (whisper's cross K/V): the page
            # capture above covers the paged arena only
            dense_state=capture_dense_state(self.pool)
            if self.plan.needs_state_slots else None)
        snap.counters["admitted_log"] = list(self.admitted_log)
        snap.page_digests = {int(p): snap.page_digest(i)
                             for i, p in enumerate(used)}
        return snap

    @classmethod
    def restore(cls, fm: PhysicalFM, snap: EngineSnapshot, *,
                reuse_jits_from: Optional["DecodeEngine"] = None
                ) -> "DecodeEngine":
        """An engine rebuilt from a snapshot. Every page's sha256 is
        recomputed and checked BEFORE any stream can decode against it: a
        corrupted page leaves the registry and every live stream mapping it
        re-queues through the fold-and-re-prefill path (``digest_failures``
        counted), with the spill capture suppressed, since the content it
        would copy is exactly what failed.

        ``reuse_jits_from``: the dead engine of the same configuration on
        the same FM (an in-process restore after a device reset). The new
        engine shares its executables and adopts the tensors they bake —
        the pool, the device page table, the token buffer, whisper's
        ``ck``/``cv`` — and rewrites every element of them in place from
        the snapshot (zeros outside the used pages), so every storage check
        passes, ``compile_count`` stays and nothing is captured again. No
        second pool is allocated. Without it (a restore from disk), a fresh
        pool and fresh executables are built."""
        import copy
        reuse = (reuse_jits_from is not None
                 and reuse_jits_from._config_dict() == snap.config
                 and reuse_jits_from.fm is fm)
        eng = cls(fm, **snap.config,
                  _adopt=reuse_jits_from if reuse else None)
        if reuse:
            for name in cls._EXECUTABLES:
                setattr(eng, name, getattr(reuse_jits_from, name))
        used = np.asarray(snap.used_pages)
        bad = [int(p) for i, p in enumerate(used)
               if snap.page_digest(i) != snap.page_digests[int(p)]]
        idx = torch.as_tensor(used.astype(np.int64), device=eng.device)
        for j, sub in enumerate(eng._paged_subs()):
            cap, st = snap.pages[j], snap.slot_state[j]
            for k in PAGE_KEYS:
                _fill_pages(sub[k], idx, eng._upload(cap[k]))
            for k in SLOT_KEYS:
                sub[k].copy_(torch.from_numpy(np.asarray(st[k])))
            sub["len"].copy_(torch.from_numpy(
                np.asarray(snap.lens, np.int32))[None].expand_as(sub["len"]))
        eng._ptab = snap.ptab.copy()
        eng._held = snap.held.copy()
        eng._lens = snap.lens.copy()
        eng._page_refs = snap.page_refs.copy()
        eng._free_pages = [p for p in range(eng.total_pages - 1, TRASH_PAGE,
                                            -1) if eng._page_refs[p] == 0]
        eng._prefix_registry = dict(snap.registry)
        eng._page_key = dict(snap.page_key)
        eng._ptab_dirty = True
        eng._sync_page_table()
        eng._slot_adapters = snap.slot_adapters.copy()
        eng._seg_key = None
        eng._tokens.copy_(torch.from_numpy(np.asarray(snap.tokens)))
        for g, state in zip(eng._keys, np.asarray(snap.keys)):
            g.set_state(torch.from_numpy(state.copy()))
        eng.slots = copy.deepcopy(snap.slots)
        eng.pending = collections.deque(copy.deepcopy(snap.pending))
        eng.rejected = copy.deepcopy(snap.rejected)
        if snap.dense_state is not None:
            restore_dense_state(eng.pool, snap.dense_state)
        if eng.state_pool is not None:
            # live slots are marked BEFORE the bad-page requeue below: its
            # _preempt frees the victim's state slot
            for i, s in enumerate(eng.slots):
                if s is not None:
                    eng.state_pool.alloc(i)
        counters = dict(snap.counters)
        eng.admitted_log = [tuple(x) for x in
                            counters.pop("admitted_log", [])]
        for k in cls._COUNTERS:
            setattr(eng, k, counters.get(k, getattr(eng, k)))
        if snap.spill is not None:
            eng.spill = snap.spill
        for p in bad:
            eng.digest_failures += 1
            key = eng._page_key.pop(p, None)
            if key is not None:
                eng._prefix_registry.pop(key, None)
        if bad:
            badset = set(bad)
            for i, s in enumerate(eng.slots):
                if s is None or s.done:
                    continue
                if badset & {int(x) for x in eng._ptab[i, :eng._held[i]]}:
                    sp, eng.spill = eng.spill, None
                    try:
                        eng._preempt(i)
                    finally:
                        eng.spill = sp
        return eng


def _fill_pages(t: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor):
    """Rewrite one arena tensor IN PLACE from a snapshot: zeros everywhere
    (as a fresh pool holds), then the used pages' content (axis 1)."""
    t.zero_()
    if idx.numel():
        t.index_copy_(1, idx, vals)


def _set_slot(psub, slot, slot_ks, slot_vs, true_len):
    """An admission's per-slot entries of one paged sublayer, in place:
    the running scales (``slot_ks``/``slot_vs`` (nper, kv)), the drift
    trackers reset, ``len`` set to ``true_len``; ``slot`` and ``true_len``
    are (1,) device tensors."""
    psub["slot_k_scale"].index_copy_(1, slot, slot_ks[:, None])
    psub["slot_v_scale"].index_copy_(1, slot, slot_vs[:, None])
    psub["k_max"].index_fill_(1, slot, 0.0)
    psub["v_max"].index_fill_(1, slot, 0.0)
    psub["len"].index_copy_(1, slot, true_len.to(psub["len"].dtype).expand(
        psub["len"].shape[0], 1))


def _spilled_float(entry) -> list:
    """A spilled prefix page's float sidecar (per sublayer group), back
    from its int16 bit patterns."""
    return [{"k": torch.from_numpy(np.ascontiguousarray(sub["kf"]))
             .view(torch.bfloat16),
             "v": torch.from_numpy(np.ascontiguousarray(sub["vf"]))
             .view(torch.bfloat16)} for sub in entry.blob]


def _host(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``t`` that no later executable call overwrites
    (on the CPU ``.cpu()`` would return the executable's own buffer)."""
    return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()


def quantize_pages(x, scale):
    """Pages of float K or V (nper, npages, ps, kv, hd) into int8 codes at
    their per-(page, kv-head) ``scale`` (nper, npages, kv); an empty page's
    zero scale is guarded by 1e-12 (its codes are 0)."""
    return torch.clamp(torch.round(
        x / torch.clamp(scale, min=1e-12)[:, :, None, :, None]),
        -127, 127).to(torch.int8)

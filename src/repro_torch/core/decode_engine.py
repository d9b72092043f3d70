"""Continuous-batching decode engine over a persistent dense int8 KV pool.

Autoregressive serving is where FMplex's co-location wins compound: every
decode step re-uses the shared backbone across all co-resident tasks, so the
per-step cost of multi-task isolation must be ~zero. The engine owns:

  * a **slot pool** — a fixed, bucketed number of decode slots backed by one
    persistent KV cache allocated ONCE (``lm.init_cache(kv_quant=True)``):
    one contiguous ``(num_slots, s_max)`` int8 region per slot with
    per-(slot, kv-head) scales fixed at prefill admission. Every stream
    reserves its worst-case length, so the slot count caps colocation.
    Decode attention reads it through the int8 flash-decode kernel
    (``kernels.ops.decode_attention_int8``).
  * **variable-length bucketed admission** — a prompt is right-padded to the
    smallest prompt-length bucket holding it (the bucket is a static shape
    key; the true length masks pads out of attention and the cache), then
    scattered into a free slot, producing the first token.
  * **chunked decode** — ``step_chunk`` advances every slot ``chunk`` steps
    (free slots step too, on garbage that the next admission overwrites;
    their adapter id is the "no adapter" sentinel), with the q/v LoRA
    deltas of the co-batched tasks through the segmented (SGMV) kernel. The
    segment metadata is built once per slot *composition* and reused by
    every step and every layer.
  * **static shapes** — prefill is keyed on (adapter cap, prompt bucket),
    decode on (slots, adapter cap, chunk): ``compile_count`` counts the
    distinct keys, and steady-state churn must not add any.
  * **failure semantics** — per-stream non-finite logits quarantine only
    that stream; deadlines cancel live streams at chunk entry (with the
    chunk clamped to a small ladder when a deadline is nearer than a full
    chunk); ``cancel`` unwinds a stream by rid.

This slice ports the dense pool only. The paged pool (and with it prefix
sharing, chunked prefill and preemption), speculative decoding, the
host-RAM spill tier, snapshot/restore and encoder-decoder admission come
with later slices and raise ``NotImplementedError`` here.
"""
from __future__ import annotations

import collections
import dataclasses
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.cache_manager import CachePlan
from repro_torch.core.physical import PAD_SENTINEL, PhysicalFM, bucket_for, seg_to_device
from repro_torch.models import lm

FREE = PAD_SENTINEL   # free-slot adapter sentinel (same as run_batch padding)


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


@dataclasses.dataclass
class _PendingJoin:
    """One admission request (the dense pool admits at once or raises)."""
    task_id: str
    prompt: np.ndarray
    adapter_id: Optional[str]
    max_new_tokens: int
    rid: int
    eos_id: Optional[int]
    deadline: float = float("inf")
    status: str = "ok"


class DecodeEngine:
    """Slot-based continuous-batching token server bound to one PhysicalFM."""

    def __init__(self, fm: PhysicalFM, *, num_slots: int = 8,
                 prompt_len: Optional[int] = None, max_new: int = 32,
                 chunk: int = 4, kv_quant: bool = True,
                 eos_id: Optional[int] = None,
                 prompt_buckets: Optional[tuple] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 sample_seed: int = 0, paged: bool = False,
                 spill_bytes: int = 0, deadline_clamp: bool = True,
                 spec_k: int = 0):
        cfg = fm.cfg
        if cfg.vocab_size <= 0 or cfg.is_representation:
            raise ValueError("DecodeEngine serves generative decoder LMs "
                             "(vocab head required)")
        if paged:
            raise NotImplementedError(
                "paged=True: the paged int8 pool (page allocator, prefix "
                "sharing, chunked prefill, paged decode kernel K4) comes "
                "with a later slice of the port")
        if spec_k > 0:
            raise NotImplementedError("spec_k > 0: speculative decoding comes "
                                      "with a later slice of the port")
        if spill_bytes > 0:
            raise NotImplementedError("spill_bytes > 0: the host-RAM spill "
                                      "tier comes with a later slice of the port")
        self.fm = fm
        self.cfg = cfg
        self.device = fm.device
        self.num_slots = bucket_for(num_slots)
        self.plan = CachePlan.for_config(cfg, paged=False)
        if self.plan.needs_state_slots:
            raise NotImplementedError("per-slot recurrent / cross-attention "
                                      "state comes with a later slice")
        self.paged = False
        self.impl = fm.lora_impl
        self.prompt_len = prompt_len or fm.input_len
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
        # the persistent pool: allocated once, updated in place
        self.pool = lm.init_cache(cfg, self.num_slots, self.s_max,
                                  kv_quant=kv_quant, device=self.device)
        self.pending: collections.deque = collections.deque()  # never fills
        self._tokens = torch.zeros((self.num_slots,), dtype=torch.int32,
                                   device=self.device)          # last token/slot
        self.slots: list[Optional[DecodeSlot]] = [None] * self.num_slots
        self._slot_adapters = np.full((self.num_slots,), FREE, np.int32)
        self._fn_prefill: dict[tuple, Callable] = {}
        self._fn_decode: dict[tuple, Callable] = {}
        self._fn_write: dict = {}
        self._seg_key = None        # composition signature of cached metadata
        self._seg_dev = None        # device-uploaded (perm, inv, blocks)
        self.steps = 0              # decode steps executed (all slots)
        self.last_chunk_s = 0.0
        self.rejected: list[_PendingJoin] = []   # terminally rejected joins
        # (rid, task, true_prompt_len, tail_tokens): the dense pool always
        # prefills the whole prompt, so tail == true length
        self.admitted_log: list[tuple[int, str, int, int]] = []
        self.admissions = 0
        self.quarantines = 0
        self.deadline_cancels = 0
        self.cancels = 0
        self.deadline_clamp = bool(deadline_clamp)
        self._step_ema = 0.0
        self.deadline_clamps = 0
        self._decode_charges: collections.Counter = collections.Counter()

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
        """Distinct static-shape keys of prefill, decode and pool writes;
        steady state across join/leave churn must not grow this."""
        return len(self._fn_prefill) + len(self._fn_decode) + len(self._fn_write)

    def can_admit(self, prompt_tokens: Optional[int] = None, *, prompt=None,
                  adapter_id: Optional[str] = None) -> bool:
        """Would an admission proceed right now? Dense pool: a free slot."""
        return bool(self.free_slots())

    # ---- static-shape planes ----
    def _seg(self, impl, perm, inv, blocks):
        if impl != "segmented":
            return None
        return {"perm": perm, "inv": inv, "block_adapter": blocks,
                "block_t": self.fm.seg_block_t}

    def _prefill_fn(self, cap: int, plen: int):
        """Admission prefill for one prompt-length bucket: a one-row cache of
        the pool's length, filled and quantized per (row, kv head)."""
        key = (cap, plen)
        if key not in self._fn_prefill:
            cfg, impl, sample = self.cfg, self.impl, self._sample
            s_max, kvq, dev = self.s_max, self.kv_quant, self.device

            def run(params, tokens, true_len, gens, lora_stack, adapter_idx,
                    perm, inv, blocks):
                cache = lm.init_cache(cfg, 1, s_max, kv_quant=kvq, device=dev)
                logits, cache = lm.prefill(
                    params, cfg, tokens=tokens, cache=cache, lora=lora_stack,
                    adapter_idx=adapter_idx, lora_impl=impl,
                    lora_seg=self._seg(impl, perm, inv, blocks),
                    seq_lens=true_len)
                first, gens = sample(logits, gens)
                return first, lm.finite_logits(logits), gens, cache

            self._fn_prefill[key] = run
        return self._fn_prefill[key]

    def _write_fn(self):
        """Admission scatter: copy the one-row prefill cache into the pool's
        slot along the batch axis (in place)."""
        if None not in self._fn_write:
            def write(pool, cache, slot):
                for psub, csub in zip(pool, cache):
                    for name, t in psub.items():
                        t[:, slot].copy_(csub[name][:, 0])
                return pool
            self._fn_write[None] = write
        return self._fn_write[None]

    def _decode_fn(self, cap: int, chunk: int):
        """``chunk`` decode steps over every slot; returns (pool, last
        tokens, generators, tokens (slots, chunk), finite flags (slots,))."""
        key = (self.num_slots, cap, chunk)
        if key not in self._fn_decode:
            cfg, impl, sample = self.cfg, self.impl, self._sample
            nslots, dev = self.num_slots, self.device

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
                return pool, tok, gens, torch.stack(out, dim=1), fin

            self._fn_decode[key] = run
        return self._fn_decode[key]

    # ---- segment metadata (per composition, not per token) ----
    def _segments(self, cap: int):
        if self.impl != "segmented":
            return None, None, None
        key = (self._slot_adapters.tobytes(), cap)
        if key != self._seg_key:
            self._seg_dev = seg_to_device(
                *self.fm.segment_meta(self._slot_adapters, cap, 1), self.device)
            self._seg_key = key
        return self._seg_dev

    def _prefill_segments(self, adapter_slot: int, cap: int, plen: int):
        if self.impl != "segmented":
            return None, None, None
        ids = np.full((plen,), adapter_slot, np.int32)
        return seg_to_device(*self.fm.segment_meta(ids, cap, 1), self.device)

    def bucket_for_prompt(self, n: int) -> int:
        """Smallest admission bucket holding an n-token prompt."""
        for b in self.prompt_buckets:
            if n <= b:
                return b
        return self.prompt_buckets[-1]

    # ---- serving surface ----
    def join(self, task_id: str, prompt: np.ndarray, *,
             adapter_id: Optional[str] = None, max_new_tokens: int = 8,
             rid: int = -1, eos_id: Optional[int] = None,
             deadline: Optional[float] = None) -> int:
        """Admit one request: prefill its prompt (LoRA applied, K/V int8-
        quantized per (slot, kv head)), scatter it into a free slot, produce
        the first token. Returns the slot index. A full dense pool raises:
        its capacity is the static slot count. Prompts longer than the
        largest bucket keep their LAST ``prompt_len`` tokens (with a
        warning); the decode budget clamps to the pool's ``max_new``."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        req = _PendingJoin(task_id=task_id, prompt=prompt,
                           adapter_id=adapter_id,
                           max_new_tokens=max_new_tokens, rid=rid,
                           eos_id=eos_id,
                           deadline=float("inf") if deadline is None
                           else float(deadline))
        if not self.free_slots():
            raise RuntimeError("no free decode slots; step_chunk() first")
        return self._admit_now(req)

    def _admit_now(self, req: _PendingJoin) -> int:
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
        perm, inv, blocks = self._prefill_segments(aslot, cap, plen)
        dev = self.device
        first, fin, _, cache = self._prefill_fn(cap, plen)(
            self.fm.params, torch.as_tensor(prompt[None], device=dev),
            torch.full((1,), true_len, dtype=torch.int32, device=dev),
            [self._keys[slot]], self.fm.adapters.stacked(),
            torch.full((1,), aslot, dtype=torch.int32, device=dev),
            perm, inv, blocks)
        # the prefill consumed real device work whether or not the stream
        # survives it — record the admission for token-level charging
        self.admissions += 1
        self.admitted_log.append((req.rid, req.task_id, true_len, true_len))
        # numeric health rides the admission's host sync: a non-finite
        # prefill quarantines right here, before the pool write
        fin_ok = bool(fin[0].item())
        if fin_ok:
            self.pool = self._write_fn()(self.pool, cache, slot)
        else:
            self.quarantines += 1
        return self._finish_admission(req, slot, aslot, first, fin_ok,
                                      true_prompt, true_len, max_new_tokens)

    def _finish_admission(self, req: _PendingJoin, slot: int, aslot: int,
                          first, fin_ok: bool, true_prompt: np.ndarray,
                          true_len: int, max_new_tokens: int) -> int:
        self._tokens[slot] = first[0]
        now = time.perf_counter()
        tok0 = int(first[0].item())
        eos = self.eos_id if req.eos_id is None else req.eos_id
        self.slots[slot] = DecodeSlot(
            rid=req.rid, task_id=req.task_id, adapter_slot=aslot,
            max_new=max_new_tokens, eos_id=eos, tokens=[tok0], t_join=now,
            t_first=now, prompt_tokens=true_len, prompt=true_prompt,
            adapter_id=req.adapter_id, deadline=req.deadline,
            status="ok" if fin_ok else "quarantined",
            done=(not fin_ok or max_new_tokens == 1
                  or (eos is not None and tok0 == eos)))
        self._slot_adapters[slot] = aslot
        self._seg_key = None                    # composition changed
        return slot

    def leave(self, slot: int) -> DecodeSlot:
        """Retire a slot (finished or cancelled) and free it for admission."""
        s = self.slots[slot]
        if s is None:
            raise ValueError(f"slot {slot} is free")
        self.slots[slot] = None
        self._slot_adapters[slot] = FREE
        self._seg_key = None                    # composition changed
        # keep the freed slot's cache length bounded while it idles
        for sub in self.pool:
            sub["len"][:, slot] = 0
        return s

    # ---- failure semantics: deadlines, cancellation ----
    def _expire_deadlines(self, now: float):
        """Live slots past their deadline are marked done
        (``deadline_cancelled``) and retire with their partial tokens."""
        for s in self.slots:
            if s is not None and not s.done and s.deadline < now:
                s.done = True
                s.status = "deadline_cancelled"
                self.deadline_cancels += 1

    def cancel(self, rid: int):
        """Client-cancel one stream by rid: ``("slot", DecodeSlot)`` for a
        live stream (retired through ``leave``), ``None`` when the rid is
        not in the engine."""
        for i, s in enumerate(self.slots):
            if s is not None and s.rid == rid:
                s.done = True
                s.status = "cancelled"
                self.cancels += 1
                return ("slot", self.leave(i))
        return None

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
        """Dispatch every ladder chunk length once against the idle pool, so
        the deadline clamp adds no shape key mid-measurement. The garbage
        rows land in regions the next admission overwrites."""
        if self.active_count():
            raise RuntimeError("warm_decode_ladder must run on an idle engine")
        cap = self.fm.adapters.capacity()
        perm, inv, blocks = self._segments(cap)
        adapters = torch.as_tensor(self._slot_adapters, device=self.device)
        for c in self.chunk_ladder():
            self.pool, self._tokens, _, _, _ = self._decode_fn(cap, c)(
                self.fm.params, self.pool, self._tokens, self._keys,
                self.fm.adapters.stacked(), adapters, perm, inv, blocks)

    def step_chunk(self) -> list[DecodeSlot]:
        """Advance every occupied slot by up to ``chunk`` tokens; retire and
        return the slots that finished (done slots retire first)."""
        t0 = time.perf_counter()
        self._expire_deadlines(t0)
        retired = [self.leave(i) for i, s in enumerate(self.slots)
                   if s is not None and s.done]
        live = [i for i, s in enumerate(self.slots)
                if s is not None and not s.done]
        finished = []
        if live:
            eff = self._effective_chunk(live, t0)
            cap = self.fm.adapters.capacity()
            t_disp = time.perf_counter()
            perm, inv, blocks = self._segments(cap)
            self.pool, self._tokens, _, out, fin = self._decode_fn(cap, eff)(
                self.fm.params, self.pool, self._tokens, self._keys,
                self.fm.adapters.stacked(),
                torch.as_tensor(self._slot_adapters, device=self.device),
                perm, inv, blocks)
            out = out.cpu().numpy()             # one host sync per chunk
            fin = fin.cpu().numpy()
            dt = (time.perf_counter() - t_disp) / eff
            self._step_ema = dt if self._step_ema == 0.0 \
                else 0.5 * self._step_ema + 0.5 * dt
            self.steps += eff
            for i in live:
                s = self.slots[i]
                committed = [int(t) for t in out[i]]
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
        retired += [self.leave(i) for i in finished]
        self.last_chunk_s = time.perf_counter() - t0
        return retired

    def drain(self) -> list[DecodeSlot]:
        """Step until every occupied slot retires."""
        out = []
        while self.active_count():
            out += self.step_chunk()
        return out

    # ---- durability (later slice) ----
    def snapshot(self):
        raise NotImplementedError("engine snapshot/restore comes with a later "
                                  "slice of the port (durability plane)")

    @classmethod
    def restore(cls, fm, snap, **kwargs):
        raise NotImplementedError("engine snapshot/restore comes with a later "
                                  "slice of the port (durability plane)")

"""Unified event-loop serving plane: one clock, three kinds of work.

Before this subsystem the server ran two disjoint planes: pooled batches
dispatched synchronously while generative batches drained the decode engine
to completion — a long decode stream starved pooled tasks for its whole
lifetime, and BFQ's virtual time never saw per-token work. The event loop
owns ONE clock: each ``tick`` the scheduler picks the next *unit of work* by
virtual tag —

  * a **pooled sub-batch** (tag = smallest queued pooled start tag), executed
    through the double-buffered ``Executor.execute_async`` path: the co-batch
    for tick N+1 is assembled on the host and dispatched while the device is
    still executing tick N, whose heads/host-sync resolve afterwards;
  * a **prefill admission** (tag = smallest queued generative start tag,
    available while the decode pool can take it): arrivals join the
    ``DecodeEngine`` mid-flight between chunks, charged their TRUE prompt
    length in tokens. Admission is **memory-aware** on a paged pool: the
    loop peeks the would-be-admitted request and only dispatches the prefill
    when the engine's free-page count covers its prompt bucket plus a chunk
    of decode headroom (``DecodeEngine.can_admit``), DEFERRING — the request
    stays queued at its tag, the loop serves other work — otherwise;
  * a **decode chunk** (tag = the most-behind active stream's virtual time):
    every occupied slot advances up to ``chunk`` scan steps; each
    participating task is charged the tokens its streams actually COMMITTED
    (engine charge log — under speculative decoding a high-accept stream
    commits several tokens per step, a zero-accept one exactly one, and
    their tasks pay accordingly; on plain engines this degenerates to the
    old ``chunk × active slots``).

Charges advance task virtual time through ``SchedulerBase.charge_tokens``
(BFQ: ``l(1)·tokens/weight``, the same per-token price arrival tags use), so
weighted max-min sharing holds across both planes at token granularity: a
pooled batch interleaves between decode chunks exactly when its tag falls
below the decode stream's, and vice versa.

``run`` replays an arrival trace against the wall clock; ``step_batch``
preserves the old synchronous one-BFQ-batch contract (``FMplexServer.step``)
on top of the same machinery.

This module is the JAX package's loop, nearly line for line. On a paged
pool with chunked shared-prefix prefill a sharer's admission is charged its
private TAIL only (what the device computed), and TTFT is split into
prefix-hit and miss series (``ttft_hit_samples``/``ttft_miss_samples``).

**Failure semantics.** Performance isolation (BFQ, the page gate) is only
half of virtualization's promise — the loop also owns FAILURE isolation, and
every request leaves it with a terminal ``Request.status`` (``core.request``
for the full catalogue). The exit paths and what each one unwinds:

  * ``deadline_shed`` (queued): each tick sheds queued generative requests
    whose deadline is already infeasible — predicted TTFT is the page gate's
    token cost model, ``l(1) ×`` admitted prompt length — BEFORE they cost a
    prefill. The scheduler REFUNDS the arrival tags (``on_cancel`` re-chains
    the task's queue), so shed work never distorts fair shares. Deferred
    admissions that expire inside the engine's pending queue surface here
    too (never charged: admission prompt charges are taken from the
    engine's ``admitted_log`` at ACTUAL admission, not at dispatch).
  * ``deadline_cancelled`` / ``quarantined`` (mid-flight): stamped by the
    engine (deadline sweep / in-graph finite-logits flag) and retired
    through the normal retire path — partial tokens preserved, pages and
    prefix references released, the chunks already charged stand (they were
    real device work).
  * ``cancelled``: client ``cancel(request_id)`` unwinds the request
    wherever it lives — queued (tag refund), deferred/preempted (popped,
    never charged), or live (retired via ``leave``: pages, COW references
    and registry entries released).
  * ``head_failed``: the executor isolates a raising task head to that
    task's requests (bounded retry/backoff first); other tasks in the same
    co-batch resolve normally.
  * ``watchdog_shed`` / ``rejected_stranded``: a loop-level watchdog
    watches for wedged engines (work queued, no progress for
    ``watchdog_stall_s``); on a trip it degrades gracefully — terminally
    rejects stranded deferred joins and sheds the lowest-weight task's
    oldest queued request. The engine's wedge (``EngineWedged``: stranded
    deferred joins, nothing live, nothing that can ever fit) is caught and
    converted into terminal rejections; any other error raised by the
    engine (a kernel's precondition, a device fault) propagates.

**Durable serving state.** ``snapshot_state`` quiesces (resolves the
double-buffered pooled batch) and captures the engine snapshot, the
scheduler's virtual-time tags and the in-flight request map;
``restore_state`` rebuilds the engine from it (every page sha256-checked:
``DecodeEngine.restore``) and re-applies the tags, so fair shares resume
where they left off; ``checkpoint_restart`` chains quiesce, snapshot,
teardown, restore and resume, counting ``resets_survived`` on the loop and
on every in-flight request. The restored engine shares the dead one's
captured executables and rewrites the tensors they bake in place. A device
reset mid-trace loses no request: live streams resume from their restored
pages, pending and preempted entries keep their places, and a stream whose
page fails its digest re-prefills from its host-side tokens.

Non-ok terminations count ``acct.dropped`` (never ``completed``) and feed
``ServeLoop.failures`` — ``serving.metrics.failure_counters`` reports them.
"""
from __future__ import annotations

import collections
import time
from typing import Optional

import numpy as np

from repro_torch.core.bfq import group_sub_batches
from repro_torch.core.decode_engine import EngineWedged
from repro_torch.core.request import Batch, Request


def is_generative(r: Request) -> bool:
    return r.max_new_tokens > 0


def is_pooled(r: Request) -> bool:
    return r.max_new_tokens <= 0


class ServeLoop:
    """Event-loop serving plane bound to one (server, physical FM) pair."""

    def __init__(self, server, fm_id: str, *, engine_kwargs: Optional[dict] = None,
                 idle_sleep: float = 2e-4,
                 watchdog_stall_s: Optional[float] = 10.0):
        self.srv = server
        self.fm_id = fm_id
        self.engine_kwargs = engine_kwargs or {}
        self.idle_sleep = idle_sleep
        self._pending = None                    # double-buffered pooled batch
        self._inflight: dict[int, Request] = {}  # rid -> loop-admitted request
        self.served: list[Request] = []
        self.ticks = collections.Counter()      # work-kind -> tick count
        self.page_samples: list[float] = []     # paged-pool occupancy / tick
        self.shared_samples: list[float] = []   # dedup fraction / decode tick
        self._tie_last = "decode"               # alternation state (see tick)
        # TTFT split by admission kind (chunked shared-prefix prefill):
        # rids whose admission mapped a prefix (tail < full prompt) land in
        # the hit series at retire, everything else in the miss series
        self._prefix_hit_rids: set[int] = set()
        self.ttft_hit_samples: list[float] = []
        self.ttft_miss_samples: list[float] = []
        # failure-isolation plane (module docstring): terminal-status tallies
        # plus the stall watchdog. The watchdog only arms while work is
        # queued and fires when no progress event (serve / engine step /
        # admission) lands for watchdog_stall_s — None disables it.
        self.failures = collections.Counter()   # terminal status -> count
        self.watchdog_stall_s = watchdog_stall_s
        # deadline enforcement switch: warmup() turns it off around its run
        # (compiles take arbitrarily long; shedding a warmup request would
        # leave its executable cold for the measured run)
        self.enforce_deadlines = True
        self._progress_mark = None
        self._last_progress_t = time.perf_counter()

    # ---- plumbing ----
    @property
    def sched(self):
        return self.srv.schedulers[self.fm_id]

    def _vfms(self):
        return self.srv.vfms_on(self.fm_id)

    def _executor(self):
        ex = self.srv.executors.get(self.fm_id)
        if ex is None:       # FM deployed profile-only, then attached later
            from repro_torch.core.executor import Executor
            ex = self.srv.executors[self.fm_id] = Executor(
                self.srv.fms[self.fm_id])
        return ex

    def _engine(self, create: bool = False):
        eng = self.srv.engines.get(self.fm_id)
        if eng is None and create:
            eng = self.srv.decode_engine(self.fm_id, **self.engine_kwargs)
        return eng

    def submit(self, req: Request, now: Optional[float] = None):
        self.srv.on_arrival(req, time.perf_counter() if now is None else now)

    # ---- the clock ----
    def tick(self, now: Optional[float] = None) -> str:
        """One scheduling decision: dispatch the smallest-tag unit of work.
        Returns the kind dispatched ('pooled' | 'admit' | 'decode' | 'idle')."""
        now = time.perf_counter() if now is None else now
        sched, vfms = self.sched, self._vfms()
        eng = self._engine()
        self._shed_infeasible(sched, vfms, eng, now)
        if self.watchdog_stall_s is not None:
            # the watchdog watches ENGINE progress specifically: pooled
            # completions must not mask a wedged decode pool (a stuck pooled
            # execute blocks inside the tick and cannot be watchdogged
            # anyway). Armed only while the engine holds work; a trip means
            # streams/pending sat still for watchdog_stall_s.
            has_eng_work = eng is not None and \
                (eng.active_count() or eng.pending_count())
            sig = (eng.steps, eng.admissions) if has_eng_work else None
            if sig is None or sig != self._progress_mark:
                self._progress_mark = sig
                self._last_progress_t = now
            elif now - self._last_progress_t > self.watchdog_stall_s:
                self._watchdog_trip(sched, vfms, eng, now)
                self._last_progress_t = now
        candidates = []
        pooled_tag = sched.peek_tag(vfms, is_pooled)
        if pooled_tag != float("inf"):
            candidates.append((pooled_tag, 0, "pooled"))
        gen_tag = sched.peek_tag(vfms, is_generative)
        if gen_tag != float("inf"):
            admit_ok = eng is None
            if not admit_ok:
                # memory-aware admission: peek the request this admission
                # would serve and ask the engine whether a free slot AND (on
                # a paged pool) enough free pages for its prompt bucket plus
                # a chunk of decode headroom exist — otherwise DEFER: the
                # request keeps its tag and the loop serves other work until
                # retiring streams free pages. The PROMPT rides along so the
                # gate can discount pages a shared prefix would map rather
                # than allocate (a sharer needs only its private tail)
                head = sched.peek_request(vfms, is_generative)
                if head is not None and head.payload is not None:
                    v = vfms.get(head.task_id)
                    aid = v.extensions.adapter_id if v is not None else None
                    prompt = np.asarray(head.payload, np.int32).reshape(-1)
                    admit_ok = eng.can_admit(len(prompt), prompt=prompt,
                                             adapter_id=aid)
                else:
                    admit_ok = eng.can_admit(1)
            if admit_ok:
                # ties: admit before pooled/decode — filling slots lets the
                # next decode chunk amortize over more streams
                candidates.append((gen_tag, -1, "admit"))
        if eng is not None and (eng.active_count() or eng.pending_count()):
            tids = [s.task_id for s in eng.slots if s is not None] \
                + eng.pending_task_ids()
            decode_tag = min(sched.task_vtime(t) for t in tids)
            if not sched.token_accounting:
                # no token clock (STFQ/FIFO): the decode tag is meaningless
                # against real queue tags — force a tie with the best queued
                # tag so admission (tie priority -1) refills free slots
                # mid-flight and the pooled/decode alternation below shares
                # the device between the planes
                queued_tag = min(pooled_tag, gen_tag)
                if queued_tag != float("inf"):
                    decode_tag = queued_tag
            candidates.append((decode_tag, 1, "decode"))
        if not candidates:
            self._flush()
            self.ticks["idle"] += 1
            return "idle"
        best = min(candidates)
        kind = best[2]
        # exact pooled/decode tag ties alternate: without a token clock the
        # planes are forced into a tie above, and a fixed preference would
        # starve one of them under sustained load on the other; under BFQ
        # exact ties are transient and alternation is still fair
        if kind in ("pooled", "decode"):
            other = "decode" if kind == "pooled" else "pooled"
            tie = next((c for c in candidates
                        if c[2] == other and c[0] == best[0]), None)
            if tie is not None and self._tie_last == kind:
                kind = other
            self._tie_last = kind
        if kind == "pooled":
            self._tick_pooled(sched, vfms, now)
        elif kind == "admit":
            self._tick_admit(sched, vfms, now)
        else:
            self._tick_decode(sched, vfms, now)
        self.ticks[kind] += 1
        return kind

    def _tick_pooled(self, sched, vfms, now):
        batch = sched.next_batch(vfms, now, pred=is_pooled)
        if batch is None:
            return
        # dispatch N+1 BEFORE resolving N: the np.stack co-batch assembly in
        # execute_async runs on the host while the device still executes the
        # pending batch (double-buffered host prep)
        new = self._executor().execute_async(batch, vfms)
        self._flush()
        self._pending = new

    def _flush(self):
        """Resolve the in-flight pooled batch: heads + host sync + completion
        bookkeeping (Eq. 3 retro-correction via ``on_complete``)."""
        if self._pending is None:
            return
        out = self._pending.resolve()
        batch = self._pending.batch
        self._pending = None
        # head_failed stamping BEFORE on_complete so its accounting sees the
        # terminal status (failed rows count dropped, not completed)
        self._stamp_head_failures(batch, out)
        self.srv.on_complete(self.fm_id, batch, time.perf_counter())
        for r in batch.requests:
            r.result = out[r.rid]
        self.served += batch.requests

    def _stamp_head_failures(self, batch, out):
        """Map the executor's per-task HeadFailure sentinels (isolated head
        crash past its bounded retries) to terminal request statuses."""
        from repro_torch.core.executor import HeadFailure
        for r in batch.requests:
            res = out.get(r.rid)
            if isinstance(res, HeadFailure):
                r.status = "head_failed"
                r.error = res.error
                out[r.rid] = None
                self.failures["head_failed"] += 1

    def _admit_one(self, eng, vfms, r: Request):
        """Join one generative request into the pool (immediate or deferred —
        the engine's ``admitted_log`` records the charge at ACTUAL
        admission)."""
        ext = vfms[r.task_id].extensions
        prompt = np.asarray(r.payload).reshape(-1)
        eng.join(r.task_id, prompt, adapter_id=ext.adapter_id,
                 max_new_tokens=r.max_new_tokens, rid=r.rid,
                 deadline=r.deadline() if self.enforce_deadlines else None,
                 # enc-dec: encoder input frames ride the request; None is
                 # the engine's zero-frame default (decoder-only unaffected)
                 enc_feats=getattr(r, "enc_feats", None))

    def _charge_admissions(self, sched, vfms, now):
        """Drain the engine's admitted log and charge each loop-admitted
        request the prompt tokens its prefill ACTUALLY computed — the TAIL
        tokens, which a chunked shared-prefix admission keeps below the
        full (post-truncation) prompt length. Charging full prompt length
        would bill a sharer for compute the prefix registry saved it,
        inflating its task's virtual time and handing its fair share to
        competitors. Charging at ACTUAL admission — not at dispatch into
        the engine — means a deferred join that gets shed/cancelled while
        still pending never carried a charge to refund (the BFQ-charge bug
        this replaces: deferred joins were priced at dispatch, so a drop in
        the pending queue left the task's virtual time inflated by a
        prefill that never ran)."""
        eng = self._engine()
        if eng is None:
            return
        charges: dict[str, float] = collections.Counter()
        for rid, tid, toks, tail in eng.take_admitted():
            # step_batch-owned requests were dispatched at FULL arrival
            # price (see _drain_gen) — only loop-admitted rids pay here
            if rid in self._inflight:
                charges[tid] += tail
                if tail < toks:
                    self._prefix_hit_rids.add(rid)
        if charges:
            sched.charge_tokens(vfms, charges, now)

    def _tick_admit(self, sched, vfms, now):
        # the double buffer only spans pooled→pooled ticks: an engine tick
        # syncs the device anyway, so resolve the pending pooled batch first
        # (its requests must not outlive work dispatched after them)
        self._flush()
        eng = self._engine(create=True)
        # paged pools admit ONE request per tick: tick()'s can_admit gate
        # only vetted the head request, so popping more would shove the rest
        # past the page check into the engine's rid-FIFO pending queue —
        # charged early and served out of tag order. The loop re-ticks and
        # admission keeps its tie priority, so a burst still lands back to
        # back, each admission individually vetted.
        free = 1 if eng.paged else len(eng.free_slots())
        # defer_charge: dispatch advances the stream's virtual time only to
        # its start tag; the ACTUAL work is charged at admission via the
        # engine's admitted log and per decode chunk (double-pricing would
        # halve the gen share)
        batch = sched.next_batch(vfms, now, pred=is_generative, limit=free,
                                 defer_charge=True)
        if batch is None:
            return
        for r in batch.requests:
            self._inflight[r.rid] = r       # before join: admitted-log drain
            self._admit_one(eng, vfms, r)   # below must see the rid as ours
        self._charge_admissions(sched, vfms, now)

    def _tick_decode(self, sched, vfms, now):
        self._flush()                 # see _tick_admit: pooled results first
        eng = self._engine()
        # expire deadlines BEFORE counting active slots so an expired stream
        # is not charged for a chunk it no longer decodes (the engine sweeps
        # again inside step_chunk; the sweep is idempotent)
        eng._expire_deadlines(now)
        # decode chunks charge the tokens each task's streams actually
        # COMMITTED (engine's per-task charge log): under speculation a
        # high-accept stream commits several tokens per scan step while a
        # zero-accept co-batched stream commits one — a flat
        # chunk × active_slots split would bill both the same. Engines
        # without the log (stubs) fall back to exactly that flat split.
        active = collections.Counter(
            s.task_id for s in eng.slots if s is not None and not s.done)
        steps0 = eng.steps
        try:
            retired = eng.step_chunk()
        except EngineWedged:
            # wedged engine (stranded deferred joins, nothing live, nothing
            # can ever fit): the engine raises for direct users, the LOOP
            # degrades — terminally reject the stranded entries and keep
            # serving everything else. Any other error propagates.
            self.failures["wedge_recoveries"] += 1
            eng.shed_stranded()
            self._handle_rejected(eng, vfms, time.perf_counter())
            return
        if eng.paged:
            self.page_samples.append(eng.page_occupancy())
            self.shared_samples.append(
                eng.dedup_saved_pages() / max(eng.logical_page_count(), 1))
        # charge the work the chunk ACTUALLY did (0 when a stalled/faulted
        # engine made no progress — phantom charges would corrupt fair
        # shares for the rest of the run)
        committed = eng.take_decode_charges() \
            if hasattr(eng, "take_decode_charges") else None
        if committed:
            agg: dict[str, float] = collections.Counter()
            for (tid, _rid), n in committed.items():
                agg[tid] += n
            sched.charge_tokens(vfms, agg, now)
        elif committed is None:
            advanced = eng.steps - steps0
            if advanced:
                sched.charge_tokens(
                    vfms, {t: n * advanced for t, n in active.items()}, now)
        # pending joins admitted inside step_chunk (and any terminally
        # rejected along the way) surface through the engine's logs
        self._charge_admissions(sched, vfms, now)
        done_t = time.perf_counter()
        self._handle_rejected(eng, vfms, done_t)
        for s in retired:
            self._retire(s, vfms, done_t)

    def _retire(self, slot, vfms, now):
        """Stamp a loop-admitted stream's request at ITS retire chunk (keeps
        TTFT/TPOT honest for short streams co-batched with long ones)."""
        r = self._inflight.pop(slot.rid, None)
        hit = slot.rid in self._prefix_hit_rids
        self._prefix_hit_rids.discard(slot.rid)
        if r is None:
            return                    # admitted by step_batch; handled there
        r.first_token_time = slot.t_first
        r.finish_time = now
        if r.arrival is not None and slot.t_first is not None:
            (self.ttft_hit_samples if hit else self.ttft_miss_samples
             ).append(slot.t_first - r.arrival)
        r.result = np.asarray(slot.tokens, np.int32)
        v = vfms.get(r.task_id)
        if v is not None:
            if slot.status == "ok":
                v.acct.completed += 1
            else:
                v.acct.dropped += 1
            # token-level service accounting: l(1) per token of device work,
            # prompt (admission prefill) included — mirrors what
            # charge_tokens billed to the task's virtual time. Billed even
            # for quarantined/expired streams: the device did the work.
            v.acct.service_time += self.sched.profile.l(1) * \
                (slot.prompt_tokens + len(slot.tokens))
        if slot.status != "ok":
            r.status = slot.status
            r.error = f"stream {slot.status}"
            self.failures[slot.status] += 1
        self.served.append(r)

    # ---- failure plane (module docstring, failure-semantics section) ----
    def _terminal(self, r: Request, status: str, now, *, tokens=None,
                  t_first=None, vfms=None):
        """Stamp a terminal failure status on a request and account it."""
        r.status = status
        r.error = r.error or status
        r.finish_time = now
        if t_first is not None:
            r.first_token_time = t_first
        r.result = None if tokens is None else np.asarray(tokens, np.int32)
        self.failures[status] += 1
        v = (vfms if vfms is not None else self._vfms()).get(r.task_id)
        if v is not None:
            v.acct.dropped += 1
        self._inflight.pop(r.rid, None)
        self.served.append(r)

    def _handle_rejected(self, eng, vfms, now, *, mine=None, out=None):
        """Drain the engine's terminally rejected pending entries (deadline
        sweep, stranded shed, wedge recovery) into terminal request statuses.
        ``mine``/``out`` route ``step_batch``-owned rids back to its result
        map (its while-loop must see a result for every request or it never
        terminates)."""
        for p in eng.take_rejected():
            toks = p.resume.tokens if p.resume is not None else None
            t_first = p.resume.t_first if p.resume is not None else None
            r = mine.get(p.rid) if mine is not None else None
            if r is not None:
                r.status = p.status
                r.error = f"admission {p.status}"
                r.finish_time = now
                if t_first is not None:
                    r.first_token_time = t_first
                out[p.rid] = None if toks is None else \
                    np.asarray(toks, np.int32)
                self.failures[p.status] += 1
                # no acct here: step_batch's on_complete sees the terminal
                # status and counts dropped for the whole batch
                continue
            r = self._inflight.get(p.rid)
            if r is not None:
                self._terminal(r, p.status, now, tokens=toks,
                               t_first=t_first, vfms=vfms)

    def _shed_infeasible(self, sched, vfms, eng, now):
        """Shed queued generative requests whose deadline is already
        infeasible BEFORE they cost a prefill: predicted TTFT is the page
        gate's token cost model — ``l(1)`` per admitted prompt token. The
        scheduler refunds the arrival tags (``on_cancel`` re-chains the
        queue), so shed work never distorts the task's fair share."""
        if not self.enforce_deadlines:
            return
        l1 = sched.profile.l(1)
        cap = eng.prompt_len if eng is not None else None
        for v in vfms.values():
            for r in [q for q in v.queue if is_generative(q)]:
                dl = r.deadline()
                if dl == float("inf"):
                    continue
                plen = len(np.asarray(r.payload).reshape(-1)) \
                    if r.payload is not None else max(r.tokens, 1.0)
                if cap is not None:
                    plen = min(plen, cap)
                if now + l1 * plen > dl and sched.on_cancel(vfms, r):
                    self._terminal(r, "deadline_shed", now, vfms=vfms)

    def _watchdog_trip(self, sched, vfms, eng, now):
        """No progress for watchdog_stall_s with work queued: degrade
        gracefully. Stranded deferred joins are terminally rejected (they
        are the one way the engine can wedge) and the lowest-weight task's
        oldest queued request is shed — never crash, never hang."""
        self.failures["watchdog_trips"] += 1
        if eng is not None and eng.pending_count():
            eng.shed_stranded()
            self._handle_rejected(eng, vfms, now)
        loaded = [v for v in vfms.values() if v.queue]
        if loaded:
            v = min(loaded, key=lambda x: x.weight)
            r = v.queue[0]
            if sched.on_cancel(vfms, r):
                self._terminal(r, "watchdog_shed", now, vfms=vfms)

    def cancel(self, request_id: int, now: Optional[float] = None) -> bool:
        """Client-initiated cancellation: unwind one request wherever it
        lives. Queued → scheduler tag refund (no device work happened);
        deferred/preempted in the engine's pending queue → popped, never
        charged (admission charges land at actual admission); live slot →
        retired through ``leave`` (pages, COW references and prefix-registry
        entries released), partial tokens preserved, chunk charges already
        billed stand (real device work). Returns True iff the request was
        found live anywhere."""
        now = time.perf_counter() if now is None else now
        sched, vfms = self.sched, self._vfms()
        for v in vfms.values():
            for r in list(v.queue):
                if r.rid == request_id:
                    if sched.on_cancel(vfms, r):
                        self._terminal(r, "cancelled", now, vfms=vfms)
                        return True
        eng = self._engine()
        if eng is None:
            return False
        res = eng.cancel(request_id)
        if res is None:
            return False
        kind, obj = res
        r = self._inflight.get(request_id)
        if r is None:
            return True               # engine-direct stream, not loop-owned
        if kind == "slot":
            self._terminal(r, "cancelled", now, tokens=obj.tokens,
                           t_first=obj.t_first, vfms=vfms)
        else:
            toks = obj.resume.tokens if obj.resume is not None else None
            t_first = obj.resume.t_first if obj.resume is not None else None
            self._terminal(r, "cancelled", now, tokens=toks,
                           t_first=t_first, vfms=vfms)
        return True

    # ---- durable serving state (snapshot / restore / device reset) ----
    def snapshot_state(self) -> dict:
        """Quiesce (resolve the double-buffered pooled batch) and capture
        what a restore needs: the engine snapshot (page contents, tables,
        refcounts, registry, slot, generator and deadline state, pending
        queue), the scheduler's virtual-time tags and the in-flight request
        map. Host-side objects (requests, the spill arena) ride by
        reference: they are what a device reset cannot touch."""
        self._flush()
        eng = self._engine()
        tags = self.sched.snapshot_tags() \
            if hasattr(self.sched, "snapshot_tags") else None
        return {"engine": None if eng is None else eng.snapshot(),
                "sched": tags, "inflight": dict(self._inflight)}

    def restore_state(self, state: dict, *, reuse_jits_from=None):
        """Rebuild the engine from a snapshot (digest-checked; see
        ``DecodeEngine.restore``), swap it into the server and re-apply the
        scheduler's tags. In-flight requests keep their identities: the
        retire path finds them by rid as before the reset."""
        from repro_torch.core.decode_engine import DecodeEngine
        self._flush()
        snap = state.get("engine")
        if snap is not None:
            eng = DecodeEngine.restore(self.srv.fms[self.fm_id], snap,
                                       reuse_jits_from=reuse_jits_from)
            self.srv.engines[self.fm_id] = eng
        if state.get("sched") is not None \
                and hasattr(self.sched, "restore_tags"):
            self.sched.restore_tags(state["sched"])
        self._inflight.update(state.get("inflight", {}))
        # restored streams re-arm the watchdog from NOW, not from the
        # pre-reset progress mark
        self._progress_mark = None
        self._last_progress_t = time.perf_counter()

    def checkpoint_restart(self) -> dict:
        """The whole recovery sequence: quiesce, snapshot, teardown (the old
        engine leaves the server; its executables and the tensors they
        bake are reused), restore, resume. Returns the snapshot used.
        ``serving.faults.DeviceResetFault`` scrambles the old arena in
        between, to prove the restore reads nothing from dead state."""
        state = self.snapshot_state()
        old = self.srv.engines.pop(self.fm_id, None)
        self.restore_state(state, reuse_jits_from=old)
        self.stamp_reset()
        return state

    def stamp_reset(self):
        """Count one survived reset on the loop and on every in-flight
        request."""
        self.failures["resets_survived"] += 1
        for r in self._inflight.values():
            r.resets_survived += 1

    # ---- drivers ----
    def warmup(self, *, pooled_task: Optional[str] = None,
               gen_task: Optional[str] = None, pooled_n: int = 4):
        """Run every shape key the loop can dispatch twice before
        measuring (its first call runs eagerly, its second captures it as a
        CUDA graph: ``core.graphs``): one pooled co-batch per batch bucket up
        to ``pooled_n`` (BFQ can form ANY size under load), one admission
        prefill per prompt-length bucket, the decode chunk, the pool write
        and, on a chunked paged pool, one tail prefill and tail scatter per
        tail bucket, and with a spill arena the spill tier's gather and
        write-backs — so the kernels are built, the graphs captured, the
        allocator has its blocks and the heads have their verdicts before a
        measured run. Generative warmup is skipped for FMs
        with no generative head; encoder-decoder stacks warm through the
        engine's zero-frame ``enc_feats`` default."""
        import numpy as np

        from repro_torch.core.physical import BUCKETS
        fm = self.srv.fms[self.fm_id]
        cfg = fm.cfg
        vfms = self._vfms()
        if not vfms:
            return
        tids = sorted(vfms)
        pooled_task = pooled_task or tids[0]
        gen_task = gen_task or tids[-1]
        rng = np.random.RandomState(0)

        def payload():
            # DISTINCT rows: the executor's head probe defers its verdict on
            # identical rows, which would leave the head modes unprobed
            return rng.randn(fm.input_len, cfg.d_model).astype(np.float32)

        ex = self._executor()
        for b in (x for x in BUCKETS if x <= max(pooled_n, 1)):
            for _ in range(2):
                reqs = [Request(pooled_task, 0.0, payload=payload())
                        for _ in range(b)]
                ex.execute(Batch(reqs, group_sub_batches(reqs, vfms)), vfms)
        trace = [Request(pooled_task, 0.0, payload=payload())
                 for _ in range(pooled_n)]
        if cfg.vocab_size > 0 and not cfg.is_representation:
            eng = self._engine(create=True)
            for plen in eng.prompt_buckets:
                trace += [Request(
                    gen_task, 0.0,
                    payload=rng.randint(0, cfg.vocab_size,
                                        plen).astype("int32"),
                    tokens=float(plen + 2), max_new_tokens=2)
                    for _ in range(2)]
        # warmup requests inherit task-level SLOs at enqueue, and a first
        # call (kernel build) takes arbitrarily long: enforcement would shed
        # the very requests meant to warm the path
        enforce = self.enforce_deadlines
        self.enforce_deadlines = False
        try:
            self.run(trace)
        finally:
            self.enforce_deadlines = enforce
        # the deadline clamp dispatches shortened chunks from a fixed
        # ladder, and the spill tier gathers and writes back pages at a
        # fixed width: run them now so deadline traffic, spills and
        # restores add no shape key
        eng = self._engine()
        if eng is not None and eng.active_count() == 0:
            if eng.deadline_clamp:
                eng.warm_decode_ladder()
            # the speculative plane flips between the spec and plain
            # executables adaptively: warm both ladders, so accept-rate
            # swings add no shape key
            if eng.spec_k > 0:
                if not eng.deadline_clamp:
                    eng.warm_decode_ladder()
                eng.warm_speculative()
            if eng.spill is not None:
                eng.warm_spill()
            # chunked shared-prefix admissions key per TAIL bucket: run
            # them now so the first sharer join adds no shape key
            if eng.chunked_prefill:
                eng.warm_chunked()

    def _work_left(self) -> bool:
        eng = self._engine()
        return (self._pending is not None or bool(self._inflight)
                or (eng is not None and (eng.active_count() > 0
                                         or eng.pending_count() > 0))
                or any(v.queue for v in self._vfms().values()))

    def run(self, trace, *, drain: bool = True,
            max_wall: Optional[float] = None, on_tick=None) -> list[Request]:
        """Replay a trace (``Request.arrival`` = offset seconds from start)
        against the wall clock: requests are submitted when their arrival
        time passes (rebased to ``perf_counter`` so latency stats line up)
        and the loop ticks between arrivals. ``on_tick(loop, rel)`` runs
        before every tick — the chaos-injection harness's hook
        (``serving.faults``). Returns the requests served by THIS call
        (``self.served`` accumulates across calls)."""
        trace = sorted(trace, key=lambda r: r.arrival)
        t0 = time.perf_counter()
        n0 = len(self.served)
        i = 0
        while True:
            now = time.perf_counter()
            if max_wall is not None and now - t0 > max_wall:
                break
            rel = now - t0
            if on_tick is not None:
                on_tick(self, rel)
            while i < len(trace) and trace[i].arrival <= rel:
                r = trace[i]
                r.arrival = t0 + r.arrival          # rebase to wall clock
                self.submit(r, now)
                i += 1
            kind = self.tick(now)
            if kind == "idle":
                if i >= len(trace):
                    if not drain or not self._work_left():
                        break
                else:
                    wait = t0 + trace[i].arrival - time.perf_counter()
                    time.sleep(max(0.0, min(self.idle_sleep, wait)))
        self._flush()
        return self.served[n0:]

    # ---- legacy synchronous contract (FMplexServer.step) ----
    def step_batch(self) -> Optional[Batch]:
        """Dispatch + execute ONE mixed BFQ batch synchronously and return it
        (or None). Pooled members run the double-buffered path; generative
        members stream through the decode engine (mid-flight admission into
        free slots, chunked decode, token-level charging) until all of THIS
        batch's streams retire. Loop-admitted streams sharing the pool retire
        normally along the way."""
        # a still-pending pooled batch from a prior tick() must resolve
        # before this path serves anything newer (its requests are already
        # off the queues and executed — leaving them unstamped while step()
        # keeps returning batches would wedge callers polling finish_time)
        self._flush()
        now = time.perf_counter()
        batch = self.srv.next_batch(self.fm_id, now)
        if batch is None:
            return None
        sched, vfms = self.sched, self._vfms()
        pooled = [r for r in batch.requests if is_pooled(r)]
        gen = [r for r in batch.requests if is_generative(r)]
        results: dict[int, object] = {}
        pend = None
        if pooled:
            pb = Batch(pooled, group_sub_batches(pooled, vfms))
            pend = self._executor().execute_async(pb, vfms)
        if gen:
            results.update(self._drain_gen(gen, sched, vfms))
        if pend is not None:
            results.update(pend.resolve())
        self._stamp_head_failures(batch, results)
        self.srv.on_complete(self.fm_id, batch, time.perf_counter())
        for r in batch.requests:
            r.result = results[r.rid]
        return batch

    def _drain_gen(self, reqs, sched, vfms) -> dict[int, object]:
        """Serve this batch's generative requests to completion (the old
        drain-synchronous contract). No token charges here: this path's
        requests were dispatched at their FULL arrival price and are
        retro-corrected by ``on_complete`` in ``step_batch`` — charging
        chunks on top would double-price them."""
        eng = self._engine(create=True)
        pending = collections.deque(reqs)
        mine = {r.rid: r for r in reqs}
        out: dict[int, object] = {}

        def mine_active():
            # paged pools may DEFER a join into the engine's pending queue;
            # those streams are still ours and must be drained to completion
            return any(s is not None and s.rid in mine for s in eng.slots) \
                or any(r in mine for r in eng.pending_rids())

        while pending or mine_active():
            now = time.perf_counter()
            while pending and eng.free_slots():
                self._admit_one(eng, vfms, pending.popleft())
            # loop-admitted streams sharing the pool WERE dispatched at
            # deferred charge — their chunks still bill token-level, at
            # the tokens each stream actually COMMITTED (the rid-keyed
            # charge log filters OUR full-arrival-priced streams out)
            loop_active = collections.Counter(
                s.task_id for s in eng.slots
                if s is not None and not s.done and s.rid in self._inflight)
            retired = eng.step_chunk()
            committed = eng.take_decode_charges() \
                if hasattr(eng, "take_decode_charges") else None
            if committed is not None:
                agg: dict[str, float] = collections.Counter()
                for (tid, rid), n in committed.items():
                    if rid in self._inflight:
                        agg[tid] += n
                if agg:
                    sched.charge_tokens(vfms, agg, now)
            elif loop_active:
                sched.charge_tokens(
                    vfms, {t: n * eng.chunk for t, n in loop_active.items()},
                    now)
            # loop-admitted deferred joins that got in during this chunk
            # still bill their prompt at admission; OURS are skipped inside
            # (full arrival price, see the docstring above)
            self._charge_admissions(sched, vfms, now)
            done_t = time.perf_counter()
            # terminal rejections (deadline sweep inside step_chunk) of OUR
            # requests must land in `out` or the while-loop never ends
            self._handle_rejected(eng, vfms, done_t, mine=mine, out=out)
            for s in retired:
                r = mine.get(s.rid)
                if r is None:         # a loop-admitted stream retired too
                    self._retire(s, vfms, done_t)
                    continue
                r.first_token_time = s.t_first
                # per-request completion: a short request co-batched with a
                # long one finishes at ITS retire chunk (on_complete keeps an
                # already-stamped finish_time)
                r.finish_time = done_t
                if s.status != "ok":
                    r.status = s.status
                    r.error = f"stream {s.status}"
                    self.failures[s.status] += 1
                out[s.rid] = np.asarray(s.tokens, np.int32)
        return out

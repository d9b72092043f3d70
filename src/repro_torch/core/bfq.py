"""Batch-aware Fair Queueing (BFQ) — paper §4.2 — plus scheduler baselines.

BFQ extends start-time fair queueing (STFQ) from per-request ordering to batch
formation:

  arrival:    S_i^j = max(F_i^{j-1}, v),  F_i^j = S_i^j + l / w_i        (1, 2)
  v         = max_i F_i^last over each task's most recently dispatched request
  formation:  take requests in start-tag order; stop at B_max (profiled
              throughput knee) or when admitting one more would push ANY
              selected request past its SLO deadline.
  adapters:   requests sharing the backbone co-batch; adapter-incompatible
              requests execute as sequential compatible sub-batches (Fig. 5c).
  correction: after a batch of size b executes, retro-correct tags of the
              dispatched requests and every queued request of participating
              tasks with the batch-dependent service time
              F_i^j = S_i^j + l_i(b) / w_i                                (3)

Token-level plane (event-loop serving, ``core.serve_loop``): generative
streams consume service in decode chunks, not whole requests, so the loop
charges each participating task ``charge_tokens`` work units per unit of
device time — a decode chunk charges the tokens the task's streams actually
COMMITTED that chunk (the engine's rid-keyed charge log: under speculative
decoding a high-accept stream commits up to ``spec_k + 1`` tokens per scan
step while a zero-accept co-batched stream commits one, and their tasks are
billed accordingly; on engines without the log this degenerates to the old
``chunk × active_slots(task)`` flat split), a prefill admission charges the
true prompt length. Charges advance the
task's virtual finish time by ``l(1) · tokens / w_i`` (the same per-token
price arrival tags use), so weighted max-min sharing holds across the pooled
and generative planes at token granularity: the loop dispatches whichever
unit of work — pooled sub-batch, admission, or decode chunk — carries the
smallest virtual tag.

All schedulers are event-driven and time-source-agnostic: the same code runs
under the discrete-event simulator and the real-execution server.
"""
from __future__ import annotations

import collections
from typing import Optional

from repro_torch.core.profile import FMProfile
from repro_torch.core.request import Batch, Request
from repro_torch.core.vfm import VFM


def group_sub_batches(requests: list[Request], vfms: dict[str, VFM]):
    """Adapter-compatibility grouping: one backbone co-batch, sequential
    adapter sub-batches; base-model requests (no adapter) need no sub-batch."""
    by_adapter: dict[Optional[str], list[Request]] = collections.defaultdict(list)
    for r in requests:
        aid = vfms[r.task_id].extensions.adapter_id
        by_adapter[aid].append(r)
    return [(aid, rs) for aid, rs in by_adapter.items()]


class SchedulerBase:
    name = "base"
    # True when charge_tokens/task_vtime maintain a real token-level virtual
    # clock; schedulers without one (STFQ, FIFO) need the event loop to
    # alternate planes instead of comparing their meaningless decode tags
    token_accounting = False

    def __init__(self, profile: FMProfile):
        self.profile = profile

    def on_arrival(self, vfm: VFM, req: Request, now: float):
        vfm.enqueue(req)

    def next_batch(self, vfms: dict[str, VFM], now: float, *, pred=None,
                   limit: Optional[int] = None,
                   defer_charge: bool = False) -> Optional[Batch]:
        raise NotImplementedError

    def exec_time(self, batch: Batch) -> float:
        sizes = [len(rs) for aid, rs in batch.sub_batches if aid is not None]
        return self.profile.exec_time(batch.size, sizes)

    def on_complete(self, batch: Batch, vfms: dict[str, VFM], now: float):
        pass

    # ---- token-level plane (event-loop serving) ----
    def charge_tokens(self, vfms: dict[str, VFM],
                      tokens_by_task: dict[str, float], now: float):
        """Charge mid-request service (decode chunks, prefill admissions) to
        each task's virtual time. No-op for schedulers without virtual time —
        the event loop then degrades to its tie-break order."""

    def task_vtime(self, task_id: str) -> float:
        """Virtual start tag of the task's NEXT unit of in-flight work (its
        decode stream's next chunk). 0.0 when the scheduler has no notion."""
        return 0.0

    def peek_tag(self, vfms: dict[str, VFM], pred=None) -> float:
        """Smallest start tag among queued requests matching ``pred``
        (inf when none) — what the event loop compares plane tags against."""
        tags = [r.start_tag for v in vfms.values() for r in v.queue
                if pred is None or pred(r)]
        return min(tags) if tags else float("inf")

    def peek_request(self, vfms: dict[str, VFM], pred=None):
        """The queued request the next dispatch would serve (smallest start
        tag, rid tie-break), WITHOUT popping it — the event loop inspects it
        (e.g. its prompt length) to decide whether the decode pool can admit
        it yet (memory-aware admission)."""
        best = None
        for v in vfms.values():
            for r in v.queue:
                if pred is not None and not pred(r):
                    continue
                if best is None or (r.start_tag, r.rid) < (best.start_tag,
                                                           best.rid):
                    best = r
        return best

    def on_cancel(self, vfms: dict[str, VFM], req: Request) -> bool:
        """Remove a still-QUEUED request (client cancel / deadline shed)
        before it is ever dispatched. Returns False when the request is not
        queued (already dispatched — nothing to unwind here). Baselines
        without tag chains need nothing more; BFQ refunds the arrival tags."""
        v = vfms.get(req.task_id)
        if v is None or req not in v.queue:
            return False
        v.queue.remove(req)
        return True

    def snapshot_tags(self) -> Optional[dict]:
        """Virtual-time state for an engine snapshot (durability layer).
        Baselines carry no cross-request tag state — nothing to capture."""
        return None

    def restore_tags(self, tags: Optional[dict]):
        return None

    @staticmethod
    def _pop(vfms, selected):
        for r in selected:
            vfms[r.task_id].queue.remove(r)


class BFQ(SchedulerBase):
    """Batch-aware fair queueing (work-conserving, weighted)."""
    name = "bfq"
    token_accounting = True

    def __init__(self, profile: FMProfile):
        super().__init__(profile)
        self.v = 0.0                          # global virtual tag
        self._tail: dict[str, float] = {}     # F of task's last ENQUEUED request
        self._last_dispatched: dict[str, float] = {}  # F of last DISPATCHED

    def snapshot_tags(self) -> dict:
        """Capture the virtual-time state (global tag + per-task finish-tag
        chains) for the durability layer: a restored engine resumes with the
        SAME fair-share history, so a reset cannot reset anyone's share."""
        return {"v": self.v, "tail": dict(self._tail),
                "last_dispatched": dict(self._last_dispatched)}

    def restore_tags(self, tags: Optional[dict]):
        if not tags:
            return
        self.v = float(tags["v"])
        self._tail = dict(tags["tail"])
        self._last_dispatched = dict(tags["last_dispatched"])

    def on_arrival(self, vfm: VFM, req: Request, now: float):
        """Eqs. 1-2. Token-based FMs (paper §4.2): the expected service time
        scales with the request's token count, so heavier requests advance the
        task's finish tags proportionally — same accounting principle across
        request-level and token-level runtimes, no separate token policy."""
        prev_f = self._tail.get(vfm.task_id, 0.0)
        req.v_at_arrival = self.v
        req.start_tag = max(prev_f, self.v)
        l1 = self.profile.l(1) * max(req.tokens, 1e-9)
        req.finish_tag = req.start_tag + l1 / vfm.weight
        self._tail[vfm.task_id] = req.finish_tag
        vfm.enqueue(req)

    def next_batch(self, vfms: dict[str, VFM], now: float, *, pred=None,
                   limit: Optional[int] = None,
                   defer_charge: bool = False) -> Optional[Batch]:
        """Form one batch in start-tag order. ``pred`` restricts formation to
        matching requests (the event loop separates pooled and generative
        work units); ``limit`` caps the batch below B_max (e.g. at the decode
        pool's free slot count).

        ``defer_charge``: dispatch bookkeeping advances the task's virtual
        time only to the request's START tag, not its finish tag — for
        streams whose service is charged incrementally via ``charge_tokens``
        (admission prefill + per-chunk). Without this the stream would be
        double-priced: once by the arrival finish tag's full prompt+budget
        estimate, again by the actual per-token charges."""
        queued = [r for v in vfms.values() for r in v.queue
                  if pred is None or pred(r)]
        if not queued:
            return None
        queued.sort(key=lambda r: (r.start_tag, r.rid))
        b_cap = self.profile.b_max if limit is None \
            else min(self.profile.b_max, limit)
        selected: list[Request] = []
        # incremental formation state (O(B_max) per dispatch instead of
        # O(B_max^2)): adapter-size counter and the tightest deadline among
        # still-satisfiable candidates are both maintained as requests join
        sizes: collections.Counter = collections.Counter()
        l1 = self.profile.l(1)
        min_deadline = float("inf")
        for r in queued:
            if len(selected) >= b_cap:
                break
            aid = vfms[r.task_id].extensions.adapter_id
            sizes[aid] += 1
            a_sizes = [n for a, n in sizes.items() if a is not None]
            done = now + self.profile.exec_time(len(selected) + 1, a_sizes)
            cand_deadline = min(
                min_deadline,
                r.deadline() if r.deadline() >= now + l1 else float("inf"))
            # stop extending if it would push a STILL-SATISFIABLE request past
            # its deadline (already-expired requests are served best-effort —
            # they cannot be "pushed past" anything)
            if selected and done > cand_deadline:
                sizes[aid] -= 1
                break
            selected.append(r)
            min_deadline = cand_deadline
        self._pop(vfms, selected)
        batch = Batch(selected, group_sub_batches(selected, vfms))
        # dispatch bookkeeping: v = max_i F_i^last over dispatched requests
        for r in selected:
            tag = r.start_tag if defer_charge else r.finish_tag
            self._last_dispatched[r.task_id] = max(
                self._last_dispatched.get(r.task_id, 0.0), tag)
            r.dispatch_time = now
        self.v = max([self.v] + list(self._last_dispatched.values()))
        return batch

    def on_complete(self, batch: Batch, vfms: dict[str, VFM], now: float):
        """Eq. 3 retro-correction with the realized batch size."""
        b = batch.size
        lb = self.profile.effective_per_request(b)
        per_task = collections.Counter(r.task_id for r in batch.requests)
        for tid in per_task:
            vfm = vfms[tid]
            # correct the dispatched requests' finish tags
            f_last = self._last_dispatched.get(tid, 0.0)
            for r in batch.requests:
                if r.task_id != tid:
                    continue
                r.finish_tag = r.start_tag + lb * max(r.tokens, 1e-9) / vfm.weight
                f_last = max(f_last, r.finish_tag)
            self._last_dispatched[tid] = f_last
            # re-chain the queued requests of this task (Eq. 3)
            prev = f_last
            for r in vfm.queue:
                r.start_tag = max(prev, r.v_at_arrival)
                r.finish_tag = r.start_tag + lb * max(r.tokens, 1e-9) / vfm.weight
                prev = r.finish_tag
            self._tail[tid] = prev if vfm.queue else f_last
        self.v = max([self.v] + list(self._last_dispatched.values()))

    def charge_tokens(self, vfms: dict[str, VFM],
                      tokens_by_task: dict[str, float], now: float):
        """Token-level virtual-time accounting (event-loop plane).

        Each charged task's virtual finish advances by ``l(1)·tokens/w``
        chained TASK-LOCALLY from its last finish — the same way a backlogged
        task's queued requests chain off its tail — so a lighter-weight
        stream falls behind proportionally and weighted shares hold at token
        granularity (chaining from the global ``v`` instead would reset the
        stream's lag every chunk and collapse sharing to 1:1). A stream
        cannot bank credit by idling: its slots only exist between an
        admission (whose arrival tag was clamped to ``v``) and its retire.
        The task's QUEUED requests are re-chained off the new finish (Eq. 3
        style): without this, requests enqueued before a long decode chunk
        would keep stale, too-early tags and jump the fair order at their
        next admission."""
        l1 = self.profile.l(1)
        for tid, toks in tokens_by_task.items():
            if toks <= 0:
                continue
            vfm = vfms.get(tid)
            w = vfm.weight if vfm is not None else 1.0
            start = self._last_dispatched.get(tid, self.v)
            f = start + l1 * toks / w
            self._last_dispatched[tid] = f
            if vfm is not None:
                prev = f
                for r in vfm.queue:
                    r.start_tag = max(prev, r.v_at_arrival)
                    r.finish_tag = r.start_tag + \
                        l1 * max(r.tokens, 1e-9) / w
                    prev = r.finish_tag
                self._tail[tid] = prev if vfm.queue else f
        self.v = max([self.v] + list(self._last_dispatched.values()))

    def on_cancel(self, vfms: dict[str, VFM], req: Request) -> bool:
        """Cancel refund: a queued request's arrival advanced the task's
        enqueue tail (Eqs. 1-2), so every request queued BEHIND it chains off
        an l(1)·tokens/w slice of service the task will now never receive —
        a shed/cancelled request would permanently distort the task's fair
        share. Removing it re-chains the remaining queue off the task's last
        DISPATCHED finish (exactly the Eq. 3 re-chain ``on_complete`` and
        ``charge_tokens`` perform), restoring the tags to what they would
        have been had the request never arrived."""
        if not super().on_cancel(vfms, req):
            return False
        tid = req.task_id
        vfm = vfms[tid]
        l1 = self.profile.l(1)
        prev = self._last_dispatched.get(tid, 0.0)
        for r in vfm.queue:
            r.start_tag = max(prev, r.v_at_arrival)
            r.finish_tag = r.start_tag + l1 * max(r.tokens, 1e-9) / vfm.weight
            prev = r.finish_tag
        self._tail[tid] = prev
        return True

    def task_vtime(self, task_id: str) -> float:
        return self._last_dispatched.get(task_id, 0.0)


class STFQ(SchedulerBase):
    """Classical start-time fair queueing (S-STFQ baseline): fair tags, but
    per-request service — batching disabled."""
    name = "stfq"

    def __init__(self, profile: FMProfile):
        super().__init__(profile)
        self.v = 0.0
        self._tail: dict[str, float] = {}

    def on_arrival(self, vfm: VFM, req: Request, now: float):
        prev_f = self._tail.get(vfm.task_id, 0.0)
        req.start_tag = max(prev_f, self.v)
        req.finish_tag = req.start_tag + self.profile.l(1) / vfm.weight
        self._tail[vfm.task_id] = req.finish_tag
        vfm.enqueue(req)

    def next_batch(self, vfms, now, *, pred=None, limit=None,
                   defer_charge=False):
        queued = [r for v in vfms.values() for r in v.queue
                  if pred is None or pred(r)]
        if not queued:
            return None
        r = min(queued, key=lambda r: (r.start_tag, r.rid))
        self._pop(vfms, [r])
        r.dispatch_time = now
        self.v = max(self.v, r.start_tag)
        return Batch([r], group_sub_batches([r], vfms))


class FIFOBatch(SchedulerBase):
    """S-BE baseline: arrival-order batching up to B_max, no fairness."""
    name = "s-be"

    def next_batch(self, vfms, now, *, pred=None, limit=None,
                   defer_charge=False):
        queued = [r for v in vfms.values() for r in v.queue
                  if pred is None or pred(r)]
        if not queued:
            return None
        queued.sort(key=lambda r: (r.arrival, r.rid))
        b_cap = self.profile.b_max if limit is None \
            else min(self.profile.b_max, limit)
        selected = queued[: b_cap]
        self._pop(vfms, selected)
        for r in selected:
            r.dispatch_time = now
        return Batch(selected, group_sub_batches(selected, vfms))


SCHEDULERS = {"bfq": BFQ, "stfq": STFQ, "s-be": FIFOBatch}

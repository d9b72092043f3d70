"""Per-server FMplex instance (paper §5/§6).

Maintains the local vFM registry, task queues, scheduler state, and bindings
from vFMs to physical FM instances. The same object serves both planes:

  * real plane  — the event-loop serving plane (``core.serve_loop``): one
    clock per FM under which pooled sub-batches, prefill admissions, and
    decode chunks interleave by BFQ virtual tag (``serve_loop(fm_id)``);
    ``step`` keeps the legacy synchronous one-batch contract on top of it;
  * sim plane   — the discrete-event simulator drives ``on_arrival`` /
    ``next_batch`` / ``on_complete`` with virtual time.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.bfq import SCHEDULERS, SchedulerBase
from repro_torch.core.decode_engine import DecodeEngine
from repro_torch.core.executor import Executor
from repro_torch.core.physical import PhysicalFM
from repro_torch.core.profile import FMProfile
from repro_torch.core.request import Batch, Request
from repro_torch.core.serve_loop import ServeLoop
from repro_torch.core.vfm import VFM, TaskExtensions


class FMplexServer:
    def __init__(self, server_id: str = "s0"):
        self.server_id = server_id
        self.fms: dict[str, PhysicalFM] = {}          # physical FM instances
        self.executors: dict[str, Executor] = {}      # persistent, one per FM
        self.engines: dict[str, DecodeEngine] = {}    # persistent decode pools
        self.loops: dict[str, ServeLoop] = {}         # event-loop plane per FM
        self.profiles: dict[str, FMProfile] = {}
        self.schedulers: dict[str, SchedulerBase] = {}
        self.vfms: dict[str, VFM] = {}                # task_id -> vFM
        self.bindings: dict[str, str] = {}            # task_id -> fm instance id

    # ---- deployment control (driven by FMplex-Controller) ----
    def deploy_fm(self, fm_id: str, fm: Optional[PhysicalFM] = None,
                  profile: Optional[FMProfile] = None, scheduler: str = "bfq"):
        if fm is not None:
            self.fms[fm_id] = fm
            self.executors[fm_id] = Executor(fm)
            profile = profile or fm.profile or fm.calibrate()
        assert profile is not None
        self.profiles[fm_id] = profile
        self.schedulers[fm_id] = SCHEDULERS[scheduler](profile)

    def undeploy_fm(self, fm_id: str):
        self.fms.pop(fm_id, None)
        self.executors.pop(fm_id, None)
        self.engines.pop(fm_id, None)
        self.loops.pop(fm_id, None)
        self.profiles.pop(fm_id)
        self.schedulers.pop(fm_id)

    def decode_engine(self, fm_id: str, **kwargs) -> DecodeEngine:
        """The FM's persistent continuous-batching decode pool (created on
        first use; ``kwargs`` configure it then — slots, chunk, max_new...).
        Passing kwargs once the pool exists raises: silently ignoring them
        (e.g. a ``max_new`` larger than the allocated pool, which ``join``
        would quietly clamp to) has bitten before."""
        eng = self.engines.get(fm_id)
        if eng is None:
            eng = self.engines[fm_id] = DecodeEngine(self.fms[fm_id], **kwargs)
        elif kwargs:
            raise ValueError(
                f"decode engine for {fm_id!r} already exists; it cannot be "
                f"reconfigured with {sorted(kwargs)} (undeploy_fm first)")
        return eng

    def serve_loop(self, fm_id: str, **kwargs) -> ServeLoop:
        """The FM's persistent event-loop serving plane (created on first
        use; ``kwargs`` configure it then — e.g. ``engine_kwargs`` for the
        decode pool it admits into). Like ``decode_engine``, kwargs against
        an existing loop raise instead of being silently dropped."""
        loop = self.loops.get(fm_id)
        if loop is None:
            loop = self.loops[fm_id] = ServeLoop(self, fm_id, **kwargs)
        elif kwargs:
            raise ValueError(
                f"serve loop for {fm_id!r} already exists; it cannot be "
                f"reconfigured with {sorted(kwargs)} (undeploy_fm first)")
        return loop

    def bind_task(self, task_id: str, fm_id: str, *, weight: float = 1.0,
                  slo=None, extensions: Optional[TaskExtensions] = None) -> VFM:
        vfm = VFM(task_id, weight=weight, slo=slo, extensions=extensions,
                  backbone=fm_id)
        vfm.bound_fm = fm_id
        self.vfms[task_id] = vfm
        self.bindings[task_id] = fm_id
        fm = self.fms.get(fm_id)
        if fm is not None and extensions is not None:
            if extensions.decoder is not None:
                fm.attach_head(task_id, extensions.decoder)
            if extensions.adapter_id is not None and \
                    extensions.adapter_weights is not None and \
                    extensions.adapter_id not in fm.adapters.ids:
                fm.adapters.add(extensions.adapter_id, extensions.adapter_weights)
        return vfm

    def unbind_task(self, task_id: str) -> Optional[dict]:
        """Detach a task, returning its movable snapshot (elastic adaptation).

        Frees the task's adapter slot when the binding owns the adapter (its
        extensions carry the weights — the symmetric case to bind_task adding
        it) and no other task bound to the same FM shares it: the store has
        finite slot capacity, so lifetime task churn must not accumulate dead
        adapters. The snapshot keeps the weights; rebinding re-adds them.
        Adapters registered out-of-band (``fm.adapters.new``) are left alone.
        """
        vfm = self.vfms.pop(task_id, None)
        if vfm is None:
            return None
        fm_id = self.bindings.pop(task_id)
        fm = self.fms.get(fm_id)
        if fm is not None:
            fm.detach_task(task_id)
            ext = vfm.extensions
            aid = ext.adapter_id if ext is not None else None
            if aid is not None and ext.adapter_weights is not None and not any(
                    v.extensions is not None
                    and v.extensions.adapter_id == aid
                    and self.bindings.get(t) == fm_id
                    for t, v in self.vfms.items()):
                fm.adapters.remove(aid)
        return vfm.snapshot()

    def rebind_snapshot(self, snap: dict, fm_id: str) -> VFM:
        vfm = VFM.restore(snap, backbone=fm_id)
        vfm.bound_fm = fm_id
        self.vfms[vfm.task_id] = vfm
        self.bindings[vfm.task_id] = fm_id
        fm = self.fms.get(fm_id)
        ext = vfm.extensions
        if fm is not None and ext is not None:
            if ext.decoder is not None:
                fm.attach_head(vfm.task_id, ext.decoder)
            if ext.adapter_id is not None and ext.adapter_weights is not None \
                    and ext.adapter_id not in fm.adapters.ids:
                fm.adapters.add(ext.adapter_id, ext.adapter_weights)
        return vfm

    # ---- scheduler-facing (both planes) ----
    def vfms_on(self, fm_id: str) -> dict[str, VFM]:
        return {t: v for t, v in self.vfms.items() if self.bindings[t] == fm_id}

    def on_arrival(self, req: Request, now: float):
        vfm = self.vfms[req.task_id]
        self.schedulers[self.bindings[req.task_id]].on_arrival(vfm, req, now)

    def next_batch(self, fm_id: str, now: float) -> Optional[Batch]:
        return self.schedulers[fm_id].next_batch(self.vfms_on(fm_id), now)

    def on_complete(self, fm_id: str, batch: Batch, now: float):
        sched = self.schedulers[fm_id]
        for r in batch.requests:
            if r.finish_time is None:     # decode path stamps per-request
                r.finish_time = now       # completion at its retire chunk
            v = self.vfms.get(r.task_id)
            if v is not None:
                # terminal failures (head_failed, quarantined, ...) count
                # dropped; service is billed either way — the device ran
                if r.ok:
                    v.acct.completed += 1
                else:
                    v.acct.dropped += 1
                v.acct.service_time += \
                    sched.profile.effective_per_request(batch.size)
        sched.on_complete(batch, self.vfms_on(fm_id), now)

    # ---- real-plane serving (event-loop plane) ----
    def step(self, fm_id: str) -> Optional[Batch]:
        """Dispatch + execute one batch synchronously; returns it (or None).

        Legacy contract kept on top of the event-loop plane: one mixed BFQ
        batch — pooled members through the double-buffered executor path,
        generative members through the FM's persistent ``DecodeEngine`` with
        mid-flight admission and token-level fair-share charging. For
        interleaved serving (pooled batches BETWEEN decode chunks), drive
        ``serve_loop(fm_id)`` directly instead."""
        return self.serve_loop(fm_id).step_batch()

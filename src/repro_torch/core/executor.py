"""Batch executor: runs BFQ-formed batches against a physical FM (real plane).

The executor owns both halves of the serve data path (paper Fig. 4 steps 4-7,
segmented-LoRA formulation), split by workload:

**Pooled-feature path** (``execute`` — one shared forward per batch):

  1. adapter sort   — the scheduler's co-batch arrives as adapter-compatible
     sub-batches (``Batch.sub_batches``); the executor concatenates them so
     rows sharing an adapter are contiguous, and maps each row's adapter id
     to its slot in the FM's ``AdapterStore`` (sentinel == store capacity
     means "base model, no adapter").
  2. block metadata — ``PhysicalFM.run_batch_device`` flattens the sorted
     batch token-major and builds the SGMV metadata ONCE per batch
     composition on the host (memoized in ``PhysicalFM.seg_meta_cache``).
  3. SGMV backbone  — one shared backbone pass; q/v LoRA deltas dispatch
     through ``kernels.ops.segmented_lora`` (the CUDA kernel on the GPU, its
     plain version on the CPU) — no per-request (B, d, r) weight
     materialization.
  4. task heads     — pooled features STAY ON DEVICE; each task's decoder
     head is first tried on the device tensor of its rows (padded to the
     batch bucket). Heads that do not take tensors (numpy-bound) fall back
     to host-side batched or per-row application — verdicts are probed once
     and cached per (task, head) pair.

**Double-buffered dispatch** (``execute_async``): the pooled path splits into
host prep + device dispatch (returns immediately: CUDA launches are
asynchronous) and a deferred ``resolve`` (head application + host sync). The
event loop (``core.serve_loop``) dispatches tick N+1 — whose ``np.stack``
co-batch assembly runs on the host while the device still executes tick N —
BEFORE resolving tick N, so host prep and device compute overlap.
``execute`` keeps the synchronous contract (``execute_async(...).resolve()``).

Generative requests (``Request.max_new_tokens > 0``) are served by the event
loop directly: admission prefill into the FM's persistent ``DecodeEngine``
slot pool, then chunked decode interleaved with pooled batches (see
``core.serve_loop.ServeLoop``).

Batch shapes are bucketed (batch size AND adapter slot count), so steady-state
serving reuses the same static-shape keys as tasks come and go within slot
capacity.
"""
from __future__ import annotations

import collections
import dataclasses
import time
import zlib

import numpy as np
import torch

from repro_torch.core.physical import PhysicalFM
from repro_torch.core.request import Batch
from repro_torch.core.vfm import VFM


@dataclasses.dataclass
class HeadFailure:
    """Sentinel result for rows whose task head raised past the executor's
    bounded retries. Per-task failure isolation: one misbehaving head fails
    ONLY its own task's requests — the shared backbone pass and every other
    task's head in the same co-batch resolve normally. The serve loop maps
    these to ``status == "head_failed"``."""
    task_id: str
    error: str


class PendingBatch:
    """An in-flight pooled batch: host prep + device dispatch have happened,
    head application and the host sync are deferred to ``resolve()``. Holding
    one of these while assembling the next co-batch is what overlaps tick
    N+1's host prep with tick N's device step (double buffering)."""

    def __init__(self, executor: "Executor", batch: Batch, order, feats_dev):
        self._executor = executor
        self.batch = batch
        self._order = order
        self._feats_dev = feats_dev
        self._out = None

    def resolve(self) -> dict[int, object]:
        """Block on the device step, apply per-task heads, return
        {request id: task output}. Idempotent."""
        if self._out is None:
            self._out = self._executor._finish(self._order, self._feats_dev)
        return self._out


class Executor:
    def __init__(self, fm: PhysicalFM, *, head_retries: int = 2,
                 head_backoff_s: float = 0.005, retry_jitter: float = 0.5,
                 retry_seed: int = 0):
        self.fm = fm
        # task_id -> (head object, mode); the head is stored so a rebound task
        # with a NEW head re-probes (id()-keyed caching would let a recycled
        # id inherit a stale verdict on this persistent object). mode is
        # "device" (called on the device tensor), "batched" (host,
        # vectorized) or "row".
        self._head_mode: dict[str, tuple[object, str]] = {}
        # per-task head fault isolation (HeadFailure): bounded retries with
        # exponential backoff before the task's rows fail terminally
        self.head_retries = max(0, int(head_retries))
        self.head_backoff_s = float(head_backoff_s)
        self.head_failures = collections.Counter()  # task_id -> give-ups
        self.retries = 0                            # head re-attempts (all)
        # bounded seeded retry jitter: a purely deterministic exponential
        # backoff retries co-failing tasks in LOCKSTEP (every victim of one
        # transient fault hammers the recovering dependency at the same
        # instants); each task's delays are scaled by a per-task seeded
        # factor in [1-jitter, 1+jitter] so retry schedules desynchronize
        # while staying reproducible and bounded
        self.retry_jitter = min(max(float(retry_jitter), 0.0), 0.95)
        self.retry_seed = int(retry_seed)
        self._retry_rng: dict[str, np.random.RandomState] = {}
        self.retry_delays: dict[str, list[float]] = collections.defaultdict(
            list)                                   # task_id -> slept delays

    @staticmethod
    def _bucketed_rows(feats_dev, idxs: list[int]):
        """Gather a task's feature rows padded to the batch bucket (row 0
        repeated), so a device head sees one shape per bucket whatever
        sub-batch size the event loop forms."""
        from repro_torch.core.physical import bucket_for
        pad = bucket_for(len(idxs)) - len(idxs)
        rows = torch.as_tensor(idxs + [idxs[0]] * pad, device=feats_dev.device)
        return feats_dev[rows]

    @staticmethod
    def _host(y):
        if isinstance(y, torch.Tensor):
            return y.detach().float().cpu().numpy()
        return np.asarray(y)

    def _run_device_head(self, head, feats_dev, idxs: list[int]):
        y = self._host(head(self._bucketed_rows(feats_dev, idxs)))
        return list(y[:len(idxs)])

    def _apply_head(self, tid: str, head, feats_dev, feats_fn,
                    idxs: list[int]):
        """Apply one task's head over its feature sub-array — on the device
        tensor when the head takes one, host-batched when it vectorizes,
        per-row otherwise. ``feats_fn`` materializes the host copy of the
        features lazily, so steady-state batches whose heads all run on the
        device never pull the feature array to the host. The verdict is
        probed on the head's first multi-row batch: its batched output must
        match per-row application on the first and last rows (a shape check
        alone is not enough — a head that reduces over its input returns the
        right shape with cross-row-contaminated values). Heads are assumed
        pure over features. n_t == 1 always goes per-row."""
        if len(idxs) <= 1:
            return [head(feats_fn()[i]) for i in idxs]
        cached = self._head_mode.get(tid)
        if cached is not None and cached[0] is head:
            mode = cached[1]
            if mode == "device":
                return self._run_device_head(head, feats_dev, idxs)
            if mode == "batched":
                return list(head(feats_fn()[idxs]))
            return [head(feats_fn()[i]) for i in idxs]
        feats = feats_fn()                          # probing needs host rows
        if not np.ptp(feats[idxs], axis=0).any():
            # identical probe rows can't discriminate batched from reducing
            # heads (e.g. all-default zero payloads) — apply per-row and defer
            # the verdict to a batch with distinct rows
            return [head(feats[i]) for i in idxs]
        row0 = self._host(head(feats[idxs[0]]))
        rowN = self._host(head(feats[idxs[-1]]))  # row-position-dependent

        def matches(y):
            return (getattr(y, "shape", (None,))[0] == len(idxs)
                    and np.asarray(y[0]).shape == row0.shape
                    and np.allclose(np.asarray(y[0]), row0, atol=1e-3)
                    and np.asarray(y[-1]).shape == rowN.shape
                    and np.allclose(np.asarray(y[-1]), rowN, atol=1e-3))

        # device first: the head called on the device rows
        try:
            y = self._run_device_head(head, feats_dev, idxs)
            if matches(np.stack(y)):
                self._head_mode[tid] = (head, "device")
                return y
        except Exception:           # noqa: BLE001 — probing: any failure
            pass                    # means "not a device head"
        try:
            y = head(feats[idxs])
            ok = matches(y)
        except Exception:           # noqa: BLE001 — probing, as above
            y, ok = None, False
        self._head_mode[tid] = (head, "batched" if ok else "row")
        if ok:
            return list(y)                    # reuse the probed batched output
        return [head(feats[i]) for i in idxs]

    def _retry_factor(self, tid: str) -> float:
        """Per-task jitter multiplier in [1 - retry_jitter, 1 + retry_jitter),
        drawn from a stream seeded by (task id, retry_seed) — stable across
        processes (crc32, not the salted builtin hash) so retry schedules
        are reproducible yet distinct per task."""
        if self.retry_jitter <= 0.0:
            return 1.0
        rng = self._retry_rng.get(tid)
        if rng is None:
            seed = (zlib.crc32(tid.encode()) ^ self.retry_seed) & 0xFFFFFFFF
            rng = self._retry_rng[tid] = np.random.RandomState(seed)
        return 1.0 + self.retry_jitter * (2.0 * rng.random_sample() - 1.0)

    def _apply_head_isolated(self, tid: str, head, feats_dev, feats_fn,
                             idxs: list[int]):
        """Failure-isolation wrapper around ``_apply_head``: a raising head
        is retried ``head_retries`` times with exponential backoff (transient
        faults — a device OOM, a flaky host hook — usually clear), and a head
        that keeps raising fails ONLY this task's rows with ``HeadFailure``
        sentinels. The cached probe verdict is dropped on every
        failure so a head that recovers later re-probes from scratch instead
        of replaying a stale mode. Backoff delays carry bounded per-task
        seeded jitter (``retry_jitter``) so tasks co-failing on one shared
        transient fault do not retry in lockstep; delays are recorded in
        ``retry_delays`` per task."""
        delay = self.head_backoff_s
        err: Exception = RuntimeError("head failed")
        for attempt in range(self.head_retries + 1):
            try:
                return self._apply_head(tid, head, feats_dev, feats_fn, idxs)
            except Exception as e:      # noqa: BLE001 — isolation boundary
                err = e
                self._head_mode.pop(tid, None)
                if attempt < self.head_retries:
                    self.retries += 1
                    d = delay * self._retry_factor(tid)
                    self.retry_delays[tid].append(d)
                    time.sleep(d)
                    delay *= 2
        self.head_failures[tid] += 1
        fail = HeadFailure(task_id=tid,
                           error=f"{type(err).__name__}: {err}")
        return [fail] * len(idxs)

    def execute_async(self, batch: Batch, vfms: dict[str, VFM]) -> PendingBatch:
        """Host prep + device dispatch, NO host sync: returns a
        ``PendingBatch`` whose ``resolve()`` applies heads and syncs. CUDA
        launches are asynchronous, so the device works through the backbone
        pass while the caller assembles the next batch."""
        # adapter-sorted layout: concatenate sub-batches (one adapter each)
        order, embeds, aidx = [], [], []
        for adapter_id, reqs in batch.sub_batches:
            ai = self.fm.adapters.index(adapter_id)
            for r in reqs:
                order.append(r)
                x = r.payload
                if x is None:
                    x = np.zeros((self.fm.input_len, self.fm.cfg.d_model),
                                 np.float32)
                embeds.append(x)
                aidx.append(ai)
        feats_dev = self.fm.run_batch_device(np.stack(embeds),
                                             np.asarray(aidx, np.int32))
        return PendingBatch(self, batch, order, feats_dev)

    def execute(self, batch: Batch, vfms: dict[str, VFM]) -> dict[int, object]:
        """Synchronous contract: dispatch + resolve in one call.
        ``last_exec_s`` covers this whole call; it is only stamped here —
        for async batches the dispatch→resolve span includes whatever
        interleaved work ran in between, which is not an executor cost."""
        t0 = time.perf_counter()
        out = self.execute_async(batch, vfms).resolve()
        self.last_exec_s = time.perf_counter() - t0
        return out

    def _finish(self, order, feats_dev) -> dict[int, object]:
        """Deferred half of ``execute_async``: per-task heads over the device
        features + host sync."""
        # host copy, materialized lazily: only headless requests, probes, and
        # fallback-mode heads need it — all-device-head batches never pull
        feats_np: list = [None]

        def feats_fn():
            if feats_np[0] is None:
                feats_np[0] = feats_dev.float().cpu().numpy()
            return feats_np[0]

        # per-task batched head application over feature sub-arrays
        by_task: dict[str, list[int]] = {}
        for i, r in enumerate(order):
            by_task.setdefault(r.task_id, []).append(i)
        out = {}
        for tid, idxs in by_task.items():
            head = self.fm.heads.get(tid)
            ys = [feats_fn()[i] for i in idxs] if head is None \
                else self._apply_head_isolated(tid, head, feats_dev,
                                               feats_fn, idxs)
            for i, y in zip(idxs, ys):
                # results leave the executor as host values
                out[order[i].rid] = self._host(y) \
                    if isinstance(y, torch.Tensor) else y
        # evict verdicts of detached tasks (persistent executor: don't retain
        # dead head closures for the life of the server)
        self._head_mode = {t: v for t, v in self._head_mode.items()
                           if t in self.fm.heads}
        return out

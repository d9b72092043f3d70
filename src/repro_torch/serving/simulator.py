"""Discrete-event cluster simulator (the paper's testbed, virtualized).

Executes the REAL scheduler code (``repro_torch.core.bfq``) under virtual
time; only the accelerator is modeled, via per-backbone profiles (l(b)
curves calibrated on the real plane or taken from Table-3-style constants).

Deployment modes map to the paper's baselines through two knobs:
  * instance placement — shared backbone (FMplex/S-*) vs replica-per-task
    (ST/BE/SP);
  * GPU sharing discipline — "exclusive" (one instance), "ps" (best-effort
    processor sharing, i.e. CUDA time-slicing), "partition" (static spatial
    partition: each instance runs at a fixed fraction — the TPU analogue of
    TPC masking).

Supports mid-run speed changes (straggler injection) and GPU failure events
(fault-tolerance benches); the Controller reacts by rebinding vFM snapshots.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Optional

from repro_torch.core.bfq import SCHEDULERS
from repro_torch.core.profile import FMProfile
from repro_torch.core.request import Batch, Request
from repro_torch.core.vfm import VFM, TaskExtensions

_seq = itertools.count()


@dataclasses.dataclass
class Execution:
    batch: Batch
    remaining: float           # dedicated-GPU seconds of work left
    total: float


class SimInstance:
    """One deployed physical backbone on a GPU."""

    def __init__(self, fm_id: str, profile: FMProfile, scheduler: str = "bfq"):
        self.fm_id = fm_id
        self.profile = profile
        self.scheduler = SCHEDULERS[scheduler](profile)
        self.vfms: dict[str, VFM] = {}
        self.exec: Optional[Execution] = None
        self.loading_until: float = 0.0    # cold-load completion time

    def bind(self, task_id: str, *, weight=1.0, slo=None, adapter_id=None):
        v = VFM(task_id, weight=weight, slo=slo,
                extensions=TaskExtensions(adapter_id=adapter_id),
                backbone=self.fm_id)
        v.bound_fm = self.fm_id
        self.vfms[task_id] = v
        return v

    @property
    def busy(self) -> bool:
        return self.exec is not None

    def memory(self) -> int:
        return self.profile.memory_bytes + self.profile.instance_overhead_bytes \
            + len(self.vfms) * self.profile.task_memory_bytes


class SimGPU:
    def __init__(self, gpu_id: str, mem_bytes: float = 16e9,
                 sharing: str = "exclusive", speed: float = 1.0):
        self.gpu_id = gpu_id
        self.mem_bytes = mem_bytes
        self.sharing = sharing          # exclusive | ps | partition
        self.speed = speed
        self.alive = True
        self.instances: list[SimInstance] = []

    def rate_for(self, inst: SimInstance) -> float:
        if not self.alive:
            return 0.0
        if self.sharing == "partition":
            return self.speed / max(len(self.instances), 1)
        if self.sharing == "ps":
            busy = sum(1 for i in self.instances if i.busy)
            return self.speed / max(busy, 1)
        return self.speed

    def mem_used(self) -> float:
        return sum(i.memory() for i in self.instances)

    def fits(self, extra_bytes: float) -> bool:
        return self.mem_used() + extra_bytes <= self.mem_bytes


class Simulator:
    def __init__(self, gpus: list[SimGPU]):
        self.gpus = gpus
        self.routing: dict[str, tuple[SimGPU, SimInstance]] = {}
        self.now = 0.0
        self.finished: list[Request] = []
        self.timed_hooks: list[tuple[float, Callable]] = []  # (t, fn(sim))

    # ---- topology ----
    def route(self, task_id: str, gpu: SimGPU, inst: SimInstance,
              frac: float = 1.0):
        """Weighted routing: a task may be replicated across deployments."""
        self.routing.setdefault(task_id, []).append((gpu, inst, frac))

    def _pick_route(self, req: Request):
        routes = self.routing[req.task_id]
        if len(routes) == 1:
            return routes[0][:2]
        total = sum(f for _, _, f in routes)
        x = (req.rid * 2654435761 % 2 ** 20) / 2 ** 20 * total   # hash spread
        acc = 0.0
        for g, i, f in routes:
            acc += f
            if x <= acc:
                return g, i
        return routes[-1][:2]

    def instance_of(self, task_id: str) -> SimInstance:
        return self.routing[task_id][0][1]

    def add_hook(self, t: float, fn: Callable):
        self.timed_hooks.append((t, fn))
        self.timed_hooks.sort(key=lambda x: x[0])

    # ---- engine ----
    def _advance(self, dt: float):
        if dt <= 0:
            return
        for g in self.gpus:
            for inst in g.instances:
                if inst.busy:
                    inst.exec.remaining -= dt * g.rate_for(inst)
        self.now += dt

    def _next_completion(self) -> float:
        t = float("inf")
        for g in self.gpus:
            for inst in g.instances:
                if inst.busy:
                    r = g.rate_for(inst)
                    if r > 0:
                        t = min(t, self.now + inst.exec.remaining / r)
        return t

    def _try_dispatch(self, inst: SimInstance):
        if inst.busy or self.now < inst.loading_until:
            return
        batch = inst.scheduler.next_batch(inst.vfms, self.now)
        if batch is None:
            return
        work = inst.scheduler.exec_time(batch)
        inst.exec = Execution(batch, work, work)

    def run(self, arrivals: list[Request], horizon: float):
        heap = [(r.arrival, next(_seq), r) for r in arrivals]
        heapq.heapify(heap)
        hooks = list(self.timed_hooks)
        while True:
            t_arr = heap[0][0] if heap else float("inf")
            t_done = self._next_completion()
            t_hook = hooks[0][0] if hooks else float("inf")
            t_next = min(t_arr, t_done, t_hook, horizon)
            if t_next >= horizon and t_done == float("inf"):
                self._advance(horizon - self.now)
                break
            self._advance(t_next - self.now)

            if t_next == t_hook and hooks:
                _, fn = hooks.pop(0)
                fn(self)
                for g in self.gpus:
                    for inst in g.instances:
                        self._try_dispatch(inst)
                continue

            # completions first (free capacity before new work at same t)
            progressed = False
            for g in self.gpus:
                for inst in g.instances:
                    if inst.busy and inst.exec.remaining <= 1e-12:
                        batch = inst.exec.batch
                        inst.exec = None
                        for r in batch.requests:
                            r.finish_time = self.now
                            v = inst.vfms.get(r.task_id)
                            if v is not None:
                                v.acct.completed += 1
                                v.acct.service_time += \
                                    inst.profile.effective_per_request(batch.size)
                        inst.scheduler.on_complete(batch, inst.vfms, self.now)
                        self.finished.extend(batch.requests)
                        self._try_dispatch(inst)
                        progressed = True
            if progressed:
                continue

            if heap and heap[0][0] <= self.now + 1e-12:
                _, _, req = heapq.heappop(heap)
                gpu, inst = self._pick_route(req)
                vfm = inst.vfms[req.task_id]
                inst.scheduler.on_arrival(vfm, req, self.now)
                self._try_dispatch(inst)
                continue

            if self.now >= horizon:
                break
        return self.finished


# ---------------- cluster builders (deployment modes) ----------------

def build_single_gpu(mode: str, tasks: list[dict], profile: FMProfile,
                     mem_bytes: float = 16e9):
    """One GPU, one backbone family, N tasks. mode: fmplex | s-be | s-stfq |
    be | sp | st. Returns (sim, ok) — ok False if the deployment OOMs."""
    sched = {"fmplex": "bfq", "s-be": "s-be", "s-stfq": "stfq"}.get(mode)
    if sched is not None:  # shared backbone: ONE instance, many vFMs
        gpu = SimGPU("g0", mem_bytes, sharing="exclusive")
        inst = SimInstance(profile.name, profile, scheduler=sched)
        gpu.instances.append(inst)
        sim = Simulator([gpu])
        ok = gpu.fits(0)
        for t in tasks:
            inst.bind(t["task_id"], weight=t.get("weight", 1.0),
                      slo=t.get("slo"), adapter_id=t.get("adapter_id"))
            sim.route(t["task_id"], gpu, inst)
        ok = ok and gpu.mem_used() <= mem_bytes
        return sim, ok
    if mode in ("be", "sp"):  # replica per task on one GPU
        gpu = SimGPU("g0", mem_bytes,
                     sharing=("ps" if mode == "be" else "partition"))
        sim = Simulator([gpu])
        for t in tasks:
            inst = SimInstance(f"{profile.name}/{t['task_id']}", profile,
                               scheduler="s-be")
            gpu.instances.append(inst)
            inst.bind(t["task_id"], weight=t.get("weight", 1.0),
                      slo=t.get("slo"), adapter_id=t.get("adapter_id"))
            sim.route(t["task_id"], gpu, inst)
        return sim, gpu.mem_used() <= mem_bytes
    if mode == "st":          # dedicated GPU per task
        gpus, sim = [], None
        gpus = [SimGPU(f"g{i}", mem_bytes) for i in range(len(tasks))]
        sim = Simulator(gpus)
        for g, t in zip(gpus, tasks):
            inst = SimInstance(f"{profile.name}/{t['task_id']}", profile,
                               scheduler="s-be")
            g.instances.append(inst)
            inst.bind(t["task_id"], weight=t.get("weight", 1.0),
                      slo=t.get("slo"), adapter_id=t.get("adapter_id"))
            sim.route(t["task_id"], g, inst)
        return sim, True
    raise ValueError(mode)

"""Cluster deployment state maintained by FMplex-Controller (paper §5).

Backend-agnostic: the same state drives the discrete-event simulator and the
real in-process servers. Compute feasibility uses the backbone profile's
amortized throughput at the batching knee; memory feasibility uses backbone +
per-task extension residency.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

from repro_torch.core.profile import FMProfile

_dep_ids = itertools.count()

UTILIZATION_TARGET = 0.8     # keep headroom for bursts when admitting load


@dataclasses.dataclass
class TaskSpec:
    task_id: str
    backbone: str
    demand_rps: float = 1.0
    weight: float = 1.0
    slo_s: Optional[float] = None
    adapter_id: Optional[str] = None


@dataclasses.dataclass
class Deployment:
    """One physical FM instance on one server."""
    dep_id: str
    server_id: str
    backbone: str
    profile: FMProfile
    tasks: dict[str, float] = dataclasses.field(default_factory=dict)  # task->rps
    routing: dict[str, float] = dataclasses.field(default_factory=dict)  # task->frac
    partitions: int = 1   # FM instances sharing this accelerator (spatial split)

    def capacity_rps(self) -> float:
        """Sustainable request rate at the batching knee, scaled by the
        accelerator partition this instance owns (paper §6: co-located FM
        instances get disjoint TPC subsets)."""
        b = self.profile.b_max
        return b / self.profile.l(b) / max(self.partitions, 1)

    def load_rps(self) -> float:
        return sum(self.tasks.values())

    def spare_rps(self) -> float:
        return UTILIZATION_TARGET * self.capacity_rps() - self.load_rps()

    def memory(self) -> float:
        return self.profile.memory_bytes + self.profile.instance_overhead_bytes \
            + len(self.tasks) * self.profile.task_memory_bytes

    def meets_slo(self, slo_s: Optional[float]) -> bool:
        if slo_s is None:
            return True
        return self.profile.l(self.profile.b_max) <= slo_s


@dataclasses.dataclass
class Server:
    server_id: str
    mem_bytes: float = 16e9
    alive: bool = True
    deployments: list[Deployment] = dataclasses.field(default_factory=list)

    def mem_used(self) -> float:
        return sum(d.memory() for d in self.deployments)

    def mem_free(self) -> float:
        return self.mem_bytes - self.mem_used()


class ClusterState:
    def __init__(self, servers: list[Server],
                 profiles: dict[str, FMProfile]):
        self.servers = {s.server_id: s for s in servers}
        self.profiles = profiles                      # backbone -> profile
        self.deployments: dict[str, Deployment] = {}
        self.task_bindings: dict[str, list[str]] = {}  # task -> [dep_id]

    def active_deployments(self, backbone: str) -> list[Deployment]:
        return [d for d in self.deployments.values() if d.backbone == backbone]

    def new_deployment(self, server: Server, backbone: str) -> Deployment:
        dep = Deployment(f"dep{next(_dep_ids)}", server.server_id, backbone,
                         self.profiles[backbone])
        self.deployments[dep.dep_id] = dep
        server.deployments.append(dep)
        for d in server.deployments:          # spatial partition rebalance
            d.partitions = len(server.deployments)
        return dep

    def bind(self, task: TaskSpec, assignment: dict[str, float]):
        """assignment: dep_id -> fraction of the task's demand routed there."""
        self.task_bindings[task.task_id] = list(assignment)
        for dep_id, frac in assignment.items():
            dep = self.deployments[dep_id]
            dep.tasks[task.task_id] = task.demand_rps * frac
            dep.routing[task.task_id] = frac

    def unbind(self, task_id: str):
        for dep_id in self.task_bindings.pop(task_id, []):
            dep = self.deployments.get(dep_id)
            if dep:
                dep.tasks.pop(task_id, None)
                dep.routing.pop(task_id, None)

    def total_tasks(self) -> int:
        return len(self.task_bindings)

"""Elastic adaptation (paper §5.3, Fig. 16) + fault/straggler response.

When demand surges or a server degrades, the Controller first tries the CHEAP
path enabled by vFM decoupling: update the affected task's binding/routing to
a compatible backbone that is already resident (move only task-local state —
queue metadata, decoder/adapter refs, scheduler weights; ~task-load
timescale). Only if no compatible backbone has spare capacity does it fall
back to provisioning a new backbone (backbone-load timescale).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.controller.maxshare import MaxShare
from repro_torch.controller.state import ClusterState, TaskSpec


@dataclasses.dataclass
class AdaptResult:
    path: str                 # "rebind" | "provision" | "infeasible"
    ready_s: float            # time until the new capacity serves traffic
    assignment: dict


class ElasticAdapter:
    def __init__(self, cluster: ClusterState):
        self.cluster = cluster
        self.placer = MaxShare(cluster)

    def on_surge(self, task: TaskSpec, new_demand_rps: float) -> AdaptResult:
        """Demand change for an existing task: rebind vs provision."""
        task = dataclasses.replace(task, demand_rps=new_demand_rps)
        self.cluster.unbind(task.task_id)
        before = set(self.cluster.deployments)
        plan = self.placer.place(task)
        if plan is None:
            return AdaptResult("infeasible", float("inf"), {})
        if set(self.cluster.deployments) == before:
            # only task-local state moved: queue metadata + extensions
            prof = self.cluster.profiles[task.backbone]
            return AdaptResult("rebind", prof.task_load_s, plan.assignment)
        prof = self.cluster.profiles[task.backbone]
        return AdaptResult("provision", prof.load_time_s + prof.task_load_s,
                           plan.assignment)

    def on_server_failure(self, server_id: str) -> list[AdaptResult]:
        """Rebind every task of a dead/straggling server elsewhere."""
        server = self.cluster.servers[server_id]
        server.alive = False
        moved = []
        dead = list(server.deployments)
        server.deployments.clear()
        agg: dict[str, TaskSpec] = {}
        for dep in dead:
            self.cluster.deployments.pop(dep.dep_id, None)
            for tid, rps in dep.tasks.items():
                if tid in agg:
                    agg[tid].demand_rps += rps
                else:
                    agg[tid] = TaskSpec(tid, dep.backbone, demand_rps=rps)
        victims = list(agg.values())
        # also clear stale bindings before replacement
        for t in victims:
            self.cluster.task_bindings.pop(t.task_id, None)
        for t in victims:
            moved.append(self.on_surge(t, t.demand_rps))
        return moved

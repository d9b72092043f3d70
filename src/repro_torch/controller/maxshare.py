"""Max-Share heuristic — paper Algorithm 1.

Prefer binding a task onto ACTIVE deployments of its backbone (best-fit order:
smallest spare capacity that still absorbs the task — leaves minimal unused
capacity); only when no feasible plan exists over live backbones, provision a
new backbone on a best-fit server. Supports replication: if one deployment
cannot absorb the demand, the plan spreads it across several (routing
fractions), matching the paper's "task replication across servers".
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.controller.state import (ClusterState, Deployment, Server,
                                          TaskSpec)


@dataclasses.dataclass
class Plan:
    task: TaskSpec
    assignment: dict[str, float]              # dep_id -> demand fraction
    new_deployments: list[tuple[str, str]]    # (server_id, backbone) provisioned


def _feasible_assignment(task: TaskSpec, candidates: list[Deployment]
                         ) -> Optional[dict[str, float]]:
    """Greedy fill over the candidate set (paper's plan())."""
    remaining = task.demand_rps
    assignment: dict[str, float] = {}
    for dep in candidates:
        if not dep.meets_slo(task.slo_s):
            continue
        absorb = min(max(dep.spare_rps(), 0.0), remaining)
        if absorb <= 0:
            continue
        assignment[dep.dep_id] = absorb / task.demand_rps if task.demand_rps else 1.0
        remaining -= absorb
        if remaining <= 1e-9:
            return assignment
    return None


class MaxShare:
    def __init__(self, cluster: ClusterState):
        self.cluster = cluster

    def best_fit_order(self, deps: list[Deployment], task: TaskSpec
                       ) -> list[Deployment]:
        """Rank by how snugly they absorb the task (minimal leftover spare)."""
        def key(d):
            spare_after = d.spare_rps() - task.demand_rps
            return (0 if spare_after >= 0 else 1,
                    spare_after if spare_after >= 0 else -spare_after)
        return sorted(deps, key=key)

    def best_fit_servers(self, task: TaskSpec) -> list[Server]:
        prof = self.cluster.profiles[task.backbone]
        need = prof.memory_bytes + prof.task_memory_bytes
        fits = [s for s in self.cluster.servers.values()
                if s.alive and s.mem_free() >= need]
        # fewest co-resident deployments first (a new instance halves the
        # partition of everything already on the server), then snuggest memory
        return sorted(fits, key=lambda s: (len(s.deployments),
                                           s.mem_free() - need))

    def place(self, task: TaskSpec) -> Optional[Plan]:
        """Algorithm 1. Returns a committed Plan or None (⊥)."""
        cand: list[Deployment] = []
        # phase 1: prefer existing backbones
        active = self.cluster.active_deployments(task.backbone)
        for dep in self.best_fit_order(active, task):
            cand.append(dep)
            assignment = _feasible_assignment(task, cand)
            if assignment is not None:
                self.cluster.bind(task, assignment)
                return Plan(task, assignment, [])
        # phase 2: provision only as needed
        new_deps: list[tuple[str, str]] = []
        for server in self.best_fit_servers(task):
            # Algorithm 1 feasible(): a new instance shrinks the spatial
            # partition of co-resident deployments — reject the server if that
            # would push any EXISTING deployment over its admitted load.
            n_after = len(server.deployments) + 1
            if any(d.load_rps() > 0.8 * (d.profile.b_max /
                                         d.profile.l(d.profile.b_max)) / n_after
                   for d in server.deployments):
                continue
            dep = self.cluster.new_deployment(server, task.backbone)
            new_deps.append((server.server_id, task.backbone))
            cand.append(dep)
            assignment = _feasible_assignment(task, cand)
            if assignment is not None:
                self.cluster.bind(task, assignment)
                return Plan(task, assignment, new_deps)
        # infeasible: roll back provisioned deployments
        for server_id, _ in new_deps:
            server = self.cluster.servers[server_id]
            dep = server.deployments.pop()
            self.cluster.deployments.pop(dep.dep_id, None)
        return None

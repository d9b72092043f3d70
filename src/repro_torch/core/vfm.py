"""The virtual foundation model (vFM) — FMplex's core abstraction (§4.1).

A vFM gives each task the illusion of a private FM. Three facets:
  * virtual queue — invocations are intercepted and queued per task;
  * task extensions — encoder / decoder head / PEFT adapter references that
    customize the shared backbone for this task only;
  * state & accounting — SLO, fair-share weight, and a named accounting
    identity tracking usage (drives admission, fair sharing, SLO enforcement).

vFMs are bound to a physical FM at deployment time and can be rebound at
runtime (Controller elastic adaptation) by moving only this object's state.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Optional

from repro_torch.core.request import SLO, Request


@dataclasses.dataclass
class TaskExtensions:
    encoder: Any = None          # input-side adaptation module (or None)
    decoder: Any = None          # task head module (or None)
    adapter_id: Optional[str] = None   # PEFT adapter identity (batching key)
    adapter_weights: Any = None


@dataclasses.dataclass
class Accounting:
    """Named per-vFM accounting identity."""
    admitted: int = 0
    completed: int = 0
    dropped: int = 0
    service_time: float = 0.0    # backbone seconds consumed (amortized)
    last_finish_tag: float = 0.0


class VFM:
    """A logically-private FM instance backed by a shared physical FM."""

    def __init__(self, task_id: str, *, weight: float = 1.0,
                 slo: Optional[SLO] = None,
                 extensions: Optional[TaskExtensions] = None,
                 backbone: str = ""):
        self.task_id = task_id
        self.weight = float(weight)
        self.slo = slo or SLO()
        self.extensions = extensions or TaskExtensions()
        self.backbone = backbone
        self.queue: collections.deque[Request] = collections.deque()
        self.acct = Accounting()
        self.bound_fm: Optional[str] = None    # physical FM instance id

    # ---- virtual queue ----
    def enqueue(self, req: Request):
        req.slo = req.slo if req.slo.deadline_s is not None else self.slo
        self.queue.append(req)
        self.acct.admitted += 1

    def __len__(self):
        return len(self.queue)

    # ---- lifecycle (elastic adaptation moves exactly this state) ----
    def snapshot(self) -> dict:
        """Task-local state moved on rebinding (queue metadata, extensions,
        scheduler state) — NOT the backbone."""
        return {
            "task_id": self.task_id,
            "weight": self.weight,
            "slo": self.slo,
            "extensions": self.extensions,
            "queue": list(self.queue),
            "acct": self.acct,
        }

    @classmethod
    def restore(cls, snap: dict, backbone: str = "") -> "VFM":
        v = cls(snap["task_id"], weight=snap["weight"], slo=snap["slo"],
                extensions=snap["extensions"], backbone=backbone)
        v.queue.extend(snap["queue"])
        v.acct = snap["acct"]
        return v

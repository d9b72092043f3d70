"""Elastic scaling for training: rebuild the mesh at a different size and
reshard state from the last checkpoint (the train-side analogue of the
Controller's serving-side elasticity).

Workflow on node loss / cluster resize:
  1. coordinator detects the new healthy device set and restarts the
     process group at its size;
  2. ``shrink_plan`` picks the largest usable mesh (data dimension shrinks
     first: model-parallel groups must stay intact);
  3. restore the last checkpoint with the new mesh's shardings
     (``repro_torch.checkpoint.ckpt.restore`` reshards on load);
  4. training resumes; global batch is preserved by raising grad-accumulation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class MeshPlan:
    pods: int
    data: int
    model: int
    grad_accum: int          # multiplier to preserve the global batch

    @property
    def devices(self) -> int:
        return self.pods * self.data * self.model


def shrink_plan(healthy_devices: int, *, model_parallel: int,
                old_data: int, old_pods: int = 1) -> Optional[MeshPlan]:
    """Largest mesh with the same model axis that fits the healthy devices."""
    if healthy_devices < model_parallel:
        return None
    pods = old_pods
    while pods >= 1:
        avail = healthy_devices // (pods * model_parallel)
        data = 1
        while data * 2 <= min(avail, old_data):
            data *= 2
        if avail >= 1:
            accum = max(1, (old_data * old_pods) // (data * pods))
            return MeshPlan(pods, data, model_parallel, accum)
        pods -= 1
    return None


def rebuild_mesh(plan: MeshPlan, device_type: str = "cuda"):
    """The plan's mesh on the running process group (of ``plan.devices``
    ranks)."""
    from repro_torch.launch.mesh import make_mesh_for
    return make_mesh_for(plan.devices, model_parallel=plan.model,
                         pods=plan.pods, device_type=device_type)


def reshard_state(ckpt_dir, state_like, mesh, shardings, step=None):
    """Restore the latest checkpoint resharded onto ``mesh`` (``shardings``
    a tree of ``(mesh, placements)`` on it)."""
    from repro_torch.checkpoint import ckpt
    return ckpt.restore(ckpt_dir, state_like, step=step, shardings=shardings)

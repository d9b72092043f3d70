"""AdamW + global-norm clipping + cosine schedule, step for step as the JAX
package's ``optim/adamw.py``: functions over trees (nested dicts and lists)
of f32 tensors. ``torch.optim.AdamW`` is not it: it has no global-norm clip
and other defaults, and rounds its step in another order."""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor           # () int32, on the parameters' device
    m: object
    v: object


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else None

        def z(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return AdamWState(torch.zeros((), dtype=torch.int32, device=dev),
                          tree_map(z, params), tree_map(z, params))

    def update(self, grads, state: AdamWState, params):
        """(new params, new state, {"grad_norm", "lr"}): the gradients
        clipped to a global norm of ``clip_norm``, f32 moments, bias
        correction, and the decay ``weight_decay * p`` added to the update
        inside the learning-rate product. Leaves keep their dtype."""
        step = state.step + 1
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        grads = tree_map(lambda g: g.float() * scale, grads)
        m = tree_map(lambda mm, g: self.b1 * mm + (1 - self.b1) * g,
                     state.m, grads)
        v = tree_map(lambda vv, g: self.b2 * vv + (1 - self.b2) * g * g,
                     state.v, grads)
        t = step.float()
        bc1 = 1 - self.b1 ** t
        bc2 = 1 - self.b2 ** t
        lr = self.lr(step) if callable(self.lr) else self.lr

        def upd(p, mm, vv):
            u = (mm / bc1) / (torch.sqrt(vv / bc2) + self.eps)
            u = u + self.weight_decay * p.float()
            return (p.float() - lr * u).to(p.dtype)

        new_params = tree_map(upd, params, m, v)
        return new_params, AdamWState(step, m, v), {"grad_norm": gnorm,
                                                    "lr": lr}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if not leaves:
        return torch.zeros(())
    return torch.sqrt(sum(leaves[1:], leaves[0]))


def cosine_schedule(peak: float, warmup: int, total: int, floor: float = 0.1):
    """lr(step): linear warm-up to ``peak`` over ``warmup`` steps, then a
    cosine decay to ``floor * peak`` at ``total``; f32 tensors."""
    def lr(step):
        step = step.float()
        warm = peak * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)
    return lr

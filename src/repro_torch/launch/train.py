"""Fault-tolerant LM training on one device (the JAX package's
``launch/train.py``).

Trains every leaf of the LM (``lm.loss_fn``: next-token cross-entropy,
labels, or a representation config's reconstruction, plus the MoE aux
loss) from f32 master weights with AdamW, eagerly, on the card unless
asked for the CPU. Exercised by tests and examples: checkpoint/restart
(saves on a thread, atomic publish, a checkpoint of either package
restores in the other), failure injection with automatic resume, and
straggler detection. One device only: the JAX package's mesh (FSDP
shardings, activation rules) waits for the port of ``sharding/*`` and
``launch/mesh.py``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
      --steps 40 --batch 8 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, reduced
from repro_torch.data.tokens import TokenPipeline
from repro_torch.distributed.fault import (FailureInjector, InjectedFailure,
                                           StepTimer, StragglerDetector)
from repro_torch.models import lm
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim.adamw import AdamW, cosine_schedule


def make_train_step(cfg, opt: AdamW):
    """step(state, batch) -> (state, metrics): the loss and every leaf's
    gradient by autograd (``lm.loss_fn``; zeros for a leaf the loss does
    not reach, as ``jax.grad`` gives), then ``opt.update``; the new params
    are leaves that require grad, the metrics detached."""
    def train_step(state, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        loss, metrics = lm.loss_fn(params, cfg, batch)
        grads = iter([torch.zeros_like(p) if g is None else g
                      for p, g in zip(leaves, torch.autograd.grad(
                          loss, leaves, allow_unused=True))])
        grads = tree_map(lambda _: next(grads), params)
        with torch.no_grad():
            new_p, new_opt, om = opt.update(grads, state["opt"], params)
        new_p = tree_map(lambda t: t.requires_grad_(True), new_p)
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in {**metrics, **om}.items()}
        return {"params": new_p, "opt": new_opt}, metrics
    return train_step


def _batch(host: dict, device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in host.items()}


class Trainer:
    """The JAX package's ``Trainer`` on one device: ``TokenPipeline``
    batches, AdamW under ``cosine_schedule(lr, 20, total_steps)``,
    checkpoints every ``ckpt_every`` steps and at the last, restart from the
    latest one on an injected failure. ``params`` (a tree of f32 tensors
    on ``device``, e.g. ``weights.model_params(jax_tree, masters=True)``)
    replaces the random init, which draws f32 masters from a generator
    seeded 0 (as the JAX trainer's ``PRNGKey(0)``). A ``mesh`` raises
    ``NotImplementedError``: the mesh code is not ported."""

    def __init__(self, cfg, *, batch: int, seq: int, ckpt_dir: str,
                 mesh=None, ckpt_every: int = 20, lr: float = 3e-4,
                 total_steps: int = 1000, async_ckpt: bool = True,
                 seed: int = 0, device="cuda", params=None):
        if mesh is not None:
            raise NotImplementedError(
                "the port trains on one device: a mesh waits for the port "
                "of sharding/* and launch/mesh.py")
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.ckpt_dir = Path(ckpt_dir)
        self.ckpt_every = ckpt_every
        self.async_ckpt = async_ckpt
        self.device = torch.device(device)
        self.opt = AdamW(lr=cosine_schedule(lr, 20, total_steps))
        self.data = TokenPipeline(cfg, batch, seq, seed=seed)
        self.straggler = StragglerDetector()
        self._step_fn = make_train_step(cfg, self.opt)
        self._pending_save = None
        self._params = params

    def init_state(self):
        if self._params is not None:
            params = tree_map(lambda t: t.detach().clone(), self._params)
        else:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = lm.init_model(gen, self.cfg, device=self.device,
                                   masters=True)
        params = tree_map(lambda t: t.requires_grad_(True), params)
        return {"params": params, "opt": self.opt.init(params)}

    def restore_or_init(self):
        state = self.init_state()
        step = ckpt.latest_step(self.ckpt_dir)
        if step is not None:
            state, step = ckpt.restore(self.ckpt_dir, state)
            state["params"] = tree_map(lambda t: t.requires_grad_(True),
                                       state["params"])
            print(f"[trainer] restored step {step} from {self.ckpt_dir}")
            return state, step + 1
        return state, 0

    def run(self, steps: int, *, injector: FailureInjector | None = None,
            max_restarts: int = 2) -> list[float]:
        losses, restarts = [], 0
        while True:
            try:
                state, start = self.restore_or_init()
                for step in range(start, steps):
                    if injector:
                        injector.check(step)
                    batch = _batch(next(self.data), self.device)
                    with StepTimer() as t:
                        state, metrics = self._step_fn(state, batch)
                        loss = float(metrics["loss"])
                    self.straggler.record(step, t.duration)
                    losses.append(loss)
                    if step % self.ckpt_every == 0 or step == steps - 1:
                        if self._pending_save is not None:
                            self._pending_save.join()
                        self._pending_save = ckpt.save(
                            self.ckpt_dir, step, state,
                            blocking=not self.async_ckpt)
                if self._pending_save is not None:
                    self._pending_save.join()
                return losses
            except InjectedFailure as e:
                restarts += 1
                print(f"[trainer] {e}; restart {restarts}")
                if restarts > max_restarts:
                    raise


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    tr = Trainer(cfg, batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt,
                 lr=args.lr, total_steps=args.steps, device=args.device)
    t0 = time.time()
    losses = tr.run(args.steps)
    print(f"arch={cfg.name} steps={len(losses)} "
          f"loss {losses[0]:.3f} -> {np.mean(losses[-5:]):.3f} "
          f"({time.time()-t0:.1f}s, stragglers={len(tr.straggler.events)})")
    return losses


if __name__ == "__main__":
    main()

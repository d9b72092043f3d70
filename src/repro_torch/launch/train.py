"""Fault-tolerant LM training (the JAX package's ``launch/train.py``).

Trains every leaf of the LM (``lm.loss_fn``: next-token cross-entropy,
labels, or a representation config's reconstruction, plus the MoE aux
loss) from f32 master weights with AdamW, eagerly, on the card unless
asked for the CPU. Exercised by tests and examples: checkpoint/restart
(saves on a thread, atomic publish, a checkpoint of either package
restores in the other), failure injection with automatic resume, and
straggler detection. On a mesh (``Trainer(mesh=...)``, a ``DeviceMesh``
over ("data", "model")) the masters and both AdamW moments are DTensors
under ``FSDP_RULES``, the batch is split over the batch dimensions and the
activations follow ``ACT_RULES``; the kernels run on each rank's local
shards (``kernels.ops``).

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
from repro_torch.models.common import (NO_SHARD, ShardCtx, logical_axes,
                                       tree_leaves, tree_map)
from repro_torch.optim.adamw import AdamW, AdamWState, cosine_schedule
from repro_torch.sharding import rules as R


def _like(g, p):
    """A gradient in its parameter's placements (a DTensor parameter's
    gradient may come back ``Partial`` or otherwise placed)."""
    if g is None:
        return torch.zeros_like(p)
    if hasattr(p, "placements") and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg, opt: AdamW, shard=NO_SHARD):
    """step(state, batch) -> (state, metrics): the loss and every leaf's
    gradient by autograd (``lm.loss_fn`` under ``shard``; zeros for a leaf
    the loss does not reach, as ``jax.grad`` gives), then ``opt.update``;
    the new params are leaves that require grad, the metrics detached. On
    a mesh (DTensor params) the step runs under ``implicit_replication``,
    so the plain tensors the model makes (positions, masks, the step
    counter) act as replicated; the metrics come back whole, as plain
    tensors."""
    def train_step(state, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        loss, metrics = lm.loss_fn(params, cfg, batch, shard)
        grads = iter([_like(g, p) for p, g in zip(leaves, torch.autograd.grad(
            loss, leaves, allow_unused=True))])
        grads = tree_map(lambda _: next(grads), params)
        with torch.no_grad():
            new_p, new_opt, om = opt.update(grads, state["opt"], params)
        new_p = tree_map(lambda t: t.requires_grad_(True), new_p)
        metrics = {k: _whole(v.detach()) if isinstance(v, torch.Tensor)
                   else v for k, v in {**metrics, **om}.items()}
        return {"params": new_p, "opt": new_opt}, metrics
    if shard.mesh is None:
        return train_step

    def mesh_step(state, batch):
        from torch.distributed.tensor.experimental import implicit_replication
        with implicit_replication():
            return train_step(state, batch)
    return mesh_step


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _batch(host: dict, device, mesh=None) -> dict:
    """The host batch on ``device``; on a mesh each tensor a DTensor split
    over the batch dimensions (every rank draws the same global batch and
    keeps its rows: no communication)."""
    out = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
    if mesh is None:
        return out
    from torch.distributed.tensor import DTensor, Replicate
    rep = [Replicate()] * mesh.ndim
    return {k: DTensor.from_local(v, mesh, rep, run_check=False).redistribute(
        mesh, R.placements_for(R.spec_for(
            R.ACT_RULES, ("batch",) + (None,) * (v.ndim - 1), mesh,
            tuple(v.shape)), mesh)) for k, v in out.items()}


def distribute(tree, shardings):
    """Each tensor of ``tree`` (the same on every rank) as a DTensor with
    the ``(mesh, placements)`` of ``shardings`` at its place (None keeps a
    leaf plain): each rank keeps its slice, no communication."""
    def one(t, sh):
        if sh is None:
            return t
        mesh, pl = sh
        local = t.detach()[R.local_slices(t.shape, mesh, pl)].contiguous()
        return R.from_local(local, mesh, pl, t.shape)
    return tree_map(one, tree, shardings)


class Trainer:
    """The JAX package's ``Trainer``: ``TokenPipeline`` batches, AdamW
    under ``cosine_schedule(lr, 20, total_steps)``, checkpoints every
    ``ckpt_every`` steps and at the last, restart from the latest one on an
    injected failure. ``params`` (a tree of f32 tensors on ``device``, e.g.
    ``weights.model_params(jax_tree, masters=True)``) replaces the random
    init, which draws f32 masters from a generator seeded 0 (as the JAX
    trainer's ``PRNGKey(0)``). ``mesh`` (a ``DeviceMesh`` over ("data",
    "model"), every rank of its group running the same ``Trainer``): the
    state is placed by ``state_shardings`` and the activations follow
    ``ACT_RULES`` (``self.shard``); the checkpoints keep the one-device
    format, so a mesh-trained checkpoint restores without a mesh and the
    other way round."""

    def __init__(self, cfg, *, batch: int, seq: int, ckpt_dir: str,
                 mesh=None, ckpt_every: int = 20, lr: float = 3e-4,
                 total_steps: int = 1000, async_ckpt: bool = True,
                 seed: int = 0, device="cuda", params=None):
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh
            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"a mesh is a torch.distributed DeviceMesh "
                                f"(launch.mesh), not {type(mesh).__name__}")
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.ckpt_dir = Path(ckpt_dir)
        self.ckpt_every = ckpt_every
        self.async_ckpt = async_ckpt
        self.device = torch.device(device)
        self.mesh = mesh
        self.shard = ShardCtx(R.ACT_RULES, mesh) if mesh is not None \
            else ShardCtx()
        self.opt = AdamW(lr=cosine_schedule(lr, 20, total_steps))
        self.data = TokenPipeline(cfg, batch, seq, seed=seed)
        self.straggler = StragglerDetector()
        self._step_fn = make_train_step(cfg, self.opt, self.shard)
        self._pending_save = None
        self._params = params

    def init_state(self):
        if self._params is not None:
            params = tree_map(lambda t: t.detach().clone(), self._params)
        else:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = lm.init_model(gen, self.cfg, device=self.device,
                                   masters=True)
        if self.mesh is not None:
            params = distribute(params, self.state_shardings(
                {"params": params, "opt": None})["params"])
        params = tree_map(lambda t: t.requires_grad_(True), params)
        return {"params": params, "opt": self.opt.init(params)}

    def state_shardings(self, state):
        """``(mesh, placements)`` of each leaf of ``state``: the masters
        and both AdamW moments under ``FSDP_RULES`` over the model's
        logical axes, the step counter plain (None); None without a
        mesh."""
        if self.mesh is None:
            return None
        p_sh = R.tree_shardings(R.FSDP_RULES,
                                logical_axes(lm.model_spec(self.cfg)),
                                self.mesh, state["params"])
        return {"params": p_sh, "opt": AdamWState(None, p_sh, p_sh)}

    def restore_or_init(self):
        state = self.init_state()
        if self.mesh is not None:
            # every rank reads the step rank 0 last published
            if self._pending_save is not None:
                self._pending_save.join()
            torch.distributed.barrier()
        step = ckpt.latest_step(self.ckpt_dir)
        if step is not None:
            state, step = ckpt.restore(self.ckpt_dir, state,
                                       shardings=self.state_shardings(state))
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
                    batch = _batch(next(self.data), self.device, self.mesh)
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

"""Task pipeline (paper §4.3, Listings 1–2): compose encoder + vFM(+adapter)
+ decoder; fine-tune extensions with the backbone frozen; package artifacts.

The JAX package takes ``jax.value_and_grad`` of the composed forward and
jits the step. Here the step runs eagerly: autograd through the backbone
reaches the attention kernel (K2) and the norm kernel on the card, each
with a hand-written backward (``kernels.ops``); the backbone's leaves never
require grad and stay bit-identical.
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim.adamw import AdamW
from repro_torch.taskapi.interfaces import Adapter, Decoder, Encoder, vFM


class Pipeline:
    def __init__(self, vfm: vFM, task_id: str = "task0", seed: int = 0):
        self.vfm = vfm
        self.task_id = task_id
        self.encoder: Optional[Encoder] = None
        self.decoder: Optional[Decoder] = None
        self.adapter: Optional[Adapter] = None
        self._gen = torch.Generator(device=vfm.device).manual_seed(seed)
        self.state: dict = {"encoder": {}, "decoder": {}, "adapter": None}

    # ---- composition (Table 1) ----
    def add_encoder(self, enc: Encoder):
        self.encoder = enc
        self.state["encoder"] = enc.init(self._gen)
        return self

    def add_decoder(self, dec: Decoder):
        self.decoder = dec
        self.state["decoder"] = dec.init(self._gen)
        return self

    def attach_adapter(self, adapter: Adapter):
        self.adapter = adapter
        self.state["adapter"] = adapter.init(self._gen, self.vfm.cfg)
        return self

    def remove_adapter(self, adapter_id: str | None = None):
        self.adapter = None
        self.state["adapter"] = None
        return self

    # ---- inference ----
    def _forward(self, ext_params, x):
        e = self.encoder.apply(ext_params["encoder"], x) if self.encoder else x
        e = e.float()
        feats = self.vfm.run(e, lora_tree=ext_params.get("adapter"))
        y = self.decoder.apply(ext_params["decoder"], feats.float()) \
            if self.decoder else feats
        return y

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x), device=self.vfm.device)

    def run(self, x):
        """The task's output for a batch ``x`` (numpy or tensor)."""
        with torch.no_grad():
            return self._forward(self.state, self._tensor(x).float())

    # ---- fine-tuning (backbone frozen) ----
    def loss_and_grad(self, parts: dict, x, y, loss: str = "mse"):
        """(loss, grads) of one step: the loss of the pipeline with its
        state's ``parts`` (a dict of extension trees, e.g. {"encoder": ...,
        "adapter": ...}) replaced by the given ones on the batch (x, y), and
        its gradient with respect to each leaf of ``parts``, in their
        structure: what ``jax.value_and_grad`` of the JAX package's loss
        gives. ``loss`` "mse", or anything else for cross-entropy over the
        last axis with integer targets ``y``."""
        frozen = {k: v for k, v in self.state.items() if k not in parts}
        params = tree_map(lambda t: t.detach().requires_grad_(True), parts)
        x = self._tensor(x).float()
        y = self._tensor(y)
        with torch.enable_grad():
            pred = self._forward({**frozen, **params}, x)
            if loss == "mse":
                value = torch.mean((pred - y.float()) ** 2)
            else:
                logp = F.log_softmax(pred, dim=-1)
                value = -torch.mean(logp.gather(-1, y.long()[:, None]))
        leaves = tree_leaves(params)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
        # a leaf the loss does not reach gets zeros, as in JAX
        grads = iter([torch.zeros_like(t) if g is None else g
                      for t, g in zip(leaves, grads)])
        return value.detach(), tree_map(lambda _: next(grads), params)

    def train(self, data: Iterable, *, steps: int = 50, lr: float = 1e-3,
              parts_to_train=("encoder", "decoder", "adapter"),
              loss: str = "mse", verbose: bool = False) -> list[float]:
        """AdamW (no decay) on ``parts_to_train`` over ``steps`` batches
        (x, y) of ``data`` (restarted when it runs out); the losses."""
        train_parts = {k: v for k, v in self.state.items()
                       if k in parts_to_train and v is not None}
        opt = AdamW(lr=lr, weight_decay=0.0)
        opt_state = opt.init(train_parts)
        losses = []
        it = iter(data)
        for step in range(steps):
            try:
                x, y = next(it)
            except StopIteration:
                it = iter(data)
                x, y = next(it)
            value, g = self.loss_and_grad(train_parts, x, y, loss=loss)
            train_parts, opt_state, _ = opt.update(g, opt_state, train_parts)
            losses.append(float(value))
            if verbose and step % 10 == 0:
                print(f"step {step}: loss {value:.4f}")
        self.state.update(train_parts)
        return losses

    # ---- deployment artifact ----
    def package(self, *, weight: float = 1.0, slo_s: float | None = None,
                demand_rps: float = 1.0) -> dict:
        from repro_torch.taskapi.artifacts import package_pipeline
        return package_pipeline(self, weight=weight, slo_s=slo_s,
                                demand_rps=demand_rps)

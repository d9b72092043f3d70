"""Task-API interfaces (paper Table 1): Encoder / Decoder / Adapter / vFM.

As in the JAX package, a module instance holds hyperparameters and its
parameters are an explicit tree of tensors (``init`` draws them from a
``torch.Generator``, ``apply`` consumes them), so a pipeline can freeze the
backbone and train only the extensions.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


class Module:
    """Base for task extensions."""

    def init(self, gen: torch.Generator) -> dict:
        return {}

    def apply(self, params, x):
        raise NotImplementedError

    def run(self, params, x):      # paper naming
        return self.apply(params, x)


class Encoder(Module):
    """Input-side adaptation: raw request -> backbone embeddings (B, S, d)."""


class Decoder(Module):
    """Task head: backbone features -> task output."""


class Adapter:
    """PEFT adapter attached to the vFM backbone (LoRA on q/v projections)."""

    def __init__(self, rank: int = 16, adapter_id: str = "adapter0"):
        self.rank = rank
        self.adapter_id = adapter_id

    def init(self, gen: torch.Generator, cfg: ModelConfig):
        """One adapter (an NA = 1 stack), f32 leaves on ``gen``'s device;
        the B leaves start at zero."""
        from repro_torch.models import lora
        return lora.init_single_adapter(gen, cfg, self.rank,
                                        device=gen.device)


class vFM:
    """Task-side handle to a (virtual) foundation model.

    Locally backed by a real backbone copy for fine-tuning; at deployment the
    artifact binds to a *shared* physical FM — the task keeps the same logical
    view (paper §4.1). The backbone is drawn from ``seed`` on ``device``
    (the card unless the caller passes ``"cpu"``), its leaves cast to their
    use-site dtypes; none of them requires grad.
    """

    def __init__(self, backbone: str | ModelConfig, *, seed: int = 0,
                 params=None, device=None):
        self.cfg = backbone if isinstance(backbone, ModelConfig) \
            else get_config(backbone)
        self.device = torch.device("cuda" if device is None else device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = lm.init_model(gen, self.cfg, device=self.device)
        self.params = params

    def run(self, embeds, lora_tree=None):
        """Backbone features for a batch of embeddings (B, S, d) -> (B, S,
        d), on the gather LoRA path with every row on adapter 0."""
        aidx = None
        if lora_tree is not None:
            aidx = torch.zeros((embeds.shape[0],), dtype=torch.int32,
                               device=embeds.device)
        feats, _ = lm.forward(self.params, self.cfg, embeds=embeds,
                              lora=lora_tree, adapter_idx=aidx)
        return feats

"""Bring the JAX package's parameter trees into the port.

torch cannot reproduce ``jax.random``, so parity tests build the reference
weights with the JAX package, convert every leaf to numpy
(``jax.tree.map(np.asarray, tree)``) and load them here. Both packages use the
same tree structure (dicts, lists over the period's sublayers, a leading
``num_periods`` axis on every stacked leaf), so the conversion is leaf by
leaf. This module imports numpy and torch only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.common import tree_map
from repro_torch.models.lm import cast_params


def to_torch(tree, device="cuda"):
    """numpy leaves -> torch tensors (copied) on ``device``, same structure
    and dtypes (lists stay lists; tuples become lists)."""
    def conv(x):
        return torch.tensor(np.array(x), device=device)
    out = tree_map(conv, tree)
    return list(out) if isinstance(out, tuple) else out


def model_params(tree, device="cuda", masters: bool = False) -> dict:
    """A JAX ``lm.init_model`` tree (numpy leaves) as the port's serving
    params: f32 leaves, then each cast to its use-site dtype
    (``lm.use_dtype``: the matrices bf16; the norms, the head, the MoE
    router and the recurrences' gate and decay leaves f32). With
    ``masters`` the f32 leaves as they are: the trainer's master weights
    (``launch.train``), which the forward casts at each use site."""
    out = to_torch(tree, device=device)
    return out if masters else cast_params(out)


def adapter_tree(tree, device="cuda") -> list:
    """A JAX LoRA adapter tree (``lora.init_single_adapter`` layout, or a
    stack) as the port's: a list over sublayers, f32 leaves."""
    return to_torch(tree, device=device)


def extension_state(state, device="cuda") -> dict:
    """A JAX task pipeline's ``state`` (numpy leaves: ``encoder`` and
    ``decoder`` dicts, ``adapter`` a LoRA tree or None) as the port's
    ``taskapi.Pipeline.state``: f32 leaves on ``device``, the adapter a list
    over sublayers as ``adapter_tree`` gives it."""
    out = {k: to_torch(state.get(k) or {}, device=device)
           for k in ("encoder", "decoder")}
    ada = state.get("adapter")
    out["adapter"] = None if ada is None else adapter_tree(ada, device=device)
    return out

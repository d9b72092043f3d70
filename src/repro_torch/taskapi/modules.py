"""Reference Task-API extensions (paper Listing 1/2)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.taskapi.interfaces import Decoder, Encoder


def _normal(gen, shape, fan_in):
    return torch.randn(shape, generator=gen, device=gen.device) / fan_in ** 0.5


class LinearChannelCombiner(Encoder):
    """Multichannel time series -> patch embeddings.

    (B, T, C) --channel combine--> (B, T, C') --patchify--> (B, T/P, P·C')
    --linear--> (B, S, d_model). The paper's MOMENT encoder example.
    """

    def __init__(self, num_channels: int, new_num_channels: int,
                 patch: int, d_model: int):
        self.c_in, self.c_out, self.patch, self.d = \
            num_channels, new_num_channels, patch, d_model

    def init(self, gen):
        return {
            "combine": _normal(gen, (self.c_in, self.c_out), self.c_in),
            "proj": _normal(gen, (self.patch * self.c_out, self.d),
                            self.patch * self.c_out),
        }

    def apply(self, p, x):
        B, T, C = x.shape
        x = x @ p["combine"]                                   # (B, T, C')
        S = T // self.patch
        x = x[:, : S * self.patch].reshape(B, S, self.patch * self.c_out)
        return x @ p["proj"]                                   # (B, S, d)


class IdentityEncoder(Encoder):
    def apply(self, p, x):
        return x


class MLPDecoder(Decoder):
    """Pooled features -> task output (classification logits / regression).
    The tanh GELU, as ``jax.nn.gelu``'s default."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int):
        self.i, self.h, self.o = input_dim, hidden_dim, output_dim

    def init(self, gen):
        return {
            "w1": _normal(gen, (self.i, self.h), self.i),
            "b1": torch.zeros((self.h,), device=gen.device),
            "w2": _normal(gen, (self.h, self.o), self.h),
            "b2": torch.zeros((self.o,), device=gen.device),
        }

    def apply(self, p, feats):
        x = feats.mean(dim=1) if feats.dim() == 3 else feats   # pool (B, d)
        x = F.gelu(x @ p["w1"] + p["b1"], approximate="tanh")
        return x @ p["w2"] + p["b2"]


class LinearDecoder(Decoder):
    def __init__(self, input_dim: int, output_dim: int):
        self.i, self.o = input_dim, output_dim

    def init(self, gen):
        return {"w": _normal(gen, (self.i, self.o), self.i),
                "b": torch.zeros((self.o,), device=gen.device)}

    def apply(self, p, feats):
        x = feats.mean(dim=1) if feats.dim() == 3 else feats
        return x @ p["w"] + p["b"]

"""Synthetic-but-learnable token pipeline (deterministic, seedable).

Sequences follow a noisy affine recurrence over the vocab with per-sequence
(a, b) drawn from a small set — enough structure that a ~100M model's loss
drops well below uniform entropy within a few hundred steps, which is what the
end-to-end training example validates. For stub-frontend archs the pipeline
emits frame/patch embeddings + aligned labels.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig


class TokenPipeline:
    def __init__(self, cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.rng = np.random.RandomState(seed)
        self.params = [(5, 17), (7, 3), (11, 29), (13, 7)]

    def _tokens(self, n, s):
        V = max(self.cfg.vocab_size, 2)
        out = np.zeros((n, s), np.int64)
        for i in range(n):
            a, b = self.params[self.rng.randint(len(self.params))]
            x = self.rng.randint(V)
            for t in range(s):
                out[i, t] = x
                x = (a * x + b) % V
                if self.rng.rand() < 0.05:
                    x = self.rng.randint(V)
        return out.astype(np.int32)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        cfg = self.cfg
        b = {}
        if cfg.is_encoder_decoder:
            b["enc_embeds"] = self.rng.randn(
                self.batch, self.seq, cfg.d_model).astype(np.float32) * 0.1
            b["tokens"] = self._tokens(self.batch, self.seq)
        elif cfg.frontend_stub:
            b["embeds"] = self.rng.randn(
                self.batch, self.seq, cfg.d_model).astype(np.float32) * 0.1
            if cfg.vocab_size > 0:
                b["labels"] = self._tokens(self.batch, self.seq)
            if cfg.mrope_sections:
                pos = np.arange(self.seq, dtype=np.int32)
                b["pos3"] = np.tile(pos[None, :, None], (self.batch, 1, 3))
        else:
            b["tokens"] = self._tokens(self.batch, self.seq)
        return b

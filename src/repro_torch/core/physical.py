"""Physical FM: a loaded backbone + adapter/head stores + bucketed shapes.

A PhysicalFM owns:
  * backbone params for one ``ModelConfig`` on one device, each weight cast
    once to its use-site dtype (``models.lm.cast_params``);
  * an adapter store — LoRA A/B stacks padded to a common rank AND to a slot
    bucket (4/8/16/...) so the stacked shapes stay fixed while tasks come and
    go within capacity;
  * a decoder-head store — per-task heads applied after the shared pass;
  * a cache of forward executables keyed on (batch bucket, adapter slot
    bucket, lora impl), one per input length under each key, each captured
    as a CUDA graph at its second call (``core.graphs``): the JAX package's
    bucketed jit cache, whose zero-recompile tests carry over through
    ``compile_count``.

``run_batch`` picks the LoRA path per co-batch (``lora_impl="auto"``, the
default, as in the JAX package): ``AUTO_LORA_TABLE``, measured on the GPU by
``tools/lora_crossover.py``, chooses between the segmented path (the SGMV
kernel over adapter-sorted token blocks) and the per-request gather path
(two batched matmuls). Explicit ``"segmented"``/``"gather"`` pin one path.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import graphs
from repro_torch.core.profile import FMProfile, profile_backbone
from repro_torch.kernels.segmented_lora import SegmentMetaCache, padded_tokens
from repro_torch.models import lm
from repro_torch.models import lora as lora_mod
from repro_torch.models.common import tree_leaves, tree_map

BUCKETS = (1, 2, 4, 8, 16, 32)
SLOT_BUCKETS = (4, 8, 16, 32, 64)
LORA_IMPLS = ("auto", "segmented", "gather")

# lora_impl="auto": the faster path per (batch bucket, adapter-count bucket)
# cell, from ``run_batch`` pinned to each path on full-width moment-large
# (rank-4 adapters with random B, 32 patches a request; median wall time of
# a synchronized call, each a replay of the key's captured graph), measured
# by ``tools/lora_crossover.py`` on an NVIDIA H100 80GB HBM3 at a 700.00 W
# power limit (nvidia-smi), twice. "segmented" won every cell of both runs,
# by 0.9-2.0 ms of a 3.7-9.4 ms call: with the host out of the way the
# gather path's extra device time (1.0-3.2 ms a forward, ~330 more kernels)
# decides, so there is no crossover at these shapes. The JAX package's
# table was measured on its CPU backend and does not carry over.
# Re-measure when a kernel, the model path or the card changes.
NA_BUCKETS = (1, 2, 4, 8, 16)
AUTO_LORA_TABLE = {
    (1, 1): "segmented", (1, 2): "segmented", (1, 4): "segmented",
    (1, 8): "segmented", (1, 16): "segmented",
    (2, 1): "segmented", (2, 2): "segmented", (2, 4): "segmented",
    (2, 8): "segmented", (2, 16): "segmented",
    (4, 1): "segmented", (4, 2): "segmented", (4, 4): "segmented",
    (4, 8): "segmented", (4, 16): "segmented",
    (8, 1): "segmented", (8, 2): "segmented", (8, 4): "segmented",
    (8, 8): "segmented", (8, 16): "segmented",
    (16, 1): "segmented", (16, 2): "segmented", (16, 4): "segmented",
    (16, 8): "segmented", (16, 16): "segmented",
    (32, 1): "segmented", (32, 2): "segmented", (32, 4): "segmented",
    (32, 8): "segmented", (32, 16): "segmented",
}
# adapter-id sentinel for rows that are padding / free decode slots; beyond
# any real slot index AND any slot bucket, so both LoRA paths zero it out.
PAD_SENTINEL = 10**6


def bucket_for(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return BUCKETS[-1]


def slot_bucket_for(n: int) -> int:
    for b in SLOT_BUCKETS:
        if n <= b:
            return b
    return SLOT_BUCKETS[-1]


def seg_to_device(perm, inv, blocks, device) -> tuple:
    """Upload SGMV metadata: gather indices as int64, block ids as int32."""
    return (torch.as_tensor(perm, dtype=torch.long, device=device),
            torch.as_tensor(inv, dtype=torch.long, device=device),
            torch.as_tensor(blocks, dtype=torch.int32, device=device))


class AdapterStore:
    """Backbone LoRA adapters of one physical FM, stacked for co-batching.

    Each entry is a full per-layer LoRA tree (``models.lora`` layout, NA=1);
    ``stacked()`` maintains one NA=capacity() stack padded with zero-weight
    adapters up to the slot bucket, so its shape is stable while tasks come
    and go within capacity, and the "no adapter" sentinel ``capacity()``
    never aliases a real slot. The stack of each capacity is built once and
    then rewritten IN PLACE, slot by slot, wherever its slot's adapter
    changed (an add fills a pad slot; a removal shifts the later slots down
    and zeroes the freed one): the captured executables of a capacity read
    its stack where it lies, so it never moves."""

    def __init__(self, cfg, rank: int = 16, device="cuda"):
        self.cfg = cfg
        self.rank = rank
        self.device = torch.device(device)
        self.ids: list[str] = []
        self._trees: list = []
        # capacity -> (stack, the tree each slot holds; None: zeros)
        self._stacks: dict[int, tuple] = {}

    def __len__(self):
        return len(self.ids)

    def capacity(self) -> int:
        """Current slot-bucket capacity of the stacked representation."""
        return slot_bucket_for(max(1, len(self.ids)))

    def add(self, adapter_id: str, tree):
        if len(self.ids) >= SLOT_BUCKETS[-1]:
            raise ValueError(
                f"adapter slots exhausted ({SLOT_BUCKETS[-1]}) on this FM; "
                "deploy another physical FM instance for more tasks")
        self.ids.append(adapter_id)
        self._trees.append(tree_map(lambda t: t.to(self.device, torch.float32),
                                    tree))

    def new(self, adapter_id: str, seed: int = 0):
        """A fresh adapter (zero B: a zero delta until trained)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        tree = lora_mod.init_single_adapter(gen, self.cfg, self.rank,
                                            device=self.device)
        self.add(adapter_id, tree)
        return tree

    def remove(self, adapter_id: str):
        """Idempotent: the server frees adapters on unbind."""
        if adapter_id not in self.ids:
            return
        i = self.ids.index(adapter_id)
        del self.ids[i], self._trees[i]     # stacked() shifts the slots

    def index(self, adapter_id: Optional[str]) -> int:
        """Sentinel == capacity() (the stack's NA) means 'no adapter'."""
        if adapter_id in self.ids:
            return self.ids.index(adapter_id)
        return self.capacity()

    def _zero_tree(self):
        template = self._trees[0] if self._trees else \
            lora_mod.init_single_adapter(None, self.cfg, self.rank,
                                         device=self.device)
        return tree_map(torch.zeros_like, template)

    def stacked(self):
        cap = self.capacity()
        n = len(self.ids)
        if cap not in self._stacks:
            trees = self._trees + [self._zero_tree() for _ in range(cap - n)]
            self._stacks[cap] = (lora_mod.stack_adapters(trees),
                                 self._trees + [None] * (cap - n))
            return self._stacks[cap][0]
        stack, held = self._stacks[cap]
        for j in range(cap):                    # in place, changed slots only
            want = self._trees[j] if j < n else None
            if held[j] is not want:
                if want is None:
                    tree_map(lambda s: s[:, j].zero_(), stack)
                else:
                    tree_map(lambda s, t: s[:, j].copy_(t[:, 0]), stack, want)
                held[j] = want
        return stack


class PhysicalFM:
    """One deployed backbone instance on one device."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, lora_rank: int = 16,
                 input_len: int = 32, lora_impl: str = "auto",
                 seg_block_t: int = 16, device="cuda", params=None):
        if lora_impl not in LORA_IMPLS:
            raise ValueError(f"lora_impl={lora_impl!r}: one of {LORA_IMPLS}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.input_len = input_len
        self.lora_impl = lora_impl
        self.seg_block_t = seg_block_t
        t0 = time.perf_counter()
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = lm.init_model(gen, cfg, device=self.device)
        else:
            params = lm.cast_params(tree_map(lambda t: t.to(self.device), params))
        self.params = params
        self.adapters = AdapterStore(cfg, lora_rank, device=self.device)
        self.heads: dict[str, Callable] = {}        # task_id -> head fn
        # (batch bucket, slot bucket, impl) -> {input length: Executable}
        self._fn_cache: dict[tuple, dict] = {}
        self.seg_meta_cache = SegmentMetaCache()    # per-composition host sort
        self.load_time_s = time.perf_counter() - t0
        self.profile: Optional[FMProfile] = None

    # ---- stores ----
    def attach_head(self, task_id: str, head_fn: Callable):
        self.heads[task_id] = head_fn

    def detach_task(self, task_id: str):
        self.heads.pop(task_id, None)

    # ---- execution ----
    def compile_count(self) -> int:
        """Executables across every (batch bucket, slot bucket, impl) key,
        one per input length as ``jax.jit`` traces one per input shape
        (each captured as a CUDA graph at its second call): steady-state
        serving must not grow this."""
        return sum(len(fns) for fns in self._fn_cache.values())

    def resolve_lora_impl(self, rows: int, num_adapters: Optional[int] = None
                          ) -> str:
        """The LoRA path for a ``rows``-row co-batch: ``AUTO_LORA_TABLE`` at
        (batch bucket, adapter-count bucket) under "auto"; an explicit impl
        passes through. ``num_adapters`` defaults to the registered count;
        the decode engine passes its slot bucket so the choice cannot flip
        within one of its shape keys."""
        if self.lora_impl != "auto":
            return self.lora_impl
        na = len(self.adapters) if num_adapters is None else num_adapters
        nb = next((b for b in NA_BUCKETS if max(1, na) <= b), NA_BUCKETS[-1])
        return AUTO_LORA_TABLE[(bucket_for(rows), nb)]

    def _features_fn(self, bucket: int, slots: int, impl: str, seq_len: int):
        """Shared backbone forward with per-request backbone LoRA deltas,
        one executable per (batch bucket, adapter slot bucket, lora impl)
        and input length; the weights and the adapter stack are baked."""
        fns = self._fn_cache.setdefault((bucket, slots, impl), {})
        if seq_len not in fns:
            cfg, bt = self.cfg, self.seg_block_t

            def run(params, embeds, lora_stack, adapter_idx, perm, inv, blocks):
                seg = None
                if impl == "segmented":
                    seg = {"perm": perm, "inv": inv, "block_adapter": blocks,
                           "block_t": bt}
                # an audio-style backbone: the stub frames go to the
                # encoder; the decoder runs over a BOS-only token stream
                inputs = dict(tokens=torch.zeros(
                    embeds.shape[:2], dtype=torch.long, device=embeds.device),
                    enc_embeds=embeds) if cfg.is_encoder_decoder \
                    else dict(embeds=embeds)
                feats, _ = lm.forward(params, cfg, **inputs, lora=lora_stack,
                                      adapter_idx=adapter_idx, lora_impl=impl,
                                      lora_seg=seg)
                return feats.mean(dim=1)                   # (B, d) pooled

            fns[seq_len] = graphs.Executable(run, bake=(0, 2))
        return fns[seq_len]

    def segment_meta(self, adapter_idx: np.ndarray, cap: int, seq_len: int):
        """Per-batch SGMV metadata (host side, memoized per composition).
        Shapes depend only on (batch bucket, slot bucket, seq_len, block_t)."""
        b = len(adapter_idx)
        bt = self.seg_block_t
        # worst case: every distinct adapter plus the two sentinels ("no
        # adapter" == cap and batch padding) opens a block-padded segment
        max_segs = min(b, cap + 2)
        tp = padded_tokens(b * seq_len, max_segs, bt)
        ids = np.repeat(np.asarray(adapter_idx, np.int32), seq_len) \
            if seq_len != 1 else np.asarray(adapter_idx, np.int32)
        return self.seg_meta_cache.get(ids, cap, bt, tp)

    def run_batch_device(self, embeds, adapter_idx: np.ndarray):
        """Serve forward returning the pooled features as a device tensor
        (no host pull) so per-task heads can run on the device. The tensor
        is the caller's: a copy of the executable's output, which the next
        forward of the same key overwrites (the executor holds one batch's
        features while it dispatches the next)."""
        n = embeds.shape[0]
        if n > BUCKETS[-1]:            # oversize co-batch: serve in chunks
            c = BUCKETS[-1]
            return torch.cat(
                [self.run_batch_device(embeds[i:i + c], adapter_idx[i:i + c])
                 for i in range(0, n, c)])
        b = bucket_for(n)
        pad = b - n
        embeds = np.asarray(embeds, np.float32)
        adapter_idx = np.asarray(adapter_idx, np.int32)
        if pad:
            embeds = np.concatenate([embeds, np.zeros((pad,) + embeds.shape[1:],
                                                      embeds.dtype)])
            adapter_idx = np.concatenate(
                [adapter_idx, np.full((pad,), PAD_SENTINEL, np.int32)])
        stack = self.adapters.stacked()
        cap = self.adapters.capacity()
        impl = self.resolve_lora_impl(b)
        if impl == "segmented":
            perm, inv, blocks = seg_to_device(
                *self.segment_meta(adapter_idx, cap, embeds.shape[1]),
                self.device)
        else:   # the gather path never reads the metadata
            perm = inv = blocks = None
        out = self._features_fn(b, cap, impl, embeds.shape[1])(
            self.params, torch.as_tensor(embeds, device=self.device), stack,
            torch.as_tensor(adapter_idx, device=self.device), perm, inv,
            blocks)
        return out[:n].clone()

    def run_batch(self, embeds: np.ndarray, adapter_idx: np.ndarray):
        """embeds: (n, S, d); adapter_idx: (n,). Returns (n, d) f32 numpy
        features, padded to the next batch bucket on the device."""
        return self.run_batch_device(embeds, adapter_idx).float().cpu().numpy()

    def calibrate(self, sizes=(1, 2, 4, 8, 16)) -> FMProfile:
        d = self.cfg.d_model
        rng = np.random.RandomState(0)

        def run(b):
            e = rng.randn(b, self.input_len, d).astype(np.float32)
            self.run_batch(e, np.zeros((b,), np.int32))   # syncs on the copy

        # two lead calls a size: the executable's eager first call and its
        # capture, so the timed call is a replay, as in serving
        self.profile = profile_backbone(run, sizes=sizes, name=self.cfg.name,
                                        warmup=2)
        self.profile.load_time_s = self.load_time_s
        self.profile.memory_bytes = sum(
            t.numel() * t.element_size() for t in tree_leaves(self.params))
        return self.profile

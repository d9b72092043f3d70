#!/usr/bin/env python3
"""Measure the segmented/gather LoRA crossover of the pooled forward on one
GPU, the source of ``repro_torch.core.physical.AUTO_LORA_TABLE``.

    python3 tools/lora_crossover.py [--repeats 15] [--out PATH]

Full-width moment-large (random weights from a seed), 32 patches a request,
rank-4 q/v adapters with random A and B (a fresh adapter's B is zero). For
every (batch bucket in ``BUCKETS``) x (adapter count in ``NA_BUCKETS``) cell
it serves one co-batch of that many requests spread round-robin over that
many registered adapters (the executor's adapter-sorted order) through
``PhysicalFM.run_batch`` pinned to "segmented" and pinned to "gather", the
two in turns, each a replay of its key's captured executable (three warm
calls a key first: eager, capture, replay): the median wall time of a
synchronized call (what a caller waits), the device busy time of one call
and its idle share
(``chip_smoke.profile_step``: every device record of the call under
``torch.profiler``), K1's launches per call, and the host time of one segment-metadata
build with an empty memo (the serving path memoizes it per composition).
Prints one line per cell, the table as a Python literal to paste above
``AUTO_LORA_TABLE``, the card's name and power limit, and writes everything
as JSON to ``--out`` (default ``build/lora_crossover.json``). Needs a
CUDA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

INPUT_LEN, RANK = 32, 4
IMPLS = ("segmented", "gather")


def adapter(fm, i):
    """A rank-4 q/v adapter with random A and B at 0.05."""
    import torch

    from repro_torch.models import lora
    from repro_torch.models.common import tree_map
    gen = torch.Generator(device=fm.device).manual_seed(1000 + i)
    tree = lora.init_single_adapter(gen, fm.cfg, RANK, device=fm.device)
    return tree_map(lambda t: torch.randn(t.shape, generator=gen,
                                          device=fm.device) * 0.05, tree)


def measure(fm, x, aidx, repeats: int) -> dict:
    """Both impls on one co-batch, in turns."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.segmented_lora import SegmentMetaCache
    out = {}
    walls = {impl: [] for impl in IMPLS}
    for impl in IMPLS:                       # warm both keys
        fm.lora_impl = impl
        for _ in range(3):
            fm.run_batch(x, aidx)
    for i in range(repeats):
        for impl in (IMPLS if i % 2 == 0 else IMPLS[::-1]):
            fm.lora_impl = impl
            t0 = time.perf_counter()
            fm.run_batch(x, aidx)            # the host copy synchronizes
            walls[impl].append(time.perf_counter() - t0)
    for impl in IMPLS:
        fm.lora_impl = impl
        ops.reset_launches()
        fm.run_batch(x, aidx)
        k1 = int(ops.LAUNCHES["segmented_lora"])
        prof = cs.profile_step(lambda: fm.run_batch_device(x, aidx))
        out[impl] = {"wall_ms": 1e3 * statistics.median(walls[impl]),
                     "wall_ms_min": 1e3 * min(walls[impl]),
                     "device_ms": prof["device_busy_ms"],
                     "device_idle_share": prof["device_idle_share"],
                     "device_kernels": prof["device_kernels"],
                     "k1_launches": k1}
    memo, fm.seg_meta_cache = fm.seg_meta_cache, SegmentMetaCache()
    t0 = time.perf_counter()
    fm.segment_meta(aidx, fm.adapters.capacity(), x.shape[1])
    out["segment_meta_miss_ms"] = 1e3 * (time.perf_counter() - t0)
    fm.seg_meta_cache = memo
    torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=15)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "lora_crossover.json"))
    args = ap.parse_args()
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.physical import BUCKETS, NA_BUCKETS, PhysicalFM
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    dev = torch.device("cuda", 0)
    cfg = get_config("moment-large")
    base = PhysicalFM(cfg, seed=0, input_len=INPUT_LEN, lora_rank=RANK,
                      device=dev)
    smi = cs.smi_line()
    print(f"card: {smi}; {cfg.name} {cfg.num_layers} layers d {cfg.d_model}, "
          f"input_len {INPUT_LEN}, rank {RANK}, torch {torch.__version__}",
          flush=True)
    grid, table = [], {}
    for na in NA_BUCKETS:
        # one FM per adapter count, every one on the same weights
        fm = PhysicalFM(cfg, input_len=INPUT_LEN, lora_rank=RANK, device=dev,
                        params=base.params)
        for i in range(na):
            fm.adapters.add(f"lora{i}", adapter(fm, i))
        for b in BUCKETS:
            rng = np.random.RandomState(100 * b + na)
            x = rng.randn(b, INPUT_LEN, cfg.d_model).astype(np.float32)
            aidx = np.sort(np.arange(b) % na).astype(np.int32)
            cell = measure(fm, x, aidx, args.repeats)
            win = min(IMPLS, key=lambda k: cell[k]["wall_ms"])
            table[(b, na)] = win
            grid.append({"batch": b, "num_adapters": na, "winner": win,
                         **cell})
            print(f"b={b:2d} na={na:2d} segmented {cell['segmented']['wall_ms']:7.3f} "
                  f"ms wall / {cell['segmented']['device_ms']:7.3f} device "
                  f"({cell['segmented']['k1_launches']} K1); gather "
                  f"{cell['gather']['wall_ms']:7.3f} / "
                  f"{cell['gather']['device_ms']:7.3f}; meta miss "
                  f"{cell['segment_meta_miss_ms']:.3f} ms -> {win}",
                  flush=True)
        del fm
    print("AUTO_LORA_TABLE = {")
    for b in BUCKETS:
        print("    " + " ".join(f'({b}, {na}): "{table[(b, na)]}",'
                                for na in NA_BUCKETS))
    print("}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "config": cfg.name, "input_len": INPUT_LEN,
                   "rank": RANK, "repeats": args.repeats, "stat": "median",
                   "grid": grid}, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

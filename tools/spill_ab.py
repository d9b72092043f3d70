#!/usr/bin/env python3
"""What the host spill tier costs and saves per preemption, on one GPU.

    python3 tools/spill_ab.py [--reps 4] [--out FILE.json]

Full-width stablelm-1.6b (random weights from a seed, ``chip_smoke``'s 4
tasks with rank-16 q/v adapters), 8 live streams of 96-token prompts on a
paged pool with room for all of them and a 256 MiB host arena. Each round
preempts one live stream and resumes it at once, in turns (ABCCBA): from
its host spill with the engine's page upload (pinned memory, only the real
pages), from its spill with a pageable upload (the pages padded to the
fixed width on the host and copied from pageable memory), and with the
tier off
(the fold-and-re-prefill fallback). Prints, per kind, the median and every
sample of the resume's host ms (``DecodeEngine.resume_costs``: the spill
path after the entry's digest check, synchronized) and of the preemption
(``_preempt`` between two synchronizes: with the tier on it copies the
stream's pages and its prompt pages to the host and digests them), then
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def pageable_restore(self, blob, pages):
    """``DecodeEngine._restore_pages`` with a pageable upload: the pages
    padded to the fixed width on the host and copied from pageable
    memory."""
    import numpy as np
    import torch

    from repro_torch.core.decode_engine import TRASH_PAGE
    from repro_torch.core.spill import PAGE_KEYS
    n, W = len(pages), self.pages_per_slot
    idx = np.full((W,), TRASH_PAGE, np.int64)
    idx[:n] = pages
    data = []
    for sub in blob:
        d = {}
        for k in PAGE_KEYS:
            a = np.asarray(sub[k])
            pad = np.zeros((a.shape[0], W) + a.shape[2:], a.dtype)
            pad[:, :n] = a[:, :n]
            d[k] = torch.as_tensor(pad, device=self.device)
        data.append(d)
    self.pool = self._page_restore_fn()(
        self.pool, data, torch.as_tensor(idx, device=self.device))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this tool measures the port on a GPU",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.core.decode_engine import DecodeEngine
    from repro_torch.kernels import build
    build.build_all()
    dev = torch.device("cuda", 0)
    _, cfg, fm, _ = cs.build_server(dev, **cs.PAGED_KW)
    eng = cs.durability_engine(fm, spill_bytes=cs.SPILL_BYTES,
                               total_pages=None)
    for task, p, aid, rid in cs.durability_joins(cfg, seed=41, n=cs.SLOTS):
        eng.join(task, p, adapter_id=aid, max_new_tokens=cs.MAX_NEW, rid=rid)
    eng.step_chunk()
    pinned = DecodeEngine._restore_pages
    order = ["spill_pinned", "spill_pageable", "reprefill"]
    order += order[::-1]
    resume = {k: [] for k in order}
    preempt = {"spill": [], "no_spill": []}
    try:
        for rep in range(args.reps):
            for j, kind in enumerate(order):
                live = [i for i, s in enumerate(eng.slots) if s is not None]
                slot = live[(rep * len(order) + j) % len(live)]
                arena = eng.spill
                if kind == "reprefill":
                    eng.spill = None
                else:
                    DecodeEngine._restore_pages = pinned \
                        if kind == "spill_pinned" else pageable_restore
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng._preempt(slot)
                torch.cuda.synchronize()
                preempt["no_spill" if eng.spill is None else "spill"].append(
                    1e3 * (time.perf_counter() - t0))
                eng._drain_pending()
                eng.spill = arena
                got, sec = eng.resume_costs[-1]
                if got != ("reprefill" if kind == "reprefill" else "spill"):
                    raise RuntimeError(f"{kind}: the resume took the {got} "
                                       "path")
                resume[kind].append(1e3 * sec)
    finally:
        DecodeEngine._restore_pages = pinned
    out = {"resume_ms": {k: {"median": float(np.median(v)), "all": v}
                         for k, v in resume.items()},
           "preempt_ms": {k: {"median": float(np.median(v)), "all": v}
                          for k, v in preempt.items()},
           "card": cs.smi_line()}
    print(json.dumps(out, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

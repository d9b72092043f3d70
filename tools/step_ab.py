#!/usr/bin/env python3
"""Time full-width steps of this tree against a parent tree's on one GPU,
in turns.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/step_ab.py --parent build/parent [--rounds 2]

Each turn is a fresh process in a tree's root (parent, change, change,
parent, per round): it builds that tree's kernels, serves full-width
stablelm-1.6b behind ``FMplexServer`` with 4 adapters
(``chip_smoke.build_server``) and times, with that tree's own
``chip_smoke`` helpers, one decode step of the dense and of the paged
engine with 8 live streams (``live_step_timing``) and one speculative
verify step against the plain step of the same engine
(``spec_step_timing``): CUDA-event ms eager and graphed, and the
profile's device busy ms and kernel count. A change that moves work
between kernels shows here as the replayed graph's wall time, on one card.
Prints one JSON line per turn, medians by tree, and the card's name and
power limit. Needs a CUDA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# run in a tree's root: its chip_smoke and its src/
CHILD = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from repro_torch.kernels import build
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
build.build_all()
out = {}
for name, kw in (("dense", {}), ("paged", cs.PAGED_KW)):
    srv, cfg, fm, loop = cs.build_server(dev, **kw)
    eng = srv.decode_engine("fm0", **loop.engine_kwargs)
    r = cs.live_step_timing(dev, (srv, fm, eng), "", seed=1, rid0=-300)
    prof = r["decode_step_profile"]
    out[name] = {"event_ms": r["decode_step_ms"],
                 "busy_ms": prof["graphed"]["device_busy_ms"],
                 "kernels": prof["graphed"]["device_kernels"]}
    if name == "paged":
        s = cs.spec_step_timing(dev, fm)
        out["spec"] = {"verify_step_ms": s["verify_step_ms"],
                       "plain_step_ms": s["plain_step_ms"]}
    del srv, fm, eng, loop
    cs._release()
print("STEP " + json.dumps(out), flush=True)
"""


def turn(tree: str) -> dict:
    done = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                          capture_output=True, text=True)
    lines = [ln for ln in done.stdout.splitlines() if ln.startswith("STEP ")]
    if done.returncode or not lines:
        raise SystemExit(f"turn in {tree} failed ({done.returncode}):\n"
                         f"{done.stdout[-3000:]}\n{done.stderr[-3000:]}")
    return json.loads(lines[-1][5:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    trees = {"parent": os.path.abspath(args.parent), "change": ROOT}
    runs: dict = {"parent": [], "change": []}
    for _ in range(args.rounds):
        for who in ("parent", "change", "change", "parent"):
            r = turn(trees[who])
            runs[who].append(r)
            print(json.dumps({"tree": who, **r}), flush=True)

    def med(who, *path):
        vals = []
        for r in runs[who]:
            for k in path:
                r = r[k]
            vals.append(r)
        return statistics.median(vals)
    summary = {who: {
        "dense_graphed_ms": med(who, "dense", "event_ms", "graphed"),
        "paged_graphed_ms": med(who, "paged", "event_ms", "graphed"),
        "dense_busy_ms": med(who, "dense", "busy_ms"),
        "paged_busy_ms": med(who, "paged", "busy_ms"),
        "verify_step_graphed_ms": med(who, "spec", "verify_step_ms",
                                      "graphed"),
        "plain_step_graphed_ms": med(who, "spec", "plain_step_ms",
                                     "graphed")} for who in runs}
    print("medians " + json.dumps(summary), flush=True)
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

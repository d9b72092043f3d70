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

With ``--h2o-window`` each turn instead serves full-width
h2o-danube-1.8b at ``--layers`` layers (default 4) on the paged pool and
times one decode step with 8 live streams of 4160-token prompts, so that
every layer's paged attention (K4) runs under the 4096-position window:
CUDA-event ms eager and graphed, device busy ms and K4's device time in
the graphed step's profile (its kernels among the profile's eight
costliest).

With ``--pooled`` each turn instead times the pooled forwards whose
attention is K2's Hopper body: full-width stablelm-1.6b's pooled forward
of 32 requests x 128 positions and whisper-base's pooled batch of 4
requests x 1500 frames (encoder, and the decoder over as many BOS tokens),
each through ``PhysicalFM.run_batch_device``: device ms of the call
(``chip_smoke.device_ms``), the graphed call's CUDA-event ms and device
busy ms, and K2's device ms in the graphed call's profile.

With ``--families`` each turn instead runs ``chip_smoke``'s paged
servings of the families phase (``phase_family_serving``: qwen2-7b,
h2o-danube-1.8b and minitron-8b at their served depth, the serve loop
graphed) and reports each one's TPOT p50, TTFT p50, tokens/s and wall
time: the end-to-end numbers that K4's and the verify window's plan
moves on short spans.
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


# the same in a tree's root for h2o-danube-1.8b under its window: LAYERS
# and PROMPT are filled in
CHILD_H2O = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from repro_torch.kernels import build
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
build.build_all()
cfg = cs.family_config("h2o-danube-1.8b", num_layers=LAYERS)
pages = cs.SLOTS * (-(-(PROMPT + cs.MAX_NEW + 1 + cs.CHUNK) // cs.PAGE_SIZE) + 1) + 2
kw = dict(cs.PAGED_KW, total_pages=pages)
srv, cfg, fm, loop = cs.build_server(dev, cfg, prompt_len=PROMPT, **kw)
eng = srv.decode_engine("fm0", **loop.engine_kwargs)
r = cs.live_step_timing(dev, (srv, fm, eng), "", seed=1, rid0=-300,
                        prompt_len=PROMPT)
prof = r["decode_step_profile"]
k4 = sum(ms for n, ms in prof["graphed"]["top_kernels_ms"] if "paged" in n)
print("STEP " + json.dumps({"h2o_paged": {
    "event_ms": r["decode_step_ms"],
    "busy_ms": prof["graphed"]["device_busy_ms"],
    "kernels": prof["graphed"]["device_kernels"],
    "paged_attention_ms": k4}}), flush=True)
"""


# the same in a tree's root for the families phase's paged servings
CHILD_FAMILIES = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from repro_torch.kernels import build
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
build.build_all()
out = {}
for arch in (cs.QWEN2, cs.H2O, cs.MINITRON):
    ok, st = cs.phase_family_serving(dev, arch, "paged")
    out[arch] = {"ok": ok, **{k: st[k] for k in (
        "tpot_p50_ms", "ttft_p50_ms", "tokens_per_s", "wall_s")}}
print("STEP " + json.dumps(out), flush=True)
"""


# the same in a tree's root for the pooled forwards of stablelm-1.6b and
# whisper-base
CHILD_POOLED = r"""
import json, sys
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
from repro_torch.kernels import build
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
build.build_all()
out = {}
rng = np.random.RandomState(9)
aidx = np.sort(np.arange(32) % 4).astype(np.int32)
for name, kw, shape in (
        ("stablelm_pooled", {}, (32, cs.PROMPT_LEN)),
        ("whisper_pooled", dict(cfg=cs.whisper_config(), input_len=cs.ENC_LEN,
                                prompt_len=cs.W_PROMPT_LEN,
                                max_new=cs.W_MAX_NEW, enc_len=cs.ENC_LEN,
                                paged=True, page_size=cs.W_PAGE_SIZE),
         (4, cs.ENC_LEN))):
    srv, cfg, fm, loop = cs.build_server(dev, **kw)
    embeds = (rng.randn(*shape, cfg.d_model) * 0.5).astype(np.float32)
    idx = aidx[:shape[0]]

    def run():
        fm.run_batch_device(embeds, idx)
    run()
    torch.cuda.synchronize()
    prof = cs.profile_both(run, match="flash_attention_kernel")
    out[name] = {"device_ms": cs.device_ms(run, iters=10, warmup=2),
                 "event_ms": prof["graphed"]["event_ms"],
                 "busy_ms": prof["graphed"]["device_busy_ms"],
                 "k2_ms": prof["graphed"]["match_ms"]}
    del srv, fm, loop
    cs._release()
print("STEP " + json.dumps(out), flush=True)
"""


def turn(tree: str, child: str = CHILD) -> dict:
    done = subprocess.run([sys.executable, "-c", child], cwd=tree,
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
    ap.add_argument("--h2o-window", action="store_true")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--families", action="store_true")
    ap.add_argument("--pooled", action="store_true")
    args = ap.parse_args()
    trees = {"parent": os.path.abspath(args.parent), "change": ROOT}
    runs: dict = {"parent": [], "change": []}
    child = CHILD if not args.h2o_window else CHILD_H2O.replace(
        "LAYERS", str(args.layers)).replace("PROMPT", "4160")
    if args.families:
        child = CHILD_FAMILIES
    if args.pooled:
        child = CHILD_POOLED
    for _ in range(args.rounds):
        for who in ("parent", "change", "change", "parent"):
            r = turn(trees[who], child)
            runs[who].append(r)
            print(json.dumps({"tree": who, **r}), flush=True)
    if args.families:
        print("medians " + json.dumps({who: {arch: {
            k: statistics.median(r[arch][k] for r in runs[who])
            for k in ("tpot_p50_ms", "ttft_p50_ms", "tokens_per_s",
                      "wall_s")} for arch in runs[who][0]}
            for who in runs}), flush=True)
        sys.path.insert(0, ROOT)
        import chip_smoke as cs
        print(cs.smi_line(), flush=True)
        return 0
    if args.pooled:
        print("medians " + json.dumps({who: {name: {
            k: statistics.median(r[name][k] for r in runs[who])
            for k in ("device_ms", "event_ms", "busy_ms", "k2_ms")}
            for name in runs[who][0]} for who in runs}), flush=True)
        sys.path.insert(0, ROOT)
        import chip_smoke as cs
        print(cs.smi_line(), flush=True)
        return 0
    if args.h2o_window:
        print("medians " + json.dumps({who: {
            "graphed_ms": statistics.median(
                r["h2o_paged"]["event_ms"]["graphed"] for r in runs[who]),
            "eager_ms": statistics.median(
                r["h2o_paged"]["event_ms"]["eager"] for r in runs[who]),
            "busy_ms": statistics.median(
                r["h2o_paged"]["busy_ms"] for r in runs[who]),
            "paged_attention_ms": statistics.median(
                r["h2o_paged"]["paged_attention_ms"] for r in runs[who])}
            for who in runs}), flush=True)
        sys.path.insert(0, ROOT)
        import chip_smoke as cs
        print(cs.smi_line(), flush=True)
        return 0

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

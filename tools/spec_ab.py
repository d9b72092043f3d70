#!/usr/bin/env python3
"""Decode tokens/s of the speculative engine against the same engine with
``spec_k=0``, in turns, on one GPU.

    python3 tools/spec_ab.py [--reps 2] [--max-new 96] [--out FILE.json]

Full-width stablelm-1.6b (random weights from a seed, ``chip_smoke``'s 4
tasks with rank-16 q/v adapters), 8 slots, pages of 16 on a
dense-equivalent pool, chunk 4, greedy; the speculative engine at spec_k 4
with the default adaptive demotion (``spec_disable_below`` 1.25, probes
every 16 plain dispatches). Two workloads, each 8 streams admitted up
front (untimed) and then drained (timed: pure decode):

  * agentic — the copy-inclined model (every attention out-projection
    zeroed, as the JAX package's ``bench_speculative.py`` does: the next
    token is a function of the current one) on ``agentic_token_trace``
    prompts (self-overlap 0.85) that re-feed the model's own earlier output
    (``chip_smoke.echo_joins``' construction: the stream continues a span
    it already emitted, as an agent loop re-feeding its context does);
  * adversarial — random weights on ``adversarial_token_trace`` prompts
    (no self-overlap: every draft misses, and the demotion is what keeps
    the verify cost off the step).

Each workload runs plain, spec, spec, plain (``--reps`` times), every
engine warmed first (its prefill bucket, both decode ladders; no chunk
runs, so the accept average starts unread). Prints per
run the tokens/s and per engine the accept rate, tokens per dispatch and
fallbacks, the streams' equality across engines, and the card's name and
power limit. The numbers are figures, not gates.
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

PROMPT_LEN = 256          # the echo prompts: context, echo, re-entry


def engine(fm, spec_k: int, max_new: int):
    from repro_torch.core.decode_engine import DecodeEngine
    import chip_smoke as cs
    return DecodeEngine(fm, num_slots=cs.SLOTS, prompt_len=PROMPT_LEN,
                        prompt_buckets=(PROMPT_LEN,), max_new=max_new,
                        chunk=cs.CHUNK, paged=True, page_size=cs.PAGE_SIZE,
                        prefix_sharing=True, chunked_prefill=False,
                        spec_k=spec_k)


def warm(eng, vocab: int):
    """The prefill bucket twice (each join left at once: no chunk runs, so
    the accept average starts unread), both decode ladders and the
    refresh's key."""
    import numpy as np
    rng = np.random.RandomState(5)
    for _ in range(2):
        slot = eng.join("task0", rng.randint(0, vocab, PROMPT_LEN),
                        adapter_id="lora0", max_new_tokens=2, rid=-1)
        eng.leave(slot)
    eng.warm_decode_ladder()
    eng.warm_speculative()
    eng._rescale_fn()


def workload(fm, cfg, kind: str, max_new: int) -> list:
    """(task, prompt, adapter, rid) for 8 streams."""
    import numpy as np

    from repro_torch.serving.loadgen import (adversarial_token_trace,
                                             agentic_token_trace)
    import chip_smoke as cs
    kw = dict(prompt_len=64, vocab=cfg.vocab_size, max_new=max_new,
              min_new=max_new, seed=3)
    reqs = agentic_token_trace("t", 10.0, 100.0, overlap=0.85, **kw) \
        if kind == "agentic" else adversarial_token_trace("t", 10.0, 100.0,
                                                          **kw)
    joins = [(f"task{i % cs.N_TASKS}", np.asarray(r.payload, np.int32),
              f"lora{i % cs.N_TASKS}", i) for i, r in enumerate(reqs[:cs.SLOTS])]
    if kind != "agentic":
        return joins
    # the echo: each context's own greedy continuation, re-fed
    eng = engine(fm, 0, max_new)
    for task, p, a, rid in joins:
        eng.join(task, p, adapter_id=a, max_new_tokens=max_new, rid=rid)
    chains = {d.rid: np.asarray(d.tokens, np.int32) for d in eng.drain()}
    rng = np.random.RandomState(4)
    return [(task, np.concatenate([p, chains[rid],
                                   rng.randint(0, cfg.vocab_size, 4).astype(
                                       np.int32), chains[rid][:2]]), a, rid)
            for task, p, a, rid in joins]


def drive(eng, joins, max_new: int) -> tuple[float, dict]:
    import torch
    for task, p, a, rid in joins:
        eng.join(task, p, adapter_id=a, max_new_tokens=max_new, rid=rid)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = {}
    while eng.active_count() or eng.pending_count():
        for d in eng.step_chunk():
            done[d.rid] = list(d.tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the prefill's first token is not decode work
    return sum(len(t) - 1 for t in done.values()) / wall, done


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=96)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this tool measures the port on a GPU",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.serving.metrics import speculation_stats
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    dev = torch.device("cuda", 0)
    _, cfg, fm, _ = cs.build_server(dev)
    out = {"card": cs.smi_line(), "max_new": args.max_new, "slots": cs.SLOTS,
           "spec_k": cs.SPEC_K, "chunk": cs.CHUNK}
    for kind in ("adversarial", "agentic"):
        if kind == "agentic":
            for sub in fm.params["layers"]:        # the copy-inclined model
                sub["attn"]["wo"].zero_()
        joins = workload(fm, cfg, kind, args.max_new)
        engines = {"plain": engine(fm, 0, args.max_new),
                   "spec": engine(fm, cs.SPEC_K, args.max_new)}
        for eng in engines.values():
            warm(eng, cfg.vocab_size)
        keys = {n: e.compile_count() for n, e in engines.items()}
        base = {n: speculation_stats(e) for n, e in engines.items()}
        rates = {"plain": [], "spec": []}
        streams = {}
        for _ in range(args.reps):
            for name in ("plain", "spec", "spec", "plain"):
                tps, done = drive(engines[name], joins, args.max_new)
                rates[name].append(tps)
                streams.setdefault(name, done)
        spec = engines["spec"]
        st = speculation_stats(spec)
        res = {
            "tokens_per_s": {n: {"median": float(np.median(v)), "all": v}
                             for n, v in rates.items()},
            "spec_over_plain": float(np.median(rates["spec"])
                                     / np.median(rates["plain"])),
            "accept_rate": st["accept_rate"],
            "draft_proposed": st["draft_proposed"]
            - base["spec"]["draft_proposed"],
            "draft_accepted": st["draft_accepted"]
            - base["spec"]["draft_accepted"],
            "spec_dispatches": st["spec_dispatches"]
            - base["spec"]["spec_dispatches"],
            "spec_fallbacks": st["spec_fallbacks"]
            - base["spec"]["spec_fallbacks"],
            "tokens_per_dispatch": st["tokens_per_dispatch"],
            "streams_equal": streams["plain"] == streams["spec"],
            "keys_added": {n: e.compile_count() - keys[n]
                           for n, e in engines.items()},
        }
        if not res["streams_equal"]:
            res["first_mismatch"] = cs.first_mismatch(streams["spec"],
                                                      streams["plain"])
        out[kind] = res
        print(kind, json.dumps(res), flush=True)
        del engines
        cs._release()
    print(json.dumps(out, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

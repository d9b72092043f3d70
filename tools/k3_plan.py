#!/usr/bin/env python3
"""Where K3's two bodies cross over: each body at each shape, in turns.

    python3 tools/k3_plan.py [--out RESULTS.json] [--quick]

For each shape below, K3 (``ops.decode_attention_int8``) runs with its
plan forced (``chip_smoke.k3_forced``) to the one-CTA body
("cta"), the split body with one split ("split") and with several splits
and the merge launch ("merge", at the plan's count and at half and twice
it), each held against the plain version (two bf16 ulps of the largest
output) and timed on the card (device time of the call's kernels, summed,
from ``torch.profiler``; input sets rotated so each call finds its cache
cold), in turns: forward then reverse. Prints one JSON line a shape: the
plan's choice, each candidate's times and error, the fastest, SDPA on the
cache dequantized to bf16 (``enable_gqa``, the window as a mask; never
called by the port) and the bound; then the card's name and power limit.
``--quick`` keeps the serving shapes. Needs a CUDA GPU and nvcc.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

# name: (B, H, KV, hd, S, window, lowest length, input sets); lengths are
# random in [lowest, S] (the long shapes: S), as chip_smoke times them
SHAPES = {
    "stablelm": (8, 32, 32, 64, 161, None, 1, 24),
    "whisper": (8, 8, 8, 64, 129, None, 1, 24),
    "olmoe": (8, 16, 16, 128, 161, None, 1, 24),
    "qwen2": (8, 28, 4, 128, 161, None, 1, 24),
    "jamba": (8, 32, 8, 128, 161, None, 1, 24),
    "grok": (8, 48, 8, 128, 161, None, 1, 24),
    "stablelm_s640": (8, 32, 32, 64, 640, None, 1, 12),
    "qwen2_s1024": (8, 28, 4, 128, 1024, None, 1, 12),
    "h2o_window": (8, 32, 8, 80, 4200, 4096, 4097, 6),
    "h2o_long_window": (1, 32, 8, 80, 524288, 4096, 524288, 1),
    "jamba_long": (1, 32, 8, 128, 524288, None, 524288, 1),
}
QUICK = ("stablelm", "whisper", "olmoe", "qwen2", "jamba", "grok")


def candidates(planned, long_span: bool):
    body, n = planned
    out = [] if long_span else [("cta", 1)]
    out.append(("split", 1))
    base = n if body == "merge" else 4
    for m in sorted({max(2, base // 2), base, 2 * base}):
        out.append(("merge", m))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import decode_attention_int8 as k3
    build.build_all(["decode_attention_int8"])
    print("ptxas: " + ", ".join(f"{k}: {r}, {sp}" for k, r, sp in
                                cs.ptxas_kernels("decode_attention_int8")),
          flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(31)
    sms = build.sm_count(0)
    results, ok = [], True
    for name, (B, H, KV, hd, S, window, lo, nsets) in SHAPES.items():
        if args.quick and name not in QUICK:
            continue
        lens = None
        if lo > 1:
            lens = torch.randint(lo, S + 1, (B,), generator=torch.Generator()
                                 .manual_seed(S)).tolist()
        sets = cs.int8_inputs(gen, B, H, KV, S, hd, nsets, dev, lens=lens)
        planned = k3.plan(B, KV, H // KV, hd, S, window, sms)
        q, kq, vq, ks, vs, ln = sets[0]
        want = ref.decode_attention_int8_ref(
            q, kq.transpose(1, 2), vq.transpose(1, 2), ks, vs, ln,
            window=window)
        tol = 2 * 2.0 ** -8 * want.float().abs().max().item() + 1e-6

        def call(q, kq, vq, ks, vs, ln):
            return ops.decode_attention_int8(q, kq, vq, ks, vs, ln,
                                             window=window)
        rec = {"shape": name, "B": B, "H": H, "KV": KV, "hd": hd, "S": S,
               "window": window, "plan": list(planned), "us": {},
               "max_abs_err": {}}
        cands = candidates(planned, S > 100000)
        for cand in cands:
            with cs.k3_forced(cand):
                got, again = call(*sets[0]), call(*sets[0])
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                label = f"{cand[0]}{cand[1]}"
                rec["max_abs_err"][label] = err
                good = err <= tol and torch.equal(got, again)
                ok &= good
                if not good:
                    print(f"FAIL {name} {label}: err {err:.3e} (bound "
                          f"{tol:.3e}), same bits {torch.equal(got, again)}",
                          flush=True)
        it = dict(iters=5, warmup=2) if S > 100000 else {}
        for cand in cands + cands[::-1]:
            with cs.k3_forced(cand):
                rec["us"].setdefault(f"{cand[0]}{cand[1]}", []).append(
                    1e3 * cs.device_ms(cs.rotating(call, sets), **it))
        rec["fastest"] = min(rec["us"], key=lambda k: min(rec["us"][k]))
        kd = (kq.transpose(1, 2).float() * ks[:, :, None, None]).to(
            torch.bfloat16)
        vd = (vq.transpose(1, 2).float() * vs[:, :, None, None]).to(
            torch.bfloat16)
        mask = cs.window_mask(S, ln, window, dev)
        rec["sdpa_us"] = 1e3 * cs.device_ms(
            lambda: F.scaled_dot_product_attention(
                q[:, :, None], kd, vd, attn_mask=mask, enable_gqa=True),
            **({"iters": 5, "warmup": 2} if S > 100000 else {}))
        del kd, vd, mask
        rec["bound_us"] = 1e3 * cs.int8_bound(q, kq, ln, window)[0]
        print(json.dumps(rec), flush=True)
        results.append(rec)
        del sets, q, kq, vq, want
        torch.cuda.empty_cache()
    smi = cs.smi_line()
    print(smi, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "shapes": results}, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where the int8 decode kernels' bodies cross over: each body at each
shape, in turns.

    python3 tools/k3_plan.py [--out RESULTS.json] [--quick]
        [--kernels k3 k4 verify]

K3 (``ops.decode_attention_int8``): for each shape in ``SHAPES`` the plan
is forced (``chip_smoke.k3_forced``) to the one-CTA body ("cta"), the
split body with one split ("split") and with several splits and the merge
launch ("merge", at the plan's count and at half and twice it). K4
(``ops.paged_decode_attention``) and the verify window
(``ops.paged_verify_attention``, T 5), which take one plan
(``paged_decode_attention.plan``): for each shape in ``PAGED_SHAPES``
the plan is forced (``chip_smoke.k4_forced``) to the one-CTA body, the
split body with one cell over the table and with cells of ``CELLS`` keys
and the plan's (several cells and the merge). Each candidate is held
against the plain version (two bf16 ulps of the largest output; the
verify window's positions also bit for bit against K4 at their lengths
under the same plan) and timed on the card (device time of the call's
kernels, summed, from ``torch.profiler``; input sets rotated so each call
finds its cache cold), in turns: forward then reverse. Prints one JSON
line a shape: the plan's choice, each candidate's times and error, the
fastest, SDPA on the cache dequantized to bf16 (``enable_gqa``, the
window as a mask; never called by the port) and the bound; then the
card's name and power limit. ``--quick`` keeps the serving shapes. Needs a
CUDA GPU and nvcc.
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
# K4 and the verify window: name: (B, H, KV, hd, K4's MP, the verify
# window's MP, window, lowest length, input sets), pages of 16 (the tables
# chip_smoke times); lengths random in [lowest, MP * 16] (the verify
# window's base lengths leave room for its T positions)
PAGED_SHAPES = {
    "stablelm": (8, 32, 32, 64, 11, 13, None, 1, 24),
    "whisper": (8, 8, 8, 64, 9, 11, None, 1, 24),
    "olmoe": (8, 16, 16, 128, 11, 13, None, 1, 24),
    "qwen2": (8, 28, 4, 128, 11, 13, None, 1, 24),
    "jamba": (8, 32, 8, 128, 11, 13, None, 1, 24),
    "h2o": (8, 32, 8, 80, 11, 13, 4096, 1, 24),
    "h2o_window": (8, 32, 8, 80, 263, 264, 4096, 4097, 6),
}
CELLS = (256, 512, 1024, 1088, 1408, 2048)


def candidates(planned, long_span: bool):
    body, n = planned
    out = [] if long_span else [("cta", 1)]
    out.append(("split", 1))
    base = n if body == "merge" else 4
    for m in sorted({max(2, base // 2), base, 2 * base}):
        out.append(("merge", m))
    return out


def paged_candidates(planned, S: int, window, quick: bool) -> list:
    """K4's forced plans (``paged_decode_attention.plan`` values) at a
    shape: the one-CTA body, one cell over the table, the plan's cells and
    those of ``CELLS`` keys below the table."""
    whole = 64 * -(-S // 64)
    cells = {planned[1]} - {0, whole}
    if not quick:
        span = min(window, S) if window else S
        cells |= {c for c in CELLS if c < span} or {64 * max(1, span // 256)}
    return [("cta", 0), ("split", whole)] + [("split", c)
                                             for c in sorted(cells)]


def cand_label(cand, S: int, window, T: int) -> str:
    """A forced plan's label: the body a call of T positions runs, the
    cells a pair walks and the cell's keys (``merge4x1088``)."""
    from repro_torch.kernels import paged_decode_attention as k4
    with cs.k4_forced(cand):
        sp = k4.split_for(1, 1, 1, 64, S, window, T, 1)
    return f"{sp.body}{max(sp.nsplit, 1)}x{sp.cell}"


def paged_shapes(args, dev, gen, sms) -> tuple[list, bool]:
    """K4 and the verify window at ``PAGED_SHAPES``, every candidate in
    turns: (one record a shape and kernel, all checks passed)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_decode_attention as k4
    results, ok = [], True
    T = cs.SPEC_K + 1
    for name, (B, H, KV, hd, MP, MPv, window, lo, nsets) in \
            PAGED_SHAPES.items():
        if args.quick and name not in QUICK:
            continue
        G = H // KV
        for kernel in ("k4", "verify"):
            if kernel not in args.kernels:
                continue
            mp = MPv if kernel == "verify" else MP
            S = mp * cs.PAGE_SIZE
            rng = torch.Generator().manual_seed(S)
            if kernel == "k4":
                lens = torch.randint(lo, S + 1, (B,), generator=rng).tolist()
                sets = cs.paged_inputs(gen, B, H, KV, hd, 1 + B * mp, nsets,
                                       dev, lens=lens, MP=mp)
                call = (lambda q, kp, vp, ks, vs, pt, ln:
                        ops.paged_decode_attention(q, kp, vp, ks, vs, pt, ln,
                                                   window=window))
                plain = ref.paged_decode_attention_ref
            else:
                sets = [cs.verify_inputs(
                    gen, B, H, KV, hd, T, mp, torch.randint(
                        min(lo, S - T), S - T + 1, (B,),
                        generator=rng).tolist(), dev) for _ in range(nsets)]
                call = (lambda q, kp, vp, ks, vs, pt, ln:
                        ops.paged_verify_attention(q, kp, vp, ks, vs, pt, ln,
                                                   window=window))
                plain = ref.paged_verify_attention_ref
            q, kp, vp, ks, vs, pt, ln = sets[0]
            want = plain(q, kp.transpose(1, 2), vp.transpose(1, 2), ks, vs,
                         pt, ln, window=window)
            tol = 2 * 2.0 ** -8 * want.float().abs().max().item() + 1e-6
            planned = k4.plan(B, KV, G, hd, S, window, sms)
            rec = {"kernel": kernel, "shape": name, "B": B, "H": H, "KV": KV,
                   "hd": hd, "MP": mp, "window": window,
                   "plan": list(planned), "us": {}, "max_abs_err": {}}
            cands = paged_candidates(planned, S, window, args.quick)
            nt = T if kernel == "verify" else 1
            for cand in cands:
                label = cand_label(cand, S, window, nt)
                with cs.k4_forced(cand):
                    got, again = call(*sets[0]), call(*sets[0])
                    good = torch.equal(got, again)
                    if kernel == "verify":
                        per = torch.stack([ops.paged_decode_attention(
                            q[:, j].contiguous(), kp, vp, ks, vs, pt,
                            (ln + j + 1).to(torch.int32), window=window)
                            for j in range(T)], dim=1)
                        good &= torch.equal(got, per)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                rec["max_abs_err"][label] = err
                good &= err <= tol
                ok &= bool(good)
                if not good:
                    print(f"FAIL {kernel} {name} {label}: err {err:.3e} "
                          f"(bound {tol:.3e})", flush=True)
            for cand in cands + cands[::-1]:
                label = cand_label(cand, S, window, nt)
                with cs.k4_forced(cand):
                    rec["us"].setdefault(label, []).append(
                        1e3 * cs.device_ms(cs.rotating(call, sets)))
            rec["fastest"] = min(rec["us"], key=lambda k: min(rec["us"][k]))
            lib_sets = []
            for q, kp, vp, ks, vs, pt, ln in sets[:4]:
                def gathered(pages, sc):
                    g = pages[pt.long()].float() * \
                        sc[pt.long()][:, :, None, :, None]
                    return g.permute(0, 3, 1, 2, 4).reshape(
                        B, KV, S, hd).to(torch.bfloat16)
                lens = ln[:, None] + (torch.arange(T, device=dev)[None] + 1
                                      if kernel == "verify" else 0)
                pos = torch.arange(S, device=dev)[None, None]
                mask = pos < lens[..., None]
                if window is not None:
                    mask &= pos >= lens[..., None] - window
                qq = q.transpose(1, 2) if kernel == "verify" else q[:, :, None]
                lib_sets.append((qq.contiguous(), gathered(kp, ks),
                                 gathered(vp, vs), mask[:, None]))
            rec["sdpa_us"] = 1e3 * cs.device_ms(cs.rotating(
                lambda q, k, v, m: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=m, enable_gqa=True), lib_sets))
            del lib_sets
            rec["bound_us"] = 1e3 * (
                cs.verify_bound(q, kp, pt, ln, window) if kernel == "verify"
                else cs.paged_bound(q, kp, pt, ln, window))[0]
            print(json.dumps(rec), flush=True)
            results.append(rec)
            del sets, want
            torch.cuda.empty_cache()
    return results, ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--kernels", nargs="+", default=["k3", "k4", "verify"],
                    choices=["k3", "k4", "verify"])
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import decode_attention_int8 as k3
    libs = ["decode_attention_int8", "paged_decode_attention",
            "paged_verify_attention"]
    build.build_all(libs)
    for lib in libs:
        print(f"ptxas {lib}: " + ", ".join(
            f"{k}: {r}, {sp}" for k, r, sp in cs.ptxas_kernels(lib)),
            flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(31)
    sms = build.sm_count(0)
    results, ok = [], True
    for name, (B, H, KV, hd, S, window, lo, nsets) in SHAPES.items():
        if "k3" not in args.kernels:
            break
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
    paged, paged_ok = paged_shapes(args, dev, gen, sms)
    results += paged
    ok &= paged_ok
    smi = cs.smi_line()
    print(smi, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": smi, "shapes": results}, f, indent=1)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

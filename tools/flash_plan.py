#!/usr/bin/env python3
"""Where the prefill attention's (K2's) bodies cross over: each body at each
timed shape, in turns.

    python3 tools/flash_plan.py [--out RESULTS.json] [--quick] [--shapes a,b]

For each shape of ``chip_smoke.FLASH_TIMED`` (or the ``--shapes`` named)
the plan (``flash_attention.plan``) is forced (``chip_smoke.flash_forced``)
to each form of ``chip_smoke.flash_forms`` (the mma body with its own
split; where the Hopper body takes the call, that body with 64 and with
128 rows a CTA, unsplit, and with 64 rows in about three splits) and, at
512 keys or more, the Hopper body with 64 and 128 rows and the keys in 2,
3 and 4 splits of whole key tiles. Each candidate is held against the
plain version (two bf16 ulps of the largest output, and bit-identical
over two calls) and timed on the card (device time of the call's kernels,
summed, from ``torch.profiler``; input sets rotated so that each call
finds its operands cold), in turns: forward then reverse. Prints one JSON
line a shape: the plan's choice, each candidate's times and error, the
fastest, ``scaled_dot_product_attention`` on the same inputs
(``chip_smoke.flash_sdpa_args``; never called by the port) and the bound;
then the card's name and power limit. ``--quick`` keeps the pooled
shapes, stablelm's admission and whisper's encoder. The ptxas report of
the build (registers, spill stores, and any wgmma serialization warning)
and the count of HGMMA instructions in the library are printed first;
each check and timing is announced on stderr. Needs a CUDA GPU and nvcc.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402

QUICK = ("pooled", "admission", "whisper_encoder", "qwen2_pooled",
         "olmoe_pooled", "jamba_pooled")

def ptxas_summary(label: str, report: str) -> dict:
    """Registers and spill stores of each kernel in a ptxas report, and
    its lines that report serialized wgmma (C75xx)."""
    kernels = {k: [r, sp] for k, r, sp in
               cs.ptxas_kernels("flash_attention", report)}
    warn = sorted({ln.strip()[:200] for ln in report.splitlines()
                   if "C75" in ln or "serializ" in ln})
    out = {"build": label, "kernels": kernels, "wgmma_warnings": warn}
    print("ptxas " + json.dumps(out), flush=True)
    return out


def candidates(shape: tuple, sms: int) -> dict:
    """The Plan of each form timed at a call's shapes, by label."""
    from repro_torch.kernels import flash_attention as fa
    forms = cs.flash_forms(shape, sms)
    Sk = shape[2]
    if "wgmma64" in forms and Sk >= 512:
        tile = fa._SM90_TILE
        for rows in (64, 128):
            for n in (2, 3, 4):
                part = tile * -(-Sk // n // tile)
                forms[f"wgmma{rows}_split{n}"] = fa.Plan(
                    "wgmma", rows, -(-Sk // part), part)
    return forms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--shapes", help="comma-separated FLASH_TIMED names")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from repro_torch.kernels import build, ops, ref
    build.build_all(["flash_attention"])
    ptxas_summary("flash_attention", (build.BUILD_DIR / "flash_attention.log")
                  .read_text())
    print("sass " + json.dumps(cs.sass_hmma("flash_attention")), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4)
    sms = cs.sm_count(dev)
    results = []
    names = args.shapes.split(",") if args.shapes else \
        QUICK if args.quick else tuple(cs.FLASH_TIMED)
    for name in names:
        case = cs.FLASH_TIMED[name]
        nsets = 2 if case["B"] * case["Sq"] * case["Sk"] > 2 ** 21 else 24
        sets = cs.flash_inputs(gen, dev, **case, nsets=nsets)
        (q, k, v), kw = sets[0]
        shape = cs.flash_shape(q, k, kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        rows = cs.flash_visible(q, k, kw).any(dim=-1)
        tol = 2 * 2.0 ** -8 * want.float()[rows].abs().max().item() + 1e-6

        def rotating(fn):
            it = [0]

            def call():
                a, kwa = sets[it[0] % len(sets)]
                fn(*a, **kwa)
                it[0] += 1
            return call

        def forced(side):
            def call(*a, **kwa):
                with cs.flash_forced(side):
                    return ops.flash_attention(*a, **kwa)
            return call
        fns = {label: forced(side)
               for label, side in candidates(shape, sms).items()}
        checks = {}
        for label, fn in list(fns.items()):
            print(f"# {name}: check {label}", file=sys.stderr, flush=True)
            try:
                got, again = fn(q, k, v, **kw), fn(q, k, v, **kw)
            except RuntimeError as e:
                checks[label] = {"failed": str(e)}
                del fns[label]
                continue
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()[rows].max().item()
            checks[label] = {"max_abs_err": err, "ok": err <= tol,
                             "bit_identical": bool(torch.equal(got, again))}
        lib_sets = [cs.flash_sdpa_args(*a, kwa) for a, kwa in sets]
        times = {label: [] for label in fns}
        sdpa = []
        for label in list(fns) + list(reversed(fns)):
            if label not in fns:
                continue
            print(f"# {name}: time {label}", file=sys.stderr, flush=True)
            try:
                times[label].append(1e3 * cs.device_ms(rotating(fns[label])))
            except RuntimeError as e:
                checks[label] = {"failed": str(e)}
                del fns[label], times[label]
        for _ in range(2):
            it = [0]

            def lib_call():
                a, kwa = lib_sets[it[0] % len(lib_sets)]
                F.scaled_dot_product_attention(*a, **kwa)
                it[0] += 1
            sdpa.append(1e3 * cs.device_ms(lib_call))
        b_ms, b_by = cs.flash_bound(q, k, kw)
        best = min(times, key=lambda lb: min(times[lb]))
        line = {"shape": name, "case": case,
                "plan": cs.flash_plan(q, k, kw),
                "us": times, "checks": checks, "fastest": best,
                "sdpa_us": sdpa, "bound_us": 1e3 * b_ms, "bound_by": b_by}
        print(json.dumps(line), flush=True)
        results.append(line)
    smi = cs.smi_line()
    print(smi, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"shapes": results, "smi": smi}, f, indent=1)
    return 0 if all(c.get("ok") and c.get("bit_identical")
                    for r in results for c in r["checks"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())

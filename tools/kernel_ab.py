#!/usr/bin/env python3
"""Time two versions of the port's CUDA kernels on one GPU, in turns.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/kernel_ab.py --parent build/parent [--kernels NAME ...]

For each kernel named (default: ``decode_attention`` and ``segmented_lora``)
this builds the parent tree's source (``<parent>/src/repro_torch/csrc``)
beside this tree's, loads the parent's wrapper module from its file with
the parent's library swapped in, and times both on the same input sets at
the serving shapes of ``chip_smoke.py`` (parent, change, change, parent;
device time from ``torch.profiler``, by kernel name, so a call's split
into its kernels shows; then the host time per call the same way), after
checking that both agree. Prints one JSON
line per shape and the card's name and power limit. ``build/`` is
gitignored, so the parent tree and its library stay out of commits. Needs
a CUDA GPU and nvcc.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def parent_wrapper(parent: str, name: str):
    """The parent tree's wrapper module of kernel ``name``, its library
    built from the parent's source, and a function that calls a wrapper
    function with that library in place of this tree's."""
    from repro_torch.kernels import build
    src = os.path.join(parent, "src", "repro_torch", "csrc", build.SOURCES[name])
    so = build.BUILD_DIR / f"{name}-parent.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), src],
                   check=True, capture_output=True, text=True)
    import ctypes
    lib = ctypes.CDLL(str(so))
    spec = importlib.util.spec_from_file_location(
        f"_parent_{name}",
        os.path.join(parent, "src", "repro_torch", "kernels", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    def swapped(fn):
        def call(*a, **kw):
            saved = build._LIBS.get(name)
            build._LIBS[name] = lib
            try:
                return fn(*a, **kw)
            finally:
                build._LIBS[name] = saved
        return call
    return mod, swapped


def rotating(fn, sets):
    it = [0]

    def call():
        fn(*sets[it[0] % len(sets)])
        it[0] += 1
    return call


def cases(name: str, dev, gen):
    """(shape name, input sets, call(new_module)) at the serving shapes."""
    from repro_torch.kernels.segmented_lora import padded_tokens
    if name == "decode_attention":
        for shape, nsets in (("cross", 6), ("float_pool", 24)):
            c = cs.FLOAT_CASES[shape]
            sets = cs.float_inputs(gen, cs.SLOTS, c["H"], c["KV"], c["S"], 64,
                                   nsets, dev, lens=None
                                   if shape == "float_pool" else c["lens"])
            yield shape, sets, lambda mod: mod.decode_attention
    elif name == "segmented_lora":
        for shape, n_tok, segs, d, nsets in (
                ("decode", cs.SLOTS, 6, 2048, 24),
                ("prefill", cs.PROMPT_LEN, 6, 2048, 24),
                ("pooled", 32 * cs.PROMPT_LEN, 6, 2048, 2),
                ("whisper_decode", cs.SLOTS, 6, 512, 12)):
            T = padded_tokens(n_tok, segs, cs.BLOCK_T)
            sets = cs.sgmv_inputs(gen, T, d, d, 4, nsets, dev)
            yield shape, sets, lambda mod: (
                lambda x, i, a, b: mod.segmented_lora(x, i, a, b,
                                                      block_t=cs.BLOCK_T))
    else:
        raise SystemExit(f"no A/B cases for kernel {name!r}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--kernels", nargs="+",
                    default=["decode_attention", "segmented_lora"])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    build.build_all(args.kernels)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(17)
    for name in args.kernels:
        parent_mod, swapped = parent_wrapper(args.parent, name)
        new_mod = importlib.import_module(f"repro_torch.kernels.{name}")
        for shape, sets, pick in cases(name, dev, gen):
            new_fn, old_fn = pick(new_mod), swapped(pick(parent_mod))
            got, want = new_fn(*sets[0]), old_fn(*sets[0])
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs().max().item()
            out = {"kernel": name, "shape": shape, "max_abs_diff": diff,
                   "parent_us": [], "change_us": []}
            for who in ("parent", "change", "change", "parent"):
                fn = old_fn if who == "parent" else new_fn
                by_name = cs.device_kernels(rotating(fn, sets))
                out[f"{who}_us"].append(1e3 * sum(by_name.values()))
                out[f"{who}_split_us"] = {k[:48]: 1e3 * v
                                          for k, v in by_name.items()}
            # host time per call: the least of three runs of 200 calls
            # (CUDA events time the enqueue rate once the host is the
            # bottleneck; the least run is the one other work disturbed
            # least), in turns
            for who in ("parent", "change", "change", "parent"):
                fn = old_fn if who == "parent" else new_fn
                out.setdefault(f"{who}_enqueue_us", []).append(min(
                    1e3 * cs.time_ms(rotating(fn, sets), iters=200,
                                     warmup=20) for _ in range(3)))
            print(json.dumps(out), flush=True)
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

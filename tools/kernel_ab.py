#!/usr/bin/env python3
"""Time two versions of the port's CUDA kernels on one GPU, in turns.

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tools/kernel_ab.py --parent build/parent [--kernels NAME ...] \
        [--floor]

For each kernel named (default: ``decode_attention`` and ``segmented_lora``)
this builds the parent tree's source (``<parent>/src/repro_torch/csrc``, its
headers resolved beside it) beside this tree's, loads the parent's wrapper
module from its file with the parent's library swapped in, and times both
on the same input sets at the serving shapes of ``chip_smoke.py`` (parent,
change, the floor build if asked for, then the same in reverse; device
time from ``torch.profiler`` by kernel name, so a call's split into its
kernels shows; then the host time per call of parent and change the same
way), after checking that both agree. ``--floor`` also builds this tree's
int8 decode kernels with ``-DINT8_DECODE_COPY_ONLY`` (the same loads, no
math: the floor of the design at a shape; its output is not the
function's) and times that build in the same turns through this tree's
wrapper. Prints a ptxas summary of every build (spill stores, registers),
one JSON line per shape and the card's name and power limit.
``build/`` is gitignored, so the parent tree and its library stay out of
commits. Needs a CUDA GPU and nvcc.
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


def nvcc_build(src: str, so, flags=()) -> str:
    """Compile one kernel source into ``so`` with the port's flags plus
    ``flags``; returns the ptxas report."""
    from repro_torch.kernels import build
    done = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, *flags, "-o",
                           str(so), src], capture_output=True, text=True)
    if done.returncode != 0:
        raise SystemExit(f"nvcc failed on {src} {' '.join(flags)}:\n"
                         f"{done.stdout}{done.stderr}")
    return done.stdout + done.stderr


def swapper(name: str, lib):
    """A function that calls a wrapper function with library ``lib`` in
    place of this tree's library of kernel ``name``."""
    from repro_torch.kernels import build

    def swapped(fn):
        def call(*a, **kw):
            saved = build._LIBS.get(name)
            build._LIBS[name] = lib
            try:
                return fn(*a, **kw)
            finally:
                build._LIBS[name] = saved
        return call
    return swapped


def spill_lines(label: str, report: str):
    """Print a build's ptxas summary: spill stores summed over its kernels,
    the most registers any of them uses, and the registers of the hd 64,
    G 1 instantiation (the serving shapes')."""
    import re
    spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", report))
    per_fn = re.findall(r"Compiling entry function '(\w+)'.*?Used (\d+) registers",
                        report, flags=re.S)
    regs = max((int(n) for _, n in per_fn), default=0)
    serving = [int(n) for f, n in per_fn if "ILi64ELi1E" in f]
    print(f"ptxas {label}: {spills} bytes of spill stores, at most {regs} "
          f"registers (hd 64, G 1: {serving})", flush=True)


def parent_wrapper(parent: str, name: str):
    """The parent tree's wrapper module of kernel ``name``, its library
    built from the parent's source, and a function that calls a wrapper
    function with that library in place of this tree's."""
    import ctypes

    from repro_torch.kernels import build
    src = os.path.join(parent, "src", "repro_torch", "csrc", build.SOURCES[name])
    so = build.BUILD_DIR / f"{name}-parent.so"
    spill_lines(f"{name} parent", nvcc_build(src, so))
    lib = ctypes.CDLL(str(so))
    spec = importlib.util.spec_from_file_location(
        f"_parent_{name}",
        os.path.join(parent, "src", "repro_torch", "kernels", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, swapper(name, lib)


# the kernels with a copy-only build, and its define
FLOOR_KERNELS = ("decode_attention_int8", "paged_decode_attention")
FLOOR_FLAG = "-DINT8_DECODE_COPY_ONLY"


def floor_wrapper(name: str):
    """This tree's source of kernel ``name`` built copy-only, and a
    function that calls a wrapper function with that library in place."""
    import ctypes

    from repro_torch.kernels import build
    so = build.BUILD_DIR / f"{name}-floor.so"
    spill_lines(f"{name} floor",
                nvcc_build(str(build.CSRC / build.SOURCES[name]), so,
                           [FLOOR_FLAG]))
    return swapper(name, ctypes.CDLL(str(so)))


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
    elif name == "decode_attention_int8":
        # the dense pool of stablelm-1.6b: 8 slots, H = KV = 32, hd 64,
        # S = s_max = 161, ragged lengths in [1, S]; 24 sets (one a layer)
        S = cs.PROMPT_LEN + cs.MAX_NEW + 1
        sets = cs.int8_inputs(gen, cs.SLOTS, 32, 32, S, 64, 24, dev)
        # the wrapper takes the head-major view of the pool's layout
        yield "stablelm", sets, lambda mod: (
            lambda q, kq, vq, ks, vs, ln: mod.decode_attention_int8(
                q, kq.transpose(1, 2), vq.transpose(1, 2), ks, vs, ln))
    elif name == "paged_decode_attention":
        # the paged pools: stablelm-1.6b (H = KV = 32, a table of 11 pages,
        # lengths in [1, s_max = 161]; 24 sets) and whisper-base's decoder
        # self-attention (H = KV = 8, a table of 9 pages, lengths in [1,
        # s_max = 129]; 6 sets); pages of 16, a dense-equivalent arena
        for shape, H, s_max, nsets in (
                ("stablelm", 32, cs.PROMPT_LEN + cs.MAX_NEW + 1, 24),
                ("whisper", 8, cs.W_PROMPT_LEN + cs.W_MAX_NEW + 1, 6)):
            MP = -(-s_max // cs.PAGE_SIZE)
            sets = cs.paged_inputs(gen, cs.SLOTS, H, H, 64, 1 + cs.SLOTS * MP,
                                   nsets, dev, MP=MP)
            for st in sets:
                st[6].clamp_(max=s_max)
            yield shape, sets, lambda mod: mod.paged_decode_attention
    else:
        raise SystemExit(f"no A/B cases for kernel {name!r}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--kernels", nargs="+",
                    default=["decode_attention", "segmented_lora"])
    ap.add_argument("--floor", action="store_true",
                    help="also time the copy-only build of the int8 decode "
                    "kernels")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    build.build_all(args.kernels)
    for name in args.kernels:
        spill_lines(f"{name} change",
                    (build.BUILD_DIR / f"{name}.log").read_text())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(17)
    for name in args.kernels:
        parent_mod, swapped = parent_wrapper(args.parent, name)
        new_mod = importlib.import_module(f"repro_torch.kernels.{name}")
        floor = floor_wrapper(name) \
            if args.floor and name in FLOOR_KERNELS else None
        for shape, sets, pick in cases(name, dev, gen):
            new_fn, old_fn = pick(new_mod), swapped(pick(parent_mod))
            fns = {"parent": old_fn, "change": new_fn}
            if floor is not None:
                fns["floor"] = floor(pick(new_mod))
            got, want = new_fn(*sets[0]), old_fn(*sets[0])
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs().max().item()
            out = {"kernel": name, "shape": shape, "max_abs_diff": diff}
            turns = list(fns) + list(reversed(fns))
            for who in turns:
                by_name = cs.device_kernels(rotating(fns[who], sets))
                out.setdefault(f"{who}_us", []).append(
                    1e3 * sum(by_name.values()))
                out[f"{who}_split_us"] = {k[:48]: 1e3 * v
                                          for k, v in by_name.items()}
            # host time per call: the least of three runs of 200 calls
            # (CUDA events time the enqueue rate once the host is the
            # bottleneck; the least run is the one other work disturbed
            # least), in turns
            for who in ("parent", "change", "change", "parent"):
                out.setdefault(f"{who}_enqueue_us", []).append(min(
                    1e3 * cs.time_ms(rotating(fns[who], sets), iters=200,
                                     warmup=20) for _ in range(3)))
            print(json.dumps(out), flush=True)
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

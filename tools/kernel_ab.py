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
kernels shows; then the host time per call of parent and change the
same way), after checking that both agree (``max_abs_diff``: 0 where
the change keeps the parent's bits). ``decode_attention_int8`` runs at
stablelm's serving shape (its one-CTA body), qwen2-7b's pool, h2o-danube's
window and the long_500k cells' 524288 keys. ``flash_attention_bwd`` (in
``flash_attention.py``) runs at the five ``chip_smoke.FLASH_BWD_CASES``
shapes, ``rmsnorm`` at a decode step's 8 rows of every model width and
at stablelm's verify, prefill and pooled row counts, ``rmsnorm_bwd`` (in
the ``rmsnorm`` library) at ``chip_smoke.RMSNORM_BWD_TIMED`` and at 1024
rows of d 512, 768 and 3584 with dw (``max_abs_diff_each``: dx, then dw,
whose summation order the redesign changed). ``--floor`` also
builds this tree's int8 decode kernels with ``-DINT8_DECODE_COPY_ONLY``
(the same loads, no math: the floor of the design at a shape; its output
is not the function's) and times that build in the same turns through
this tree's wrapper. Prints a
ptxas summary of every build (spill stores, registers), one JSON line per
shape and the card's name and power limit.
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


# kernels whose wrapper lives in another kernel's module, and those whose
# kernels live in another kernel's library
MODULES = {"flash_attention_bwd": "flash_attention", "rmsnorm_bwd": "rmsnorm"}
LIBRARIES = {"rmsnorm_bwd": "rmsnorm"}


def _module_from(path: str, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def parent_wrapper(parent: str, name: str):
    """The parent tree's wrapper module of kernel ``name``, its library
    built from the parent's source, and a function that calls a wrapper
    function with that library in place of this tree's."""
    import ctypes

    from repro_torch.kernels import build
    pkg = os.path.join(parent, "src", "repro_torch")
    lib_name = LIBRARIES.get(name, name)
    src = os.path.join(pkg, "csrc", build.SOURCES[lib_name])
    so = build.BUILD_DIR / f"{name}-parent.so"
    spill_lines(f"{name} parent", nvcc_build(src, so))
    lib = ctypes.CDLL(str(so))
    mod = _module_from(
        os.path.join(pkg, "kernels", f"{MODULES.get(name, name)}.py"),
        f"_parent_{name}")
    return mod, swapper(lib_name, lib)


# the kernels with a copy-only build, and its define
FLOOR_KERNELS = ("decode_attention_int8", "paged_decode_attention",
                 "paged_verify_attention")
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


def short(kernel: str) -> str:
    """A profiler kernel name cut to its function and template arguments
    (no return type, anonymous namespace or parameter list), at most 48
    characters."""
    name = kernel.replace("(anonymous namespace)::", "")
    name = name[len("void "):] if name.startswith("void ") else name
    return (name.split("(")[0] or kernel)[:48]


def rotating(fn, sets):
    it = [0]

    def call():
        fn(*sets[it[0] % len(sets)])
        it[0] += 1
    return call


def cases(name: str, dev, gen):
    """(shape name, input sets, call(new_module)) at the serving shapes."""
    import torch

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
        # S = s_max = 161, ragged lengths in [1, S]; 24 sets (one a layer);
        # then qwen2-7b's pool (H 28, KV 4, hd 128), h2o-danube-1.8b's under
        # its 4096 window (lengths 4097-4200) and the long_500k cells' one
        # row of 524288 positions (h2o's window, jamba's whole cache)
        S = cs.PROMPT_LEN + cs.MAX_NEW + 1
        for shape, B, H, KV, hd, s_len, window, lo, nsets in (
                ("stablelm", cs.SLOTS, 32, 32, 64, S, None, 1, 24),
                ("qwen2", cs.SLOTS, 28, 4, 128, S, None, 1, 24),
                ("h2o_window", cs.SLOTS, 32, 8, 80, 4200, 4096, 4097, 6),
                ("h2o_long_window", 1, 32, 8, 80, 524288, 4096, 524288, 1),
                ("jamba_long", 1, 32, 8, 128, 524288, None, 524288, 1)):
            lens = None if lo == 1 else torch.randint(
                lo, s_len + 1, (B,), generator=torch.Generator()
                .manual_seed(s_len)).tolist()
            sets = cs.int8_inputs(gen, B, H, KV, s_len, hd, nsets, dev,
                                  lens=lens)
            # the wrapper takes the head-major view of the pool's layout
            yield shape, sets, lambda mod, w=window: (
                lambda q, kq, vq, ks, vs, ln: mod.decode_attention_int8(
                    q, kq.transpose(1, 2), vq.transpose(1, 2), ks, vs, ln,
                    window=w))
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
    elif name == "paged_verify_attention":
        # chip_smoke.verify_timing's shape: stablelm's speculative pool
        # (8 streams, T 5, H = KV = 32, hd 64, a table of 13 pages of 16),
        # ragged base lengths; 24 sets (one a layer)
        T, MP = cs.SPEC_K + 1, 13
        rng = torch.Generator().manual_seed(5)
        sets = [cs.verify_inputs(gen, cs.SLOTS, 32, 32, 64, T, MP, torch.randint(
            0, MP * cs.PAGE_SIZE - T, (cs.SLOTS,), generator=rng).tolist(), dev)
            for _ in range(24)]
        yield "serving", sets, lambda mod: mod.paged_verify_attention
    elif name == "rmsnorm":
        # a decode step's rows at every model width, then stablelm's width
        # over a verify forward's, a prefill bucket's and a pooled batch's
        # rows; 8 sets each
        for shape, rows, d in (
                *((f"decode_d{d}", cs.SLOTS, d) for d in cs.RMSNORM_WIDTHS),
                ("verify", cs.SLOTS * (cs.SPEC_K + 1), 2048),
                ("prefill", cs.PROMPT_LEN, 2048),
                ("pooled", 32 * cs.PROMPT_LEN, 2048)):
            sets = [cs.rmsnorm_inputs(gen, rows, d, dev)[::-1]
                    for _ in range(8)]
            yield shape, sets, lambda mod: mod.rmsnorm
    elif name == "rmsnorm_bwd":
        # moment's training rows at its width with dw and without, the LM
        # step's norms (stablelm, 4096 rows at d 2048) with dw, and the
        # other widths at 1024 rows with dw; enough sets to pass the L2
        for shape, rows, d, need_dw in (
                *((lbl, rows, d, dw) for lbl, rows, d, dw in
                  cs.RMSNORM_BWD_TIMED),
                *((f"1024x{d}_dw", 1024, d, True) for d in (512, 768, 3584))):
            nsets = max(2, -(-64 * 2 ** 20 // (4 * rows * d)))
            sets = []
            for _ in range(nsets):
                x, w = cs.rmsnorm_inputs(gen, rows, d, dev)
                sets.append((w, x, torch.randn(
                    (rows, d), generator=gen, device=dev).to(x.dtype)))
            yield shape, sets, lambda mod, dw=need_dw: (
                lambda w, x, dy: mod.rmsnorm_bwd(w, x, dy, need_dw=dw))
    elif name == "flash_attention_bwd":
        # the five FLASH_BWD_CASES: q, k, v, the forward's output and
        # log-sum-exp (this tree's forward), the output's gradient; 2 sets
        from repro_torch.kernels.flash_attention import flash_attention
        for shape, case in cs.FLASH_BWD_CASES.items():
            sets = []
            for _ in range(2):
                (q, k, v, dout), kw = cs.flash_bwd_inputs(gen, dev, case)
                out, lse = flash_attention(q, k, v, with_lse=True, **kw)
                sets.append((q, k, v, out, lse, dout, kw))
            yield shape, sets, lambda mod: (
                lambda q, k, v, out, lse, dout, kw: mod.flash_attention_bwd(
                    q, k, v, out, lse, dout, **kw))
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
    libs = sorted({LIBRARIES.get(n, n) for n in args.kernels})
    build.build_all(libs)
    for name in libs:
        spill_lines(f"{name} change",
                    (build.BUILD_DIR / f"{name}.log").read_text())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(17)
    for name in args.kernels:
        parent_mod, swapped = parent_wrapper(args.parent, name)
        new_mod = importlib.import_module(
            f"repro_torch.kernels.{MODULES.get(name, name)}")
        floor = floor_wrapper(name) \
            if args.floor and name in FLOOR_KERNELS else None
        for shape, sets, pick in cases(name, dev, gen):
            new_fn, old_fn = pick(new_mod), swapped(pick(parent_mod))
            fns = {"parent": old_fn, "change": new_fn}
            if floor is not None:
                fns["floor"] = floor(pick(new_mod))
            got, want = new_fn(*sets[0]), old_fn(*sets[0])
            torch.cuda.synchronize()
            if isinstance(got, torch.Tensor):
                got, want = (got,), (want,)
            each = [(g.float() - w.float()).abs().max().item()
                    for g, w in zip(got, want) if g is not None]
            out = {"kernel": name, "shape": shape,
                   "max_abs_diff": max(each), "max_abs_diff_each": each}
            turns = list(fns) + list(reversed(fns))
            for who in turns:
                by_name = cs.device_kernels(rotating(fns[who], sets))
                out.setdefault(f"{who}_us", []).append(
                    1e3 * sum(by_name.values()))
                out[f"{who}_split_us"] = {short(k): 1e3 * v
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

#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``src/repro_torch/csrc``,
then runs these phases and fails (non-zero exit) if any of them fails:

1. kernels — each kernel against its plain PyTorch version on the card, at
   the shapes the serving paths give it, with the tolerance stated; the
   int8 decode kernels (K3 dense, K4 paged: one kernel body) at every case
   of ``INT8_CASES`` (stablelm's pools with and without a window and with
   GQA, whisper's self-attention, every (hd, G) instantiation, a window
   across a pass, caches of several rounds; lengths 1, 32, 33, page
   multiples and the table's full width; K4 with shared (COW) pages and
   stale codes in unmapped pages), each twice, bit for bit, and K4 against
   K3 on a contiguous table whose page scales are the slot scales; the
   prefill kernel (K2) at
   the pooled, full-admission and tail-admission shapes (``FLASH_CASES``:
   ragged ``kv_len``, a prefix operand with 64 and 0 valid positions), with
   GQA, a window and queries that are a strict suffix of the keys, and at
   whisper's bidirectional encoder (1500 frames, a pooled batch and one
   admission's, the latter split over the key axis) and cross-attention
   prefill (Sq 16 and 64 against 1500 frames) shapes, split over the key
   axis (empty trailing splits, empty splits past a prefix's length, a
   split holding a prefix's end and the new keys, causal splits over
   several query tiles) and at hd 128, its library's SASS holding the
   tensor cores' HMMA; the float flash-decode kernel (K5) at the
   cross-attention decode shape (8 slots, 1500 frames), the float pool's
   (S = s_max, ragged lengths), with GQA and windows, at every (hd, G)
   instantiation, lengths that leave later splits empty and a window
   across a split boundary (``FLOAT_CASES``); the SGMV kernel (K1) at
   stablelm's and whisper's serving shapes, ranks 4 and 64, a narrower
   output, one adapter and sentinel blocks only (``sgmv_cases``); K1 and
   K5 each twice on the same inputs, bit for bit; the ptxas reports of the
   K1, K3, K4, K5, verify-window and rmsnorm libraries free of spill
   stores; rmsnorm (no Pallas counterpart: the jnp ``layers.rmsnorm``) at
   d 512, 1024 and 2048 within one bf16 ulp of each element of its plain
   version, with each row's bits the same alone and among 8, 40 and 4176
   rows;
   moment-large's pooled shapes (K1 at d = out = 1024, ranks 4 and 16; K2
   not causal, 16 heads, 32 patches); the speculative verify window (K4
   over T positions) at every case of ``VERIFY_CASES`` (T 1 to 10, GQA,
   windows, hd 32/64/128, caches of 1520 positions), within two bf16 ulps
   of its plain version, bit-identical twice, one launch a call, and every
   window position bit-identical to K4 at its length; and at the shapes of
   the other attention families: qwen2-7b's G 7 (H 28, KV 4, hd 128) and
   h2o-danube-1.8b's hd 80 (H 32, KV 8) under its 4096-position window in
   every case table (K2 pooled, admission and tail, and h2o's 4160-token
   prefill; K3/K4 and K5 pools; the verify window at T 5), every (hd, G)
   of hd 32, 64, 80, 128 and G 1, 2, 4, 7, 8 for K3, K4, the verify
   window and K5, K1 at the four configs' q and v widths, and rmsnorm at
   d 2560, 3584, 4096 and 8192; and the ptxas reports of every library
   free of spill stores;
2. reference — a two-layer cut of full-width stablelm-1.6b, prefill plus
   teacher-forced decode through the kernels on the card, held against the
   same model run with the plain versions on the CPU, on the int8 pool (K3)
   and on the float pool (K5); then a two-layer cut of full-width
   whisper-base (2 + 2 layers, 1500 frames per row) the same way (K2 for
   the encoder and the cross-attention of the prompt, K5 for every
   cross-attention decode);
3. paged reference — the same two-layer cut through the paged decode
   engine (shared prefix pages, per-page int8 scales) on the card against
   the same engine on the CPU, teacher-forced; then the chunked paged
   engine (three sharers admitted by their tails behind a mapped prefix
   page, K2 with the prefix operand) the same way;
4. serving — full-width stablelm-1.6b (24 layers, random weights from a seed)
   through ``FMplexServer`` / ``ServeLoop.run``: 4 tasks with randomized
   rank-16 q/v LoRA adapters and linear heads, a mixed trace of pooled
   feature requests and generative requests (prompts of 2-128 tokens, 32 new
   tokens each) on the dense int8 pool (8 slots, chunk 4, greedy). Every
   request must finish ok with finite outputs, and each kernel of the path
   must have launched in this run;
5. paged serving — the same model and tasks on the paged int8 pool (8
   slots, pages of 16, 45 pages: about half the dense-equivalent 89, so
   admission defers and decode preempts), with copy-on-write prefix sharing
   and full prefill: pooled requests, long-tail generative streams and
   shared-prefix streams on one adapter. Every request finishes ok with its
   token budget, K4, K2 and K1 launch, at least one prefix hit and one
   deferral or preemption happen, and no page leaks; then the same trace on
   a paged pool with chunked shared-prefix prefill (the engine's default):
   at least one tail admission, K2 launched, no leak, the prefix-hit and
   miss TTFT p50;
   then full-width whisper-base (6 + 6 layers, 1500 frames per stream)
   through the same server on the paged int8 pool: pooled frame requests
   and transcription streams with their own frames (prompts 4-64 tokens,
   32-64 new tokens); every request finishes ok with its budget, K5, K4,
   K2 and K1 launch, and every state slot and page is free at the end;
   then three whisper streams on q/k at the real fan-in served through the
   loop, their logits held position by position against the same streams
   on the CPU engine (teacher-forced);
   then a two-layer cut of full-width moment-large (``backbone_features``
   and ``run_batch`` under each LoRA impl, GPU against CPU, and a planted
   check that the mask is not causal), and full-width moment-large served
   through the port's launcher (``repro_torch.launch.serve``, 4 tasks,
   Poisson load at 40 requests/s, ``lora_impl="auto"``): every request
   served, K2 and (where the table chose "segmented") K1 launched per
   forward, no new shape key; and ``python -m repro_torch.launch.serve``
   with no flags;
6. durability — full-width stablelm-1.6b on the paged pool with a host
   spill arena (``phase_durability``): a burst that preempts, resumed from
   the host, whose tokens must equal the same joins on an unpressured pool,
   and with a 20 MiB arena (at least one re-prefill, every stream its
   budget); 8 sampled streams (temperature 0.7, top-k 8) spilled against
   the unpressured pool, tokens equal; a shared prefix spilled across an
   idle gap and restored for the next wave's tail admissions (K2 with the
   prefix operand); a mid-flight snapshot restored over the old arena,
   scrambled in place, reusing the executables (tokens equal, no key added
   or captured again, reserved memory grown by less than one pool); a
   tampered page (a digest failure, every stream its budget); the disk
   round trip (npz + json, restored without reuse); ``checkpoint_restart``
   and ``DeviceResetFault`` through ``ServeLoop`` (streams equal the
   fault-free run's, ``resets_survived`` stamped, no leak); whisper's
   cross state through a snapshot (a two-layer cut, tokens equal); K4, K2
   and K1 must launch; and one sampled decode step (eager) against the
   greedy graphed step;
7. speculative — self-speculative decoding (spec_k 4) at full width on
   stablelm-1.6b (``phase_speculative``): the verify window teacher-forced
   against five sequential decode steps on copies of one live cache (a
   two-layer cut and the full 24 layers, both gated at relative L2 2e-2
   with greedy agreement), then 8 streams through the speculative engine,
   graphed and speculating on every dispatch, on random weights and on the
   copy-inclined model (every attention out-projection zeroed; prompts
   that re-feed the model's own output): the streams equal to the plain
   engine's, the device length equal to the host's committed length after
   every chunk, accepts on the copy-inclined run, no leak, no key after
   the warm-ups, the graphed run equal to its eager replay, the verify
   kernel launched;
8. timing — device times (``torch.profiler``) of each kernel, its plain
   version and a library yardstick, beside the least time the card could
   take (its bound), K2 also at whisper's encoder and cross-prefill
   shapes (with its number of key splits and, where it splits, its time
   unsplit), K1 and K5 with their split plans and their time by kernel
   (shrink/expand), K1 also beside the port's gather path at the same
   tokens, K4 also at whisper's self-attention decode shape, a profile of
   one dense, one paged and one whisper decode step
   (8 live streams each), of one whisper pooled batch and of one moment
   pooled batch (32 x 32 patches) under each LoRA impl, and the prefill
   device time a prefix hit saves (full admission against its tail); the
   verify kernel against its bound, five unrolled K4 calls, its plain
   version and SDPA on dequantized K/V with the per-position mask; rmsnorm
   at stablelm's width over a decode step's, a verify forward's, a prefill
   bucket's and a pooled batch's rows against its plain version and
   ``F.rms_norm``; and one speculative step (a verify forward of 8 x 5
   rows) against the plain step of the same engine, both profiled eager
   and graphed;
9. families — the other attention-only families (``phase_families``),
   after stablelm's servers are freed: two-layer full-width cuts of
   qwen2-7b and h2o-danube-1.8b on the card against the CPU on the dense
   int8, float and paged pools (h2o with one 4160-token prompt and 32
   decode steps, so its window binds in K2, K3 and K4); qwen2-7b (4 of its
   28 layers; dense and paged), h2o-danube-1.8b (4 of 24; dense and paged,
   full prefill) and minitron-8b (4 of 32; paged) at full width through
   ``FMplexServer``/``ServeLoop`` with stablelm's gates, each server freed
   before the next model is built; qwen2-vl-72b at full width cut to 2 of
   its 80 layers (a pooled batch of vision-patch embeddings, a greedy
   decode from patches with M-RoPE streams against the CPU, and M-RoPE on
   the card against its CPU run); then the device times of K2-K5 and the
   verify window at these shapes beside their bounds and SDPA;
10. stacks — the MoE, Mamba and xLSTM stacks (``phase_stacks``), after the
   families' servers are freed: GPU-against-CPU references of olmoe-1b-7b
   cut to 2 of its 16 layers (int8, float and paged pools), a jamba probe
   at full width (one attention sublayer with its dense MLP and one Mamba
   sublayer with its 16-expert MoE) on the same three pools and
   xlstm-125m cut to 4 of its 12 layers (its dense pool), each with the
   share of tokens whose
   experts differ between the card and the CPU per MoE layer (rows are
   compared up to their first such flip, and the rest counted); olmoe-1b-7b
   (4 of 16 layers; dense and paged), jamba-v0.1-52b cut to 8 of its 32 layers
   (dense, and paged with its demotions, a preemption that re-prefills
   and the state slots drained) and xlstm-125m (4 of 12 layers; dense) served
   at full width through ``FMplexServer``/``ServeLoop`` with stablelm's
   gates, each with a profiled decode step where the stack decodes
   through attention; grok-1-314b cut to 1 of its 64 layers (a pooled
   batch, a greedy decode on the dense int8 pool against the CPU, K3 at
   its group of 6); then the device times of K2-K4 at these shapes beside
   their bounds and SDPA.
11. training — the task API (``phase_training``), after the stacks'
   servers are freed: K2's backward kernel (``flash_attention_bwd``)
   against the plain version's autograd at moment-large's training shape
   (16 x 64 patches, 16 heads of 64, not causal), stablelm-1.6b causal
   over ragged ``kv_len``, qwen2-7b's group of 7 at hd 128, h2o-danube's hd
   80 under a window shorter than S and whisper's bidirectional 1500
   frames (dq, dk, dv within 1e-2 rel L2 and 2e-2 of the largest element,
   bit-identical twice; the forward's output the same bits with its
   log-sum-exp written or not, the log-sum-exp within 1e-3 of
   ``torch.logsumexp``); rmsnorm's backward (``rmsnorm_bwd``) at
   ``RMSNORM_BWD_CASES`` (d 768 to 8192; the LM step's 4096 x 2048; dx
   within two bf16 ulps, dw within 1e-5, bit-identical twice, each row's
   dx the same bits alone and among 8 and all rows, dx the same without
   dw, one launch a call); a
   two-layer cut of full-width moment-large, one ``train`` step's
   gradients on the card against the CPU per leaf group (0.05 rel L2);
   ``Pipeline.train`` at full width (24 layers, 40 steps of 16 x 512 x 3)
   with its loss halved, its adapter moved, its backbone bit-identical
   and every step through K2, rmsnorm and both backward kernels; the
   simulator (fmplex, sp, be) on the card-calibrated and the paper's
   moment-large profile; and the backward kernels' device times beside
   their bounds, their plain versions' autograd and SDPA's (with a
   boolean mask where the case needs one) / ``F.rms_norm``'s backward
   (rmsnorm's with dw and without at moment's 1024 x 1024, with dw at the
   LM step's 4096 x 2048);
12. LM training — the JAX package's ``launch/train.py`` on the card
   (``phase_lm_training``): full-width stablelm-1.6b cut to 2 layers, f32
   masters, ``lm.loss_fn``'s loss and every leaf's gradient on the card
   against the CPU (0.05 rel L2; the norm weights' through
   ``rmsnorm_bwd`` with dw); the full 24 layers (1.644 B f32 masters)
   with q/k at their real fan-in trained by
   ``launch.train.make_train_step`` for 12 steps on one batch of 8 x 512
   tokens (AdamW, lr 3e-4): finite losses that halve, every leaf moved,
   exactly the K2, K2-backward, rmsnorm and rmsnorm-backward launches a
   step implies with remat and no other kernel, the step's ms, the peak
   memory and one profiled step by kernel group; and
   ``examples/train_e2e_torch.py --full-width`` (xlstm-125m, 4 layers,
   30 steps): the injected failure fires, the run restores from its
   checkpoint and finishes with its loss lower;
13. the mesh plane (``phase_mesh``) on a 1-device mesh; and
14. long context and the recurrent scans (``phase_long``): K5 with a key
   offset and log-sum-exp at the long_500k shapes (h2o-danube-1.8b's hd 80
   under its 4096-position window, jamba's hd 128; 524288 positions;
   lengths 524288, 300001 and 1) within two bf16 ulps of its plain
   version, the cache cut into the 16 pieces of the "data" split and
   merged by ``merge_partials`` within two ulps of one call, empty pieces
   o = 0 and lse = -inf, each timed beside SDPA; decode at 524288
   positions (h2o-danube-1.8b at full depth, jamba at JAMBA_LAYERS,
   graphed) with finite logits and the last step within LONG_TOL of the
   same step through the 16 pieces; xlstm-125m trained one step at 2 x
   4096 with its peak memory beside the prediction; one Mamba layer at
   jamba's width with and without its chunks checkpointed; and four
   dry-run cells traced on the host beside the whole run.

The references of 9 and 10 (with qwen2-vl-72b and grok-1-314b), 12's
checkpoint/restart example and 14's xlstm-125m training step check and
time nothing: they run in child processes (``python3 chip_smoke.py
--child <job>``, ``CHILD_JOBS``) beside 13, which checks only, and their
results join the run's. Every log line is headed by the seconds since its
process started.

The serving paths run graphed: every executable of ``PhysicalFM`` and
``DecodeEngine`` is a ``torch.cuda.CUDAGraph`` per shape key from its
second call on (``repro_torch.core.graphs``), and the warm-ups call every
key twice. Each serving phase (dense, paged, chunked, whisper, moment)
records the calls it makes on the engine and the FM and replays them in
order under ``graphs.disabled()`` on a fresh engine of the same
configuration (``replay_eager``): greedy tokens, launches per kernel and
``compile_count`` must be equal, no page or state slot may leak, pooled
features are compared bit for bit; every key called twice must hold a
graph, and no key may be added after warm-up. The timing profiles each
step, prefill and pooled batch both ways (``profile_both``), with the
capture time of each key and the device memory reserved before and after
each warm-up. The references that record every sampler call on the host
(``_engine_run``, ``whisper_teacher_forced``) run eagerly.

The line before last prints the card's name and power limit
(``nvidia-smi``); before it, one JSON line lists the kernels. The last line
is ``{"ok": true, "device": {...}}``. Nothing falls back to the CPU: without
a CUDA device the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (data sheet)
BF16_FLOPS_PER_S = 989e12       # H100 SXM dense bf16 tensor rate (data sheet)
ARCH = "stablelm-1.6b"
WHISPER = "whisper-base"
MOMENT = "moment-large"
MOMENT_LEN = 32                 # patches a request (the launcher's input_len)
ENC_LEN = 1500                  # whisper's n_audio_ctx (arXiv:2212.04356)
SLOTS, CHUNK, PROMPT_LEN, MAX_NEW, RANK, BLOCK_T = 8, 4, 128, 32, 16, 16
N_TASKS = 4
PAGE_SIZE, TOTAL_PAGES = 16, 45
PAGED_KW = dict(paged=True, page_size=PAGE_SIZE, total_pages=TOTAL_PAGES,
                prefix_sharing=True, chunked_prefill=False)


T_START = time.perf_counter()


def log(*a):
    """One line of the run's log, headed by the seconds since the start."""
    print(f"[{time.perf_counter() - T_START:7.1f} s]", *a, flush=True)


def fail(msg: str) -> int:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean ms per call between CUDA events around ``iters`` calls: device
    time when the device is the bottleneck, the host's enqueue time when the
    host is (small kernels behind a Python wrapper)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def timed_records(events, cuda) -> tuple[dict, int]:
    """Device records of a profiling session (``kineto_results.events()``)
    launched after its first ``torch.cuda.synchronize`` (a runtime
    ``cudaDeviceSynchronize``, which the port's code never calls), by name:
    (summed ns, count); and the ns from the first such record's start to
    the last one's end. Correlation ids grow with every runtime call, so a
    record belongs to the timed calls when its id is above the
    synchronize's."""
    syncs = [e.correlation_id() for e in events
             if e.device_type() != cuda and e.name() == "cudaDeviceSynchronize"]
    if not syncs:
        return {}, 0
    first = min(syncs)
    out: dict = {}
    lo, hi = None, None
    for e in events:
        if e.device_type() == cuda and e.correlation_id() > first:
            ns, n = out.get(e.name(), (0, 0))
            out[e.name()] = (ns + e.duration_ns(), n + 1)
            end = e.start_ns() + e.duration_ns()
            lo = e.start_ns() if lo is None else min(lo, e.start_ns())
            hi = end if hi is None else max(hi, end)
    return out, (hi - lo if out else 0)


def device_kernels(fn, iters: int = 20, warmup: int = 3,
                   tries: int = 20) -> dict:
    """Mean DEVICE ms per call of each kernel (and copy) the call runs on
    the card, by name, from ``torch.profiler``, so host gaps between
    launches do not count: the summed durations of its records over the
    calls. The profiler can keep no record of a session's first launches
    (seen on the H100 once several kernel libraries are loaded: up to two
    launches a session whose runtime calls are recorded and whose kernels
    are not), so each session starts with ``warmup`` calls and a
    synchronize and counts only what was launched after it
    (``timed_records``). A session is run again, up to ``tries`` sessions
    (then this raises; CUDA events would time the host's enqueue rate
    instead), when it recorded no device time; when a kernel's record
    count is not a multiple of the calls (every call launches the same
    kernels: records were dropped); or when its records do not span
    0.7-1.02 of the host's time for the calls (the calls are host-bound,
    so their records span nearly all of it: a session whose durations all
    read about half was seen on the H100)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(max(1, warmup)):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter_ns()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter_ns() - t0
        recs, span = timed_records(
            list(prof.profiler.kineto_results.events()),
            torch.autograd.DeviceType.CUDA)
        short = sorted(f"{n[:48]}: {c}" for n, (_, c) in recs.items()
                       if c % iters)
        if not recs or short:
            log(f"device_kernels: records of {iters} calls "
                f"{short or 'without device time'}; again")
        elif not 0.7 * wall <= span <= 1.02 * wall:
            log(f"device_kernels: records span {span / wall:.3f} of the "
                f"calls' host time; again")
        else:
            return {n: ns / 1e6 / iters for n, (ns, _) in recs.items()}
    raise RuntimeError(f"the profiler recorded no complete session of "
                       f"{iters} calls in {tries}")


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean DEVICE ms per call: the summed durations of every kernel (and
    copy) the call runs on the card (``device_kernels``)."""
    return sum(device_kernels(fn, iters, warmup).values())


def kernel_split(by_name: dict, parts: dict) -> dict:
    """Device ms per call of each named part of a kernel's call: the sum
    over the kernels whose name holds the part's key (``parts``: key ->
    label)."""
    return {label: sum(ms for n, ms in by_name.items() if key in n)
            for key, label in parts.items()}


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def sass_hmma(name: str) -> dict:
    """How many tensor-core instructions (mma.sync's HMMA, wgmma's HGMMA)
    the built library of kernel ``name`` holds, by kind, from ``cuobjdump
    -sass`` (raises if the tool fails)."""
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    kinds: dict = {}
    for line in sass.splitlines():
        for word in line.replace(";", " ").split():
            if word.startswith(("HMMA", "HGMMA")):
                kinds[word] = kinds.get(word, 0) + 1
    return kinds


def spill_stores(name: str) -> int:
    """Bytes of spill stores the ptxas report of kernel ``name``'s library
    (``build/kernels/<name>.log``) gives, summed over its kernels."""
    import re

    from repro_torch.kernels import build
    log_text = (build.BUILD_DIR / f"{name}.log").read_text()
    return sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", log_text))


def ptxas_kernels(name: str, text: str | None = None) -> list:
    """(kernel, registers, spill store bytes) of every kernel in the ptxas
    report of kernel ``name``'s library (or in the report ``text``), the
    kernel named by its mangled name's function and template arguments
    (e.g. ``paged_verify_kernel<64,1,0>``)."""
    import re

    from repro_torch.kernels import build
    if text is None:
        text = (build.BUILD_DIR / f"{name}.log").read_text()
    out = []
    for mangled, body in re.findall(
            r"Compiling entry function '(\w+)'(.*?)(?=Compiling entry|\Z)",
            text, flags=re.S):
        names, i = [], 3 if mangled.startswith("_ZN") else 2
        while i < len(mangled) and (mangled[i].isdigit() or (
                mangled[i] == "L" and mangled[i + 1:i + 2].isdigit())):
            i += mangled[i] == "L"               # a static function's name
            n = re.match(r"\d+", mangled[i:]).group()
            names.append(mangled[i + len(n):i + len(n) + int(n)])
            i += len(n) + int(n)
        args = re.findall(r"L[ib](\d+)E", mangled) \
            if mangled[i:i + 1] == "I" else []
        label = (names[-1] if names else mangled) + (
            f"<{','.join(args)}>" if args else "")
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores", body)
        out.append((label, int(regs.group(1)) if regs else None,
                    int(spill.group(1)) if spill else 0))
    return out


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=30,
        check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------- phase 1: kernels vs their plain versions ----------------

def sgmv_inputs(gen, T, d, out, na, nsets, dev, r=RANK, sentinel_only=False):
    """``nsets`` input sets (one per layer, so timing finds them cold):
    bf16 x, f32 A (na, d, r) and B (na, r, out), and per block an adapter id
    or a sentinel (``na`` or 10**6: no adapter; every block with
    ``sentinel_only``)."""
    import torch
    nb = T // BLOCK_T
    sets = []
    for _ in range(nsets):
        x = torch.randn((T, d), generator=gen, device=dev).to(torch.bfloat16)
        a = torch.randn((na, d, r), generator=gen, device=dev) * 0.05
        b = torch.randn((na, r, out), generator=gen, device=dev) * 0.05
        ids = torch.randint(0, na + 2, (nb,), generator=gen, device=dev)
        ids = torch.where(ids > na, torch.full_like(ids, 10**6), ids)
        if sentinel_only:
            ids.fill_(na)
        sets.append((x, ids.to(torch.int32), a, b))
    return sets


def sgmv_bound(x, ids, a, b):
    """Bytes and flops the function needs on this data: x rows of live
    blocks only (a sentinel block reads nothing and writes zeros), every
    output row, the block ids, and A/B of each adapter in use."""
    T, d = x.shape
    na, _, r = a.shape
    out = b.shape[-1]
    live = ids[ids < na]
    used = int(torch_unique_count(live))
    nbytes = 2 * BLOCK_T * d * live.numel() + 2 * T * out + 4 * ids.numel() + \
        4 * used * (d * r + r * out)
    flops = 2.0 * live.numel() * BLOCK_T * r * (d + out)
    return bound_ms(nbytes, flops)


def sgmv_cases(cfg) -> dict:
    """K1 shapes: stablelm-1.6b's q/v projections (d = out = 2048, rank 16,
    4 adapters) at decode (8 tokens: 6 blocks of 16), admission prefill (128
    tokens) and a pooled batch (32 x 128 tokens); whisper-base's at decode
    (d = out = 512); moment-large's pooled batch (32 x 32 patches, d = out
    = 1024) at ranks 4 and 16; at decode ranks 4 and 64, a narrower
    output (96), one adapter, and a batch of sentinel blocks only; and the
    q and v projections of the other attention families at decode."""
    from repro_torch.kernels.segmented_lora import padded_tokens
    d = cfg.d_model
    dec = padded_tokens(SLOTS, min(SLOTS, 4 + 2), BLOCK_T)
    return {
        "decode": dict(T=dec, d=d, out=d),
        "prefill": dict(T=padded_tokens(PROMPT_LEN, min(PROMPT_LEN, 6),
                                        BLOCK_T), d=d, out=d),
        "pooled": dict(T=padded_tokens(32 * PROMPT_LEN, 6, BLOCK_T), d=d,
                       out=d),
        "whisper_decode": dict(T=dec, d=512, out=512),
        "rank4": dict(T=dec, d=d, out=d, r=4),
        "rank64": dict(T=dec, d=d, out=d, r=64),
        "out96": dict(T=dec, d=d, out=96),
        "one_adapter": dict(T=dec, d=d, out=d, na=1),
        "all_sentinel": dict(T=dec, d=d, out=d, sentinel_only=True),
        # moment-large's pooled batch: 32 requests x 32 patches, d = out =
        # 1024, the launcher's rank 4 and rank 16
        **{f"moment_r{r}": dict(T=padded_tokens(32 * MOMENT_LEN, 6, BLOCK_T),
                                d=1024, out=1024, r=r) for r in (4, 16)},
        # the q and v projections of qwen2-7b, h2o-danube-1.8b, minitron-8b
        # and qwen2-vl-72b at decode (v: KV * hd wide)
        **{f"{name}_{p}": dict(T=dec, d=dm, out=o)
           for name, dm, outs in (("qwen2", 3584, (3584, 512)),
                                  ("h2o", 2560, (2560, 640)),
                                  ("minitron", 4096, (4096, 1024)),
                                  ("qwen2_vl", 8192, (8192, 1024)))
           for p, o in zip("qv", outs)},
    }


def sgmv_plan(x) -> str:
    """K1's d-split plan at these shapes ("plain" on the CPU)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.segmented_lora import d_splits
    if not x.is_cuda:
        return "plain"
    n, split_len = d_splits(x.shape[0] // BLOCK_T, x.shape[1],
                            build.sm_count(x.device.index or 0))
    return f"{n} d-split(s) of {split_len}"


def torch_unique_count(t):
    import torch
    return torch.unique(t).numel() if t.numel() else 0


def int8_inputs(gen, B, H, KV, S, hd, nsets, dev, lens=None):
    """``nsets`` K3 input sets: q (B, H, hd) bf16 and an int8 cache (B, S,
    KV, hd) in the pool's layout with per-(b, h) scales (``quantize_kv`` of
    random floats); lengths random in [1, S] unless given (a length past S
    reads S positions)."""
    import torch

    from repro_torch.kernels.decode_attention_int8 import quantize_kv
    sets = []
    for _ in range(nsets):
        q = torch.randn((B, H, hd), generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn((B, KV, S, hd), generator=gen, device=dev)
        v = torch.randn((B, KV, S, hd), generator=gen, device=dev)
        kq, vq, ks, vs = quantize_kv(k, v)
        # the pool's layout: (B, S, KV, hd); the kernel reads the transposed view
        kq = kq.transpose(1, 2).contiguous()
        vq = vq.transpose(1, 2).contiguous()
        ln = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                           dtype=torch.int32) if lens is None else \
            torch.tensor(lens, dtype=torch.int32, device=dev)
        sets.append((q, kq, vq, ks, vs, ln))
    return sets


def int8_bound(q, kq, lens, window=None):
    B, H, hd = q.shape
    S, KV = kq.shape[1], kq.shape[2]
    n = lens.clamp(max=S)
    if window is not None:
        n = n - (lens - window).clamp(min=0)
    n = int(n.sum())
    nbytes = 2 * 2 * B * H * hd + 2 * n * KV * hd + 2 * 4 * B * KV + 4 * B
    flops = 4.0 * n * H * hd
    return bound_ms(nbytes, flops)


def float_inputs(gen, B, H, KV, S, hd, nsets, dev, lens=None):
    """``nsets`` K5 input sets: q (B, H, hd) and a bf16 cache (B, S, KV, hd)
    in the model layout, each cut from a pool-shaped (2, B, S, KV, hd)
    block as the engine's views are; lengths random in [1, S] unless
    given."""
    import torch
    sets = []
    for _ in range(nsets):
        q = torch.randn((B, H, hd), generator=gen, device=dev).to(torch.bfloat16)
        kv = torch.randn((2, B, S, KV, hd), generator=gen, device=dev).to(
            torch.bfloat16)
        ln = torch.randint(1, S + 1, (B,), generator=gen, device=dev,
                           dtype=torch.int32) if lens is None else \
            torch.tensor(lens, dtype=torch.int32, device=dev)
        sets.append((q, kv[0], kv[1], ln))
    return sets


def float_bound(q, k, lens, window=None):
    """Bytes and flops K5 needs on this data: bf16 K and V of the positions
    inside each length (and window), q read and the output written once,
    the lengths; 4 * hd flops per (query head, valid position)."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    n = lens.clamp(max=S)
    if window is not None:
        n = n - (lens - window).clamp(min=0)
    n = int(n.sum())
    nbytes = 2 * 2 * B * H * hd + 2 * 2 * n * KV * hd + 4 * B
    flops = 4.0 * n * H * hd
    return bound_ms(nbytes, flops)


# K5 shapes: the cross-attention decode of full-width whisper-base (8 slots,
# H = KV = 8, 1500 frames, every row at full length), the float dense pool
# of full-width stablelm-1.6b (H = KV = 32, S = s_max = 161, ragged lengths
# from 1 to S), with GQA and with a window; at the cross length every other
# (hd, G) instantiation of the kernel (hd 32, 64, 80, 128; G 1, 2, 4, 7, 8),
# lengths that end inside the first split (the later splits of those rows
# empty) and a window whose start crosses a split boundary (split at 384 on
# 132 SMs); a grid of 8 splits; and the float pools of qwen2-7b (H 28, KV
# 4, hd 128) and h2o-danube-1.8b (H 32, KV 8, hd 80) under its 4096-position
# window over 4160 prompt positions and more
FLOAT_CASES = {
    "cross": dict(H=8, KV=8, S=ENC_LEN, lens=[ENC_LEN] * SLOTS),
    "float_pool": dict(H=32, KV=32, S=PROMPT_LEN + MAX_NEW + 1,
                       lens=[1, 161, 77, 16, 100, 33, 128, 2]),
    "gqa": dict(H=32, KV=8, S=PROMPT_LEN + MAX_NEW + 1,
                lens=[161, 1, 64, 90, 17, 160, 5, 128]),
    "window": dict(H=32, KV=32, S=PROMPT_LEN + MAX_NEW + 1, window=48,
                   lens=[161, 1, 48, 49, 120, 7, 96, 150]),
    "cross_gqa_window": dict(H=8, KV=2, S=ENC_LEN, window=700,
                             lens=[ENC_LEN, 1, 699, 701, 1499, 32, 900, 64]),
    **{f"cross_hd{hd}_g{g}": dict(H=8 * g, KV=8, S=ENC_LEN, hd=hd,
                                  lens=[ENC_LEN, 1, 383, 385, 1100, 32, 767,
                                        1499])
       for hd, gs in ((32, (1, 2, 4, 7, 8)), (64, (2, 7, 8)),
                      (80, (1, 2, 4, 7, 8)), (128, (1, 2, 4, 7, 8)))
       for g in gs},
    "cross_short": dict(H=8, KV=8, S=ENC_LEN,
                        lens=[100, 1, 383, 384, 385, ENC_LEN, 50, 7]),
    "cross_window_crossing": dict(H=8, KV=8, S=ENC_LEN, window=300,
                                  lens=[1000, ENC_LEN, 790, 770, 1153, 400,
                                        384, 1200]),
    # 32 pairs over 2048 positions: the most splits a cluster holds (8)
    "eight_splits": dict(H=8, KV=4, S=2048,
                         lens=[2048, 1, 255, 257, 1800, 2047, 1024, 600]),
    "qwen2_pool": dict(H=28, KV=4, hd=128, S=PROMPT_LEN + MAX_NEW + 1,
                       lens=[1, 161, 77, 16, 100, 33, 128, 2]),
    "h2o_pool_window": dict(H=32, KV=8, hd=80, S=4200, window=4096,
                            lens=[4200, 1, 4096, 4097, 4160, 4191, 2000,
                                  4199]),
}


def float_splits(q, k) -> str:
    """K5's split plan at these shapes ("plain" on the CPU)."""
    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import splits
    if not q.is_cuda:
        return "plain"
    n, split_len = splits(q.shape[0] * k.shape[2], k.shape[1],
                          build.sm_count(q.device.index or 0))
    return f"{n} split(s) of {split_len}"


def check_float_decode(dev, gen):
    """K5 against its plain version at every case of ``FLOAT_CASES``, two
    bf16 ulps of the largest output (no row is empty: every length >= 1),
    and bit-identical over two calls on the same inputs."""
    import torch

    from repro_torch.kernels import ops, ref
    errs, ok = {}, True
    for name, case in FLOAT_CASES.items():
        hd = case.get("hd", full_config().head_dim)
        q, k, v, ln = float_inputs(gen, SLOTS, case["H"], case["KV"],
                                   case["S"], hd, 1, dev,
                                   lens=case["lens"])[0]
        window = case.get("window")
        got = ops.decode_attention(q, k, v, ln, window=window)
        again = ops.decode_attention(q, k, v, ln, window=window)
        want = ref.decode_attention_ref(q, k.transpose(1, 2),
                                        v.transpose(1, 2), ln, window=window,
                                        p_dtype=v.dtype)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = 2 * 2.0 ** -8 * want.float().abs().max().item() + 1e-6
        same = torch.equal(got, again)
        log(f"kernel decode_attention [{name}] B={SLOTS} H={case['H']} "
            f"KV={case['KV']} S={case['S']} hd={hd} window={window}, "
            f"{float_splits(q, k)}: max_abs_err={err:.3e} (bound "
            f"{tol:.3e}), bit-identical twice: {same}")
        ok &= err <= tol and bool(torch.isfinite(got.float()).all()) and same
        errs[name] = err
    return ok, errs


def paged_inputs(gen, B, H, KV, hd, P, nsets, dev, lens=None, MP=None):
    """``nsets`` paged input sets: a random int8 arena (every page holds
    codes, so unmapped and recycled pages are stale, not zero), per-page
    scales, and a table of MP (default: stablelm's pool, 11) distinct random
    pages per stream with entries past a stream's last page 0 and streams 2
    and 3 mapping the same first two pages (COW). Lengths random in [1, MP *
    ps] unless given."""
    import torch
    MP = MP or -(-(PROMPT_LEN + MAX_NEW + 1) // PAGE_SIZE)
    sets = []
    for _ in range(nsets):
        q = torch.randn((B, H, hd), generator=gen, device=dev).to(torch.bfloat16)
        kp = torch.randint(-127, 128, (P, PAGE_SIZE, KV, hd), generator=gen,
                           device=dev, dtype=torch.int8)
        vp = torch.randint(-127, 128, (P, PAGE_SIZE, KV, hd), generator=gen,
                           device=dev, dtype=torch.int8)
        ks = torch.rand((P, KV), generator=gen, device=dev) * 0.05 + 1e-3
        vs = torch.rand((P, KV), generator=gen, device=dev) * 0.05 + 1e-3
        ln = torch.randint(1, MP * PAGE_SIZE + 1, (B,), generator=gen,
                           device=dev, dtype=torch.int32) \
            if lens is None else torch.tensor(lens, dtype=torch.int32,
                                              device=dev)
        npg = [min(MP, -(-int(n) // PAGE_SIZE)) for n in ln.tolist()]
        perm = (torch.randperm(P - 1, generator=gen, device=dev) + 1).tolist()
        pt = torch.zeros((B, MP), dtype=torch.int32)
        for b in range(B):
            pt[b, :npg[b]] = torch.tensor(perm[:npg[b]], dtype=torch.int32)
            perm = perm[npg[b]:]
        if min(npg[2], npg[3]) >= 2:
            pt[3, :2] = pt[2, :2]
        sets.append((q, kp, vp, ks, vs, pt.to(dev), ln))
    return sets


def paged_bound(q, kp, pt, lens, window=None):
    """Bytes and flops on this data: K and V int8 of every page a stream
    visits (``ceil(len / ps) * ps`` positions per (stream, kv head), less
    the pages wholly before a window), one k and one v scale per visited
    (page, kv head), the table, q, the output and the lengths."""
    B, H, hd = q.shape
    _, ps, KV, _ = kp.shape
    MP = pt.shape[1]
    pages = 0
    n = 0
    for ln in lens.tolist():
        hi = min(ln, MP * ps)
        lo = max(0, ln - window) if window else 0
        pages += -(-hi // ps) - lo // ps
        n += hi - min(lo, hi)
    nbytes = 2 * pages * ps * KV * hd + 2 * 4 * pages * KV + 4 * B * MP + \
        2 * 2 * B * H * hd + 4 * B
    flops = 4.0 * n * H * hd
    return bound_ms(nbytes, flops)


# K3/K4 shapes (8 rows each; hd 64 unless given): the dense and paged pools
# of full-width stablelm-1.6b (H = KV = 32, s_max = 161, a table of 11 pages
# of 16) with and without a window and with GQA, and whisper-base's decoder
# self-attention (H = KV = 8, s_max = 129, a table of 9 pages); every (hd,
# G) instantiation; a window whose start crosses a pass of the CTA (64
# positions at hd 64) inside a lane group's run; and caches longer than the
# kernel's register ring holds (hd 64: 256 positions), where it turns over.
# Lengths 1, 32 and 33 (a warp-pass edge at hd 64 G 1), page multiples and
# the table's full width (MP * ps; the dense kernel reads min(len, S)). S is
# the dense cache's length; the paged table holds ceil(S / ps) pages. Also
# qwen2-7b's heads (H 28, KV 4, hd 128: G 7) with a window, and
# h2o-danube-1.8b's (H 32, KV 8, hd 80: lane groups with idle lanes) with
# its own 4096-position window over a 4200-position cache (4160 prompt
# tokens plus decode). The one K3/K4 case table: the cuda-marked tests and
# the CPU builds of the kernel bodies (tests/_int8_host.py) import it.
INT8_CASES = {
    "serving": dict(H=32, KV=32, S=161, lens=[1, 32, 33, 80, 176, 161, 100, 7]),
    "serving_window": dict(H=32, KV=32, S=161, window=48,
                           lens=[161, 1, 48, 49, 120, 7, 96, 176]),
    "gqa": dict(H=32, KV=8, S=161, lens=[161, 1, 64, 90, 17, 160, 5, 176]),
    "gqa_window": dict(H=32, KV=8, S=161, window=48,
                       lens=[176, 1, 48, 49, 120, 7, 96, 150]),
    "whisper": dict(H=8, KV=8, S=129, lens=[1, 32, 33, 48, 144, 129, 100, 64]),
    "window_crossing": dict(H=8, KV=8, S=161, window=70,
                            lens=[176, 100, 71, 70, 69, 130, 65, 150]),
    **{f"hd{hd}_g{g}": dict(H=8 * g, KV=8, hd=hd, S=161,
                            lens=[1, 32, 33, 64, 176, 161, 65, 128])
       for hd in (32, 64, 80, 128) for g in (1, 2, 4, 6, 7, 8)},
    "qwen2_window": dict(H=28, KV=4, hd=128, S=161, window=48,
                         lens=[161, 1, 48, 49, 120, 7, 96, 176]),
    "h2o_window": dict(H=32, KV=8, hd=80, S=4200, window=4096,
                       lens=[4200, 1, 4096, 4097, 4160, 4192, 2000, 4216]),
    "long": dict(H=8, KV=4, S=1500,
                 lens=[1500, 1, 257, 700, 1499, 512, 1024, 1504]),
    "long_window": dict(H=16, KV=8, S=1500, window=300, hd=128,
                        lens=[1500, 1, 299, 301, 1000, 640, 1024, 1280]),
}


# The verify window (K4 over T positions, paged_verify_attention; 8 rows
# each, pages of 16, hd 64 unless given). ``base``: row b's window position
# j attends base[b] + j + 1 positions. Stablelm's speculative pool at
# spec_k 4 (T 5; a table of 13 pages: s_max 161 plus a chunk of 4 windows
# of 5 positions of speculative room) with and without a window; T 1 (K4's
# function), 2, 4 and 10; GQA (G 2, 4 and 8); hd 32, 64 and 128; base
# lengths 0 (the first decoded token), windows that cross a page inside the
# window (base 15 and 31 straddle pages 1 and 2), tables filled to their
# last position, and caches longer than the kernel's register ring
# (several rounds of passes, hd 128 over 1520 positions among them); qwen2-7b's
# heads (G 7, hd 128) and h2o-danube-1.8b's (G 4, hd 80) at T 5, the latter
# under its 4096-position window over 4160 prompt positions and more. The
# one verify case table: the cuda-marked tests and the CPU build of the
# kernel body (tests/_int8_host.py) import it.
VERIFY_CASES = {
    "serving": dict(H=32, KV=32, T=5, MP=13,
                    base=[0, 15, 31, 100, 155, 60, 7, 203]),
    "serving_window": dict(H=32, KV=32, T=5, MP=13, window=48,
                           base=[160, 1, 47, 44, 120, 7, 96, 180]),
    "t1": dict(H=32, KV=32, T=1, MP=11, base=[0, 31, 32, 79, 175, 160, 99, 6]),
    "t2": dict(H=32, KV=32, T=2, MP=11, base=[0, 14, 15, 16, 100, 174, 63, 64]),
    "t4": dict(H=32, KV=32, T=4, MP=12, window=33,
               base=[0, 13, 29, 30, 100, 188, 63, 64]),
    "gqa_t2": dict(H=32, KV=8, T=2, MP=13, base=[160, 0, 63, 90, 17, 150, 5, 206]),
    "g2_t4": dict(H=16, KV=8, T=4, MP=13, base=[0, 15, 31, 130, 12, 150, 77, 204]),
    "g2_t5_split": dict(H=16, KV=8, T=5, MP=13, window=40,
                        base=[0, 15, 31, 130, 12, 150, 77, 203]),
    "t10_split": dict(H=8, KV=8, T=10, MP=13, window=20,
                      base=[0, 10, 31, 130, 12, 150, 77, 198]),
    "hd64_t3": dict(H=8, KV=8, T=3, MP=13, base=[0, 14, 31, 130, 12, 150, 77, 205]),
    "hd32_t7": dict(H=8, KV=8, hd=32, T=7, MP=13,
                    base=[0, 10, 31, 130, 12, 150, 77, 201]),
    "hd128_t3": dict(H=16, KV=8, hd=128, T=3, MP=13,
                     base=[0, 14, 31, 130, 12, 150, 77, 205]),
    "long": dict(H=8, KV=4, T=5, MP=95,
                 base=[1490, 0, 256, 700, 1400, 511, 1020, 1515]),
    "long_window": dict(H=16, KV=8, hd=128, T=3, MP=95, window=300,
                        base=[1490, 0, 299, 301, 1000, 640, 1024, 1280]),
    "long_unstaged": dict(H=8, KV=8, hd=128, T=3, MP=95,
                          base=[1490, 0, 299, 301, 1000, 640, 1024, 1517]),
    "g8_t4": dict(H=32, KV=4, T=4, MP=13, window=40,
                  base=[0, 15, 31, 130, 12, 150, 77, 204]),
    "qwen2_t5": dict(H=28, KV=4, hd=128, T=5, MP=13,
                     base=[0, 15, 31, 130, 12, 150, 77, 203]),
    "h2o_t5_window": dict(H=32, KV=8, hd=80, T=5, MP=264, window=4096,
                          base=[4160, 0, 4091, 15, 31, 130, 77, 4219]),
    "grok_t5": dict(H=48, KV=8, hd=128, T=5, MP=13,
                    base=[0, 15, 31, 130, 12, 150, 77, 203]),
}


def verify_inputs(gen, B, H, KV, hd, T, MP, base, dev):
    """One verify input set: q (B, T, H, hd) bf16, a random int8 arena of
    1 + B * MP pages of 16 (every page holds codes: unmapped and recycled
    pages are stale), per-page scales, a table of distinct random pages
    covering each stream's base + T positions (entries past them 0, streams
    2 and 3 mapping the same first two pages), and the base lengths."""
    import torch
    P = 1 + B * MP
    q = torch.randn((B, T, H, hd), generator=gen, device=dev).to(torch.bfloat16)
    kp = torch.randint(-127, 128, (P, PAGE_SIZE, KV, hd), generator=gen,
                       device=dev, dtype=torch.int8)
    vp = torch.randint(-127, 128, (P, PAGE_SIZE, KV, hd), generator=gen,
                       device=dev, dtype=torch.int8)
    ks = torch.rand((P, KV), generator=gen, device=dev) * 0.05 + 1e-3
    vs = torch.rand((P, KV), generator=gen, device=dev) * 0.05 + 1e-3
    npg = [min(MP, -(-(int(n) + T) // PAGE_SIZE)) for n in base]
    perm = (torch.randperm(P - 1, generator=gen, device=dev) + 1).tolist()
    pt = torch.zeros((B, MP), dtype=torch.int32)
    for b in range(B):
        pt[b, :npg[b]] = torch.tensor(perm[:npg[b]], dtype=torch.int32)
        perm = perm[npg[b]:]
    if min(npg[2], npg[3]) >= 2:
        pt[3, :2] = pt[2, :2]
    return (q, kp, vp, ks, vs, pt.to(dev),
            torch.tensor(base, dtype=torch.int32, device=dev))


def verify_bound(q, kp, pt, base, window=None):
    """Bytes and flops of the verify window on this data: K and V int8 of
    every page the window's positions visit, walked once (``ceil(hi / ps)``
    pages of a stream, less those wholly before the first position's
    window), one k and one v scale per visited (page, kv head), the table,
    q, the output and the lengths; flops of every (row, position) pair a
    query row attends."""
    B, T, H, hd = q.shape
    _, ps, KV, _ = kp.shape
    MP = pt.shape[1]
    pages, pairs = 0, 0
    for b in base.tolist():
        hi = min(b + T, MP * ps)
        lo = max(0, b + 1 - window) if window else 0
        pages += -(-hi // ps) - lo // ps
        for j in range(T):
            hj = min(b + j + 1, MP * ps)
            pairs += hj - (max(0, hj - window) if window else 0)
    nbytes = 2 * pages * ps * KV * hd + 2 * 4 * pages * KV + 4 * B * MP + \
        2 * 2 * B * T * H * hd + 4 * B
    return bound_ms(nbytes, 4.0 * pairs * H * hd)


def check_verify(dev, gen):
    """The verify window against its plain version (T single-token reads)
    at every case of ``VERIFY_CASES``, through each body K4's plan can pick
    (``k4_sides``: the plan's, then the others, forced): two bf16 ulps of
    the largest output, bit-identical over two calls, one launch a call,
    and every window position bit-identical to K4
    (``paged_decode_attention``, under the same plan) at its length: the
    speculative engine's attention is the plain engine's."""
    import torch

    from repro_torch.kernels import ops, ref
    errs, ok = {}, True
    for name, c in VERIFY_CASES.items():
        H, KV, T, MP = c["H"], c["KV"], c["T"], c["MP"]
        hd, window = c.get("hd", 64), c.get("window")
        q, kp, vp, ks, vs, pt, base = verify_inputs(
            gen, SLOTS, H, KV, hd, T, MP, c["base"], dev)
        want = ref.paged_verify_attention_ref(
            q, kp.transpose(1, 2), vp.transpose(1, 2), ks, vs, pt, base,
            window=window)
        S = MP * PAGE_SIZE
        for side in k4_sides(SLOTS, KV, H // KV, hd, S, window, dev):
            with k4_forced(side):
                body = k4_plan(SLOTS, KV, H // KV, hd, S, window, dev, T=T)
                before = ops.LAUNCHES["paged_verify_attention"]
                got = ops.paged_verify_attention(q, kp, vp, ks, vs, pt, base,
                                                 window=window)
                launched = ops.LAUNCHES["paged_verify_attention"] - before
                again = ops.paged_verify_attention(q, kp, vp, ks, vs, pt,
                                                   base, window=window)
                k4 = torch.stack([ops.paged_decode_attention(
                    q[:, j].contiguous(), kp, vp, ks, vs, pt,
                    (base + j + 1).to(torch.int32), window=window)
                    for j in range(T)], dim=1)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = 2 * 2.0 ** -8 * want.float().abs().max().item() + 1e-6
            same = torch.equal(got, again)
            as_k4 = torch.equal(got, k4)
            log(f"kernel paged_verify_attention [{name}] B={SLOTS} T={T} "
                f"H={H} KV={KV} hd={hd} ps={PAGE_SIZE} MP={MP} "
                f"window={window} body={body}"
                f"{' (plan)' if side is None else ''}: max_abs_err="
                f"{err:.3e} (bound {tol:.3e}), bit-identical twice: {same}, "
                f"each position bit-identical to K4: {as_k4}")
            ok &= err <= tol and bool(torch.isfinite(got.float()).all()) \
                and same and launched == 1 and as_k4
            errs[name] = max(err, errs.get(name, 0.0))
    return ok, errs


# rmsnorm at the model widths (whisper-base, moment-large, stablelm-1.6b,
# h2o-danube-1.8b, qwen2-7b, minitron-8b, qwen2-vl-72b) and the row counts
# it meets: one row, a decode step's 8, a verify forward's 40 (8 x 5), and
# 4176
RMSNORM_WIDTHS = (512, 1024, 2048, 2560, 3584, 4096, 8192)
RMSNORM_ROWS = (1, 8, 40, 4176)


def rmsnorm_inputs(gen, rows, d, dev):
    """bf16 activations (rows, d) of spread magnitudes and f32 weights, as
    the models hold them."""
    import torch
    x = torch.randn((rows, d), generator=gen, device=dev) * \
        (0.1 + 8 * torch.rand((rows, 1), generator=gen, device=dev))
    w = 1 + 0.3 * torch.randn((d,), generator=gen, device=dev)
    return x.to(torch.bfloat16), w


def check_rmsnorm(dev, gen):
    """rmsnorm against its plain version at ``RMSNORM_WIDTHS`` on 4176 rows,
    every element within one bf16 ulp (2^-7 of its magnitude: both compute
    in f32, summing in another order, and round once), bit-identical twice;
    and row-invariant: every row gives the same bits in that one call, in
    calls of 8 rows (a decode step's), of 40 rows shaped (8, 5, d) (a verify
    forward's) and of one row. The plain version is put through the same
    chunks and its differences are reported (not gated): the elements whose
    bits differ between its 8-row and 40-row calls, and the rows whose f32
    mean of squares differs."""
    import torch

    from repro_torch.kernels import ops, ref
    n = RMSNORM_ROWS[-1]
    n40 = n // 40 * 40
    errs, ok = {}, True
    for d in RMSNORM_WIDTHS:
        x, w = rmsnorm_inputs(gen, n, d, dev)
        before = ops.LAUNCHES["rmsnorm"]
        whole = ops.rmsnorm(w, x)
        launched = ops.LAUNCHES["rmsnorm"] - before
        same = torch.equal(whole, ops.rmsnorm(w, x))

        def by(fn, rows, shape=None):
            return torch.cat([fn(w, x[i:i + rows] if shape is None else
                                 x[i:i + rows].view(*shape, d)).view(-1, d)
                              for i in range(0, n // rows * rows, rows)])
        by8, by40, by1 = by(ops.rmsnorm, 8), by(ops.rmsnorm, 40, (8, 5)), \
            torch.cat([ops.rmsnorm(w, x[i:i + 1]) for i in range(8)])
        inv = torch.equal(by8, whole) and torch.equal(by40, whole[:n40]) \
            and torch.equal(by1, whole[:8])
        plain = ref.rmsnorm(w, x)
        p8 = by(ref.rmsnorm, 8)[:n40]
        p40 = by(ref.rmsnorm, 40, (8, 5))
        plain_elems = int((p8 != p40).sum().item())

        def mean_sq(t):                     # the plain version's mean
            t = t.float()
            return torch.mean(t * t, dim=-1)
        m8 = torch.cat([mean_sq(x[i:i + 8]) for i in range(0, n40, 8)])
        m40 = torch.cat([mean_sq(x[i:i + 40].view(8, 5, d)).view(-1)
                         for i in range(0, n40, 40)])
        plain_rows = int((m8 != m40).sum().item())
        torch.cuda.synchronize()
        diff = (whole.float() - plain.float()).abs()
        within = bool((diff <= 2.0 ** -7 * plain.float().abs()).all())
        err = diff.max().item()
        log(f"kernel rmsnorm [d={d}] {n} rows: max_abs_err={err:.3e} (one "
            f"bf16 ulp of each element: {within}), bit-identical twice: "
            f"{same}, row-invariant over calls of {n}, 8, 40 as (8, 5, d) "
            f"and 1 rows: {inv}; the plain version over calls of 8 and 40 "
            f"rows: {plain_elems} of {n40 * d} elements differ, the f32 "
            f"mean of squares of {plain_rows} of {n40} rows")
        ok &= within and same and inv and launched == 1 \
            and bool(torch.isfinite(whole.float()).all())
        errs[f"d{d}"] = err
    return ok, errs


# K3's kernels by profiler name: the one-CTA body, the split body and the
# splits' merge (kernel_split keys)
K3_PARTS = {"decode_int8_kernel": "cta", "decode_int8_split_kernel": "split",
            "merge_kernel": "merge"}


def sm_count(dev) -> int:
    """The SMs of ``dev``'s card (an H100's 132 for a CPU rehearsal)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention_int8 as k3
    if dev.type != "cuda":
        return k3._META_SMS
    return build.sm_count(dev.index or 0)


def k3_plan(B, KV, G, hd, S, window, dev) -> list:
    """K3's plan at a shape on this card: [body, splits]."""
    from repro_torch.kernels import decode_attention_int8 as k3
    return list(k3.plan(B, KV, G, hd, S, window, sm_count(dev)))


def k3_sides(B, KV, G, hd, S, window, dev):
    """K3's bodies at a shape, as ``k3_forced`` values: None (the plan's
    own choice, first), then every body the plan did not pick: the
    one-CTA body ("cta"), the split body with one split ("split") and
    with several and the merge ("merge", the plan's count or 4). Both
    sides of the dispatch."""
    body, n = k3_plan(B, KV, G, hd, S, window, dev)
    others = [("cta", 1), ("split", 1), ("merge", n if body == "merge" else 4)]
    return [None] + [o for o in others if o[0] != body]


@contextlib.contextmanager
def k3_forced(side):
    """K3's plan (``decode_attention_int8.plan``) replaced by ``side``, a
    (body, splits) pair, while open (None: the plan itself)."""
    from repro_torch.kernels import decode_attention_int8 as k3
    real = k3.plan
    if side is not None:
        k3.plan = lambda *shape: side
    try:
        yield
    finally:
        k3.plan = real


# K4's and the verify window's kernels by profiler name: the one-CTA bodies,
# the split body (one walk, a kernel a form) and its merge
K4_PARTS = {"paged_decode_kernel": "cta", "paged_split_kernel": "split",
            "paged_merge_kernel": "merge"}
VERIFY_PARTS = {"paged_verify_kernel": "cta",
                "paged_verify_split_kernel": "split",
                "paged_merge_kernel": "merge"}


def k4_plan(B, KV, G, hd, S, window, dev, T=1) -> list:
    """What a call of T window positions (K4: T 1) launches at a table of
    S positions on this card (``paged_decode_attention.split_for``):
    [body, cells a pair walks, cell keys]."""
    from repro_torch.kernels import paged_decode_attention as k4
    return list(k4.split_for(B, KV, G, hd, S, window, T, sm_count(dev))[:3])


def k4_sides(B, KV, G, hd, S, window, dev):
    """K4's bodies (the verify window's too: it takes K4's plan) at a
    shape, as ``k4_forced`` values: None (the plan's own choice, first),
    then every body the plan did not pick: the one-CTA body ("cta", 0),
    the split body with one cell over the whole table ("split") and with
    cells of a quarter of the span, 64 keys at least ("merge": several
    cells and the merge launch)."""
    body = k4_plan(B, KV, G, hd, S, window, dev)[0]
    span = min(window, S) if window else S
    out = [None]
    for side in (("cta", 0), ("split", 64 * -(-S // 64)),
                 ("split", 64 * max(1, span // 4 // 64))):
        with k4_forced(side):
            if k4_plan(B, KV, G, hd, S, window, dev)[0] != body:
                out.append(side)
    return out


def kernel_launches() -> dict:
    """The launches since the last ``reset_launches`` by kernel (the
    kernels that ran; calls by body apart, ``ops.bodies``)."""
    from repro_torch.kernels import ops
    return {k: int(v) for k, v in ops.LAUNCHES.items() if v and "/" not in k}


def sum_bodies(runs) -> dict:
    """The calls by body (``ops.bodies``, kernel -> body -> calls) of
    several runs' stats, summed."""
    out: dict = {}
    for st in runs:
        for kernel, by in st.get("bodies", {}).items():
            into = out.setdefault(kernel, {})
            for body, n in by.items():
                into[body] = into.get(body, 0) + n
    return out


@contextlib.contextmanager
def k4_forced(side):
    """K4's plan (``paged_decode_attention.plan``, which the verify window
    takes too) replaced by ``side``, a (body, cell keys) pair, while open
    (None: the plan itself); ``split_for`` counts the cells from it."""
    from repro_torch.kernels import paged_decode_attention as k4
    real = k4.plan
    if side is not None:
        k4.plan = lambda *shape: side
    try:
        yield
    finally:
        k4.plan = real


def check_int8_decode(dev, gen):
    """K3 and K4 against their plain versions at every case of
    ``INT8_CASES``, two bf16 ulps of the largest output (every length >= 1,
    so no row is empty), and bit-identical over two calls on the same
    inputs; K3 and K4 through each of their bodies (``k3_sides``,
    ``k4_sides``: the plan's, then the others). K4's inputs hold stale
    codes in unmapped pages and two streams sharing their first pages
    (``paged_inputs``)."""
    import torch

    from repro_torch.kernels import ops, ref
    errs, ok = {"dense": {}, "paged": {}}, True
    for name, case in INT8_CASES.items():
        H, KV, S = case["H"], case["KV"], case["S"]
        hd, window, lens = case.get("hd", 64), case.get("window"), case["lens"]
        MP = -(-S // PAGE_SIZE)
        q, kq, vq, ks, vs, ln = int8_inputs(gen, SLOTS, H, KV, S, hd, 1, dev,
                                            lens=lens)[0]
        dense = (lambda: ops.decode_attention_int8(q, kq, vq, ks, vs, ln,
                                                   window=window),
                 lambda: ref.decode_attention_int8_ref(
                     q, kq.transpose(1, 2), vq.transpose(1, 2), ks, vs, ln,
                     window=window))
        q4, kp, vp, pks, pvs, pt, ln4 = paged_inputs(
            gen, SLOTS, H, KV, hd, 1 + SLOTS * MP, 1, dev, lens=lens, MP=MP)[0]
        paged = (lambda: ops.paged_decode_attention(q4, kp, vp, pks, pvs, pt,
                                                    ln4, window=window),
                 lambda: ref.paged_decode_attention_ref(
                     q4, kp.transpose(1, 2), vp.transpose(1, 2), pks, pvs, pt,
                     ln4, window=window))
        planned = k3_plan(SLOTS, KV, H // KV, hd, S, window, dev)
        planned4 = k4_plan(SLOTS, KV, H // KV, hd, MP * PAGE_SIZE, window,
                           dev)
        runs = [("dense", side) for side in
                k3_sides(SLOTS, KV, H // KV, hd, S, window, dev)] + \
            [("paged", side) for side in
             k4_sides(SLOTS, KV, H // KV, hd, MP * PAGE_SIZE, window, dev)]
        for kind, side in runs:
            kernel, plain = dense if kind == "dense" else paged
            with k3_forced(side if kind == "dense" else None), \
                    k4_forced(side if kind == "paged" else None):
                got, again = kernel(), kernel()
            want = plain()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            tol = 2 * 2.0 ** -8 * want.float().abs().max().item() + 1e-6
            same = torch.equal(got, again)
            label, where = (("decode_attention_int8",
                             f"S={S} body={list(side or planned)}"
                             f"{' (plan)' if side is None else ''}")
                            if kind == "dense" else
                            ("paged_decode_attention",
                             f"ps={PAGE_SIZE} MP={MP} body="
                             f"{list(side or planned4)}"
                             f"{' (plan)' if side is None else ''}"))
            log(f"kernel {label} [{name}] B={SLOTS} H={H} KV={KV} hd={hd} "
                f"{where} window={window}: max_abs_err={err:.3e} (bound "
                f"{tol:.3e}), bit-identical twice: {same}")
            ok &= err <= tol and bool(torch.isfinite(got.float()).all()) \
                and same
            errs[kind][name] = max(err, errs[kind].get(name, 0.0))
    return ok, errs


# K2 shapes on the serving paths of full-width stablelm-1.6b (H = KV = 32,
# hd = 64): the pooled forward (32 rows of 128 features, causal), a full
# admission (one 128-token bucket, 77 real tokens) and a chunked tail
# admission (a 64-token tail bucket, 37 real tokens, behind the 128-position
# prefix operand with 64 and 0 valid positions), plus GQA, a window, queries
# that are a strict suffix of the keys and lengths that are no tile multiple;
# and of full-width whisper-base (H = KV = 8, hd = 64), none causal: the
# bidirectional encoder over 1500 frames (a pooled batch and an admission),
# the cross-attention of an admission's prompt buckets (Sq 16 and 64 < Sk =
# 1500 frames) and of the pooled decoder (Sq = Sk = 1500).
FLASH_CASES = {
    "pooled": dict(B=32, Sq=128, Sk=128, KV=None),
    "admission": dict(B=1, Sq=128, Sk=128, kv_len=[77]),
    "tail": dict(B=2, Sq=64, Sk=64, Sp=128, kv_len=[37, 37],
                 prefix_len=[64, 0]),
    "gqa": dict(B=2, Sq=128, Sk=128, KV=8, kv_len=[100, 128]),
    "window": dict(B=2, Sq=128, Sk=128, window=48, kv_len=[128, 90]),
    "suffix": dict(B=2, Sq=45, Sk=77, KV=8, kv_len=[77, 50]),
    "tail_gqa_ragged": dict(B=2, Sq=16, Sk=16, Sp=128, KV=8, kv_len=[5, 16],
                            prefix_len=[112, 16]),
    "whisper_encoder": dict(B=2, Sq=ENC_LEN, Sk=ENC_LEN, H=8, KV=8,
                            causal=False),
    "whisper_encoder_admission": dict(B=1, Sq=ENC_LEN, Sk=ENC_LEN, H=8,
                                      KV=8, causal=False),
    "whisper_cross_prefill": dict(B=1, Sq=64, Sk=ENC_LEN, H=8, KV=8,
                                  causal=False),
    "whisper_cross_short": dict(B=1, Sq=16, Sk=ENC_LEN, H=8, KV=8,
                                causal=False),
    "whisper_decoder_self": dict(B=1, Sq=64, Sk=64, H=8, KV=8, kv_len=[37]),
    # key splits (``flash_attention.splits``; the encoder admission above
    # runs 24 query tiles in 2 splits of 768 keys): 8 CTAs over 1500 keys
    # in 12 splits of 128, 11 of them empty past kv_len; 32 CTAs over a
    # 1024-key prefix and 16 new keys in 9 splits, two of them empty past
    # prefix_len, the last the new keys alone; the same over a 1008-key
    # prefix, whose last split holds the prefix's end and the new keys; hd
    # 128 whole and in 3 splits; causal over several query tiles: a
    # 128-query tail behind a 192-key prefix (64 CTAs in 3 splits, the
    # second crossing the prefix's end, the third empty for the first
    # query tile) and a 512-token admission (256 CTAs in 2 splits)
    "split_empty_tail": dict(B=1, Sq=16, Sk=ENC_LEN, H=8, KV=8, causal=False,
                             kv_len=[100]),
    "split_prefix_boundary": dict(B=1, Sq=16, Sk=16, Sp=1024, kv_len=[9],
                                  prefix_len=[700]),
    "split_prefix_crossing": dict(B=1, Sq=16, Sk=16, Sp=1008, kv_len=[16],
                                  prefix_len=[1000]),
    "hd128": dict(B=2, Sq=96, Sk=96, KV=8, hd=128, kv_len=[96, 41]),
    "hd128_split": dict(B=1, Sq=16, Sk=300, KV=8, hd=128, causal=False,
                        kv_len=[250]),
    "split_causal_tail": dict(B=1, Sq=128, Sk=128, Sp=192, kv_len=[100],
                              prefix_len=[150]),
    "split_causal_admission": dict(B=1, Sq=512, Sk=512, kv_len=[400]),
    # moment-large's bidirectional encoder: a pooled batch of 32 requests of
    # 32 patches (H = KV = 16, hd 64), and one request
    "moment": dict(B=32, Sq=MOMENT_LEN, Sk=MOMENT_LEN, H=16, KV=16,
                   causal=False),
    "moment_one": dict(B=1, Sq=MOMENT_LEN, Sk=MOMENT_LEN, H=16, KV=16,
                       causal=False),
    # qwen2-7b (H 28, KV 4, hd 128: G 7, 9 queries and a dead row a CTA)
    # and h2o-danube-1.8b (H 32, KV 8, hd 80, its 4096-position window):
    # pooled, admission and tail (h2o's without the window: a window over a
    # prefix is refused, so h2o admits whole), and h2o's causal prefill of
    # 4160 prompt tokens in a 4352 bucket, longer than its window
    "qwen2_pooled": dict(B=32, Sq=128, Sk=128, H=28, KV=4, hd=128),
    "qwen2_admission": dict(B=1, Sq=128, Sk=128, H=28, KV=4, hd=128,
                            kv_len=[77]),
    "qwen2_tail": dict(B=2, Sq=64, Sk=64, Sp=128, H=28, KV=4, hd=128,
                       kv_len=[37, 37], prefix_len=[64, 0]),
    "h2o_pooled": dict(B=32, Sq=128, Sk=128, H=32, KV=8, hd=80, window=4096),
    "h2o_admission": dict(B=1, Sq=128, Sk=128, H=32, KV=8, hd=80,
                          window=4096, kv_len=[77]),
    "h2o_tail": dict(B=2, Sq=64, Sk=64, Sp=128, H=32, KV=8, hd=80,
                     kv_len=[37, 37], prefix_len=[64, 0]),
    "h2o_window_prefill": dict(B=1, Sq=4352, Sk=4352, H=32, KV=8, hd=80,
                               window=4096, kv_len=[4160]),
    # olmoe-1b-7b (H = KV = 16, hd 128), jamba-v0.1-52b (H 32, KV 8, hd
    # 128) and grok-1-314b (H 48, KV 8, hd 128: G 6): pooled and admission
    "olmoe_pooled": dict(B=32, Sq=128, Sk=128, H=16, KV=16, hd=128),
    "olmoe_admission": dict(B=1, Sq=128, Sk=128, H=16, KV=16, hd=128,
                            kv_len=[77]),
    "jamba_pooled": dict(B=32, Sq=128, Sk=128, H=32, KV=8, hd=128),
    "jamba_admission": dict(B=1, Sq=128, Sk=128, H=32, KV=8, hd=128,
                            kv_len=[77]),
    "grok_pooled": dict(B=8, Sq=32, Sk=32, H=48, KV=8, hd=128),
}
# the shapes timed: one call of each kind as the serving path makes it
# (whisper: the encoder of one admission, and the cross-attention of a
# 64-token prompt bucket against its 1500 frames)
FLASH_TIMED = {
    "pooled": FLASH_CASES["pooled"],
    "admission": FLASH_CASES["admission"],
    "tail": dict(B=1, Sq=64, Sk=64, Sp=128, kv_len=[37], prefix_len=[64]),
    "whisper_encoder": dict(B=1, Sq=ENC_LEN, Sk=ENC_LEN, H=8, KV=8,
                            causal=False),
    "whisper_cross": FLASH_CASES["whisper_cross_prefill"],
    "moment": FLASH_CASES["moment"],
    "qwen2_pooled": FLASH_CASES["qwen2_pooled"],
    "h2o_pooled": FLASH_CASES["h2o_pooled"],
    "h2o_window_prefill": FLASH_CASES["h2o_window_prefill"],
    **{name: FLASH_CASES[name] for name in (
        "olmoe_pooled", "olmoe_admission", "jamba_pooled",
        "jamba_admission")},
}


def flash_inputs(gen, dev, B, Sq, Sk, KV=None, H=None, Sp=0, kv_len=None,
                 prefix_len=None, window=None, causal=True, hd=None,
                 nsets=1):
    """``nsets`` bf16 input sets for one K2 case in the model layout, and
    its keyword arguments (stablelm-1.6b's heads unless ``H``/``KV``/
    ``hd``)."""
    import torch
    cfg = full_config()
    H, hd = H or cfg.num_heads, hd or cfg.head_dim
    KV = KV or cfg.num_kv_heads
    sets = []
    for _ in range(nsets):
        def r(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(
                torch.bfloat16)
        args = [r(B, Sq, H, hd), r(B, Sk, KV, hd), r(B, Sk, KV, hd)]
        kw = {"causal": causal, "window": window}
        if kv_len is not None:
            kw["kv_len"] = torch.tensor(kv_len, dtype=torch.int32, device=dev)
        if Sp:
            kw.update(prefix_k=r(B, Sp, KV, hd), prefix_v=r(B, Sp, KV, hd),
                      prefix_len=torch.tensor(prefix_len, dtype=torch.int32,
                                              device=dev))
        sets.append((args, kw))
    return sets


def flash_visible(q, k, kw):
    """(B, Sq, Sp + Sk) bool: which keys each query may see (the kernel's
    masks, computed on the host side of the check)."""
    import torch
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    pk = kw.get("prefix_k")
    Sp = 0 if pk is None else pk.shape[1]
    dev = q.device
    kpos = torch.arange(Sp + Sk, device=dev)
    qpos = Sp + Sk - Sq + torch.arange(Sq, device=dev)
    vis = torch.ones((B, Sq, Sp + Sk), dtype=torch.bool, device=dev)
    if kw.get("causal", True):
        vis &= (qpos[:, None] >= kpos[None])[None]
    if kw.get("window") is not None:
        vis &= ((qpos[:, None] - kpos[None]) < kw["window"])[None]
    n_new = kw["kv_len"] if kw.get("kv_len") is not None else \
        torch.full((B,), Sk, device=dev)
    ok = (kpos[None] >= Sp) & (kpos[None] - Sp < n_new[:, None])
    if Sp:
        ok |= (kpos[None] < Sp) & (kpos[None] < kw["prefix_len"][:, None])
    return vis & ok[:, None]


def flash_bound(q, k, kw):
    """Bytes and flops the function needs on this data: q read and out
    written once, K and V of the keys inside ``kv_len``/``prefix_len``
    only, the lengths; 4 * hd flops per (query head, visible key)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    vis = flash_visible(q, k, kw)
    keys = int(vis.any(dim=1).sum())          # key rows any query reads
    nbytes = 2 * 2 * B * Sq * H * hd + 2 * 2 * keys * KV * hd + 8 * B
    flops = 4.0 * hd * H * int(vis.sum())
    return bound_ms(nbytes, flops)


def flash_shape(q, k, kw) -> tuple:
    """(B, Sq, Sk, Sp, H, KV, hd, causal, window) of a K2 call."""
    B, Sq, H, hd = q.shape
    pk = kw.get("prefix_k")
    return (B, Sq, k.shape[1], 0 if pk is None else pk.shape[1], H,
            k.shape[2], hd, kw.get("causal", True), kw.get("window"))


def flash_plan(q, k, kw) -> list:
    """What K2's wrapper launches for this call on this card: [body, rows,
    splits, keys a split] (``flash_attention.plan``)."""
    from repro_torch.kernels import flash_attention as fa
    return list(fa.plan(*flash_shape(q, k, kw), sm_count(q.device)))


def flash_forms(shape: tuple, sms: int) -> dict:
    """Each form of K2 at a call's shapes (B, Sq, Sk, Sp, H, KV, hd, causal,
    window), by label, as ``flash_attention.Plan`` values: the mma body
    with its own split ("mma"), and where the Hopper body takes the call
    (no prefix, hd 64 or 128) that body with 64 and with 128 rows a CTA,
    unsplit ("wgmma64", "wgmma128"), and with 64 rows and the keys in
    about three splits of 64-key multiples, which end inside the body's
    key tiles ("wgmma64_split")."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Sk, Sp, H, KV, hd = shape[:7]
    forms = {"mma": fa.Plan("mma", fa._ROWS,
                            *fa.splits(B, Sq, H, KV, Sp + Sk, sms))}
    if not Sp and hd in fa._SM90_HEAD_DIMS:
        whole = fa._SM90_TILE * -(-Sk // fa._SM90_TILE)
        part = 64 * max(1, -(-Sk // 3 // 64))
        forms.update(wgmma64=fa.Plan("wgmma", 64, 1, whole),
                     wgmma128=fa.Plan("wgmma", 128, 1, whole),
                     wgmma64_split=fa.Plan("wgmma", 64, -(-Sk // part),
                                           part))
    return forms


def flash_sides(q, k, kw) -> list:
    """K2's forms at a call's shapes, as ``flash_forced`` values: None (the
    plan's own choice, first), then every form of ``flash_forms`` that
    launches something else."""
    from repro_torch.kernels import flash_attention as fa
    shape = flash_shape(q, k, kw)
    mine = fa.plan(*shape, sm_count(q.device))
    return [None] + [f for f in flash_forms(shape, sm_count(q.device))
                     .values() if f != mine]


@contextlib.contextmanager
def flash_forced(side):
    """K2's plan (``flash_attention.plan``) replaced by ``side``, a
    ``flash_attention.Plan``, while open (None: the plan itself)."""
    from repro_torch.kernels import flash_attention as fa
    real = fa.plan
    if side is not None:
        fa.plan = lambda *shape: side
    try:
        yield
    finally:
        fa.plan = real


def check_flash(dev, gen):
    """K2 against its plain version at every case of ``FLASH_CASES``
    through each of its bodies (``flash_sides``: the plan's, then the
    others, forced), two bf16 ulps of the largest output, and bit-identical
    over two calls on the same inputs; rows with no visible key are left
    out (the kernel returns zeros there, the plain version the mean of the
    masked values, as JAX does)."""
    import torch

    from repro_torch.kernels import ops, ref
    errs, ok = {}, True
    for name, case in FLASH_CASES.items():
        (args, kw), = flash_inputs(gen, dev, **case)
        want = ref.flash_attention_ref(*args, **kw)
        rows = flash_visible(args[0], args[1], kw).any(dim=-1)
        tol = 2 * 2.0 ** -8 * want.float()[rows].abs().max().item() + 1e-6
        for side in flash_sides(args[0], args[1], kw):
            with flash_forced(side):
                got = ops.flash_attention(*args, **kw)
                again = ops.flash_attention(*args, **kw)
                planned = flash_plan(args[0], args[1], kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()[rows].max().item()
            same = bool(torch.equal(got, again))
            good = err <= tol and same and bool(
                torch.isfinite(got.float()).all())
            tag = name if side is None else f"{name} forced {planned}"
            log(f"kernel flash_attention [{tag}] {case}: plan {planned}, "
                f"max_abs_err={err:.3e} (bound {tol:.3e}), bit-identical "
                f"twice: {same}" + ("" if good else "  FAILED"))
            ok &= good
            errs[name] = max(errs.get(name, 0.0), err)
    return ok, errs


def check_unsupported(dev) -> dict:
    """Each attention wrapper raises ``ValueError`` for a shape it has no
    instantiation for: hd 96 (every one), and a group of 3 for K3, K4, the
    verify window and K5 (K2 takes any group up to 64)."""
    import torch

    from repro_torch.kernels import ops
    bf, i8, i32 = torch.bfloat16, torch.int8, torch.int32

    def z(*shape, dt=bf):
        return torch.zeros(shape, dtype=dt, device=dev)

    def raises(fn):
        try:
            fn()
        except ValueError:
            return True
        return False
    out = {}
    for hd, H, KV in ((96, 8, 8), (64, 12, 4)):
        if hd == 96:
            out["flash_attention hd96"] = raises(lambda: ops.flash_attention(
                z(1, 16, H, hd), z(1, 16, KV, hd), z(1, 16, KV, hd)))
        tag = f"hd{hd}_g{H // KV}"
        ln = torch.ones(2, dtype=i32, device=dev)
        out[f"decode_attention {tag}"] = raises(lambda: ops.decode_attention(
            z(2, H, hd), z(2, 32, KV, hd), z(2, 32, KV, hd), ln))
        out[f"decode_attention_int8 {tag}"] = raises(
            lambda: ops.decode_attention_int8(
                z(2, H, hd), z(2, 32, KV, hd, dt=i8), z(2, 32, KV, hd, dt=i8),
                z(2, KV, dt=torch.float32), z(2, KV, dt=torch.float32), ln))
        pt = torch.zeros((2, 2), dtype=i32, device=dev)
        arena = z(3, PAGE_SIZE, KV, hd, dt=i8)
        scale = z(3, KV, dt=torch.float32)
        pages = (arena, arena, scale, scale, pt)
        out[f"paged_decode_attention {tag}"] = raises(
            lambda: ops.paged_decode_attention(z(2, H, hd), *pages, ln))
        out[f"paged_verify_attention {tag}"] = raises(
            lambda: ops.paged_verify_attention(z(2, 3, H, hd), *pages, ln))
    log(f"kernel wrappers raise for shapes without an instantiation: {out}")
    return out


def phase_kernels(dev):
    """Each kernel against its plain version at the serving shapes. The
    tolerance is two bf16 ulps of the largest output magnitude: both sides
    accumulate in f32 (in another order) and round the result to bf16."""
    import torch

    from repro_torch.kernels import ops, ref
    cfg = full_config()
    gen = torch.Generator(device=dev).manual_seed(1)
    results, ok = {}, True
    cap = 4                                  # slot bucket of 4 adapters
    for name, case in sgmv_cases(cfg).items():
        T, dd, oo = case["T"], case["d"], case["out"]
        na, r = case.get("na", cap), case.get("r", RANK)
        x, ids, a, b = sgmv_inputs(gen, T, dd, oo, na, 1, dev, r=r,
                                   sentinel_only=case.get("sentinel_only",
                                                          False))[0]
        got = ops.segmented_lora(x, ids, a, b, block_t=BLOCK_T)
        again = ops.segmented_lora(x, ids, a, b, block_t=BLOCK_T)
        want = ref.segmented_lora_ref(x, ids, a, b, BLOCK_T)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = 2 * 2.0 ** -8 * want.float().abs().max().item() + 1e-6
        sentinel_zero = bool((got.view(-1, BLOCK_T, oo)[ids >= na] == 0).all())
        same = torch.equal(got, again)
        log(f"kernel segmented_lora [{name}] T={T} d={dd} out={oo} r={r} "
            f"NA={na}, {sgmv_plan(x)}: max_abs_err={err:.3e} (bound "
            f"{tol:.3e}), sentinel blocks zero: {sentinel_zero}, "
            f"bit-identical twice: {same}")
        ok &= err <= tol and sentinel_zero and same
        results.setdefault("segmented_lora", {})[name] = err
    # K3 and K4 at every case of INT8_CASES
    ok_i, errs_i = check_int8_decode(dev, gen)
    ok &= ok_i
    results["decode_attention_int8"] = errs_i["dense"]
    results["paged_decode_attention"] = errs_i["paged"]
    # the verify window at every case of VERIFY_CASES
    ok_v, results["paged_verify_attention"] = check_verify(dev, gen)
    ok &= ok_v
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    S = PROMPT_LEN + MAX_NEW + 1
    MP = -(-S // PAGE_SIZE)
    # K4 against K3 on a contiguous table whose page scales are the slot
    # scales: the same attention over the same codes, two bf16 ulps
    q, kq, vq, ks, vs, ln = int8_inputs(gen, SLOTS, H, KV, S, hd, 1, dev)[0]
    P = 1 + SLOTS * MP
    kpad = torch.zeros((SLOTS, MP * PAGE_SIZE, KV, hd), dtype=torch.int8,
                       device=dev)
    vpad = torch.zeros_like(kpad)
    kpad[:, :S], vpad[:, :S] = kq, vq
    kp = torch.zeros((P, PAGE_SIZE, KV, hd), dtype=torch.int8, device=dev)
    vp = torch.zeros_like(kp)
    kp[1:] = kpad.reshape(SLOTS * MP, PAGE_SIZE, KV, hd)
    vp[1:] = vpad.reshape(SLOTS * MP, PAGE_SIZE, KV, hd)
    pt = (1 + torch.arange(SLOTS * MP, device=dev, dtype=torch.int32)
          ).reshape(SLOTS, MP)
    pks = torch.zeros((P, KV), device=dev)
    pvs = torch.zeros((P, KV), device=dev)
    pks[1:] = ks.repeat_interleave(MP, dim=0)
    pvs[1:] = vs.repeat_interleave(MP, dim=0)
    got = ops.paged_decode_attention(q, kp, vp, pks, pvs, pt, ln)
    want = ops.decode_attention_int8(q, kq, vq, ks, vs, ln)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = 2 * 2.0 ** -8 * want.float().abs().max().item() + 1e-6
    log(f"kernel paged_decode_attention vs decode_attention_int8 on a "
        f"contiguous table: max_abs_err={err:.3e} (bound {tol:.3e})")
    ok &= err <= tol
    results["paged_vs_dense"] = err
    ok_f, results["flash_attention"] = check_flash(dev, gen)
    ok_d, results["decode_attention"] = check_float_decode(dev, gen)
    ok_n, results["rmsnorm"] = check_rmsnorm(dev, gen)
    ok_u = all(check_unsupported(dev).values())
    return ok and ok_f and ok_d and ok_n and ok_u, results


# ---------------- phase 2: a small input against the CPU reference ----------------

def full_config(**over):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ARCH), **over)


def random_adapter(store, i, dev):
    """A rank-16 q/v adapter with random A AND B (a fresh adapter's B is zero,
    which would make the LoRA kernel's work invisible)."""
    import torch

    from repro_torch.models import lora
    from repro_torch.models.common import tree_map
    gen = torch.Generator(device=dev).manual_seed(1000 + i)
    tree = lora.init_single_adapter(gen, store.cfg, store.rank, device=dev)
    return tree_map(lambda t: torch.randn(t.shape, generator=gen, device=dev)
                    * 0.05, tree)


def _teacher_forced(cfg, fm, d, params, lst, cap, toks, aidx, S, steps,
                    impl, kv_quant, enc=None):
    """Prefill ``S`` tokens (an encoder-decoder stack: with the frames
    ``enc`` (B, S_enc, d), numpy), then ``steps`` teacher-forced decode
    steps; returns the f32 logits of every step on the host."""
    import torch

    from repro_torch.core.physical import seg_to_device
    from repro_torch.models import lm

    def meta(n):
        if impl != "segmented":
            return None
        perm, inv, blocks = seg_to_device(*fm.segment_meta(aidx, cap, n), d)
        return {"perm": perm, "inv": inv, "block_adapter": blocks,
                "block_t": fm.seg_block_t}
    B = toks.shape[0]
    adapter_idx = torch.as_tensor(aidx, device=d)
    cache = lm.init_cache(cfg, B, S + steps + 1, kv_quant=kv_quant,
                          enc_len=None if enc is None else enc.shape[1],
                          device=d)
    logits, cache = lm.prefill(
        params, cfg, tokens=torch.as_tensor(toks[:, :S], device=d), cache=cache,
        enc_embeds=None if enc is None else torch.as_tensor(enc, device=d),
        lora=lst, adapter_idx=adapter_idx, lora_impl=impl, lora_seg=meta(S))
    out = [logits.float().cpu()]
    seg1 = meta(1)
    for t in range(steps):
        logits, cache = lm.decode_step(
            params, cfg, tokens=torch.as_tensor(toks[:, S + t], device=d),
            cache=cache, lora=lst, adapter_idx=adapter_idx, lora_impl=impl,
            lora_seg=seg1)
        out.append(logits.float().cpu())
    return torch.stack(out)                       # (1 + steps, B, V)


def phase_reference(dev):
    """Full-width, two-layer model with 4 rows (3 adapters and one base-model
    row): prefill + teacher-forced decode through the kernels on the card,
    held against the same weights run with the plain versions on the CPU.
    The two sides round bf16 activations after matmuls summed in different
    orders, so they drift apart by bf16 ulps (2^-9 relative), and an ulp of
    K/V can move an int8 code by one. Bound: relative L2 error of the logits
    at most 2e-2, and the greedy token equal wherever the CPU's top-2 gap
    exceeds twice the largest logit difference, on both legs: the serving
    path (segmented LoRA through K1, int8 cache through K3) and the float
    pool (gather LoRA, bf16 cache through K5). K2 carries both prefills;
    each leg's kernels must launch in its GPU run."""
    import numpy as np
    import torch

    from repro_torch.core.physical import AdapterStore, PhysicalFM
    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_map
    cfg = full_config(num_layers=2)
    fm = PhysicalFM(cfg, seed=3, lora_rank=RANK, lora_impl="segmented",
                    device=dev)
    cpu_params = tree_map(lambda t: t.cpu(), fm.params)
    store = AdapterStore(cfg, RANK, device=dev)
    for i in range(3):
        store.add(f"a{i}", random_adapter(store, i, dev))
    stack = store.stacked()
    cap = store.capacity()
    stack_cpu = tree_map(lambda t: t.cpu(), stack)
    B, S, steps = 4, 16, 4
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, (B, S + steps)).astype(np.int64)
    aidx = np.array([0, 2, cap, 1], np.int32)          # cap == base model
    report = {}
    legs = {"segmented": (True, ("segmented_lora", "decode_attention_int8",
                                 "flash_attention", "rmsnorm")),
            "gather": (False, ("decode_attention", "flash_attention",
                               "rmsnorm"))}
    ok = True
    for impl, (kvq, kernels) in legs.items():
        c = _teacher_forced(cfg, fm, torch.device("cpu"), cpu_params,
                            stack_cpu, cap, toks, aidx, S, steps, impl, kvq)
        ops.reset_launches()
        g = _teacher_forced(cfg, fm, torch.device(dev), fm.params, stack, cap,
                            toks, aidx, S, steps, impl, kvq)
        r = report[impl] = drift(g.flatten(0, 1), c.flatten(0, 1))
        r["launches"] = {k: int(ops.LAUNCHES[k]) for k in kernels}
        ok &= (r["finite"] and r["rel_l2"] <= 2e-2 and r["argmax_agree"]
               and all(v > 0 for v in r["launches"].values()))
    log("reference: 2-layer full-width model, 4 rows x (16 prompt + 4 decode) "
        "teacher-forced, GPU vs CPU, int8 pool (K3) and float pool (K5): "
        + json.dumps(report))
    return ok, report


def whisper_config(**over):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(WHISPER), **over)


def fan_in_qk(params, cfg):
    """Scale every query and key projection (self and cross, decoder and
    encoder) in place to the model's real fan-in, sqrt(heads / d_model)
    with the projection's own heads (query or kv): the package's init
    takes the heads axis of a (d, heads, hd) projection as its fan-in (see
    ``phase_reference_whisper``). The xLSTM cells likewise: the mLSTM's
    q, k and v projections (di, heads, hd) by sqrt(heads / di), its keys a
    further 1/4, and its gate projection ``wif`` and the sLSTM's ``w`` and
    ``r`` (drawn at a fixed 0.1 and 0.05) to 1 / sqrt(di). At the init
    draws xlstm-125m's q/k/v come out 20x and its gate pre-activations
    2-4x too large, the stabilizer's floor exp(-m) falls to ~1e-3 and the
    normalizer max(|n . q|, exp(-m)) takes |n . q| where it passes near
    zero, so one bf16 ulp is amplified: the card and the CPU 0.73 rel L2
    apart at 12 layers, 0.053 with q/k/v and ``wif`` at their fan-in,
    0.015 with the keys at 1/4 (|n . q| under the floor) and the sLSTM's
    gates at theirs (measured on one NVIDIA H100 80GB HBM3, 700.00 W)."""
    encoder = params["encoder"]["layers"] if "encoder" in params else []
    for sub in params["layers"] + encoder:
        for name in ("attn", "cross"):
            if name in sub:
                for w, heads in (("wq", cfg.num_heads),
                                 ("wk", cfg.num_kv_heads)):
                    sub[name][w].mul_((heads / cfg.d_model) ** 0.5)
        if "mlstm" in sub:
            di = sub["mlstm"]["wq"].shape[1]
            for w in ("wq", "wk", "wv"):
                sub["mlstm"][w].mul_((cfg.num_heads / di) ** 0.5)
            sub["mlstm"]["wk"].mul_(0.25)
            sub["mlstm"]["wif"].mul_(1.0 / (0.1 * di ** 0.5))
        if "slstm" in sub:
            di = sub["slstm"]["w"].shape[1]
            for w in ("w", "r"):
                sub["slstm"][w].mul_(1.0 / (0.05 * di ** 0.5))


def phase_reference_whisper(dev):
    """A two-layer cut (2 decoder, 2 encoder layers) of full-width
    whisper-base with 4 rows (3 adapters and the base model), each with its
    own 1500 random frames: encoder, prefill and teacher-forced decode
    through the kernels on the card (K2 for the bidirectional encoder, the
    cross-attention of the prompt and the decoder's causal prefill; K5 for
    every cross-attention decode; K3 for the int8 self-attention; K1),
    held against the same weights with the plain versions on the CPU. The
    encoder's bf16 rounding noise reaches the logits through every
    cross-attention (on the CPU the JAX and PyTorch packages differ by
    ~4e-2 relative L2 there: tests/test_torch_encdec.py), so the bound is
    relative L2 at most 6e-2, with greedy tokens equal wherever the CPU's
    top-2 gap exceeds twice the largest difference.

    The query and key projections are drawn at the model's real fan-in
    (scaled by sqrt(heads / d_model)): the package's init takes the axis
    before last (the heads) as the fan-in of a (d, heads, hd) projection,
    8x too large here, which makes attention over 1500 frames nearly
    one-hot and the forward chaotic in bf16: a perturbation of one bf16
    ulp flips which frame a query attends, so no kernel fault could be told
    from rounding. The drift with the package's init is printed for scale
    (``package_init``), the gate reads the real fan-in's."""
    import numpy as np
    import torch

    from repro_torch.core.physical import AdapterStore, PhysicalFM
    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_map
    cfg = whisper_config(num_layers=2, encoder_layers=2)
    fm = PhysicalFM(cfg, seed=4, lora_rank=RANK, lora_impl="segmented",
                    device=dev)
    store = AdapterStore(cfg, RANK, device=dev)
    for i in range(3):
        store.add(f"a{i}", random_adapter(store, i, dev))
    stack, cap = store.stacked(), store.capacity()
    stack_cpu = tree_map(lambda t: t.cpu(), stack)
    B, S, steps = 4, 16, 4
    rng = np.random.RandomState(1)
    toks = rng.randint(0, cfg.vocab_size, (B, S + steps)).astype(np.int64)
    enc = (rng.randn(B, ENC_LEN, cfg.d_model) * 0.5).astype(np.float32)
    aidx = np.array([0, 2, cap, 1], np.int32)

    def run():
        cpu_params = tree_map(lambda t: t.cpu(), fm.params)
        c = _teacher_forced(cfg, fm, torch.device("cpu"), cpu_params,
                            stack_cpu, cap, toks, aidx, S, steps, "segmented",
                            True, enc)
        ops.reset_launches()
        g = _teacher_forced(cfg, fm, torch.device(dev), fm.params, stack,
                            cap, toks, aidx, S, steps, "segmented", True, enc)
        torch.cuda.synchronize()
        return drift(g.flatten(0, 1), c.flatten(0, 1))
    package_init = run()
    fan_in_qk(fm.params, cfg)
    r = run()
    r["launches"] = {k: int(ops.LAUNCHES[k]) for k in (
        "segmented_lora", "flash_attention", "decode_attention",
        "decode_attention_int8", "rmsnorm")}
    r["package_init"] = {k: package_init[k] for k in ("rel_l2", "max_abs")}
    log(f"whisper reference: 2+2-layer full-width whisper-base, {B} rows x "
        f"({ENC_LEN} frames, {S} prompt + {steps} decode) teacher-forced, "
        f"GPU vs CPU: " + json.dumps(r))
    ok = (r["finite"] and r["rel_l2"] <= 6e-2 and r["argmax_agree"]
          and all(v > 0 for v in r["launches"].values()))
    return ok, r


def _engine_run(fm, prompts, names, teacher_calls=None, paged=True,
                chunked=False, prompt_len=32, max_new=CHUNK + 1):
    """The prompts through a decode engine on ``fm`` (the paged pool, or
    the dense one for scale; ``max_new`` tokens a stream, one chunk of
    decode after the admissions by default; ``chunked``: the paged pool
    with chunked shared-prefix prefill).
    Greedy when ``teacher_calls`` is None; otherwise every sampler call is
    fed the argmax of the matching call in ``teacher_calls``. Returns each
    call's (f32 logits, live rows) and the engine. Eager
    (``graphs.disabled()``): the recording sampler reads the logits on the
    host."""
    import numpy as np
    import torch

    from repro_torch.core import graphs
    from repro_torch.core.decode_engine import DecodeEngine
    kw = dict(PAGED_KW, total_pages=None, chunked_prefill=chunked) \
        if paged else {}
    eng = DecodeEngine(fm, num_slots=len(prompts), prompt_len=prompt_len,
                       max_new=max_new, chunk=CHUNK, **kw)
    calls = []

    def sample(logits, gens):
        live = np.ones(1, bool) if logits.shape[0] == 1 else np.array(
            [s is not None and not s.done for s in eng.slots])
        calls.append((logits.float().cpu(), live))
        src = logits if teacher_calls is None else \
            teacher_calls[len(calls) - 1][0]
        return torch.argmax(src, dim=-1).to(torch.int32).to(logits.device), gens
    eng._sample = sample
    with graphs.disabled():
        for i, (p, name) in enumerate(zip(prompts, names)):
            eng.join(f"t{i}", p, adapter_id=name, max_new_tokens=max_new,
                     rid=i)
        eng.drain()
    return calls, eng


def drift(g, c) -> dict:
    """GPU-vs-CPU drift of f32 logits (rows, V) on the host: max |diff|,
    relative L2, and greedy agreement wherever the CPU's top-2 gap exceeds
    twice the largest difference."""
    import torch
    worst = (g - c).abs().max().item()
    top2 = torch.topk(c, 2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > 2 * worst
    return {"finite": bool(torch.isfinite(g).all()), "max_abs": worst,
            "max_ref": c.abs().max().item(),
            "rel_l2": (torch.linalg.vector_norm(g - c)
                       / torch.linalg.vector_norm(c)).item(),
            "argmax_checked": int(sure.sum()),
            "argmax_agree": bool((g.argmax(-1) == c.argmax(-1))[sure].all())}


def phase_reference_paged(dev):
    """The two-layer full-width model through the PAGED engine: 4 streams
    (three adapters and the base model; streams 0 and 1 share a 16-token
    prefix page under one adapter, so the second maps the first's page),
    per-page int8 admission, then one teacher-forced decode chunk — the
    card (K4, K1) against the CPU (plain versions). The same engine on the
    dense pool, same prompts, is run both ways for scale: the two devices
    round bf16 activations differently, and the int8 codes of K/V that
    differ by an ulp near a rounding boundary differ by one. These prompts
    drift more than the dense reference's (on an H100: 0.0220 paged, 0.0222
    dense, against that phase's 0.0169), so the bound is relative L2 at
    most 3e-2, with greedy tokens equal wherever the CPU's top-2 gap
    exceeds twice the largest logit difference."""
    import numpy as np
    import torch

    from repro_torch.core.physical import PhysicalFM
    from repro_torch.models.common import tree_map
    cfg = full_config(num_layers=2)
    gfm = PhysicalFM(cfg, seed=3, lora_rank=RANK, input_len=32,
                     lora_impl="segmented", seg_block_t=BLOCK_T, device=dev)
    cfm = PhysicalFM(cfg, seed=3, lora_rank=RANK, input_len=32,
                     lora_impl="segmented", seg_block_t=BLOCK_T, device="cpu",
                     params=tree_map(lambda t: t.cpu(), gfm.params))
    for i in range(3):
        tree = random_adapter(gfm.adapters, i, dev)
        gfm.adapters.add(f"a{i}", tree)
        cfm.adapters.add(f"a{i}", tree_map(lambda t: t.cpu(), tree))
    rng = np.random.RandomState(5)
    prefix = rng.randint(0, cfg.vocab_size, PAGE_SIZE).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.randint(0, cfg.vocab_size, 4)]),
               np.concatenate([prefix, rng.randint(0, cfg.vocab_size, 9)]),
               rng.randint(0, cfg.vocab_size, 20),
               rng.randint(0, cfg.vocab_size, 13)]
    prompts = [p.astype(np.int32) for p in prompts]
    names = ["a0", "a0", "a2", None]
    report = {}
    for paged in (True, False):
        ccalls, ceng = _engine_run(cfm, prompts, names, paged=paged)
        gcalls, geng = _engine_run(gfm, prompts, names, ccalls, paged=paged)
        r = drift(torch.cat([lg[lv] for lg, lv in gcalls]),
                  torch.cat([lg[lv] for lg, lv in ccalls]))
        r["calls"] = [len(ccalls), len(gcalls)]
        if paged:
            r["prefix_hits"] = [ceng.prefix_hits, geng.prefix_hits]
        report["paged" if paged else "dense_same_prompts"] = r
    log("paged reference: 2-layer full-width engine, 4 streams (one shared "
        "prefix page) x (prefill + 4 decode) teacher-forced, GPU vs CPU: "
        + json.dumps(report))
    k = report["paged"]
    ok = (k["finite"] and k["rel_l2"] <= 3e-2 and k["argmax_agree"]
          and k["calls"][0] == k["calls"][1] and k["prefix_hits"] == [1, 1])
    return ok, report


def phase_reference_chunked(dev):
    """The two-layer full-width model through the paged engine with CHUNKED
    shared-prefix prefill: five streams, four of them on adapter a0 behind
    one 16-token prefix page. The first admits in full and registers the
    page; the three sharers with tails of 9, 16 and 1 tokens map it and
    prefill only their tails (``_try_admit_tail``, the float-sidecar mode,
    K2 with the prefix operand); a base-model stream admits in full. Then
    one teacher-forced decode chunk. The card (K2, K1, K4) against the CPU
    (plain versions), under the paged reference's bound: relative L2 of
    the logits at most 3e-2, greedy tokens equal wherever the CPU's top-2
    gap exceeds twice the largest difference. K2 must launch on the card."""
    import numpy as np
    import torch

    from repro_torch.core.physical import PhysicalFM
    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_map
    cfg = full_config(num_layers=2)
    gfm = PhysicalFM(cfg, seed=3, lora_rank=RANK, input_len=32,
                     lora_impl="segmented", seg_block_t=BLOCK_T, device=dev)
    cfm = PhysicalFM(cfg, seed=3, lora_rank=RANK, input_len=32,
                     lora_impl="segmented", seg_block_t=BLOCK_T, device="cpu",
                     params=tree_map(lambda t: t.cpu(), gfm.params))
    for i in range(2):
        tree = random_adapter(gfm.adapters, i, dev)
        gfm.adapters.add(f"a{i}", tree)
        cfm.adapters.add(f"a{i}", tree_map(lambda t: t.cpu(), tree))
    rng = np.random.RandomState(6)
    prefix = rng.randint(0, cfg.vocab_size, PAGE_SIZE).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.randint(0, cfg.vocab_size, n)])
               for n in (4, 9, 16, 1)] + \
        [rng.randint(0, cfg.vocab_size, 13)]
    prompts = [p.astype(np.int32) for p in prompts]
    names = ["a0", "a0", "a0", "a0", None]
    ccalls, ceng = _engine_run(cfm, prompts, names, chunked=True)
    ops.reset_launches()
    gcalls, geng = _engine_run(gfm, prompts, names, ccalls, chunked=True)
    torch.cuda.synchronize()
    r = drift(torch.cat([lg[lv] for lg, lv in gcalls]),
              torch.cat([lg[lv] for lg, lv in ccalls]))
    r.update(calls=[len(ccalls), len(gcalls)],
             prefix_hits=[ceng.prefix_hits, geng.prefix_hits],
             prefill_tokens_saved=[ceng.prefill_tokens_saved,
                                   geng.prefill_tokens_saved],
             flash_attention_launches=int(ops.LAUNCHES["flash_attention"]))
    log("chunked reference: 2-layer full-width chunked paged engine, 5 "
        "streams (3 tail admissions behind one shared prefix page) x "
        "(prefill + 4 decode) teacher-forced, GPU vs CPU: " + json.dumps(r))
    ok = (r["finite"] and r["rel_l2"] <= 3e-2 and r["argmax_agree"]
          and r["calls"][0] == r["calls"][1] and r["prefix_hits"] == [3, 3]
          and r["prefill_tokens_saved"] == [3 * PAGE_SIZE] * 2
          and r["flash_attention_launches"] > 0)
    return ok, r


# ---------------- graphed against eager ----------------

ENGINE_CALLS = ("join", "step_chunk", "cancel", "shed_stranded",
                "warm_decode_ladder", "warm_chunked", "warm_speculative")


def call_summary(name, out):
    """What a recorded call returned, in a comparable form: the streams a
    ``step_chunk`` retired with their tokens and status, a cancel's place
    and rid, a copy of pooled features on the device; else the value."""
    if name == "step_chunk":
        return [(d.rid, list(d.tokens), d.status) for d in out]
    if name == "cancel":
        return None if out is None else (out[0], out[1].rid)
    if name == "run_batch_device":
        return out.clone()
    return out


def record_calls(eng, fm) -> dict:
    """Route every call that does device work on ``eng`` (a
    ``DecodeEngine``, or None) and ``fm`` (``PhysicalFM.run_batch_device``)
    through a recorder: each call's arguments, what it returned (a join's
    slot, the streams a ``step_chunk`` retired with their tokens and status,
    a copy of the pooled features on the device) and the kernel launches it
    made, in order. ``rec["unwrap"]()`` takes the recorder out."""
    from repro_torch.kernels import ops
    rec = {"calls": []}

    def wrap(obj, target, name):
        orig = getattr(obj, name)

        def recorded(*a, **kw):
            before = dict(ops.LAUNCHES)
            out = orig(*a, **kw)
            rec["calls"].append((target, name, a, kw, call_summary(name, out), {
                k: n - before.get(k, 0) for k, n in ops.LAUNCHES.items()
                if n != before.get(k, 0)}))
            return out
        setattr(obj, name, recorded)
    targets = [(fm, "fm", ("run_batch_device",))]
    if eng is not None:
        targets.append((eng, "eng", ENGINE_CALLS))
    for obj, target, names in targets:
        for name in names:
            wrap(obj, target, name)

    def unwrap():
        for obj, _, names in targets:
            for name in names:
                obj.__dict__.pop(name, None)
    rec["unwrap"] = unwrap
    return rec


def replay_eager(rec, fm, eng, engine_kwargs) -> dict:
    """The calls ``record_calls`` recorded, in order, under
    ``graphs.disabled()`` on the same FM and (for engine calls) a fresh
    ``DecodeEngine`` of the same configuration: the graphed run against
    eager. Greedy tokens must be equal stream by stream and position by
    position (every join's slot and every retired stream's tokens and
    status), the launches of every call equal per kernel, the engines'
    ``compile_count`` equal and the FM's unchanged, and every page and state
    slot free at the end on both sides. Pooled features are compared bit
    for bit; where a forward differs, its max |diff| and relative L2 are
    reported and bounded by the reference phases' 2e-2 (cuBLAS may pick
    another algorithm under capture)."""
    import torch

    from repro_torch.core import graphs
    from repro_torch.core.decode_engine import DecodeEngine
    from repro_torch.kernels import ops
    rec["unwrap"]()
    e2 = DecodeEngine(fm, **engine_kwargs) if eng is not None else None
    if eng is not None and eng._fn_rescale is not None:
        e2._rescale_fn()           # made before the run, as on the graphed side
    fm_keys = fm.compile_count()
    bad, tokens, pooled_diff = [], 0, []
    launches_g: dict = {}
    launches_e: dict = {}
    t0 = time.perf_counter()
    with graphs.disabled():
        for i, (target, name, a, kw, want, delta) in enumerate(rec["calls"]):
            obj = e2 if target == "eng" else fm
            before = dict(ops.LAUNCHES)
            out = getattr(obj, name)(*a, **kw)
            got = {k: n - before.get(k, 0) for k, n in ops.LAUNCHES.items()
                   if n != before.get(k, 0)}
            for k, n in delta.items():
                launches_g[k] = launches_g.get(k, 0) + n
            for k, n in got.items():
                launches_e[k] = launches_e.get(k, 0) + n
            if got != delta:
                bad.append((i, name, "launches", delta, got))
            if name == "run_batch_device":
                if not torch.equal(out, want):
                    d = (out.float() - want.float())
                    pooled_diff.append({
                        "call": i, "max_abs": d.abs().max().item(),
                        "rel_l2": (d.norm() / want.float().norm()).item()})
                continue
            out = call_summary(name, out)
            if name == "step_chunk":
                tokens += sum(len(t) for _, t, _ in out)
            if out != want:
                bad.append((i, name, "result", want, out))
    torch.cuda.synchronize()
    n_pooled = sum(1 for c in rec["calls"] if c[1] == "run_batch_device")
    out = {"calls": len(rec["calls"]), "eager_s": time.perf_counter() - t0,
           "mismatches": [str(b)[:300] for b in bad[:5]],
           "tokens_compared": tokens, "launches_graphed": launches_g,
           "launches_eager": launches_e, "pooled_forwards": n_pooled,
           "pooled_bit_equal": n_pooled - len(pooled_diff),
           "pooled_max_rel_l2": max((d["rel_l2"] for d in pooled_diff),
                                    default=0.0),
           "pooled_diffs": pooled_diff[:5], "fm_keys": [fm_keys,
                                                        fm.compile_count()]}
    ok = not bad and launches_g == launches_e and fm.compile_count() == fm_keys
    ok &= out["pooled_max_rel_l2"] <= 2e-2
    if eng is not None:
        out["engine_keys"] = [eng.compile_count(), e2.compile_count()]
        leak = [e.free_page_count() != e.total_pages - 1
                or bool(e._page_refs.any()) if e.paged else False
                for e in (eng, e2)]
        leak += [bool(e.state_pool.slots_in_use()) for e in (eng, e2)
                 if e.state_pool is not None]
        out["leak"] = any(leak) or bool(e2.active_count() or e2.pending)
        ok &= eng.compile_count() == e2.compile_count() and not out["leak"]
    out["ok"] = bool(ok)
    return out


def graphed_against_eager(stats, rec, fm, eng, loop, mem) -> bool:
    """Add a serving phase's graph report to ``stats`` (its keys with
    their capture times, the device memory reserved before and after the
    warm-up that captured them, and the recorded calls replayed eagerly:
    ``replay_eager``) and say whether it holds: every key called twice is
    captured and the eager replay agrees."""
    keys = graph_keys(eng, fm)
    replay = replay_eager(rec, fm, eng, loop.engine_kwargs if loop else {})
    stats["graphs"] = {"memory_reserved_mb": [m / 2**20 for m in mem],
                       "uncaptured": keys["uncaptured"], "keys": keys["keys"],
                       "eager_replay": replay}
    if keys["uncaptured"] or not replay["ok"]:
        log(f"graphs: uncaptured {keys['uncaptured']}, eager replay "
            f"{json.dumps(replay, default=float)[:2000]}")
    return not keys["uncaptured"] and replay["ok"]


def graph_keys(eng, fm) -> dict:
    """Every executable of ``eng`` and ``fm`` by shape key: calls, whether
    it is captured, its capture's host ms and its kernel launches per
    replay; ``uncaptured``: keys called twice or more that hold no graph
    (none may)."""
    exes = []
    if eng is not None:
        for plane, fns in (("prefill", eng._fn_prefill),
                           ("decode", eng._fn_decode),
                           ("write", eng._fn_write)):
            exes += [(f"{plane} {k}", e) for k, e in fns.items()]
        for name in ("rescale", "gather", "page_restore", "slot_restore"):
            if getattr(eng, f"_fn_{name}") is not None:
                exes.append((name, getattr(eng, f"_fn_{name}")))
    for k, fns in fm._fn_cache.items():
        exes += [(f"forward {k} len {n}", e) for n, e in fns.items()]
    return {"keys": {name: {"calls": e.calls, "captured": e.captured,
                            "capture_ms": None if e.capture_s is None
                            else 1e3 * e.capture_s,
                            "launches": e.launches} for name, e in exes},
            "uncaptured": [name for name, e in exes
                           if e.calls >= 2 and not e.captured]}


# ---------------- phase 4/5: serving at full width ----------------

def stack_kernels(eng, decode_kernel: str) -> tuple:
    """The kernels a served stack must launch: K1, K2, its pool's decode
    kernel and rmsnorm where it has attention, rmsnorm alone where it has
    none (xlstm-125m)."""
    if eng.plan.has_attention:
        return ("segmented_lora", decode_kernel, "flash_attention", "rmsnorm")
    return ("rmsnorm",)


def state_slots_drained(eng) -> bool:
    """Every state slot of a stack with fixed per-slot state is free at the
    end, each allocation freed once, and no more than the slots were ever
    in use; True for a stack without (the attention-only pools)."""
    sp = eng.state_pool
    if sp is None:
        return True
    return (sp.in_use_count() == 0 and sp.allocs == sp.frees
            and 0 < sp.peak_in_use <= eng.num_slots)


def build_server(dev, cfg=None, input_len=PROMPT_LEN, prompt_len=PROMPT_LEN,
                 max_new=MAX_NEW, **engine_kwargs):
    """Full-width ``cfg`` (default stablelm-1.6b) behind ``FMplexServer``
    with 4 tasks (random rank-16 q/v adapters, linear heads) and its serve
    loop (8 slots, chunk 4); pooled requests carry ``input_len`` rows."""
    import numpy as np
    import torch

    from repro_torch.core.physical import PhysicalFM
    from repro_torch.core.server import FMplexServer
    from repro_torch.core.vfm import TaskExtensions
    cfg = cfg or full_config()
    t0 = time.perf_counter()
    fm = PhysicalFM(cfg, seed=0, lora_rank=RANK, input_len=input_len,
                    lora_impl="segmented", seg_block_t=BLOCK_T, device=dev)
    torch.cuda.synchronize()
    log(f"model: {cfg.name} full width, {cfg.num_layers} layers"
        f"{f' + {cfg.encoder_layers} encoder layers' if cfg.encoder_layers else ''}, "
        f"{sum(t.numel() for t in _leaves(fm.params)) / 1e9:.3f} B params, "
        f"built in {time.perf_counter() - t0:.1f} s")
    srv = FMplexServer("s0")
    srv.deploy_fm("fm0", fm, scheduler="bfq")
    rng = np.random.RandomState(0)
    for i in range(N_TASKS):
        fm.adapters.add(f"lora{i}", random_adapter(fm.adapters, i, dev))
        w = torch.as_tensor(rng.randn(cfg.d_model, 8).astype(np.float32) * 0.02,
                            device=dev)
        head = (lambda ww: (lambda f: torch.as_tensor(f, device=ww.device).float() @ ww))(w)
        srv.bind_task(f"task{i}", "fm0", weight=1.0 + i,
                      extensions=TaskExtensions(decoder=head,
                                                adapter_id=f"lora{i}"))
    loop = srv.serve_loop("fm0", engine_kwargs=dict(
        num_slots=SLOTS, prompt_len=prompt_len, max_new=max_new, chunk=CHUNK,
        **engine_kwargs))
    return srv, cfg, fm, loop


def _leaves(tree):
    from repro_torch.models.common import tree_leaves
    return tree_leaves(tree)


def mixed_trace(cfg, seed: int = 7):
    """Pooled feature requests from every task and generative requests
    (prompts uniform in 2..128 tokens, 32 new tokens) over ~1.5 s."""
    import numpy as np

    from repro_torch.core.request import Request
    rng = np.random.RandomState(seed)
    trace = []
    for i in range(48):
        trace.append(Request(f"task{i % N_TASKS}", 0.03 * i,
                             payload=rng.randn(PROMPT_LEN, cfg.d_model)
                             .astype(np.float32)))
    for i in range(24):
        plen = int(rng.randint(2, PROMPT_LEN + 1))
        trace.append(Request(f"task{(i + 1) % N_TASKS}", 0.005 + 0.06 * i,
                             payload=rng.randint(0, cfg.vocab_size, plen)
                             .astype(np.int32),
                             tokens=float(plen + MAX_NEW),
                             max_new_tokens=MAX_NEW))
    return trace


def phase_serving(dev, cfg=None):
    """Full-width serving of ``cfg`` (default stablelm-1.6b) on the dense
    int8 pool; see the module docstring for what must hold."""
    import numpy as np
    import torch

    from repro_torch.core.physical import BUCKETS
    from repro_torch.kernels import ops
    from repro_torch.serving.metrics import decode_stats, latency_stats
    name = "serving" if cfg is None else f"{cfg.name} serving"
    srv, cfg, fm, loop = build_server(dev, cfg)
    eng = srv.decode_engine("fm0", **loop.engine_kwargs)
    rec = record_calls(eng, fm)
    mem0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    loop.warmup(pooled_task="task0", gen_task="task1", pooled_n=BUCKETS[-1])
    torch.cuda.synchronize()
    log(f"{name} warmup: {time.perf_counter() - t0:.1f} s")
    mem1 = torch.cuda.memory_reserved()
    keys0 = (eng.compile_count(), fm.compile_count())
    trace = mixed_trace(cfg)
    ops.reset_launches()
    t0 = time.perf_counter()
    loop.run(trace, max_wall=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: int(ops.LAUNCHES[k])
                for k in ("segmented_lora", "decode_attention_int8",
                          "flash_attention", "rmsnorm")}
    bodies = ops.bodies()
    gen = [r for r in trace if r.max_new_tokens > 0]
    pooled = [r for r in trace if r.max_new_tokens <= 0]
    ok = state_slots_drained(eng)
    bad = [r for r in trace if not r.ok or r.finish_time is None
           or r.result is None]
    if bad:
        ok = False
        log(f"{name}: {len(bad)} requests did not finish ok: "
            f"{[(r.rid, r.status) for r in bad[:5]]}")
    short = [r for r in gen if r.result is None or len(r.result) != r.max_new_tokens]
    nonfinite = [r for r in pooled
                 if r.result is None or not np.all(np.isfinite(r.result))]
    ok &= not short and not nonfinite and eng.quarantines == 0
    ok &= all(launches[k] > 0 for k in stack_kernels(eng, "decode_attention_int8"))
    keys1 = (eng.compile_count(), fm.compile_count())
    ok &= keys1 == keys0
    ds = decode_stats(gen)
    ls = latency_stats(pooled)
    n_tok = sum(len(r.result) for r in gen if r.result is not None)
    stats = {
        "card": smi_line(),
        "wall_s": wall, "requests": len(trace), "generative": len(gen),
        "pooled": len(pooled), "tokens": n_tok, "tokens_per_s": n_tok / wall,
        "ttft_p50_ms": ds.get("ttft_p50_ms"), "tpot_p50_ms": ds.get("tpot_p50_ms"),
        "pooled_p50_ms": ls.get("p50_ms"), "launches": launches,
        "bodies": bodies,
        "ticks": dict(loop.ticks), "decode_steps": eng.steps,
        "quarantines": eng.quarantines, "shape_keys": [keys0, keys1],
        "state_slots": None if eng.state_pool is None else dict(
            eng.state_pool.gauges(), allocs=eng.state_pool.allocs,
            frees=eng.state_pool.frees),
    }
    ok &= graphed_against_eager(stats, rec, fm, eng, loop, (mem0, mem1))
    log(f"{name}: " + json.dumps(stats, default=float))
    if short or nonfinite:
        log(f"{name}: short streams {len(short)}, non-finite pooled {len(nonfinite)}")
    if keys1 != keys0:
        log(f"{name}: new shape keys after warmup {keys0} -> {keys1}")
    return ok, stats, (srv, fm, eng)


def paged_trace(cfg, seed: int = 11):
    """Pooled feature requests from every task, long-tail generative streams
    (prompts 16-128 tokens, 8-32 new tokens) and shared-prefix streams on
    one adapter (80% carry one 64-token prefix: 4 full pages to map), all
    arriving within ~1.5 s."""
    import numpy as np

    from repro_torch.core.request import Request
    from repro_torch.serving import loadgen
    rng = np.random.RandomState(seed)
    pooled = [Request(f"task{i % N_TASKS}", 0.06 * i,
                      payload=rng.randn(PROMPT_LEN, cfg.d_model)
                      .astype(np.float32)) for i in range(24)]
    tail = loadgen.long_tail_token_trace(
        "task1", 8.0, 1.5, prompt_len=PROMPT_LEN, vocab=cfg.vocab_size,
        new_lo=8, new_hi=MAX_NEW, seed=seed, min_prompt_len=16)
    shared = loadgen.shared_prefix_token_trace(
        "task2", 8.0, 1.5, prefix_len=64, prompt_len=PROMPT_LEN,
        vocab=cfg.vocab_size, shared_frac=0.8, n_prefixes=1,
        max_new=MAX_NEW, seed=seed + 1)
    return loadgen.merge([pooled, tail, shared])


def paged_burst(cfg, eng) -> dict:
    """Twelve joins straight into the engine at once (``DecodeEngine.join``
    then ``drain``, the engine's own surface): 96-token prompts, 32 new
    tokens each. Six admit (the gate prices each at its 8-page bucket plus
    a chunk of headroom for it and every live stream), the rest DEFER; the
    six grow from 6 to 9 pages each, past the 44 usable pages, so the
    youngest are PREEMPTED and resume. The serve loop's memory gate keeps
    its own admissions out of both paths on purpose, so the loop's trace
    alone need not drive them."""
    import numpy as np
    rng = np.random.RandomState(13)
    before = (eng.deferrals, eng.preemptions)
    n = 12
    for i in range(n):
        eng.join(f"task{i % N_TASKS}",
                 rng.randint(0, cfg.vocab_size, 96).astype(np.int32),
                 adapter_id=f"lora{i % N_TASKS}", max_new_tokens=MAX_NEW,
                 rid=-1000 - i)
    done = eng.drain()
    return {"joins": n,
            "finished": sum(1 for d in done if d.rid <= -1000 and d.status
                            == "ok" and len(d.tokens) == MAX_NEW),
            "deferrals": eng.deferrals - before[0],
            "preemptions": eng.preemptions - before[1]}


def prefix_pair(cfg, eng) -> int:
    """Two joins straight into the engine on one adapter whose prompts
    share a 64-token prefix (4 full pages), the second joined once the
    first is admitted: it maps the first's pages, whatever the serve
    loop's admission batches did (a prefix registers after its admission's
    prefill, so sharers admitted in one batch do not hit each other, and
    how requests batch follows the model's speed). Returns the prefix hits
    the pair made."""
    import numpy as np
    rng = np.random.RandomState(17)
    prefix = rng.randint(0, cfg.vocab_size, 64)
    before = eng.prefix_hits
    for i in range(2):
        eng.join("task2", np.concatenate([
            prefix, rng.randint(0, cfg.vocab_size, 16)]).astype(np.int32),
            adapter_id="lora2", max_new_tokens=8, rid=-2000 - i)
    eng.drain()
    return eng.prefix_hits - before


def phase_paged_serving(dev, chunked: bool = False, cfg=None):
    """Full-width serving of ``cfg`` (default stablelm-1.6b) on the paged
    pool (PAGED_KW; ``chunked``: with chunked shared-prefix prefill, the
    engine's default); see the module docstring for what must hold."""
    import numpy as np
    import torch

    from repro_torch.core.physical import BUCKETS
    from repro_torch.kernels import ops
    from repro_torch.serving.metrics import (decode_stats, latency_stats,
                                             mixed_stats, page_gauges)
    name = "chunked serving" if chunked else "paged serving"
    family = cfg is not None
    if family:
        name = f"{cfg.name} {name}"
    srv, cfg, fm, loop = build_server(
        dev, cfg, **dict(PAGED_KW, chunked_prefill=chunked))
    with warnings.catch_warnings(record=True) as demoted:
        warnings.simplefilter("always")
        eng = srv.decode_engine("fm0", **loop.engine_kwargs)
    rec = record_calls(eng, fm)
    mem0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    loop.warmup(pooled_task="task0", gen_task="task1", pooled_n=BUCKETS[-1])
    eng._rescale_fn()          # the refresh's one key, made on first use
    torch.cuda.synchronize()
    log(f"{name} warmup: {time.perf_counter() - t0:.1f} s")
    mem1 = torch.cuda.memory_reserved()
    keys0 = (eng.compile_count(), fm.compile_count())
    trace = paged_trace(cfg)
    n_miss0 = len(loop.ttft_miss_samples)       # the warmup's requests
    ops.reset_launches()
    t0 = time.perf_counter()
    loop.run(trace, max_wall=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    loop_hits = eng.prefix_hits
    burst = None if chunked else paged_burst(cfg, eng)
    pair = None if chunked else prefix_pair(cfg, eng)
    launches = {k: int(ops.LAUNCHES[k])
                for k in ("segmented_lora", "paged_decode_attention",
                          "flash_attention", "rmsnorm")}
    bodies = ops.bodies()
    hybrid = eng.plan.has_recurrent
    gen = [r for r in trace if r.max_new_tokens > 0]
    pooled = [r for r in trace if r.max_new_tokens <= 0]
    bad = [r for r in trace if not r.ok or r.finish_time is None
           or r.result is None]
    short = [r for r in gen if r.result is None
             or len(r.result) != min(r.max_new_tokens, MAX_NEW)]
    nonfinite = [r for r in pooled
                 if r.result is None or not np.all(np.isfinite(r.result))]
    gauges = page_gauges(eng)
    leak = eng.free_page_count() != eng.total_pages - 1 \
        or bool(eng._page_refs.any())
    ds = decode_stats(gen)
    ls = latency_stats(pooled)
    n_tok = sum(len(r.result) for r in gen if r.result is not None)
    stats = {
        "card": smi_line(),
        "wall_s": wall, "requests": len(trace), "generative": len(gen),
        "pooled": len(pooled), "tokens": n_tok, "tokens_per_s": n_tok / wall,
        "ttft_p50_ms": ds.get("ttft_p50_ms"),
        "tpot_p50_ms": ds.get("tpot_p50_ms"),
        "pooled_p50_ms": ls.get("p50_ms"), "launches": launches,
        "bodies": bodies,
        "ticks": dict(loop.ticks), "decode_steps": eng.steps,
        "quarantines": eng.quarantines, "page_gauges": gauges,
        "occupancy_max": max(loop.page_samples, default=0.0),
        "shape_keys": [keys0, (eng.compile_count(), fm.compile_count())],
    }
    ok = not bad and not short and not nonfinite and not leak
    ok &= eng.quarantines == 0 and state_slots_drained(eng)
    ok &= all(launches[k] > 0
              for k in stack_kernels(eng, "paged_decode_attention"))
    stats["prefix_hits"] = {"loop": loop_hits, "pair": pair}
    if hybrid:
        # a stack with recurrent state: prefix sharing, chunked prefill,
        # speculation and the spill tier demote (reported), a preempted
        # stream re-prefills its folded prompt (no spill tier to resume
        # from), and every state slot comes back
        stats["demotions"] = {
            "warnings": [str(w.message)[:90] for w in demoted],
            "prefix_sharing": eng.prefix_sharing,
            "chunked_prefill": eng.chunked_prefill, "spec_k": eng.spec_k,
            "spill": eng.spill is not None}
        stats["state_slots"] = dict(eng.state_pool.gauges(),
                                    allocs=eng.state_pool.allocs,
                                    frees=eng.state_pool.frees)
        ok &= not eng.prefix_sharing and eng.spill is None
        ok &= eng.prefix_hits == 0 and burst["preemptions"] >= 1
    else:
        # stablelm's trace shares prefixes through the loop; another
        # model's speed batches its admissions otherwise, and there the
        # direct pair (stablelm's too) shows the sharing
        ok &= (loop_hits >= 1 or family) and (chunked or pair == 1)
    ok &= stats["shape_keys"][1] == keys0
    if chunked:
        stats["ttft_split"] = mixed_stats(trace, ttft_split={
            "hit": loop.ttft_hit_samples,
            "miss": loop.ttft_miss_samples[n_miss0:]}).get("ttft_split")
        ok &= eng.prefill_tokens_saved > 0 and bool(loop.ttft_hit_samples)
    else:
        stats["burst"] = burst
        ok &= eng.deferrals + eng.preemptions >= 1
        ok &= burst["finished"] == burst["joins"]
    ok &= graphed_against_eager(stats, rec, fm, eng, loop, (mem0, mem1))
    log(f"{name}: " + json.dumps(stats, default=float))
    if not ok:
        log(f"{name}: not ok {[(r.rid, r.status) for r in bad[:5]]}, "
            f"short {len(short)}, non-finite pooled {len(nonfinite)}, "
            f"leak {leak}, prefix hits {eng.prefix_hits}, tokens saved "
            f"{eng.prefill_tokens_saved}, deferrals {eng.deferrals}, "
            f"preemptions {eng.preemptions}")
    return ok, stats, (srv, fm, eng)


W_PROMPT_LEN, W_MAX_NEW, W_PAGE_SIZE = 64, 64, 16


def whisper_trace(cfg, seed: int = 23):
    """Whisper traffic within ~1 s: 8 pooled requests of 1500 random frames
    each (audio-clip features through the encoder and a BOS-only decoder),
    and 16 transcription streams, each with its own 1500 frames, a prompt
    of 4-64 tokens (start-of-transcript tokens plus a previous-text prompt)
    and a budget of 32-64 new tokens."""
    import numpy as np

    from repro_torch.core.request import Request
    rng = np.random.RandomState(seed)
    trace = [Request(f"task{i % N_TASKS}", 0.12 * i,
                     payload=(rng.randn(ENC_LEN, cfg.d_model) * 0.5)
                     .astype(np.float32)) for i in range(8)]
    for i in range(16):
        plen = int(rng.randint(4, W_PROMPT_LEN + 1))
        n_new = int(rng.randint(32, W_MAX_NEW + 1))
        r = Request(f"task{(i + 1) % N_TASKS}", 0.003 + 0.06 * i,
                    payload=rng.randint(0, cfg.vocab_size, plen)
                    .astype(np.int32), tokens=float(plen + n_new),
                    max_new_tokens=n_new)
        r.enc_feats = (rng.randn(ENC_LEN, cfg.d_model) * 0.5).astype(
            np.float32)
        trace.append(r)
    return trace


def phase_whisper_serving(dev):
    """Full-width whisper-base (6 + 6 layers, random weights from a seed)
    through ``FMplexServer``/``ServeLoop.run`` on the paged int8 pool (8
    slots, pages of 16; prefix sharing demotes on this stack): 1500-frame
    cross state per slot, written at admission. Every request must finish
    ok with its token budget (pooled: finite features), K5, K4, K2 and K1
    must launch in the run, no stream may be quarantined, and every state
    slot and page must be free at the end."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving.metrics import (decode_stats, latency_stats,
                                             page_gauges)
    srv, cfg, fm, loop = build_server(
        dev, cfg=whisper_config(), input_len=ENC_LEN,
        prompt_len=W_PROMPT_LEN, max_new=W_MAX_NEW, enc_len=ENC_LEN,
        paged=True, page_size=W_PAGE_SIZE)
    eng = srv.decode_engine("fm0", **loop.engine_kwargs)
    rec = record_calls(eng, fm)
    mem0 = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    loop.warmup(pooled_task="task0", gen_task="task1", pooled_n=8)
    eng._rescale_fn()          # the refresh's one key, made on first use
    torch.cuda.synchronize()
    log(f"whisper serving warmup: {time.perf_counter() - t0:.1f} s")
    mem1 = torch.cuda.memory_reserved()
    keys0 = (eng.compile_count(), fm.compile_count())
    trace = whisper_trace(cfg)
    ops.reset_launches()
    t0 = time.perf_counter()
    loop.run(trace, max_wall=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: int(ops.LAUNCHES[k])
                for k in ("segmented_lora", "flash_attention",
                          "decode_attention", "paged_decode_attention",
                          "rmsnorm")}
    bodies = ops.bodies()
    gen = [r for r in trace if r.max_new_tokens > 0]
    pooled = [r for r in trace if r.max_new_tokens <= 0]
    bad = [r for r in trace if not r.ok or r.finish_time is None
           or r.result is None]
    short = [r for r in gen if r.result is None
             or len(r.result) != r.max_new_tokens]
    nonfinite = [r for r in pooled
                 if r.result is None or not np.all(np.isfinite(r.result))]
    leak = eng.free_page_count() != eng.total_pages - 1 \
        or bool(eng._page_refs.any()) or bool(eng.state_pool.slots_in_use())
    ds = decode_stats(gen)
    ls = latency_stats(pooled)
    n_tok = sum(len(r.result) for r in gen if r.result is not None)
    stats = {
        "card": smi_line(), "wall_s": wall, "requests": len(trace),
        "generative": len(gen), "pooled": len(pooled), "tokens": n_tok,
        "tokens_per_s": n_tok / wall, "ttft_p50_ms": ds.get("ttft_p50_ms"),
        "tpot_p50_ms": ds.get("tpot_p50_ms"),
        "pooled_p50_ms": ls.get("p50_ms"), "launches": launches,
        "bodies": bodies,
        "ticks": dict(loop.ticks), "decode_steps": eng.steps,
        "quarantines": eng.quarantines, "page_gauges": page_gauges(eng),
        "prefix_sharing": eng.prefix_sharing,
        "shape_keys": [keys0, (eng.compile_count(), fm.compile_count())],
    }
    ok = not bad and not short and not nonfinite and not leak
    ok &= eng.quarantines == 0 and all(v > 0 for v in launches.values())
    ok &= not eng.prefix_sharing and eng.state_pool.allocs >= len(gen)
    ok &= stats["shape_keys"][1] == keys0
    ok &= graphed_against_eager(stats, rec, fm, eng, loop, (mem0, mem1))
    ok_tf, stats["teacher_forced"] = whisper_teacher_forced(dev)
    log("whisper serving: " + json.dumps(stats, default=float))
    if not ok:
        log(f"whisper serving: not ok {[(r.rid, r.status) for r in bad[:5]]}"
            f", short {len(short)}, non-finite pooled {len(nonfinite)}, "
            f"leak {leak}")
    return ok and ok_tf, stats, (srv, fm, eng)


def record_streams(eng, log: dict, teacher: dict = None):
    """Route ``eng``'s sampler through a recorder (before any of its plane
    functions exists: each captures the sampler when it is built). Every
    sampler call's f32 logits go into ``log`` under (rid, position) for
    each live row: an admission prefill (one row) at the stream's position
    (0, or a resumed stream's generated count), a decode chunk's rows at
    each slot's generated count plus the step within the chunk. Greedy when
    ``teacher`` is None; otherwise every row is fed ``teacher``'s argmax at
    the same (rid, position), so two runs that schedule the same streams
    differently compare position by position."""
    import torch
    cur = {}
    admit, decode_fn = eng._admit_now, eng._decode_fn

    def admit_now(req):
        cur["adm"] = (req.rid, 0 if req.resume is None
                      else len(req.resume.tokens))
        try:
            return admit(req)
        finally:
            cur.pop("adm", None)

    def dfn(cap, chunk):
        run = decode_fn(cap, chunk)

        def counted(*a, **kw):
            cur["step"] = 0
            return run(*a, **kw)
        return counted

    def sample(logits, gens):
        host = logits.float().cpu()
        if "adm" in cur:
            keys = [cur["adm"]]
        else:
            keys = [None if sl is None or sl.done else
                    (sl.rid, len(sl.tokens) + cur["step"]) for sl in eng.slots]
            cur["step"] += 1
        tok = host.argmax(-1)
        for i, key in enumerate(keys):
            if key is None:
                continue
            log[key] = host[i]
            if teacher is not None and key in teacher:
                tok[i] = teacher[key].argmax()
        return tok.to(torch.int32).to(logits.device), gens
    eng._admit_now, eng._decode_fn, eng._sample = admit_now, dfn, sample


# (prompt tokens, new tokens) of the teacher-forced whisper streams
W_TF_STREAMS = ((7, 12), (20, 10), (37, 12))


def whisper_teacher_forced(dev):
    """Three whisper streams served through the loop on the card, on
    full-width whisper-base with q/k at the real fan-in (``fan_in_qk``; the
    package's init makes attention over 1500 frames nearly one-hot, where
    the card and the CPU drift 0.40 apart, see ``phase_reference_whisper``),
    on the paged int8 pool, each with its own frames and adapter; held
    teacher-forced against the same streams through the port's engine on
    the CPU (the plain versions), position by position: relative L2 of the
    logits at most 6e-2 (``phase_reference_whisper``'s bound), greedy tokens
    equal wherever the CPU's top-2 gap exceeds twice the largest
    difference, and every generated position compared. Eager on both sides
    (``graphs.disabled()``): the recorder reads every sampler call's logits
    on the host."""
    import numpy as np
    import torch

    from repro_torch.core import graphs
    from repro_torch.core.decode_engine import DecodeEngine
    from repro_torch.core.physical import PhysicalFM
    from repro_torch.core.request import Request
    from repro_torch.models.common import tree_map
    srv, cfg, fm, loop = build_server(
        dev, cfg=whisper_config(), input_len=ENC_LEN,
        prompt_len=W_PROMPT_LEN, max_new=W_MAX_NEW, enc_len=ENC_LEN,
        paged=True, page_size=W_PAGE_SIZE)
    fan_in_qk(fm.params, cfg)
    glog, clog = {}, {}
    record_streams(srv.decode_engine("fm0", **loop.engine_kwargs), glog)
    rng = np.random.RandomState(29)
    trace = []
    for i, (plen, n_new) in enumerate(W_TF_STREAMS):
        r = Request(f"task{i}", 0.01 * i, payload=rng.randint(
            0, cfg.vocab_size, plen).astype(np.int32),
            tokens=float(plen + n_new), max_new_tokens=n_new)
        r.enc_feats = (rng.randn(ENC_LEN, cfg.d_model) * 0.5).astype(
            np.float32)
        trace.append(r)
    with graphs.disabled():
        loop.run(trace, max_wall=300)
    torch.cuda.synchronize()
    cfm = PhysicalFM(cfg, lora_rank=RANK, input_len=ENC_LEN,
                     lora_impl="segmented", seg_block_t=BLOCK_T, device="cpu",
                     params=tree_map(lambda t: t.cpu(), fm.params))
    for aid, tree in zip(fm.adapters.ids, fm.adapters._trees):
        cfm.adapters.add(aid, tree_map(lambda t: t.cpu(), tree))
    ceng = DecodeEngine(cfm, **loop.engine_kwargs)
    record_streams(ceng, clog, teacher=glog)
    for r in trace:
        ceng.join(r.task_id, r.payload, rid=r.rid, enc_feats=r.enc_feats,
                  adapter_id=srv.vfms[r.task_id].extensions.adapter_id,
                  max_new_tokens=r.max_new_tokens)
    ceng.drain()
    want = {(r.rid, t) for r in trace for t in range(r.max_new_tokens)}
    keys = sorted(want & set(glog) & set(clog))
    out = drift(torch.stack([glog[k] for k in keys]),
                torch.stack([clog[k] for k in keys]))
    out.update(streams=len(trace), positions=len(keys), expected=len(want),
               served=[bool(r.ok and r.result is not None
                            and len(r.result) == r.max_new_tokens)
                       for r in trace])
    log("whisper teacher-forced streams: " + json.dumps(out))
    ok = (out["finite"] and out["rel_l2"] <= 6e-2 and out["argmax_agree"]
          and len(keys) == len(want) and all(out["served"]))
    return ok, out


def moment_config(**over):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOMENT), **over)


def phase_reference_moment(dev):
    """A two-layer cut of full-width moment-large (d 1024, 16 heads of 64,
    bidirectional) with 3 random rank-16 adapters: ``backbone_features`` of
    4 requests of 32 patches, and ``run_batch`` of the same requests with
    mixed adapters and a "no adapter" row under each LoRA impl, through the
    kernels on the card (K2 not causal, K1 under "segmented"), held against
    the same weights with the plain versions on the CPU. Both sides round
    bf16 activations after matmuls summed in different orders: bound,
    relative L2 at most 2e-2 (the port's CPU parity bound for hidden states,
    tests/test_torch_models.py). Planted check that the mask is not causal:
    changing the last patch moves the first position's features on the card
    (relative L2) by more than 10x the features' GPU-CPU drift; under a
    causal mask they would not move at all."""
    import numpy as np
    import torch

    from repro_torch.core.physical import PhysicalFM
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    cfg = moment_config(num_layers=2)
    gfm = PhysicalFM(cfg, seed=5, lora_rank=RANK, input_len=MOMENT_LEN,
                     lora_impl="segmented", seg_block_t=BLOCK_T, device=dev)
    cfm = PhysicalFM(cfg, lora_rank=RANK, input_len=MOMENT_LEN,
                     lora_impl="segmented", seg_block_t=BLOCK_T, device="cpu",
                     params=tree_map(lambda t: t.cpu(), gfm.params))
    for i in range(3):
        tree = random_adapter(gfm.adapters, i, dev)
        gfm.adapters.add(f"a{i}", tree)
        cfm.adapters.add(f"a{i}", tree_map(lambda t: t.cpu(), tree))
    rng = np.random.RandomState(31)
    x = rng.randn(4, MOMENT_LEN, cfg.d_model).astype(np.float32)
    aidx = np.array([0, 2, gfm.adapters.capacity(), 1], np.int32)

    def feats(fm, embeds):
        return lm.backbone_features(fm.params, cfg, torch.as_tensor(
            embeds, device=fm.device)).float().cpu()
    report = {}
    ops.reset_launches()
    g = feats(gfm, x)
    report["backbone_features"] = drift(g.flatten(0, 1), feats(cfm, x)
                                        .flatten(0, 1))
    report["backbone_features"]["flash_attention_launches"] = int(
        ops.LAUNCHES["flash_attention"])
    for impl in ("segmented", "gather"):
        gfm.lora_impl = cfm.lora_impl = impl
        ops.reset_launches()
        gr = torch.as_tensor(gfm.run_batch(x, aidx))
        r = report[f"run_batch_{impl}"] = drift(
            gr, torch.as_tensor(cfm.run_batch(x, aidx)))
        r["launches"] = {k: int(ops.LAUNCHES[k]) for k in (
            "segmented_lora", "flash_attention")}
        r["rmsnorm_launches"] = int(ops.LAUNCHES["rmsnorm"])
    x2 = x.copy()
    x2[:, -1] += 1.0
    moved = feats(gfm, x2)[:, 0] - g[:, 0]
    report["first_position_moved_by_last_patch"] = {
        "max_abs": moved.abs().max().item(),
        "rel_l2": (moved.norm() / g[:, 0].norm()).item()}
    log("moment reference: 2-layer full-width moment-large, 4 requests x "
        f"{MOMENT_LEN} patches, GPU vs CPU: " + json.dumps(report))
    ok = all(report[k]["finite"] and report[k]["rel_l2"] <= 2e-2 for k in (
        "backbone_features", "run_batch_segmented", "run_batch_gather"))
    ok &= report["backbone_features"]["flash_attention_launches"] == 2
    ok &= report["run_batch_segmented"]["launches"] == {
        "segmented_lora": 4, "flash_attention": 2}
    ok &= report["run_batch_gather"]["launches"] == {
        "segmented_lora": 0, "flash_attention": 2}
    ok &= all(report[f"run_batch_{impl}"]["rmsnorm_launches"] > 0
              for impl in ("segmented", "gather"))
    ok &= report["first_position_moved_by_last_patch"]["rel_l2"] > \
        10 * report["backbone_features"]["rel_l2"]
    return ok, report


MOMENT_TASKS, MOMENT_RPS, MOMENT_SECONDS = 4, 40.0, 5.0


def phase_moment_serving(dev):
    """Full-width moment-large (24 layers, random weights from a seed)
    through the port's launcher (``repro_torch.launch.serve``:
    ``build_server``, then ``run_load``): 4 tasks, Poisson arrivals at the
    launcher's 40 requests/s for 5 s, 32 patches a request, every batch
    bucket warmed first. Every request must finish ok with finite outputs,
    each pooled forward must launch 24 K2 and, where the table chose
    "segmented" for it, 48 K1 (q and v of 24 layers; none under "gather"),
    and no shape key may be added after warm-up. Prints what the launcher
    prints. Then ``python -m repro_torch.launch.serve`` with no flags, the
    user's entry point, must print ``served n/n``."""
    import numpy as np
    import torch

    from repro_torch.core.physical import BUCKETS
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launch
    t0 = time.perf_counter()
    srv, cfg = launch.build_server(MOMENT_TASKS, device=dev)
    fm = srv.fms["fm0"]
    prof = srv.profiles["fm0"]
    rec = record_calls(None, fm)
    mem0 = torch.cuda.memory_reserved()
    srv.serve_loop("fm0").warmup(pooled_n=BUCKETS[-1])
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_reserved()
    log(f"moment serving: built, calibrated and warmed in "
        f"{time.perf_counter() - t0:.1f} s; backbone={cfg.name} "
        f"layers={cfg.num_layers} d={cfg.d_model} l(1)={prof.l(1) * 1e3:.1f}ms "
        f"l({prof.b_max})={prof.l(prof.b_max) * 1e3:.1f}ms b_max={prof.b_max}")
    keys0 = fm.compile_count()
    chosen = []
    resolve = fm.resolve_lora_impl

    def recorded(rows, num_adapters=None):
        impl = resolve(rows, num_adapters)
        chosen.append(impl)
        return impl
    fm.resolve_lora_impl = recorded
    ops.reset_launches()
    t0 = time.perf_counter()
    reqs = launch.run_load(srv, cfg, rps=MOMENT_RPS, seconds=MOMENT_SECONDS,
                           n_tasks=MOMENT_TASKS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del fm.resolve_lora_impl
    launches = {k: int(ops.LAUNCHES[k])
                for k in ("segmented_lora", "flash_attention", "rmsnorm")}
    bodies = ops.bodies()
    s = launch.summary(srv, reqs, MOMENT_TASKS)
    bad = [r for r in reqs if not r.ok or r.result is None
           or not np.all(np.isfinite(r.result))]
    n_seg = chosen.count("segmented")
    stats = {
        "card": smi_line(), "wall_s": wall, "requests": len(reqs),
        "served": s["n"], "mean_ms": s.get("mean_ms"),
        "p50_ms": s.get("p50_ms"), "p99_ms": s.get("p99_ms"),
        "fairness": s["fairness"], "l1_ms": 1e3 * prof.l(1),
        "b_max": prof.b_max, "l_bmax_ms": 1e3 * prof.l(prof.b_max),
        "forwards": len(chosen), "segmented_forwards": n_seg,
        "launches": launches, "bodies": bodies,
        "shape_keys": [keys0, fm.compile_count()],
    }
    log(f"served {s['n']}/{len(reqs)} mean={s.get('mean_ms', float('nan')):.1f}ms "
        f"p99={s.get('p99_ms', float('nan')):.1f}ms "
        f"fairness={s['fairness']:.3f}")
    ok = bool(reqs) and not bad and s["n"] == len(reqs)
    ok &= launches["flash_attention"] == cfg.num_layers * len(chosen) > 0
    ok &= launches["segmented_lora"] == 2 * cfg.num_layers * n_seg
    ok &= launches["rmsnorm"] > 0
    ok &= fm.compile_count() == keys0
    ok &= graphed_against_eager(stats, rec, fm, None, None, (mem0, mem1))
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(
                             ROOT, "src")))
    lines = cli.stdout.strip().splitlines()
    stats["cli"] = {"rc": cli.returncode, "lines": lines,
                    "seconds": time.perf_counter() - t0}
    served = [ln for ln in lines if ln.startswith("served ")]
    n, _, total = served[-1].split()[1].partition("/") if served else ("", "", "")
    ok &= cli.returncode == 0 and bool(served) and n == total and int(n) > 0 \
        and f"layers={cfg.num_layers} d={cfg.d_model}" in cli.stdout
    log("moment serving: " + json.dumps(stats, default=float))
    if not ok:
        log(f"moment serving: not ok {[(r.rid, r.status) for r in bad[:5]]}; "
            f"cli stderr: {cli.stderr[-2000:]}")
    return ok, stats, (srv, fm, None)


# ---------------- phase 7: durability ----------------

SPILL_BYTES = 256 << 20          # the host arena of the durability checks
# a victim's entry (~12 MiB) and its own prompt pages (6 x 1.5 MiB), spilled
# right after it, outgrow this budget: the entry is evicted, a re-prefill
SMALL_SPILL_BYTES = 20 << 20
BURST_PROMPT = 96                # paged_burst's prompts
SAMPLED_PROMPT = 64              # 8 streams that all admit, then outgrow
RESTORE_AT = 3                   # chunks before a mid-flight snapshot


def durability_joins(cfg, seed: int, n: int = 12, plen: int = BURST_PROMPT):
    """``n`` joins of ``plen``-token prompts on the 4 adapters in turn."""
    import numpy as np
    rng = np.random.RandomState(seed)
    return [(f"task{i % N_TASKS}",
             rng.randint(0, cfg.vocab_size, plen).astype(np.int32),
             f"lora{i % N_TASKS}", -2000 - i) for i in range(n)]


def run_joins(eng, joins, pause=None, max_new: int = MAX_NEW):
    """Join every stream straight into ``eng`` (a paged pool defers what
    does not fit), then step until all retire. ``pause(eng, chunks)`` runs
    after every chunk and may return the engine to continue on (a restored
    one). Returns ({rid: tokens}, {rid: status}, the last engine)."""
    for task, prompt, aid, rid in joins:
        eng.join(task, prompt, adapter_id=aid, max_new_tokens=max_new,
                 rid=rid)
    done, n = [], 0
    while eng.active_count() or eng.pending_count():
        done += eng.step_chunk()
        n += 1
        if pause is not None:
            eng = pause(eng, n) or eng
    return ({d.rid: list(d.tokens) for d in done},
            {d.rid: d.status for d in done}, eng)


def durability_engine(fm, warm: bool = True, **kw):
    """A full-width engine of the serving phases' shape (8 slots, prompts
    up to 128, 32 new tokens, chunk 4) on the paged pool of ``PAGED_KW``
    updated with ``kw``; ``warm``: the decode ladder and the spill tier's
    executables captured first, so costs are read in steady state."""
    from repro_torch.core.decode_engine import DecodeEngine
    eng = DecodeEngine(fm, num_slots=SLOTS, prompt_len=PROMPT_LEN,
                       max_new=MAX_NEW, chunk=CHUNK, **dict(PAGED_KW, **kw))
    if warm:
        eng.warm_decode_ladder()
        eng.warm_spill()
    return eng


def executable_state(eng) -> tuple:
    """``compile_count`` and the shape keys that hold a captured graph."""
    keys = graph_keys(eng, eng.fm)["keys"]
    return (eng.compile_count(),
            sorted(k for k, v in keys.items() if v["captured"]
                   and not k.startswith("forward")))


def leaked(eng) -> bool:
    return (eng.free_page_count() != eng.total_pages - 1
            or bool(eng._page_refs.any()) or bool(eng.active_count())
            or bool(eng.pending_count()))


def _release():
    """Return the device memory of the engines a check dropped."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def durability_spill(fm, cfg) -> dict:
    """Checks 1 and 2: the burst of ``paged_burst`` (12 joins of 96
    tokens) on the 45-page pool with a 256 MiB arena, against the same
    joins on an unpressured pool (``total_pages=None``); then with a
    20 MiB arena; then 8 SAMPLED streams (temperature 0.7, top-k 8) that
    all admit and then outgrow the 45 pages, against the unpressured
    pool."""
    import numpy as np

    from repro_torch.core.spill import _blob_digest
    out = {}
    joins = durability_joins(cfg, seed=41)
    ref = durability_engine(fm, total_pages=None)
    want, _, _ = run_joins(ref, joins)
    eng = durability_engine(fm, spill_bytes=SPILL_BYTES)
    got, status, _ = run_joins(eng, joins)
    spill_ms = [1e3 * t for k, t in eng.resume_costs if k == "spill"]
    out["spill"] = {
        "tokens_equal": got == want, "streams": len(got),
        "statuses_ok": all(v == "ok" for v in status.values()),
        "preemptions": eng.preemptions, "spill_resumes": eng.spill_resumes,
        "spilled_pages": eng.spilled_pages,
        "restored_pages": eng.restored_pages,
        "digest_failures": eng.digest_failures, "leak": leaked(eng),
        "resume_kinds": [k for k, _ in eng.resume_costs],
        "spill_resume_ms": spill_ms,
        "arena_mb": eng.spill.bytes_in_use / 2**20,
        "arena_evictions": eng.spill.evictions}
    if got != want:
        out["spill"]["first_mismatch"] = first_mismatch(got, want)
    small = durability_engine(fm, spill_bytes=SMALL_SPILL_BYTES)
    got_s, status_s, _ = run_joins(small, joins)
    out["budget"] = {
        "finished": sum(1 for r, t in got_s.items()
                        if len(t) == MAX_NEW and status_s[r] == "ok"),
        "joins": len(joins), "preemptions": small.preemptions,
        "spill_resumes": small.spill_resumes,
        "skips": small.spill.skips, "evictions": small.spill.evictions,
        "reprefill_ms": [1e3 * t for k, t in small.resume_costs
                         if k == "reprefill"],
        "leak": leaked(small)}
    # a resume's cost (``resume_costs``, as in the JAX package) starts after
    # the entry's digest check: time that host sha256 apart, over an entry
    # of the resumed stream's size
    n = eng.restored_pages // max(eng.spill_resumes, 1)
    blob = [{k: np.zeros((cfg.num_layers, n, PAGE_SIZE, cfg.num_kv_heads,
                          cfg.head_dim), np.int8) for k in ("k", "v")}]
    t0 = time.perf_counter()
    _blob_digest(blob)
    out["spill_verify_ms"] = {"pages": n,
                              "ms": 1e3 * (time.perf_counter() - t0)}
    out["resume_ms_mean"] = {
        "spill": float(np.mean(spill_ms)) if spill_ms else None,
        "reprefill": float(np.mean(out["budget"]["reprefill_ms"]))
        if out["budget"]["reprefill_ms"] else None}
    del ref, eng, small
    _release()
    sjoins = durability_joins(cfg, seed=43, n=SLOTS, plen=SAMPLED_PROMPT)
    skw = dict(temperature=0.7, top_k=8, sample_seed=5)
    sref = durability_engine(fm, total_pages=None, **skw)
    swant, _, _ = run_joins(sref, sjoins)
    seng = durability_engine(fm, spill_bytes=SPILL_BYTES, **skw)
    sgot, sstatus, _ = run_joins(seng, sjoins)
    out["sampled"] = {
        "tokens_equal": sgot == swant, "streams": len(sgot),
        "deferrals": seng.deferrals, "preemptions": seng.preemptions,
        "spill_resumes": seng.spill_resumes,
        "resume_kinds": [k for k, _ in seng.resume_costs],
        "leak": leaked(seng)}
    if sgot != swant:
        out["sampled"]["first_mismatch"] = first_mismatch(sgot, swant)
    sp, bu, sa = out["spill"], out["budget"], out["sampled"]
    out["ok"] = bool(
        sp["tokens_equal"] and sp["statuses_ok"] and sp["spill_resumes"] >= 1
        and sp["digest_failures"] == 0 and not sp["leak"]
        and set(sp["resume_kinds"]) == {"spill"}
        and bu["finished"] == bu["joins"] and len(bu["reprefill_ms"]) >= 1
        and not bu["leak"]
        and sa["tokens_equal"] and sa["spill_resumes"] >= 1
        and sa["deferrals"] == 0 and not sa["leak"])
    return out


def first_mismatch(got: dict, want: dict, logits: dict = None) -> dict:
    """The first stream and position where two runs' tokens differ; with
    ``logits`` (the ``want`` run's f32 logits by (rid, position),
    ``record_streams``), also that run's top-2 logit margin there."""
    for rid in sorted(want):
        a, b = got.get(rid, []), want[rid]
        for j, (x, y) in enumerate(zip(a, b)):
            if x != y:
                out = {"rid": rid, "position": j, "got": x, "want": y}
                if logits is not None and (rid, j) in logits:
                    import torch
                    top2 = torch.topk(logits[(rid, j)], 2).values
                    out["want_top2_margin"] = (top2[0] - top2[1]).item()
                return out
        if len(a) != len(b):
            return {"rid": rid, "lengths": [len(a), len(b)]}
    return {"missing": sorted(set(want) ^ set(got))}


def durability_prefix(fm, cfg) -> dict:
    """Check 3: on the chunked pool with a 256 MiB arena, a wave of four
    sharers of one 64-token prefix, drained to idle (the prefix's last
    sharer spills its pages), then a second wave: its first sharer
    restores the prefix from the host (with its float sidecars) and every
    sharer prefills only its tail, through K2 with the prefix operand."""
    import numpy as np

    from repro_torch.kernels import ops
    eng = durability_engine(fm, chunked_prefill=True,
                            spill_bytes=SPILL_BYTES)
    eng.warm_chunked()
    rng = np.random.RandomState(47)
    prefix = rng.randint(0, cfg.vocab_size, 64).astype(np.int32)

    def wave(base):
        return [("task2", np.concatenate([prefix, rng.randint(
            0, cfg.vocab_size, 8 + 8 * i).astype(np.int32)]), "lora2",
            base - i) for i in range(4)]
    first, _, _ = run_joins(eng, wave(-3000))
    spilled = eng.spilled_pages
    saved0, hits0 = eng.prefill_tokens_saved, eng.spill_prefix_hits
    ops.reset_launches()
    second, status, _ = run_joins(eng, wave(-3100))
    out = {"spilled_pages_after_wave_1": spilled,
           "spill_prefix_hits": eng.spill_prefix_hits - hits0,
           "prefill_tokens_saved": eng.prefill_tokens_saved - saved0,
           "restored_pages": eng.restored_pages,
           "flash_attention_launches": int(ops.LAUNCHES["flash_attention"]),
           "finished": sum(1 for r, t in second.items()
                           if len(t) == MAX_NEW and status[r] == "ok"),
           "leak": leaked(eng)}
    out["ok"] = bool(out["spilled_pages_after_wave_1"] >= 4
                     and out["spill_prefix_hits"] >= 1
                     and out["prefill_tokens_saved"] > 0
                     and out["flash_attention_launches"] > 0
                     and out["finished"] == 4 and not out["leak"])
    return out


def durability_snapshot(fm, cfg) -> dict:
    """Checks 4-6. The burst on the pressured pool (256 MiB arena),
    snapshotted after ``RESTORE_AT`` chunks, the old arena scrambled in
    place (``serving.faults.scramble_arena``) and restored over it reusing
    the executables: the tokens equal the uninterrupted run's, no shape
    key is added and none captured again, and the reserved memory grows
    by less than one pool. Then a snapshot with one page's codes flipped:
    at least one digest failure, every stream finishes its budget. Then
    a snapshot of the unpressured pool written to disk, read back and
    restored without reuse (a fresh pool and fresh executables): the
    tokens equal the uninterrupted run's."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.core.decode_engine import DecodeEngine
    from repro_torch.serving.faults import scramble_arena
    joins = durability_joins(cfg, seed=53)
    ref = durability_engine(fm, total_pages=None)
    want, _, _ = run_joins(ref, joins)
    eng = durability_engine(fm, spill_bytes=SPILL_BYTES)
    run_joins(eng, durability_joins(cfg, seed=59))     # every key captured
    out = {}

    def restore_over(e, n, tamper=False):
        if n != RESTORE_AT:
            return None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = e.snapshot()
        out["snapshot_ms"] = 1e3 * (time.perf_counter() - t0)
        out["snapshot_mb"] = sum(
            a.nbytes for part in (snap.pages, snap.slot_state)
            for sub in part for a in sub.values()) / 2**20
        out["snapshot_pages"] = len(snap.used_pages)
        out["pending_at_snapshot"] = len(snap.pending)
        out["resumes_pending"] = sum(p.resume is not None
                                     for p in snap.pending)
        if tamper:
            snap.pages[0]["k"] = np.array(snap.pages[0]["k"])
            snap.pages[0]["k"][:, 0] ^= 1
        before = executable_state(e)
        scramble_arena(e)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        new = DecodeEngine.restore(e.fm, snap, reuse_jits_from=e)
        torch.cuda.synchronize()
        out["restore_ms"] = 1e3 * (time.perf_counter() - t0)
        out["memory_reserved_mb"] = [mem0 / 2**20,
                                     torch.cuda.memory_reserved() / 2**20]
        out["same_pool"] = new.pool is e.pool
        out["executables_before_after"] = [before, executable_state(new)]
        return new
    got, status, eng = run_joins(eng, joins, pause=restore_over)
    pool_mb = sum(t.numel() * t.element_size() for sub in eng.pool
                  for k, t in sub.items() if k != "page_table") / 2**20
    b, a = out["executables_before_after"]
    grow = out["memory_reserved_mb"][1] - out["memory_reserved_mb"][0]
    snap_ok = (got == want and all(v == "ok" for v in status.values())
               and a == b and executable_state(eng)[0] == b[0]
               and grow < pool_mb and out["same_pool"]
               and eng.digest_failures == 0 and not leaked(eng))
    res = {"restore": dict(out, tokens_equal=got == want,
                           pool_mb=pool_mb, memory_growth_mb=grow,
                           spill_resumes=eng.spill_resumes,
                           executables_after_drain=executable_state(eng)[0],
                           leak=leaked(eng))}
    if got != want:
        res["restore"]["first_mismatch"] = first_mismatch(got, want)
    out = {}
    got_t, status_t, eng = run_joins(
        eng, durability_joins(cfg, seed=61),
        pause=lambda e, n: restore_over(e, n, tamper=True))
    res["tamper"] = {"digest_failures": eng.digest_failures,
                     "finished": sum(1 for r, t in got_t.items()
                                     if len(t) == MAX_NEW
                                     and status_t[r] == "ok"),
                     "joins": len(got_t), "leak": leaked(eng)}
    tamper_ok = (res["tamper"]["digest_failures"] >= 1
                 and res["tamper"]["finished"] == 12 and not leaked(eng))
    path = os.path.join(ROOT, "build", "durability", "snap")
    disk = {}

    def to_disk(e, n):
        if n != RESTORE_AT:
            return None
        snap = e.snapshot()
        ckpt.save_snapshot(path, snap)
        loaded = ckpt.load_snapshot(path)
        disk["digests_equal"] = loaded.page_digests == snap.page_digests
        new = DecodeEngine.restore(e.fm, loaded)
        disk["fresh_pool"] = new.pool is not e.pool
        return new
    got_d, _, dis = run_joins(ref, joins, pause=to_disk)
    disk.update(tokens_equal=got_d == want, leak=leaked(dis),
                digest_failures=dis.digest_failures)
    res["disk"] = disk
    disk_ok = (disk["tokens_equal"] and disk["digests_equal"]
               and disk["fresh_pool"] and not disk["leak"]
               and disk["digest_failures"] == 0)
    res["ok"] = bool(snap_ok and tamper_ok and disk_ok)
    return res


def durability_loop(srv, cfg, loop) -> dict:
    """Check 7: generative requests through ``FMplexServer``/``ServeLoop``
    on the pressured pool with a 256 MiB arena, fault-free; then the same
    requests with ``checkpoint_restart`` under load and then a
    ``DeviceResetFault`` (the old arena scrambled in place before the
    restore reads it). Streams equal the fault-free run's bit for bit,
    every request in flight at a reset carries it, nothing leaks."""
    import numpy as np

    from repro_torch.core.request import Request
    from repro_torch.serving.faults import DeviceResetFault
    rng = np.random.RandomState(67)
    prompts = [(f"task{i % N_TASKS}", rng.randint(
        0, cfg.vocab_size, int(rng.randint(32, BURST_PROMPT + 1)))
        .astype(np.int32)) for i in range(SLOTS)]

    def requests():
        return [Request(t, 0.0, payload=p, tokens=float(len(p) + MAX_NEW),
                        max_new_tokens=MAX_NEW) for t, p in prompts]
    clean = requests()
    loop.run(clean, max_wall=300)
    hit = requests()
    for r in hit:
        loop.submit(r, time.perf_counter())
    eng = srv.engines["fm0"]
    for _ in range(1000):
        if eng.active_count() >= SLOTS // 2:
            break
        loop.tick()
    else:
        raise RuntimeError("durability loop: the streams did not admit")
    loop.checkpoint_restart()
    at_first = set(loop._inflight)
    for _ in range(4):
        loop.tick()
    fault = DeviceResetFault()
    fault.inject(loop)
    at_second = set(loop._inflight)
    while loop._work_left():
        loop.tick()
    eng = srv.engines["fm0"]
    out = {"requests": len(hit),
           "ok": [r.ok for r in clean + hit].count(True),
           "tokens_equal": all(r.result is not None and c.result is not None
                               and list(r.result) == list(c.result)
                               for r, c in zip(hit, clean)),
           "resets_survived": loop.failures["resets_survived"],
           "stamps": [r.resets_survived for r in hit],
           "expected_stamps": [int(r.rid in at_first) + int(r.rid in at_second)
                               for r in hit],
           "digest_failures": eng.digest_failures, "leak": leaked(eng)}
    out["ok"] = bool(out["ok"] == 2 * len(hit) and out["tokens_equal"]
                     and out["resets_survived"] == 2
                     and out["stamps"] == out["expected_stamps"]
                     and max(out["stamps"]) == 2
                     and out["digest_failures"] == 0 and not out["leak"])
    return out


def durability_whisper(dev) -> dict:
    """Check 8: a two-layer cut of full-width whisper-base on the paged
    pool, four streams with their own 1500 frames; the same joins again,
    snapshotted after two chunks (the cross ``ck``/``cv`` with it, the
    ``dense_state`` path), the old arena scrambled in place and restored
    over reusing the executables: the tokens equal the uninterrupted
    run's."""
    import numpy as np

    from repro_torch.core.decode_engine import DecodeEngine
    from repro_torch.core.physical import PhysicalFM
    from repro_torch.serving.faults import scramble_arena
    cfg = whisper_config(num_layers=2, encoder_layers=2)
    fm = PhysicalFM(cfg, seed=4, lora_rank=RANK, input_len=ENC_LEN,
                    lora_impl="segmented", seg_block_t=BLOCK_T, device=dev)
    for i in range(2):
        fm.adapters.add(f"lora{i}", random_adapter(fm.adapters, i, dev))
    eng = DecodeEngine(fm, num_slots=SLOTS, prompt_len=W_PROMPT_LEN,
                       max_new=16, chunk=CHUNK, enc_len=ENC_LEN, paged=True,
                       page_size=W_PAGE_SIZE)
    rng = np.random.RandomState(71)
    jobs = [(rng.randint(0, cfg.vocab_size, int(rng.randint(4, 65)))
             .astype(np.int32), f"lora{i % 2}" if i < 3 else None,
             (rng.randn(ENC_LEN, cfg.d_model) * 0.5).astype(np.float32))
            for i in range(4)]

    def run(restore: bool):
        for i, (p, aid, feats) in enumerate(jobs):
            eng.join("t", p, adapter_id=aid, max_new_tokens=16, rid=-4000 - i,
                     enc_feats=feats)
        e, done, n, snap = eng, [], 0, None
        while e.active_count() or e.pending_count():
            done += e.step_chunk()
            n += 1
            if restore and n == 2:
                snap = e.snapshot()
                scramble_arena(e)
                e = DecodeEngine.restore(fm, snap, reuse_jits_from=e)
        return {d.rid: list(d.tokens) for d in done}, e, snap
    want, _, _ = run(restore=False)
    got, e, snap = run(restore=True)
    out = {"tokens_equal": got == want, "streams": len(got),
           "dense_state_mb": sum(a.nbytes for sub in snap.dense_state
                                 if sub for a in sub.values()) / 2**20,
           "same_pool": e.pool is eng.pool,
           "state_slots_free": not e.state_pool.slots_in_use(),
           "leak": leaked(e)}
    out["ok"] = bool(out["tokens_equal"] and out["streams"] == 4
                     and out["same_pool"] and out["state_slots_free"]
                     and not out["leak"])
    return out


def phase_durability(dev):
    """The durability plane at full width on stablelm-1.6b (24 layers,
    the serving phases' 4 tasks and rank-16 q/v adapters, 8 slots, pages
    of 16, chunk 4, greedy unless said): spill resume against the
    unpressured pool and the budget fallback, a sampled pair, a prefix
    spilled across an idle wave, snapshot/restore over the scrambled old
    arena reusing the executables, a tampered page, the disk round trip,
    ``checkpoint_restart`` and the device reset through the serve loop,
    and whisper's cross state through a snapshot; then one sampled decode
    step (eager: its executables draw from per-slot generators) against
    the greedy graphed step, 8 live streams each. Launches are counted
    from 0 at the start of the phase: K4, K2 and K1 must launch."""
    import torch

    from repro_torch.kernels import ops
    srv, cfg, fm, loop = build_server(
        dev, **dict(PAGED_KW, spill_bytes=SPILL_BYTES))
    ops.reset_launches()
    t0 = time.perf_counter()
    stats = {"card": smi_line()}
    for name, fn in (("spill", lambda: durability_spill(fm, cfg)),
                     ("prefix", lambda: durability_prefix(fm, cfg)),
                     ("snapshot", lambda: durability_snapshot(fm, cfg))):
        t1 = time.perf_counter()
        stats[name] = fn()
        stats[name]["seconds"] = time.perf_counter() - t1
        log(f"durability {name}: " + json.dumps(stats[name], default=float))
        _release()
    t1 = time.perf_counter()
    loop.warmup(pooled_task="task0", gen_task="task1", pooled_n=1)
    stats["loop"] = durability_loop(srv, cfg, loop)
    stats["loop"]["seconds"] = time.perf_counter() - t1
    log("durability loop: " + json.dumps(stats["loop"], default=float))
    srv.engines.pop("fm0")
    _release()
    t1 = time.perf_counter()
    stats["whisper"] = durability_whisper(dev)
    stats["whisper"]["seconds"] = time.perf_counter() - t1
    log("durability whisper: " + json.dumps(stats["whisper"], default=float))
    torch.cuda.synchronize()
    stats["launches"] = {k: int(ops.LAUNCHES[k])
                         for k in ("segmented_lora", "flash_attention",
                                   "decode_attention_int8",
                                   "paged_decode_attention",
                                   "decode_attention", "rmsnorm")}
    stats["bodies"] = ops.bodies()
    stats["wall_s"] = time.perf_counter() - t0
    stats["sampled_step"] = sampled_step_timing(dev, fm)
    log("durability sampled step: " + json.dumps(stats["sampled_step"],
                                                  default=float))
    ok = all(stats[k]["ok"] for k in ("spill", "prefix", "snapshot", "loop",
                                      "whisper"))
    ok &= all(stats["launches"][k] > 0 for k in (
        "segmented_lora", "flash_attention", "paged_decode_attention",
        "rmsnorm"))
    log(f"durability: ok {ok}, launches {stats['launches']}, "
        f"{stats['wall_s']:.1f} s")
    return ok, stats


def sampled_step_timing(dev, fm) -> dict:
    """One full-width decode step with 8 live streams: greedy (its
    executable a captured graph) against sampled at temperature 0.7 and
    top-k 8 (eager: the sampling executables draw from per-slot
    generators), ms between CUDA events, one call each way
    (``live_step_timing``)."""
    out = {}
    for name, kw in (("greedy", {}),
                     ("sampled", dict(temperature=0.7, top_k=8))):
        eng = durability_engine(fm, total_pages=None, warm=False, **kw)
        r = live_step_timing(dev, (None, fm, eng), "", seed=73, rid0=-5000)
        del eng
        out[name] = {"event_ms": r["decode_step_ms"],
                     "launches": r["launches_per_decode_step"],
                     "device_busy_ms": {
                         w: r["decode_step_profile"][w]["device_busy_ms"]
                         for w in ("eager", "graphed")}}
        _release()
    out["sampled_eager_over_greedy_graphed"] = \
        out["sampled"]["event_ms"]["eager"] / \
        out["greedy"]["event_ms"]["graphed"]
    return out


# ---------------- the speculative plane (P11) ----------------

SPEC_K = 4                       # drafted tokens a step: windows of 5
SPEC_KW = dict(paged=True, page_size=PAGE_SIZE, total_pages=None,
               prefix_sharing=True, chunked_prefill=False, spec_k=SPEC_K,
               spec_disable_below=1.0)
# the verify window against T sequential decode steps on the same cache,
# and the spec engine's logits against the CPU's: the reference phases'
# relative L2 bound (bf16 activations rounded after products over B * T
# rows instead of B, in another order)
SPEC_REL_L2 = 2e-2


def spec_engine(fm, **kw):
    """A full-width engine of the serving phases' shape (8 slots, prompts
    up to 128, 32 new tokens, chunk 4) on a dense-equivalent paged pool of
    pages of 16 (SPEC_KW: spec_k 4, speculating on every dispatch unless
    ``kw`` says otherwise)."""
    from repro_torch.core.decode_engine import DecodeEngine
    return DecodeEngine(fm, num_slots=SLOTS, prompt_len=PROMPT_LEN,
                        max_new=MAX_NEW, chunk=CHUNK, **dict(SPEC_KW, **kw))


def spec_joins(cfg, seed: int, n: int = SLOTS) -> list:
    """``n`` joins on the 4 tasks' adapters, prompts of 16-96 tokens."""
    import numpy as np
    rng = np.random.RandomState(seed)
    return [(f"task{i % N_TASKS}",
             rng.randint(0, cfg.vocab_size, int(rng.randint(16, 97))).astype(
                 np.int32), f"lora{i % N_TASKS}", 9000 + 100 * seed + i)
            for i in range(n)]


def echo_joins(fm, cfg, seed: int) -> list:
    """Joins whose prompts re-feed the model's own earlier output, as an
    agent loop re-feeds its context: ``spec_joins``' prompts (cut to 80
    tokens) are run through a plain engine for ``MAX_NEW`` greedy tokens c,
    then each new prompt is the old one, c, four random tokens and c's
    first two tokens again. On the copy-inclined model (the next token a
    function of the current one) the stream then continues c, and its
    history holds every bigram it meets. At stablelm's vocabulary of
    ~100k the copy-inclined chain from a random prompt does not revisit a
    bigram within 32 tokens (measured on an H100: no draft proposed over 8
    such streams), so without the echo nothing would be accepted."""
    import numpy as np
    eng = spec_engine(fm, spec_k=0)
    base = [(t, p[:80], a, rid) for t, p, a, rid in spec_joins(cfg, seed)]
    for task, prompt, adapter, rid in base:
        eng.join(task, prompt, adapter_id=adapter, max_new_tokens=MAX_NEW,
                 rid=rid)
    chains = {d.rid: np.asarray(d.tokens, np.int32) for d in eng.drain()}
    rng = np.random.RandomState(seed)
    out = []
    for task, prompt, adapter, rid in base:
        c = chains[rid]
        out.append((task, np.concatenate([
            prompt, c, rng.randint(0, cfg.vocab_size, 4).astype(np.int32),
            c[:2]]), adapter, rid))
    del eng
    return out


def spec_warm(eng, cfg):
    """One join per prompt bucket (drained), both decode ladders and the
    refresh's key: every key the run can dispatch, twice."""
    import numpy as np
    rng = np.random.RandomState(91)
    for _ in range(2):
        for i, b in enumerate(eng.prompt_buckets):
            eng.join("task0", rng.randint(0, cfg.vocab_size, b),
                     adapter_id="lora0", max_new_tokens=2, rid=-9000 - i)
        eng.drain()
    eng.warm_decode_ladder()
    eng.warm_speculative()
    eng._rescale_fn()


def spec_run(eng, joins) -> tuple[dict, int]:
    """The joins, then chunks until every stream retires; after every chunk
    each live slot's device length (every layer) must equal the host's
    committed length. Returns the streams and the chunks where it did
    not."""
    import torch
    for task, prompt, adapter, rid in joins:
        eng.join(task, prompt, adapter_id=adapter, max_new_tokens=MAX_NEW,
                 rid=rid)
    done, bad = [], 0
    while eng.active_count() or eng.pending_count():
        done += eng.step_chunk()
        dev_len = torch.stack([sub["len"] for sub in eng.pool
                               if "page_table" in sub]).cpu().numpy()
        live = [i for i, s in enumerate(eng.slots)
                if s is not None and not s.done]
        bad += int(any((dev_len[:, :, i] != eng._lens[i]).any()
                       for i in live))
    return {d.rid: list(d.tokens) for d in done}, bad


def plain_reference(fm, joins) -> tuple[dict, dict]:
    """The joins through a plain paged engine (spec_k 0), eager, every
    sampler call recorded (``record_streams``): its streams and its f32
    logits by (rid, position)."""
    from repro_torch.core import graphs
    eng = spec_engine(fm, spec_k=0)
    logits: dict = {}
    record_streams(eng, logits)
    with graphs.disabled():
        for task, prompt, adapter, rid in joins:
            eng.join(task, prompt, adapter_id=adapter,
                     max_new_tokens=MAX_NEW, rid=rid)
        out = {d.rid: list(d.tokens) for d in eng.drain()}
    return out, logits


def verify_vs_sequential(fm, cfg, seed: int = 61) -> dict:
    """Teacher-forced: 8 live streams, one 5-token window scored by
    ``lm.verify_step`` on a copy of the pool against 5 ``decode_step``
    calls on another copy, fed the sequential walk's own greedy tokens.
    Logits compared by ``drift`` (bound SPEC_REL_L2, greedy agreement where
    the sequential step's top-2 gap exceeds twice the largest difference);
    the lengths must be equal and the int8 codes within one step. On the
    H100 every dense product, K1 and the verify kernel give each of the 40
    rows the bits its sequential step gets, and so does the rmsnorm kernel
    (its reduction order depends on d alone): PyTorch's f32 mean, whose
    order followed the row count, made a one-ulp difference at layer 6 that
    24 random layers amplified to 0.12 relative L2 of the logits."""
    import torch

    from repro_torch.models import lm
    eng = spec_engine(fm)
    for task, prompt, adapter, rid in spec_joins(cfg, seed):
        eng.join(task, prompt, adapter_id=adapter, max_new_tokens=MAX_NEW,
                 rid=rid)
    eng._ensure_chunk_pages()
    eng._sync_page_table()
    full = torch.cat([eng._ptab_dev, eng._ptab_spec], dim=1)
    aidx = torch.as_tensor(eng._slot_adapters, device=fm.device)
    stack = fm.adapters.stacked()
    T = SPEC_K + 1

    def clone(extra):
        out = []
        for sub in eng.pool:
            d = {k: v.clone() for k, v in sub.items() if k != "page_table"}
            d["page_table"] = full.expand(d["k"].shape[0], -1, -1)
            if extra:
                shape = d["k_max"].shape[:2] + (T, d["k_max"].shape[2])
                d["k_cmax"] = torch.empty(shape, device=fm.device)
                d["v_cmax"] = torch.empty(shape, device=fm.device)
            out.append(d)
        return out
    seq, toks, want = clone(False), [eng._tokens.clone()], []
    for j in range(T):
        logits, seq = lm.decode_step(fm.params, cfg, tokens=toks[-1],
                                     cache=seq, lora=stack, adapter_idx=aidx,
                                     lora_impl="segmented",
                                     lora_seg=eng._seg(
                                         "segmented", *eng._segments(
                                             fm.adapters.capacity())))
        want.append(logits.float())
        toks.append(torch.argmax(logits, dim=-1).to(torch.int32))
    wide = clone(True)
    meta = eng._spec_segments(fm.adapters.capacity())
    got, wide = lm.verify_step(fm.params, cfg,
                               tokens=torch.stack(toks[:T], dim=1),
                               cache=wide, lora=stack, adapter_idx=aidx,
                               lora_impl="segmented",
                               lora_seg=eng._seg("segmented", *meta))
    torch.cuda.synchronize()
    r = drift(got.float().transpose(0, 1).reshape(-1, got.shape[-1]).cpu(),
              torch.stack(want).reshape(-1, got.shape[-1]).cpu())
    r["len_equal"] = all(torch.equal(a["len"], b["len"])
                         for a, b in zip(wide, seq))
    r["code_max_diff"] = max(
        int((a[c].int() - b[c].int()).abs().max()) for a, b in zip(wide, seq)
        for c in ("k", "v"))
    r["bit_equal"] = bool(torch.equal(
        got.float().transpose(0, 1).reshape(-1, got.shape[-1]),
        torch.stack(want).reshape(-1, got.shape[-1])))
    r["ok"] = bool(r["finite"] and r["rel_l2"] <= SPEC_REL_L2
                   and r["argmax_agree"] and r["len_equal"]
                   and r["code_max_diff"] <= 1)
    for i in range(SLOTS):
        eng.leave(i)
    return r


def verify_split_walk(dev) -> dict:
    """``verify_vs_sequential`` on full-width qwen2-7b cut to 2 layers,
    whose G 7 takes K4's split body on the spec engine's table: once at
    the plan's cells (one cell: ``paged_verify_split_kernel``) and once
    with cells of 64 keys forced on both kernels (``k4_forced``: several
    cells and ``paged_merge_kernel``), so that the verify window's split
    walk runs inside the model's verify step against K4's in its
    sequential steps. Gated as ``verify_vs_sequential``, and on each run
    going through the body it was meant to."""
    from repro_torch.core.physical import PhysicalFM
    from repro_torch.kernels import ops
    cfg = family_config(QWEN2, num_layers=2)
    fm = PhysicalFM(cfg, seed=7, lora_rank=RANK, input_len=PROMPT_LEN,
                    lora_impl="segmented", seg_block_t=BLOCK_T, device=dev)
    for i in range(N_TASKS):
        fm.adapters.add(f"lora{i}", random_adapter(fm.adapters, i, dev))
    out, ok = {}, True
    for side, body in ((None, "split"), (("split", 64), "merge")):
        ops.reset_launches()
        with k4_forced(side):
            r = verify_vs_sequential(fm, cfg)
        r["bodies"] = ops.bodies()
        ok &= r["ok"] and set(r["bodies"].get("paged_verify_attention",
                                              {})) == {body} \
            and set(r["bodies"].get("paged_decode_attention", {})) == {body}
        out[body] = r
        log(f"speculative verify vs sequential steps, {cfg.name} at 2 "
            f"layers, K4's {body} body: " + json.dumps(r, default=float))
    del fm
    out["ok"] = bool(ok)
    return out


def spec_serving(fm, cfg, name: str, joins: list) -> dict:
    """One model's speculative run (module docstring): warm, the joins
    through the spec engine graphed with the rollback invariant after
    every chunk, keys before and after, no leak, the eager replay of the
    recorded calls, and the streams equal to the plain engine's (gated;
    where not, the first mismatch with the plain run's top-2 margin
    there)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving.metrics import speculation_stats
    want, logits = plain_reference(fm, joins)
    _release()
    eng = spec_engine(fm)
    rec = record_calls(eng, fm)
    mem0 = torch.cuda.memory_reserved()
    spec_warm(eng, cfg)
    mem1 = torch.cuda.memory_reserved()
    keys0 = eng.compile_count()
    base = {k: getattr(eng, k) for k in ("draft_proposed", "draft_accepted",
                                        "spec_dispatches", "spec_commits",
                                        "spec_fallbacks", "steps")}
    ops.reset_launches()
    t0 = time.perf_counter()
    got, bad_len = spec_run(eng, joins)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    st = {"card": smi_line(), "wall_s": wall,
          "tokens": sum(len(v) for v in got.values()),
          "len_mismatch_chunks": bad_len, "launches": launches,
          "bodies": ops.bodies(),
          "run": {k: getattr(eng, k) - v for k, v in base.items()},
          "speculation": speculation_stats(eng),
          "shape_keys": [keys0, eng.compile_count()],
          "leak": leaked(eng)}
    st["tokens_per_s"] = st["tokens"] / wall
    st["equal_to_plain"] = got == want
    if got != want:
        st["first_mismatch"] = first_mismatch(got, want, logits)
    ok = (bad_len == 0 and not st["leak"] and keys0 == eng.compile_count()
          and st["equal_to_plain"]
          and launches.get("paged_verify_attention", 0) > 0
          and st["run"]["spec_dispatches"] > 0 and eng.quarantines == 0
          and all(len(v) == MAX_NEW for v in got.values())
          and set(got) == set(want))
    keys = graph_keys(eng, fm)
    replay = replay_eager(rec, fm, eng, dict(
        num_slots=SLOTS, prompt_len=PROMPT_LEN, max_new=MAX_NEW,
        chunk=CHUNK, **SPEC_KW))
    st["graphs"] = {"memory_reserved_mb": [m / 2**20 for m in (mem0, mem1)],
                    "uncaptured": keys["uncaptured"],
                    "spec_keys": {k: v for k, v in keys["keys"].items()
                                  if "spec" in k},
                    "eager_replay": replay}
    ok &= not keys["uncaptured"] and replay["ok"]
    st["ok"] = bool(ok)
    log(f"speculative {name}: " + json.dumps(st, default=float)[:6000])
    return st


def spec_loop(srv, cfg, loop) -> dict:
    """The speculative engine behind the serve loop (``FMplexServer`` /
    ``ServeLoop.run``, the user's entry point): ``ServeLoop.warmup`` (it
    warms both decode ladders on a speculative engine), then a burst of 8
    pooled requests and 12 generative streams (prompts 16-96 tokens, 32
    new tokens) arriving within ~0.5 s. Every request finishes ok with its
    budget, no key is added, no page leaks, the verify kernel launches."""
    import numpy as np
    import torch

    from repro_torch.core.request import Request
    from repro_torch.kernels import ops
    loop.warmup(pooled_task="task0", gen_task="task1", pooled_n=1)
    eng = srv.engines["fm0"]
    keys0 = eng.compile_count()
    rng = np.random.RandomState(17)
    trace = [Request(f"task{i % N_TASKS}", 0.05 * i,
                     payload=rng.randn(PROMPT_LEN, cfg.d_model).astype(
                         np.float32)) for i in range(8)]
    trace += [Request(task, 0.04 * i, payload=p, tokens=float(len(p) + MAX_NEW),
                      max_new_tokens=MAX_NEW)
              for i, (task, p, _, _) in enumerate(spec_joins(cfg, 3, n=12))]
    ops.reset_launches()
    t0 = time.perf_counter()
    loop.run(trace, max_wall=300)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches()
    gen = [r for r in trace if r.max_new_tokens > 0]
    bad = [r for r in trace if not r.ok or r.result is None]
    short = [r for r in gen if r.result is None or len(r.result) != MAX_NEW]
    st = {"wall_s": wall, "requests": len(trace), "launches": launches,
          "bodies": ops.bodies(),
          "tokens": sum(len(r.result) for r in gen if r.result is not None),
          "shape_keys": [keys0, eng.compile_count()], "leak": leaked(eng),
          "spec_dispatches": eng.spec_dispatches,
          "spec_keys_warm": sorted(str(k) for k in eng._fn_decode
                                   if k[0] == "spec")}
    st["ok"] = bool(not bad and not short and not st["leak"]
                    and keys0 == eng.compile_count()
                    and launches.get("paged_verify_attention", 0) > 0
                    and len(st["spec_keys_warm"]) == len(eng.chunk_ladder()))
    log("speculative serve loop: " + json.dumps(st, default=float))
    return st


def phase_speculative(dev):
    """Self-speculative decoding at full width on stablelm-1.6b (24
    layers; the serving phases' 4 tasks with rank-16 q/v adapters; 8
    slots, pages of 16, chunk 4, spec_k 4, greedy): the verify window
    teacher-forced against sequential decode steps on the same cache, on
    a two-layer full-width cut and at the full 24 layers, and on
    qwen2-7b's two-layer cut through K4's split body
    (``verify_split_walk``: one cell, then several and the merge); then
    on random weights (zero accepts: every step commits one token) and on
    the copy-inclined model (every attention out-projection zeroed, as
    the JAX package's ``bench_speculative.py`` does: accepts fire), 8
    streams of 32 tokens each through the speculative engine, graphed,
    with every
    dispatch speculative (``spec_disable_below`` 1.0), and on random
    weights behind the serve loop (``spec_loop``). Gates: the verify
    logits within SPEC_REL_L2 of the sequential ones with greedy agreement,
    at 2 and at 24 layers and on qwen2-7b's bodies; the streams equal to the plain engine's (the
    JAX contract: greedy speculation is lossless), on random weights and
    on the copy-inclined model; the device length equal to the host's
    committed length after every chunk; accepts on the copy-inclined run;
    no page leak; no key added after the warm-ups; the graphed run equal
    to its eager replay; the verify kernel and rmsnorm launched. Both
    exactness gates rest on every op giving a verify row the bits of its
    sequential step (``verify_vs_sequential``)."""
    from repro_torch.core.physical import PhysicalFM
    t0 = time.perf_counter()
    stats = {"card": smi_line()}
    # the teacher-forced window on the two-layer cut (the reference
    # phases') and at full depth
    cfg2 = full_config(num_layers=2)
    fm2 = PhysicalFM(cfg2, seed=3, lora_rank=RANK, input_len=PROMPT_LEN,
                     lora_impl="segmented", seg_block_t=BLOCK_T, device=dev)
    for i in range(N_TASKS):
        fm2.adapters.add(f"lora{i}", random_adapter(fm2.adapters, i, dev))
    stats["verify_vs_sequential"] = verify_vs_sequential(fm2, cfg2)
    log("speculative verify vs sequential steps, 2 layers: "
        + json.dumps(stats["verify_vs_sequential"], default=float))
    del fm2
    _release()
    stats["verify_split_walk"] = verify_split_walk(dev)
    _release()
    srv, cfg, fm, loop = build_server(dev, **SPEC_KW)
    full = stats["verify_vs_sequential_24_layers"] = verify_vs_sequential(
        fm, cfg)
    log("speculative verify vs sequential steps, 24 layers: "
        + json.dumps(full, default=float))
    _release()
    stats["random"] = spec_serving(fm, cfg, "random weights",
                                   spec_joins(cfg, 1))
    _release()
    stats["loop"] = spec_loop(srv, cfg, loop)
    srv.engines.pop("fm0")
    _release()
    for sub in fm.params["layers"]:          # the copy-inclined model
        sub["attn"]["wo"].zero_()
    stats["copy_inclined"] = spec_serving(fm, cfg, "copy-inclined",
                                          echo_joins(fm, cfg, 2))
    _release()
    # launches of the three served runs, each counted from 0 just before it
    launches: dict = {}
    for run in ("random", "loop", "copy_inclined"):
        for k, v in stats[run]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    stats["launches"] = launches
    stats["bodies"] = sum_bodies(stats[run] for run in (
        "random", "loop", "copy_inclined"))
    stats["wall_s"] = time.perf_counter() - t0
    ok = stats["verify_vs_sequential"]["ok"] and full["ok"] \
        and stats["verify_split_walk"]["ok"] and stats["random"]["ok"] and stats["loop"]["ok"] \
        and stats["copy_inclined"]["ok"]
    ok &= stats["copy_inclined"]["run"]["draft_accepted"] > 0
    ok &= all(launches.get(k, 0) > 0 for k in (
        "paged_verify_attention", "segmented_lora", "flash_attention",
        "rmsnorm"))
    log(f"speculative: ok {ok}, launches {launches}, "
        f"{stats['wall_s']:.1f} s")
    del srv, fm
    _release()
    return ok, stats


def verify_timing(dev, gen, nsets: int = 24, H: int = 32, KV: int = 32,
                  hd: int = 64, MP: int = 13, window=None,
                  base_lo: int = 0) -> dict:
    """The verify kernel's device time per call at the speculative
    serving shape (8 streams, T 5, H = KV = 32, hd 64, a table of 13 pages
    of 16, ragged base lengths; or the heads, table, window and least base
    length given), over ``nsets`` arenas (one per layer, so
    each call finds its pages cold); its plain version's; T unrolled K4
    calls at the successive lengths (the JAX Pallas path); one
    ``scaled_dot_product_attention`` call on the pages already gathered
    and dequantized to bf16 with the per-position mask (never called by the
    port; the gather not timed); the bound counted on this data."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    T = SPEC_K + 1
    rng = torch.Generator().manual_seed(5)
    sets = []
    for _ in range(nsets):
        base = torch.randint(base_lo, MP * PAGE_SIZE - T, (SLOTS,),
                             generator=rng)
        sets.append(verify_inputs(gen, SLOTS, H, KV, hd, T, MP,
                                  base.tolist(), dev))
    kernel = rotating(lambda *a: ops.paged_verify_attention(
        *a, window=window), sets)
    by_kernel = device_kernels(kernel)
    k_ms = sum(by_kernel.values())
    p_ms = device_ms(rotating(lambda q, kp, vp, ks, vs, pt, b:
                              ref.paged_verify_attention_ref(
                                  q, kp.transpose(1, 2), vp.transpose(1, 2),
                                  ks, vs, pt, b, window=window), sets),
                     iters=5 if MP > 64 else 20)
    # the JAX Pallas path: T single-token calls, each at its own length
    unrolled = [([q[:, j].contiguous() for j in range(T)], kp, vp, ks, vs,
                 pt, [(b + j + 1).to(torch.int32) for j in range(T)])
                for q, kp, vp, ks, vs, pt, b in sets]
    u_ms = device_ms(rotating(lambda qs, kp, vp, ks, vs, pt, ls: [
        ops.paged_decode_attention(qj, kp, vp, ks, vs, pt, lj, window=window)
        for qj, lj in zip(qs, ls)], unrolled))
    S = MP * PAGE_SIZE
    lib_sets = []
    for q, kp, vp, ks, vs, pt, b in sets:
        def gathered(pages, sc):
            g = pages[pt.long()].float() * sc[pt.long()][:, :, None, :, None]
            return g.permute(0, 3, 1, 2, 4).reshape(
                SLOTS, KV, S, hd).to(torch.bfloat16)
        lens = b[:, None] + 1 + torch.arange(T, device=dev)[None]
        pos = torch.arange(S, device=dev)[None, None]
        mask = pos < lens[..., None]
        if window is not None:
            mask &= pos >= lens[..., None] - window
        G = H // KV
        lib_sets.append((q.transpose(1, 2).contiguous(),
                         gathered(kp, ks).repeat_interleave(G, dim=1),
                         gathered(vp, vs).repeat_interleave(G, dim=1),
                         mask[:, None]))                   # (B, 1, T, S)
    lib_ms = device_ms(rotating(
        lambda q, k, v, m: F.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=m),
        lib_sets))
    b_ms, b_by = verify_bound(sets[0][0], sets[0][1], sets[0][5], sets[0][6],
                              window)
    plan = k4_plan(SLOTS, KV, H // KV, hd, MP * PAGE_SIZE, window, dev, T=T)
    split = kernel_split(by_kernel, VERIFY_PARTS)
    log(f"paged_verify_attention [B={SLOTS} T={T} H={H} KV={KV} hd={hd} "
        f"MP={MP} window={window}]: plan {plan}, {k_ms * 1e3:.2f} us ("
        + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in split.items() if v)
        + f"; T unrolled K4 {u_ms * 1e3:.2f}, SDPA {lib_ms * 1e3:.2f}, "
        f"bound {b_ms * 1e3:.2f})")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, unrolled_k4_ms=u_ms, plan=plan,
                split_ms=split, enqueue_ms=time_ms(kernel))


def rmsnorm_timing(dev, gen, d: int = 2048, shapes=None) -> dict:
    """rmsnorm's device time per call at stablelm's width (d 2048) over
    rows of a decode step (8), a verify forward (40), a prefill bucket
    (128) and a pooled batch (32 x 128), each over 8 input sets; its plain
    version's; one ``torch.nn.functional.rms_norm`` call on the same inputs
    (never called by the port; bf16 x with an f32 weight takes its
    composite path) and, beside it, the same call with the weight cast to
    bf16 beforehand (its fused path; a weight rounded to bf16, so not the
    same function); the bound counted on this data (x and w read once, the
    output written once)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    def library(w, x):
        return F.rms_norm(x, (d,), w, 1e-5)
    out = {}
    for name, rows in shapes or (
            ("decode", SLOTS), ("verify", SLOTS * (SPEC_K + 1)),
            ("prefill", PROMPT_LEN), ("pooled", 32 * PROMPT_LEN)):
        sets = [rmsnorm_inputs(gen, rows, d, dev)[::-1] for _ in range(8)]
        b_ms, b_by = bound_ms(2 * 2 * rows * d + 4 * d, 4.0 * rows * d)
        with warnings.catch_warnings():     # the composite path's notice
            warnings.simplefilter("ignore", UserWarning)
            lib_ms = device_ms(rotating(library, sets))
        out[name] = dict(
            rows=rows, d=d,
            ms=device_ms(rotating(ops.rmsnorm, sets)),
            plain_ms=device_ms(rotating(ref.rmsnorm, sets)),
            library_ms=lib_ms,
            library_bf16_weight_ms=device_ms(rotating(library, [
                (w.to(x.dtype), x) for w, x in sets])),
            bound_ms=b_ms, bound_by=b_by,
            enqueue_ms=time_ms(rotating(ops.rmsnorm, sets)))
        log(f"rmsnorm [{name}: {rows} x {d}]: "
            f"{out[name]['ms'] * 1e3:.2f} us (plain "
            f"{out[name]['plain_ms'] * 1e3:.2f}, F.rms_norm "
            f"{out[name]['library_ms'] * 1e3:.2f}, with a bf16 weight "
            f"{out[name]['library_bf16_weight_ms'] * 1e3:.2f}, bound "
            f"{b_ms * 1e3:.2f})")
    return out


def spec_step_timing(dev, fm) -> dict:
    """One full-width speculative step (chunk 1: draft, one verify forward
    of 8 x 5 rows, acceptance, rollback) with 8 live streams of 64-token
    prompts on ``fm`` (random weights, the 4 tasks' adapters), and the
    plain step of the same engine on the same streams: launches per step,
    ms by CUDA events and the profile both ways (``profile_both``)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    cfg = fm.cfg
    eng = spec_engine(fm)
    rng = np.random.RandomState(83)
    for i in range(SLOTS):
        eng.join(f"task{i % N_TASKS}", rng.randint(0, cfg.vocab_size, 64),
                 adapter_id=f"lora{i % N_TASKS}", max_new_tokens=MAX_NEW,
                 rid=-7000 - i)
    eng._ensure_chunk_pages()
    eng._sync_page_table()
    cap = fm.adapters.capacity()
    adapters = torch.as_tensor(eng._slot_adapters, device=dev)
    hist, hlen = eng._spec_history()
    spec = eng._spec_decode_fn(cap, 1)
    plain = eng._decode_fn(cap, 1)
    smeta, pmeta = eng._spec_segments(cap), eng._segments(cap)

    def run_spec():
        spec(fm.params, eng.pool, eng._tokens, eng._keys, hist, hlen,
             [eng._ptab_dev, eng._ptab_spec], fm.adapters.stacked(),
             adapters, *smeta)

    def run_plain():
        plain(fm.params, eng.pool, eng._tokens, eng._keys,
              fm.adapters.stacked(), adapters, *pmeta)
    out = {}
    for name, fn in (("verify_step", run_spec), ("plain_step", run_plain)):
        ops.reset_launches()
        fn()
        torch.cuda.synchronize()
        out[f"launches_per_{name}"] = kernel_launches()
        prof = out[f"{name}_profile"] = profile_both(fn)
        out[f"{name}_ms"] = {w: prof[w]["event_ms"]
                             for w in ("eager", "graphed")}
    out["verify_over_plain_graphed"] = out["verify_step_ms"]["graphed"] / \
        out["plain_step_ms"]["graphed"]
    for i in range(SLOTS):
        eng.leave(i)
    if leaked(eng):
        raise RuntimeError("speculative step timing leaked pages")
    del eng
    _release()
    return out


# ---------------- phase 9: the other attention-only families ----------------

QWEN2, H2O, MINITRON, QWEN2_VL = ("qwen2-7b", "h2o-danube-1.8b", "minitron-8b",
                                  "qwen2-vl-72b")
H2O_PROMPT, H2O_STEPS = 4160, 32    # a prompt past h2o-danube's 4096 window
MINITRON_LAYERS = 4                 # of minitron-8b's 32: its serving took
                                    # 42 s at 32, 26.5 s at 16 and 11.6 s
                                    # at 8 layers
# the served depth of each family cut for the run's time (the whole run
# took 1009 s on an H100 with qwen2-7b at 14 of 28 layers and h2o-danube-
# 1.8b at 12 of 24, the eager replay of each serving run ~1 s a layer):
# qwen2-7b and h2o-danube-1.8b at 4 (phase_long decodes h2o at its full
# depth); minitron-8b at MINITRON_LAYERS
SERVED_LAYERS = {"minitron-8b": MINITRON_LAYERS, "qwen2-7b": 4,
                 "h2o-danube-1.8b": 4}
VLM_LAYERS = 2                      # of qwen2-vl-72b's 80 (see phase_vlm)
VLM_GRID = 8                        # patches a side: 64 a request


def family_config(arch, **over):
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), **over)


def free_device():
    """Drop what the collector can reach and return the cached blocks, so
    the next model's weights find the card's memory."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def family_fms(dev, cfg, seed):
    """One backbone on the card (q/k at the real fan-in, ``fan_in_qk``) and
    the same weights on the CPU, with the same three random rank-16
    adapters."""
    from repro_torch.core.physical import PhysicalFM
    from repro_torch.models.common import tree_map
    kw = dict(seed=seed, lora_rank=RANK, input_len=32, lora_impl="segmented",
              seg_block_t=BLOCK_T)
    gfm = PhysicalFM(cfg, device=dev, **kw)
    fan_in_qk(gfm.params, cfg)
    cfm = PhysicalFM(cfg, device="cpu", params=tree_map(
        lambda t: t.cpu(), gfm.params), **kw)
    for i in range(3):
        tree = random_adapter(gfm.adapters, i, dev)
        gfm.adapters.add(f"a{i}", tree)
        cfm.adapters.add(f"a{i}", tree_map(lambda t: t.cpu(), tree))
    return gfm, cfm


def phase_reference_family(dev, arch):
    """A two-layer cut of full-width ``arch`` (qwen2-7b: GQA 28 / 4, G 7,
    hd 128, a qkv bias; h2o-danube-1.8b: hd 80, a 4096-position window),
    prefill and teacher-forced decode through the kernels on the card
    against the same weights with the plain versions on the CPU, q/k at the
    real fan-in (``fan_in_qk``), three adapters and the base model: the
    dense int8 pool (segmented LoRA: K1, K3), the float pool (gather LoRA:
    K5) and the paged pool (the engine, full prefill: K4, K1), K2 carrying
    every prefill. qwen2-7b: 4 rows of 16 prompt tokens and 4 decode steps
    on the dense pools, phase_reference_paged's 4 streams (one shared
    prefix page) on the paged one. h2o-danube-1.8b: on the int8 and paged
    pools one stream of 4160 prompt tokens and 32 decode steps, so that its
    window binds in K2, K3 and K4; the float pool as qwen2's. Bounds as
    stablelm's: relative L2 2e-2 (dense pools), 3e-2 (paged), greedy tokens
    equal wherever the CPU's top-2 gap exceeds twice the largest logit
    difference; each leg's kernels must launch."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    cfg = family_config(arch, num_layers=2)
    gfm, cfm = family_fms(dev, cfg, seed=6)
    stack, cstack = gfm.adapters.stacked(), cfm.adapters.stacked()
    cap = gfm.adapters.capacity()
    long = arch == H2O
    rng = np.random.RandomState(8)
    report, ok = {}, True
    for leg, impl, kvq, kernels in (
            ("int8", "segmented", True, ("segmented_lora",
                                         "decode_attention_int8",
                                         "flash_attention", "rmsnorm")),
            ("float", "gather", False, ("decode_attention", "flash_attention",
                                        "rmsnorm"))):
        if long and leg == "int8":
            B, S, steps, aidx = 1, H2O_PROMPT, H2O_STEPS, np.array([1],
                                                                    np.int32)
        else:
            B, S, steps, aidx = 4, 16, 4, np.array([0, 2, cap, 1], np.int32)
        toks = rng.randint(0, cfg.vocab_size, (B, S + steps)).astype(np.int64)
        c = _teacher_forced(cfg, cfm, torch.device("cpu"), cfm.params, cstack,
                            cap, toks, aidx, S, steps, impl, kvq)
        ops.reset_launches()
        g = _teacher_forced(cfg, gfm, torch.device(dev), gfm.params, stack,
                            cap, toks, aidx, S, steps, impl, kvq)
        torch.cuda.synchronize()
        r = report[leg] = drift(g.flatten(0, 1), c.flatten(0, 1))
        r.update(rows=B, prompt=S, steps=steps, bound=2e-2, launches={
            k: int(ops.LAUNCHES[k]) for k in kernels})
        ok &= (r["finite"] and r["rel_l2"] <= 2e-2 and r["argmax_agree"]
               and all(v > 0 for v in r["launches"].values()))
    if long:
        prompts = [rng.randint(0, cfg.vocab_size, H2O_PROMPT).astype(np.int32)]
        names, plen, max_new = ["a1"], H2O_PROMPT, H2O_STEPS + 1
    else:
        prefix = rng.randint(0, cfg.vocab_size, PAGE_SIZE)
        prompts = [np.concatenate([prefix, rng.randint(0, cfg.vocab_size, 4)]),
                   np.concatenate([prefix, rng.randint(0, cfg.vocab_size, 9)]),
                   rng.randint(0, cfg.vocab_size, 20),
                   rng.randint(0, cfg.vocab_size, 13)]
        prompts = [p.astype(np.int32) for p in prompts]
        names, plen, max_new = ["a0", "a0", "a2", None], 32, CHUNK + 1
    ccalls, _ = _engine_run(cfm, prompts, names, prompt_len=plen,
                            max_new=max_new)
    ops.reset_launches()
    gcalls, geng = _engine_run(gfm, prompts, names, ccalls, prompt_len=plen,
                               max_new=max_new)
    torch.cuda.synchronize()
    r = report["paged"] = drift(torch.cat([lg[lv] for lg, lv in gcalls]),
                                torch.cat([lg[lv] for lg, lv in ccalls]))
    r.update(calls=[len(ccalls), len(gcalls)], prompt=plen, bound=3e-2,
             launches={k: int(ops.LAUNCHES[k]) for k in (
                 "paged_decode_attention", "segmented_lora",
                 "flash_attention", "rmsnorm")})
    ok &= (r["finite"] and r["rel_l2"] <= 3e-2 and r["argmax_agree"]
           and r["calls"][0] == r["calls"][1]
           and all(v > 0 for v in r["launches"].values()))
    del gfm, cfm, stack, cstack, geng
    free_device()
    report["seconds"] = time.perf_counter() - t0
    log(f"{arch} reference: 2-layer full-width cut, GPU vs CPU, int8 pool "
        f"(K3), float pool (K5), paged pool (K4): " + json.dumps(report))
    return bool(ok), report


def phase_family_serving(dev, arch, pool):
    """Full-width ``arch`` (at SERVED_LAYERS where the run's time cuts it)
    behind ``FMplexServer``/``ServeLoop`` as stablelm is served (random
    weights from a seed, 4 tasks with rank-16 q/v adapters, 8 slots,
    graphed): ``pool`` "dense" is
    ``phase_serving`` (the dense int8 pool), "paged" is
    ``phase_paged_serving`` (the paged pool of 45 pages, full prefill, the
    burst that defers and preempts), with the same gates. The server is
    freed before the next model is built."""
    t0 = time.perf_counter()
    cfg = family_config(arch, **({"num_layers": SERVED_LAYERS[arch]}
                                 if arch in SERVED_LAYERS else {}))
    log(f"{arch} {pool} serving at {cfg.num_layers} of "
        f"{family_config(arch).num_layers} layers")
    if pool == "dense":
        ok, stats, handles = phase_serving(dev, cfg)
    else:
        ok, stats, handles = phase_paged_serving(dev, cfg=cfg)
    del handles
    free_device()
    stats["seconds"] = time.perf_counter() - t0
    log(f"{arch} {pool} serving: ok {ok}, {stats['tokens_per_s']:.1f} "
        f"tokens/s, TTFT p50 {stats['ttft_p50_ms']:.1f} ms, TPOT p50 "
        f"{stats['tpot_p50_ms']:.2f} ms, {stats['seconds']:.1f} s")
    return ok, stats


def vlm_inputs(rng, B, d):
    """B requests of VLM_GRID x VLM_GRID vision-patch embeddings (numpy)
    and their M-RoPE streams (B, S, 3): t the request's frame (0-2), h and
    w the patch's row and column."""
    import numpy as np
    S = VLM_GRID * VLM_GRID
    emb = (rng.randn(B, S, d) * 0.5).astype(np.float32)
    s = np.arange(S)
    pos3 = np.stack([np.zeros(S, int), s // VLM_GRID, s % VLM_GRID], -1)
    pos3 = pos3[None] + np.stack([rng.randint(0, 3, B), np.zeros(B, int),
                                  np.zeros(B, int)], -1)[:, None]
    return emb, pos3.astype(np.int64)


def phase_vlm(dev):
    """qwen2-vl-72b at full width (d 8192, 64 query heads over 8 kv heads
    of 128, M-RoPE sections (16, 24, 24), a qkv bias, vocab 152064), its
    depth cut to VLM_LAYERS of 80: 145 GB of bf16 weights do not fit one
    80 GB card, 2 layers hold 4.3 B parameters (most of them the embedding
    and the f32 head). q/k at the real fan-in (``fan_in_qk``), three
    adapters. (1) One pooled batch of 8 requests of 64 vision-patch
    embeddings through ``PhysicalFM.run_batch_device`` (segmented LoRA):
    finite (8, d) features, K1 and K2 launched. (2) Two streams of 64 patch
    embeddings with M-RoPE streams prefilled into the dense int8 pool, then
    4 greedy decode steps (text positions, t = h = w), on the card fed the
    CPU run's tokens: relative L2 of the logits at most 2e-2, the greedy
    tokens equal where the CPU's top-2 gap exceeds twice the largest
    difference, K3 launched. (3) ``apply_mrope`` on the card at distinct
    (t, h, w) streams against its CPU run: two bf16 ulps of the largest
    output."""
    import numpy as np
    import torch

    from repro_torch.core.physical import seg_to_device
    from repro_torch.kernels import ops
    from repro_torch.models import layers, lm
    t0 = time.perf_counter()
    full = family_config(QWEN2_VL)
    cfg = family_config(QWEN2_VL, num_layers=VLM_LAYERS)
    reduced = {"num_layers": [full.num_layers, cfg.num_layers],
               "params_b": [full.param_count() / 1e9,
                            cfg.param_count() / 1e9]}
    gfm, cfm = family_fms(dev, cfg, seed=9)
    rng = np.random.RandomState(10)
    cap = gfm.adapters.capacity()
    report, ok = {"reduced": reduced}, True
    # (1) the pooled forward
    x, _ = vlm_inputs(rng, 8, cfg.d_model)
    ops.reset_launches()
    feats = gfm.run_batch_device(x, np.array([0, 1, 2, cap, 0, 1, 2, cap],
                                             np.int32))
    torch.cuda.synchronize()
    pooled = {"shape": list(feats.shape),
              "finite": bool(torch.isfinite(feats.float()).all()),
              "launches": {k: int(ops.LAUNCHES[k]) for k in (
                  "segmented_lora", "flash_attention", "rmsnorm")}}
    ok &= pooled["shape"] == [8, cfg.d_model] and pooled["finite"] and \
        all(v > 0 for v in pooled["launches"].values())
    report["pooled"] = pooled
    # (2) prefill from patches with M-RoPE, then greedy decode
    B, steps = 2, 4
    emb, pos3 = vlm_inputs(rng, B, cfg.d_model)
    S = emb.shape[1]
    aidx = np.array([1, cap], np.int32)

    def run(d, fm, teacher=None):
        stack = fm.adapters.stacked()

        def meta(n):
            perm, inv, blocks = seg_to_device(
                *fm.segment_meta(aidx, cap, n), d)
            return {"perm": perm, "inv": inv, "block_adapter": blocks,
                    "block_t": fm.seg_block_t}
        ai = torch.as_tensor(aidx, device=d)
        cache = lm.init_cache(cfg, B, S + steps + 1, kv_quant=True, device=d)
        logits, cache = lm.prefill(
            fm.params, cfg, embeds=torch.as_tensor(emb, device=d),
            pos3=torch.as_tensor(pos3, device=d), cache=cache, lora=stack,
            adapter_idx=ai, lora_impl="segmented", lora_seg=meta(S))
        out, toks = [logits.float().cpu()], []
        for t in range(steps):
            tok = out[-1].argmax(-1) if teacher is None else teacher[t]
            toks.append(tok)
            logits, cache = lm.decode_step(
                fm.params, cfg, tokens=tok.to(d), cache=cache, lora=stack,
                adapter_idx=ai, lora_impl="segmented", lora_seg=meta(1))
            out.append(logits.float().cpu())
        return torch.stack(out), toks
    c, toks = run(torch.device("cpu"), cfm)
    ops.reset_launches()
    g, _ = run(torch.device(dev), gfm, toks)
    torch.cuda.synchronize()
    r = report["decode"] = drift(g.flatten(0, 1), c.flatten(0, 1))
    r.update(rows=B, patches=S, steps=steps, bound=2e-2, launches={
        k: int(ops.LAUNCHES[k]) for k in ("decode_attention_int8",
                                          "flash_attention",
                                          "segmented_lora")})
    ok &= (r["finite"] and r["rel_l2"] <= 2e-2 and r["argmax_agree"]
           and all(v > 0 for v in r["launches"].values()))
    # (3) M-RoPE on the card against its CPU run
    xq = torch.randn((B, S, cfg.num_heads, cfg.head_dim),
                     generator=torch.Generator().manual_seed(11)).to(
        torch.bfloat16)
    p3 = torch.as_tensor(pos3 * 7)        # farther angles than the grid's
    want = layers.apply_mrope(xq, p3, cfg.mrope_sections, cfg.rope_theta)
    got = layers.apply_mrope(xq.to(dev), p3.to(dev), cfg.mrope_sections,
                             cfg.rope_theta).cpu()
    err = (got.float() - want.float()).abs().max().item()
    tol = 2 * 2.0 ** -8 * want.float().abs().max().item()
    report["mrope"] = {"max_abs_err": err, "bound": tol,
                       "distinct_streams": bool((p3[..., 1] != p3[..., 2])
                                                .any())}
    ok &= err <= tol and report["mrope"]["distinct_streams"]
    del gfm, cfm, feats
    free_device()
    report["seconds"] = time.perf_counter() - t0
    log(f"qwen2-vl-72b: reduced {json.dumps(reduced)}: "
        + json.dumps(report, default=float))
    return bool(ok), report


def phase_families(dev):
    """The other attention-only families (the slice's models): full-width
    serving of qwen2-7b (dense and paged), h2o-danube-1.8b (dense and
    paged) and minitron-8b (paged), each at SERVED_LAYERS. Their references
    (``family_references``) and qwen2-vl-72b (``stack_references``) run in
    child processes beside phase_mesh. Each step's seconds are printed; returns
    (phase results, serving stats)."""
    phases, stats = {}, {}
    for arch, pool in ((QWEN2, "dense"), (QWEN2, "paged"), (H2O, "dense"),
                       (H2O, "paged"), (MINITRON, "paged")):
        key = f"{arch} {pool} serving"
        phases[key], stats[key] = phase_family_serving(dev, arch, pool)
    return phases, stats


def family_references(dev):
    """The qwen2-7b and h2o-danube-1.8b references, each the card against
    the CPU (they check, and time nothing; qwen2-vl-72b runs with the
    stacks' references, ``stack_references``, so that the largest CPU
    models are built one at a time): (phase results, their reports)."""
    phases, stats = {}, {}
    for arch in (QWEN2, H2O):
        key = f"{arch} reference"
        phases[key], stats[key] = phase_reference_family(dev, arch)
    return phases, stats


def family_timing(dev) -> dict:
    """Device time per call of each attention kernel at the shapes the
    other families give it, beside its bound and one PyTorch call that
    computes the same function (SDPA; never called by the port): K2 at
    qwen2-7b's and h2o-danube-1.8b's pooled forward (32 x 128) and h2o's
    4160-token prefill in a 4352 bucket under its window
    (``flash_timing``); K3 (``int8_timing``) and K4 (``paged_timing``) at 8
    streams of qwen2's pool (s_max 161) and of h2o's under its window
    (lengths 4097-4200); the verify window (``verify_timing``, T 5) at
    both; K5 (``float_decode_timing``) at both float pools; K1 at the four
    configs' q and v projections of a decode step (8 tokens) and rmsnorm
    over a decode step's 8 rows at their widths (``rmsnorm_timing``)."""
    import torch

    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(12)
    S = PROMPT_LEN + MAX_NEW + 1
    out = {"flash_attention": flash_timing(dev, (
        ("qwen2_pooled", 6), ("h2o_pooled", 6), ("h2o_window_prefill", 2)))}
    out["decode_attention_int8"] = {
        "qwen2": int8_timing(dev, gen, 28, 4, 128, S, 24),
        "h2o_window": int8_timing(dev, gen, 32, 8, 80, 4200, 6, window=4096,
                                  lo=4097)}
    out["paged_decode_attention"] = {
        "qwen2": paged_timing(dev, gen, 28, 4, 128, S, 24),
        "h2o_window": paged_timing(dev, gen, 32, 8, 80, 4200, 6,
                                   window=4096, lo=4097)}
    out["paged_verify_attention"] = {
        "qwen2": verify_timing(dev, gen, 24, H=28, KV=4, hd=128),
        "h2o_window": verify_timing(dev, gen, 6, H=32, KV=8, hd=80, MP=264,
                                    window=4096, base_lo=4097)}
    out["decode_attention"] = float_decode_timing(
        dev, (("qwen2_pool", 24), ("h2o_pool_window", 6)))
    # K1 at the q and v projections of a decode step (no library call
    # computes it), and rmsnorm over a decode step's rows at each width
    cases = sgmv_cases(full_config())
    out["segmented_lora"] = {}
    for name in (f"{m}_{p}" for m in ("qwen2", "h2o", "minitron", "qwen2_vl")
                 for p in "qv"):
        T, dd, oo = cases[name]["T"], cases[name]["d"], cases[name]["out"]
        sets = sgmv_inputs(gen, T, dd, oo, 4, 8, dev)
        b_ms, b_by = sgmv_bound(*sets[0])
        k_ms = device_ms(rotating(lambda x, i, a, b: ops.segmented_lora(
            x, i, a, b, block_t=BLOCK_T), sets))
        out["segmented_lora"][name] = dict(T=T, d=dd, out=oo, ms=k_ms,
                                           bound_ms=b_ms, bound_by=b_by,
                                           library_ms=None)
    out["rmsnorm"] = {f"d{d}": rmsnorm_timing(dev, gen, d, (
        ("decode", SLOTS),))["decode"] for d in (2560, 3584, 4096, 8192)}
    log("family timing: " + json.dumps(out, default=float))
    return out


# ---------------- phase 10: the MoE, Mamba and xLSTM stacks ----------------

OLMOE, JAMBA, XLSTM, GROK = ("olmoe-1b-7b", "jamba-v0.1-52b", "xlstm-125m",
                             "grok-1-314b")
# jamba-v0.1-52b's 98.7 GB of bf16 weights do not fit one 80 GB card: 8 of
# its 32 layers (one whole period of the 1:7 Mamba:attention interleave,
# 12.74 B parameters; 16 layers, two periods, fit too but the whole run then
# took 769 s against the 750 s aimed at); grok-1-314b 1 of its 64 (5.7 B
# parameters on the card and again on the CPU; 2 layers took 26.5 s)
JAMBA_LAYERS, GROK_LAYERS = 8, 1
# olmoe-1b-7b at 4 of its 16 layers (the run's time; its serving took
# ~58 s at 16 and 9.6 + 13.8 s dense and paged at 8)
OLMOE_LAYERS = 4
# xlstm-125m at 4 of its 12 layers (one period of its sublayer pattern),
# to keep the whole run near 800 s once the LM training phase came in (a
# run took 745-867 s with it whole; its 12-layer serving took 50 s, its
# recurrent prefill sequential)
XLSTM_LAYERS = 4
GROK_PROMPT, GROK_STEPS = 32, 4


@contextlib.contextmanager
def route_log():
    """Every MoE call's expert choices while open: each token's top-k
    experts from its own router input, sorted, on the host ((B, S, k) a
    call, in call order). Eager runs only (it reads back to the host)."""
    import numpy as np
    import torch

    from repro_torch.models import blocks, moe
    calls = []
    orig = blocks.moe_ffn

    def record(p, x, *, k, **kw):
        _, idx = moe.top_k(torch.softmax(x.float() @ p["router"].float(),
                                         dim=-1), k)
        calls.append(np.sort(idx.cpu().numpy(), axis=-1))
        return orig(p, x, k=k, **kw)
    blocks.moe_ffn = record
    try:
        yield calls
    finally:
        blocks.moe_ffn = orig


def route_flips(gcalls, ccalls, n_moe, valid=None) -> dict:
    """Routing agreement, card against CPU: per MoE layer of the period
    (call index mod ``n_moe``), the share of (valid) tokens whose top-k
    set differs."""
    import numpy as np
    if len(gcalls) != len(ccalls):
        raise RuntimeError(f"MoE calls {len(gcalls)} on the card, "
                           f"{len(ccalls)} on the CPU")
    per = {}
    for i, (a, b) in enumerate(zip(gcalls, ccalls)):
        f = (a != b).any(-1)
        v = np.ones(f.shape, bool) if valid is None else valid(i, f.shape)
        d = per.setdefault(i % n_moe, [0, 0])
        d[0] += int((f & v).sum())
        d[1] += int(v.sum())
    return {f"moe_call_{l}": {"flipped": n, "tokens": t,
                              "share": n / max(t, 1)}
            for l, (n, t) in sorted(per.items())}


def keep_unflipped_tf(gcalls, ccalls, n_moe, B, S, steps):
    """(1 + steps, B) bool: the logits of ``_teacher_forced`` (prefill of S
    tokens, then ``steps`` decode steps) to compare: each row's up to its
    first token routed to other experts on the card than on the CPU
    (call j reads position S - 1 + j)."""
    import numpy as np
    first = np.full((B,), S + steps)
    for i, (a, b) in enumerate(zip(gcalls, ccalls)):
        f = (a != b).any(-1)                                  # (B, s)
        fwd = i // n_moe                      # 0: the prefill, t + 1: step t
        pos = np.arange(f.shape[1]) if fwd == 0 else np.array([S + fwd - 1])
        hit = np.where(f, pos[None], S + steps).min(axis=1)
        first = np.minimum(first, hit)
    return (S - 1 + np.arange(1 + steps))[:, None] < first[None]


def keep_unflipped_engine(gcalls, ccalls, n_moe, calls, prompts):
    """Per sampler call of ``_engine_run`` (its prompts admitted in order
    into slots 0.., one prefill each, then decode steps of every slot):
    the rows to compare, each stream's up to the first call that routes one
    of its tokens to other experts on the card than on the CPU."""
    import numpy as np
    flipped, keep = set(), []
    for c, (lg, live) in enumerate(calls):
        pairs = list(zip(gcalls[c * n_moe:(c + 1) * n_moe],
                         ccalls[c * n_moe:(c + 1) * n_moe]))
        if c < len(prompts):                  # the prefill of stream c
            if lg.shape[0] != 1:
                raise RuntimeError("the streams did not admit in order")
            n = len(prompts[c])
            if any((a != b).any(-1)[0, :n].any() for a, b in pairs):
                flipped.add(c)
            keep.append(np.array([c not in flipped]))
            continue
        f = np.zeros((lg.shape[0],), bool)
        for a, b in pairs:
            f |= (a != b).any(-1)[:, 0]
        flipped |= {int(r) for r in np.nonzero(f & live)[0]}
        keep.append(live & np.array([r not in flipped
                                     for r in range(lg.shape[0])]))
    return keep


def stack_config(arch, **over):
    """``arch`` at full width, cut where one card forces it (jamba to
    JAMBA_LAYERS, grok to GROK_LAYERS layers) or the run's time does
    (xlstm to XLSTM_LAYERS, olmoe to OLMOE_LAYERS)."""
    cut = {JAMBA: JAMBA_LAYERS, GROK: GROK_LAYERS,
           XLSTM: XLSTM_LAYERS, OLMOE: OLMOE_LAYERS}.get(arch)
    if cut is not None and "num_layers" not in over:
        over["num_layers"] = cut
    return family_config(arch, **over)


def phase_reference_stack(dev, name, cfg):
    """``cfg`` at full width on the card against the same weights and
    adapters on the CPU (``family_fms``: attention q/k and the mLSTM q/k/v
    at their real fan-in): with attention, prefill and teacher-forced
    decode on the dense int8 pool (segmented LoRA: K1, K3) and the float
    pool (gather LoRA: K5), K2 carrying every prefill, and the paged
    engine (K4); without (xlstm-125m), the dense pool alone (rmsnorm).
    4 rows of 16 prompt tokens and 4 decode steps on the dense pools,
    phase_reference_paged's 4 streams on the paged one. Bounds as
    stablelm's: relative L2 2e-2 (dense pools), 3e-2 (paged), greedy tokens
    equal wherever the CPU's top-2 gap exceeds twice the largest logit
    difference, each leg's kernels launched. On a MoE stack each leg
    reports the share of tokens routed to other experts on the card than
    on the CPU, per MoE layer, and compares each row up to its first such
    flip (``keep_unflipped_tf``/``keep_unflipped_engine``), the rows left
    out counted."""
    import numpy as np
    import torch

    from repro_torch.configs.base import ATTN
    from repro_torch.kernels import ops
    from repro_torch.models import blocks
    t0 = time.perf_counter()
    layout = blocks.period_layout(cfg)
    nper = cfg.num_layers // len(layout)
    n_moe = nper * sum(lay.has_moe for lay in layout)
    attn = any(lay.kind == ATTN for lay in layout)
    gfm, cfm = family_fms(dev, cfg, seed=6)
    stack, cstack = gfm.adapters.stacked(), cfm.adapters.stacked()
    cap = gfm.adapters.capacity()
    rng = np.random.RandomState(8)
    report = {"params_b": sum(t.numel() for t in _leaves(gfm.params)) / 1e9}
    ok = True
    legs = (("int8", "segmented", True, ("segmented_lora",
                                         "decode_attention_int8",
                                         "flash_attention", "rmsnorm")),
            ("float", "gather", False, ("decode_attention",
                                        "flash_attention", "rmsnorm"))) \
        if attn else (("dense", "gather", True, ("rmsnorm",)),)
    for leg, impl, kvq, kernels in legs:
        B, S, steps, aidx = 4, 16, 4, np.array([0, 2, cap, 1], np.int32)
        toks = rng.randint(0, cfg.vocab_size, (B, S + steps)).astype(np.int64)
        with route_log() as croutes:
            c = _teacher_forced(cfg, cfm, torch.device("cpu"), cfm.params,
                                cstack, cap, toks, aidx, S, steps, impl, kvq)
        ops.reset_launches()
        with route_log() as groutes:
            g = _teacher_forced(cfg, gfm, torch.device(dev), gfm.params,
                                stack, cap, toks, aidx, S, steps, impl, kvq)
        torch.cuda.synchronize()
        keep = torch.as_tensor(keep_unflipped_tf(
            groutes, croutes, n_moe, B, S, steps)) if n_moe else \
            torch.ones(g.shape[:2], dtype=torch.bool)
        r = report[leg] = drift(g[keep], c[keep])
        r.update(rows=B, prompt=S, steps=steps, bound=2e-2,
                 finite_all=bool(torch.isfinite(g).all()),
                 compared=[int(keep.sum()), keep.numel()], launches={
                     k: int(ops.LAUNCHES[k]) for k in kernels})
        if n_moe:
            r["routing"] = route_flips(groutes, croutes, n_moe)
        ok &= (r["finite_all"] and r["rel_l2"] <= 2e-2 and r["argmax_agree"]
               and r["compared"][0] > 0
               and all(v > 0 for v in r["launches"].values()))
    if attn:
        prefix = rng.randint(0, cfg.vocab_size, PAGE_SIZE)
        prompts = [np.concatenate([prefix, rng.randint(0, cfg.vocab_size, 4)]),
                   np.concatenate([prefix, rng.randint(0, cfg.vocab_size, 9)]),
                   rng.randint(0, cfg.vocab_size, 20),
                   rng.randint(0, cfg.vocab_size, 13)]
        prompts = [p.astype(np.int32) for p in prompts]
        names = ["a0", "a0", "a2", None]
        with route_log() as croutes:
            ccalls, _ = _engine_run(cfm, prompts, names)
        ops.reset_launches()
        with route_log() as groutes:
            gcalls, geng = _engine_run(gfm, prompts, names, ccalls)
        torch.cuda.synchronize()
        keep = keep_unflipped_engine(groutes, croutes, n_moe, ccalls,
                                     prompts) if n_moe else \
            [lv for _, lv in ccalls]
        gk = [lg[torch.as_tensor(k)] for (lg, _), k in zip(gcalls, keep)]
        ck = [lg[torch.as_tensor(k)] for (lg, _), k in zip(ccalls, keep)]
        r = report["paged"] = drift(torch.cat(gk), torch.cat(ck))
        r.update(calls=[len(ccalls), len(gcalls)], bound=3e-2,
                 finite_all=all(bool(torch.isfinite(lg).all())
                                for lg, _ in gcalls),
                 compared=[int(sum(k.sum() for k in keep)),
                           int(sum(lv.sum() for _, lv in ccalls))],
                 prefix_sharing=geng.prefix_sharing,
                 launches={k: int(ops.LAUNCHES[k]) for k in (
                     "paged_decode_attention", "segmented_lora",
                     "flash_attention", "rmsnorm")})
        if n_moe:
            def valid(i, shape):
                """A prefill's prompt positions, a decode step's live
                rows."""
                c = i // n_moe
                if c < len(prompts):
                    return np.arange(shape[1])[None] < len(prompts[c])
                return ccalls[c][1][:, None]
            r["routing"] = route_flips(groutes, croutes, n_moe, valid)
        ok &= (r["finite_all"] and r["rel_l2"] <= 3e-2 and r["argmax_agree"]
               and r["calls"][0] == r["calls"][1] and r["compared"][0] > 0
               and all(v > 0 for v in r["launches"].values()))
        del geng
    del gfm, cfm, stack, cstack
    free_device()
    report["seconds"] = time.perf_counter() - t0
    log(f"{name} reference (GPU vs CPU): " + json.dumps(report, default=float))
    return bool(ok), report


def phase_stack_serving(dev, arch, pool, profile: bool = False):
    """Full-width ``arch`` (cut by ``stack_config``) behind
    ``FMplexServer``/``ServeLoop`` as stablelm is served (4 tasks with
    rank-16 q/v adapters, 8 slots, graphed, equal to its eager replay, no
    key after warm-up): ``pool`` "dense" is ``phase_serving``, "paged"
    ``phase_paged_serving`` (full prefill; on a stack with recurrent state
    the prefix-hit gates give way to the demotions, a preemption that
    re-prefills and the state slots drained). ``profile``: one decode step
    of 8 live streams on the server's engine, profiled eager and graphed
    (``live_step_timing``). The server is freed before the next model."""
    t0 = time.perf_counter()
    cfg = stack_config(arch)
    if pool == "dense":
        ok, stats, handles = phase_serving(dev, cfg)
    else:
        ok, stats, handles = phase_paged_serving(dev, cfg=cfg)
    if profile:
        stats["step"] = live_step_timing(dev, handles, "", seed=31,
                                         rid0=-3000)
        log(f"{arch} {pool} decode step: "
            + json.dumps(stats["step"], default=float))
    del handles
    free_device()
    stats["seconds"] = time.perf_counter() - t0
    stats["layers"] = [cfg.num_layers, family_config(arch).num_layers]
    log(f"{arch} {pool} serving ({cfg.num_layers} layers): ok {ok}, "
        f"{stats['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{stats['ttft_p50_ms']:.1f} ms, TPOT p50 "
        f"{stats['tpot_p50_ms']:.2f} ms, {stats['seconds']:.1f} s")
    return ok, stats


def phase_grok(dev):
    """grok-1-314b at full width (d 6144, 48 query heads over 8 kv heads
    of 128: K3 at its group of 6; 8 experts of d_ff 32768, top-2), its
    depth cut to GROK_LAYERS of 64. (1) One pooled batch of 8 requests of
    32 embedding rows through ``PhysicalFM.run_batch_device``: finite (8,
    d) features, K1 and K2 launched. (2) Two streams of GROK_PROMPT tokens
    prefilled into the dense int8 pool, then GROK_STEPS greedy decode
    steps, on the card fed the CPU run's tokens: relative L2 of the logits
    at most 2e-2 (rows up to their first routing flip, counted), the greedy
    tokens equal where the CPU's top-2 gap exceeds twice the largest
    difference, K3 launched."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    full, cfg = family_config(GROK), stack_config(GROK)
    reduced = {"num_layers": [full.num_layers, cfg.num_layers],
               "params_b": [full.param_count() / 1e9,
                            cfg.param_count() / 1e9]}
    gfm, cfm = family_fms(dev, cfg, seed=13)
    rng = np.random.RandomState(14)
    cap = gfm.adapters.capacity()
    report, ok = {"reduced": reduced}, True
    x = (rng.randn(8, 32, cfg.d_model) * 0.5).astype(np.float32)
    ops.reset_launches()
    feats = gfm.run_batch_device(x, np.array([0, 1, 2, cap, 0, 1, 2, cap],
                                             np.int32))
    torch.cuda.synchronize()
    pooled = {"shape": list(feats.shape),
              "finite": bool(torch.isfinite(feats.float()).all()),
              "launches": {k: int(ops.LAUNCHES[k]) for k in (
                  "segmented_lora", "flash_attention", "rmsnorm")}}
    ok &= pooled["shape"] == [8, cfg.d_model] and pooled["finite"] and \
        all(v > 0 for v in pooled["launches"].values())
    report["pooled"] = pooled
    B, S, steps = 2, GROK_PROMPT, GROK_STEPS
    aidx = np.array([1, cap], np.int32)
    prompt = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int64)

    def run(d, fm, teacher=None):
        """Prefill, then greedy decode steps (fed ``teacher``'s tokens
        where given): the logits of every call, and the tokens fed."""
        from repro_torch.core.physical import seg_to_device
        from repro_torch.models import lm
        stack = fm.adapters.stacked()

        def meta(n):
            perm, inv, blocks = seg_to_device(
                *fm.segment_meta(aidx, cap, n), d)
            return {"perm": perm, "inv": inv, "block_adapter": blocks,
                    "block_t": fm.seg_block_t}
        ai = torch.as_tensor(aidx, device=d)
        cache = lm.init_cache(cfg, B, S + steps + 1, kv_quant=True, device=d)
        logits, cache = lm.prefill(
            fm.params, cfg, tokens=torch.as_tensor(prompt, device=d),
            cache=cache, lora=stack, adapter_idx=ai, lora_impl="segmented",
            lora_seg=meta(S))
        out, fed = [logits.float().cpu()], []
        for t in range(steps):
            tok = out[-1].argmax(-1) if teacher is None else teacher[t]
            fed.append(tok)
            logits, cache = lm.decode_step(
                fm.params, cfg, tokens=tok.to(d), cache=cache, lora=stack,
                adapter_idx=ai, lora_impl="segmented", lora_seg=meta(1))
            out.append(logits.float().cpu())
        return torch.stack(out), fed
    with route_log() as croutes:
        c, fed = run(torch.device("cpu"), cfm)
    ops.reset_launches()
    with route_log() as groutes:
        g, _ = run(torch.device(dev), gfm, fed)
    torch.cuda.synchronize()
    n_moe = cfg.num_layers
    keep = torch.as_tensor(keep_unflipped_tf(groutes, croutes, n_moe, B, S,
                                             steps))
    r = report["decode"] = drift(g[keep], c[keep])
    r.update(rows=B, prompt=S, steps=steps, bound=2e-2,
             finite_all=bool(torch.isfinite(g).all()),
             compared=[int(keep.sum()), keep.numel()],
             routing=route_flips(groutes, croutes, n_moe),
             launches={k: int(ops.LAUNCHES[k]) for k in (
                 "decode_attention_int8", "flash_attention",
                 "segmented_lora", "rmsnorm")})
    ok &= (r["finite_all"] and r["rel_l2"] <= 2e-2 and r["argmax_agree"]
           and r["compared"][0] > 0
           and all(v > 0 for v in r["launches"].values()))
    del gfm, cfm, feats
    free_device()
    report["seconds"] = time.perf_counter() - t0
    log(f"grok-1-314b: reduced {json.dumps(reduced)}: "
        + json.dumps(report, default=float))
    return bool(ok), report


def phase_stacks(dev):
    """The MoE, Mamba and xLSTM stacks: full-width serving of olmoe-1b-7b
    (dense and paged), jamba-v0.1-52b at JAMBA_LAYERS layers (dense and
    paged) and xlstm-125m (dense), a profiled decode step of olmoe and of
    jamba. Their references and grok-1-314b run in a child process beside
    phase_mesh (``stack_references``). Each step's seconds are printed;
    returns (phase results, serving stats)."""
    phases, stats = {}, {}
    for arch, pool, prof in ((OLMOE, "dense", True), (OLMOE, "paged", False),
                             (JAMBA, "dense", True), (JAMBA, "paged", False),
                             (XLSTM, "dense", False)):
        key = f"{arch} {pool} serving"
        phases[key], stats[key] = phase_stack_serving(dev, arch, pool, prof)
    return phases, stats


def stack_references(dev):
    """The olmoe, jamba-probe and xlstm references, grok-1-314b at
    GROK_LAYERS layers and qwen2-vl-72b at VLM_LAYERS, each the card
    against the CPU (they check, and time nothing): (phase results, their
    reports)."""
    from repro_torch.configs.base import ATTN, MAMBA
    phases, stats = {}, {}
    for name, cfg in (
            (f"{OLMOE} 2-layer", stack_config(OLMOE, num_layers=2)),
            # one attention sublayer with its dense MLP and one Mamba
            # sublayer with its 16-expert MoE: the two sublayer kinds of
            # jamba's period at full width (3.7 B parameters on the CPU in
            # place of 12.7 B for one whole period)
            (f"{JAMBA} probe", stack_config(JAMBA, num_layers=2,
                                            block_pattern=(ATTN, MAMBA))),
            (XLSTM, stack_config(XLSTM))):
        key = f"{name} reference"
        phases[key], stats[key] = phase_reference_stack(dev, name, cfg)
    key = f"{GROK} pooled and decode"
    phases[key], stats[key] = phase_grok(dev)
    key = f"{QWEN2_VL} pooled and decode"
    phases[key], stats[key] = phase_vlm(dev)
    return phases, stats


def stack_timing(dev) -> dict:
    """Device time per call of the attention kernels at the shapes the
    MoE and hybrid stacks give them, beside the bound and SDPA: K2 at
    olmoe's (16 / 16, hd 128) and jamba's (32 / 8, hd 128) pooled forward
    (32 x 128) and admission (one 128-token bucket), K3 and K4 at 8
    streams of each model's pool (s_max 161), and K3 at grok's group of 6
    (48 / 8)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(15)
    S = PROMPT_LEN + MAX_NEW + 1
    out = {"flash_attention": flash_timing(dev, (
        ("olmoe_pooled", 6), ("olmoe_admission", 48), ("jamba_pooled", 6),
        ("jamba_admission", 48)))}
    out["decode_attention_int8"] = {
        "olmoe": int8_timing(dev, gen, 16, 16, 128, S, 24),
        "jamba": int8_timing(dev, gen, 32, 8, 128, S, 24),
        "grok": int8_timing(dev, gen, 48, 8, 128, S, 24)}
    out["paged_decode_attention"] = {
        "olmoe": paged_timing(dev, gen, 16, 16, 128, S, 24),
        "jamba": paged_timing(dev, gen, 32, 8, 128, S, 24)}
    log("stack timing: " + json.dumps(out, default=float))
    return out


# ---------------- phase 6: timing ----------------

def rotating(fn, items):
    """A call of ``fn`` on the next of ``items`` (argument tuples) in turn."""
    it = [0]

    def call():
        fn(*items[it[0] % len(items)])
        it[0] += 1
    return call


def window_mask(S, lens, window, dev):
    """(B, 1, 1, S) bool: the positions below each length, and with a
    window the last ``window`` of them."""
    import torch
    pos = torch.arange(S, device=dev)[None]
    mask = pos < lens[:, None]
    if window is not None:
        mask &= pos >= lens[:, None] - window
    return mask[:, None, None]


def int8_timing(dev, gen, H, KV, hd, S, nsets, window=None, lo=1) -> dict:
    """K3's device time per call on 8 rows of an int8 cache of ``S``
    positions with lengths random in [``lo``, S] (``window``: attended
    under it), over ``nsets`` input sets (one per layer, so each call finds
    its cache cold), its plain version's, one
    ``scaled_dot_product_attention`` call on the cache already dequantized
    to bf16 (never called by the port; the dequantization not timed), the
    bound on this data, and the host-clock time of a call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    lens = None
    if lo > 1:
        lens = torch.randint(lo, S + 1, (SLOTS,), generator=torch.Generator()
                             .manual_seed(S)).tolist()
    sets = int8_inputs(gen, SLOTS, H, KV, S, hd, nsets, dev, lens=lens)
    kernel = rotating(lambda q, kq, vq, ks, vs, l: ops.decode_attention_int8(
        q, kq, vq, ks, vs, l, window=window), sets)
    by_kernel = device_kernels(kernel)
    k_ms = sum(by_kernel.values())
    p_ms = device_ms(rotating(lambda q, kq, vq, ks, vs, l: ref.decode_attention_int8_ref(
        q, kq.transpose(1, 2), vq.transpose(1, 2), ks, vs, l, window=window),
        sets), iters=5 if S > 1024 else 20)
    lib_sets = []
    for q, kq, vq, ks, vs, l in sets:
        kd = (kq.transpose(1, 2).float() * ks[:, :, None, None]).to(torch.bfloat16)
        vd = (vq.transpose(1, 2).float() * vs[:, :, None, None]).to(torch.bfloat16)
        G = H // KV
        lib_sets.append((q[:, :, None], kd.repeat_interleave(G, dim=1),
                         vd.repeat_interleave(G, dim=1),
                         window_mask(S, l, window, dev)))
    lib_ms = device_ms(rotating(lambda q, k, v, m: F.scaled_dot_product_attention(
        q, k, v, attn_mask=m), lib_sets))
    b_ms, b_by = int8_bound(sets[0][0], sets[0][1], sets[0][5], window)
    plan = k3_plan(SLOTS, KV, H // KV, hd, S, window, dev)
    split = kernel_split(by_kernel, K3_PARTS)
    log(f"decode_attention_int8 [H={H} KV={KV} hd={hd} S={S} window={window}]: "
        f"plan {plan}, {k_ms * 1e3:.2f} us ("
        + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in split.items() if v)
        + f"; SDPA {lib_ms * 1e3:.2f}, bound {b_ms * 1e3:.2f})")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, plan=plan, split_ms=split,
                enqueue_ms=time_ms(kernel))


def paged_timing(dev, gen, H, KV, hd, s_max, nsets, window=None,
                 lo=None) -> dict:
    """K4's device time per call on 8 streams with ragged lengths up to
    ``s_max`` (from ``lo`` where given; ``window``: attended under it; a
    table of ceil(s_max / 16) pages), over ``nsets``
    dense-equivalent arenas (one per layer, so each call finds its pages
    cold), its plain version's, one ``scaled_dot_product_attention`` call
    on the pages already gathered and dequantized to bf16 (never called by
    the port; the gather not timed), the bound counted on this data, and
    the host-clock time of a call (``enqueue_ms``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    MP = -(-s_max // PAGE_SIZE)
    lens = None
    if lo is not None:
        lens = torch.randint(lo, s_max + 1, (SLOTS,),
                             generator=torch.Generator().manual_seed(s_max)
                             ).tolist()
    sets = paged_inputs(gen, SLOTS, H, KV, hd, 1 + SLOTS * MP, nsets, dev,
                        lens=lens, MP=MP)
    for st in sets:
        st[6].clamp_(max=s_max)
    kernel = rotating(lambda *a: ops.paged_decode_attention(*a, window=window),
                      sets)
    by_kernel = device_kernels(kernel)
    k_ms = sum(by_kernel.values())
    p_ms = device_ms(rotating(lambda q, kp, vp, ks, vs, pt, l:
                              ref.paged_decode_attention_ref(
                                  q, kp.transpose(1, 2), vp.transpose(1, 2),
                                  ks, vs, pt, l, window=window), sets),
                     iters=5 if s_max > 1024 else 20)
    lib_sets = []
    for q, kp, vp, ks, vs, pt, l in sets:
        def gathered(pages, sc):
            g = pages[pt.long()].float() * sc[pt.long()][:, :, None, :, None]
            return g.permute(0, 3, 1, 2, 4).reshape(
                SLOTS, KV, MP * PAGE_SIZE, hd).to(torch.bfloat16)
        G = H // KV
        lib_sets.append((q[:, :, None],
                         gathered(kp, ks).repeat_interleave(G, dim=1),
                         gathered(vp, vs).repeat_interleave(G, dim=1),
                         window_mask(MP * PAGE_SIZE, l, window, dev)))
    lib_ms = device_ms(rotating(lambda q, k, v, m: F.scaled_dot_product_attention(
        q, k, v, attn_mask=m), lib_sets))
    b_ms, b_by = paged_bound(sets[0][0], sets[0][1], sets[0][5], sets[0][6],
                             window)
    plan = k4_plan(SLOTS, KV, H // KV, hd, MP * PAGE_SIZE, window, dev)
    split = kernel_split(by_kernel, K4_PARTS)
    log(f"paged_decode_attention [H={H} KV={KV} hd={hd} MP={MP} "
        f"window={window}]: plan {plan}, {k_ms * 1e3:.2f} us ("
        + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in split.items() if v)
        + f"; SDPA {lib_ms * 1e3:.2f}, bound {b_ms * 1e3:.2f})")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, plan=plan, split_ms=split,
                enqueue_ms=time_ms(kernel))


def phase_timing(dev, handles, paged_handles, chunked_handles,
                 whisper_handles, moment_handles):
    """Device time of each kernel, its plain version and a library
    yardstick at the decode shapes (the most launched), over 24 input sets
    (one per layer, > 50 MB L2 for K3's cache) so each call finds its
    operands as cold as a decode step does. Also the host-clock time of the
    kernel call (``enqueue_ms``: what a caller waits per call when the host,
    not the card, is the bottleneck) and a profile of one decode step."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    cfg = full_config()
    gen = torch.Generator(device=dev).manual_seed(2)
    nsets, cap = cfg.num_layers, 4
    extra = {}

    # K1 at the decode, prefill and pooled shapes of stablelm, whisper's
    # decode shape and moment-large's pooled batch at ranks 4 and 16; the
    # stablelm decode one goes in the kernels line (48
    # launches per decode step). Beside it, as a yardstick, the port's
    # gather path at the same tokens (``models/lora.py::apply_lora_delta``:
    # the same tokens as (requests, tokens) rows, one adapter index a
    # request, two bmm; the other side of the segmented/gather crossover)
    from repro_torch.models.lora import apply_lora_delta
    cases = sgmv_cases(cfg)
    for name, (n_req, per_req) in (("decode", (SLOTS, 1)),
                                   ("prefill", (1, PROMPT_LEN)),
                                   ("pooled", (32, PROMPT_LEN)),
                                   ("whisper_decode", (SLOTS, 1)),
                                   ("moment_r4", (32, MOMENT_LEN)),
                                   ("moment_r16", (32, MOMENT_LEN))):
        n_tok = n_req * per_req
        T, dd = cases[name]["T"], cases[name]["d"]
        sets = sgmv_inputs(gen, T, dd, dd, cap,
                           2 if name == "pooled" else nsets, dev,
                           r=cases[name].get("r", RANK))
        by_kernel = device_kernels(rotating(lambda x, i, a, b: ops.segmented_lora(
            x, i, a, b, block_t=BLOCK_T), sets))
        k_ms = sum(by_kernel.values())
        p_ms = device_ms(rotating(lambda x, i, a, b: ref.segmented_lora_ref(
            x, i, a, b, BLOCK_T), sets))
        b_ms, b_by = sgmv_bound(*sets[0])
        gather = [(x[:n_tok].view(n_req, per_req, dd), a, b,
                   torch.arange(n_req, device=dev, dtype=torch.int32) % cap)
                  for x, _, a, b in sets]
        extra[f"segmented_lora_{name}"] = {
            "T": T, "tokens": n_tok, "d": dd, "r": sets[0][2].shape[-1],
            "plan": sgmv_plan(sets[0][0]),
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "split_ms": kernel_split(by_kernel, {"shrink_kernel": "shrink",
                                                 "expand_kernel": "expand"}),
            "gather_path_ms": device_ms(rotating(apply_lora_delta, gather)),
            "enqueue_ms": time_ms(rotating(
                lambda x, i, a, b: ops.segmented_lora(x, i, a, b,
                                                      block_t=BLOCK_T),
                sets))}
        log(f"segmented_lora [{name}]: {extra[f'segmented_lora_{name}']['plan']}, "
            f"{k_ms * 1e3:.2f} us (bound {b_ms * 1e3:.2f})")
        if name == "decode":
            k1 = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    S = PROMPT_LEN + MAX_NEW + 1
    k3 = int8_timing(dev, gen, H, KV, hd, S, nsets)
    for key in ("enqueue_ms", "plan", "split_ms"):
        extra[f"decode_attention_int8_{key}"] = k3.pop(key)
    # K4 at the stablelm shape (the kernels line) and at whisper-base's
    # decoder self-attention (H = KV = 8, a table of 9 pages)
    k4 = paged_timing(dev, gen, H, KV, hd, S, nsets)
    for key in ("enqueue_ms", "plan", "split_ms"):
        extra[f"paged_decode_attention_{key}"] = k4.pop(key)
    extra["paged_decode_attention_whisper"] = paged_timing(
        dev, gen, 8, 8, hd, W_PROMPT_LEN + W_MAX_NEW + 1, 6)
    # launches, ms and profile of one full-width decode step, 8 live streams
    extra.update(live_step_timing(dev, handles, "", seed=1, rid0=-300))
    extra.update(live_step_timing(dev, paged_handles, "paged_", seed=3,
                                  rid0=-100))
    # K2 at its three shapes; the pooled one (the most device time per
    # call) goes in the kernels line
    extra["flash_attention"] = flash_timing(dev)
    k2 = {k: extra["flash_attention"]["pooled"][k]
          for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    extra["tail_saving"] = tail_saving(dev, chunked_handles)
    extra["decode_attention"] = float_decode_timing(dev)
    k5 = {k: extra["decode_attention"]["cross"][k]
          for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    extra.update(live_step_timing(dev, whisper_handles, "whisper_", seed=8,
                                  rid0=-200, prompt_len=W_PROMPT_LEN,
                                  max_new=W_MAX_NEW, frames=True))
    extra["whisper_pooled_batch"] = whisper_pooled_timing(dev,
                                                          whisper_handles)
    extra["moment_pooled_batch"] = moment_pooled_timing(dev, moment_handles)

    def brief(pb):
        out = {way: {k: pb[way][k] for k in (
            "wall_ms", "device_busy_ms", "device_idle_share",
            "device_kernels", "event_ms", "event_idle_share")}
            for way in ("eager", "graphed")}
        out["kernels_extra"] = pb["kernels_extra"]
        return out
    ts, mp = extra["tail_saving"], extra["moment_pooled_batch"]
    extra["rows"] = {
        "stablelm dense decode step": brief(extra["decode_step_profile"]),
        "stablelm paged decode step": brief(
            extra["paged_decode_step_profile"]),
        "stablelm full admission prefill": brief(ts["full_prefill_profile"]),
        "stablelm tail admission prefill": brief(ts["tail_prefill_profile"]),
        "whisper paged decode step": brief(
            extra["whisper_decode_step_profile"]),
        "whisper pooled batch": brief(
            extra["whisper_pooled_batch"]["profile"]),
        "moment pooled batch segmented": brief(mp["segmented"]["profile"]),
        "moment pooled batch gather": brief(mp["gather"]["profile"])}
    log("rows (eager | graphed): " + json.dumps(extra["rows"]))
    return k1, k2, k3, k4, k5, extra


def whisper_pooled_timing(dev, handles) -> dict:
    """One pooled whisper batch of 4 requests of 1500 frames (encoder, and
    the decoder over as many BOS tokens) through ``PhysicalFM``: K2 launches
    per batch, device time and its profile, and K2's share of it."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    srv, fm, eng = handles
    rng = np.random.RandomState(9)
    embeds = (rng.randn(4, ENC_LEN, fm.cfg.d_model) * 0.5).astype(np.float32)
    aidx = np.arange(4, dtype=np.int32)

    def run():
        fm.run_batch_device(embeds, aidx)
    ops.reset_launches()
    run()
    torch.cuda.synchronize()
    launches = int(ops.LAUNCHES["flash_attention"])
    prof = profile_both(run, match="flash_attention_kernel")
    k2 = prof["graphed"]["match_ms"]
    return {"flash_attention_launches": launches,
            "device_ms": device_ms(run, iters=3, warmup=1),
            "flash_attention_device_ms": k2, "profile": prof}


def moment_pooled_timing(dev, handles) -> dict:
    """One pooled moment-large batch of 32 requests x 32 patches (4
    adapters) through ``PhysicalFM`` pinned to each LoRA impl in turn: wall
    ms, device busy ms and idle share of one profiled call, K1 and K2
    launches per batch; the FM goes back to "auto" afterwards."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    srv, fm, _ = handles
    rng = np.random.RandomState(10)
    embeds = rng.randn(32, MOMENT_LEN, fm.cfg.d_model).astype(np.float32)
    aidx = np.sort(np.arange(32) % len(fm.adapters)).astype(np.int32)

    def run():
        fm.run_batch_device(embeds, aidx)
    out = {}
    for impl in ("segmented", "gather"):
        fm.lora_impl = impl
        ops.reset_launches()
        run()
        torch.cuda.synchronize()
        out[impl] = {"launches": {k: int(ops.LAUNCHES[k]) for k in (
            "segmented_lora", "flash_attention", "rmsnorm")},
            "profile": profile_both(run)}
        for way in ("eager", "graphed"):
            p = out[impl]["profile"][way]
            log(f"moment pooled batch [{impl}, {way}]: wall "
                f"{p['wall_ms']:.2f} ms, device busy "
                f"{p['device_busy_ms']:.3f} ms, idle "
                f"{p['device_idle_share']:.3f}, {p['device_kernels']} "
                f"kernels, {out[impl]['launches']}")
    fm.lora_impl = "auto"
    out["auto_picks"] = fm.resolve_lora_impl(32)
    return out


def float_decode_timing(dev,
                        shapes=(("cross", 6), ("float_pool", 24))) -> dict:
    """K5's device time per call at the cross-attention decode of
    full-width whisper-base (8 slots x 8 heads x 1500 frames, 24.6 MB of
    bf16 K/V per call; 6 sets, one per decoder layer, 147 MB in all, so
    each call finds its sidecar cold as a decode step does) and at the
    float dense pool of stablelm-1.6b (ragged lengths up to s_max = 161;
    24 sets), its plain version's, one ``scaled_dot_product_attention``
    call on the same bf16 cache (a boolean mask where lengths are ragged),
    and the bound counted on this data; the split plan, and the time by
    kernel (``split_ms``: the decode kernel, and a merge kernel where one
    runs)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for name, nsets in shapes:
        case = FLOAT_CASES[name]
        window, G = case.get("window"), case["H"] // case["KV"]
        sets = float_inputs(gen, SLOTS, case["H"], case["KV"], case["S"],
                            case.get("hd", 64), nsets, dev,
                            lens=None if name == "float_pool"
                            else case["lens"])
        kernel = rotating(lambda q, k, v, ln: ops.decode_attention(
            q, k, v, ln, window=window), sets)
        by_kernel = device_kernels(kernel)
        k_ms = sum(by_kernel.values())
        p_ms = device_ms(rotating(
            lambda q, k, v, ln: ref.decode_attention_ref(
                q, k.transpose(1, 2), v.transpose(1, 2), ln,
                window=window, p_dtype=v.dtype), sets), iters=5)
        lib = []
        for q, k, v, ln in sets:
            kw = {}
            if bool((ln < case["S"]).any()) or window is not None:
                kw["attn_mask"] = window_mask(case["S"], ln, window, dev)
            lib.append(((q[:, :, None],
                         k.transpose(1, 2).repeat_interleave(G, dim=1),
                         v.transpose(1, 2).repeat_interleave(G, dim=1)), kw))
        l_ms = device_ms(rotating(
            lambda a, kw: F.scaled_dot_product_attention(*a, **kw), lib))
        q, k, _, ln = sets[0]
        b_ms, b_by = float_bound(q, k, ln, window)
        out[name] = dict(B=SLOTS, H=case["H"], KV=case["KV"], S=case["S"],
                         plan=float_splits(q, k), ms=k_ms, plain_ms=p_ms,
                         library_ms=l_ms, bound_ms=b_ms, bound_by=b_by,
                         split_ms=kernel_split(by_kernel, {
                             "decode_kernel": "decode",
                             "merge_kernel": "merge"}),
                         enqueue_ms=time_ms(kernel))
        log(f"decode_attention [{name}]: {out[name]['plan']}, "
            f"{k_ms * 1e3:.2f} us (SDPA {l_ms * 1e3:.2f}, bound "
            f"{b_ms * 1e3:.2f})")
    return out


def flash_sdpa_args(q, k, v, kw) -> tuple:
    """The (args, kwargs) of one ``scaled_dot_product_attention`` call for
    the same function as a K2 call: heads first and repeated to the query
    heads, the prefix and the keys concatenated; causal where that is the
    whole mask, no mask where every key is visible (whisper's encoder and
    cross-attention), else a boolean mask from the same visibility."""
    import torch
    G = q.shape[2] // k.shape[2]
    mask = flash_visible(q, k, kw)[:, None]
    if kw.get("prefix_k") is not None:
        k = torch.cat([kw["prefix_k"], k], dim=1)
        v = torch.cat([kw["prefix_v"], v], dim=1)
    args = (q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(G, dim=1),
            v.transpose(1, 2).repeat_interleave(G, dim=1))
    if kw.get("causal", True) and kw.get("window") is None and \
            kw.get("kv_len") is None and q.shape[1] == k.shape[1]:
        return args, {"is_causal": True}
    return args, {} if bool(mask.all()) else {"attn_mask": mask}


def flash_timing(dev, shapes=(("pooled", 6), ("admission", 48), ("tail", 48),
                             ("whisper_encoder", 8), ("whisper_cross", 24),
                             ("moment", 24))) -> dict:
    """K2's device time per call at the pooled, full-admission and tail
    shapes of ``FLASH_TIMED`` over rotating input sets (more bytes than the
    50 MB L2 in all), its plain version's, one
    ``scaled_dot_product_attention`` call on the same inputs (causal for
    the pooled shape; no mask where every key is visible, as in whisper's
    encoder and cross-attention; a boolean mask from the same visibility,
    over the prefix and the keys concatenated, for the others; the
    concatenation is not timed), and the bound counted on this data; where
    the wrapper splits the keys, the same calls unsplit (``unsplit_ms``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(4)
    out = {}
    for name, nsets in shapes:
        case = FLASH_TIMED[name]
        sets = flash_inputs(gen, dev, **case, nsets=nsets)

        def rotating(fn, items):
            it = [0]

            def call():
                a, kw = items[it[0] % len(items)]
                fn(*a, **kw)
                it[0] += 1
            return call
        k_ms = device_ms(rotating(ops.flash_attention, sets))
        p_ms = device_ms(rotating(ref.flash_attention_ref, sets), iters=5)
        lib = [flash_sdpa_args(*a, kw) for a, kw in sets]
        l_ms = device_ms(rotating(F.scaled_dot_product_attention, lib))
        (q, k, _), kw = sets[0]
        b_ms, b_by = flash_bound(q, k, kw)
        planned = flash_plan(q, k, kw)
        body, rows, nsplit = planned[:3]
        out[name] = dict(case=case, ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                         bound_ms=b_ms, bound_by=b_by, nsplit=nsplit,
                         plan=planned)
        if nsplit > 1:      # what the split buys: the same calls unsplit
            with flash_forced(fa.Plan(body, rows, 1, 1 << 30)):
                out[name]["unsplit_ms"] = device_ms(
                    rotating(ops.flash_attention, sets))
        log(f"flash_attention [{name}]: plan {planned}, {k_ms * 1e3:.1f} us"
            + (f" (unsplit {out[name]['unsplit_ms'] * 1e3:.1f} us)"
               if nsplit > 1 else "")
            + f", SDPA {l_ms * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us")
    return out


def tail_saving(dev, handles) -> dict:
    """What a prefix hit saves in prefill device time at full width: a
    96-token prompt admitted in full (its 128-token bucket) against the same
    prompt's 32-token tail behind a 64-token prefix operand (the tail path's
    float mode), each one admission prefill through the chunked engine's own
    planes, by profiler device time, with one profile of each (device
    busy against wall time, kernel count, the kernels taking the most
    device time)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import lm
    srv, fm, eng = handles
    cap = fm.adapters.capacity()
    aslot = fm.adapters.index("lora2")
    rng = np.random.RandomState(17)
    prompt = rng.randint(0, fm.cfg.vocab_size, 128).astype(np.int32)
    gens = [torch.Generator(device=dev).manual_seed(0)]
    aidx = torch.full((1,), aslot, dtype=torch.int32, device=dev)

    def i32(n):
        return torch.full((1,), n, dtype=torch.int32, device=dev)
    full_fn = eng._prefill_fn(cap, 128)
    seg = eng._prefill_segments(aslot, cap, 128)
    toks = torch.as_tensor(prompt[None], device=dev)

    def full():
        full_fn(fm.params, toks, i32(96), None, gens, fm.adapters.stacked(),
                aidx, *seg)
    tb = eng.bucket_for_tail(32)
    tail_fn = eng._tail_prefill_fn(cap, tb, "float")
    tseg = eng._prefill_segments(aslot, cap, tb)
    ttoks = torch.as_tensor(prompt[None, 64:64 + tb], device=dev)
    prefix_fp = [{"k": c["k"], "v": c["v"]} for c in lm.init_cache(
        fm.cfg, 1, eng._prefix_width * PAGE_SIZE, kv_quant=False,
        device=dev)]

    def tail():
        tail_fn(fm.params, prefix_fp, ttoks, i32(32), i32(64), gens,
                fm.adapters.stacked(), aidx, *tseg)
    out = {}
    for name, fn in (("full", full), ("tail", tail)):
        ops.reset_launches()
        fn()
        torch.cuda.synchronize()
        out[f"{name}_flash_attention_launches"] = int(
            ops.LAUNCHES["flash_attention"])
        out[f"{name}_prefill_device_ms"] = device_ms(fn, iters=5, warmup=1)
        out[f"{name}_prefill_profile"] = profile_both(fn)
    out["saved_device_ms_per_hit"] = out["full_prefill_device_ms"] - \
        out["tail_prefill_device_ms"]
    return out


def live_step_timing(dev, handles, prefix: str, seed: int, rid0: int,
                     prompt_len: int = 64, max_new: int = MAX_NEW,
                     frames: bool = False) -> dict:
    """One full-width decode step of the engine in ``handles`` with 8 live
    streams of ``prompt_len``-token prompts, one adapter each (on the paged
    pool 5 pages a stream with the chunk's headroom: 40 of the 44 usable
    pages; with ``frames``, each stream with its own 1500 encoder frames):
    launches per step, ms by CUDA events, and its profile, under keys
    starting with ``prefix``. The streams retire afterwards, and every page
    and state slot must be free again."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    srv, fm, eng = handles
    rng = np.random.RandomState(seed)
    for i in range(SLOTS):
        kw = {}
        if frames:
            kw["enc_feats"] = (rng.randn(ENC_LEN, fm.cfg.d_model)
                               * 0.5).astype(np.float32)
        eng.join(f"task{i % N_TASKS}",
                 rng.randint(0, fm.cfg.vocab_size, prompt_len),
                 adapter_id=f"lora{i % N_TASKS}", max_new_tokens=max_new,
                 rid=rid0 - i, **kw)
    if eng.pending_count() or eng.active_count() != SLOTS:
        raise RuntimeError(f"{prefix}step timing: the 8 streams did not "
                           "admit")
    if eng.paged:
        eng._ensure_chunk_pages()
        eng._sync_page_table()
    cap = fm.adapters.capacity()
    perm, inv, blocks = eng._segments(cap)
    adapters = torch.as_tensor(eng._slot_adapters, device=dev)
    step = eng._decode_fn(cap, 1)

    def run():
        step(fm.params, eng.pool, eng._tokens, eng._keys,
             fm.adapters.stacked(), adapters, perm, inv, blocks)
    ops.reset_launches()
    run()
    torch.cuda.synchronize()
    out = {f"{prefix}launches_per_decode_step":
           kernel_launches()}
    prof = out[f"{prefix}decode_step_profile"] = profile_both(run)
    out[f"{prefix}decode_step_ms"] = {way: prof[way]["event_ms"]
                                      for way in ("eager", "graphed")}
    out[f"{prefix}decode_step_capture_ms"] = None if step.capture_s is None \
        else 1e3 * step.capture_s
    for i in range(SLOTS):
        eng.leave(i)
    if (eng.paged and eng.free_page_count() != eng.total_pages - 1) or \
            (eng.state_pool is not None and eng.state_pool.slots_in_use()):
        raise RuntimeError(f"{prefix}step timing leaked pages or state "
                           "slots")
    return out


def profile_both(fn, match=None) -> dict:
    """``profile_step`` of ``fn`` two ways: eager (``graphs.disabled()``:
    every op launched from Python) and graphed (after the calls that
    capture its executable, a replay); each with ``event_ms``, the mean ms
    of a call between CUDA events without the profiler (5 eager calls, 20
    replays), and ``event_idle_share``, 1 - device busy / event_ms.
    ``kernels_extra``: the device records of a replay beyond the eager
    call's (the profiler sees each kernel inside a graph; a replay adds
    its staging copies)."""
    from repro_torch.core import graphs
    with graphs.disabled():
        eager = profile_step(fn, match)
        eager["event_ms"] = time_ms(fn, iters=5, warmup=1)
    fn()
    fn()
    graphed = profile_step(fn, match)
    graphed["event_ms"] = time_ms(fn, iters=20, warmup=2)
    for p in (eager, graphed):
        p["event_idle_share"] = 1.0 - p["device_busy_ms"] / p["event_ms"]
    return {"eager": eager, "graphed": graphed,
            "kernels_extra": graphed["device_kernels"]
            - eager["device_kernels"]}


def profile_step(fn, match=None, groups=()) -> dict:
    """One decode step under ``torch.profiler``: device busy time against
    the wall time of the step, the number of device kernels, and the
    kernels that take the most device time; with ``match``, also the device
    time of every kernel whose name holds it (``match_ms``); with
    ``groups`` (name keys), the device ms of each group (a kernel counts in
    the first key its name holds, else in ``other``) and its share of the
    busy time (``group_ms``, ``group_share``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms if wall_ms else None,
           "device_kernels": len(kernels),
           "top_kernels_ms": [(n[:60], ms) for n, ms in top]}
    if match is not None:
        out["match_ms"] = sum(ms for n, ms in by_name.items() if match in n)
    if groups:
        got = dict.fromkeys((*groups, "other"), 0.0)
        for n, ms in by_name.items():
            got[next((g for g in groups if g in n), "other")] += ms
        out["group_ms"] = got
        out["group_share"] = {g: ms / busy_ms for g, ms in got.items()} \
            if busy_ms else {}
    return out


# ---------------- phase 11: training (the task API) ----------------

# the prefill attention's backward at the shapes training gives it, and
# beyond (B, Sq = Sk, H, KV, hd, causal, window, kv_len)
FLASH_BWD_CASES = {
    # moment-large fine-tuned: 16 series of 64 patches, 16 heads of 64
    "moment": (16, 64, 16, 16, 64, False, None, None),
    # stablelm-1.6b causal over right-padded rows (one sees one key)
    "stablelm_ragged": (4, 128, 32, 32, 64, True, None, (128, 97, 64, 1)),
    # qwen2-7b's group of 7 at hd 128
    "qwen2_g7": (2, 128, 28, 4, 128, True, None, None),
    # h2o-danube-1.8b's hd 80, group of 4, a window shorter than S
    "h2o_window": (1, 256, 32, 8, 80, True, 100, None),
    # whisper-base's bidirectional encoder over 1500 frames
    "whisper_encoder": (1, 1500, 8, 8, 64, False, None, None),
}
TRAIN_STEPS, TRAIN_B, TRAIN_T = 40, 16, 512     # 64 patches of 8 a series
# the rmsnorm backward's timed shapes: moment's training rows (16 x 64
# patches) at its width, with dw and without (what Pipeline.train
# launches: the backbone is frozen), and the LM step's norms (stablelm,
# 8 x 512 tokens at d 2048)
RMSNORM_BWD_TIMED = (("1024x1024_dw", 1024, 1024, True),
                     ("1024x1024", 1024, 1024, False),
                     ("4096x2048_dw", 4096, 2048, True))
TRAIN_LR = 1e-3                  # 5e-3 overshoots at full width (x7 loss)


def flash_bwd_inputs(gen, dev, case):
    """q, k, v and the output's gradient (bf16, model layout) and the
    forward's keyword arguments of one ``FLASH_BWD_CASES`` entry."""
    import torch
    B, S, H, KV, hd, causal, window, kv_len = case

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    kw = {"causal": causal, "window": window}
    if kv_len is not None:
        kw["kv_len"] = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    return (r(B, S, H, hd), r(B, S, KV, hd), r(B, S, KV, hd),
            r(B, S, H, hd)), kw


def flash_grads(fn, q, k, v, dout, kw):
    """(out, dq, dk, dv) of ``fn`` (the kernels' ``ops.flash_attention``
    or the plain ``ref.flash_attention_ref``) through autograd."""
    import torch
    ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*ts, **kw)
    return (out.detach(), *torch.autograd.grad(out, ts, dout))


def flash_bwd_bound(q, k, kw):
    """Bytes and flops of the backward on this data: q, k, v, the output,
    its gradient (bf16) and the log-sum-exp (f32) read once, dq, dk, dv
    written once; 10 * hd flops per (query head, visible key): S
    recomputed, then dP, dV, dQ and dK."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    vis = flash_visible(q, k, kw)
    nbytes = 2 * (4 * B * Sq * H * hd + 4 * B * Sk * KV * hd) + 4 * B * H * Sq
    return bound_ms(nbytes, 10.0 * hd * H * int(vis.sum()))


def check_flash_bwd(dev, gen):
    """K2's backward (``flash_attention_bwd`` through ``ops.flash_attention``
    with inputs that require grad) against the plain version's autograd
    (``ref.flash_attention_ref``, the same bf16 inputs) at every
    ``FLASH_BWD_CASES`` entry: dq, dk and dv each within 1e-2 relative L2
    and every element within 2e-2 of that gradient's largest magnitude
    (both take bf16 operands into f32 sums in other orders; the kernel
    rounds P and dS to bf16 for the tensor cores, the plain version rounds
    P and its bf16 cotangents); two calls bit-identical; the forward's
    output the same bits with the log-sum-exp written and without, the
    log-sum-exp within 1e-3 of ``torch.logsumexp`` over the masked scaled
    scores (f32; -inf where a row sees no key, as a row of kv_len 0 would).
    One backward launch a call."""
    import torch

    from repro_torch.kernels import flash_attention as _flash
    from repro_torch.kernels import ops, ref
    ok, errs = True, {}
    for name, case in FLASH_BWD_CASES.items():
        (q, k, v, dout), kw = flash_bwd_inputs(gen, dev, case)
        before = ops.LAUNCHES["flash_attention_bwd"]
        got = flash_grads(ops.flash_attention, q, k, v, dout, kw)
        launched = ops.LAUNCHES["flash_attention_bwd"] - before
        again = flash_grads(ops.flash_attention, q, k, v, dout, kw)
        want = flash_grads(ref.flash_attention_ref, q, k, v, dout, kw)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        o_plain = _flash.flash_attention(q, k, v, **kw)
        o_lse, lse = _flash.flash_attention(q, k, v, with_lse=True, **kw)
        vis = flash_visible(q, k, kw)                 # (B, Sq, Sk)
        G = q.shape[2] // k.shape[2]
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                         k.float().repeat_interleave(G, dim=2))
        s = (s / q.shape[-1] ** 0.5).masked_fill(~vis[:, None], -torch.inf)
        lse_err = (lse - torch.logsumexp(s, dim=-1)).nan_to_num(0.0) \
            .abs().max().item()
        rep = {"launches": launched, "bit_identical": same,
               "lse_same_out": torch.equal(o_plain, o_lse) and
               torch.equal(o_lse, got[0]), "lse_max_err": lse_err}
        worst = 0.0
        for n, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
            g, w = g.float(), w.float()
            err = (g - w).abs().max().item()
            worst = max(worst, err)
            rep[n] = {"rel_l2": (torch.linalg.vector_norm(g - w)
                                 / torch.linalg.vector_norm(w)).item(),
                      "max_abs": err, "max_ref": w.abs().max().item(),
                      "finite": bool(torch.isfinite(g).all())}
        torch.cuda.synchronize()
        good = all(rep[n]["finite"] and rep[n]["rel_l2"] <= 1e-2 and
                   rep[n]["max_abs"] <= 2e-2 * rep[n]["max_ref"]
                   for n in ("dq", "dk", "dv"))
        good &= same and rep["lse_same_out"] and lse_err <= 1e-3 and \
            launched == 1
        log(f"kernel flash_attention_bwd [{name}: {case}]: {good} "
            + json.dumps(rep))
        ok &= good
        errs[name] = worst
    return ok, errs


RMSNORM_BWD_CASES = ((4176, 768), (4176, 1024), (4176, 2048),
                     (4096, 2048), (4176, 4096), (1056, 8192))


def check_rmsnorm_bwd(dev, gen):
    """rmsnorm's backward (``rmsnorm_bwd`` through ``ops.rmsnorm`` with x
    and w requiring grad) against the plain version's autograd at every
    ``RMSNORM_BWD_CASES`` (rows, d): xlstm's d 768, moment's 1024,
    stablelm's 2048 (and the LM step's 4096 rows), 4096, and 8192 through
    the generic loop: dx within two bf16 ulps of each element plus 1e-5 of
    its row's largest |dx| (one rounding of an f32 value that subtracts two
    terms: where they cancel, what is left is their f32 roundings), dw
    within 1e-5 of its largest magnitude (f32 sums over the rows in another
    order); both bit-identical twice; each row's dx the same bits alone,
    among 8 rows and among all; dx the same bits without dw (x alone
    requiring grad); one counted launch a call. dx is the first backward
    kernel's (the two-pass form) bit for bit: ``tools/kernel_ab.py --kernels
    rmsnorm_bwd`` holds that against the parent's build on the card, and
    ``tests/test_torch_autograd.py`` against its order on the CPU."""
    import torch

    from repro_torch.kernels import ops, ref
    ok, errs = True, {}
    for n, d in RMSNORM_BWD_CASES:
        x, w = rmsnorm_inputs(gen, n, d, dev)
        dy = torch.randn((n, d), generator=gen, device=dev).to(x.dtype)

        def grads(fn, lo=0, hi=n, need_dw=True):
            xr = x[lo:hi].detach().clone().requires_grad_(True)
            wr = w.detach().clone().requires_grad_(need_dw)
            ins = (xr, wr) if need_dw else (xr,)
            return torch.autograd.grad(fn(wr, xr), ins, dy[lo:hi])
        before = ops.LAUNCHES["rmsnorm_bwd"]
        dx, dw = grads(ops.rmsnorm)
        launched = ops.LAUNCHES["rmsnorm_bwd"] - before
        dx2, dw2 = grads(ops.rmsnorm)
        before = ops.LAUNCHES["rmsnorm_bwd"]
        (dx_only,) = grads(ops.rmsnorm, need_dw=False)
        launched_only = ops.LAUNCHES["rmsnorm_bwd"] - before
        px, pw = grads(ref.rmsnorm)
        inv = torch.equal(grads(ops.rmsnorm, 0, 8)[0], dx[:8]) and all(
            torch.equal(grads(ops.rmsnorm, i, i + 1)[0], dx[i:i + 1])
            for i in range(8))
        torch.cuda.synchronize()
        g, p = dx.float(), px.float()
        floor = 1e-5 * p.abs().amax(dim=1, keepdim=True)
        within = bool(((g - p).abs() <= 2 * 2.0 ** -8 * p.abs() + floor)
                      .all())
        dw_err = (dw - pw).abs().max().item() / pw.abs().max().item()
        same = torch.equal(dx, dx2) and torch.equal(dw, dw2)
        no_dw = torch.equal(dx_only, dx)
        good = within and dw_err <= 1e-5 and same and inv and no_dw and \
            launched == 1 and launched_only == 1
        log(f"kernel rmsnorm_bwd [{n} x {d}, plan "
            f"{_rmsnorm_bwd_plan(n, d)}]: {good}: dx max_abs_err="
            f"{(g - p).abs().max().item():.3e} (two bf16 ulps: {within}), "
            f"dw rel err {dw_err:.2e}, bit-identical twice: {same}, "
            f"row-invariant over calls of 1, 8 and {n} rows: {inv}, dx the "
            f"same without dw: {no_dw}, launches {launched}, "
            f"{launched_only}")
        ok &= good
        errs[f"{n}x{d}"] = (g - p).abs().max().item()
    return ok, errs


def _rmsnorm_bwd_plan(rows, d):
    from repro_torch.kernels.rmsnorm import _bwd_plan
    return list(_bwd_plan(rows, d))


def train_batches(seed, B=TRAIN_B, T=TRAIN_T):
    """Endless (x (B, T, 3), y (B, 1)) numpy batches: three channels of a
    time series and the regression target of ``tests/test_taskapi.py``
    (five times channel 0's mean, plus 1)."""
    import numpy as np
    r = np.random.RandomState(seed)
    while True:
        x = r.randn(B, T, 3).astype(np.float32)
        yield x, (x[:, :, 0].mean(axis=1) * 5.0 + 1.0)[:, None]


def training_pipeline(cfg, dev, seed, params=None):
    """The task of the paper's Listing 1 on moment-large: a
    LinearChannelCombiner (3 channels -> 1, patches of 8), an
    MLPDecoder(d, 64, 1) and a rank-16 q/v adapter, over a backbone drawn
    from ``seed`` on ``dev`` (or ``params``) whose q/k projections are
    scaled to their real fan-in (``fan_in_qk``: at the package's init they
    are 8x too large at d 1024 and the attention saturates; the port's own
    bf16 gradients through such a backbone are then 1.0 rel L2 from its f32
    ones, 0.008 at the real fan-in, measured on the CPU at 2 layers)."""
    from repro_torch import taskapi
    vfm = taskapi.vFM(cfg, seed=seed, params=params, device=dev)
    if params is None:
        fan_in_qk(vfm.params, cfg)
    P = taskapi.Pipeline(vfm, task_id="hr", seed=seed)
    P.add_encoder(taskapi.LinearChannelCombiner(3, 1, 8, cfg.d_model))
    P.add_decoder(taskapi.MLPDecoder(cfg.d_model, 64, 1))
    P.attach_adapter(taskapi.Adapter(rank=RANK, adapter_id="hr_lora"))
    return P


def group_drift(g, c) -> dict:
    """Per leaf group (encoder, adapter, decoder): relative L2 and max
    |diff| of a card gradient tree against the CPU's."""
    import torch
    out = {}
    for group in g:
        a = torch.cat([t.float().cpu().reshape(-1) for t in _leaves(g[group])])
        b = torch.cat([t.float().reshape(-1) for t in _leaves(c[group])])
        out[group] = {"rel_l2": (torch.linalg.vector_norm(a - b)
                                 / torch.linalg.vector_norm(b)).item(),
                      "max_abs": (a - b).abs().max().item(),
                      "finite": bool(torch.isfinite(a).all())}
    return out


def phase_reference_training(dev):
    """A two-layer cut of full-width moment-large: one ``train`` step's
    loss and gradients (``Pipeline.loss_and_grad``: the encoder, the
    adapter, the decoder) on the card, through K2's and rmsnorm's kernels
    and their backward kernels, against the same step on the CPU with the
    plain versions (the same weights, extension state and numpy batch; the
    adapter's B leaves drawn, as at init they are zero and the A leaves'
    gradient with them). Gate: every group within 0.05 relative L2 (both
    sides round the same bf16 activations and cotangents; sums run in other
    orders and the kernels round P and dS to bf16); 2 attention and 5 norm
    backward launches (2 a layer, and the final norm)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.common import tree_map
    cfg = moment_config(num_layers=2)
    G = training_pipeline(cfg, dev, seed=13)
    r = np.random.RandomState(13)
    for sub in G.state["adapter"]:
        for k in ("q", "v"):
            sub[k]["b"] = torch.tensor(r.randn(*sub[k]["b"].shape) * 0.05,
                                       dtype=torch.float32, device=dev)
    C = training_pipeline(cfg, "cpu", seed=13, params=tree_map(
        lambda t: t.cpu(), G.vfm.params))
    C.state = tree_map(lambda t: t.cpu(), G.state)
    x, y = next(train_batches(29))
    parts = ("encoder", "adapter", "decoder")
    ops.reset_launches()
    lg, gg = G.loss_and_grad({k: G.state[k] for k in parts}, x, y)
    torch.cuda.synchronize()
    launches = {k: int(ops.LAUNCHES[k]) for k in (
        "flash_attention", "flash_attention_bwd", "rmsnorm", "rmsnorm_bwd")}
    lc, gc = C.loss_and_grad({k: C.state[k] for k in parts}, x, y)
    report = {"loss": [lg.item(), lc.item()], "launches": launches,
              **group_drift(gg, gc)}
    log("training reference: 2-layer full-width moment-large, one step of "
        f"{TRAIN_B} x {TRAIN_T} x 3, GPU vs CPU: " + json.dumps(report))
    ok = all(report[k]["finite"] and report[k]["rel_l2"] <= 0.05
             for k in parts)
    ok &= abs(lg.item() - lc.item()) <= 0.05 * abs(lc.item())
    ok &= launches == {"flash_attention": 2, "flash_attention_bwd": 2,
                       "rmsnorm": 5, "rmsnorm_bwd": 5}
    return ok, report


class _Clock:
    """Wraps a batch iterator: the host time at each ``next``. ``train``
    reads each step's loss on the host (a sync), so the gaps are steps."""

    def __init__(self, it):
        self.it, self.stamps = it, []

    def __iter__(self):
        return self

    def __next__(self):
        self.stamps.append(time.perf_counter())
        return next(self.it)


def phase_train(dev):
    """``Pipeline.train`` at full width: moment-large, 24 layers, d 1024,
    the task of ``training_pipeline``, 40 steps (AdamW, lr ``TRAIN_LR``) on
    batches of 16 series x 512 steps x 3 channels (64 patches, MOMENT's own
    input length, arXiv:2402.03885) made with numpy. Gates: the mean loss
    of the last 5 steps below half the first; every layer's adapter B
    leaves moved off
    zero; every backbone leaf bit-identical to before and none requiring
    grad; each step through K2 and rmsnorm and their backward kernels (24
    attention forwards and backwards a step, 49 norms: 2 a layer and the
    final one) and no other kernel; the trained task's outputs finite, and
    its artifact serializable. Reports the step's host ms (median of the
    steps after the first 5)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.taskapi import serialize
    cfg = moment_config()
    P = training_pipeline(cfg, dev, seed=17)
    before = [t.clone() for t in _leaves(P.vfm.params)]
    data = _Clock(train_batches(19))
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    losses = P.train(data, steps=TRAIN_STEPS, lr=TRAIN_LR, loss="mse")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, bodies = kernel_launches(), ops.bodies()
    steps = np.diff(data.stamps + [t0 + wall]) * 1e3
    frozen = all(torch.equal(a, b) and not b.requires_grad
                 for a, b in zip(before, _leaves(P.vfm.params)))
    moved = all(bool((t[n]["b"].abs().amax(dim=(1, 2, 3)) > 0).all())
                for t in P.state["adapter"] for n in ("q", "v"))
    x, _ = next(train_batches(23))
    y = P.run(x[:4])
    blob = serialize(P.package(weight=1.0, slo_s=0.2, demand_rps=5.0))
    want = {"flash_attention": cfg.num_layers * TRAIN_STEPS,
            "flash_attention_bwd": cfg.num_layers * TRAIN_STEPS,
            "rmsnorm": (2 * cfg.num_layers + 1) * TRAIN_STEPS,
            "rmsnorm_bwd": (2 * cfg.num_layers + 1) * TRAIN_STEPS}
    stats = {"card": smi_line(), "layers": cfg.num_layers,
             "d": cfg.d_model, "steps": TRAIN_STEPS,
             "batch": [TRAIN_B, TRAIN_T, 3], "lr": TRAIN_LR,
             "loss_first": losses[0], "loss_last5_mean": sum(losses[-5:]) / 5,
             "losses": losses,
             "wall_s": wall, "step_ms_median": float(np.median(steps[5:])),
             "step_ms_first": float(steps[0]), "launches": launches,
             "bodies": bodies,
             "backbone_bit_identical": frozen, "adapter_b_moved": moved,
             "artifact_bytes": len(blob),
             "outputs_finite": bool(torch.isfinite(y).all())}
    log("training: " + json.dumps(stats, default=float))
    ok = sum(losses[-5:]) / 5 < 0.5 * losses[0] and frozen and moved
    ok &= launches == want and stats["outputs_finite"] and tuple(y.shape) \
        == (4, 1)
    return ok, stats


def phase_simulator(card_profile) -> tuple[bool, dict]:
    """The discrete-event simulator (``build_single_gpu``) at the loads of
    ``tests/test_simulator.py`` (two tasks, Poisson 1, 20 and 40 requests/s
    each for 10 s) under FMplex's shared backbone, the static partition
    (sp) and processor sharing (be), once with the moment-large profile
    ``phase_moment_serving`` calibrated on the card and once with the
    paper's (``PAPER_PROFILES``). Host work; gate: every run finished every
    request with finite latencies."""
    import math

    from repro_torch.controller import get_profile
    from repro_torch.serving import loadgen, metrics, simulator
    tasks = [{"task_id": "A"}, {"task_id": "B"}]
    out, ok = {}, True
    for label, prof in (("card", card_profile),
                        ("paper", get_profile(MOMENT))):
        rows = out[label] = {"l1_ms": prof.l(1) * 1e3, "b_max": prof.b_max,
                             "l_bmax_ms": prof.l(prof.b_max) * 1e3}
        for rate, horizon in ((1, 60.0), (20, 120.0), (40, 200.0)):
            for mode in ("fmplex", "sp", "be"):
                arr = loadgen.merge([
                    loadgen.poisson_trace("A", rate, 10, seed=1),
                    loadgen.poisson_trace("B", rate, 10, seed=2)])
                sim, fits = simulator.build_single_gpu(mode, tasks, prof)
                fin = sim.run(arr, horizon)
                st = metrics.latency_stats(fin)
                done = sum(1 for r in fin if r.finish_time is not None)
                rows[f"{mode}@{rate}"] = {"mean_ms": st["mean_ms"],
                                          "p99_ms": st["p99_ms"],
                                          "done": f"{done}/{len(arr)}"}
                ok &= fits and done == len(arr) and math.isfinite(
                    st["mean_ms"]) and math.isfinite(st["p99_ms"])
    log("simulator (moment-large, 2 tasks): " + json.dumps(out))
    return ok, out


def training_timing(dev, gen) -> dict:
    """Device times of the two backward kernels beside their bounds, their
    plain versions' autograd (the backward alone: the graph built once and
    kept) and one PyTorch call's backward for the same function where one
    takes the case without an explicit mask (``F.scaled_dot_product_attention``
    in the head-major layout, ``enable_gqa`` for a group; ``F.rms_norm``;
    never called by the port): K2's at every ``FLASH_BWD_CASES`` shape
    (SDPA's with a boolean ``attn_mask`` where the case has a ``kv_len``
    or a window), with its split by kernel name (the fused launch, or the
    dQ and dK/dV passes) and the plan that chose it; rmsnorm's at the
    ``RMSNORM_BWD_TIMED`` shapes with its plan, its split by kernel name
    and how many kernels a call ran (one without dw, two with)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as _flash
    from repro_torch.kernels import ref
    from repro_torch.kernels import rmsnorm as _rmsnorm

    def backward_only(out, ins, grad):
        return lambda: torch.autograd.grad(out, ins, grad, retain_graph=True)
    res = {}
    for name, case in FLASH_BWD_CASES.items():
        (q, k, v, dout), kw = flash_bwd_inputs(gen, dev, case)
        out, lse = _flash.flash_attention(q, k, v, with_lse=True, **kw)
        ins = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        plain = ref.flash_attention_ref(*ins, **kw)
        heads = [t.detach().transpose(1, 2).clone().requires_grad_(True)
                 for t in (q, k, v)]
        if "kv_len" not in kw and kw["window"] is None:
            lib = F.scaled_dot_product_attention(
                *heads, is_causal=kw["causal"],
                enable_gqa=q.shape[2] != k.shape[2])
        else:                       # the visible (query, key) pairs
            lib = F.scaled_dot_product_attention(
                *heads, attn_mask=flash_visible(q, k, kw)[:, None],
                enable_gqa=q.shape[2] != k.shape[2])
        lib_ms = device_ms(backward_only(lib, heads, dout.transpose(1, 2)))
        b_ms, b_by = flash_bwd_bound(q, k, kw)
        by_name = device_kernels(lambda: _flash.flash_attention_bwd(
            q, k, v, out, lse, dout, **kw))
        B, S, H, KV, hd = case[:5]
        res[f"flash_attention_bwd_{name}"] = dict(
            shape=list(case),
            plan=list(_flash._bwd_plan(B, S, S, KV, H // KV, hd, case[5],
                                       case[6])),
            ms=sum(by_name.values()),
            split=kernel_split(by_name, {"bwd_fused": "fused",
                                         "bwd_dq": "dq",
                                         "bwd_dkv": "dkv"}),
            plain_ms=device_ms(backward_only(plain, ins, dout)),
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    for label, rows, d, need_dw in RMSNORM_BWD_TIMED:
        x, w = rmsnorm_inputs(gen, rows, d, dev)
        dy = torch.randn((rows, d), generator=gen, device=dev).to(x.dtype)
        xr, wr = (t.detach().clone().requires_grad_(True) for t in (x, w))
        xl, wl = (t.detach().clone().requires_grad_(True) for t in (x, w))
        wr.requires_grad_(need_dw)
        wl.requires_grad_(need_dw)
        ins, lins = ((xr, wr), (xl, wl)) if need_dw else ((xr,), (xl,))
        with warnings.catch_warnings():     # the composite path's notice
            warnings.simplefilter("ignore", UserWarning)
            lib = F.rms_norm(xl, (d,), wl, 1e-5)
            lib_ms = device_ms(backward_only(lib, lins, dy))
        b_ms, b_by = bound_ms(3 * 2 * rows * d + 4 * d * (2 if need_dw else 1),
                              10.0 * rows * d)
        by_name = device_kernels(
            lambda: _rmsnorm.rmsnorm_bwd(w, x, dy, need_dw=need_dw))
        res[f"rmsnorm_bwd_{label}"] = dict(
            rows=rows, d=d, dw=need_dw, plan=_rmsnorm_bwd_plan(rows, d),
            ms=sum(by_name.values()),
            split=kernel_split(by_name, {"rmsnorm_bwd_kernel": "rows",
                                         "dw_sum": "dw_sum"}),
            kernels=len(by_name),
            plain_ms=device_ms(backward_only(ref.rmsnorm(wr, xr), ins, dy)),
            library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    for n, t in res.items():
        lib = "none" if t["library_ms"] is None else \
            f"{t['library_ms'] * 1e3:.2f}"
        log(f"{n}: {t['ms'] * 1e3:.2f} us (plain {t['plain_ms'] * 1e3:.2f}, "
            f"library {lib}, bound {t['bound_ms'] * 1e3:.2f} by "
            f"{t['bound_by']})" + (f", plan {t['plan']}, split "
                                   + json.dumps(t["split"])
                                   if "plan" in t else ""))
    return res


def phase_training(dev, card_profile):
    """Phase 11: the backward kernels against their plain versions'
    autograd, the two-layer gradient reference, ``Pipeline.train`` at full
    width, the simulator on the card's and the paper's profiles, and the
    backward kernels' device times. Returns (phases, stats of the full-width
    run (its launches count toward the kernels line), errors by kernel,
    timing)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(41)
    t0 = time.perf_counter()
    phases, errs = {}, {}
    phases["flash_attention_bwd"], errs["flash_attention_bwd"] = \
        check_flash_bwd(dev, gen)
    phases["rmsnorm_bwd"], errs["rmsnorm_bwd"] = check_rmsnorm_bwd(dev, gen)
    free_device()
    phases["training_reference"], _ = phase_reference_training(dev)
    free_device()
    phases["training"], stats = phase_train(dev)
    free_device()
    phases["simulator"], _ = phase_simulator(card_profile)
    timing = training_timing(dev, gen)
    log(f"training phase: {phases}, {time.perf_counter() - t0:.1f} s")
    return phases, stats, errs, timing


# ---------------- phase 12: LM training (launch/train.py) ----------------

LM_REF_LAYERS, LM_REF_B, LM_REF_S = 2, 2, 128
LM_STEPS, LM_B, LM_S, LM_LR = 12, 8, 512, 3e-4


def lm_launches_per_step(layers: int) -> dict:
    """What one ``make_train_step`` of an attention stack of ``layers``
    layers launches: the forward's 2 norms a layer and the final norm and
    one K2 a layer; remat (``lm.loss_fn``'s default, one period a
    checkpoint) runs each layer's two norms and its K2 again in the
    backward (the final norm lies outside the checkpoints); the backward's
    one ``rmsnorm_bwd`` a norm (with dw: every norm weight trains) and one
    K2 backward a layer."""
    return {"flash_attention": 2 * layers, "flash_attention_bwd": layers,
            "rmsnorm": (2 * layers + 1) + 2 * layers,
            "rmsnorm_bwd": 2 * layers + 1}


def lm_masters(cfg, dev, seed):
    """f32 master weights of ``cfg`` drawn from ``seed`` on ``dev``
    (``lm.init_model(masters=True)``, the trainer's), requiring grad."""
    import torch

    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = lm.init_model(gen, cfg, device=dev, masters=True)
    return tree_map(lambda t: t.requires_grad_(True), params)


def lm_batch(cfg, B, S, seed, dev):
    """One ``TokenPipeline`` batch (the trainer's data) on ``dev``."""
    import torch

    from repro_torch.data.tokens import TokenPipeline
    host = next(TokenPipeline(cfg, B, S, seed=seed))
    return {k: torch.as_tensor(v, device=dev) for k, v in host.items()}


def lm_reference_training(dev):
    """Full-width stablelm-1.6b cut to 2 of its 24 layers (d 2048, vocab
    100352), f32 masters with q/k at their real fan-in (``fan_in_qk``: at
    the package's init the attention saturates and bf16 gradients through
    it are noise), one ``TokenPipeline`` batch of 2 x 128: ``lm.loss_fn``'s
    loss and every leaf's gradient on the card (K2, rmsnorm and both
    backward kernels; the norm weights' gradients from ``rmsnorm_bwd``
    with dw) against the same weights and batch on the CPU (the plain
    versions). Gate: the loss within 1e-2 relative, every leaf's gradient
    finite and within 0.05 rel L2 (both sides round the same bf16
    activations and cotangents; sums run in other orders and the kernels
    round P and dS to bf16); the launches ``lm_launches_per_step`` gives
    for 2 layers, and no other kernel."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map, tree_paths
    cfg = full_config(num_layers=LM_REF_LAYERS)
    params = lm_masters(cfg, dev, seed=31)
    with torch.no_grad():
        fan_in_qk(params, cfg)
    cpu = tree_map(lambda t: t.detach().cpu().requires_grad_(True), params)
    batch = lm_batch(cfg, LM_REF_B, LM_REF_S, 37, dev)

    def grads(p, b):
        leaves = [t for _, t in tree_paths(p)]
        loss, _ = lm.loss_fn(p, cfg, b)
        return loss.detach(), torch.autograd.grad(loss, leaves)
    ops.reset_launches()
    lg, gg = grads(params, batch)
    torch.cuda.synchronize()
    launches = kernel_launches()
    lc, gc = grads(cpu, {k: v.cpu() for k, v in batch.items()})
    names = [k for k, _ in tree_paths(cpu)]
    drift = {}
    for n, a, b in zip(names, gg, gc):
        a, b = a.float().cpu(), b.float()
        drift[n] = {"rel_l2": (torch.linalg.vector_norm(a - b)
                               / torch.linalg.vector_norm(b)).item(),
                    "finite": bool(torch.isfinite(a).all())}
    worst = max(drift, key=lambda n: drift[n]["rel_l2"])
    report = {"loss": [lg.item(), lc.item()], "launches": launches,
              "worst_leaf": [worst, drift[worst]["rel_l2"]],
              "norm_leaves": {n: round(v["rel_l2"], 5) for n, v in
                              drift.items() if "ln" in n or "norm" in n}}
    log(f"LM training reference: {LM_REF_LAYERS}-layer full-width {ARCH}, "
        f"loss_fn over {LM_REF_B} x {LM_REF_S} tokens, GPU vs CPU: "
        + json.dumps(report))
    ok = all(v["finite"] and v["rel_l2"] <= 0.05 for v in drift.values())
    ok &= abs(lg.item() - lc.item()) <= 1e-2 * abs(lc.item())
    ok &= launches == lm_launches_per_step(LM_REF_LAYERS)
    return ok, report


def phase_lm_steps(dev):
    """Full-width, full-depth stablelm-1.6b (24 layers, 1.644 B f32 master
    weights, q/k at their real fan-in) trained by
    ``launch.train.make_train_step`` for ``LM_STEPS`` steps on one
    ``TokenPipeline`` batch of 8 x 512, taken again each step (AdamW at lr
    3e-4, no checkpoint: the params with both moments would be ~20 GB on
    disk). Why q/k at their fan-in (``fan_in_qk``): at the package's init
    the attention saturates and the global gradient norm is ~5e10, so the
    clip to 1.0 leaves every gradient under AdamW's eps and the loss stays
    at 12.02 (ln V + 0.5); at the real fan-in the norm is ~0.8. Why one
    batch: at vocab 100352 the pipeline's tokens rarely repeat between
    batches, so 12 fresh batches lower the loss by ~0.1 (12.04 -> 11.94),
    within a few times its batch-to-batch spread; one batch taken again
    falls to ~3.4. (Both measured on an NVIDIA H100 80GB HBM3 at 700 W.)
    Gates: every loss finite, the mean of the last 3 below half the
    first, every leaf moved; the launches exactly
    ``lm_launches_per_step(24)`` a step (97 rmsnorm, 49 rmsnorm_bwd, 48
    K2, 24 K2 backward) and no other kernel. Reports the step's host ms
    (median after the first), the peak memory and one profiled step split
    by kernel group."""
    import numpy as np
    import torch

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim.adamw import AdamW
    cfg = full_config()
    torch.cuda.reset_peak_memory_stats()
    params = lm_masters(cfg, dev, seed=43)
    with torch.no_grad():
        fan_in_qk(params, cfg)
    before = [t.detach().clone() for t in tree_leaves(params)]
    opt = AdamW(lr=LM_LR)
    state = {"params": params, "opt": opt.init(params)}
    step = make_train_step(cfg, opt)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in next(TokenPipeline(cfg, LM_B, LM_S, seed=47)).items()}
    losses, ms, norms = [], [], []
    torch.cuda.synchronize()
    ops.reset_launches()
    for _ in range(LM_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))            # a sync
        ms.append(1e3 * (time.perf_counter() - t0))
        norms.append(float(metrics["grad_norm"]))
    torch.cuda.synchronize()
    launches, bodies = kernel_launches(), ops.bodies()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    moved = all(not torch.equal(a, b.detach())
                for a, b in zip(before, tree_leaves(state["params"])))
    del before

    def one():
        nonlocal state
        state, m = step(state, batch)
        float(m["loss"])
    split = profile_step(one, groups=(
        "flash_attention_bwd", "rmsnorm_bwd", "flash_attention", "rmsnorm"))
    per = lm_launches_per_step(cfg.num_layers)
    want = {k: v * LM_STEPS for k, v in per.items()}
    stats = {"card": smi_line(), "layers": cfg.num_layers, "d": cfg.d_model,
             "steps": LM_STEPS, "batch": [LM_B, LM_S], "lr": LM_LR,
             "losses": losses, "grad_norms": norms,
             "step_ms_median": float(np.median(ms[1:])),
             "step_ms_first": ms[0], "peak_gb": peak_gb,
             "launches": launches, "bodies": bodies,
             "launches_per_step": per,
             "all_leaves_moved": moved, "profiled_step": split}
    log("LM training: " + json.dumps(stats, default=float))
    ok = all(np.isfinite(losses)) and np.mean(losses[-3:]) < 0.5 * losses[0]
    ok &= moved and launches == want
    return ok, stats


# the example's own 60 steps and failure at 25 took 90 s on an NVIDIA
# H100 80GB HBM3 at 700 W; a failure 2 steps after the step-10 save found
# it still being written and restarted from step 0
E2E_STEPS, E2E_FAIL_AT = 30, 15


def start_train_e2e():
    """Start ``examples/train_e2e_torch.py --full-width`` as a subprocess on
    the card: xlstm-125m at full width cut to 4 layers, checkpoints every
    10 steps in a temporary directory, ``E2E_STEPS`` steps with a failure
    injected at step ``E2E_FAIL_AT``, its output to a file. Returns the
    handle ``finish_train_e2e`` takes."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    fd, path = tempfile.mkstemp(prefix="train_e2e_", suffix=".log")
    with os.fdopen(fd, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "examples",
                                          "train_e2e_torch.py"),
             "--full-width", "--steps", str(E2E_STEPS), "--fail-at",
             str(E2E_FAIL_AT)], stdout=f, stderr=subprocess.STDOUT,
            env=env, cwd=ROOT)
    stop_at_exit(proc)
    return proc, path, time.perf_counter()


def finish_train_e2e(handle, timeout=600):
    """Wait for ``start_train_e2e``'s run: it must restore from its
    checkpoint, finish and exit 0 (the example asserts the loss
    decreased). Returns (ok, its exit code, seconds and last lines)."""
    proc, path, t0 = handle
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    with open(path) as f:
        text = f.read()
    os.remove(path)
    out = {"rc": proc.returncode, "s": time.perf_counter() - t0,
           "tail": text.strip().splitlines()[-4:]}
    log("train_e2e_torch --full-width: " + json.dumps(out))
    ok = proc.returncode == 0 and "restarted=True" in text and \
        "restored step" in text
    return ok, out


# ---------------- child processes beside phase_mesh ----------------

# work that checks, and times nothing, runs in child processes (``python3
# chip_smoke.py --child <job>``) beside phase_mesh, which checks only too:
# each job returns ({phase: ok}, stats) (the whole run took 1210 s on an
# H100 whose host ran it 1.5x slower than another's 879 s, most of it host
# work; the references and the xlstm step, ~180 s, are host work alone)
CHILD_RESULT = "child result: "


def xlstm_training_job(dev):
    ok, stats = long_xlstm_training(dev)
    return {"long_xlstm_training": ok}, stats


CHILD_JOBS = {"family_references": (family_references, 5),
              "stack_references": (stack_references, 5),
              "long_xlstm_training": (xlstm_training_job, 0)}


def stop_at_exit(proc):
    """Kill ``proc`` when this process exits, if it still runs."""
    import atexit

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    atexit.register(stop)


def child_main(name: str) -> int:
    """The body of ``--child <name>``: run CHILD_JOBS[name] on the card and
    print its result as the last line, after CHILD_RESULT."""
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phases, stats = CHILD_JOBS[name][0](torch.device("cuda", 0))
    print(CHILD_RESULT + json.dumps({
        "phases": {k: bool(v) for k, v in phases.items()}, "stats": stats},
        default=lambda o: o.tolist() if hasattr(o, "tolist") else str(o)),
        flush=True)
    return 0


def start_children(names=tuple(CHILD_JOBS)) -> dict:
    """Start ``--child`` of each job (the CPU-heavy references at nice 5,
    so that the single-threaded host work beside them keeps its core),
    each writing to its own file: {name: (process, path)}."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = {}
    for name in names:
        fd, path = tempfile.mkstemp(prefix=f"child_{name}_", suffix=".log")
        nice = CHILD_JOBS[name][1]
        with os.fdopen(fd, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--child", name],
                stdout=f, stderr=subprocess.STDOUT, env=env, cwd=ROOT,
                preexec_fn=(lambda n=nice: os.nice(n)) if nice else None)
        stop_at_exit(proc)
        out[name] = (proc, path)
    return out


def finish_children(children, timeout=900) -> tuple[dict, dict]:
    """Wait for ``start_children``'s jobs (killed ``timeout`` s from here),
    relay each one's log lines headed by its name, and merge their
    results: ({phase: ok}, {job: stats}); a job that exits without a
    result fails as the phase "<job> child"."""
    phases, stats = {}, {}
    t_end = time.perf_counter() + timeout
    for name, (proc, path) in children.items():
        try:
            proc.wait(timeout=max(1.0, t_end - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        with open(path) as f:
            lines = f.read().splitlines()
        os.remove(path)
        res = None
        for line in lines:
            if line.startswith(CHILD_RESULT):
                res = json.loads(line[len(CHILD_RESULT):])
            else:
                log(f"[child {name}] {line}")
        if res is None or proc.returncode != 0:
            phases[f"{name} child"] = False
            log(f"child {name}: exit code {proc.returncode}, no result")
            continue
        phases.update(res["phases"])
        stats[name] = res["stats"]
    return phases, stats


def phase_lm_training(dev):
    """Phase 12: the LM trainer's gradient reference (2 layers, GPU vs
    CPU) and full-width full-depth steps with their launches and profile
    (the checkpoint/restart example, ``start_train_e2e``, runs beside
    phase_mesh). Returns (phases, stats
    of the full-depth steps: their launches count toward the kernels
    line)."""
    t0 = time.perf_counter()
    phases = {}
    phases["lm_reference"], _ = lm_reference_training(dev)
    free_device()
    phases["lm_training"], stats = phase_lm_steps(dev)
    free_device()
    log(f"LM training phase: {phases}, {time.perf_counter() - t0:.1f} s")
    return phases, stats


MESH_LAYERS, MESH_STEPS, MESH_B, MESH_S = 4, 4, 8, 512
MESH_GRAD_MB = 64                # the compressed gradient tree
MOE_LAYERS, MOE_S = 2, 512       # one olmoe row: ep's one group is gshard's
DRYRUN_CELL = "qwen2-7b:train_4k:pod1"


@contextlib.contextmanager
def plain_kernel_inputs():
    """While open: every tensor a hand-written kernel of the training path
    is given (``ops._k2``, ``_k2_bwd``, ``_rms``, ``_rms_bwd``, the calls
    that launch) is checked to be a plain CUDA tensor, never a DTensor;
    yields the list of offences (empty when all were)."""
    import torch

    from repro_torch.kernels import ops
    bad = []
    names = ("_k2", "_k2_bwd", "_rms", "_rms_bwd")
    orig = {n: getattr(ops, n) for n in names}

    def wrap(n):
        def call(*a, **k):
            for t in list(a) + list(k.values()):
                if isinstance(t, torch.Tensor) and (
                        type(t) is not torch.Tensor or t.device.type != "cuda"):
                    bad.append((n, type(t).__name__, str(t.device)))
            return orig[n](*a, **k)
        return call
    for n in names:
        setattr(ops, n, wrap(n))
    try:
        yield bad
    finally:
        for n in names:
            setattr(ops, n, orig[n])


def mesh_training(dev, mesh, ckpt_dir):
    """(a) ``Trainer(mesh=make_local_mesh())`` on the card: full-width
    stablelm-1.6b cut to ``MESH_LAYERS`` layers, f32 masters with q/k at
    their real fan-in, ``MESH_STEPS`` steps of ``MESH_B`` x ``MESH_S``
    tokens (``Trainer.run``, which saves the last step's checkpoint into
    ``ckpt_dir``); then the mesh-less ``Trainer``'s step function over the
    same ``TokenPipeline`` batches from the same masters. Gates: each loss
    within 1e-5 relative and each final master within 1e-5 rel L2 of the
    mesh-less run's; exactly ``lm_launches_per_step(MESH_LAYERS)`` launches
    a step (rmsnorm, rmsnorm_bwd, K2, K2's backward), no other kernel, and
    every kernel input a plain CUDA tensor (each rank's local shard through
    ``local_map``). Returns (ok, stats, the mesh trainer)."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.train import Trainer, _batch
    from repro_torch.models.common import tree_map, tree_paths
    cfg = full_config(num_layers=MESH_LAYERS)
    masters = lm_masters(cfg, dev, seed=53)
    with torch.no_grad():
        fan_in_qk(masters, cfg)
    masters = tree_map(lambda t: t.detach(), masters)
    kw = dict(batch=MESH_B, seq=MESH_S, device=dev, ckpt_every=10 ** 9,
              async_ckpt=False, lr=LM_LR, total_steps=MESH_STEPS)
    tr = Trainer(cfg, ckpt_dir=ckpt_dir, mesh=mesh, params=masters, **kw)
    torch.cuda.synchronize()
    ops.reset_launches()
    with plain_kernel_inputs() as bad:
        losses = tr.run(MESH_STEPS)
    torch.cuda.synchronize()
    launches = kernel_launches()
    mesh_ms = [1e3 * d for d in tr.straggler.durations]
    # the same steps without a mesh: the trainer's own step function
    plain = Trainer(cfg, ckpt_dir=os.path.join(ckpt_dir, "unused"),
                    params=masters, **kw)
    state = plain.init_state()
    want, plain_ms = [], []
    for _ in range(MESH_STEPS):
        batch = _batch(next(plain.data), plain.device)
        t0 = time.perf_counter()
        state, metrics = plain._step_fn(state, batch)
        want.append(float(metrics["loss"]))
        plain_ms.append(1e3 * (time.perf_counter() - t0))
    worst = [0.0, None]
    with np.load(os.path.join(ckpt_dir, f"checkpoint-{MESH_STEPS - 1}.npz")) \
            as saved:
        for k, v in tree_paths(state["params"]):
            a, b = saved["params/" + k], v.detach().float().cpu().numpy()
            r = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
            if r >= worst[0]:
                worst = [r, k]
    del state
    per = lm_launches_per_step(MESH_LAYERS)
    stats = {"card": smi_line(), "layers": MESH_LAYERS, "d": cfg.d_model,
             "batch": [MESH_B, MESH_S], "steps": MESH_STEPS,
             "losses_mesh": losses, "losses_plain": want,
             "bit_identical_losses": losses == want,
             "worst_master_rel_l2": worst,
             "step_ms_mesh": mesh_ms, "step_ms_plain": plain_ms,
             "step_ms_mesh_median": float(np.median(mesh_ms[1:])),
             "step_ms_plain_median": float(np.median(plain_ms[1:])),
             "launches": launches, "launches_per_step": per,
             "non_plain_kernel_inputs": bad[:4]}
    log("mesh training (1-device mesh vs no mesh): "
        + json.dumps(stats, default=float))
    ok = all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(losses, want))
    ok &= len(losses) == MESH_STEPS and worst[0] <= 1e-5 and not bad
    ok &= launches == {k: v * MESH_STEPS for k, v in per.items()}
    return ok, stats, tr


def mesh_compression(dev, mesh):
    """(b) ``compressed_pmean`` of a ``MESH_GRAD_MB`` MB f32 gradient tree
    over the mesh's 1-rank NCCL group equals ``dequantize_int8(
    *quantize_int8(x))`` bit for bit, leaf for leaf."""
    import torch

    from repro_torch.distributed import compression as C
    gen = torch.Generator(device=dev).manual_seed(59)
    n = MESH_GRAD_MB * (1 << 20) // 4
    sizes = [n // 2, n // 4, n // 8, n - n // 2 - n // 4 - n // 8]
    tree = {f"g{i}": torch.randn(m, generator=gen, device=dev) * 10.0 ** -i
            for i, m in enumerate(sizes)}
    t0 = time.perf_counter()
    got = C.tree_compressed_pmean(tree, mesh.get_group("data"))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    same = {k: bool(torch.equal(got[k], C.dequantize_int8(
        *C.quantize_int8(v)))) for k, v in tree.items()}
    out = {"mb": MESH_GRAD_MB, "leaves": sizes, "bit_equal": same,
           "host_ms": ms}
    log("mesh compression: " + json.dumps(out))
    return all(same.values()), out


def mesh_restore(tr, ckpt_dir):
    """(c) (a)'s checkpoint restored onto the mesh with ``shardings=
    trainer.state_shardings(...)``: every leaf a DTensor in those
    placements (the step counter plain) equal to the saved leaf."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import ckpt
    from repro_torch.checkpoint.ckpt import _sharding_paths
    from repro_torch.models.common import tree_paths
    like = tr.init_state()
    sh = tr.state_shardings(like)
    t0 = time.perf_counter()
    state, step = ckpt.restore(ckpt_dir, like, shardings=sh)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    del like
    want = _sharding_paths(state, sh)
    bad = []
    with np.load(os.path.join(ckpt_dir, f"checkpoint-{step}.npz")) as saved:
        for k, v in tree_paths(state):
            if want[k] is not None and (not hasattr(v, "placements") or tuple(
                    v.placements) != tuple(want[k][1])):
                bad.append(k)
                continue
            loc = v.to_local() if hasattr(v, "to_local") else v
            if not np.array_equal(loc.detach().cpu().numpy(), saved[k]):
                bad.append(k)
    out = {"step": step, "leaves": len(want), "mismatched": bad[:5],
           "restore_s": s}
    log("mesh restore: " + json.dumps(out))
    return not bad and step == MESH_STEPS - 1, out


def mesh_expert_parallel(dev, mesh):
    """(d) One olmoe-1b-7b prefill (full width, ``MOE_LAYERS`` layers, one
    row of ``MOE_S`` tokens, TP-placed bf16 params on the mesh) with
    ``moe_dispatch="ep"`` against the mesh-less gshard path on the same
    weights: one row is ep's one routing group and gshard's, so the two
    drop the same tokens. Gates: ep ran at every MoE layer (no fallback),
    the hidden states up to the first token routed to other experts within
    2e-2 rel L2 and, with no such token, the last logits too (bf16
    products summed in other orders)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.launch.train import distribute
    from repro_torch.models import blocks, lm, moe
    from repro_torch.models.common import ShardCtx, logical_axes
    from repro_torch.sharding import rules as R
    cfg = family_config(OLMOE, num_layers=MOE_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(61)
    params = lm.init_model(gen, cfg, device=dev)
    with torch.no_grad():
        fan_in_qk(params, cfg)
    toks = torch.randint(0, cfg.vocab_size, (1, MOE_S), device=dev,
                         generator=gen)
    ep_cfg = dataclasses.replace(cfg, moe_dispatch="ep")
    dparams = distribute(params, R.tree_shardings(
        R.TP_RULES, logical_axes(lm.model_spec(cfg)), mesh, params))
    shard = ShardCtx(R.ACT_RULES, mesh)
    routes = {"ep": [], "gshard": []}
    ran_ep = []
    orig_moe, orig_ep = blocks.moe_ffn, moe._moe_ep

    def record(p, x, *, k, **kw):
        xx = x.full_tensor() if hasattr(x, "full_tensor") else x
        rw = p["router"].full_tensor() if hasattr(p["router"], "full_tensor") \
            else p["router"]
        _, idx = moe.top_k(torch.softmax(xx.float() @ rw.float(), dim=-1), k)
        routes["ep" if hasattr(x, "full_tensor") else "gshard"].append(
            np.sort(idx.cpu().numpy(), axis=-1))
        return orig_moe(p, x, k=k, **kw)

    def ep(*a, **k):
        out = orig_ep(*a, **k)
        ran_ep.append(out is not None)
        return out
    blocks.moe_ffn, moe._moe_ep = record, ep
    try:
        with torch.no_grad():
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                hx, _ = lm.forward(dparams, ep_cfg, tokens=toks, shard=shard)
                lx, _ = lm.prefill(dparams, ep_cfg, tokens=toks, cache=None,
                                   shard=shard)
                hx, lx = hx.full_tensor(), lx.full_tensor()
            hg, _ = lm.forward(params, cfg, tokens=toks)
            lg, _ = lm.prefill(params, cfg, tokens=toks, cache=None)
    finally:
        blocks.moe_ffn, moe._moe_ep = orig_moe, orig_ep
    first = MOE_S
    for a, b in zip(routes["ep"], routes["gshard"]):
        f = (a != b).any(-1)[0]
        if f.any():
            first = min(first, int(np.argmax(f)))

    def rel(a, b):
        return (torch.linalg.vector_norm((a - b).float())
                / torch.linalg.vector_norm(b.float())).item()
    h_rel = rel(hx[:, :first], hg[:, :first]) if first else 0.0
    l_rel = rel(lx, lg) if first == MOE_S else None
    out = {"card": smi_line(), "layers": MOE_LAYERS, "tokens": MOE_S,
           "ep_calls": ran_ep, "first_flip": first,
           "hidden_rel_l2": h_rel, "logits_rel_l2": l_rel,
           "moe_calls": [len(routes["ep"]), len(routes["gshard"])]}
    log("mesh expert parallelism (ep on the mesh vs gshard): "
        + json.dumps(out))
    ok = len(ran_ep) == MOE_LAYERS * 2 and all(ran_ep)
    ok &= h_rel <= 2e-2 and (l_rel is None or l_rel <= 2e-2)
    return ok, out


def mesh_dryrun_start(out):
    """(e) ``python -m repro_torch.launch.dryrun --cell DRYRUN_CELL`` as a
    subprocess on the torch build that runs this script (host only: a
    256-rank fake group, meta tensors), started before (a) so that it runs
    beside it."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--cell",
         DRYRUN_CELL, "--out", out], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)


def mesh_dryrun_finish(proc, out):
    try:
        so, se = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        so, se = proc.communicate()
    rec = {}
    if os.path.exists(out):
        lines = open(out).read().splitlines()
        rec = json.loads(lines[-1]) if lines else {}
    mem = rec.get("memory", {})
    stats = {"rc": proc.returncode, "cell": DRYRUN_CELL,
             "status": rec.get("status"), "chips": rec.get("chips"),
             "trace_s": rec.get("trace_s"),
             "flops_per_dev": rec.get("hlo_flops_per_dev"),
             "model_flops_per_dev": rec.get("model_flops_per_dev"),
             "collective_bytes": rec.get("collectives", {}).get("total"),
             "bottleneck": (rec.get("roofline") or {}).get("bottleneck"),
             "roofline": rec.get("roofline"),
             "argument_gb": mem.get("argument_size_in_bytes", 0) / 1e9,
             "temp_gb": mem.get("temp_size_in_bytes", 0) / 1e9,
             "kernels": rec.get("cost_analysis_raw"),
             "error": (rec.get("error") or se[-800:]) if
             rec.get("status") != "ok" else None}
    log("mesh dry-run cell: " + json.dumps(stats, default=float))
    ok = proc.returncode == 0 and rec.get("status") == "ok" and \
        rec.get("chips") == 256 and stats["bottleneck"] is not None
    return ok, stats


def phase_mesh(dev):
    """Phase 13: the mesh plane on the card. ``make_local_mesh()``, a (1, 1)
    mesh over ("data", "model") on a 1-rank NCCL group, carries (a)
    ``Trainer(mesh=...)`` against the mesh-less trainer, (b) the int8
    compressed mean, (c) the cross-mesh restore of (a)'s checkpoint and (d)
    the expert-parallel MoE; (e) one dry-run cell runs as a subprocess
    beside them. The group is torn down at the end. Its launches stay out
    of the kernels line's sums (the phase gates them itself)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="mesh_phase_")
    phases, stats = {}, {}
    proc = mesh_dryrun_start(os.path.join(tmp, "dryrun_torch.jsonl"))
    try:
        mesh = make_local_mesh()
        ckpt_dir = os.path.join(tmp, "ckpt")
        phases["mesh_training"], stats["training"], tr = mesh_training(
            dev, mesh, ckpt_dir)
        free_device()
        phases["mesh_compression"], stats["compression"] = \
            mesh_compression(dev, mesh)
        phases["mesh_restore"], stats["restore"] = mesh_restore(tr, ckpt_dir)
        del tr
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        free_device()
        phases["mesh_expert_parallel"], stats["ep"] = \
            mesh_expert_parallel(dev, mesh)
        free_device()
    finally:
        phases["mesh_dryrun"], stats["dryrun"] = mesh_dryrun_finish(
            proc, os.path.join(tmp, "dryrun_torch.jsonl"))
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"mesh phase: {phases}, {time.perf_counter() - t0:.1f} s")
    return phases, stats


# ---------------- phase 14: long context and the recurrent scans -----------

# the long_500k cells' cache: 524288 positions, cut into the 16 pieces of
# the "data" split (32768 positions each) under the long-context rules
LONG_S, LONG_PIECES = 524288, 16
# K5 at the long_500k cells' attention layers: h2o-danube-1.8b's (hd 80,
# its 4096-position window) and jamba's (hd 128, no window), one row, at
# the full length, an odd length and one position
LONG_CASES = {"h2o": dict(H=32, KV=8, hd=80, window=4096),
              "jamba": dict(H=32, KV=8, hd=128, window=None)}
LONG_LENS = (LONG_S, 300001, 1)
LONG_STEPS = 6                  # decode steps at ~524288 positions
LONG_TOL = (1e-2, 5e-2)         # rel L2, max abs: one call vs 16 pieces
XLSTM_TRAIN_B, XLSTM_TRAIN_S, XLSTM_TRAIN_STEPS = 2, 4096, 1
MAMBA_S = 4096
# the dry-run cells phase_long runs on the host (started with the run)
LONG_DRYRUN_CELLS = ("h2o-danube-1.8b:long_500k:pod1",
                     "jamba-v0.1-52b:long_500k:pod1",
                     "xlstm-125m:train_4k:pod1", "jamba-v0.1-52b:train_4k:pod1")


def long_pieces(q, k, v, ln, window, pieces=LONG_PIECES, scales=None):
    """K5 over the cache (B, S, KV, hd) cut into ``pieces`` along its
    sequence, as the ranks of the long-context split hold it (with
    ``scales`` (k_scale, v_scale): K3 over an int8 cache): each piece with
    its key offset and log-sum-exp, merged by ``models.attention.
    merge_partials`` -> (o in q's dtype, [(o, lse)] of each piece)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.attention import merge_partials

    def call(kc, vc, **kw):
        if scales is None:
            return ops.decode_attention(q, kc, vc, ln, window=window, **kw)
        return ops.decode_attention_int8(q, kc, vc, *scales, ln,
                                         window=window, **kw)
    n = k.shape[1] // pieces
    parts = [call(k[:, i * n:(i + 1) * n], v[:, i * n:(i + 1) * n],
                  key_offset=i * n, return_lse=True) for i in range(pieces)]
    o, _ = merge_partials(torch.stack([p[0] for p in parts]),
                          torch.stack([p[1] for p in parts]))
    return o.to(q.dtype), parts


def long_kernel(dev, gen, int8: bool):
    """K5 (float cache) or K3 (``int8``: an int8 cache, ``quantize_kv`` of
    random floats) with a key offset and log-sum-exp at the long_500k
    shapes, against its plain version on the card: each length's call
    within two bf16 ulps of the largest output; the same call with
    ``return_lse`` rounding to its bits (the log-sum-exp path computes what
    the plain call does); every piece (key offset, lse) within two ulps of
    its largest output (o) and 1e-3 (lse) of the plain version's piece; the
    16 pieces merged within two ulps of the one call; a piece wholly
    outside the window or past the length o = 0 and lse = -inf; K3 also
    through each body its plan did not pick, within two ulps and the same
    bits twice, and a second call of the plan's with the same bits. Timed at
    the full length: one call, the 16 pieces plus the merge, the plain
    version and SDPA (``enable_gqa``, the window as a mask) on the same
    cache (K3's dequantized to bf16 outside the timing)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref
    label = "K3" if int8 else "K5"
    ok, out = True, {}
    for name, case in LONG_CASES.items():
        H, KV, hd, window = case["H"], case["KV"], case["hd"], case["window"]
        # K3's other bodies, each checked at every length too
        sides = k3_sides(1, KV, H // KV, hd, LONG_S, window,
                         dev)[1:] if int8 else []
        if int8:
            q, k, v, ks, vs, _ = int8_inputs(gen, 1, H, KV, LONG_S, hd, 1,
                                             dev, lens=[LONG_S])[0]
            free_device()
            scales = (ks, vs)

            def kernel(kc, vc, ln, **kw):
                return ops.decode_attention_int8(q, kc, vc, ks, vs, ln,
                                                 window=window, **kw)

            def plain(kc, vc, ln, **kw):
                return ref.decode_attention_int8_ref(
                    q, kc.transpose(1, 2), vc.transpose(1, 2), ks, vs, ln,
                    window=window, **kw)
        else:
            q, k, v, _ = float_inputs(gen, 1, H, KV, LONG_S, hd, 1, dev,
                                      lens=[LONG_S])[0]
            scales = None

            def kernel(kc, vc, ln, **kw):
                return ops.decode_attention(q, kc, vc, ln, window=window,
                                            **kw)

            def plain(kc, vc, ln, **kw):
                return ref.decode_attention_ref(
                    q, kc.transpose(1, 2), vc.transpose(1, 2), ln,
                    window=window, p_dtype=vc.dtype, **kw)
        n = LONG_S // LONG_PIECES
        res = {}
        for L in LONG_LENS:
            ln = torch.tensor([L], dtype=torch.int32, device=dev)
            got = kernel(k, v, ln)
            want = plain(k, v, ln)
            tol = 2 * 2.0 ** -8 * want.float().abs().max().item() + 1e-6
            err = (got.float() - want.float()).abs().max().item()
            o32, _ = kernel(k, v, ln, return_lse=True)
            same = torch.equal(got, o32.to(got.dtype)) and \
                torch.equal(got, kernel(k, v, ln))
            side_err = {}
            for side in sides:
                with k3_forced(side):
                    s1, s2 = kernel(k, v, ln), kernel(k, v, ln)
                e = (s1.float() - want.float()).abs().max().item()
                side_err[f"{side[0]}{side[1]}"] = e
                same &= e <= tol and torch.equal(s1, s2)
                del s1, s2
            merged, parts = long_pieces(q, k, v, ln, window, scales=scales)
            merr = (merged.float() - got.float()).abs().max().item()
            # each piece against its own plain version, two ulps of that
            # piece's largest output (a piece normalised over fewer keys
            # holds larger outputs than the whole)
            perr, pok, lerr, empty, empty_ok = 0.0, True, 0.0, 0, True
            lo = max(0, L - window) if window else 0
            for i, (po, pl) in enumerate(parts):
                wo, wl = plain(k[:, i * n:(i + 1) * n],
                               v[:, i * n:(i + 1) * n], ln, key_offset=i * n,
                               return_lse=True)
                e = (po - wo).abs().max().item()
                perr = max(perr, e)
                pok &= e <= 2 * 2.0 ** -8 * wo.abs().max().item() + 1e-6
                fin = torch.isfinite(wl)
                pok &= torch.equal(fin, torch.isfinite(pl))
                lerr = max(lerr, (pl[fin] - wl[fin]).abs().max().item()
                           if fin.any() else 0.0)
                if i * n >= L or (i + 1) * n <= lo:
                    empty += 1
                    empty_ok &= bool(torch.isneginf(pl).all()) and \
                        not po.any().item()
            good = err <= tol and pok and merr <= tol and \
                lerr <= 1e-3 and same and empty_ok and \
                bool(torch.isfinite(merged.float()).all())
            log(f"long {label} [{name}] H={H} KV={KV} hd={hd} S={LONG_S} "
                f"window={window} len={L}: max_abs_err={err:.3e} (bound "
                f"{tol:.3e}), other bodies {json.dumps(side_err)}, lse path "
                f"and a second call same bits: {same}, pieces: o err "
                f"{perr:.3e}, lse err {lerr:.3e}, {empty} empty (o 0, lse "
                f"-inf: {empty_ok}), 16-piece merge vs one call "
                f"{merr:.3e}: {good}")
            ok &= good
            res[L] = {"max_abs_err": err, "merge_err": merr,
                      "piece_err": perr, "lse_err": lerr,
                      "empty_pieces": empty, "other_bodies_err": side_err}
        ln = torch.tensor([LONG_S], dtype=torch.int32, device=dev)
        by_kernel = device_kernels(lambda: kernel(k, v, ln))
        ms = sum(by_kernel.values())
        pieces_ms = device_ms(lambda: long_pieces(q, k, v, ln, window,
                                                  scales=scales))
        plain_ms = device_ms(lambda: plain(k, v, ln), iters=3, warmup=1)
        if int8:
            k4 = (k.transpose(1, 2).float() * ks[:, :, None, None]).to(
                torch.bfloat16)
            v4 = (v.transpose(1, 2).float() * vs[:, :, None, None]).to(
                torch.bfloat16)
        else:
            k4 = k.transpose(1, 2).contiguous()
            v4 = v.transpose(1, 2).contiguous()
        mask = None
        if window is not None:
            pos = torch.arange(LONG_S, device=dev)
            mask = (pos >= LONG_S - window)[None, None, None]
        sdpa_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q.view(1, H, 1, hd), k4, v4, attn_mask=mask, enable_gqa=True),
            **({"iters": 5, "warmup": 1} if int8 else {}))
        del k4, v4
        bound, by = (int8_bound if int8 else float_bound)(q, k, ln, window)
        out[name] = {"ms": ms, "pieces_ms": pieces_ms, "plain_ms": plain_ms,
                     "library_ms": sdpa_ms, "bound_ms": bound,
                     "bound_by": by, "lengths": res}
        if int8:
            out[name]["plan"] = k3_plan(1, KV, H // KV, hd, LONG_S, window,
                                        dev)
            out[name]["split_ms"] = kernel_split(by_kernel, K3_PARTS)
            log(f"long K3 [{name}]: plan {out[name]['plan']}, by kernel "
                f"{json.dumps(out[name]['split_ms'])} ms")
        log(f"long {label} timing [{name}] (card {smi_line()}): one call "
            f"{ms:.4f} ms, 16 pieces + merge {pieces_ms:.4f} ms, plain "
            f"{plain_ms:.3f} ms, SDPA {sdpa_ms:.4f} ms, bound {bound:.4f} ms"
            f" ({by})")
        del q, k, v, kernel, plain
        free_device()
    return ok, out


def long_k5(dev, gen):
    """(a) K5 at the long_500k shapes (``long_kernel``)."""
    return long_kernel(dev, gen, int8=False)


def long_k3(dev, gen):
    """(a) K3 at the long_500k shapes (``long_kernel``): the plan's split
    body (tens of splits a (row, kv head) and the merge), and at every
    length its other bodies (``k3_sides``)."""
    return long_kernel(dev, gen, int8=True)


@contextlib.contextmanager
def attention_in_pieces():
    """The dense cache's decode attention (float: ``models.attention.
    decode_attention``; int8: ``attention._attend_int8``) routed through
    ``long_pieces`` while open."""
    from repro_torch.models import attention

    real = attention.decode_attention, attention._attend_int8

    def pieces(q, k_cache, v_cache, cache_len, *, window=None):
        return long_pieces(q, k_cache, v_cache, cache_len, window)[0]

    def pieces_int8(q, k_cache, v_cache, ks, vs, lens, window, piece):
        return long_pieces(q, k_cache, v_cache, lens, window,
                           scales=(ks, vs))[0]
    attention.decode_attention, attention._attend_int8 = pieces, pieces_int8
    try:
        yield
    finally:
        attention.decode_attention, attention._attend_int8 = real


def long_decode(dev, arch, seed, kv_quant=False):
    """(b) ``lm.decode_step`` of ``arch`` (h2o-danube-1.8b at full width
    and depth, jamba at its served JAMBA_LAYERS) on one row of a float
    cache of LONG_S positions filled from a seed (no prefill: the
    recurrent states zero), its length LONG_S - LONG_STEPS, for
    LONG_STEPS steps through one ``graphs.Executable`` (call 1 eager, 2
    captured, then replays): TPOT over the replays, finite logits, K5's
    launches one per attention sublayer a step; then the last step again
    from the same state, eager, its attention through the 16 pieces and
    the merge, within LONG_TOL of the graphed step's logits. With
    ``kv_quant`` the dense int8 pool instead (random codes, per-(row, kv
    head) scales of 1.5 / 127) and K3."""
    import numpy as np
    import torch

    from repro_torch.core import graphs
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    cfg = stack_config(arch) if arch == JAMBA else family_config(arch)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = lm.init_model(gen, cfg, device=dev)
    with torch.no_grad():
        fan_in_qk(params, cfg)
    cache = lm.init_cache(cfg, 1, LONG_S, kv_quant=kv_quant, device=dev)
    n_attn = 0
    for sub in cache:
        if "k" in sub:
            for name in ("k", "v"):
                if kv_quant:
                    sub[name].random_(-127, 128, generator=gen)
                    sub[f"{name}_scale"].fill_(1.5 / 127)
                else:
                    sub[name].normal_(generator=gen)
            sub["len"].fill_(LONG_S - LONG_STEPS)
            n_attn += sub["k"].shape[0]
    gb = sum(t.numel() * t.element_size() for sub in cache
             for t in sub.values()) / 1e9
    toks = torch.randint(0, cfg.vocab_size, (LONG_STEPS, 1), generator=gen,
                         device=dev)

    def step(params, cache, tok):
        return lm.decode_step(params, cfg, tokens=tok, cache=cache)[0]
    exe = graphs.Executable(step, bake=(0, 1))
    ops.reset_launches()
    ms, finite = [], True
    for t in range(LONG_STEPS):
        if t == LONG_STEPS - 1:
            snap = [{k: v.clone() for k, v in sub.items()
                     if k not in ("k", "v")} for sub in cache]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = exe(params, cache, toks[t])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        finite &= bool(torch.isfinite(logits).all())
    launches = kernel_launches()
    bodies = ops.bodies()
    last = logits.float().clone()
    for sub, sn in zip(cache, snap):
        for k, v in sn.items():
            sub[k].copy_(v)
    with graphs.disabled(), attention_in_pieces(), torch.no_grad():
        split = lm.decode_step(params, cfg, tokens=toks[-1],
                               cache=cache)[0].float()
    rel = (torch.linalg.vector_norm(split - last) /
           torch.linalg.vector_norm(last)).item()
    worst = (split - last).abs().max().item()
    want = n_attn * LONG_STEPS
    kernel = "decode_attention_int8" if kv_quant else "decode_attention"
    stats = {"card": smi_line(), "layers": cfg.num_layers, "int8": kv_quant,
             "attention_layers": n_attn, "cache_gb": gb,
             "len_last": LONG_S, "tpot_ms": float(np.median(ms[2:])),
             "step_ms": ms, "finite": finite,
             "pieces_vs_one_call": [rel, worst], "launches": launches,
             "bodies": bodies}
    log(f"long decode {arch}{' int8' if kv_quant else ''}: "
        + json.dumps(stats, default=float))
    ok = finite and rel <= LONG_TOL[0] and worst <= LONG_TOL[1] and \
        launches.get(kernel, 0) == want
    del exe, params, cache, logits
    free_device()
    return ok, stats


def long_xlstm_training(dev):
    """(c) xlstm-125m at full width and its served XLSTM_LAYERS: one
    ``make_train_step`` step (a second took 71 s of the run's time and
    is checked no differently) on one batch of XLSTM_TRAIN_B x
    XLSTM_TRAIN_S, the mLSTM/sLSTM scans in checkpointed chunks of 64
    inside the per-period remat. The peak memory of a step above what the
    params and AdamW hold, beside the prediction: without chunks each
    mLSTM layer would keep every step's (B, 4, 384, 384) f32 memory C (3
    layers x 2 rows x 9.7 GB = 58 GB of C alone); with them it keeps 64
    boundary states a layer (3 x 64 x 4.73 MB = 0.91 GB) plus one chunk's
    recompute."""
    import numpy as np
    import torch

    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch.train import make_train_step
    from repro_torch.optim.adamw import AdamW
    cfg = stack_config(XLSTM)
    params = lm_masters(cfg, dev, seed=61)
    with torch.no_grad():
        fan_in_qk(params, cfg)
    opt = AdamW(lr=LM_LR)
    state = {"params": params, "opt": opt.init(params)}
    step = make_train_step(cfg, opt)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in next(TokenPipeline(
        cfg, XLSTM_TRAIN_B, XLSTM_TRAIN_S, seed=62)).items()}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(XLSTM_TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        ms.append(1e3 * (time.perf_counter() - t0))
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    di = int(cfg.xlstm_proj_factor * cfg.d_model)
    hd = di // cfg.num_heads
    n_ml = sum(1 for k in cfg.block_pattern[:cfg.num_layers] if k == "mlstm")
    state_b = XLSTM_TRAIN_B * cfg.num_heads * (hd * hd + hd + 1) * 4
    pred = {"boundaries_gb": n_ml * (XLSTM_TRAIN_S // 64) * state_b / 1e9,
            "unchunked_C_gb": n_ml * XLSTM_TRAIN_S * XLSTM_TRAIN_B
            * cfg.num_heads * hd * hd * 4 / 1e9}
    stats = {"card": smi_line(), "layers": cfg.num_layers,
             "batch": [XLSTM_TRAIN_B, XLSTM_TRAIN_S], "losses": losses,
             "step_ms": ms, "base_gb": base / 1e9, "step_peak_gb": peak,
             "prediction": pred}
    log("long xlstm training: " + json.dumps(stats, default=float))
    ok = all(np.isfinite(losses)) and peak < pred["unchunked_C_gb"] / 4
    del state, step, params
    free_device()
    return ok, stats


def long_mamba(dev):
    """(c) One Mamba layer at jamba's width (d 4096, di 8192, d_state 16),
    forward and backward at B 1, S MAMBA_S, in checkpointed chunks of 128
    and again with nothing checkpointed (``scan._run`` run plain): each
    one's peak memory beside the prediction (unchunked: dA, dBx and the
    states, each (S, di, ds) f32, 2.15 GB; chunked: 32 boundary states of
    0.5 MB and one chunk's three (128, di, ds) tensors, 0.2 GB), and the
    same gradients."""
    import torch

    from repro_torch.models import mamba, scan
    from repro_torch.models.common import init_params
    cfg = family_config(JAMBA)
    gen = torch.Generator(device=dev).manual_seed(71)
    # f32 masters, as the trainer holds them: the forward casts at each use
    p = {k: v.requires_grad_(True) for k, v in init_params(
        gen, mamba.mamba_spec(cfg), device=dev).items()}
    x = (torch.randn((1, MAMBA_S, cfg.d_model), generator=gen, device=dev)
         * 0.1).to(torch.bfloat16).requires_grad_(True)

    def run():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        y, _ = mamba.mamba_forward(p, x, cfg)
        g = torch.autograd.grad(y.float().square().mean(), [x, p["A_log"]])
        torch.cuda.synchronize()
        return ((torch.cuda.max_memory_allocated() - base) / 1e9,
                1e3 * (time.perf_counter() - t0), [t.float() for t in g])
    chunked, c_ms, g1 = run()
    real = scan._run
    scan._run = lambda fn, state, xs, consts: fn(state, xs, *consts)
    try:
        whole, w_ms, g0 = run()
    finally:
        scan._run = real
    di, ds = cfg.mamba_expand * cfg.d_model, cfg.mamba_d_state
    pred = {"unchunked_gb": 3 * MAMBA_S * di * ds * 4 / 1e9,
            "chunked_gb": (MAMBA_S // 128 * di * ds * 4
                           + 3 * 128 * di * ds * 4) / 1e9}
    same = all(torch.equal(a, b) for a, b in zip(g1, g0))
    rel = max((torch.linalg.vector_norm(a - b) /
               torch.linalg.vector_norm(b)).item() for a, b in zip(g1, g0))
    stats = {"card": smi_line(), "S": MAMBA_S, "peak_gb_chunked": chunked,
             "peak_gb_unchunked": whole, "ms_chunked": c_ms,
             "ms_unchunked": w_ms, "prediction": pred,
             "gradients_bit_identical": same, "gradients_rel_l2": rel}
    log("long mamba layer: " + json.dumps(stats, default=float))
    del p, x, g0, g1
    free_device()
    # the gradients: the same ops in the same order (a checkpoint hands
    # the recomputed tensors back to the same graph), 1e-6 rel L2 a leaf
    return rel <= 1e-6 and chunked < whole / 4, stats


def long_dryrun_start():
    """(d) ``python -m repro_torch.launch.dryrun --cell`` of each of
    LONG_DRYRUN_CELLS as subprocesses on the host (a 256-rank fake group,
    meta tensors), started with the run at a lower priority, each writing
    its own file, its output and errors to files beside it (a pipe that
    nobody reads until the end could stall it): ({cell: process},
    directory)."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="long_dryrun_")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {}
    for cell in LONG_DRYRUN_CELLS:
        base = os.path.join(tmp, cell.replace(":", "_"))
        with open(base + ".stdout", "w") as so, \
                open(base + ".stderr", "w") as se:
            procs[cell] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--cell",
                 cell, "--out", base], stdout=so, stderr=se, env=env,
                cwd=ROOT, preexec_fn=lambda: os.nice(10))
        stop_at_exit(procs[cell])   # none left running on an early exit
    return procs, tmp


def long_dryrun_finish(procs, tmp, timeout=120):
    """Wait for the dry-run cells (each traced in a few seconds; those not
    done ``timeout`` s from here are killed and fail) and read their
    records: (ok, {cell: summary})."""
    import shutil
    ok, stats = True, {}
    t_end = time.perf_counter() + timeout
    for cell, proc in procs.items():
        try:
            proc.wait(timeout=max(1.0, t_end - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        path = os.path.join(tmp, cell.replace(":", "_"))
        with open(path + ".stderr") as f:
            se = f.read()
        lines = open(path).read().splitlines() if os.path.exists(path) \
            else []
        rec = json.loads(lines[-1]) if lines else {}
        stats[cell] = {"rc": proc.returncode, "status": rec.get("status"),
                       "trace_s": rec.get("trace_s"),
                       "flops_per_dev": rec.get("hlo_flops_per_dev"),
                       "collective_bytes": (rec.get("collectives") or {}).get(
                           "total"),
                       "temp_gb": (rec.get("memory") or {}).get(
                           "temp_size_in_bytes", 0) / 1e9,
                       "error": None if rec.get("status") == "ok" else
                       (rec.get("error") or se[-800:])}
        ok &= proc.returncode == 0 and rec.get("status") == "ok"
    shutil.rmtree(tmp, ignore_errors=True)
    log("long dry-run cells: " + json.dumps(stats, default=float))
    return ok, stats


def phase_long(dev, dryrun, xlstm=True):
    """Phase 14: (a) K5 and K3 with a key offset and log-sum-exp at the
    long_500k shapes (``long_k5``, ``long_k3``), (b) decode at 524288
    positions (``long_decode``: h2o-danube-1.8b, jamba, and h2o-danube-1.8b
    on the dense int8 pool), (c) the checkpointed scans (``long_xlstm_
    training`` where ``xlstm``, else it ran in a child process beside
    phase_mesh; ``long_mamba``) and (d) the dry-run cells started with the
    run (``long_dryrun_finish``). Returns (phases, stats), stats with the
    decode runs' launches for the kernels line."""
    import torch
    t0 = time.perf_counter()
    phases, stats = {}, {}
    try:
        gen = torch.Generator(device=dev).manual_seed(53)
        phases["long_k5"], stats["k5"] = long_k5(dev, gen)
        free_device()
        phases["long_k3"], stats["k3"] = long_k3(dev, gen)
        for arch, seed in ((H2O, 54), (JAMBA, 55)):
            phases[f"long_decode {arch}"], stats[arch] = long_decode(
                dev, arch, seed)
        phases[f"long_decode_int8 {H2O}"], stats[f"{H2O} int8"] = \
            long_decode(dev, H2O, 56, kv_quant=True)
        t8, tf = stats[f"{H2O} int8"]["tpot_ms"], stats[H2O]["tpot_ms"]
        log(f"long decode {H2O}: TPOT {t8:.3f} ms on the int8 cache, "
            f"{tf:.3f} ms on the float cache ({t8 / tf:.3f}x)")
        if xlstm:
            phases["long_xlstm_training"], stats["xlstm"] = \
                long_xlstm_training(dev)
        phases["long_mamba"], stats["mamba"] = long_mamba(dev)
    finally:
        phases["long_dryrun"], stats["dryrun"] = long_dryrun_finish(*dryrun)
    launches = {}
    for run in (H2O, JAMBA, f"{H2O} int8"):
        for k, v in stats.get(run, {}).get("launches", {}).items():
            launches[k] = launches.get(k, 0) + v
    stats["launches"] = launches
    stats["bodies"] = sum_bodies(stats.get(run, {})
                                 for run in (H2O, JAMBA, f"{H2O} int8"))
    log(f"long phase: {phases}, {time.perf_counter() - t0:.1f} s")
    return phases, stats


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: this script runs the port on a GPU only")
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        return fail(f"the port is not importable next to this script ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    try:
        build.build_all()
    except RuntimeError as e:
        return fail(str(e))
    log(f"built kernels in {time.perf_counter() - t0:.1f} s, by source: "
        + json.dumps({k: round(v, 1) for k, v in build.BUILD_SECONDS.items()}))
    # the long phase's dry-run cells trace on the host beside the run
    long_dryrun = long_dryrun_start()
    for name in build.SOURCES:
        log(f"  ptxas {name} (kernel: registers, spill store bytes): "
            + ", ".join(f"{k}: {r}, {sp}" for k, r, sp in ptxas_kernels(name)))
    phases = {}
    # the kernels redesigned for registers and shared memory must not spill
    spills = {n: spill_stores(n) for n in build.SOURCES}
    log(f"  ptxas spill stores (bytes): {json.dumps(spills)}")
    phases["no_spills"] = not any(spills.values())
    try:
        hmma = sass_hmma("flash_attention")
    except (OSError, subprocess.SubprocessError) as e:
        return fail(f"cuobjdump failed: {e}")
    log(f"  sass flash_attention: {json.dumps(hmma)}")
    # K2's two products must run on the tensor cores: mma.sync m16n8k16 in
    # the mma.sync body, wgmma (S = Q K^T from shared memory, P V with P in
    # registers) in the Hopper body
    phases["flash_attention_hmma"] = hmma.get("HMMA.16816.F32.BF16", 0) > 0
    phases["flash_attention_hgmma"] = all(
        any(k.startswith(f"HGMMA.64x{n}x16.F32.BF16") for k in hmma)
        for n in (64, 128))
    ok_k, errs = phase_kernels(dev)
    phases["kernels"] = ok_k
    ok_r, _ = phase_reference(dev)
    phases["reference"] = ok_r
    ok_rp, _ = phase_reference_paged(dev)
    phases["paged_reference"] = ok_rp
    ok_rc, _ = phase_reference_chunked(dev)
    phases["chunked_reference"] = ok_rc
    ok_rw, _ = phase_reference_whisper(dev)
    phases["whisper_reference"] = ok_rw
    ok_s, stats, handles = phase_serving(dev)
    phases["serving"] = ok_s
    ok_p, pstats, paged_handles = phase_paged_serving(dev)
    phases["paged_serving"] = ok_p
    ok_c, cstats, chunked_handles = phase_paged_serving(dev, chunked=True)
    phases["chunked_serving"] = ok_c
    ok_w, wstats, whisper_handles = phase_whisper_serving(dev)
    phases["whisper_serving"] = ok_w
    ok_rm, _ = phase_reference_moment(dev)
    phases["moment_reference"] = ok_rm
    ok_m, mstats, moment_handles = phase_moment_serving(dev)
    phases["moment_serving"] = ok_m
    moment_profile = moment_handles[0].profiles["fm0"]
    ok_d, dstats = phase_durability(dev)
    phases["durability"] = ok_d
    ok_sp, spstats = phase_speculative(dev)
    phases["speculative"] = ok_sp
    k1, k2, k3, k4, k5, extra = phase_timing(dev, handles, paged_handles,
                                             chunked_handles, whisper_handles,
                                             moment_handles)
    kv = verify_timing(dev, torch.Generator(device=dev).manual_seed(9))
    extra["rmsnorm"] = rmsnorm_timing(
        dev, torch.Generator(device=dev).manual_seed(10))
    extra["speculative_step"] = spec_step_timing(dev, paged_handles[1])
    log("timing: " + json.dumps(extra, default=float))
    # the other families: stablelm's servers go first, so that each new
    # model's weights (minitron-8b: 22 GB) find the card's memory
    del handles, paged_handles, chunked_handles, whisper_handles
    del moment_handles
    free_device()
    t0 = time.perf_counter()
    fam_phases, fstats = phase_families(dev)
    phases.update(fam_phases)
    extra["families"] = family_timing(dev)
    log(f"families (servings): {fam_phases}, "
        f"{time.perf_counter() - t0:.1f} s")
    free_device()
    t0 = time.perf_counter()
    stack_phases, sstats = phase_stacks(dev)
    phases.update(stack_phases)
    extra["stacks"] = stack_timing(dev)
    log(f"stacks (servings): {stack_phases}, "
        f"{time.perf_counter() - t0:.1f} s")
    free_device()
    train_phases, tstats, terrs, ttiming = phase_training(dev, moment_profile)
    phases.update(train_phases)
    free_device()
    lm_phases, lstats = phase_lm_training(dev)
    phases.update(lm_phases)
    free_device()
    # the references of phases 9 and 10, xlstm-125m's long training step
    # and the checkpoint/restart example check and time nothing: they run
    # in child processes beside the mesh phase, which checks only
    t0 = time.perf_counter()
    children, e2e = start_children(), start_train_e2e()
    try:
        mesh_phases, _ = phase_mesh(dev)
        phases.update(mesh_phases)
    finally:
        child_phases, _ = finish_children(children)
        phases.update(child_phases)
        phases["train_e2e"], _ = finish_train_e2e(e2e)
    log(f"mesh phase and its children: {child_phases}, "
        f"{time.perf_counter() - t0:.1f} s")
    free_device()
    long_phases, long_stats = phase_long(dev, long_dryrun, xlstm=False)
    phases.update(long_phases)
    # launches on the main paths: the dense serving run (K1, K2, K3), the
    # paged serving run (K1, K2, K4), the chunked paged serving run (K1,
    # K2, K4), the whisper serving run (K1, K2, K4, K5), the moment
    # serving run (K2, and K1 where the table chose "segmented"), the
    # durability phase (K1, K2, K4, K5), the speculative runs (K1, K2,
    # K4's verify window), the other families' serving runs (K1, K2, K3
    # or K4) and the MoE and hybrid stacks' (K1, K2, K3 or K4; xlstm-125m
    # rmsnorm alone), rmsnorm in every one, the full-width training run
    # (K2, rmsnorm and their backward kernels) and the full-depth LM
    # training steps (the same four), and phase_long's decode at 524288
    # positions (K5 or K3, rmsnorm), each counted from 0 just before it
    main_runs = (stats, pstats, cstats, wstats, mstats, dstats, spstats,
                 *fstats.values(), *sstats.values(), tstats, lstats,
                 long_stats)
    launches = {k: sum(st["launches"].get(k, 0) for st in main_runs)
                for k in ("segmented_lora", "flash_attention",
                          "decode_attention_int8", "paged_decode_attention",
                          "paged_verify_attention", "decode_attention",
                          "rmsnorm", "flash_attention_bwd", "rmsnorm_bwd")}
    kernels = [
        {"name": "segmented_lora", "route": "cuda",
         "source": "src/repro_torch/csrc/segmented_lora.cu",
         "replaces": "src/repro/kernels/segmented_lora.py:72",
         "launches": launches["segmented_lora"],
         "max_abs_err": max(errs["segmented_lora"].values()),
         "library_ms": None, **k1},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:88",
         "launches": launches["flash_attention"],
         "max_abs_err": max(errs["flash_attention"].values()), **k2},
        {"name": "decode_attention_int8", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention_int8.cu",
         "replaces": "src/repro/kernels/decode_attention_int8.py:114",
         "launches": launches["decode_attention_int8"],
         "max_abs_err": max(errs["decode_attention_int8"].values()), **k3},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode_attention.cu",
         "replaces": "src/repro/kernels/paged_decode_attention.py:122",
         "launches": launches["paged_decode_attention"],
         "max_abs_err": max(errs["paged_decode_attention"].values()), **k4},
        {"name": "paged_verify_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_verify_attention.cu",
         "replaces": "src/repro/kernels/paged_decode_attention.py:122",
         "launches": launches["paged_verify_attention"],
         "max_abs_err": max(errs["paged_verify_attention"].values()),
         **{k: kv[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")}},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:96",
         "launches": launches["decode_attention"],
         "max_abs_err": max(errs["decode_attention"].values()), **k5},
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/csrc/rmsnorm.cu",
         "replaces": "src/repro/models/layers.py:29",
         "launches": launches["rmsnorm"],
         "max_abs_err": max(errs["rmsnorm"].values()),
         **{k: extra["rmsnorm"]["decode"][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/models/attention.py:50",
         "launches": launches["flash_attention_bwd"],
         "max_abs_err": max(terrs["flash_attention_bwd"].values()),
         **{k: ttiming["flash_attention_bwd_moment"][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
        {"name": "rmsnorm_bwd", "route": "cuda",
         "source": "src/repro_torch/csrc/rmsnorm.cu",
         "replaces": "src/repro/models/layers.py:29",
         "launches": launches["rmsnorm_bwd"],
         "max_abs_err": max(terrs["rmsnorm_bwd"].values()),
         **{k: ttiming["rmsnorm_bwd_1024x1024_dw"][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}},
    ]
    # K2's, K3's, K4's and the verify window's calls by body on the same
    # main paths, counted from 0 with the launches (K2: mma, the mma.sync body,
    # or wgmma, the Hopper body; cta: one CTA a pair, the window one a
    # position; split: the split body, one split or cell; merge: several
    # and the merge launch)
    bodies = sum_bodies(main_runs)
    for k in kernels:
        if k["name"] in ("flash_attention", "decode_attention_int8",
                         "paged_decode_attention", "paged_verify_attention"):
            k["calls_by_body"] = bodies.get(k["name"], {})
            whole = sum(k["calls_by_body"].values()) == k["launches"]
            phases["calls_by_body"] = phases.get("calls_by_body", True) \
                and whole
            log(f"{k['name']} calls by body on the main paths: "
                f"{json.dumps(k['calls_by_body'])}, summing to its "
                f"launches: {whole}")
    log(f"phases: {phases}, total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    try:
        smi = smi_line()
    except (OSError, subprocess.SubprocessError) as e:
        return fail(f"nvidia-smi failed: {e}")
    print(smi, flush=True)
    if not all(phases.values()):
        return fail(f"phase failed: {[k for k, v in phases.items() if not v]}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        sys.exit(child_main(sys.argv[2]))
    sys.exit(main())

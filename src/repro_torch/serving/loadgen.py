"""Workload generators (paper §7.1.3): Poisson sweeps, noisy-neighbor bursts,
and an Azure-Functions-like trace (lognormal per-task rates in low/moderate/
high load bands, with bursty on/off periods)."""
from __future__ import annotations

import numpy as np

from repro_torch.core.request import SLO, Request


def poisson_trace(task_id: str, rps: float, horizon: float, *, seed: int = 0,
                  slo_s: float | None = None, start: float = 0.0) -> list[Request]:
    rng = np.random.RandomState(seed)
    t, out = start, []
    while True:
        t += rng.exponential(1.0 / rps)
        if t >= start + horizon:
            break
        out.append(Request(task_id, t, slo=SLO(slo_s)))
    return out


def token_trace(task_id: str, rps: float, horizon: float, *, prompt_len: int,
                vocab: int, max_new: int = 8, seed: int = 0,
                slo_s: float | None = None, start: float = 0.0,
                min_prompt_len: int | None = None,
                infeasible_frac: float = 0.0,
                infeasible_slo_s: float = 1e-4) -> list[Request]:
    """Generative (prefill+decode) Poisson trace for the DecodeEngine path.

    Each request carries a random prompt (``payload``: int32 token ids) and a
    sampled decode budget (``max_new_tokens`` uniform in [1, max_new] —
    variable output lengths are what make continuous batching bite).
    ``min_prompt_len`` < ``prompt_len`` samples VARIABLE prompt lengths
    uniformly in [min, max] (exercising the engine's bucketed variable-length
    admission); by default all prompts are ``prompt_len`` long.
    ``Request.tokens`` carries prompt + output work units so BFQ's
    token-based accounting (§4.2) prices heavy requests proportionally.
    ``infeasible_frac`` marks that fraction of requests with a deadline no
    admission could meet (``infeasible_slo_s``, default 0.1 ms) — the chaos
    harness's fodder for the loop's pre-admission deadline shedding."""
    rng = np.random.RandomState(seed)
    lo = prompt_len if min_prompt_len is None else max(1, min_prompt_len)
    t, out = start, []
    while True:
        t += rng.exponential(1.0 / rps)
        if t >= start + horizon:
            break
        new = int(rng.randint(1, max_new + 1))
        plen = int(rng.randint(lo, prompt_len + 1))
        slo = SLO(infeasible_slo_s) if rng.rand() < infeasible_frac \
            else SLO(slo_s)
        out.append(Request(
            task_id, t, payload=rng.randint(0, vocab, plen).astype("int32"),
            tokens=float(plen + new), max_new_tokens=new, slo=slo))
    return out


def long_tail_token_trace(task_id: str, rps: float, horizon: float, *,
                          prompt_len: int, vocab: int, new_lo: int = 8,
                          new_hi: int = 512, seed: int = 0,
                          slo_s: float | None = None, start: float = 0.0,
                          min_prompt_len: int | None = None) -> list[Request]:
    """Generative trace with a LONG-TAIL decode-length mix: ``max_new_tokens``
    sampled log-uniformly in [new_lo, new_hi] (default 8-512), so most
    streams are short while a heavy tail runs 10-60x longer. This is the
    workload shape that makes dense per-slot KV reservations waste memory —
    and therefore what exercises page recycling and memory-aware admission
    on the paged pool: short streams retire and return pages while the tail
    keeps decoding. Prompt lengths are uniform in
    [min_prompt_len or prompt_len, prompt_len] like ``token_trace``."""
    rng = np.random.RandomState(seed)
    lo = prompt_len if min_prompt_len is None else max(1, min_prompt_len)
    t, out = start, []
    while True:
        t += rng.exponential(1.0 / rps)
        if t >= start + horizon:
            break
        new = int(round(np.exp(rng.uniform(np.log(new_lo),
                                           np.log(new_hi + 1)))))
        new = max(new_lo, min(new, new_hi))
        plen = int(rng.randint(lo, prompt_len + 1))
        out.append(Request(
            task_id, t, payload=rng.randint(0, vocab, plen).astype("int32"),
            tokens=float(plen + new), max_new_tokens=new, slo=SLO(slo_s)))
    return out


def shared_prefix_token_trace(task_id: str, rps: float, horizon: float, *,
                              prefix_len: int, prompt_len: int, vocab: int,
                              shared_frac: float = 0.8, n_prefixes: int = 1,
                              max_new: int = 8, seed: int = 0,
                              slo_s: float | None = None,
                              start: float = 0.0) -> list[Request]:
    """Generative trace for the COW prefix-sharing path: ``shared_frac`` of
    the requests carry one of ``n_prefixes`` fixed ``prefix_len``-token
    system/few-shot prefixes followed by a short unique user suffix (total
    length uniform in (prefix_len, prompt_len]); the rest carry fully random
    prompts up to ``prompt_len``. This is the multi-task serving shape the
    paper's memory argument targets — N co-resident streams repeating the
    same system prompt — where an unshared paged pool stores the prefix N
    times and a refcounted COW pool stores it once. ``max_new_tokens`` is
    uniform in [1, max_new] like ``token_trace``."""
    assert 0 < prefix_len < prompt_len
    rng = np.random.RandomState(seed)
    prefixes = [rng.randint(0, vocab, prefix_len).astype("int32")
                for _ in range(max(1, n_prefixes))]
    t, out = start, []
    while True:
        t += rng.exponential(1.0 / rps)
        if t >= start + horizon:
            break
        new = int(rng.randint(1, max_new + 1))
        if rng.rand() < shared_frac:
            suffix = rng.randint(0, vocab, int(
                rng.randint(1, prompt_len - prefix_len + 1))).astype("int32")
            prompt = np.concatenate(
                [prefixes[rng.randint(len(prefixes))], suffix])
        else:
            prompt = rng.randint(0, vocab, int(
                rng.randint(1, prompt_len + 1))).astype("int32")
        out.append(Request(
            task_id, t, payload=prompt, tokens=float(len(prompt) + new),
            max_new_tokens=new, slo=SLO(slo_s)))
    return out


def agentic_token_trace(task_id: str, rps: float, horizon: float, *,
                        prompt_len: int, vocab: int, overlap: float = 0.7,
                        motif_len: int = 8, n_motifs: int = 4,
                        max_new: int = 16, min_new: int | None = None,
                        seed: int = 0, slo_s: float | None = None,
                        start: float = 0.0) -> list[Request]:
    """Agentic tool-call-loop trace: the workload shape self-speculative
    decoding feeds on. An agent loop re-feeds its own context every round —
    tool-call scaffolding, echoed tool output, restated plans — so a large
    fraction of each prompt RECURS within itself and the stream's n-gram
    self-overlap is high (the prompt-lookup drafter finds matches, and a
    model continuing such a context keeps emitting spans it already
    emitted).

    Each prompt interleaves segments drawn from a small per-trace motif
    pool (the recurring scaffolding) with fresh random segments; a segment
    is a motif with probability ``overlap``, so ``overlap`` IS the tunable
    self-overlap fraction. ``overlap=0.0`` degenerates to fully-random
    prompts — the low-overlap ADVERSARIAL variant (see
    ``adversarial_token_trace``) where drafts never match and a speculative
    engine must fall back to plain decoding. ``max_new_tokens`` is uniform
    in [min_new or 1, max_new] like ``token_trace``."""
    assert 0.0 <= overlap <= 1.0
    rng = np.random.RandomState(seed)
    motifs = [rng.randint(0, vocab, motif_len).astype("int32")
              for _ in range(max(1, n_motifs))]
    lo_new = max(1, min_new) if min_new is not None else 1
    t, out = start, []
    while True:
        t += rng.exponential(1.0 / rps)
        if t >= start + horizon:
            break
        plen = int(rng.randint(max(motif_len, prompt_len // 2),
                               prompt_len + 1))
        parts, n = [], 0
        while n < plen:
            seg = motifs[rng.randint(len(motifs))] if rng.rand() < overlap \
                else rng.randint(0, vocab, motif_len).astype("int32")
            parts.append(seg)
            n += len(seg)
        prompt = np.concatenate(parts)[:plen].astype("int32")
        new = int(rng.randint(lo_new, max_new + 1))
        out.append(Request(
            task_id, t, payload=prompt, tokens=float(plen + new),
            max_new_tokens=new, slo=SLO(slo_s)))
    return out


def adversarial_token_trace(task_id: str, rps: float, horizon: float, *,
                            prompt_len: int, vocab: int, max_new: int = 16,
                            min_new: int | None = None, seed: int = 0,
                            slo_s: float | None = None,
                            start: float = 0.0) -> list[Request]:
    """Zero-self-overlap adversarial trace for the speculative plane:
    ``agentic_token_trace`` at ``overlap=0.0`` — fully random prompts with
    no recurring structure, so every draft window misses and a speculative
    engine's adaptive demotion is what stands between it and paying the
    verify overhead for nothing. The bench's regression bound (speculation
    on vs off on THIS trace) is the cost of that machinery."""
    return agentic_token_trace(
        task_id, rps, horizon, prompt_len=prompt_len, vocab=vocab,
        overlap=0.0, max_new=max_new, min_new=min_new, seed=seed,
        slo_s=slo_s, start=start)


def feature_trace(task_id: str, rps: float, horizon: float, *, input_len: int,
                  d_model: int, seed: int = 0, slo_s: float | None = None,
                  start: float = 0.0) -> list[Request]:
    """Pooled-feature Poisson trace: each request carries a random
    ``(input_len, d_model)`` feature payload for the shared-forward path
    (distinct rows, so executor head probing can discriminate batched from
    reducing heads). Combine with ``token_trace`` via ``merge`` for the
    mixed pooled + generative workloads the event-loop plane serves."""
    rng = np.random.RandomState(seed)
    t, out = start, []
    while True:
        t += rng.exponential(1.0 / rps)
        if t >= start + horizon:
            break
        out.append(Request(
            task_id, t,
            payload=rng.randn(input_len, d_model).astype("float32"),
            slo=SLO(slo_s)))
    return out


def burst_trace(task_id: str, base_rps: float, burst_rps: float,
                burst_start: float, burst_len: float, horizon: float,
                *, seed: int = 0, slo_s: float | None = None) -> list[Request]:
    """Steady -> spike -> steady (noisy-neighbor pattern, paper Fig. 13)."""
    a = poisson_trace(task_id, base_rps, burst_start, seed=seed, slo_s=slo_s)
    b = poisson_trace(task_id, burst_rps, burst_len, seed=seed + 1,
                      slo_s=slo_s, start=burst_start)
    c = poisson_trace(task_id, base_rps, horizon - burst_start - burst_len,
                      seed=seed + 2, slo_s=slo_s, start=burst_start + burst_len)
    return a + b + c


# Azure-Functions-like load bands, requests-per-MINUTE (paper §7.1.3)
LOAD_BANDS = {"low": (6, 60), "moderate": (60, 600), "high": (600, 1800)}


def azure_like_tasks(n_tasks: int, band: str, horizon: float, *, seed: int = 0,
                     slo_s: float | None = None):
    """Sample per-task mean rates log-uniformly within the band; each task is
    bursty: on/off periods with 3x rate multiplier when 'hot'."""
    lo, hi = LOAD_BANDS[band]
    rng = np.random.RandomState(seed)
    traces = {}
    for i in range(n_tasks):
        tid = f"task{i}"
        rpm = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        rps = rpm / 60.0
        reqs, t = [], 0.0
        hot = rng.rand() < 0.3
        while t < horizon:
            period = rng.exponential(20.0)
            rate = rps * (3.0 if hot else 0.7)
            reqs += poisson_trace(tid, max(rate, 1e-3), min(period, horizon - t),
                                  seed=rng.randint(1 << 30), slo_s=slo_s, start=t)
            t += period
            hot = not hot
        traces[tid] = sorted(reqs, key=lambda r: r.arrival)
    return traces


def merge(traces) -> list[Request]:
    out = [r for t in traces for r in (t if isinstance(t, list) else traces[t])]
    return sorted(out, key=lambda r: r.arrival)

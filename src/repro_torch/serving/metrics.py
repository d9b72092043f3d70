"""Latency / throughput / fairness metrics (paper §7.1.4)."""
from __future__ import annotations

import numpy as np


def percentile(xs, p):
    if not len(xs):
        return float("nan")
    return float(np.percentile(np.asarray(xs, float), p))


def latency_stats(requests) -> dict:
    lats = [r.latency for r in requests if r.latency is not None]
    if not lats:
        return {"n": 0}
    return {
        "n": len(lats),
        "mean_ms": 1e3 * float(np.mean(lats)),
        "p50_ms": 1e3 * percentile(lats, 50),
        "p99_ms": 1e3 * percentile(lats, 99),
        "max_ms": 1e3 * float(np.max(lats)),
    }


def speculation_stats(engine) -> dict:
    """Speculative-decoding gauges of a ``DecodeEngine``: draft volume,
    accept rate, committed tokens per dispatch (the multi-token-step payoff)
    and the adaptive plane's demotion count, plus cumulative per-task accept
    rates — the signal for spotting a co-batched task whose output never
    matches its own history (it decodes fine, it just never speculates
    usefully)."""
    proposed = int(getattr(engine, "draft_proposed", 0))
    accepted = int(getattr(engine, "draft_accepted", 0))
    disp = int(getattr(engine, "spec_dispatches", 0))
    out = {
        "spec_k": int(getattr(engine, "spec_k", 0)),
        "draft_proposed": proposed,
        "draft_accepted": accepted,
        "accept_rate": round(accepted / proposed, 4) if proposed else 0.0,
        "spec_dispatches": disp,
        "spec_fallbacks": int(getattr(engine, "spec_fallbacks", 0)),
        "tokens_per_dispatch": round(
            int(getattr(engine, "spec_commits", 0)) / disp, 3)
        if disp else 0.0,
    }
    rates = getattr(engine, "spec_task_accept_rates", None)
    if callable(rates):
        out["task_accept_rates"] = {t: round(v, 4)
                                    for t, v in sorted(rates().items())}
    return out


def decode_stats(requests, *, engine=None) -> dict:
    """Token-level serving metrics for generative (prefill+decode) requests:
    TTFT (arrival -> first generated token), TPOT (per-token decode interval
    after the first token), and aggregate generated-token throughput.
    Latency/throughput aggregates cover SUCCESSFUL requests only — a shed or
    quarantined stream's zero-token "completion" would otherwise deflate
    TTFT and inflate throughput; failed terminations are counted separately
    (``n_failed``) and goodput (tokens of requests that finished ok WITHIN
    their deadline, per second) reports what the SLO-carrying client actually
    received. ``engine`` (a speculative ``DecodeEngine``) adds the
    ``speculation`` section (``speculation_stats``)."""
    done = [r for r in requests
            if r.finish_time is not None and r.max_new_tokens > 0]
    ok = [r for r in done if getattr(r, "status", "ok") == "ok"]
    spec = speculation_stats(engine) \
        if engine is not None and getattr(engine, "spec_k", 0) > 0 else None
    if not ok:
        out = {"n": 0, "n_failed": len(done)}
        if spec is not None:
            out["speculation"] = spec
        return out
    ttft = [r.first_token_time - r.arrival for r in ok
            if r.first_token_time is not None]
    tpot = []
    total_tokens = 0
    good_tokens = 0
    for r in ok:
        n = len(r.result) if r.result is not None else r.max_new_tokens
        total_tokens += n
        if r.met_deadline():
            good_tokens += n
        if r.first_token_time is not None and n > 1:
            tpot.append((r.finish_time - r.first_token_time) / (n - 1))
    span = (max(r.finish_time for r in ok)
            - min(r.arrival for r in ok)) or 1e-9
    out = {
        "n": len(ok),
        "n_failed": len(done) - len(ok),
        "tokens_out": total_tokens,
        "tokens_per_s": total_tokens / span,
        "goodput_tokens_per_s": good_tokens / span,
        "ttft_p50_ms": 1e3 * percentile(ttft, 50),
        "ttft_p99_ms": 1e3 * percentile(ttft, 99),
        "tpot_p50_ms": 1e3 * percentile(tpot, 50),
        "tpot_p99_ms": 1e3 * percentile(tpot, 99),
    }
    if spec is not None:
        out["speculation"] = spec
    return out


def page_gauges(engine) -> dict:
    """Free/used KV-page gauges of a paged decode pool (zeros for dense) —
    the numbers an operator watches to size ``total_pages``: free and used
    counts, deferred/preempted admissions, current occupancy, and the
    prefix-sharing dedup state (physical pages mapped by several streams,
    pages saved right now, logical mappings, cumulative prefix hits)."""
    out = {
        "paged": bool(getattr(engine, "paged", False)),
        "free_pages": engine.free_page_count(),
        "used_pages": engine.used_page_count(),
        "total_pages": getattr(engine, "total_pages", 0),
        "occupancy": round(engine.page_occupancy(), 4),
        "deferrals": getattr(engine, "deferrals", 0),
        "preemptions": getattr(engine, "preemptions", 0),
        "shared_pages": engine.shared_page_count(),
        "dedup_saved_pages": engine.dedup_saved_pages(),
        "logical_pages": engine.logical_page_count(),
        "prefix_hits": getattr(engine, "prefix_hits", 0),
        # chunked shared-prefix prefill: prompt tokens the engine actually
        # prefilled vs tokens it skipped by mapping already-resident pages
        "tail_tokens_computed": getattr(engine, "tail_tokens_computed", 0),
        "prefill_tokens_saved": getattr(engine, "prefill_tokens_saved", 0),
        "hol_bypasses": getattr(engine, "hol_bypasses", 0),
        "scale_refreshes": getattr(engine, "scale_refreshes", 0),
        "spilled_pages": getattr(engine, "spilled_pages", 0),
        "restored_pages": getattr(engine, "restored_pages", 0),
        "spill_bytes_in_use": getattr(
            getattr(engine, "spill", None), "bytes_in_use", 0),
        "spill_entries": len(getattr(engine, "spill", None) or ()),
    }
    sp = getattr(engine, "state_pool", None)
    if sp is not None:
        # hybrid / enc-dec stacks: fixed-size state-slot occupancy beside
        # the page gauges (in use, peak, deferrals on slot pressure)
        out.update(sp.gauges())
    return out


def failure_counters(requests=(), *, loop=None, engine=None,
                     executor=None) -> dict:
    """Failure-plane counters: terminal statuses tallied over ``requests``
    plus the serving components' own tallies — the loop's watchdog trips and
    wedge recoveries, the engine's quarantine/deadline/cancel counts, the
    executor's head failures and retry attempts. Everything here is a count
    of a FAULT HANDLED gracefully; a crash would have produced none of them."""
    from repro_torch.core.request import FAILURE_STATUSES
    out = {s: 0 for s in FAILURE_STATUSES}
    for r in requests:
        s = getattr(r, "status", "ok")
        if s != "ok":
            out[s] = out.get(s, 0) + 1
    if loop is not None:
        out["watchdog_trips"] = int(loop.failures.get("watchdog_trips", 0))
        out["wedge_recoveries"] = int(
            loop.failures.get("wedge_recoveries", 0))
        out["resets_survived"] = int(
            loop.failures.get("resets_survived", 0))
    if engine is not None:
        out["engine_quarantines"] = int(getattr(engine, "quarantines", 0))
        out["engine_deadline_cancels"] = int(
            getattr(engine, "deadline_cancels", 0))
        out["engine_deadline_sheds"] = int(
            getattr(engine, "deadline_sheds", 0))
        out["engine_stranded_rejections"] = int(
            getattr(engine, "stranded_rejections", 0))
        out["engine_cancels"] = int(getattr(engine, "cancels", 0))
        # durability plane: host-spill traffic and the digest-verification
        # contract's violation count (corrupted spill/snapshot pages dropped)
        out["spilled_pages"] = int(getattr(engine, "spilled_pages", 0))
        out["restored_pages"] = int(getattr(engine, "restored_pages", 0))
        out["digest_failures"] = int(getattr(engine, "digest_failures", 0))
        out["spill_resumes"] = int(getattr(engine, "spill_resumes", 0))
        out["deadline_clamps"] = int(getattr(engine, "deadline_clamps", 0))
        # speculative plane: dispatches demoted to the plain decode fn by
        # the accept-rate EMA (speculation disabled, not a fault per se —
        # but a run that is ALL fallbacks is a misconfigured spec_k)
        out["spec_fallbacks"] = int(getattr(engine, "spec_fallbacks", 0))
    if executor is not None:
        out["head_failures"] = int(
            sum(getattr(executor, "head_failures", {}).values()))
        out["head_retries"] = int(getattr(executor, "retries", 0))
    return out


def mixed_stats(requests, page_samples=None, shared_samples=None,
                failures=None, ttft_split=None, engine=None) -> dict:
    """Split per-plane report for mixed pooled + generative serving (the
    event-loop plane): request-level latency for the pooled side, token-level
    TTFT/TPOT/throughput for the generative side. ``page_samples`` (the
    per-decode-tick KV-page occupancy fractions a ``ServeLoop`` collects on a
    paged pool) adds an occupancy p50/p95/max section — how full the arena
    actually ran, the signal for sizing ``total_pages``. ``shared_samples``
    (per-decode-tick dedup fractions: pages saved by prefix sharing over
    logical page mappings) adds a sharing section — how much effective
    capacity COW prefix sharing is buying on this workload. ``failures`` (a
    ``failure_counters`` dict) adds the failure-plane section.
    ``ttft_split`` ({"hit": [...], "miss": [...]} TTFT seconds, the
    ``ServeLoop.ttft_hit_samples``/``ttft_miss_samples`` series) adds a
    prefix-hit vs miss TTFT section — what chunked shared-prefix prefill is
    buying sharer joins on this workload."""
    pooled = [r for r in requests if r.max_new_tokens <= 0]
    gen = [r for r in requests if r.max_new_tokens > 0]
    out = {"pooled": latency_stats(pooled),
           "decode": decode_stats(gen, engine=engine)}
    sp = getattr(engine, "state_pool", None) if engine is not None else None
    if sp is not None:
        out["state_slots"] = sp.gauges()
    if failures:
        out["failures"] = failures
    if ttft_split and (ttft_split.get("hit") or ttft_split.get("miss")):
        hit = ttft_split.get("hit") or []
        miss = ttft_split.get("miss") or []
        out["ttft_split"] = {
            "prefix_hit_n": len(hit),
            "prefix_miss_n": len(miss),
            "prefix_hit_p50_ms": 1e3 * percentile(hit, 50),
            "prefix_miss_p50_ms": 1e3 * percentile(miss, 50),
            "prefix_hit_p99_ms": 1e3 * percentile(hit, 99),
            "prefix_miss_p99_ms": 1e3 * percentile(miss, 99),
        }
    if page_samples:
        out["kv_pages"] = {
            "samples": len(page_samples),
            "occupancy_p50": round(percentile(page_samples, 50), 4),
            "occupancy_p95": round(percentile(page_samples, 95), 4),
            "occupancy_max": round(float(np.max(page_samples)), 4),
        }
    if shared_samples:
        out["kv_sharing"] = {
            "samples": len(shared_samples),
            "dedup_frac_p50": round(percentile(shared_samples, 50), 4),
            "dedup_frac_p95": round(percentile(shared_samples, 95), 4),
            "dedup_frac_max": round(float(np.max(shared_samples)), 4),
        }
    return out


def jain_fairness(shares: dict[str, float], weights: dict[str, float]) -> float:
    """Jain index over weight-normalized service shares (Elliott [16] style).

    1.0 = every task received service exactly proportional to its weight.
    Tasks with zero share count against fairness.
    """
    xs = np.array([shares.get(t, 0.0) / max(weights[t], 1e-12) for t in weights],
                  float)
    if xs.sum() <= 0:
        return 1.0
    n = len(xs)
    return float(xs.sum() ** 2 / (n * (xs ** 2).sum() + 1e-30))


def throughput_timeline(requests, window: float, horizon: float):
    """Per-task completions/s in consecutive windows -> {task: [rps...]}."""
    import collections
    out = collections.defaultdict(lambda: [0] * max(int(horizon / window), 1))
    for r in requests:
        if r.finish_time is None:
            continue
        w = min(int(r.finish_time / window), len(out[r.task_id]) - 1) \
            if out[r.task_id] else 0
        out[r.task_id][w] += 1
    return {t: [c / window for c in cs] for t, cs in out.items()}


def fairness_timeline(requests, weights: dict[str, float], window: float,
                      horizon: float):
    thr = throughput_timeline(requests, window, horizon)
    nwin = max(int(horizon / window), 1)
    out = []
    for w in range(nwin):
        shares = {t: (thr.get(t, [0] * nwin)[w] if w < len(thr.get(t, [])) else 0)
                  for t in weights}
        # only judge fairness when there is demand in the window
        if sum(shares.values()) > 0:
            out.append(jain_fairness(shares, weights))
    return out

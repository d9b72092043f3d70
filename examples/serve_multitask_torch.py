"""End-to-end serving demo on the PyTorch port (the twin of
``examples/serve_multitask.py``): boot a real FMplex server with one shared
backbone and several vFMs (LoRA adapters + decoder heads), replay batched
Poisson traffic through BFQ, and report latency + fairness. The backbone
runs at full width on the card by default; ``--reduced`` takes the CPU-scale
cut (what the JAX example serves) and ``--device cpu`` the plain PyTorch
versions of the kernels.

Three workload planes:

  * pooled features (default) — every request is one shared forward; per-task
    decoder heads run on-device over the pooled features;
  * generative decode (``--decode``) — requests carry prompts + token budgets
    and stream through the continuous-batching ``DecodeEngine``: admission
    prefill into a persistent int8 KV slot pool, then chunked segmented-LoRA
    greedy decode with requests joining/leaving slots between chunks. Reports
    token-level metrics (TTFT / TPOT / tokens-per-second);
  * mixed (``--mixed``) — pooled AND generative traffic through ONE event
    loop (``ServeLoop``): each tick BFQ picks the smallest-virtual-tag unit
    of work — a pooled sub-batch, a variable-length prefill admission, or a
    decode chunk — so pooled batches interleave between chunks and streams
    join the pool mid-flight. Reports both planes side by side.

``--paged`` switches the decode pool to the block-paged int8 KV layout
(pages allocated on demand, recycled at retire, memory-aware admission that
defers instead of crashing on bursts) and reports the free/used page gauges.

  PYTHONPATH=src python examples/serve_multitask_torch.py --tasks 4 --rps 40 --seconds 8
  PYTHONPATH=src python examples/serve_multitask_torch.py --decode --tasks 4 --rps 10
  PYTHONPATH=src python examples/serve_multitask_torch.py --decode --paged --tasks 4 --rps 10
  PYTHONPATH=src python examples/serve_multitask_torch.py --mixed --paged --tasks 4 --rps 30
  PYTHONPATH=src python examples/serve_multitask_torch.py --chaos --paged --tasks 4 --rps 30
  PYTHONPATH=src python examples/serve_multitask_torch.py --device cpu --reduced --seconds 1

``--chaos`` runs the mixed plane with ``serving.faults`` armed (a NaN'd
adapter, a raising head, an engine stall, infeasible deadlines) and reports
the failure-plane counters — every fault lands as a terminal request status,
never a crash.
"""
import argparse

from repro_torch.launch.serve import build_server, run_load
from repro_torch.serving.metrics import decode_stats, jain_fairness, latency_stats


def _server(args, n_tasks, **kw):
    return build_server(n_tasks, device=args.device, reduce=args.reduced,
                        **kw)


def pooled_main(args):
    out = {}
    for sched in ("bfq", "stfq", "s-be"):
        srv, cfg = _server(args, args.tasks, scheduler=sched,
                           weights=[1.0 + i for i in range(args.tasks)])
        reqs = run_load(srv, cfg, rps=args.rps, seconds=args.seconds,
                        n_tasks=args.tasks)
        done = [r for r in reqs if r.finish_time is not None]
        s = latency_stats(done)
        shares = {t: sum(1 for r in done if r.task_id == t)
                  for t in srv.vfms}
        weights = {t: srv.vfms[t].weight for t in srv.vfms}
        print(f"{sched:>5s}: served {s['n']:4d} mean={s['mean_ms']:7.1f}ms "
              f"p99={s['p99_ms']:8.1f}ms "
              f"fairness={jain_fairness(shares, weights):.3f}")
        out[sched] = s
    return out


def decode_main(args):
    """Generative serving demo on a decoder LM backbone: token-level traffic
    through the DecodeEngine, scheduled by BFQ like any other request."""
    import time

    from repro_torch.core.request import Request
    from repro_torch.serving.loadgen import merge, token_trace

    srv, cfg = _server(args, args.tasks, arch="stablelm-1.6b",
                       input_len=args.prompt_len, scheduler="bfq",
                       slo_s=None)   # cold captures inside the measured loop
    eng = srv.decode_engine("fm0", num_slots=8, prompt_len=args.prompt_len,
                            max_new=args.max_new, chunk=4,
                            **_paged_kwargs(args))
    traces = merge([token_trace(f"task{i}", args.rps / args.tasks,
                                args.seconds, prompt_len=args.prompt_len,
                                vocab=cfg.vocab_size, max_new=args.max_new,
                                seed=i) for i in range(args.tasks)])
    t0 = time.perf_counter()
    served = []
    for r in traces:
        # replay with arrivals rebased to wall clock; the synchronous loop
        # admits whatever has arrived, then serves one BFQ batch
        now = time.perf_counter()
        srv.on_arrival(Request(r.task_id, now, payload=r.payload,
                               tokens=r.tokens,
                               max_new_tokens=r.max_new_tokens), now)
        batch = srv.step("fm0")
        if batch is not None:
            served += batch.requests
    while (batch := srv.step("fm0")) is not None:
        served += batch.requests          # drain the queued tail too
    served = [r for r in served if r.finish_time is not None]
    s = decode_stats(served)
    print(f"decode: served {s['n']} requests, {s['tokens_out']} tokens "
          f"({s['tokens_per_s']:.1f} tok/s) "
          f"ttft p50={s['ttft_p50_ms']:.1f}ms p99={s['ttft_p99_ms']:.1f}ms "
          f"tpot p50={s['tpot_p50_ms']:.2f}ms")
    print(f"engine: {eng.steps} decode steps, "
          f"{eng.compile_count()} executables (flat under churn), "
          f"{srv.fms['fm0'].seg_meta_cache.builds} host-side segment sorts")
    if args.paged:
        from repro_torch.serving.metrics import page_gauges
        print(f"kv pages: {page_gauges(eng)}")
    return s


def mixed_main(args):
    """Pooled + generative colocation through one event loop: half the tasks
    send pooled feature bursts, half stream variable-length prompts with
    token budgets; BFQ interleaves both planes at token granularity."""
    from repro_torch.serving.loadgen import feature_trace, merge, token_trace
    from repro_torch.serving.metrics import mixed_stats

    srv, cfg = _server(args, args.tasks, arch="stablelm-1.6b",
                       input_len=args.prompt_len, scheduler="bfq",
                       slo_s=None)   # --chaos demos deadline enforcement
    eng = srv.decode_engine("fm0", num_slots=8, prompt_len=args.prompt_len,
                            max_new=args.max_new, chunk=4,
                            **_paged_kwargs(args))
    loop = srv.serve_loop("fm0")
    n_gen = max(1, args.tasks // 2)
    # warm the executables so the measured run reflects steady state
    loop.warmup(pooled_task=f"task{args.tasks - 1}", gen_task="task0")
    loop.ticks.clear()
    traces = [feature_trace(f"task{i}", args.rps / args.tasks, args.seconds,
                            input_len=args.prompt_len, d_model=cfg.d_model,
                            seed=i) for i in range(n_gen, args.tasks)]
    traces += [token_trace(f"task{i}", args.rps / args.tasks / 4,
                           args.seconds, prompt_len=args.prompt_len,
                           min_prompt_len=2, vocab=cfg.vocab_size,
                           max_new=args.max_new, seed=i)
               for i in range(n_gen)]
    served = loop.run(merge(traces))
    s = mixed_stats(served, page_samples=loop.page_samples,
                    shared_samples=loop.shared_samples)
    eng = srv.engines["fm0"]
    print(f"mixed: {len(served)} served, ticks={dict(loop.ticks)}")
    p, d = s["pooled"], s["decode"]
    if p.get("n"):
        print(f"  pooled: n={p['n']} p50={p['p50_ms']:.1f}ms "
              f"p99={p['p99_ms']:.1f}ms")
    if d.get("n"):
        print(f"  decode: n={d['n']} {d['tokens_out']} tokens "
              f"({d['tokens_per_s']:.1f} tok/s) "
              f"ttft p50={d['ttft_p50_ms']:.1f}ms "
              f"tpot p50={d['tpot_p50_ms']:.2f}ms")
    print(f"  engine: buckets={eng.prompt_buckets}, {eng.steps} decode "
          f"steps, {eng.compile_count()} executables (flat under "
          f"churn), {srv.fms['fm0'].seg_meta_cache.builds} host-side sorts")
    if args.paged:
        from repro_torch.serving.metrics import page_gauges
        kv = s.get("kv_pages", {})
        sh = s.get("kv_sharing", {})
        print(f"  kv pages: occupancy p50={kv.get('occupancy_p50')} "
              f"p95={kv.get('occupancy_p95')} dedup "
              f"p50={sh.get('dedup_frac_p50')} | {page_gauges(eng)}")
    return s


def chaos_main(args):
    """Fault-tolerant serving demo: the mixed event-loop workload with the
    chaos harness armed — one task's adapter NaN'd (its streams quarantine,
    co-batched streams unaffected), one task's head raising (only its rows
    fail), a tenth of the generative requests carrying infeasible deadlines
    (shed before they cost a prefill), and a mid-run engine stall the loop
    watchdog recovers from. Prints the failure-plane counters next to the
    usual serving stats."""
    from repro_torch.serving.faults import (ChaosEvent, ChaosInjector,
                                      NaNAdapterFault, RaisingHeadFault,
                                      StallFault)
    from repro_torch.serving.loadgen import feature_trace, merge, token_trace
    from repro_torch.serving.metrics import failure_counters, mixed_stats

    srv, cfg = _server(args, max(args.tasks, 3), arch="stablelm-1.6b",
                       input_len=args.prompt_len, scheduler="bfq",
                       slo_s=None)
    n_tasks = max(args.tasks, 3)
    eng = srv.decode_engine("fm0", num_slots=8, prompt_len=args.prompt_len,
                            max_new=args.max_new, chunk=4,
                            **_paged_kwargs(args))
    loop = srv.serve_loop("fm0", watchdog_stall_s=0.25)
    loop.warmup(pooled_task=f"task{n_tasks - 1}", gen_task="task0")
    loop.ticks.clear()
    loop.failures.clear()
    # task0 streams get the NaN'd adapter; task{n-1}'s head raises;
    # the rest is clean traffic with 10% infeasible deadlines
    traces = [token_trace(f"task{i}", args.rps / n_tasks / 4, args.seconds,
                          prompt_len=args.prompt_len, min_prompt_len=2,
                          vocab=cfg.vocab_size, max_new=args.max_new,
                          seed=i, infeasible_frac=0.1)
              for i in range(max(1, n_tasks // 2))]
    traces += [feature_trace(f"task{i}", args.rps / n_tasks, args.seconds,
                             input_len=args.prompt_len, d_model=cfg.d_model,
                             seed=i) for i in range(n_tasks // 2, n_tasks)]
    injector = ChaosInjector([
        ChaosEvent(at=0.0, fault=NaNAdapterFault("lora0")),
        ChaosEvent(at=args.seconds * 0.1,
                   fault=RaisingHeadFault(f"task{n_tasks - 1}"),
                   duration=args.seconds * 0.5),
        ChaosEvent(at=args.seconds * 0.5, fault=StallFault(),
                   duration=1.0),
    ])
    served = loop.run(merge(traces), on_tick=injector.on_tick)
    injector.restore_all(loop)
    fails = failure_counters(served, loop=loop, engine=eng,
                             executor=srv.executors["fm0"])
    s = mixed_stats(served, page_samples=loop.page_samples,
                    shared_samples=loop.shared_samples, failures=fails)
    p, d = s["pooled"], s["decode"]
    print(f"chaos: {len(served)} served, ticks={dict(loop.ticks)}")
    print(f"  chaos events: {injector.log}")
    print(f"  failures: { {k: v for k, v in fails.items() if v} }")
    if p.get("n"):
        print(f"  pooled (ok): n={p['n']} p50={p['p50_ms']:.1f}ms "
              f"p99={p['p99_ms']:.1f}ms")
    if d.get("n"):
        print(f"  decode (ok): n={d['n']} failed={d['n_failed']} "
              f"{d['tokens_out']} tokens ({d['tokens_per_s']:.1f} tok/s, "
              f"goodput {d['goodput_tokens_per_s']:.1f} tok/s)")
    print(f"  engine: {eng.steps} decode steps, {eng.compile_count()} "
          f"executables (flat under chaos)")
    return s, fails


def _paged_kwargs(args) -> dict:
    if not args.paged:
        return {}
    kw = dict(paged=True, page_size=args.page_size,
              prefix_sharing=not args.no_prefix_sharing)
    if args.total_pages:
        kw["total_pages"] = args.total_pages
    return kw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", type=int, default=4)
    ap.add_argument("--rps", type=float, default=40.0)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--decode", action="store_true",
                    help="generative serving via the DecodeEngine")
    ap.add_argument("--mixed", action="store_true",
                    help="pooled + generative traffic through one event loop")
    ap.add_argument("--chaos", action="store_true",
                    help="mixed traffic with the chaos-injection harness "
                         "armed (NaN adapter, raising head, engine stall)")
    ap.add_argument("--paged", action="store_true",
                    help="block-paged int8 KV pool (pages on demand, "
                         "memory-aware admission) instead of dense slots")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--total-pages", type=int, default=0,
                    help="KV arena size in pages (default: dense-equivalent)")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable copy-on-write prompt-prefix page sharing")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the CPU-scale cut of the config")
    args = ap.parse_args(argv)
    if args.chaos:
        return chaos_main(args)
    if args.mixed:
        return mixed_main(args)
    if args.decode:
        return decode_main(args)
    return pooled_main(args)


if __name__ == "__main__":
    main()

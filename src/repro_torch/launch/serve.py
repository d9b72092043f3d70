"""Real-plane serving driver: FMplex end to end on one backbone.

Boots one FMplexServer with a shared backbone, binds N tasks (each with its
own decoder head + LoRA adapter), replays a Poisson workload through BFQ, and
prints the profile, per-request latency and fairness. The backbone runs at
full width on the GPU by default; ``--reduced`` takes the CPU-scale cut
(what the JAX package's launcher always serves) and ``--device cpu`` the
plain PyTorch versions of the kernels.

  PYTHONPATH=src python -m repro_torch.launch.serve --tasks 4 --rps 40 --seconds 5
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --reduced --seconds 1
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.physical import PhysicalFM
from repro_torch.core.request import SLO, Request
from repro_torch.core.server import FMplexServer
from repro_torch.core.vfm import TaskExtensions
from repro_torch.serving.metrics import jain_fairness, latency_stats


def build_server(n_tasks: int, *, arch: str = "moment-large", seed: int = 0,
                 scheduler: str = "bfq", input_len: int = 32,
                 weights=None, slo_s: Optional[float] = 1.0,
                 device="cuda", reduce: bool = False):
    """One server, one FM ``fm0`` (``reduce``: the CPU-scale cut of
    ``arch``) and ``n_tasks`` tasks ``task{i}``, each with a linear head
    (d -> 4, on the FM's device) and a fresh adapter; the profile is
    calibrated by wall clock at batch sizes 1, 2, 4, 8."""
    cfg = get_config(arch)
    if reduce:
        cfg = reduced(cfg)
    fm = PhysicalFM(cfg, seed=seed, input_len=input_len, lora_rank=4,
                    device=device)
    fm.calibrate(sizes=(1, 2, 4, 8))
    srv = FMplexServer("s0")
    srv.deploy_fm("fm0", fm, scheduler=scheduler)
    rng = np.random.RandomState(seed)
    for i in range(n_tasks):
        w_dec = torch.as_tensor(rng.randn(cfg.d_model, 4).astype(np.float32)
                                * 0.1, device=fm.device)
        # takes the device rows or one host row alike
        head = (lambda w: (lambda feats: torch.as_tensor(
            feats, device=w.device).float() @ w))(w_dec)
        fm.adapters.new(f"lora{i}", seed=i)
        ext = TaskExtensions(decoder=head, adapter_id=f"lora{i}",
                             adapter_weights=None)
        w = weights[i] if weights else 1.0
        # slo_s=None binds tasks without deadlines: the serving plane
        # ENFORCES task SLOs (shedding/cancelling infeasible work)
        srv.bind_task(f"task{i}", "fm0", weight=w,
                      slo=SLO(slo_s), extensions=ext)
    return srv, cfg


def run_load(srv: FMplexServer, cfg, *, rps: float, seconds: float,
             n_tasks: int, seed: int = 0):
    """Poisson arrivals at ``rps`` for ``seconds``, each a random payload of
    ``input_len`` patch embeddings for a random task, served by
    ``srv.step`` between arrivals; then drain. Returns the requests.

    Open loop: every arrival due by now is submitted before the next step,
    stamped with its scheduled time, so a step slower than the gap between
    arrivals queues them (and they co-batch) instead of slowing the
    arrivals down. (The JAX package's loop submits one arrival per step,
    which caps the offered load at one request per forward.)"""
    rng = np.random.RandomState(seed)
    t_end = time.perf_counter() + seconds
    all_reqs = []
    next_arrival = time.perf_counter()
    while time.perf_counter() < t_end:
        now = time.perf_counter()
        while now >= next_arrival and next_arrival < t_end:
            tid = f"task{rng.randint(n_tasks)}"
            x = rng.randn(srv.fms["fm0"].input_len,
                          cfg.d_model).astype(np.float32)
            r = Request(tid, next_arrival, payload=x)
            srv.on_arrival(r, now)
            all_reqs.append(r)
            next_arrival += rng.exponential(1.0 / rps)
        batch = srv.step("fm0")
        if batch is None:
            time.sleep(0.0005)
    while srv.step("fm0") is not None:       # drain
        pass
    return all_reqs


def summary(srv: FMplexServer, reqs, n_tasks: int) -> dict:
    """Served count, latency stats and Jain fairness of the served shares."""
    done = [r for r in reqs if r.finish_time is not None]
    stats = latency_stats(done)
    shares = {f"task{i}": sum(1 for r in done if r.task_id == f"task{i}")
              for i in range(n_tasks)}
    weights = {t: srv.vfms[t].weight for t in shares}
    return dict(stats, total=len(reqs),
                fairness=jain_fairness(shares, weights))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", type=int, default=4)
    ap.add_argument("--rps", type=float, default=40.0)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--scheduler", default="bfq", choices=("bfq", "stfq", "s-be"))
    ap.add_argument("--arch", default="moment-large")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the CPU-scale cut of the config")
    args = ap.parse_args(argv)

    srv, cfg = build_server(args.tasks, arch=args.arch,
                            scheduler=args.scheduler, device=args.device,
                            reduce=args.reduced)
    prof = srv.profiles["fm0"]
    print(f"backbone={cfg.name} layers={cfg.num_layers} d={cfg.d_model} "
          f"device={srv.fms['fm0'].device} l(1)={prof.l(1)*1e3:.1f}ms "
          f"l({prof.b_max})={prof.l(prof.b_max)*1e3:.1f}ms b_max={prof.b_max}")
    reqs = run_load(srv, cfg, rps=args.rps, seconds=args.seconds,
                    n_tasks=args.tasks)
    s = summary(srv, reqs, args.tasks)
    nan = float("nan")
    print(f"served {s['n']}/{s['total']} mean={s.get('mean_ms', nan):.1f}ms "
          f"p99={s.get('p99_ms', nan):.1f}ms fairness={s['fairness']:.3f}")
    return s


if __name__ == "__main__":
    main()

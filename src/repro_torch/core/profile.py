"""Per-backbone performance profiles (§6 Monitoring & Profiling).

FM-level estimates (memory, load time, service time as a function of batch
size) are computed once per backbone and reused by every task bound to it;
task extensions add only a small per-sub-batch term. The service-time model is
``l(b) = alpha + beta·b`` — a fixed launch overhead plus a per-request slope —
which matches accelerator batching curves up to the throughput knee ``b_max``
(beyond which FMplex stops extending batches; see paper Fig. 1).

Profiles are calibrated from real measurements (``profile_backbone``) on the
real-execution plane, or taken from Table-3-style constants for simulation.
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class FMProfile:
    name: str
    alpha: float = 2e-3            # fixed per-batch overhead (s)
    beta: float = 1e-3             # per-request slope (s)
    b_max: int = 16                # throughput knee
    memory_bytes: int = 0          # backbone weights residency
    load_time_s: float = 1.0       # cold-load + warmup
    adapter_alpha: float = 2e-4    # per-sub-batch adapter switch cost (s)
    adapter_beta: float = 1e-4     # per-request adapter compute slope (s)
    task_memory_bytes: int = 0     # typical per-task extension residency
    task_load_s: float = 0.02      # per-task extension load
    # per-deployed-instance runtime overhead (context, workspace, allocator)
    instance_overhead_bytes: int = 300 << 20

    def l(self, b: int) -> float:
        """Backbone service time for a batch of size b."""
        return self.alpha + self.beta * max(b, 0) if b > 0 else 0.0

    def exec_time(self, total: int, adapter_sizes: list[int]) -> float:
        """Backbone pass over the co-batch + sequential adapter sub-batches."""
        t = self.l(total)
        for bs in adapter_sizes:
            t += self.adapter_alpha + self.adapter_beta * bs
        return t

    def effective_per_request(self, b: int) -> float:
        """l_i(b): amortized per-request service time in a size-b co-batch."""
        return self.l(b) / max(b, 1)


def profile_backbone(run_batch, sizes=(1, 2, 4, 8, 16), name="fm",
                     warmup: int = 1) -> FMProfile:
    """Calibrate alpha/beta/b_max by timing ``run_batch(b)`` on real hardware.

    Least-squares fit of l(b) = alpha + beta·b; b_max is the knee where
    marginal throughput gain per doubling drops below 10%.
    """
    xs, ys = [], []
    for b in sizes:
        for _ in range(warmup):
            run_batch(b)
        t0 = time.perf_counter()
        run_batch(b)
        ys.append(time.perf_counter() - t0)
        xs.append(b)
    n = len(xs)
    sx, sy = sum(xs), sum(ys)
    sxx = sum(x * x for x in xs)
    sxy = sum(x * y for x, y in zip(xs, ys))
    beta = (n * sxy - sx * sy) / max(n * sxx - sx * sx, 1e-12)
    alpha = max((sy - beta * sx) / n, 1e-6)
    beta = max(beta, 1e-9)
    # knee: throughput(b) = b / l(b); find where gain per doubling < 10%
    b_max = sizes[-1]
    for lo, hi in zip(sizes, sizes[1:]):
        thr_lo = lo / (alpha + beta * lo)
        thr_hi = hi / (alpha + beta * hi)
        if thr_hi / thr_lo < 1.10:
            b_max = hi
            break
    return FMProfile(name=name, alpha=alpha, beta=beta, b_max=b_max)

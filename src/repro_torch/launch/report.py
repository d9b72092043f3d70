"""Markdown tables from the port's dry-run JSONL.

Roofline fraction per cell: T_ideal / T_bound, where
  T_bound = max(compute_s, memory_s, collective_s)   (modeled step time)
  T_ideal = max(MODEL_FLOPS/(chips·peak), MIN_BYTES/(chips·HBM_bw))
MIN_BYTES is the unavoidable per-step HBM traffic: weights read once
(+ KV/state cache read once for serve steps). For train cells compute
dominates T_ideal; for decode cells the bytes term does. The peak and the
HBM rate are the H100 SXM's (``launch.optrace``).
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch.optrace import HBM_BW, PEAK_FLOPS
from repro_torch.models import lm
from repro_torch.models.common import param_count


def min_bytes(arch: str, shape_name: str) -> float:
    """Unavoidable global HBM bytes per step (weights once + cache once)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n_params = param_count(lm.model_spec(cfg))
    if shape.kind == "train":
        # fp32 params read + grads written + bf16 compute copies (approx)
        return n_params * (4 + 4 + 2)
    w = n_params * 2                                    # bf16 weights
    if shape.kind == "decode":
        cache = param_count(lm.cache_spec(cfg, shape.global_batch,
                                          shape.seq_len)) * 2
        return w + cache
    return w


def fraction(rec: dict) -> float:
    t = rec["roofline"]
    t_bound = max(v for k, v in t.items()
                  if k.endswith("_s") and isinstance(v, float))
    chips = rec["chips"]
    t_ideal = max(rec["model_flops_global"] / (chips * PEAK_FLOPS),
                  min_bytes(rec["arch"], rec["shape"]) / (chips * HBM_BW))
    return min(t_ideal / t_bound, 1.0) if t_bound > 0 else 0.0


def load(jsonl: str, mesh: str = "pod1") -> dict:
    out = {}
    for line in Path(jsonl).read_text().splitlines():
        r = json.loads(line)
        if r.get("status") == "ok" and r.get("mesh") == mesh:
            out[(r["arch"], r["shape"])] = r
    return out


def md_table(jsonl: str, mesh: str = "pod1") -> str:
    rows = load(jsonl, mesh)
    lines = ["| arch | shape | compute_s | memory_s | collective_s | bottleneck"
             " | MODEL/traced flops | roofline frac | arg+temp GB/GPU |",
             "|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape), r in sorted(rows.items()):
        t = r["roofline"]
        m = r.get("memory", {})
        gb = (m.get("argument_size_in_bytes", 0)
              + m.get("temp_size_in_bytes", 0)) / 1e9
        lines.append(
            f"| {arch} | {shape} | {t['compute_s'] or 0:.3e} "
            f"| {t['memory_s'] or 0:.3e} "
            f"| {t['collective_s']:.3e} | {t['bottleneck'][:-2]} "
            f"| {(r.get('useful_ratio') or 0):.2f} | {fraction(r):.3f} "
            f"| {gb:.1f} |")
    return "\n".join(lines)


def skipped_table(jsonl: str) -> str:
    lines = ["| arch | shape | reason |", "|---|---|---|"]
    seen = set()
    for line in Path(jsonl).read_text().splitlines():
        r = json.loads(line)
        if r.get("status") == "skipped" and (r["arch"], r["shape"]) not in seen:
            seen.add((r["arch"], r["shape"]))
            lines.append(f"| {r['arch']} | {r['shape']} | {r['reason']} |")
    return "\n".join(lines)


def multi_pod_summary(jsonl: str) -> str:
    p1 = load(jsonl, "pod1")
    p2 = load(jsonl, "pod2")
    ok = sorted(set(p1) & set(p2))
    lines = ["| arch | shape | pod1 trace_s | pod2 trace_s | "
             "pod2 collective_s | pod-axis sharded |",
             "|---|---|---|---|---|---|"]
    for key in ok:
        a, b = p1[key], p2[key]
        lines.append(f"| {key[0]} | {key[1]} | {a['trace_s']} | "
                     f"{b['trace_s']} | {b['roofline']['collective_s']:.2e} "
                     f"| yes (512 GPUs) |")
    return "\n".join(lines)


if __name__ == "__main__":
    import sys
    jsonl = sys.argv[1] if len(sys.argv) > 1 else "results/dryrun_torch.jsonl"
    print(md_table(jsonl))

"""Multi-pod dry-run: build and trace every (arch × shape × mesh) cell.

Each cell runs one step on meta tensors, on a mesh of a ``"fake"`` process
group of 256 (``pod1``: 16 x 16 over ("data", "model")) or 512 (``pod2``:
2 x 16 x 16 over ("pod", "data", "model")) ranks started in this process
(the counterpart of the JAX package's 512 forced host devices), as rank 0,
and records what that rank runs (``launch.optrace``). Usage:

  python -m repro_torch.launch.dryrun --cell qwen2-7b:train_4k:pod1   # one cell
  python -m repro_torch.launch.dryrun --all [--resume]                # full sweep
                                                                      # (subprocess
                                                                      # per cell)

Each cell appends one record to ``results/dryrun_torch.jsonl`` (never the
JAX package's ``results/dryrun.jsonl``): the keys of the JAX package's
records, with ``trace_s`` (the traced step's wall time) in place of
``compile_s``, ``lower_s`` the cell's build time, the memory record's
``argument_size_in_bytes`` (this rank's local shards of the inputs, exact)
and ``temp_size_in_bytes`` (the peak of the meta storages the step keeps
alive at once), and ``cost_analysis_raw`` the hand-written kernels' own
work by kernel. A host-only analysis by design: it needs no GPU.
"""
import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "results"
CHIPS = {"pod1": 256, "pod2": 512}


def _fake_group(world: int):
    """Start (once) a fake process group of ``world`` ranks, as rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is up; the cell needs {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_one_cell(arch: str, shape_name: str, mesh_kind: str,
                 overrides: dict | None = None) -> dict:
    import torch.distributed as dist

    from repro_torch.configs import SHAPES, applicable, get_config
    from repro_torch.launch import flops as flops_mod
    from repro_torch.launch import optrace
    from repro_torch.launch.cells import arg_bytes, build_cell, trace_cell
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "ts": time.time()}
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec

    _fake_group(CHIPS[mesh_kind])
    mesh = make_production_mesh(multi_pod=(mesh_kind == "pod2"),
                                device_type="cpu")
    chips = dist.get_world_size()
    t0 = time.time()
    cell = build_cell(arch, shape, mesh, overrides=overrides)
    t_build = time.time() - t0
    a = trace_cell(cell)
    t_trace = time.time() - t0 - t_build
    mem = {"argument_size_in_bytes": arg_bytes(cell),
           "temp_size_in_bytes": int(a["peak_live_bytes"])}
    terms = optrace.roofline_terms(a["dot_flops"], a["hbm_traffic_bytes"],
                                   a["collective_bytes_norm"], chips,
                                   nvlink_bytes=a["collective_bytes_nvlink"])
    mf = flops_mod.model_flops(cfg, shape)
    rec.update(
        status="ok", chips=chips, lower_s=round(t_build, 1),
        trace_s=round(t_trace, 1), memory=mem,
        cost_analysis_raw=a["kernels"],
        hlo_flops_per_dev=a["dot_flops"],
        hbm_traffic_per_dev=a["hbm_traffic_bytes"],
        collective_bytes_norm=a["collective_bytes_norm"],
        collectives={**a["collective_by_kind"], "total": a["collective_bytes"],
                     "nvlink": a["collective_bytes_nvlink"]},
        collective_counts=a["collective_counts"],
        model_flops_global=mf,
        model_flops_per_dev=mf / chips,
        useful_ratio=(mf / chips) / a["dot_flops"] if a["dot_flops"] else None,
        roofline=terms, static=cell.static)
    return rec


def cell_list(mesh_kinds=("pod1", "pod2")):
    from repro_torch.configs import ASSIGNED, SHAPES
    cells = []
    for arch in ASSIGNED:
        for shape in SHAPES:
            for mk in mesh_kinds:
                cells.append((arch, shape, mk))
    return cells


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", help="arch:shape:pod1|pod2")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out", default=str(RESULTS / "dryrun_torch.jsonl"))
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--overrides", default=None,
                    help="JSON rule overrides (perf iterations)")
    args = ap.parse_args(argv)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)

    if args.cell:
        arch, shape, mk = args.cell.split(":")
        overrides = json.loads(args.overrides) if args.overrides else None
        try:
            rec = run_one_cell(arch, shape, mk, overrides)
        except Exception:
            rec = {"arch": arch, "shape": shape, "mesh": mk, "status": "error",
                   "error": traceback.format_exc()[-2000:]}
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps({k: rec[k] for k in rec if k not in ("memory", "cost")},
                         indent=None)[:600])
        sys.exit(0 if rec["status"] in ("ok", "skipped") else 1)

    if args.all:
        done = set()
        out = Path(args.out)
        if args.resume and out.exists():
            for line in out.read_text().splitlines():
                try:
                    r = json.loads(line)
                    if r.get("status") in ("ok", "skipped"):
                        done.add((r["arch"], r["shape"], r["mesh"]))
                except json.JSONDecodeError:
                    pass
        todo = [c for c in cell_list() if c not in done]
        print(f"{len(todo)} cells to run ({len(done)} already done)")
        for i, (arch, shape, mk) in enumerate(todo):
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--cell", f"{arch}:{shape}:{mk}", "--out", args.out]
            print(f"[{i+1}/{len(todo)}] {arch}:{shape}:{mk}", flush=True)
            try:
                subprocess.run(cmd, timeout=args.timeout, check=False)
            except subprocess.TimeoutExpired:
                with open(args.out, "a") as f:
                    f.write(json.dumps({"arch": arch, "shape": shape, "mesh": mk,
                                        "status": "timeout"}) + "\n")
        print("dry-run sweep complete")


if __name__ == "__main__":
    main()

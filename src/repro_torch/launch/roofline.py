"""Roofline reporting + per-cell op listing of the port's dry-run.

  python -m repro_torch.launch.roofline --table [--jsonl results/dryrun_torch.jsonl]
  python -m repro_torch.launch.roofline --detail qwen2-7b:decode_32k:pod1 \\
      [--overrides '{"act":{"seq":"model"}}']     # top collectives + products

The terms are the H100 SXM's (``launch.optrace``).
"""
import argparse
import json
from pathlib import Path

from repro_torch.launch import optrace

RESULTS = Path(__file__).resolve().parents[3] / "results"


def print_table(jsonl: str, mesh: str = "pod1"):
    rows = {}
    for line in Path(jsonl).read_text().splitlines():
        r = json.loads(line)
        if r.get("status") != "ok" or r.get("mesh") != mesh:
            continue
        rows[(r["arch"], r["shape"])] = r
    hdr = (f"{'arch':<16}{'shape':<12}{'compute_s':>11}{'memory_s':>11}"
           f"{'coll_s':>11} {'bottleneck':<12}{'MODEL/HLO':>10}"
           f"{'arg+tmp_GB':>11}")
    print(hdr)
    print("-" * len(hdr))
    for (arch, shape), r in sorted(rows.items()):
        t = r["roofline"]
        m = r.get("memory", {})
        gb = (m.get("argument_size_in_bytes", 0)
              + m.get("temp_size_in_bytes", 0)) / 1e9
        print(f"{arch:<16}{shape:<12}{t['compute_s'] or 0:>11.3e}"
              f"{t['memory_s'] or 0:>11.3e}{t['collective_s']:>11.3e} "
              f"{t['bottleneck'][:-2]:<12}{(r.get('useful_ratio') or 0):>10.2f}"
              f"{gb:>11.2f}")


class _Ranked(optrace.OpTrace):
    """An ``OpTrace`` that also keeps each collective and each product
    (the per-op listing of ``detail``)."""

    def __init__(self):
        super().__init__()
        self.colls, self.dots = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = (self.dot_flops, sum(self.coll_by_kind.values()))
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented:
            return out
        df = self.dot_flops - before[0]
        dc = sum(self.coll_by_kind.values()) - before[1]
        shape = str(tuple(getattr(out, "shape", ())))
        if df:
            self.dots.append((df, shape, func._opname))
        if dc:
            self.colls.append((dc, func._opname, shape))
        return out


def detail(cell: str, overrides=None, top: int = 12):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import SHAPES
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.dryrun import CHIPS, _fake_group
    from repro_torch.launch.mesh import make_production_mesh

    arch, shape, mk = cell.split(":")
    _fake_group(CHIPS[mk])
    mesh = make_production_mesh(multi_pod=(mk == "pod2"), device_type="cpu")
    c = build_cell(arch, SHAPES[shape], mesh, overrides=overrides)
    tr = _Ranked()
    with tr, implicit_replication():
        c.fn(*c.args)
    a = tr.analyze()
    print(json.dumps({k: v for k, v in a.items() if not isinstance(v, dict)}))
    print("kernels:", json.dumps(a["kernels"]))
    print(f"\ntop collectives (operand bytes per execution):")
    for ob, kind, rt in sorted(tr.colls, reverse=True)[:top]:
        print(f"  {ob/1e6:10.1f} MB  {kind:<24} {rt:<48}")
    print(f"\ntop products (flops per execution):")
    for f, rt, op in sorted(tr.dots, reverse=True)[:top]:
        print(f"  {f/1e9:10.2f} GF  {op:<8} {rt:<48}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--table", action="store_true")
    ap.add_argument("--jsonl", default=str(RESULTS / "dryrun_torch.jsonl"))
    ap.add_argument("--mesh", default="pod1")
    ap.add_argument("--detail", default=None)
    ap.add_argument("--overrides", default=None)
    args = ap.parse_args(argv)
    if args.table:
        print_table(args.jsonl, args.mesh)
    if args.detail:
        detail(args.detail,
               json.loads(args.overrides) if args.overrides else None)


if __name__ == "__main__":
    main()

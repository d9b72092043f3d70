#!/usr/bin/env python3
"""What a dry-run cell holds live at its peak, by storage.

    PYTHONPATH=src python3 tools/peak_live.py stablelm-1.6b:train_4k:pod2 [--top 15]

Runs one cell of ``launch.dryrun`` as the dry-run does (a fake process
group of 256 or 512 ranks, rank 0, the step once on meta tensors) under
``PeakTrace``, an ``optrace.OpTrace`` that also remembers, for every
storage the step allocates, its shape, dtype and the op that made it, and
the storages alive when the live bytes peak. Prints the peak, the largest
of those storages (bytes, shape, dtype, op, and where they sum per op) and
the record's ``temp_size_in_bytes`` for comparison. Host only.
"""
import argparse
import collections
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.launch import optrace  # noqa: E402


class PeakTrace(optrace.OpTrace):
    """``OpTrace`` that names the storages alive at its peak."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.info = {}
        self.at_peak = {}
        self._op = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._op = f"{func.namespace}.{func._opname}"
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _track(self, t):
        key = t.untyped_storage()._cdata
        fresh = key not in self._live and key not in self._inputs
        peak = self.peak_bytes
        super()._track(t)
        if fresh:
            self.info[key] = (t.untyped_storage().nbytes(), tuple(t.shape),
                              str(t.dtype).replace("torch.", ""), self._op)
        if self.peak_bytes > peak:
            self.at_peak = {k: self.info.get(k) for k in self._live}


def trace(cell_id: str):
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import SHAPES
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.dryrun import CHIPS, _fake_group
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.common import tree_leaves
    arch, shape, mk = cell_id.split(":")
    _fake_group(CHIPS[mk])
    mesh = make_production_mesh(multi_pod=(mk == "pod2"), device_type="cpu")
    cell = build_cell(arch, SHAPES[shape], mesh)
    tr = PeakTrace()
    tr.inputs(tree_leaves(list(cell.args)))
    with tr, implicit_replication():
        cell.fn(*cell.args)
    return tr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cell", help="arch:shape:pod1|pod2")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    tr = trace(args.cell)
    live = sorted((v for v in tr.at_peak.values() if v), reverse=True)
    print(f"{args.cell}: peak {tr.peak_bytes / 1e9:.2f} GB in "
          f"{len(live)} storages")
    for nb, shape, dt, op in live[:args.top]:
        print(f"  {nb / 1e9:8.3f} GB  {dt:9s} {str(shape):28s} {op}")
    by_op = collections.Counter()
    for nb, _, _, op in live:
        by_op[op] += nb
    print("  by op: " + ", ".join(f"{op} {nb / 1e9:.2f}"
                                  for op, nb in by_op.most_common(8)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Per-device cost of one step, from the port's own program: the
counterpart of the JAX package's ``launch/hlo.py``.

It reads no HLO. ``OpTrace`` is a ``TorchDispatchMode`` that watches one
step run on meta tensors (``launch.cells``: DTensors whose local shards are
meta, on a fake process group) and sees each rank's LOCAL ops: a mode sees
a DTensor op first, in its global shape, so ``OpTrace`` hands every op
that has a DTensor operand back to DTensor (``NotImplemented``) and counts
only the plain ops DTensor then runs on the local shards, and the
collectives it issues; the global-shape ops that DTensor's sharding
propagation runs on fake tensors are skipped. A Python loop is unrolled by
the trace, so a body that runs n times is counted n times, except a
recurrent scan (``models.scan.scan_chunks``): while a trace is active it
runs one chunk for all but the first and counts that chunk's forward,
recompute and backward under ``repeat(n - 1)``, as ``hlo.py`` multiplies a
``while`` body by its trip count (``OpTrace(once_a_chunk=False)`` unrolls
every chunk instead). It accumulates:

  * dot FLOPs        - 2 · prod(result dims) · prod(contracting dims) of
                       every ``mm``, ``bmm``, ``addmm`` and ``baddbmm``
                       (``matmul``, ``einsum`` and ``linear`` reach the
                       dispatcher as these), plus each hand-written
                       kernel's own FLOPs (``kernels.ops`` reports them for
                       meta tensors, with the formulas of the bounds
                       ``chip_smoke.py`` times each kernel against)
  * collective bytes - operand bytes of every ``_c10d_functional``
                       collective (DTensor's redistributes issue these), by
                       kind, and whether its group stays inside one 8-GPU
                       node (NVLink) or crosses nodes (the network)
  * HBM traffic      - the JAX package's model: Σ dot (lhs + rhs + result
                       bytes) + each kernel's bytes + 2 × collective bytes
  * live bytes       - the peak over the step of the meta storages that
                       the step allocated (the dry-run's temp size; the
                       inputs' storages, given to ``inputs``, and views of
                       them are not counted)

All quantities are per device. The roofline constants are the H100 SXM's.
"""
from __future__ import annotations

import contextlib
import math
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# H100 SXM5 80GB, NVIDIA H100 Tensor Core GPU data sheet: 989 TFLOP/s dense
# bf16 on the tensor cores, 3.35 TB/s HBM3 (the figures chip_smoke.py bounds
# each kernel with)
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
# fourth-generation NVLink, 900 GB/s a GPU both ways (same data sheet): a
# collective whose group lies inside one 8-GPU HGX node
NVLINK_BW = 450e9
# one ConnectX-7 NDR InfiniBand port a GPU, 400 Gb/s (DGX H100 user guide):
# a collective whose group spans nodes
NETWORK_BW = 50e9
NODE_GPUS = 8

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
_KIND = {"all_gather_into_tensor": "all-gather", "all_gather": "all-gather",
         "all_reduce": "all-reduce", "reduce_scatter_tensor": "reduce-scatter",
         "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
         "permute_tensor": "collective-permute"}
_DOTS = ("mm", "bmm", "addmm", "baddbmm")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _dot(name: str, args) -> tuple[float, float]:
    """(flops, operand + result bytes) of a matrix product."""
    a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") else \
        (args[0], args[1])
    *batch, m, kk = a.shape
    n = b.shape[-1]
    nb = math.prod(batch) if batch else 1
    out = nb * m * n * a.element_size()
    return 2.0 * nb * m * n * kk, float(_nbytes(a) + _nbytes(b) + out)


def _group_ranks(name) -> Optional[list]:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    try:
        return dist.get_process_group_ranks(_resolve_process_group(name))
    except (RuntimeError, ValueError, KeyError):
        return None


class OpTrace(TorchDispatchMode):
    """Counts what one rank runs while it is active (see the module
    docstring). ``analyze()`` gives the record."""

    def __init__(self, once_a_chunk: bool = True):
        super().__init__()
        self.once_a_chunk = once_a_chunk
        self._mult = 1
        self.dot_flops = 0.0
        self.dot_bytes = 0.0
        self.kernels: dict = {}
        self.coll_by_kind = {k: 0.0 for k in COLLECTIVES}
        self.coll_counts = {k: 0 for k in COLLECTIVES}
        self.coll_nvlink = 0.0
        self._groups: dict = {}
        self._live: dict = {}
        self._inputs: set = set()
        self.live_bytes = 0
        self.peak_bytes = 0

    # ---- hooks ----
    def inputs(self, tensors):
        """Storages the step is given (its arguments' local shards): views
        of them are not the step's allocations."""
        for t in tensors:
            loc = t.to_local() if hasattr(t, "to_local") else t
            self._inputs.add(loc.untyped_storage()._cdata)

    def kernel(self, name: str, flops: float, nbytes: float):
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += self._mult
        k["flops"] += self._mult * flops
        k["bytes"] += self._mult * nbytes

    @contextlib.contextmanager
    def repeat(self, k: int):
        """Count what runs inside as if it ran ``k`` times (live bytes
        excepted: the copies would not be alive at once)."""
        prev, self._mult = self._mult, self._mult * k
        try:
            yield
        finally:
            self._mult = prev

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.models import scan
        self._prev_sink, self._prev_scan = ops.META_WORK, scan.TRACE
        ops.META_WORK = self.kernel
        scan.TRACE = self
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        from repro_torch.models import scan
        ops.META_WORK = self._prev_sink
        scan.TRACE = self._prev_scan
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        flat = torch.utils._pytree.tree_leaves((args, kwargs, out))
        if any(isinstance(a, FakeTensor) for a in flat):
            return out                  # DTensor's global-shape propagation
        ns = func.namespace
        name = func._opname
        if ns == "aten" and name in _DOTS:
            f, b = _dot(name, args)
            self.dot_flops += self._mult * f
            self.dot_bytes += self._mult * b
        elif ns == "_c10d_functional" and name in _KIND:
            kind = _KIND[name]
            nb = float(sum(_nbytes(a) for a in torch.utils._pytree.tree_leaves(
                args) if isinstance(a, torch.Tensor)))
            self.coll_by_kind[kind] += self._mult * nb
            self.coll_counts[kind] += self._mult
            if self._in_node(args[-1]):
                self.coll_nvlink += self._mult * nb
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._track(t)
        return out

    def _in_node(self, group_name) -> bool:
        if group_name not in self._groups:
            ranks = _group_ranks(group_name)
            self._groups[group_name] = ranks is not None and len(
                {r // NODE_GPUS for r in ranks}) == 1
        return self._groups[group_name]

    def _track(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or key in self._inputs:
            return
        nb = st.nbytes()
        self._live[key] = nb
        self.live_bytes += nb
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

        def gone(key=key):
            self.live_bytes -= self._live.pop(key, 0)
        weakref.finalize(st, gone)       # storages keep their PyObject

    # ---- record ----
    def analyze(self) -> dict:
        kf = sum(k["flops"] for k in self.kernels.values())
        kb = sum(k["bytes"] for k in self.kernels.values())
        coll = sum(self.coll_by_kind.values())
        return {
            "dot_flops": self.dot_flops + kf,
            "matmul_flops": self.dot_flops,
            "kernel_flops": kf,
            "kernels": {n: dict(v) for n, v in sorted(self.kernels.items())},
            "collective_bytes": coll,
            # the JAX package halves the f32 operands XLA:CPU promotes; the
            # port's collectives run in their own dtypes: nothing to fix
            "collective_bytes_norm": coll,
            "collective_bytes_nvlink": self.coll_nvlink,
            "collective_by_kind": dict(self.coll_by_kind),
            "collective_counts": dict(self.coll_counts),
            "dot_traffic_bytes": self.dot_bytes + kb,
            "hbm_traffic_bytes": self.dot_bytes + kb + 2 * coll,
            "peak_live_bytes": self.peak_bytes,
        }


def roofline_terms(flops: Optional[float], bytes_accessed: Optional[float],
                   coll_bytes_per_dev: float, chips: int,
                   nvlink_bytes: float = 0.0) -> dict:
    """All three terms in seconds, from PER-DEVICE inputs: the collective
    bytes over the network's rate, but ``nvlink_bytes`` of them (groups
    inside one node) over NVLink's."""
    out = {}
    out["compute_s"] = (flops / PEAK_FLOPS) if flops else None
    out["memory_s"] = (bytes_accessed / HBM_BW) if bytes_accessed else None
    out["collective_s"] = ((coll_bytes_per_dev - nvlink_bytes) / NETWORK_BW
                           + nvlink_bytes / NVLINK_BW)
    terms = {k: v for k, v in out.items() if v}
    out["bottleneck"] = max(terms, key=terms.get) if terms else None
    return out

"""The port's dry-run on the CPU: ``python -m repro_torch.launch.dryrun``
on a 256-rank fake process group, ``launch.optrace``'s per-device counts,
the kernels' meta paths (``kernels.ops`` on meta tensors) and the
roofline/report tables over the records.

Tolerances: none. The counts are exact integers (FLOPs of products on
integer shapes, operand bytes, visible (query, key) pairs), ``model_flops``
is the same arithmetic in both packages, and the dry-run's fit check is
against the H100's 80 GB of memory.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import optrace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
H100_BYTES = 80e9


def _dryrun(cell, out):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--cell", cell,
         "--out", str(out)], capture_output=True, text=True, timeout=600,
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    return recs[-1]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "dryrun_torch.jsonl"
    return out, {c: _dryrun(c, out) for c in (
        "xlstm-125m:decode_32k:pod1", "qwen2-7b:prefill_32k:pod1",
        "whisper-base:long_500k:pod1")}


def test_train_cell_peak_halves_on_two_pods(tmp_path):
    """whisper-base's train_4k cell on 256 (pod1) and 512 (pod2) fake
    ranks: the doubled mesh halves each rank's rows, so its peak live bytes
    must not grow (the JAX package's halves: 11.39 -> 5.71 GB). The
    cross-entropy gathered the vocab on every rank (DTensor's
    ``logsumexp``), and on pod2 the backward cut a replicated gradient
    through the nested ("pod", "data") row split one mesh dimension at a
    time, through a copy of half the global logits: 2.81 -> 7.49 GB."""
    runs = {}
    for mk in ("pod1", "pod2"):               # the two traces side by side
        out = tmp_path / f"{mk}.jsonl"
        runs[mk] = out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--cell",
             f"whisper-base:train_4k:{mk}", "--out", str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    recs = {}
    for mk, (out, proc) in runs.items():
        log = proc.communicate(timeout=600)[0]
        assert proc.returncode == 0, log[-3000:]
        recs[mk] = json.loads(out.read_text().splitlines()[-1])
    pod1, pod2 = recs["pod1"], recs["pod2"]
    assert pod1["status"] == pod2["status"] == "ok"
    t1 = pod1["memory"]["temp_size_in_bytes"]
    t2 = pod2["memory"]["temp_size_in_bytes"]
    assert 0 < t2 <= t1, (t1, t2)


def test_peak_trace_names_the_storages_at_the_peak():
    """``tools/peak_live.py``'s ``PeakTrace``: the storages alive when the
    live bytes peak, with their shapes, dtypes and the ops that made
    them; a storage freed before the peak is not among them."""
    sys.path.insert(0, str(ROOT / "tools"))
    from peak_live import PeakTrace
    tr = PeakTrace()
    x = torch.empty((64, 64), device="meta")
    tr.inputs([x])
    with tr:
        a = x.float() @ x                       # 16 KiB, freed below
        del a
        b = torch.cat([x, x])                   # 32 KiB
        c = b.to(torch.bfloat16)                # 16 KiB: the peak, 48 KiB
        del c
        d = torch.ones(8, device="meta")
    assert tr.peak_bytes == 64 * 64 * 4 * 2 + 64 * 64 * 2 * 2
    live = sorted(v for v in tr.at_peak.values() if v)
    assert live == [(16384, (128, 64), "bfloat16", "aten._to_copy"),
                    (32768, (128, 64), "float32", "aten.cat")]
    del b, d


def test_xlstm_decode_cell_on_256_fake_ranks(records):
    """The cell of the acceptance list: status ok on 256 ranks, a
    bottleneck named, every term finite, and the local inputs plus the
    step's peak live bytes within one H100's 80 GB."""
    _, recs = records
    r = recs["xlstm-125m:decode_32k:pod1"]
    assert r["status"] == "ok" and r["chips"] == 256
    assert r["roofline"]["bottleneck"] in ("compute_s", "memory_s",
                                           "collective_s")
    assert r["memory"]["temp_size_in_bytes"] < H100_BYTES
    assert r["memory"]["argument_size_in_bytes"] + \
        r["memory"]["temp_size_in_bytes"] < H100_BYTES
    assert r["hlo_flops_per_dev"] > 0 and r["collectives"]["total"] > 0
    assert "trace_s" in r and "compile_s" not in r


def test_model_flops_global_matches_jax(records):
    from repro.configs import SHAPES, get_config
    from repro.launch import flops as jflops
    _, recs = records
    for cell, r in recs.items():
        arch, shape, _ = cell.split(":")
        if r["status"] == "ok":
            assert r["model_flops_global"] == jflops.model_flops(
                get_config(arch), SHAPES[shape])
            assert r["model_flops_per_dev"] == r["model_flops_global"] / 256


def test_prefill_cell_counts_k2_on_local_heads(records):
    """qwen2-7b's prefill on (16, 16): K2 meets 28 padded-to-32 q heads
    over 16 "model" ranks and 32 rows over 16 "data" ranks, so each rank's
    calls count 2 rows x 2 heads of a 32768-key causal attention; the
    kernels' FLOPs are part of the per-device total."""
    _, recs = records
    r = recs["qwen2-7b:prefill_32k:pod1"]
    assert r["status"] == "ok"
    k2 = r["cost_analysis_raw"]["flash_attention"]
    S, hd = 32768, 128
    pairs = S * (S + 1) // 2
    assert k2["calls"] == 28
    assert k2["flops"] == 28 * 4.0 * hd * 2 * 2 * pairs
    assert r["hlo_flops_per_dev"] > k2["flops"]


def test_skipped_cell_and_tables(records):
    from repro_torch.launch import report, roofline
    out, recs = records
    assert recs["whisper-base:long_500k:pod1"]["status"] == "skipped"
    table = report.md_table(str(out))
    assert "xlstm-125m" in table and "qwen2-7b" in table
    assert "whisper-base" in report.skipped_table(str(out))
    for k in ("xlstm-125m", "qwen2-7b"):
        rec = [r for c, r in recs.items() if c.startswith(k)][0]
        assert 0.0 < report.fraction(rec) <= 1.0
    roofline.print_table(str(out))


# ---------------- optrace ----------------

def test_optrace_counts_a_loop_free_product():
    a = torch.empty(256, 512, device="meta")
    b = torch.empty(512, 128, device="meta")
    with optrace.OpTrace() as tr:
        (a @ b).sum()
    r = tr.analyze()
    assert r["dot_flops"] == 2 * 256 * 128 * 512
    assert r["dot_traffic_bytes"] == 4 * (256 * 512 + 512 * 128 + 256 * 128)


def test_optrace_multiplies_loop_bodies():
    """A Python loop of 9 products counts 9 times (the trace unrolls it:
    the JAX package's scan needs its trip count)."""
    x = torch.empty(64, 64, device="meta")
    w = torch.empty(64, 64, device="meta")
    with optrace.OpTrace() as tr:
        for _ in range(9):
            x = x @ w
    assert tr.analyze()["dot_flops"] == 9 * 2 * 64 ** 3


REDIST_CODE = r"""
import json
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch import optrace
from repro_torch.launch.mesh import make_mesh
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
mesh = make_mesh((16, 16), ("data", "model"), "cpu")
loc = torch.empty(4, 1024, dtype=torch.bfloat16, device="meta")
x = DTensor.from_local(loc, mesh, [Shard(0), Replicate()], run_check=False,
                       shape=(64, 1024), stride=(1024, 1))
w = DTensor.from_local(torch.empty(1024, 64, dtype=torch.bfloat16,
                                   device="meta"), mesh,
                       [Replicate(), Shard(1)], run_check=False,
                       shape=(1024, 1024), stride=(1024, 1))
with optrace.OpTrace() as tr:
    y = x.redistribute(mesh, [Replicate(), Replicate()])
    z = x @ w
rec = tr.analyze()
print(json.dumps({"rec": rec, "y": list(y.to_local().shape),
                  "z": list(z.to_local().shape)}))
"""


def test_optrace_sees_local_ops_and_collectives():
    """On a (16, 16) fake mesh: a ``Shard(0) -> Replicate`` redistribute
    of a (64, 1024) bf16 DTensor counts one all-gather of this rank's
    4 x 1024 operand; a product of row-split x and column-split w counts
    the local (4, 1024) @ (1024, 64), not the global one."""
    r = subprocess.run([sys.executable, "-c", REDIST_CODE],
                       capture_output=True, text=True, timeout=300, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    rec = out["rec"]
    assert out["y"] == [64, 1024] and out["z"] == [4, 64]
    assert rec["collective_counts"]["all-gather"] == 1
    assert rec["collective_by_kind"]["all-gather"] == 4 * 1024 * 2
    assert rec["collective_bytes"] == 4 * 1024 * 2
    assert rec["matmul_flops"] == 2 * 4 * 64 * 1024


def test_roofline_terms_use_h100_constants():
    t = optrace.roofline_terms(989e12, 3.35e12, 50e9, 256,
                               nvlink_bytes=0.0)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(1.0)
    t = optrace.roofline_terms(1.0, 1.0, 900e9, 8, nvlink_bytes=900e9)
    assert t["collective_s"] == pytest.approx(2.0)
    assert t["bottleneck"] == "collective_s"


# ---------------- the kernels' meta paths ----------------

FLASH_META = [(16, 16, 0, True, None), (8, 24, 0, True, None),
              (16, 16, 0, False, None), (16, 40, 0, True, 7),
              (12, 12, 8, True, None), (5, 20, 3, True, 6)]


@pytest.mark.parametrize("Sq,Sk,Sp,causal,window", FLASH_META)
def test_visible_pairs_match_the_bound_masks(Sq, Sk, Sp, causal, window):
    """``ops._visible``'s closed form against ``chip_smoke.flash_visible``
    (the masks the card's bound counts) at full lengths."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import flash_visible
    q = torch.zeros(1, Sq, 1, 8)
    k = torch.zeros(1, Sk, 1, 8)
    kw = {"causal": causal, "window": window}
    if Sp:
        kw.update(prefix_k=torch.zeros(1, Sp, 1, 8),
                  prefix_len=torch.tensor([Sp]))
    vis = flash_visible(q, k, kw)
    pairs, keys = ops._visible(Sq, Sk, Sp, causal, window)
    assert pairs == int(vis.sum())
    assert keys == int(vis.any(dim=1).sum())


def test_meta_paths_give_kernel_shapes_and_work(monkeypatch):
    """Every wrapper on meta tensors returns its kernel's outputs (K2 its
    log-sum-exp through the backward) and reports its work, never running
    a plain version."""
    from repro_torch.kernels import ref

    def refuse(*a, **k):
        raise AssertionError("a plain version ran on meta tensors")
    for name in ("flash_attention_ref", "decode_attention_ref",
                 "decode_attention_int8_ref", "paged_decode_attention_ref",
                 "paged_verify_attention_ref", "segmented_lora_ref",
                 "rmsnorm"):
        monkeypatch.setattr(ref, name, refuse)
    seen = []
    monkeypatch.setattr(ops, "META_WORK", lambda *a: seen.append(a))
    m = dict(device="meta")
    bf = dict(dtype=torch.bfloat16, **m)
    q = torch.empty(2, 16, 8, 64, requires_grad=True, **bf)
    k = torch.empty(2, 16, 2, 64, requires_grad=True, **bf)
    o = ops.flash_attention(q, k, k)
    o.sum().backward()
    assert o.shape == q.shape and q.grad.shape == q.shape
    w = torch.empty(64, requires_grad=True, **m)
    x = torch.empty(3, 5, 64, requires_grad=True, **bf)
    y = ops.rmsnorm(w, x)
    y.float().sum().backward()
    assert y.shape == x.shape and y.dtype == x.dtype and w.grad.shape == (64,)
    qd = torch.empty(2, 8, 64, **bf)
    kc = torch.empty(2, 32, 2, 64, **bf)
    lens = torch.empty(2, dtype=torch.int32, **m)
    assert ops.decode_attention(qd, kc, kc, lens).shape == qd.shape
    k8 = torch.empty(2, 32, 2, 64, dtype=torch.int8, **m)
    sc = torch.empty(2, 2, **m)
    assert ops.decode_attention_int8(qd, k8, k8, sc, sc, lens).shape == \
        qd.shape
    pages = torch.empty(9, 16, 2, 64, dtype=torch.int8, **m)
    psc = torch.empty(9, 2, **m)
    pt = torch.empty(2, 4, dtype=torch.int32, **m)
    assert ops.paged_decode_attention(qd, pages, pages, psc, psc, pt,
                                      lens).shape == qd.shape
    qv = torch.empty(2, 5, 8, 64, **bf)
    assert ops.paged_verify_attention(qv, pages, pages, psc, psc, pt,
                                      lens).shape == qv.shape
    xs = torch.empty(256, 64, **bf)
    ids = torch.empty(2, dtype=torch.int32, **m)
    a = torch.empty(3, 64, 4, **m)
    b = torch.empty(3, 4, 96, **m)
    assert ops.segmented_lora(xs, ids, a, b).shape == (256, 96)
    names = [s[0] for s in seen]
    assert names == ["flash_attention", "flash_attention_bwd", "rmsnorm",
                     "rmsnorm_bwd", "decode_attention",
                     "decode_attention_int8", "paged_decode_attention",
                     "paged_verify_attention", "segmented_lora"]
    # rmsnorm's work is rmsnorm_timing's bound: x and w read, y written
    assert seen[2][1:] == (4.0 * 15 * 64, 2 * 2 * 15 * 64 + 4 * 64)
    # K2: 4 hd flops per (query head, visible key), causal 16 x 16
    assert seen[0][1] == 4.0 * 64 * 8 * 2 * (16 * 17 // 2)


def test_k3_meta_path_with_a_key_offset_and_lse(monkeypatch):
    """K3 on a meta piece of a split cache: the f32 output and the (B, H)
    log-sum-exp, and the piece's work: its S positions' FLOPs, the int8
    codes read, q read and the f32 output and lse written."""
    seen = []
    monkeypatch.setattr(ops, "META_WORK", lambda *a: seen.append(a))
    m = dict(device="meta")
    q = torch.empty(2, 8, 64, dtype=torch.bfloat16, **m)
    k8 = torch.empty(2, 32, 2, 64, dtype=torch.int8, **m)
    sc = torch.empty(2, 2, **m)
    lens = torch.empty(2, dtype=torch.int32, **m)
    o, lse = ops.decode_attention_int8(q, k8, k8, sc, sc, lens, key_offset=32,
                                       return_lse=True)
    assert o.shape == q.shape and o.dtype == torch.float32
    assert lse.shape == (2, 8) and lse.dtype == torch.float32
    n = 2 * 32
    assert seen == [("decode_attention_int8", 4.0 * n * 8 * 64,
                     (2 + 4) * 2 * 8 * 64 + 2 * n * 2 * 64 + 2 * 4 * 2 * 2
                     + 4 * 2 + 4 * 2 * 8)]

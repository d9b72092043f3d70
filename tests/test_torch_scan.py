"""The recurrent scans in checkpointed chunks (``models/scan.py``, the JAX
package's ``_chunked_scan`` and Mamba's per-chunk ``jax.checkpoint``), the
dry-run's once-a-chunk counts, and the two train cells whose backward
failed on a mesh.

Blocks: reduced xlstm-125m's mLSTM and sLSTM (d 64, di 128, 4 heads) and
reduced jamba's Mamba (di 128, d_state 16), f32 activations, B 2, S 16 in
chunks of 4 (``xlstm.SCAN_CHUNK``, Mamba's ``chunk``).

Tolerances:
  chunked against the unchunked port (every chunk run without a
      checkpoint: the parent's program): forward and gradients bit for bit
      (a non-reentrant checkpoint recomputes the same ops and hands the
      saved tensors back to the same graph, so every sum runs in the same
      order);
  against the JAX package: 1e-5 rel L2 for the outputs and 1e-4 a leaf for
      the gradients (both f32; XLA and PyTorch round exp/log and order
      their products differently, and the gates compound that over 16
      steps);
  the bytes the scan holds for the backward: at most the chunk-boundary
      states plus what one unchunked chunk saves (counted with
      ``saved_tensors_hooks``), and under half of what the unchunked scan
      holds;
  the once-a-chunk trace against the unrolled one: equal (integer counts
      in floats far below 2**53).
"""
import functools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.launch import optrace  # noqa: E402
from repro_torch.models import mamba, xlstm  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
B, S, C = 2, 16, 4
OUT_TOL, GRAD_TOL = 1e-5, 1e-4


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _blocks():
    """name -> (config, spec, forward's name, module: "xlstm" or "mamba"),
    the same names in both packages."""
    xcfg = reduced(get_config("xlstm-125m"))
    jcfg = reduced(get_config("jamba-v0.1-52b"))
    return {
        "mlstm": (xcfg, xlstm.mlstm_spec(xcfg), "mlstm_forward", "xlstm"),
        "slstm": (xcfg, xlstm.slstm_spec(xcfg), "slstm_forward", "xlstm"),
        "mamba": (jcfg, mamba.mamba_spec(jcfg), "mamba_forward", "mamba"),
    }


def _draw(spec, rng):
    """f32 numpy params at 1/sqrt(fan-in) (the q/k/v and gate projections
    at their real fan-in, as ``chip_smoke.fan_in_qk`` puts them: at the
    package's draws the cells saturate)."""
    out = {}
    for k, s in spec.items():
        shape = tuple(s.shape)
        if s.init == "zeros":
            out[k] = np.zeros(shape, np.float32)
        elif s.init == "ones":
            out[k] = np.ones(shape, np.float32)
        else:
            fan = shape[0]
            out[k] = (rng.randn(*shape) / np.sqrt(fan)).astype(np.float32)
    if "A_log" in out:
        out["A_log"] = rng.uniform(-1.0, 0.5, out["A_log"].shape).astype(
            np.float32)
    return out


def _port(name, p, x):
    cfg, _, fwd, mod = _blocks()[name]
    fn = getattr({"xlstm": xlstm, "mamba": mamba}[mod], fwd)
    if mod == "mamba":
        fn = functools.partial(fn, chunk=C)
    return fn(p, x, cfg)


def _unchunked(monkeypatch):
    """The parent's scan: every chunk run as it is, nothing checkpointed."""
    from repro_torch.models import scan
    monkeypatch.setattr(scan, "_run",
                        lambda fn, state, xs, consts: fn(state, xs, *consts))


@pytest.fixture(autouse=True)
def _chunk(monkeypatch):
    monkeypatch.setattr(xlstm, "SCAN_CHUNK", C, raising=False)


def _grads(name, p_np, x_np, w_np):
    p = {k: torch.tensor(v, requires_grad=True) for k, v in p_np.items()}
    x = torch.tensor(x_np, requires_grad=True)
    y, _ = _port(name, p, x)
    loss = (y * torch.tensor(w_np)).sum()
    g = torch.autograd.grad(loss, [x] + list(p.values()))
    return y.detach(), dict(zip(["x"] + list(p), g))


def _inputs(name, seed=0):
    cfg, spec, _, _ = _blocks()[name]
    rng = np.random.RandomState(seed)
    p = _draw(spec, rng)
    x = rng.randn(B, S, cfg.d_model).astype(np.float32)
    w = rng.randn(B, S, cfg.d_model).astype(np.float32)
    return p, x, w


@pytest.mark.parametrize("name", ["mlstm", "slstm", "mamba"])
def test_chunked_scan_equals_the_unchunked_port(name, monkeypatch):
    """Chunks of 4 over 16 steps, checkpointed, against the same block
    with nothing checkpointed: the output and every gradient bit for
    bit."""
    p, x, w = _inputs(name)
    y, g = _grads(name, p, x, w)
    _unchunked(monkeypatch)
    y0, g0 = _grads(name, p, x, w)
    assert torch.equal(y, y0)
    for k in g0:
        assert torch.equal(g[k], g0[k]), k


@pytest.mark.parametrize("name", ["mlstm", "slstm", "mamba"])
def test_chunked_scan_gradients_match_jax(name):
    """The chunked block's output and gradients (x and every parameter)
    against ``jax.grad`` of the JAX package's block on the same f32
    inputs."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.configs import reduced as jreduced
    from repro.models import mamba as jmamba
    from repro.models import xlstm as jxlstm
    from repro.models.common import NO_SHARD
    cfg_name = "jamba-v0.1-52b" if name == "mamba" else "xlstm-125m"
    jcfg = jreduced(jget(cfg_name))
    _, _, fwd, mod = _blocks()[name]
    jfn = getattr({"xlstm": jxlstm, "mamba": jmamba}[mod], fwd)
    p, x, w = _inputs(name)

    def loss(pp, xx):
        y, _ = jfn(pp, xx, jcfg, NO_SHARD)
        return jnp.sum(y * w), y
    (_, jy), jg = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    y, g = _grads(name, p, x, w)
    assert rel_l2(y.numpy(), jy) <= OUT_TOL
    assert rel_l2(g["x"].numpy(), jg[1]) <= GRAD_TOL
    for k in p:
        assert rel_l2(g[k].numpy(), jg[0][k]) <= GRAD_TOL, k


def _scan_bytes(name, monkeypatch):
    """(bytes the scan holds for the backward once it returns, bytes its
    steps saved through ``saved_tensors_hooks``, one state's bytes, the
    number of chunks). Counted inside ``scan_chunks`` alone: storages the
    scan allocated and that are still alive (``optrace.OpTrace``'s
    tracking, the output and final state left out), and the distinct
    storages it allocated that autograd packed."""
    from repro_torch.models import scan
    got = {}
    real = scan.scan_chunks

    def measured(fn, state, xs, n, consts=()):
        tr = optrace.OpTrace(once_a_chunk=False)
        tr.inputs([t for t in torch.utils._pytree.tree_leaves(
            (state, xs, consts)) if isinstance(t, torch.Tensor)])
        packed = {}

        def pack(t):
            key = t.untyped_storage()._cdata
            if key in tr._live:
                packed[key] = t.untyped_storage().nbytes()
            return t
        with tr, torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = real(fn, state, xs, n, consts)
        outs = {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
                for t in torch.utils._pytree.tree_leaves(out)}
        got.update(held=sum(b for k, b in tr._live.items() if k not in outs),
                   saved=sum(packed.values()), n=n,
                   state=sum(t.nbytes for t in
                             torch.utils._pytree.tree_leaves(out[0])))
        return out
    for mod in (xlstm, mamba):
        monkeypatch.setattr(mod, "scan_chunks", measured)
    p, x, w = _inputs(name)
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    _port(name, pt, torch.tensor(x, requires_grad=True))
    return got


@pytest.mark.parametrize("name", ["mlstm", "slstm", "mamba"])
def test_checkpointed_scan_holds_boundaries_and_one_chunk(name, monkeypatch):
    """The chunked scan's saved tensors are at most its chunk boundaries
    (a checkpoint saves its tensor inputs: Mamba's state; the xLSTM state
    dicts it keeps by reference), and all it holds for the backward is at
    most the boundaries plus one unchunked chunk's saved tensors, where
    the unchunked scan holds every step's."""
    chunked = _scan_bytes(name, monkeypatch)
    _unchunked(monkeypatch)
    whole = _scan_bytes(name, monkeypatch)
    n = chunked["n"]
    assert n == S // C
    assert chunked["saved"] <= (n - 1) * chunked["state"]
    one_chunk = whole["saved"] / n
    print(f"{name}: held {chunked['held']} B chunked, {whole['held']} B "
          f"unchunked; state {chunked['state']} B, one chunk's saves "
          f"{one_chunk:.0f} B")
    assert chunked["held"] <= n * chunked["state"] + one_chunk
    assert 2 * chunked["held"] < whole["held"]


# ---------------- the dry-run ----------------

def _python(code: str, timeout: int = 300) -> str:
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=timeout,
                       cwd=ROOT, env=dict(os.environ,
                                          PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    return r.stdout


def test_once_a_chunk_counts_equal_the_unrolled_trace():
    """The dry-run's scan counts (chunks 0 and n-1 as they run, chunk 1
    under ``repeat(n - 2)``) against every chunk unrolled, at S = 4 chunks
    (chunks of 2 over 8 steps), for the reduced xlstm-125m and jamba
    stacks' train and prefill steps on a (2, 2) mesh of a 4-rank fake
    group: dot FLOPs, HBM bytes, collective bytes and counts and the
    kernel rows equal."""
    out = _python("""
        import dataclasses, functools, json
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=4)
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor.experimental import implicit_replication
        from repro_torch.configs import SHAPES, get_config, reduced
        from repro_torch.launch import cells, optrace
        from repro_torch.models import blocks, mamba, xlstm
        from repro_torch.models.common import tree_leaves
        xlstm.SCAN_CHUNK = 2
        blocks.mam.mamba_forward = functools.partial(mamba.mamba_forward,
                                                     chunk=2)
        cells.get_config = lambda a: reduced(get_config(a))
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        keys = ("dot_flops", "hbm_traffic_bytes", "collective_bytes",
                "collective_counts", "kernels")
        res = {}
        for arch in ("xlstm-125m", "jamba-v0.1-52b"):
            for shape in ("train_4k", "prefill_32k"):
                sh = dataclasses.replace(SHAPES[shape], seq_len=8,
                                         global_batch=8)
                got = []
                for once in (True, False):
                    cell = cells.build_cell(arch, sh, mesh,
                                            overrides={"microbatch": 1})
                    tr = optrace.OpTrace(once_a_chunk=once)
                    tr.inputs(tree_leaves(list(cell.args)))
                    with tr, implicit_replication():
                        cell.fn(*cell.args)
                    a = tr.analyze()
                    got.append({k: a[k] for k in keys})
                res[arch + ":" + shape] = got
        print("RESULT " + json.dumps(res))
    """)
    res = json.loads(out.split("RESULT ", 1)[1])
    for cell, (once, unrolled) in res.items():
        assert once == unrolled, cell
        assert once["dot_flops"] > 0 and once["collective_bytes"] > 0, cell


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-v0.1-52b"])
def test_train_cell_backward_on_256_fake_ranks(arch):
    """The train_4k cell of the repaired stacks, one period deep at 4
    tokens and one microbatch, through the dry-run's ``run_one_cell`` on
    the 256-rank pod1 mesh: the backward used to raise inside
    ``torch.autograd.grad``
    (xlstm-125m: DTensor cannot unflatten di into 4 heads split 16 ways;
    jamba: an in-place write into the Mamba states' buffer asked for a
    Shard -> Partial redistribute)."""
    out = _python(f"""
        import dataclasses, json
        from repro_torch.configs import SHAPES, get_config
        from repro_torch.launch import cells, dryrun
        from repro_torch.models import blocks
        SHAPES["train_4k"] = dataclasses.replace(SHAPES["train_4k"],
                                                 seq_len=4)
        def one_period(a):
            c = get_config(a)
            return dataclasses.replace(c, num_layers=blocks.period_len(c))
        cells.get_config = one_period
        r = dryrun.run_one_cell({arch!r}, "train_4k", "pod1",
                                {{"microbatch": 1}})
        print("RESULT " + json.dumps({{k: r[k] for k in (
            "status", "chips", "hlo_flops_per_dev", "collective_bytes_norm")}}))
    """)
    r = json.loads(out.split("RESULT ", 1)[1])
    assert r["status"] == "ok" and r["chips"] == 256
    assert r["hlo_flops_per_dev"] > 0 and r["collective_bytes_norm"] > 0

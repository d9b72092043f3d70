"""The port's mesh plane held against the JAX package on the CPU:
``repro_torch.sharding.rules`` (the rule tables, ``spec_for``, and
``placements_for``'s DTensor layout against GSPMD's), ``sharding.padding``
(``pad_for_tp``, ``pad_params``), ``configs.shapes`` (``grid``),
``launch.flops`` (``model_flops``), ``distributed.elastic``
(``shrink_plan``) and ``distributed.compression`` (``quantize_int8``,
``compressed_psum`` over gloo ranks against ``shard_map`` over host
devices).

Tolerances: none. Every comparison here is exact: the specs, configs,
FLOP counts and plans are integers and strings; the padded weights are the
same numpy copies and zeros; the int8 codes and scales come from the same
f32 max, division and round-half-to-even, and the compressed sum adds
int32 codes exactly on both sides.

Multi-rank checks spawn gloo ranks (``torch.multiprocessing``) that meet
over a ``FileStore`` under ``tmp_path`` (no port); the JAX side runs in a
subprocess with ``--xla_force_host_platform_device_count`` host devices.
"""
import dataclasses
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.configs import ASSIGNED  # noqa: E402
from repro_torch.configs import SHAPES as TSHAPES  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import grid as tgrid  # noqa: E402
from repro_torch.configs import reduced as treduced  # noqa: E402
from repro_torch.distributed import compression as tcomp  # noqa: E402
from repro_torch.distributed import elastic as telastic  # noqa: E402
from repro_torch.launch import flops as tflops  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.common import tree_paths  # noqa: E402
from repro_torch.sharding import padding as tpad  # noqa: E402
from repro_torch.sharding import rules as trules  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
TABLES = ("ACT_RULES", "SP_ACT", "TP_RULES", "FSDP_RULES", "LONG_CTX_ACT",
          "LONG_CTX_PARAM", "LONG_CTX_FSDP")


def _jax_env(devices: int) -> dict:
    return {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}"}


def run_jax(code: str, devices: int, tmp_path) -> dict:
    """Run ``code`` (which writes ``out.npz`` into its working directory)
    in a JAX subprocess with ``devices`` host devices; its arrays."""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=_jax_env(devices),
                       cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    with np.load(tmp_path / "out.npz") as f:
        return {k: f[k] for k in f.files}


def spawn(fn, world: int, tmp_path, *args):
    """``fn(rank, world, store, *args)`` on ``world`` gloo ranks."""
    store = str(tmp_path / f"store-{fn.__name__}")
    mp.spawn(fn, args=(world, store) + args, nprocs=world, join=True)


def gloo(rank, world, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)


# ---------------- rules ----------------

def test_rule_tables_are_the_jax_tables():
    from repro.sharding import rules as jrules
    for name in TABLES:
        assert getattr(trules, name) == getattr(jrules, name), name


def _axes_cases(arch):
    """(path, logical axes, shape) of every parameter and decode-cache
    leaf of ``arch`` (cache at 8 rows x 64 positions), the port's trees
    checked against the JAX package's (same paths, axes and shapes)."""
    from repro.configs import get_config as jget
    from repro.models import lm as jlm
    from repro.models.common import ParamSpec as JSpec
    import jax
    out = []
    for kind in ("params", "cache"):
        tcfg, jcfg = tget(arch), jget(arch)
        tspec = tlm.model_spec(tcfg) if kind == "params" else \
            tlm.cache_spec(tcfg, 8, 64)
        jspec = jlm.model_spec(jcfg) if kind == "params" else \
            jlm.cache_spec(jcfg, 8, 64)
        jleaves = jax.tree_util.tree_flatten_with_path(
            jspec, is_leaf=lambda x: isinstance(x, JSpec))[0]
        jmap = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                         for p in path): s for path, s in jleaves}
        tmap = dict(tree_paths(tspec))
        assert set(tmap) <= set(jmap), sorted(set(tmap) - set(jmap))[:5]
        for k, s in tmap.items():
            assert tuple(s.axes) == tuple(jmap[k].axes), k
            assert tuple(s.shape) == tuple(jmap[k].shape), k
            out.append((f"{kind}/{k}", tuple(s.axes), tuple(s.shape)))
    return out


@pytest.fixture(scope="module")
def axes_cases():
    return {arch: _axes_cases(arch) for arch in ASSIGNED}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("table", TABLES)
def test_spec_for_matches_jax(table, mesh, axes_cases):
    """Every ``ASSIGNED`` arch's parameter and cache axes, with and
    without the shape (the divisibility fallback), on a plain description
    of the mesh: the port's spec equals ``tuple`` of JAX's
    ``PartitionSpec``, and its placements name each mesh dimension of size
    above 1 that the spec uses on that tensor dimension (one of size 1 is
    ``Replicate``)."""
    from repro.sharding import rules as jrules
    shape, names = MESHES[mesh]
    desc = dict(zip(names, shape))
    jmesh = types.SimpleNamespace(axis_names=names, shape=desc)
    rules = getattr(trules, table)
    n = 0
    for arch, cases in axes_cases.items():
        for key, axes, shp in cases:
            for s in (shp, None):
                got = trules.spec_for(rules, axes, desc, s)
                want = tuple(jrules.spec_for(rules, axes, jmesh, s))
                want = want + (None,) * (len(axes) - len(want))
                assert got == want, (arch, key, s)
                n += 1
            pl = trules.placements_for(got, desc)
            for j, a in enumerate(names):
                dims = [i for i, e in enumerate(got) if desc[a] > 1 and (
                    e == a or (isinstance(e, tuple) and a in e))]
                assert (pl[j].dim if hasattr(pl[j], "dim") else None) == \
                    (dims[0] if dims else None), (arch, key, a)
    assert n > 600


def test_placements_for_refuses_an_order_against_the_mesh():
    with pytest.raises(ValueError, match="mesh's order"):
        trules.placements_for((("data", "pod"), None),
                              {"pod": 2, "data": 2, "model": 1})


GSPMD_CODE = r"""
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 1), ("pod", "data", "model"))
out = {}
for name, shape, spec in [("rows", (8, 3), P(("pod", "data"), None)),
                          ("wide", (12, 2), P(("pod", "data"), None))]:
    idx = NamedSharding(mesh, spec).devices_indices_map(shape)
    for pos in np.ndindex(2, 2, 1):
        sl = idx[mesh.devices[pos]][0]
        out[f"{name}_{pos[0]}{pos[1]}"] = np.array(
            [sl.start or 0, shape[0] if sl.stop is None else sl.stop])
np.savez("out.npz", **out)
"""


def _layout_rank(rank, world, store, tmp):
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.launch.mesh import make_mesh
    gloo(rank, world, store)
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), "cpu")
    got = {}
    for name, shape in (("rows", (8, 3)), ("wide", (12, 2))):
        full = torch.arange(float(np.prod(shape))).reshape(shape)
        spec = trules.spec_for(trules.ACT_RULES, ("batch", None), mesh, shape)
        pl = trules.placements_for(spec, mesh)
        d = DTensor.from_local(full, mesh, [Replicate()] * 3,
                               run_check=False).redistribute(mesh, pl)
        loc = d.to_local()
        sl = trules.local_slices(shape, mesh, pl)
        assert torch.equal(loc, full[sl]), (name, sl)
        c = mesh.get_coordinate()
        rows = full[:, 0] // shape[1]
        got[f"{name}_{c[0]}{c[1]}"] = [int(rows[sl[0]][0]) if loc.numel()
                                       else sl[0].start,
                                       int(sl[0].stop)]
    (Path(tmp) / f"layout{rank}.json").write_text(json.dumps(got))
    dist.destroy_process_group()


def test_dtensor_layout_matches_gspmd(tmp_path):
    """On a (2, 2, 1) gloo mesh over ("pod", "data", "model"), each rank's
    local shard of a ("batch", None) array (8 and 12 rows) is the slice
    (``local_slices``) JAX's
    ``NamedSharding.devices_indices_map`` gives the device at the same
    mesh position: "pod" is the outer split in both."""
    want = run_jax(GSPMD_CODE, 4, tmp_path)
    spawn(_layout_rank, 4, tmp_path, str(tmp_path))
    got = {}
    for r in range(4):
        got.update(json.loads((tmp_path / f"layout{r}.json").read_text()))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert list(v) == got[k], (k, list(v), got[k])


# ---------------- padding, shapes, flops, elastic ----------------

@pytest.mark.parametrize("tp", [1, 2, 4, 8, 16])
def test_pad_for_tp_matches_jax(tp):
    from repro.configs import get_config as jget
    from repro.sharding.padding import pad_for_tp as jpad
    for arch in ASSIGNED:
        got = dataclasses.asdict(tpad.pad_for_tp(tget(arch), tp))
        want = dataclasses.asdict(jpad(jget(arch), tp))
        assert got == want, arch


@pytest.mark.parametrize("arch,tp", [("qwen2-7b", 8), ("qwen2-7b", 16),
                                     ("grok-1-314b", 8), ("grok-1-314b", 3)])
def test_pad_params_bit_equal(arch, tp):
    """Reduced qwen2-7b and grok-1-314b (4 q heads, 2 kv heads: kv
    expanded and q groups padded at tp 8 and 16; tp 3 pads only the
    vocab record): the JAX init's weights padded by both packages, the
    port's given torch tensors, are the same bits, leaf for leaf."""
    import jax
    from repro.configs import get_config as jget
    from repro.configs import reduced as jred
    from repro.models import lm as jlm
    from repro.sharding.padding import pad_for_tp as jpad_cfg
    from repro.sharding.padding import pad_params as jpad
    from repro_torch import weights
    jcfg = jred(jget(arch))
    tree = jax.tree.map(np.asarray, jlm.init_model(jax.random.PRNGKey(0),
                                                   jcfg))
    want = jpad(tree, jcfg, jpad_cfg(jcfg, tp))
    tcfg = treduced(tget(arch))
    tp_cfg = tpad.pad_for_tp(tcfg, tp)
    got = tpad.pad_params(weights.model_params(tree, "cpu", masters=True),
                          tcfg, tp_cfg)
    w = {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in
                  path): np.asarray(v)
         for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    g = dict(tree_paths(got))
    assert sorted(g) == sorted(w)
    for k, v in g.items():
        assert isinstance(v, torch.Tensor) and v.dtype == torch.float32
        assert np.array_equal(v.numpy(), w[k]), k
    # the numpy path gives the same arrays
    gn = dict(tree_paths(tpad.pad_params(tree, tcfg, tp_cfg)))
    for k, v in gn.items():
        assert np.array_equal(v, w[k]), k


def test_grid_and_model_flops_match_jax():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget
    from repro.configs import grid as jgrid
    from repro.launch import flops as jflops
    assert list(TSHAPES) == list(JSHAPES)
    for arch in ASSIGNED:
        got = [(s.name, s.kind, s.seq_len, s.global_batch, ok, why)
               for s, ok, why in tgrid(tget(arch))]
        want = [(s.name, s.kind, s.seq_len, s.global_batch, ok, why)
                for s, ok, why in jgrid(jget(arch))]
        assert got == want, arch
        for name in JSHAPES:
            assert tflops.model_flops(tget(arch), TSHAPES[name]) == \
                jflops.model_flops(jget(arch), JSHAPES[name]), (arch, name)
            assert tflops._counts(tget(arch)) == jflops._counts(jget(arch))


def test_shrink_plan_matches_jax():
    from repro.distributed import elastic as jelastic
    n = 0
    for healthy in range(0, 80, 3):
        for mp_ in (1, 2, 4, 8, 16):
            for old_data in (1, 2, 4, 8):
                for pods in (1, 2):
                    got = telastic.shrink_plan(healthy, model_parallel=mp_,
                                               old_data=old_data,
                                               old_pods=pods)
                    want = jelastic.shrink_plan(healthy, model_parallel=mp_,
                                                old_data=old_data,
                                                old_pods=pods)
                    assert (got is None) == (want is None)
                    if got is not None:
                        assert dataclasses.astuple(got) == \
                            dataclasses.astuple(want)
                        assert got.devices == want.devices
                        n += 1
    assert n > 100


# ---------------- compression ----------------

def _quant_inputs():
    r = np.random.RandomState(7)
    xs = [r.randn(257).astype(np.float32),
          (r.randn(16, 33) * 1e-3).astype(np.float32),
          np.zeros(8, np.float32),
          (np.arange(-254, 255, dtype=np.float32) / 2.0)]  # exact .5 codes
    return xs


def test_quantize_int8_bit_equal_to_jax():
    import jax.numpy as jnp
    from repro.distributed import compression as jcomp
    for x in _quant_inputs():
        q, s = tcomp.quantize_int8(torch.from_numpy(x))
        jq, js = jcomp.quantize_int8(jnp.asarray(x))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert np.float32(s.item()) == np.float32(js)
        d = tcomp.dequantize_int8(q, s).numpy()
        assert np.array_equal(d, np.asarray(jcomp.dequantize_int8(jq, js)))


PSUM_CODE = r"""
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P
from repro.distributed.compression import compressed_pmean, compressed_psum
mesh = Mesh(np.array(jax.devices()), ("data",))
x = jnp.asarray(np.load("x.npy"))
out = {}
for name, fn in (("psum", compressed_psum), ("pmean", compressed_pmean)):
    f = jax.jit(shard_map(lambda v: fn(v, "data"), mesh=mesh,
                          in_specs=P("data"), out_specs=P("data")))
    out[name] = np.asarray(f(x))
np.savez("out.npz", **out)
"""


def _psum_rank(rank, world, store, tmp):
    gloo(rank, world, store)
    x = torch.from_numpy(np.load(Path(tmp) / "x.npy")[rank:rank + 1])
    out = {"psum": tcomp.compressed_psum(x).numpy(),
           "pmean": tcomp.compressed_pmean(x).numpy(),
           "tree": tcomp.tree_compressed_pmean({"a": [x]})["a"][0].numpy()}
    np.savez(Path(tmp) / f"psum{rank}.npz", **out)
    dist.destroy_process_group()


def test_compressed_psum_matches_jax_shard_map(tmp_path):
    """``compressed_psum`` / ``compressed_pmean`` over a 4-rank gloo group
    against the JAX functions under ``shard_map`` over 4 host devices, one
    row a rank (rows of very different magnitudes: the shared scale is the
    largest): exactly equal on every rank."""
    r = np.random.RandomState(3)
    x = (r.randn(4, 96) * np.array([[1.0], [0.01], [30.0], [2.0]])
         ).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    want = run_jax(PSUM_CODE, 4, tmp_path)
    spawn(_psum_rank, 4, tmp_path, str(tmp_path))
    for rank in range(4):
        with np.load(tmp_path / f"psum{rank}.npz") as got:
            assert np.array_equal(got["psum"], want["psum"][rank:rank + 1])
            assert np.array_equal(got["pmean"], want["pmean"][rank:rank + 1])
            assert np.array_equal(got["tree"], got["pmean"])

"""The port on meshes of gloo ranks, held against its mesh-less self and
the JAX package on the CPU: ``lm.loss_fn`` and its gradients with the
masters under ``FSDP_RULES`` and the activations under ``ACT_RULES``,
``launch.train.Trainer(mesh=...)``, the expert-parallel MoE
(``models.moe._moe_ep``) and the cross-mesh ``checkpoint.ckpt.restore``.

Ranks are spawned (``torch.multiprocessing``) and meet over a
``FileStore`` under a temporary directory, never a TCP port; the JAX side
runs in this process (``loss_fn``, the ``Trainer``) or in a subprocess
with host devices (``_moe_ep``'s ``shard_map``). The weights are the JAX
init's with q/k at their real fan-in (``chip_smoke.fan_in_qk``, as in
``tests/test_torch_train.py``).

Tolerances:
  the (2, 2) mesh against the port without a mesh: the loss within 1e-4
      relative (the same bf16 activations; DTensor sums partial products
      and norms over ranks in other orders), every leaf's gradient within
      3e-2 rel L2 (bf16 cotangents rounded after sums in other orders:
      measured 0.012);
  against the JAX package: ``tests/test_torch_train.py``'s 1e-2 relative
      for the loss and 3e-2 rel L2 a leaf for the gradients;
  three ``Trainer`` steps on the (2, 2) mesh against three without: each
      loss within 1e-3 relative and each final master within 1e-2 rel L2
      (AdamW's normalized steps turn the gradients' bf16 noise into
      updates of up to lr on elements whose gradient is near 0);
  a (1, 1) mesh on one rank: bit for bit (the same local ops);
  ``_moe_ep`` on a (1, 2) mesh against JAX's on 2 host devices, bf16
      activations: the tokens' expert sets equal, and each row's output
      within 2e-2 rel L2 and ``aux`` within 1e-5 relative up to the first
      token whose expert set differs (there is none on these inputs);
  the restore of a JAX ``Trainer`` checkpoint onto a (2, 1) mesh: exact.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.models.common import tree_map, tree_paths  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "stablelm-1.6b"
B, S = 4, 16


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def gloo(rank, world, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)


def spawn(fn, world, tmp_path, *args):
    store = str(tmp_path / f"store-{fn.__name__}")
    mp.spawn(fn, args=(world, store) + args, nprocs=world, join=True)


def _cfg():
    from repro_torch.configs import get_config, reduced
    return reduced(get_config(ARCH))


def _masters(tree):
    """The port's f32 masters of a JAX init tree (numpy leaves), q/k at
    their real fan-in."""
    sys.path.insert(0, str(ROOT))
    from chip_smoke import fan_in_qk
    from repro_torch import weights
    params = weights.model_params(tree, "cpu", masters=True)
    with torch.no_grad():
        fan_in_qk(params, _cfg())
    return params


def _grads(params, batch, shard=None):
    from repro_torch.models import lm
    from repro_torch.models.common import NO_SHARD
    leaves = [t for _, t in tree_paths(params)]
    loss, _ = lm.loss_fn(params, _cfg(), batch, shard or NO_SHARD)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, {k: (torch.zeros(t.shape) if g is None else g)
                  for (k, t), g in zip(tree_paths(params), grads)}


# ---------------- (2, 2): loss, gradients, Trainer ----------------

def _mesh22_rank(rank, world, store, tmp, tree, tokens):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import Trainer, distribute
    from repro_torch.models.common import ShardCtx
    from repro_torch.sharding import rules as R
    gloo(rank, world, store)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    tr = Trainer(_cfg(), batch=B, seq=S, ckpt_dir=os.path.join(tmp, "mesh"),
                 mesh=mesh, device="cpu", params=_masters(tree),
                 ckpt_every=100, async_ckpt=False, lr=1e-3, total_steps=3)
    params = tree_map(lambda t: t.requires_grad_(True), distribute(
        _masters(tree), tr.state_shardings({"params": _masters(tree)})[
            "params"]))
    placements = {k: str(tuple(v.placements)) for k, v in tree_paths(params)}
    tok = DTensor.from_local(torch.from_numpy(tokens), mesh,
                             [Replicate(), Replicate()],
                             run_check=False).redistribute(
        mesh, [Shard(0), Replicate()])
    with implicit_replication():
        loss, grads = _grads(params, {"tokens": tok},
                             ShardCtx(R.ACT_RULES, mesh))
        loss = loss.full_tensor()
        grads = {k: g.full_tensor() for k, g in grads.items()}
    losses = tr.run(3)
    if rank == 0:
        np.savez(Path(tmp) / "mesh22.npz", loss=loss.detach().numpy(),
                 losses=np.array(losses),
                 **{"g/" + k: g.detach().numpy() for k, g in grads.items()})
        (Path(tmp) / "placements.json").write_text(json.dumps(placements))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh22(tmp_path_factory):
    """One spawn of 4 ranks: the loss and gradients on the (2, 2) mesh,
    then 3 ``Trainer`` steps on it; beside them the same without a mesh
    and in the JAX package."""
    import jax
    from repro.configs import get_config, reduced
    from repro.models import lm as jlm
    tmp = tmp_path_factory.mktemp("mesh22")
    cfg = reduced(get_config(ARCH))
    tree = jax.tree.map(np.asarray, jlm.init_model(jax.random.PRNGKey(0),
                                                   cfg))
    tokens = np.random.RandomState(1).randint(
        0, cfg.vocab_size, (B, S)).astype(np.int64)
    spawn(_mesh22_rank, 4, tmp, str(tmp), tree, tokens)
    return tmp, tree, tokens


def test_mesh_loss_and_grads_match_the_port_without_a_mesh(mesh22):
    tmp, tree, tokens = mesh22
    params = tree_map(lambda t: t.requires_grad_(True), _masters(tree))
    loss, grads = _grads(params, {"tokens": torch.from_numpy(tokens)})
    with np.load(tmp / "mesh22.npz") as got:
        assert abs(float(got["loss"]) - loss.item()) <= 1e-4 * abs(loss.item())
        worst = max((rel_l2(got["g/" + k], g.numpy()), k)
                    for k, g in grads.items())
    assert worst[0] <= 3e-2, worst


def test_mesh_loss_and_grads_match_jax(mesh22):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config, reduced
    from repro.models import lm as jlm
    tmp, tree, tokens = mesh22
    jp = tree_map(lambda t: jnp.asarray(t.numpy()), _masters(tree))
    (jloss, _), jg = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
        jp, reduced(get_config(ARCH)),
        {"tokens": jnp.asarray(tokens, jnp.int32)})
    jflat = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                      for p in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    with np.load(tmp / "mesh22.npz") as got:
        assert abs(float(got["loss"]) - float(jloss)) <= \
            1e-2 * abs(float(jloss))
        worst = max((rel_l2(got["g/" + k], v), k) for k, v in jflat.items())
    assert worst[0] <= 3e-2, worst


def test_mesh_params_follow_fsdp_rules(mesh22):
    """The masters' placements on the (2, 2) mesh: FSDP's row split over
    "data" where ``embed`` is, the heads, MLP width and vocab over
    "model"."""
    tmp, _, _ = mesh22
    pl = json.loads((tmp / "placements.json").read_text())
    assert pl["embed"] == "(Shard(dim=1), Shard(dim=0))"
    assert pl["head"] == "(Shard(dim=0), Shard(dim=1))"
    assert pl["layers/0/attn/wq"] == "(Shard(dim=1), Shard(dim=2))"
    assert pl["layers/0/ffn/wo"] == "(Shard(dim=2), Shard(dim=1))"
    assert pl["layers/0/ln1"] == "(Shard(dim=1), Replicate())"


def test_trainer_on_a_mesh_matches_three_steps_without(mesh22, tmp_path):
    from repro_torch.launch.train import Trainer
    tmp, tree, _ = mesh22
    tr = Trainer(_cfg(), batch=B, seq=S, ckpt_dir=tmp_path, device="cpu",
                 params=_masters(tree), ckpt_every=100, async_ckpt=False,
                 lr=1e-3, total_steps=3)
    want = np.array(tr.run(3))
    with np.load(tmp / "mesh22.npz") as got:
        assert np.all(np.abs(got["losses"] - want) <= 1e-3 * np.abs(want)), \
            (got["losses"], want)
    # the mesh run's checkpoint is in the one-device format
    with np.load(tmp / "mesh" / "checkpoint-2.npz") as m, \
            np.load(tmp_path / "checkpoint-2.npz") as p:
        assert sorted(m.files) == sorted(p.files)
        worst = max((rel_l2(m[k], p[k]), k) for k in p.files
                    if k.startswith("params/"))
    assert worst[0] <= 1e-2, worst


# ---------------- (1, 1): bit for bit ----------------

def _local_mesh_rank(rank, world, store, tmp, tree):
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import Trainer
    mesh = make_local_mesh("cpu")
    kw = dict(batch=B, seq=S, device="cpu", ckpt_every=100,
              async_ckpt=False, lr=1e-3, total_steps=3)
    got = Trainer(_cfg(), ckpt_dir=os.path.join(tmp, "m"), mesh=mesh,
                  params=_masters(tree), **kw).run(3)
    want = Trainer(_cfg(), ckpt_dir=os.path.join(tmp, "p"),
                   params=_masters(tree), **kw).run(3)
    (Path(tmp) / "local.json").write_text(json.dumps([got, want]))
    dist.destroy_process_group()


def test_local_mesh_trainer_is_bit_identical(tmp_path):
    """``make_local_mesh("cpu")`` (a (1, 1) mesh on a 1-rank gloo group it
    starts over a ``FileStore``): three ``Trainer`` steps give the losses
    and masters of three without a mesh, bit for bit."""
    import jax
    from repro.configs import get_config, reduced
    from repro.models import lm as jlm
    tree = jax.tree.map(np.asarray, jlm.init_model(
        jax.random.PRNGKey(0), reduced(get_config(ARCH))))
    mp.spawn(_local_mesh_rank, args=(1, "", str(tmp_path), tree), nprocs=1)
    got, want = json.loads((tmp_path / "local.json").read_text())
    assert got == want
    with np.load(tmp_path / "m" / "checkpoint-2.npz") as m, \
            np.load(tmp_path / "p" / "checkpoint-2.npz") as p:
        for k in p.files:
            assert np.array_equal(m[k], p[k]), k


# ---------------- 2 ranks: restore, expert parallelism ----------------

def _moe_inputs():
    r = np.random.RandomState(5)
    E, d, f = 8, 32, 48
    p = {"router": (r.randn(d, E) / np.sqrt(d)).astype(np.float32),
         "wi_gate": (r.randn(E, d, f) / np.sqrt(d)).astype(np.float32),
         "wi_up": (r.randn(E, d, f) / np.sqrt(d)).astype(np.float32),
         "wo": (r.randn(E, f, d) / np.sqrt(f)).astype(np.float32)}
    x = r.randn(2, 24, d).astype(np.float32)
    valid = np.arange(24)[None] < np.array([[24], [17]])
    return p, x, valid


EP_CODE = r"""
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import make_mesh
from repro.models import moe
from repro.models.common import ShardCtx
from repro.sharding.rules import ACT_RULES
f = np.load("ep_in.npz")
p = {k: jnp.asarray(f[k]) for k in ("router", "wi_gate", "wi_up", "wo")}
x = jnp.asarray(f["x"], jnp.bfloat16)
mesh = make_mesh((1, 2), ("data", "model"))
shard = ShardCtx(ACT_RULES, mesh)
out = {}
for name, valid in (("all", None), ("valid", jnp.asarray(f["valid"]))):
    y, aux = moe._moe_ep(p, x, 2, shard, valid)
    _, idx, _ = moe._router(p, x.reshape(-1, x.shape[-1]), 2)
    out[name] = np.asarray(y.astype(jnp.float32))
    out[name + "_aux"] = np.asarray(aux)
    out[name + "_idx"] = np.sort(np.asarray(idx), axis=-1)
np.savez("ep_out.npz", **out)
"""


def _two_rank(rank, world, store, tmp):
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import Trainer
    from repro_torch.models import moe
    from repro_torch.models.common import ShardCtx
    from repro_torch.sharding import rules as R
    gloo(rank, world, store)
    tmp = Path(tmp)
    # a JAX Trainer checkpoint onto a (2, 1) mesh
    mesh = make_mesh((2, 1), ("data", "model"), "cpu")
    tr = Trainer(_cfg(), batch=2, seq=16, ckpt_dir=tmp / "jax", mesh=mesh,
                 device="cpu")
    state, start = tr.restore_or_init()
    from repro_torch.checkpoint.ckpt import _sharding_paths
    sh = _sharding_paths(state, tr.state_shardings(state))
    checked = 0
    with np.load(tmp / "jax" / "checkpoint-0.npz") as data:
        for k, v in tree_paths(state):
            if isinstance(v, DTensor):
                assert tuple(v.placements) == tuple(sh[k][1]), k
                sl = R.local_slices(data[k].shape, mesh, v.placements)
                assert np.array_equal(v.to_local().detach().numpy(),
                                      data[k][sl]), k
                checked += 1
            else:
                assert np.array_equal(v.numpy(), data[k]), k
    # expert parallelism on a (1, 2) mesh
    emesh = make_mesh((1, 2), ("data", "model"), "cpu")
    with np.load(tmp / "ep_in.npz") as f:
        p = {k: torch.from_numpy(f[k]) for k in ("router", "wi_gate",
                                                 "wi_up", "wo")}
        x = torch.from_numpy(f["x"]).to(torch.bfloat16)
        valid = torch.from_numpy(f["valid"])
    rep = [Replicate(), Replicate()]
    out = {}
    for name, v in (("all", None), ("valid", valid)):
        y, aux = moe.moe_ffn(
            p, DTensor.from_local(x, emesh, rep, run_check=False), k=2,
            dispatch="ep", valid=v, shard=ShardCtx(R.ACT_RULES, emesh))
        out[name] = y.full_tensor().float().numpy()
        out[name + "_aux"] = aux.full_tensor().numpy()
        out[name + "_placements"] = str(tuple(y.placements))
    if rank == 0:
        np.savez(tmp / "ep_port.npz", start=start, checked=checked, **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_rank(tmp_path_factory):
    """A JAX ``Trainer`` checkpoint (one step of reduced stablelm) and the
    JAX ``_moe_ep`` on 2 host devices, then one spawn of 2 gloo ranks."""
    import jax
    from repro.configs import get_config, reduced
    from repro.launch import train as jtrain
    tmp = tmp_path_factory.mktemp("two_rank")
    jtrain.Trainer(reduced(get_config(ARCH)), batch=2, seq=16,
                   ckpt_dir=tmp / "jax", ckpt_every=1, async_ckpt=False,
                   total_steps=1).run(1)
    p, x, valid = _moe_inputs()
    np.savez(tmp / "ep_in.npz", x=x, valid=valid, **p)
    r = subprocess.run(
        [sys.executable, "-c", EP_CODE], capture_output=True, text=True,
        timeout=300, cwd=tmp,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu",
             "XLA_FLAGS": "--xla_force_host_platform_device_count=2"})
    assert r.returncode == 0, r.stderr[-3000:]
    del jax
    spawn(_two_rank, 2, tmp, str(tmp))
    return tmp


def test_jax_checkpoint_restores_onto_a_mesh(two_rank):
    """Each rank's local shard of every master and moment is its slice of
    the JAX checkpoint's leaf (``local_slices`` under the trainer's
    ``state_shardings``); the step counter whole; training resumes at
    step 1."""
    with np.load(two_rank / "ep_port.npz") as got:
        assert int(got["start"]) == 1
        assert int(got["checked"]) > 20


@pytest.mark.parametrize("case", ["all", "valid"])
def test_moe_ep_matches_jax(two_rank, case):
    """``moe_ffn(dispatch="ep")`` on a (1, 2) gloo mesh (each rank owns 4
    of 8 experts, one all-reduce over "model") against JAX's ``_moe_ep``
    under ``shard_map`` on 2 host devices, with and without right pads."""
    from repro_torch.models import moe
    p, x, valid = _moe_inputs()
    xb = torch.from_numpy(x).to(torch.bfloat16)
    _, idx, _ = moe._router({"router": torch.from_numpy(p["router"])},
                            xb.reshape(-1, x.shape[-1]), 2)
    with np.load(two_rank / "ep_out.npz") as want, \
            np.load(two_rank / "ep_port.npz") as got:
        assert np.array_equal(np.sort(idx.numpy(), axis=-1),
                              want[case + "_idx"])       # no flips
        assert str(got[case + "_placements"]) == \
            "(Shard(dim=0), Replicate())"
        y, w = got[case], want[case]
        for b in range(y.shape[0]):
            assert rel_l2(y[b], w[b]) <= 2e-2, b
        assert abs(float(got[case + "_aux"]) - float(want[case + "_aux"])) \
            <= 1e-5 * abs(float(want[case + "_aux"]))

"""The port's LM training path (``repro_torch.models.lm.chunked_ce_loss`` /
``loss_fn``, ``repro_torch.distributed.fault``, ``repro_torch.launch.train``)
against the JAX package's on the CPU, with the same numpy inputs and
weights (the JAX init's f32 tree, converted leaf for leaf as the trainer's
f32 masters by ``weights.model_params(masters=True)``).

The package's init takes the heads axis of a (d, heads, hd) q/k projection
as its fan-in, so its attention saturates and bf16 gradients through it
drift 0.02-0.06 rel L2 between the packages (measured here, per leaf; the
xLSTM cells and whisper's cross-attention 0.5-1.1). The loss-parity
fixtures scale q/k (and the xLSTM cells) to their real fan-in as
``chip_smoke.fan_in_qk`` does on the card, after which they sit within
0.022.

Tolerances, each against the JAX package on the same inputs:
  ``chunked_ce_loss`` (f32 in, f32 logits): value and gradients within
      1e-5 of their largest magnitude (the same f32 work in other orders);
  ``loss_fn`` (bf16 activations round in other places in XLA and
      PyTorch, and both round their bf16 cotangents): the loss and the MoE
      aux term within 1e-2 relative, every leaf's gradient within 3e-2 rel
      L2 (measured up to 0.022) where no token changed experts between
      the packages; a MoE call's routing flips (a token within bf16 noise
      of a tie takes another expert: its output moves by O(1)) are counted
      as ``tests/test_torch_moe.py`` and ``test_torch_hybrid.py`` count
      them, and a stack with a flip is held by its loss and by the whole
      gradient (all leaves, rel L2 0.1; measured 0.0505 on jamba's one
      flipped token of 32);
  the ``Trainer``'s loss series from the JAX trainer's initial params,
      and continued from a JAX checkpoint: within 2e-2 relative per step
      (bf16 gradient noise through AdamW's normalized steps).
``remat`` is held bit for bit against no remat; checkpoints, token batches
and the fault policies are exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from conftest import make_batch  # noqa: E402
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs import get_config, list_configs, reduced  # noqa: E402
from repro.distributed import fault as jfault  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.common import NO_SHARD  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import reduced as treduced  # noqa: E402
from repro_torch.distributed import fault as tfault  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.common import tree_map, tree_paths  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import fan_in_qk  # noqa: E402
from test_torch_hybrid import Routes  # noqa: E402

LOSS_TOL, GRAD_TOL, FLIP_GRAD_TOL, SERIES_TOL = 1e-2, 3e-2, 1e-1, 2e-2


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def flat(tree) -> dict:
    return {k: (v.detach().float().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v, np.float32)) for k, v in tree_paths(tree)}


# ---------------- chunked_ce_loss ----------------

# (B, S, d, V, chunk, true_vocab, weights): S divisible by the chunk, not
# divisible (15 over 4: chunks of 3), padded vocab entries masked, zero
# weights (a whole row, and all of them: the mean's floor of 1)
CE_CASES = {
    "divisible": (2, 16, 24, 40, 8, None, "ones"),
    "ragged": (2, 15, 24, 40, 4, None, "ones"),
    "true_vocab": (2, 12, 24, 40, 512, 33, "ones"),
    "zero_weights": (3, 10, 24, 40, 4, None, "some"),
    "all_zero": (2, 8, 24, 40, 4, None, "none"),
}


@pytest.mark.parametrize("name", list(CE_CASES))
def test_chunked_ce_loss_matches_jax(name):
    """The value and its gradients with respect to x and ``head_w`` (f32
    inputs) against JAX's ``chunked_ce_loss`` under ``jax.value_and_grad``
    on the same numpy inputs."""
    B, S, d, V, chunk, true_vocab, wkind = CE_CASES[name]
    r = np.random.RandomState(3)
    x = r.randn(B, S, d).astype(np.float32)
    head = (r.randn(d, V) / np.sqrt(d)).astype(np.float32)
    labels = r.randint(0, true_vocab or V, (B, S)).astype(np.int32)
    w = {"ones": np.ones((B, S)), "none": np.zeros((B, S)),
         "some": (r.rand(B, S) < 0.6) * np.arange(B)[:, None].clip(0, 1)
         }[wkind].astype(np.float32)

    def jf(h, xx):
        return jlm.chunked_ce_loss(h, xx, jnp.asarray(labels),
                                   jnp.asarray(w), NO_SHARD, chunk=chunk,
                                   true_vocab=true_vocab)
    jv, (jgh, jgx) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(head), jnp.asarray(x))
    th = torch.tensor(head, requires_grad=True)
    tx = torch.tensor(x, requires_grad=True)
    tv = tlm.chunked_ce_loss(th, tx, torch.tensor(labels), torch.tensor(w),
                             chunk=chunk, true_vocab=true_vocab)
    tgh, tgx = torch.autograd.grad(tv, (th, tx))
    assert abs(tv.item() - float(jv)) <= 1e-5 * max(abs(float(jv)), 1.0)
    for got, want in ((tgh, jgh), (tgx, jgx)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= \
            1e-5 * max(np.abs(want).max(), 1e-6)


# ---------------- loss_fn ----------------

def _pair(arch, seed=0):
    """(JAX config, port config, JAX params (jnp), port f32 masters on the
    CPU requiring grad): the JAX init's tree with q/k (and the xLSTM
    cells) at their real fan-in."""
    cfg, tcfg = reduced(get_config(arch)), treduced(tget(arch))
    tree = jax.tree.map(np.asarray,
                        jlm.init_model(jax.random.PRNGKey(seed), cfg))
    tp = weights.model_params(tree, "cpu", masters=True)
    fan_in_qk(tp, tcfg)
    jp = tree_map(lambda t: jnp.asarray(t.numpy().copy()), tp)
    return cfg, tcfg, jp, tree_map(lambda t: t.requires_grad_(True), tp)


def _port_batch(batch):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def _port_grads(tp, tcfg, batch, remat=True):
    leaves = [t for _, t in tree_paths(tp)]
    loss, metrics = tlm.loss_fn(tp, tcfg, _port_batch(batch), remat=remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss, metrics, {k: (np.zeros(t.shape, np.float32) if g is None
                               else g.float().numpy())
                           for (k, t), g in zip(tree_paths(tp), grads)}


def _flips(routes, cfg, tcfg, jp, tp, batch):
    """Tokens whose expert set differs between the packages, per MoE call
    of one forward (a forward-only run of both on the batch)."""
    del routes.jax[:], routes.port[:]
    kw = {k: batch[k] for k in ("tokens", "embeds", "enc_embeds", "pos3")
          if k in batch}
    jlm.forward(jp, cfg, **kw)
    with torch.no_grad():
        tlm.forward(tp, tcfg, **_port_batch(kw))
    assert len(routes.jax) == len(routes.port)
    return [int((a != b).any(-1).sum()) for a, b in zip(routes.jax,
                                                        routes.port)]


LOSS_CASES = [(arch, False) for arch in list_configs()] + \
    [("stablelm-1.6b", True)]


@pytest.mark.parametrize("arch,labels", LOSS_CASES,
                         ids=[a + ("-labels" if lb else "")
                              for a, lb in LOSS_CASES])
def test_loss_fn_matches_jax(arch, labels, monkeypatch, capsys):
    """One step's loss, its aux term and every leaf's gradient against
    ``jax.value_and_grad(lm.loss_fn, has_aux=True)`` at B 2, S 16
    (``make_batch``; ``labels``: a token batch given labels, the labels
    case of a token model), with the MoE routing flips counted."""
    cfg, tcfg, jp, tp = _pair(arch)
    batch = make_batch(cfg, 2, 16, seed=1)
    if labels:
        batch["labels"] = jnp.asarray(
            np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 16)),
            jnp.int32)
    flips = _flips(Routes(monkeypatch), cfg, tcfg, jp, tp, batch)
    (jl, jm), jg = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
        jp, cfg, batch)
    tl, tm, tg = _port_grads(tp, tcfg, batch)
    jg = flat(jg)
    assert sorted(tg) == sorted(jg)
    rels = {k: rel_l2(tg[k], jg[k]) for k in tg if np.any(jg[k])}
    whole = rel_l2(np.concatenate([tg[k].ravel() for k in sorted(tg)]),
                   np.concatenate([jg[k].ravel() for k in sorted(jg)]))
    with capsys.disabled():
        print(f"\n{arch}{' labels' if labels else ''}: loss {float(jl):.6f} "
              f"/ {tl.item():.6f}, aux {float(jm['aux']):.6f} / "
              f"{tm['aux'].item():.6f}, worst leaf "
              f"{max(rels.values()):.4f}, whole {whole:.4f}, flips {flips}")
    assert abs(tl.item() - float(jl)) <= LOSS_TOL * abs(float(jl))
    assert abs(tm["aux"].item() - float(jm["aux"])) <= \
        LOSS_TOL * max(abs(float(jm["aux"])), 1e-6)
    assert all(np.all(tg[k] == 0) for k in tg if not np.any(jg[k]))
    if sum(flips) == 0:
        assert max(rels.values()) <= GRAD_TOL, \
            sorted(rels.items(), key=lambda kv: -kv[1])[:3]
    else:
        assert sum(flips) <= 2 and whole <= FLIP_GRAD_TOL


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "whisper-base",
                                  "olmoe-1b-7b", "xlstm-125m"])
def test_loss_fn_remat_is_exact(arch):
    """``remat=True`` (each period recomputed in the backward, the
    encoder's too) gives the loss, the aux term and every gradient of
    ``remat=False`` bit for bit on the CPU."""
    cfg, tcfg, _, tp = _pair(arch)
    batch = make_batch(cfg, 2, 16, seed=4)
    a = _port_grads(tp, tcfg, batch, remat=True)
    b = _port_grads(tp, tcfg, batch, remat=False)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1]["aux"], b[1]["aux"])
    assert all(np.array_equal(a[2][k], b[2][k]) for k in a[2])


# ---------------- the trainer ----------------

STABLELM = "stablelm-1.6b"


def test_trainer_restart_continues(tmp_path):
    """``tests/test_checkpoint.py::test_trainer_restart_continues`` on the
    port: the failure at step 12 fires, the run resumes from the step-10
    checkpoint and finishes every step."""
    cfg = treduced(tget(STABLELM))
    tr = ttrain.Trainer(cfg, batch=2, seq=16, ckpt_dir=tmp_path,
                        ckpt_every=5, lr=1e-3, total_steps=18,
                        async_ckpt=False, device="cpu")
    inj = tfault.FailureInjector(fail_at_step=12)
    losses = tr.run(18, injector=inj)
    assert inj.fired
    assert len(losses) >= 18
    assert tckpt.latest_step(tmp_path) == 17
    assert all(np.isfinite(losses))


def _jax_trainer(tmp_path, steps, ckpt_every=100):
    cfg = reduced(get_config(STABLELM))
    return jtrain.Trainer(cfg, batch=2, seq=16, ckpt_dir=tmp_path,
                          ckpt_every=ckpt_every, lr=1e-3, total_steps=steps,
                          async_ckpt=False)


def _port_trainer(tmp_path, steps, params, ckpt_every=100):
    return ttrain.Trainer(treduced(tget(STABLELM)), batch=2, seq=16,
                          ckpt_dir=tmp_path, ckpt_every=ckpt_every, lr=1e-3,
                          total_steps=steps, async_ckpt=False, device="cpu",
                          params=params)


def _series_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= SERIES_TOL * np.abs(want)), \
        (got, want)


def test_trainer_loss_series_matches_jax(tmp_path):
    """Ten steps of the port's ``Trainer`` from the JAX trainer's initial
    params (its ``PRNGKey(0)`` draw, converted as f32 masters) against the
    JAX ``Trainer``'s own ten, on the same token batches (both pipelines
    seeded 0) under the same AdamW and cosine schedule."""
    jtr = _jax_trainer(tmp_path / "j", 10)
    init = jax.tree.map(np.asarray, jtr.init_state()["params"])
    want = jtr.run(10)
    got = _port_trainer(tmp_path / "t", 10,
                        weights.model_params(init, "cpu", masters=True)
                        ).run(10)
    _series_close(got, want)


def test_trainer_continues_a_jax_checkpoint(tmp_path):
    """A checkpoint the JAX ``Trainer`` wrote (params and AdamW state at
    step 5) restores in the port's ``Trainer`` (the optimizer's step count
    and moments with it) and continues to step 9 as the JAX trainer
    continues from the same checkpoint."""
    jtr = _jax_trainer(tmp_path, 6, ckpt_every=5)
    init = jax.tree.map(np.asarray, jtr.init_state()["params"])
    jtr.run(6)
    assert jckpt.latest_step(tmp_path) == 5
    tr = _port_trainer(tmp_path, 10, weights.model_params(
        init, "cpu", masters=True), ckpt_every=100)
    state, start = tr.restore_or_init()
    assert start == 6 and int(state["opt"].step) == 6
    with np.load(tmp_path / "checkpoint-5.npz") as data:
        for k, v in tree_paths(state):
            assert np.array_equal(v.detach().numpy(), data[k]), k
    # both continue from step 5's checkpoint over fresh pipelines; the
    # final save (step 9) lands in the directory either way, so each runs
    # on its own copy
    import shutil
    shutil.copytree(tmp_path, tmp_path / "port", ignore=shutil.ignore_patterns(
        "port", "jax"))
    shutil.copytree(tmp_path, tmp_path / "jax", ignore=shutil.ignore_patterns(
        "port", "jax"))
    got = _port_trainer(tmp_path / "port", 10, weights.model_params(
        init, "cpu", masters=True)).run(10)
    want = _jax_trainer(tmp_path / "jax", 10).run(10)
    assert len(got) == len(want) == 4
    _series_close(got, want)


def test_fault_policies_match_jax():
    """``FailureInjector`` and ``StragglerDetector`` (with a mitigation
    hook) against the JAX package's on the same event sequences: the same
    raises, flags, events and hook calls."""
    for fail_at in (None, 0, 7):
        got, want = [], []
        for mod, out in ((tfault, got), (jfault, want)):
            inj = mod.FailureInjector(fail_at)
            for step in list(range(12)) + [7, 7]:
                try:
                    inj.check(step)
                    out.append(("ok", step))
                except mod.InjectedFailure as e:
                    out.append(("raised", str(e)))
            out.append(inj.fired)
        assert got == want
    r = np.random.RandomState(0)
    durations = list(r.uniform(0.09, 0.11, 40))
    durations[12:16] = [0.5] * 4
    durations[25:27] = [0.3, 0.05]
    durations[30:35] = [1.0] * 5
    for threshold, patience in ((2.0, 3), (2.0, 1), (1.5, 2)):
        got, want = [], []
        for mod, out in ((tfault, got), (jfault, want)):
            calls = []
            sd = mod.StragglerDetector(threshold, patience,
                                       on_straggler=calls.append)
            flags = [sd.record(i, t) for i, t in enumerate(durations)]
            out.extend([flags, sd.events, calls, sd.slow_streak])
        assert got == want
    assert issubclass(tfault.InjectedFailure, RuntimeError)


def test_serving_faults_raise_the_trainers_failure_type():
    """The serving plane's injected faults raise the one
    ``InjectedFailure`` the training plane defines, as in the JAX
    package."""
    from repro_torch.serving import faults
    assert faults.InjectedFailure is tfault.InjectedFailure


def test_trainer_refuses_a_mesh(tmp_path):
    """A mesh that is not a ``DeviceMesh`` (the trainer on a mesh is held
    in ``tests/test_torch_mesh.py``)."""
    with pytest.raises(TypeError, match="mesh"):
        ttrain.Trainer(treduced(tget(STABLELM)), batch=2, seq=16,
                       ckpt_dir=tmp_path, mesh=object(), device="cpu")


def test_train_launcher_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu`` (its ``main``):
    reduced qwen2-7b, a few steps, finite losses, the summary line."""
    losses = ttrain.main(["--device", "cpu", "--steps", "4", "--batch", "2",
                          "--seq", "16", "--ckpt", str(tmp_path)])
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert "arch=qwen2-7b-smoke steps=4" in capsys.readouterr().out
    assert tckpt.latest_step(tmp_path) == 3

"""The port's task API (``repro_torch.taskapi``), optimizer, token pipeline
and tree checkpoints against the JAX package's, on the CPU at reduced
moment-large (2 layers, d 64, 4 heads of 16).

Both pipelines hold the same JAX-initialised backbone (converted by
``repro_torch.weights.model_params``) and extension state (``weights.
extension_state``) and see the same numpy batches. The package's init takes
the heads axis of a (d, heads, hd) q/k projection as its fan-in, so its
queries and keys come out sqrt(d / heads) = 4x too large and the attention
saturates: bf16 runs of the same function then drift 0.2 rel L2 apart in
the gradients that cross the backbone (measured: the port's own bf16
gradient 0.21-0.23 from its f32 one). The parity fixtures scale q/k to their
real fan-in (as chip_smoke.fan_in_qk does on the card), after which the
port's bf16 and f32 gradients sit within 0.01 of each other.

Tolerances, each against the JAX package's result on the same inputs
(bf16 activations round in other places in XLA and PyTorch, and both
gradients round their bf16 cotangents):
  ``Pipeline.run`` outputs                    rel L2 <= 1e-2
  one step's loss                             rel     <= 1e-2
  its gradient, per leaf group                rel L2 <= 3e-2
  the loss series of 10 steps (mse, ce)       rel     <= 1e-2 per step
(measured: 0.008, 0.002, 0.011 and 0.004).
AdamW and its schedule compute in f32 on both sides: <= 1e-6 of each leaf's
largest magnitude. Token batches, artifacts and checkpoints are exact.
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

import repro.taskapi as jt  # noqa: E402
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs import get_config, reduced  # noqa: E402
from repro.data.tokens import TokenPipeline as JTokens  # noqa: E402
from repro.optim import adamw as jopt  # noqa: E402
from repro.taskapi import artifacts as jart  # noqa: E402
import repro_torch.taskapi as tt  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.checkpoint import ckpt as tckpt  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import reduced as treduced  # noqa: E402
from repro_torch.data.tokens import TokenPipeline as TTokens  # noqa: E402
from repro_torch.models.common import tree_paths  # noqa: E402
from repro_torch.optim import adamw as topt  # noqa: E402
from repro_torch.taskapi import artifacts as tart  # noqa: E402

ARCH = "moment-large"
RUN_TOL, LOSS_TOL, GRAD_TOL, SERIES_TOL = 1e-2, 1e-2, 3e-2, 1e-2


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def flat(tree) -> dict:
    """``/``-joined path -> numpy of a JAX or a port tree."""
    out = {}
    for k, v in tree_paths(tree):
        out[k] = v.detach().float().numpy() if isinstance(v, torch.Tensor) \
            else np.asarray(v, np.float32)
    return out


def group_rel(got, want) -> float:
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    return rel_l2(np.concatenate([g[k].ravel() for k in sorted(g)]),
                  np.concatenate([w[k].ravel() for k in sorted(w)]))


def fan_in_qk(params, cfg):
    """q/k projections of a numpy backbone tree scaled to their real
    fan-in, sqrt(heads / d_model) (see the module docstring)."""
    for sub in params["layers"]:
        for w, heads in (("wq", cfg.num_heads), ("wk", cfg.num_kv_heads)):
            sub["attn"][w] = (sub["attn"][w] * np.float32(
                (heads / cfg.d_model) ** 0.5)).astype(np.float32)


def build_pair(out_dim: int, seed: int = 5):
    """A JAX pipeline and a port pipeline (on the CPU) with the same
    backbone and extension state: LinearChannelCombiner(3 -> 1, patch 8),
    MLPDecoder(d, 16, out_dim), a rank-4 adapter whose B leaves are drawn
    (at init they are zero, and so would the A leaves' gradient be)."""
    cfg = reduced(get_config(ARCH))
    tcfg = treduced(tget(ARCH))
    bb = jax.tree.map(np.asarray, jt.vFM(cfg).params)
    fan_in_qk(bb, cfg)
    J = jt.Pipeline(jt.vFM(cfg, params=jax.tree.map(jnp.asarray, bb)),
                    task_id="hr")
    J.add_encoder(jt.LinearChannelCombiner(3, 1, 8, cfg.d_model))
    J.add_decoder(jt.MLPDecoder(cfg.d_model, 16, out_dim))
    J.attach_adapter(jt.Adapter(rank=4, adapter_id="hr_lora"))
    state = jax.tree.map(np.asarray, J.state)
    r = np.random.RandomState(seed)
    for sub in state["adapter"]:
        for k in ("q", "v"):
            sub[k]["b"] = (r.randn(*sub[k]["b"].shape) * 0.05).astype(
                np.float32)
    J.state = jax.tree.map(jnp.asarray, state)
    T = tt.Pipeline(tt.vFM(tcfg, params=weights.model_params(bb, "cpu"),
                           device="cpu"), task_id="hr")
    T.add_encoder(tt.LinearChannelCombiner(3, 1, 8, tcfg.d_model))
    T.add_decoder(tt.MLPDecoder(tcfg.d_model, 16, out_dim))
    T.attach_adapter(tt.Adapter(rank=4, adapter_id="hr_lora"))
    T.state = weights.extension_state(state, device="cpu")
    return J, T, state


def reset(J, T, state):
    """Both pipelines back to the drawn extension state."""
    J.state = jax.tree.map(jnp.asarray, state)
    T.state = weights.extension_state(state, device="cpu")


def batches(seed, n_class=None, B=16):
    """Endless (x (B, 64, 3), y) batches: y the regression target of
    ``tests/test_taskapi.py``, or (``n_class``) its class by quantile."""
    r = np.random.RandomState(seed)
    while True:
        x = r.randn(B, 64, 3).astype(np.float32)
        y = (x[:, :, 0].mean(axis=1) * 5.0 + 1.0)[:, None]
        if n_class is not None:
            y = np.clip(((y[:, 0] - 1.0) * 2.0 + n_class / 2), 0,
                        n_class - 1).astype(np.int32)
        yield x, y


@pytest.fixture(scope="module")
def pairs():
    return {"mse": build_pair(1), "ce": build_pair(4)}


def jax_loss_and_grad(J, x, y, loss):
    def loss_fn(tp):
        pred = J._forward(tp, jnp.asarray(x))
        if loss == "mse":
            return jnp.mean((pred - jnp.asarray(y)) ** 2)
        logp = jax.nn.log_softmax(pred, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                             axis=-1))
    return jax.value_and_grad(loss_fn)(J.state)


def test_run_matches_jax(pairs):
    """16 rows (3 scalar outputs near zero make a rel L2 of noise: 0.013
    measured there against 0.008 over 16)."""
    J, T, _ = pairs["mse"]
    x = np.random.RandomState(0).randn(16, 64, 3).astype(np.float32)
    got = T.run(x)
    assert got.shape == (16, 1) and got.dtype == torch.float32
    assert rel_l2(got.numpy(), np.asarray(J.run(x))) <= RUN_TOL


@pytest.mark.parametrize("loss", ["mse", "ce"])
def test_step_loss_and_grads_match_jax(pairs, loss):
    """One step's loss and its gradient, per leaf group (encoder, adapter,
    decoder), against ``jax.value_and_grad`` of the JAX loss."""
    J, T, _ = pairs[loss]
    x, y = next(batches(1, None if loss == "mse" else 4))
    lj, gj = jax_loss_and_grad(J, x, y, loss)
    parts = {k: T.state[k] for k in ("encoder", "decoder", "adapter")}
    lt, gt = T.loss_and_grad(parts, x, y, loss=loss)
    assert abs(float(lt) - float(lj)) <= LOSS_TOL * abs(float(lj))
    for group in ("encoder", "adapter", "decoder"):
        assert group_rel(gt[group], gj[group]) <= GRAD_TOL, group


@pytest.mark.parametrize("loss", ["mse", "ce"])
def test_loss_series_matches_jax(pairs, loss):
    """Ten steps of ``train`` (AdamW, lr 5e-3) from the same state on the
    same batches: the two loss series step by step."""
    J, T, state = pairs[loss]
    n = None if loss == "mse" else 4
    lj = J.train(batches(2, n), steps=10, lr=5e-3, loss=loss)
    lt = T.train(batches(2, n), steps=10, lr=5e-3, loss=loss)
    reset(J, T, state)
    assert len(lt) == 10
    np.testing.assert_allclose(lt, lj, rtol=SERIES_TOL)


# ---------------- tests/test_taskapi.py's checks on the port ----------------

@pytest.fixture(scope="module")
def pipeline():
    """The JAX test's pipeline on the port: reduced moment-large drawn by
    the port from seed 0 on the CPU, no rescaling."""
    tcfg = treduced(tget(ARCH))
    P = tt.Pipeline(tt.vFM(tcfg, device="cpu"), task_id="hr")
    P.add_encoder(tt.LinearChannelCombiner(3, 1, 8, tcfg.d_model))
    P.add_decoder(tt.MLPDecoder(tcfg.d_model, 16, 1))
    P.attach_adapter(tt.Adapter(rank=4, adapter_id="hr_lora"))
    return P


def test_port_run_shapes(pipeline):
    y = pipeline.run(np.random.RandomState(0).randn(3, 64, 3).astype(
        np.float32))
    assert y.shape == (3, 1)


def test_port_train_improves_loss(pipeline):
    losses = pipeline.train(batches(0), steps=80, lr=5e-3, loss="mse")
    assert min(losses[-10:]) < losses[0] * 0.5


def test_port_backbone_frozen_during_train(pipeline):
    before = {k: v.clone() for k, v in tree_paths(pipeline.vfm.params)}
    pipeline.train(batches(1, B=4), steps=3, lr=1e-2)
    after = dict(tree_paths(pipeline.vfm.params))
    assert sorted(after) == sorted(before)
    for k, v in after.items():
        assert not v.requires_grad and torch.equal(v, before[k]), k


def test_port_adapter_changes_output(pipeline):
    x = np.random.RandomState(2).randn(2, 64, 3).astype(np.float32)
    y_with = pipeline.run(x)
    state = pipeline.state["adapter"]
    pipeline.state["adapter"] = None
    y_without = pipeline.run(x)
    pipeline.state["adapter"] = state
    # the adapter was trained above (its B leaves left zero) -> it must
    # move the output
    assert any(t["q"]["b"].abs().max() > 0 for t in state)
    assert not torch.allclose(y_with, y_without)


def test_port_artifact_roundtrip(pipeline):
    art = pipeline.package(weight=2.0, slo_s=0.5, demand_rps=3.0)
    art2 = tart.deserialize(tart.serialize(art))
    assert art2["meta"]["task_id"] == "hr"
    assert art2["meta"]["backbone"] == pipeline.vfm.cfg.name
    spec = tart.task_spec(art)
    assert spec["weight"] == 2.0 and spec["demand_rps"] == 3.0
    for group in ("encoder_weights", "decoder_weights"):
        assert sorted(art2[group]) == sorted(art[group])
        for k, v in art[group].items():
            np.testing.assert_array_equal(art2[group][k], v)


def test_artifacts_cross_packages(pairs):
    """An artifact serialized by either package deserializes in the other
    with the same metadata and arrays."""
    J, T, _ = pairs["mse"]
    for src, dst, pipe in ((jart, tart, J), (tart, jart, T)):
        art = pipe.package(weight=2.0, slo_s=0.5, demand_rps=3.0)
        got = dst.deserialize(src.serialize(art))
        want = src.deserialize(src.serialize(art))
        assert got["meta"] == want["meta"] == art["meta"]
        for group in ("encoder_weights", "decoder_weights",
                      "adapter_weights"):
            assert sorted(got[group]) == sorted(want[group])
            for k in want[group]:
                np.testing.assert_array_equal(got[group][k], want[group][k])
    # the two packages name every leaf alike
    ja = jart.deserialize(jart.serialize(J.package()))
    ta = tart.deserialize(tart.serialize(T.package()))
    for group in ("encoder_weights", "decoder_weights", "adapter_weights"):
        assert sorted(ja[group]) == sorted(ta[group])
    assert tart.task_spec(T.package()) == jart.task_spec(J.package())


# ---------------- the optimizer ----------------

def _opt_tree(r):
    return {"enc": {"w": r.randn(4, 3).astype(np.float32),
                    "b": r.randn(3).astype(np.float32)},
            "ada": [{"a": r.randn(2, 5).astype(np.float32)}, {}]}


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_adamw_matches_jax(schedule):
    """Five updates with gradients of global norm ~10 (clipping active at
    clip_norm 1), decay 0.1: the parameters, moments and norms f32-close."""
    r = np.random.RandomState(7)
    p0 = _opt_tree(r)
    grads = [jax.tree.map(lambda a: (a * 3.0).astype(np.float32),
                          _opt_tree(r)) for _ in range(5)]
    lr = 1e-2 if schedule == "constant" else None
    jo = jopt.AdamW(lr=lr or jopt.cosine_schedule(1e-2, 2, 5))
    to = topt.AdamW(lr=lr or topt.cosine_schedule(1e-2, 2, 5))
    jp, js = jax.tree.map(jnp.asarray, p0), None
    tp = jax.tree.map(torch.from_numpy, p0)
    tp["ada"] = list(tp["ada"])
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js, jinfo = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tg = jax.tree.map(torch.from_numpy, g)
        tp, ts, tinfo = to.update(tg, ts, tp)
        assert float(jinfo["grad_norm"]) > 1.0
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tinfo["lr"]), float(jinfo["lr"]),
                                   rtol=1e-6)
        for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
            g2, w2 = flat(got), flat(want)
            assert sorted(g2) == sorted(w2)
            for k in w2:
                assert np.abs(g2[k] - w2[k]).max() <= \
                    1e-6 * np.abs(w2[k]).max(), k
    assert int(ts.step) == int(js.step) == 5


# ---------------- the token pipeline ----------------

@pytest.mark.parametrize("arch", ["stablelm-1.6b", "moment-large",
                                  "whisper-base", "qwen2-vl-72b"])
def test_token_pipeline_matches_jax(arch):
    """Three batches from seed 3: the same keys and equal arrays."""
    jp = JTokens(reduced(get_config(arch)), 2, 12, seed=3)
    tp = TTokens(treduced(tget(arch)), 2, 12, seed=3)
    for _ in range(3):
        jb, tb = next(jp), next(tp)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])


# ---------------- tree checkpoints ----------------

def _ckpt_tree(r):
    return {"params": {"w": r.randn(3, 4).astype(np.float32),
                       "h": r.randn(5).astype(np.float32),
                       "n": np.arange(6, dtype=np.int32)},
            "layers": [{"a": r.randn(2, 2).astype(np.float32)},
                       {"a": r.randn(2, 2).astype(np.float32)}]}


def _torch_tree(t):
    out = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), t)
    out["params"]["h"] = out["params"]["h"].to(torch.bfloat16)
    out["layers"] = list(out["layers"])
    return out


@pytest.mark.parametrize("blocking", [True, False])
def test_checkpoints_cross_packages(tmp_path, blocking):
    """A checkpoint saved by either package (a bf16 leaf among f32 and int
    ones, lists and dicts) restores in the other: same keys, files and
    values, each leaf in the target tree's dtype."""
    r = np.random.RandomState(11)
    tree = _ckpt_tree(r)
    jtree = jax.tree.map(jnp.asarray, tree)
    jtree["params"]["h"] = jtree["params"]["h"].astype(jnp.bfloat16)
    ttree = _torch_tree(tree)
    # JAX saves at step 3, the port restores
    th = jckpt.save(tmp_path / "j", 3, jtree, blocking=blocking)
    if th is not None:
        th.join(timeout=60)
    like = jax.tree.map(torch.zeros_like, ttree)
    got, step = tckpt.restore(tmp_path / "j", like)
    assert step == 3 == tckpt.latest_step(tmp_path / "j")
    assert isinstance(got["layers"], list)
    for (k, g), (_, w) in zip(tree_paths(got), tree_paths(ttree)):
        assert g.dtype == w.dtype and torch.equal(g, w), k
    # the port saves at steps 2 and 7, JAX restores the latest
    tckpt.save(tmp_path / "t", 2, ttree)
    th = tckpt.save(tmp_path / "t", 7, ttree, blocking=blocking)
    if th is not None:
        assert isinstance(th, threading.Thread)
        th.join(timeout=60)
        assert not th.is_alive()
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == sorted(
        f"checkpoint-{s}.{e}" for s in (2, 7) for e in ("npz", "meta.json"))
    jgot, step = jckpt.restore(tmp_path / "t", jtree)
    assert step == 7 == jckpt.latest_step(tmp_path / "t")
    for (k, g), (_, w) in zip(tree_paths(jgot), tree_paths(jtree)):
        assert np.asarray(g).dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(np.asarray(g, np.float32),
                                      np.asarray(w, np.float32))
    with pytest.raises(FileNotFoundError):
        tckpt.restore(tmp_path / "none", like)
    with pytest.raises(KeyError):
        tckpt.restore(tmp_path / "t", dict(like, extra=torch.zeros(1)))


def test_vfm_defaults_to_the_card():
    """The task API's entry points run on the card unless the caller asks
    for the CPU: a vFM without a device is a CUDA one, and so is the
    generator its pipeline draws extensions from."""
    cfg = treduced(tget(ARCH))
    v = tt.vFM(cfg, params={})
    assert v.device == torch.device("cuda")

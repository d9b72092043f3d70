"""The port's representation path against the JAX package's, on reduced
moment-large (2 layers, d 64, hd 16, bidirectional) with the JAX weights
and adapters converted to the port:

* ``lm.backbone_features`` against JAX ``lm.backbone_features``, and the
  mask shown non-causal (a planted causal mask fails the check);
* ``PhysicalFM.run_batch`` pinned to "segmented" and to "gather" against
  the JAX ``PhysicalFM.run_batch`` (mixed adapters, the "no adapter"
  sentinel, a batch that pads to its bucket);
* ``lora_impl="auto"``: the table covers every cell, buckets round up,
  explicit impls pass through, auto serving equals the pinned path the
  table names, the decode engine resolves from its slot bucket, and no
  shape key is added within slot capacity — held against the port's own
  table (whatever its cells say), not the JAX package's CPU cells;
* the executor's device head and its numpy-bound fallback;
* the system behaviour of ``tests/test_system.py`` (co-batching, per-task
  heads, outputs that differ by adapter, accounting, rebind, add/remove)
  on a fixed ``FMProfile`` (no calibration by wall clock);
* the port's ``DecodeEngine`` refusing a representation backbone, and
  ``python -m repro_torch.launch.serve --device cpu --reduced``.

Tolerance: as in tests/test_torch_models.py, both sides keep activations in
bf16 and round after every op in a different order, so the bound is the
bf16 noise floor over the whole tensor (relative L2) plus a per-element
ceiling that a wrong op, O(1), would break. The adapters are random at a
scale (0.2) where each moves the features far past the bounds:

  quantity                          measured (rel-L2, max)   bound        dropped / swapped adapters
  backbone features (|h| < 3.6)     9.2e-3, 0.086            2e-2, 0.3
  pooled features, either impl      1.34e-2, 0.023           2e-2, 0.05   0.46, 0.93 / 0.47, 0.86
  (|f| < 1.4)

``test_parity_bounds_catch_adapter_faults`` holds a 4x margin.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core.physical import PhysicalFM as JPhysicalFM  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import physical  # noqa: E402
from repro_torch.core.decode_engine import DecodeEngine  # noqa: E402
from repro_torch.core.executor import Executor  # noqa: E402
from repro_torch.core.physical import (AUTO_LORA_TABLE, BUCKETS,  # noqa: E402
                                       NA_BUCKETS, PhysicalFM)
from repro_torch.core.profile import FMProfile  # noqa: E402
from repro_torch.core.request import SLO, Batch, Request  # noqa: E402
from repro_torch.core.server import FMplexServer  # noqa: E402
from repro_torch.core.vfm import TaskExtensions  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite runs in parallel workers on shared
    cores, and some JAX tests time their own calibration."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


HIDDEN_TOL = (2e-2, 0.3)      # (relative L2, max abs)
FEATURE_TOL = (2e-2, 0.05)
ADAPTER_SCALE = 0.2
BT = 8
S = 12                        # patches a request (no segment a block multiple)
# a fixed profile: l(b) = 2 ms + 1 ms * b, knee at 8 (no wall-clock calibration)
PROFILE = FMProfile(name="moment-large-smoke", alpha=2e-3, beta=1e-3, b_max=8)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def bf16_err(got, want):
    got, want = _f32(got), _f32(want)
    return (float(np.linalg.norm(got - want) / np.linalg.norm(want)),
            float(np.abs(got - want).max()))


def assert_bf16_close(got, want, tol):
    rel, worst = bf16_err(got, want)
    assert rel <= tol[0] and worst <= tol[1], (rel, worst)


def _shapes(tree, path=""):
    """{path: shape} of every leaf of a nested dict/list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: tuple(tree.shape)}
    out = {}
    for k, v in items:
        out.update(_shapes(v, f"{path}/{k}"))
    return out


def _randomized_adapter(jfm, i):
    """A JAX adapter tree with random A and B (B is zero when fresh)."""
    tree = jfm.adapters._mod.init_single_adapter(
        jax.random.PRNGKey(i), jfm.cfg, jfm.adapters.rank)
    leaves, tdef = jax.tree.flatten(tree)
    ks = jax.random.split(jax.random.PRNGKey(100 + i), len(leaves))
    return jax.tree.unflatten(tdef, [
        jax.random.normal(k, leaf.shape, leaf.dtype) * ADAPTER_SCALE
        for k, leaf in zip(ks, leaves)])


def _port_fm(np_params, cfg, trees, impl):
    fm = PhysicalFM(cfg, seed=0, input_len=S, lora_rank=4, lora_impl=impl,
                    seg_block_t=BT, device="cpu",
                    params=weights.to_torch(np_params, device="cpu"))
    for name, tree in trees.items():
        fm.adapters.add(name, weights.adapter_tree(tree, device="cpu"))
    return fm


@pytest.fixture(scope="module")
def fms():
    """JAX FMs pinned to each impl, and the port's FMs (segmented, gather,
    auto) on the same weights and three random adapters."""
    jcfg = jreduced(jget_config("moment-large"))
    cfg = reduced(get_config("moment-large"))
    jfms, trees = {}, {}
    for impl in ("segmented", "gather"):
        jfm = JPhysicalFM(jcfg, seed=0, input_len=S, lora_rank=4,
                          lora_impl=impl, seg_block_t=BT)
        for i in range(3):
            tree = _randomized_adapter(jfm, i)
            jfm.adapters.add(f"lora{i}", tree)
            trees[f"lora{i}"] = jax.tree.map(np.asarray, tree)
        jfms[impl] = jfm
    np_params = jax.tree.map(np.asarray, jfms["gather"].params)
    port = {impl: _port_fm(np_params, cfg, trees, impl)
            for impl in ("segmented", "gather", "auto")}
    return jcfg, cfg, jfms, port, np_params, trees


def _inputs(cfg, fm, n=5, seed=0):
    """Mixed adapters, two "no adapter" rows and 5 rows (pads to 8)."""
    x = np.random.RandomState(seed).randn(n, S, cfg.d_model).astype(np.float32)
    cap = fm.adapters.capacity()
    return x, np.array([0, 2, cap, 1, cap][:n], np.int32)


# ---------------- model ----------------

def test_trees_carry_leaf_for_leaf(fms):
    """The reduced tree has the unused 256 x d embed AND a (d, d) head; the
    full tree has no embed: both match the JAX package's leaf for leaf."""
    jcfg, cfg, jfms, port, np_params, _ = fms
    params = weights.model_params(np_params, device="cpu")
    assert params["embed"].shape == (256, cfg.d_model)
    assert params["embed"].dtype == torch.bfloat16
    assert params["head"].shape == (cfg.d_model, cfg.d_model)
    assert params["head"].dtype == torch.float32
    for name in ("moment-large", None):
        pcfg = get_config("moment-large") if name else cfg
        jc = jget_config("moment-large") if name else jcfg
        assert _shapes(lm.model_spec(pcfg)) == \
            _shapes(jlm.model_structs(jc)), name
    assert "embed" not in lm.model_spec(get_config("moment-large"))


def test_backbone_features_match_jax(fms):
    jcfg, cfg, jfms, port, np_params, _ = fms
    x = np.random.RandomState(3).randn(3, S, cfg.d_model).astype(np.float32)
    want = jlm.backbone_features(jfms["gather"].params, jcfg, x)
    got = lm.backbone_features(port["gather"].params, cfg, torch.tensor(x))
    assert got.shape == (3, S, cfg.d_model)
    assert_bf16_close(got, want, HIDDEN_TOL)


def test_attention_is_not_causal(fms):
    """Changing the LAST patch moves the FIRST position's features; the same
    check on the same weights with a causal mask planted (the decoder's
    forward) sees no change, so the check can tell the two apart."""
    _, cfg, _, port, _, _ = fms
    params = port["gather"].params
    x = np.random.RandomState(4).randn(2, S, cfg.d_model).astype(np.float32)
    x2 = x.copy()
    x2[:, -1] += 1.0
    f1 = lm.backbone_features(params, cfg, torch.tensor(x))
    f2 = lm.backbone_features(params, cfg, torch.tensor(x2))
    assert (f1[:, 0] - f2[:, 0]).abs().max().item() > HIDDEN_TOL[1]
    causal = dataclasses.replace(cfg, is_representation=False)
    c1, _ = lm.forward(params, causal, embeds=torch.tensor(x))
    c2, _ = lm.forward(params, causal, embeds=torch.tensor(x2))
    assert torch.equal(c1[:, 0], c2[:, 0])


# ---------------- the pooled path ----------------

@pytest.mark.parametrize("impl", ["segmented", "gather"])
def test_run_batch_matches_jax(fms, impl):
    _, cfg, jfms, port, _, _ = fms
    fm = port[impl]
    x, aidx = _inputs(cfg, fm)
    got = fm.run_batch(x, aidx)
    want = np.asarray(jfms[impl].run_batch(x, aidx), np.float32)
    assert got.shape == want.shape == (5, cfg.d_model)
    assert_bf16_close(got, want, FEATURE_TOL)
    # the "no adapter" rows equal the base model's
    cap = fm.adapters.capacity()
    base = fm.run_batch(x, np.full(5, cap, np.int32))
    np.testing.assert_array_equal(got[aidx == cap], base[aidx == cap])


@pytest.mark.parametrize("fault", ["dropped", "swapped"])
def test_parity_bounds_catch_adapter_faults(fms, fault):
    """A port that drops the adapters or swaps two of them misses the JAX
    features by over 4x the bound on both measures."""
    _, cfg, jfms, port, _, _ = fms
    fm = port["segmented"]
    x, aidx = _inputs(cfg, fm)
    want = np.asarray(jfms["segmented"].run_batch(x, aidx), np.float32)
    bad = np.full_like(aidx, fm.adapters.capacity()) if fault == "dropped" \
        else np.select([aidx == 0, aidx == 1], [1, 0], aidx).astype(np.int32)
    rel, worst = bf16_err(fm.run_batch(x, bad), want)
    assert rel > 4 * FEATURE_TOL[0] and worst > 4 * FEATURE_TOL[1], (rel, worst)


def test_pooled_features_are_the_mean_of_backbone_features(fms):
    _, cfg, _, port, _, _ = fms
    fm = port["gather"]
    x = np.random.RandomState(5).randn(2, S, cfg.d_model).astype(np.float32)
    cap = fm.adapters.capacity()
    got = fm.run_batch(x, np.full(2, cap, np.int32))
    want = lm.backbone_features(fm.params, cfg, torch.tensor(x)).mean(dim=1)
    np.testing.assert_allclose(got, want.float().numpy(), rtol=0, atol=1e-6)


# ---------------- lora_impl="auto" ----------------

def test_auto_is_the_default_and_the_table_covers_every_cell():
    assert PhysicalFM.__init__.__kwdefaults__["lora_impl"] == "auto"
    assert set(AUTO_LORA_TABLE) == {(b, n) for b in BUCKETS
                                    for n in NA_BUCKETS}
    assert len(AUTO_LORA_TABLE) == 30
    assert set(AUTO_LORA_TABLE.values()) <= {"segmented", "gather"}
    with pytest.raises(ValueError):
        PhysicalFM(reduced(get_config("moment-large")), lora_impl="sgmv",
                   device="cpu")


def test_resolve_rounds_buckets_up_and_pins_pass_through(fms):
    _, _, _, port, _, _ = fms
    auto = port["auto"]
    assert len(auto.adapters) == 3
    assert auto.resolve_lora_impl(6) == AUTO_LORA_TABLE[(8, 4)]
    assert auto.resolve_lora_impl(6, num_adapters=3) == AUTO_LORA_TABLE[(8, 4)]
    assert auto.resolve_lora_impl(1, num_adapters=0) == AUTO_LORA_TABLE[(1, 1)]
    assert auto.resolve_lora_impl(33, num_adapters=17) == \
        AUTO_LORA_TABLE[(32, 16)]
    assert auto.resolve_lora_impl(3, num_adapters=9) == AUTO_LORA_TABLE[(4, 16)]
    for impl in ("segmented", "gather"):
        assert all(port[impl].resolve_lora_impl(b, num_adapters=n) == impl
                   for b, n in AUTO_LORA_TABLE)


@pytest.mark.parametrize("choice", ["segmented", "gather"])
def test_auto_serving_equals_the_pinned_path(fms, monkeypatch, choice):
    """Whichever impl the table names for a cell, "auto" serves exactly what
    the FM pinned to that impl serves, and "auto" never reaches the model."""
    _, cfg, _, port, _, _ = fms
    auto = port["auto"]
    monkeypatch.setitem(AUTO_LORA_TABLE, (8, 4), choice)
    seen = []
    real = lm.forward

    def spy(*a, **kw):
        seen.append(kw.get("lora_impl"))
        return real(*a, **kw)
    monkeypatch.setattr(lm, "forward", spy)
    x, aidx = _inputs(cfg, auto)
    np.testing.assert_array_equal(auto.run_batch(x, aidx),
                                  port[choice].run_batch(x, aidx))
    assert seen == [choice, choice]
    assert (8, auto.adapters.capacity(), choice) in auto._fn_cache


def test_auto_adds_no_shape_key_within_slot_capacity(fms):
    _, cfg, _, port, _, trees = fms
    fm = port["auto"]
    x, aidx = _inputs(cfg, fm, n=3)
    fm.run_batch(x, aidx)
    keys, n = set(fm._fn_cache), fm.compile_count()
    assert len(fm.adapters) == 3 < fm.adapters.capacity()
    # a fourth adapter stays in the slot bucket and the adapter-count bucket
    fm.adapters.add("late", weights.adapter_tree(trees["lora0"], device="cpu"))
    try:
        fm.run_batch(x, np.array([3, 0, fm.adapters.capacity()], np.int32))
        assert set(fm._fn_cache) == keys and fm.compile_count() == n
    finally:
        fm.adapters.remove("late")


def test_decode_engine_resolves_from_its_slot_bucket(monkeypatch):
    """On a generative backbone under "auto", the engine resolves every
    shape key from the slot bucket: with the table set so the live adapter
    count (1, then 3) and the slot bucket (4) name different impls, the
    engine keeps the slot bucket's through adapter churn and adds no
    shape key."""
    cfg = reduced(get_config("stablelm-1.6b"))
    fm = PhysicalFM(cfg, seed=0, input_len=8, lora_rank=4, seg_block_t=BT,
                    device="cpu")
    eng = DecodeEngine(fm, num_slots=2, prompt_len=8, max_new=4, chunk=2)
    rows = physical.bucket_for(eng.num_slots)
    for b in (1, rows):
        monkeypatch.setitem(AUTO_LORA_TABLE, (b, 1), "gather")
        monkeypatch.setitem(AUTO_LORA_TABLE, (b, 2), "gather")
        monkeypatch.setitem(AUTO_LORA_TABLE, (b, 4), "segmented")
    fm.adapters.new("a0", seed=0)
    cap = fm.adapters.capacity()
    assert fm.resolve_lora_impl(rows) == "gather"
    assert eng._impl(rows, cap) == eng._impl(1, cap) == "segmented"
    rng = np.random.RandomState(0)

    def serve(name):
        eng.join("t", rng.randint(0, cfg.vocab_size, 5).astype(np.int32),
                 adapter_id=name, max_new_tokens=3, rid=0)
        eng.drain()
    serve("a0")
    keys = eng.compile_count()
    assert all(eng._segments(cap)[i] is not None for i in range(3))
    for i in (1, 2):
        fm.adapters.new(f"a{i}", seed=i)
    assert fm.adapters.capacity() == cap
    serve("a2")
    assert eng.compile_count() == keys
    assert eng._impl(rows, cap) == "segmented"


def test_decode_engine_refuses_a_representation_backbone(fms):
    _, _, _, port, _, _ = fms
    with pytest.raises(ValueError, match="vocab head"):
        DecodeEngine(port["gather"], num_slots=2, prompt_len=8)


# ---------------- executor heads ----------------

def _pooled_batch(fm, n, task_id="t0"):
    rng = np.random.RandomState(3)
    reqs = [Request(task_id, 0.0, payload=rng.randn(
        fm.input_len, fm.cfg.d_model).astype(np.float32)) for _ in range(n)]
    return Batch(reqs, [(None, reqs)])


def test_executor_runs_a_tensor_head_on_the_device_rows(fms):
    _, _, _, port, _, _ = fms
    fm = port["gather"]
    w = torch.tensor(np.random.RandomState(0).randn(fm.cfg.d_model, 3)
                     .astype(np.float32) * 0.1)
    fm.attach_head("t0", lambda f: torch.as_tensor(f).float() @ w)
    try:
        ex = Executor(fm)
        batch = _pooled_batch(fm, 3)
        out = ex.execute(batch, {})
        assert ex._head_mode["t0"][1] == "device"
        feats = fm.run_batch(np.stack([r.payload for r in batch.requests]),
                             np.full(3, fm.adapters.capacity(), np.int32))
        for i, r in enumerate(batch.requests):
            np.testing.assert_allclose(out[r.rid], feats[i] @ w.numpy(),
                                       atol=1e-5)
    finally:
        fm.detach_task("t0")


def test_executor_numpy_bound_head_falls_back(fms):
    """A head that takes only numpy (``np.asarray`` of a CUDA tensor raises;
    here a CPU tensor is refused the same way) runs on host rows."""
    _, _, _, port, _, _ = fms
    fm = port["gather"]
    w = np.random.RandomState(0).randn(fm.cfg.d_model, 2).astype(np.float32)

    def head(f):
        if not isinstance(f, np.ndarray):
            raise TypeError("numpy-bound head")
        return np.ascontiguousarray(f) @ w
    fm.attach_head("t0", head)
    try:
        ex = Executor(fm)
        batch = _pooled_batch(fm, 3)
        out = ex.execute(batch, {})
        assert ex._head_mode["t0"][1] in ("batched", "row")
        feats = fm.run_batch(np.stack([r.payload for r in batch.requests]),
                             np.full(3, fm.adapters.capacity(), np.int32))
        for i, r in enumerate(batch.requests):
            np.testing.assert_allclose(out[r.rid], feats[i] @ w, atol=1e-5)
    finally:
        fm.detach_task("t0")


# ---------------- the system (tests/test_system.py, fixed profile) ----------------

@pytest.fixture(scope="module")
def server(fms):
    """Three tasks on one auto-impl backbone, each with its own adapter and
    head; a fourth task shares task0's head weights on lora1."""
    _, cfg, _, _, np_params, trees = fms
    fm = _port_fm(np_params, cfg, trees, "auto")
    srv = FMplexServer("s0")
    srv.deploy_fm("fm0", fm, profile=PROFILE, scheduler="bfq")
    rng = np.random.RandomState(0)
    ws = [torch.tensor(rng.randn(cfg.d_model, 2).astype(np.float32) * 0.1)
          for _ in range(3)]
    for i in range(3):
        srv.bind_task(f"task{i}", "fm0", weight=float(i + 1), slo=SLO(60.0),
                      extensions=TaskExtensions(
                          decoder=(lambda w: (lambda f: torch.as_tensor(f)
                                              .float() @ w))(ws[i]),
                          adapter_id=f"lora{i}"))
    srv.bind_task("task0b", "fm0", slo=SLO(60.0), extensions=TaskExtensions(
        decoder=lambda f: torch.as_tensor(f).float() @ ws[0],
        adapter_id="lora1"))
    return srv, cfg


def _req(srv, cfg, tid):
    import time
    t = time.perf_counter()
    x = np.random.RandomState(1).randn(S, cfg.d_model).astype(np.float32)
    r = Request(tid, t, payload=x)
    srv.on_arrival(r, t)
    return r


def test_cross_task_cobatching_and_heads(server):
    srv, cfg = server
    assert len(srv.fms) == 1 and srv.profiles["fm0"] is PROFILE
    rs = [_req(srv, cfg, f"task{i}") for i in range(3)]
    batch = srv.step("fm0")
    assert batch is not None and batch.size == 3
    assert batch.num_adapters == 3
    for r in rs:
        assert r.ok and r.result.shape == (2,) and np.all(np.isfinite(r.result))


def test_task_outputs_differ_by_adapter(server):
    """Same input, same head weights, different adapters: the outputs
    differ (task0 on lora0, task0b on lora1)."""
    srv, cfg = server
    r0 = _req(srv, cfg, "task0")
    r1 = _req(srv, cfg, "task0b")
    while srv.step("fm0") is not None:
        pass
    assert np.abs(r0.result - r1.result).max() > 1e-2


def test_accounting_rebind_and_lifecycle(server, fms):
    srv, cfg = server
    _, _, _, _, _, trees = fms
    before = srv.vfms["task2"].acct.completed
    _req(srv, cfg, "task2")
    srv.step("fm0")
    assert srv.vfms["task2"].acct.completed == before + 1
    assert srv.vfms["task2"].acct.service_time > 0
    # rebind: queue and accounting move with the task, the backbone stays
    _req(srv, cfg, "task1")
    snap = srv.unbind_task("task1")
    assert snap is not None and len(snap["queue"]) >= 1
    vfm = srv.rebind_snapshot(snap, "fm0")
    assert vfm.acct.completed >= 1 and len(vfm.queue) >= 1
    assert srv.step("fm0") is not None
    # add and remove a task without redeploying the backbone
    fm = srv.fms["fm0"]
    n = len(fm.adapters.ids)
    fm.adapters.add("lora_tmp",
                    weights.adapter_tree(trees["lora2"], device="cpu"))
    srv.bind_task("task_tmp", "fm0", extensions=TaskExtensions(
        decoder=lambda f: f[:1], adapter_id="lora_tmp"))
    r = _req(srv, cfg, "task_tmp")
    srv.step("fm0")
    assert r.result is not None
    srv.unbind_task("task_tmp")
    fm.adapters.remove("lora_tmp")
    assert len(fm.adapters.ids) == n and "task_tmp" not in srv.vfms
    r2 = _req(srv, cfg, "task0")
    srv.step("fm0")
    assert r2.result is not None


def test_serve_loop_warmup_skips_the_engine(server):
    srv, cfg = server
    loop = srv.serve_loop("fm0")
    loop.warmup(pooled_n=4)
    assert "fm0" not in srv.engines


# ---------------- the launcher ----------------

def test_launcher_serves_every_request(capsys):
    s = launch_serve.main(["--device", "cpu", "--reduced", "--tasks", "2",
                           "--seconds", "1"])
    out = capsys.readouterr().out
    assert s["total"] > 0 and s["n"] == s["total"]
    assert "backbone=moment-large-smoke" in out and "fairness=" in out
    assert 0.0 < s["fairness"] <= 1.0


def test_run_load_offers_the_poisson_rate_whatever_the_step_time():
    """Open loop: a server whose every step takes 20 ms still receives
    about rps x seconds arrivals (the JAX launcher's loop submits one per
    step: about 15 here), stamped with their scheduled times."""
    import time

    class SlowServer:
        fms = {"fm0": type("FM", (), {"input_len": 2})()}

        def __init__(self):
            self.queue = []

        def on_arrival(self, r, now):
            self.queue.append(r)

        def step(self, fm_id):
            if not self.queue:
                return None
            time.sleep(0.02)
            self.queue.clear()
            return True
    cfg = reduced(get_config("moment-large"))
    reqs = launch_serve.run_load(SlowServer(), cfg, rps=200.0, seconds=0.3,
                                 n_tasks=2)
    assert 30 <= len(reqs) <= 100, len(reqs)
    arrivals = [r.arrival for r in reqs]
    assert arrivals == sorted(arrivals)

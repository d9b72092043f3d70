"""The port's serving slice against the JAX package's, on reduced
stablelm-1.6b with the JAX weights and adapters converted to the port:

* the port's ``DecodeEngine`` under join/leave churn (mixed adapters, a
  base-model row, variable prompt lengths and budgets) held TEACHER-FORCED
  against the JAX engine: both engines are driven by the same script, the
  JAX engine samples greedily, and the port is fed the JAX engine's token at
  every sampler call; the logits of every live row must agree at every call,
  and the tokens must agree wherever the JAX top-2 gap exceeds twice the
  tolerance;
* no new shape keys after warmup, across churn;
* ``ServeLoop.run`` on a small mixed trace serves every request, and the
  pooled features match the JAX ``PhysicalFM.run_batch``;
* importing every ``repro_torch`` module pulls in neither ``jax`` nor the
  JAX package (checked in a fresh interpreter).

Tolerance: f32 logits of two bf16 models that round in different places;
the int8 pool carries the drift from step to step (see test_torch_models.py
for the bf16 noise floor). The adapters are random at a scale (0.15) where
each moves the outputs far outside the bounds, so a port whose adapters are
dropped or swapped between tasks fails them
(``test_parity_bounds_catch_adapter_faults`` holds a 4x margin):

  quantity                           measured   bound   dropped / swapped
  logits, every call (|logit| < 4)   0.198      0.25    2.58 / 2.62
  pooled features (|f| < 1.8)        0.023      0.05    0.287 / 0.465
"""
import pytest

torch = pytest.importorskip("torch")

import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core.decode_engine import DecodeEngine as JDecodeEngine  # noqa: E402
from repro.core.physical import PhysicalFM as JPhysicalFM  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.decode_engine import DecodeEngine  # noqa: E402
from repro_torch.core.physical import PhysicalFM  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.server import FMplexServer  # noqa: E402
from repro_torch.core.vfm import TaskExtensions  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite runs in parallel workers on shared
    cores, and some JAX tests time their own calibration."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

LOGIT_TOL = 0.25
FEATURE_TOL = 0.05
FAULT_MARGIN = 4
ADAPTER_SCALE = 0.15
BT = 8
NAMES = ["lora0", "lora2", None, "lora1"]      # None: the base model
ENGINE_KW = dict(num_slots=4, prompt_len=8, max_new=8, chunk=2)


def _randomized_adapter(fm, i):
    """A JAX adapter tree with random A and B (B is zero when fresh), at a
    scale where each adapter moves the logits far outside the bounds."""
    tree = fm.adapters._mod.init_single_adapter(
        jax.random.PRNGKey(i), fm.cfg, fm.adapters.rank)
    leaves, tdef = jax.tree.flatten(tree)
    ks = jax.random.split(jax.random.PRNGKey(100 + i), len(leaves))
    return jax.tree.unflatten(tdef, [
        jax.random.normal(k, leaf.shape, leaf.dtype) * ADAPTER_SCALE
        for k, leaf in zip(ks, leaves)])


def _port_fm(jfm, cfg, trees):
    """The port's FM with the JAX FM's weights and ``trees`` (name -> numpy
    adapter tree) as its adapters."""
    fm = PhysicalFM(cfg, seed=0, input_len=8, lora_rank=4,
                    lora_impl="segmented", seg_block_t=BT, device="cpu",
                    params=weights.to_torch(jax.tree.map(np.asarray, jfm.params),
                                            device="cpu"))
    for name, tree in trees.items():
        fm.adapters.add(name, weights.adapter_tree(tree, device="cpu"))
    return fm


@pytest.fixture(scope="module")
def fms():
    """The JAX FM and the port's FM with the same weights and adapters, and
    the adapters as numpy trees."""
    jcfg = jreduced(jget_config("stablelm-1.6b"))
    cfg = reduced(get_config("stablelm-1.6b"))
    jfm = JPhysicalFM(jcfg, seed=0, input_len=8, lora_rank=4,
                      lora_impl="segmented", seg_block_t=BT)
    trees = {}
    for i in range(3):
        tree = _randomized_adapter(jfm, i)
        jfm.adapters.add(f"lora{i}", tree)
        trees[f"lora{i}"] = jax.tree.map(np.asarray, tree)
    return jfm, _port_fm(jfm, cfg, trees), cfg, trees


def _drive(eng, prompts):
    """The same churn script for both engines: 4 staggered streams, then
    joins into slots as they free, until 8 streams have run. Greedy with no
    EOS, so the control flow depends on budgets only."""
    for i in range(4):
        eng.join(f"t{i}", prompts[i], adapter_id=NAMES[i],
                 max_new_tokens=3 + i, rid=i)
    finished, nxt = [], 4
    while eng.active_count():
        finished += eng.step_chunk()
        while eng.free_slots() and nxt < len(prompts):
            eng.join(f"t{nxt}", prompts[nxt], adapter_id=NAMES[nxt % 4],
                     max_new_tokens=4 + nxt % 3, rid=nxt)
            nxt += 1
    return sorted(finished, key=lambda s: s.rid)


def _prompts(cfg, n=8, seed=1):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, int(rng.randint(2, 9)))
            .astype(np.int32) for _ in range(n)]


@pytest.fixture(scope="module")
def jax_stream(fms):
    """The JAX engine, greedy, under the churn script: the logits of every
    sampler call and the finished streams."""
    jfm, _, cfg, _ = fms
    jeng = JDecodeEngine(jfm, **ENGINE_KW)
    jcalls = []

    def jsample(logits, keys):
        jax.debug.callback(lambda l: jcalls.append(np.asarray(l, np.float32)),
                           logits, ordered=True)
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), keys
    jeng._sample = jsample
    return jcalls, _drive(jeng, _prompts(cfg))


def _teacher_forced(fm, cfg, jcalls):
    """The port's engine under the same script, fed the JAX token at every
    sampler call: the (logits, live rows) of every call and the streams."""
    eng = DecodeEngine(fm, **ENGINE_KW)
    calls = []

    def teacher(logits, gens):
        want = jcalls[len(calls)]
        live = np.ones(1, bool) if logits.shape[0] == 1 else np.array(
            [s is not None for s in eng.slots])
        calls.append((logits.float().numpy(), live))
        return torch.as_tensor(want.argmax(-1), dtype=torch.int32), gens
    eng._sample = teacher
    return calls, _drive(eng, _prompts(cfg))


def test_engine_teacher_forced_against_jax_under_churn(fms, jax_stream):
    _, fm, cfg, _ = fms
    jcalls, jdone = jax_stream
    calls, done = _teacher_forced(fm, cfg, jcalls)
    assert len(calls) == len(jcalls) and len(done) == len(jdone) == 8
    checked = 0
    for (got, live), want in zip(calls, jcalls):
        assert got.shape == want.shape
        diff = np.abs(got[live] - want[live]).max()
        assert diff <= LOGIT_TOL, diff
        top2 = np.sort(want[live], axis=-1)[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) > 2 * LOGIT_TOL
        assert (got[live].argmax(-1) == want[live].argmax(-1))[sure].all()
        checked += int(sure.sum())
    assert checked > 0
    # teacher forcing makes the streams equal by construction; their
    # lengths and terminal states must match too
    for s, js in zip(done, jdone):
        assert (s.rid, s.tokens, s.status) == (js.rid, js.tokens, js.status)
        assert len(s.tokens) == s.max_new


def _faulty_trees(trees, fault):
    if fault == "dropped":               # B = 0: every delta is zero
        return {n: jax.tree.map(np.zeros_like, t) for n, t in trees.items()}
    return dict(trees, lora0=trees["lora1"], lora1=trees["lora0"])


@pytest.mark.parametrize("fault", ["dropped", "swapped"])
def test_parity_bounds_catch_adapter_faults(fms, jax_stream, fault):
    """The bounds see the adapters: a port FM whose adapters are dropped
    (zero deltas) or swapped between two tasks misses the JAX engine's
    logits and the JAX pooled features by FAULT_MARGIN times the bound."""
    jfm, _, cfg, trees = fms
    jcalls, _ = jax_stream
    bad = _port_fm(jfm, cfg, _faulty_trees(trees, fault))
    calls, _ = _teacher_forced(bad, cfg, jcalls)
    worst = max(np.abs(got[live] - want[live]).max()
                for (got, live), want in zip(calls, jcalls))
    assert worst > FAULT_MARGIN * LOGIT_TOL, worst
    embeds, aidx = _pooled_inputs(cfg, bad)
    feats = bad.run_batch(embeds, aidx)
    want = np.asarray(jfm.run_batch(embeds, aidx), np.float32)
    assert np.abs(feats - want).max() > FAULT_MARGIN * FEATURE_TOL


def test_engine_no_new_shape_keys_after_warmup(fms):
    """Join/leave churn with changing adapters and prompt lengths adds no
    shape key once every prompt bucket has been seen; a repeated
    composition rebuilds no segment metadata."""
    _, fm, cfg, _ = fms
    eng = DecodeEngine(fm, num_slots=4, prompt_len=8, max_new=8, chunk=2)
    rng = np.random.RandomState(3)
    for plen in eng.prompt_buckets:                  # warm every bucket
        eng.join("warm", rng.randint(0, cfg.vocab_size, plen), rid=-1,
                 adapter_id="lora0", max_new_tokens=2)
    eng.drain()
    keys = eng.compile_count()
    done = _drive(eng, _prompts(cfg, seed=4))
    assert len(done) == 8 and all(len(s.tokens) == s.max_new for s in done)
    assert eng.compile_count() == keys
    builds = fm.seg_meta_cache.builds
    _drive(eng, _prompts(cfg, seed=4))
    assert fm.seg_meta_cache.builds == builds
    assert eng.compile_count() == keys


def test_sampling_topk1_is_greedy_and_seeded_sampling_reproduces(fms):
    """Top-k sampling with one torch.Generator per slot: k = 1 is greedy at
    any temperature, and the same seed gives the same streams."""
    _, fm, cfg, _ = fms
    prompts = _prompts(cfg, n=2, seed=6)

    def run(**kw):
        eng = DecodeEngine(fm, num_slots=2, prompt_len=8, max_new=6, chunk=2,
                           **kw)
        for i, p in enumerate(prompts):
            eng.join(f"t{i}", p, adapter_id=NAMES[i], max_new_tokens=6, rid=i)
        return [s.tokens for s in sorted(eng.drain(), key=lambda s: s.rid)]
    assert run(temperature=0.7, top_k=1) == run()
    assert run(temperature=1.0, top_k=20, sample_seed=3) == \
        run(temperature=1.0, top_k=20, sample_seed=3)


def test_engine_cancel_and_deadline(fms):
    """``cancel`` retires a live stream by rid and frees its slot; a stream
    past its deadline retires at the next chunk with its partial tokens."""
    import time
    _, fm, cfg, _ = fms
    eng = DecodeEngine(fm, num_slots=2, prompt_len=8, max_new=8, chunk=2)
    p = _prompts(cfg, n=2, seed=7)
    s0 = eng.join("a", p[0], adapter_id="lora0", max_new_tokens=8, rid=10)
    eng.join("b", p[1], max_new_tokens=8, rid=11,
             deadline=time.perf_counter() - 1.0)
    kind, slot = eng.cancel(10)
    assert kind == "slot" and slot.status == "cancelled" and slot.rid == 10
    assert s0 in eng.free_slots() and eng.cancel(10) is None
    (done,) = eng.step_chunk()
    assert done.rid == 11 and done.status == "deadline_cancelled"
    assert len(done.tokens) == 1 and eng.active_count() == 0


def test_unported_engine_options_raise(fms):
    _, fm, _, _ = fms
    with pytest.raises(NotImplementedError, match="later slice"):
        DecodeEngine(fm, num_slots=2, prompt_len=8, spec_k=2)
    # chunked shared-prefix prefill is ported: the paged default takes it
    assert DecodeEngine(fm, num_slots=2, prompt_len=8,
                        paged=True).chunked_prefill
    # the spill tier and snapshots are ported (tests/test_torch_recovery.py):
    # a paged pool takes an arena; the dense layout has no snapshot, as in
    # the JAX package, and keeps no arena
    assert DecodeEngine(fm, num_slots=2, prompt_len=8, paged=True,
                        spill_bytes=1 << 20).spill.budget_bytes == 1 << 20
    assert DecodeEngine(fm, num_slots=2, prompt_len=8,
                        spill_bytes=1 << 20).spill is None
    with pytest.raises(ValueError, match="paged-arena"):
        DecodeEngine(fm, num_slots=2, prompt_len=8).snapshot()
    # "auto" is ported (the GPU-measured crossover table,
    # tests/test_torch_representation.py); an unknown impl still raises
    assert PhysicalFM(fm.cfg, lora_impl="auto", device="cpu").lora_impl == "auto"
    with pytest.raises(ValueError):
        PhysicalFM(fm.cfg, lora_impl="sgmv", device="cpu")


def _pooled_inputs(cfg, fm):
    """Mixed adapters (0 and 1, the pair the swap fault exchanges) and a
    base-model row, a batch that pads to its bucket."""
    embeds = np.random.RandomState(0).randn(3, 8, cfg.d_model) \
        .astype(np.float32)
    return embeds, np.array([0, fm.adapters.capacity(), 1], np.int32)


def test_serve_loop_mixed_trace_and_pooled_features_match_jax(fms):
    jfm, fm, cfg, _ = fms
    # pooled features: the port's run_batch against the JAX one, mixed
    # adapters and a base-model row, a batch that pads to its bucket
    embeds, aidx = _pooled_inputs(cfg, fm)
    got = fm.run_batch(embeds, aidx)
    want = np.asarray(jfm.run_batch(embeds, aidx), np.float32)
    assert got.shape == want.shape == (3, cfg.d_model)
    assert np.abs(got - want).max() <= FEATURE_TOL
    rng = np.random.RandomState(1)
    # the event loop serves a small mixed trace end to end
    srv = FMplexServer("s0")
    srv.deploy_fm("fm0", fm, scheduler="bfq")
    for i in range(3):
        w = rng.randn(cfg.d_model, 2).astype(np.float32) * 0.1
        srv.bind_task(f"task{i}", "fm0", weight=float(i + 1),
                      extensions=TaskExtensions(
                          decoder=(lambda ww: (lambda f: f @ ww))(w),
                          adapter_id=f"lora{i}"))
    loop = srv.serve_loop("fm0", engine_kwargs=dict(
        num_slots=2, prompt_len=8, max_new=8, chunk=2))
    loop.warmup(pooled_task="task0", gen_task="task1")
    eng = srv.engines["fm0"]
    keys = (eng.compile_count(), fm.compile_count())
    trace = [Request(f"task{i % 3}", 0.001 * i,
                     payload=rng.randn(8, cfg.d_model).astype(np.float32))
             for i in range(8)]
    trace += [Request(f"task{i % 3}", 0.0005 + 0.002 * i,
                      payload=rng.randint(0, cfg.vocab_size, 2 + i)
                      .astype(np.int32), tokens=float(8 + i),
                      max_new_tokens=3 + i) for i in range(5)]
    loop.run(list(trace), max_wall=120)
    assert all(r.ok and r.finish_time is not None and r.result is not None
               for r in trace)
    for kind in ("pooled", "admit", "decode"):
        assert loop.ticks[kind] > 0, kind
    for r in trace:
        if r.max_new_tokens > 0:
            assert len(r.result) == r.max_new_tokens
        else:
            assert r.result.shape == (2,) and np.isfinite(r.result).all()
    assert (eng.compile_count(), fm.compile_count()) == keys


def test_port_imports_neither_jax_nor_the_jax_package():
    """In a fresh interpreter, import every module of the port and check
    that neither ``jax`` nor anything of ``repro`` got imported."""
    code = """
import pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    __import__(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert len(names) >= 25 and not bad, bad
"""
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr

"""The port's paged int8 KV pool against the JAX package's, on reduced
stablelm-1.6b with the JAX weights and adapters converted to the port:

* the plain version of the paged decode kernel (K4) against the JAX oracle,
  and the model-layout op against the JAX op's XLA path, over MHA and GQA,
  windows, ragged lengths (1, a page multiple, the table's full width),
  rows that map the same pages and tables padded with the trash page;
* the paged admission scatter and the scale refresh against the JAX
  engine's on the same float input: int8 codes exact, scales to 1e-6, the
  prompt/decode boundary page stamped at the slot scale;
* the paged engine (``chunked_prefill=False``) held TEACHER-FORCED against
  the JAX paged engine under churn: ragged prompts, shared prefixes with
  divergent tails (COW), page recycling, deferral and drain, page-pressure
  preemption and resume, and a scale refresh that fires. After every call
  the host allocator state (page tables, refcounts, free list, held pages,
  lengths, registry, pending queue, counters) must EQUAL the JAX engine's;
* no new shape keys after warmup across churn, allocation, deferral and
  preemption;
* the stranded-sharer wedge recovered through ``ServeLoop`` (and only that
  error caught);
* the refcount invariant of ``tests/test_property.py`` under randomized
  join/step/preempt/retire/cancel/expire sequences (hypothesis);
* on a GPU only, the K4 CUDA kernel against its plain version.

Tolerances: the plain versions compute the same f32 products as the JAX
oracles in another summation order (1e-5). The engines' logits are two bf16
models that round in different places (see test_torch_models.py): the
prefill K/V of deeper layers differ by bf16 ulps, which moves their int8
codes by 1-3 where a per-page scale is fine, and the cache carries that
from step to step. Measured on this script: at most 0.67 (one call; 95% of
calls under 0.17) with |logits| up to 4.4; the same chunks replayed from
the JAX engine's own pool differ by at most 0.13, so the rest is that
carried code noise. Bound 0.75; adapters at this scale move the logits by
about 2.6 (test_torch_serving.py). Host state is exact.
"""
import pytest

torch = pytest.importorskip("torch")

import collections  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core.decode_engine import DecodeEngine as JDecodeEngine  # noqa: E402
from repro.core.physical import PhysicalFM as JPhysicalFM  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.decode_engine import (TRASH_PAGE, DecodeEngine,  # noqa: E402
                                            EngineWedged)
from repro_torch.core.physical import PhysicalFM  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
# the one K3/K4 case table, shared with chip_smoke.py's card check
from chip_smoke import INT8_CASES  # noqa: E402

BT = 8
LOGIT_TOL = 0.75
ADAPTER_SCALE = 0.15
KERNEL_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite runs in parallel workers on shared
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------- the plain version of K4 and the op ----------------

def _paged_case(seed, B=4, H=8, KV=4, hd=16, ps=8, P=13, MP=4,
                lens=(9, 32, 1, 16)):
    """Random int8 arena (every page, the trash page and recycled pages
    included, holds codes), per-page scales, and a table in which rows 0
    and 3 map the same first page (COW), entries past a stream's last page
    are 0 and row 1 fills the table's full width."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, hd).astype(np.float32)
    kp = rng.randint(-127, 128, (P, KV, ps, hd)).astype(np.int8)
    vp = rng.randint(-127, 128, (P, KV, ps, hd)).astype(np.int8)
    ks = (rng.rand(P, KV) * 0.05 + 1e-3).astype(np.float32)
    vs = (rng.rand(P, KV) * 0.05 + 1e-3).astype(np.float32)
    pt = np.zeros((B, MP), np.int32)
    free = list(range(1, P))
    rng.shuffle(free)
    for b in range(B):
        for j in range(-(-int(lens[b]) // ps)):
            pt[b, j] = free.pop()
    pt[3, 0] = pt[0, 0]                     # a shared prefix page
    return q, kp, vp, ks, vs, pt, np.asarray(lens, np.int32)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("G", [1, 2])
def test_paged_ref_matches_jax(G, window):
    """Plain K4 (head-major arena) against the JAX oracle."""
    q, kp, vp, ks, vs, pt, lens = _paged_case(seed=G, H=4 * G)
    want = jref.paged_decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(ks),
        jnp.asarray(vs), jnp.asarray(pt), jnp.asarray(lens), window=window)
    got = ref.paged_decode_attention_ref(
        torch.tensor(q), torch.tensor(kp), torch.tensor(vp), torch.tensor(ks),
        torch.tensor(vs), torch.tensor(pt), torch.tensor(lens), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


@pytest.mark.parametrize("window", [None, 6])
def test_ops_paged_matches_jax_model_layout(window):
    """The op in the model layout (P, ps, KV, hd) against the JAX op's XLA
    path (gather, per-page dequant, decode reference)."""
    q, kp, vp, ks, vs, pt, lens = _paged_case(seed=5, H=8, KV=4)
    km, vm = kp.transpose(0, 2, 1, 3), vp.transpose(0, 2, 1, 3)
    want = jops.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(km), jnp.asarray(vm), jnp.asarray(ks),
        jnp.asarray(vs), jnp.asarray(pt), jnp.asarray(lens), window=window,
        backend="xla")
    got = ops.paged_decode_attention(
        torch.tensor(q), torch.tensor(np.ascontiguousarray(km)),
        torch.tensor(np.ascontiguousarray(vm)), torch.tensor(ks),
        torch.tensor(vs), torch.tensor(pt), torch.tensor(lens), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


def test_ops_paged_routes_only_cpu_to_the_plain_version():
    """Another device than the CPU reaches the kernel or an error, never the
    plain version (a meta tensor stands in for one here)."""
    q = torch.empty((1, 2, 16), device="meta")
    arena = torch.empty((2, 4, 2, 16), dtype=torch.int8, device="meta")
    sc = torch.empty((2, 2), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.paged_decode_attention(q, arena, arena, sc, sc,
                                   torch.zeros((1, 1), dtype=torch.int32),
                                   torch.ones(1, dtype=torch.int32))


# ---------------- the FMs: JAX weights and adapters in both ----------------

def _randomized_adapter(fm, i):
    tree = fm.adapters._mod.init_single_adapter(
        jax.random.PRNGKey(i), fm.cfg, fm.adapters.rank)
    leaves, tdef = jax.tree.flatten(tree)
    ks = jax.random.split(jax.random.PRNGKey(100 + i), len(leaves))
    return jax.tree.unflatten(tdef, [
        jax.random.normal(k, leaf.shape, leaf.dtype) * ADAPTER_SCALE
        for k, leaf in zip(ks, leaves)])


@pytest.fixture(scope="module")
def fms():
    jcfg = jreduced(jget_config("stablelm-1.6b"))
    cfg = reduced(get_config("stablelm-1.6b"))
    jfm = JPhysicalFM(jcfg, seed=0, input_len=8, lora_rank=4,
                      lora_impl="segmented", seg_block_t=BT)
    fm = PhysicalFM(cfg, seed=0, input_len=8, lora_rank=4,
                    lora_impl="segmented", seg_block_t=BT, device="cpu",
                    params=weights.to_torch(jax.tree.map(np.asarray,
                                                         jfm.params),
                                            device="cpu"))
    for i in range(3):
        tree = _randomized_adapter(jfm, i)
        jfm.adapters.add(f"lora{i}", tree)
        fm.adapters.add(f"lora{i}", weights.adapter_tree(
            jax.tree.map(np.asarray, tree), device="cpu"))
    return jfm, fm, cfg


# ---------------- admission scatter and scale refresh ----------------

WRITE_KW = dict(num_slots=2, prompt_len=16, max_new=8, chunk=2, paged=True,
                page_size=4, chunked_prefill=False)


def _subs_np(pool, keys):
    return [{k: np.asarray(sub[k], np.float32) if not isinstance(
        sub[k], torch.Tensor) else sub[k].float().numpy() for k in keys}
        for sub in pool]


def test_paged_write_and_rescale_match_jax(fms):
    """Same float prefill cache into both engines' admission scatter: codes
    equal, scales to 1e-6, the boundary page at the slot scale, an
    all-pad page at scale 0; then the same drift maxima into both scale
    refreshes: codes equal, scales to 1e-6."""
    jfm, fm, cfg = fms
    jeng, eng = JDecodeEngine(jfm, **WRITE_KW), DecodeEngine(fm, **WRITE_KW)
    npages, true_len, slot = 4, 9, 1     # pages 2 = boundary, 3 = all pad
    rng = np.random.RandomState(4)
    shape = (cfg.num_layers, 1, npages * 4, cfg.num_kv_heads, cfg.head_dim)
    cache = []
    for _ in jeng.pool:
        kv = {n: (rng.randn(*shape) * (1 + rng.rand(*shape[:3])[..., None,
                                                                None]))
              .astype(np.float32) for n in ("k", "v")}
        for n in kv:                      # the prefill zeroes pad positions
            kv[n][:, :, true_len:] = 0.0
        cache.append(kv)
    pages = np.array([3, 0, 7, 5], np.int32)   # page 0: a shared position
    jeng.pool = jeng._paged_write_fn(npages)(
        jeng.pool, [{n: jnp.asarray(c[n]) for n in c} for c in cache],
        jnp.int32(slot), jnp.asarray(pages), jnp.int32(true_len))
    eng.pool = eng._paged_write_fn(npages)(
        eng.pool, [{n: torch.tensor(c[n]) for n in c} for c in cache],
        torch.tensor([slot]), torch.tensor(pages).long(),
        torch.tensor([true_len], dtype=torch.int32))
    keys = ("k", "v", "k_scale", "v_scale", "slot_k_scale", "slot_v_scale",
            "len")
    real = [3, 7, 5]
    for jsub, sub in zip(_subs_np(jeng.pool, keys), _subs_np(eng.pool, keys)):
        for n in ("k", "v"):
            np.testing.assert_array_equal(sub[n][:, real], jsub[n][:, real])
            np.testing.assert_allclose(sub[f"{n}_scale"][:, real],
                                       jsub[f"{n}_scale"][:, real],
                                       rtol=1e-6, atol=0)
            # the boundary page carries the slot-wide scale, the pad page 0
            np.testing.assert_allclose(sub[f"{n}_scale"][:, 7],
                                       sub[f"slot_{n}_scale"][:, slot],
                                       rtol=1e-6)
            assert (sub[f"{n}_scale"][:, 5] == 0).all()
            np.testing.assert_allclose(sub[f"slot_{n}_scale"],
                                       jsub[f"slot_{n}_scale"], rtol=1e-6)
        assert (sub["len"][:, slot] == true_len).all()
    # the refresh: drift maxima above the page's range on some heads
    for jsub, sub in zip(jeng.pool, eng.pool):
        for n in ("k_max", "v_max"):
            mx = (rng.rand(*sub[n].shape) * 400).astype(np.float32)
            jsub[n] = jnp.asarray(mx)
            sub[n].copy_(torch.tensor(mx))
    jeng.pool = jeng._rescale_fn()(jeng.pool, jnp.int32(slot), jnp.int32(7))
    eng.pool = eng._rescale_fn()(eng.pool, torch.tensor([slot]),
                                 torch.tensor([7]))
    for jsub, sub in zip(_subs_np(jeng.pool, keys), _subs_np(eng.pool, keys)):
        for n in ("k", "v"):
            np.testing.assert_array_equal(sub[n][:, 7], jsub[n][:, 7])
            for sc in (f"{n}_scale", f"slot_{n}_scale"):
                np.testing.assert_allclose(sub[sc], jsub[sc], rtol=1e-6,
                                           atol=0)


# ---------------- the engine, teacher-forced against JAX ----------------

ENGINE_KW = dict(num_slots=4, prompt_len=16, prompt_buckets=(8, 16),
                 max_new=12, chunk=2, paged=True, page_size=4,
                 total_pages=11, chunked_prefill=False)
# a refresh threshold every decoded token crosses: the refresh then fires on
# the same chunks in both engines, whatever their bf16 rounding
REFRESH = 0.01


def _workload(cfg, seed=11):
    """Shared-prefix prompts on lora0 (a 2-page prefix and divergent tails,
    one prompt exactly the prefix) mixed with random ragged prompts on the
    other adapters and the base model."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, cfg.vocab_size, 8).astype(np.int32)
    jobs = []
    for i in range(12):
        if i % 3 != 2:
            tail = rng.randint(0, cfg.vocab_size, (0, 1, 5, 8)[i % 4])
            prompt, name = np.concatenate([prefix, tail.astype(np.int32)]), \
                "lora0"
        else:
            prompt = rng.randint(0, cfg.vocab_size,
                                 int(rng.randint(1, 17))).astype(np.int32)
            name = ("lora1", None, "lora2")[i % 3]
        jobs.append((prompt, name, int(rng.randint(3, 13))))
    return jobs


def _host_state(eng):
    return {
        "ptab": eng._ptab.tolist(), "refs": eng._page_refs.tolist(),
        "free": list(eng._free_pages), "held": eng._held.tolist(),
        "lens": eng._lens.tolist(), "registry": dict(eng._prefix_registry),
        "page_key": dict(eng._page_key), "pending": eng.pending_rids(),
        "slots": [None if s is None else (s.rid, list(s.tokens), s.done)
                  for s in eng.slots],
        "counters": [eng.deferrals, eng.preemptions, eng.hol_bypasses,
                     eng.prefix_hits, eng.shared_pages_mapped,
                     eng.admissions, eng.scale_refreshes, eng.steps],
    }


def _drive(eng, jobs):
    """Joins straight into the engine (deferring when the pool is full),
    more joins between chunks, until everything has retired; the host
    state after every call."""
    states, done = [], []
    with warnings.catch_warnings():      # folded resume prompts truncate
        warnings.simplefilter("ignore", RuntimeWarning)
        nxt = 0
        for nxt in range(6):
            p, name, n = jobs[nxt]
            eng.join(f"t{nxt}", p, adapter_id=name, max_new_tokens=n, rid=nxt)
            states.append(_host_state(eng))
        nxt += 1
        while eng.active_count() or eng.pending_count():
            done += eng.step_chunk()
            states.append(_host_state(eng))
            if nxt < len(jobs) and eng.steps % 4 == 0:
                p, name, n = jobs[nxt]
                eng.join(f"t{nxt}", p, adapter_id=name, max_new_tokens=n,
                         rid=nxt)
                nxt += 1
                states.append(_host_state(eng))
    return states, sorted(done, key=lambda s: s.rid)


def test_can_admit_pending_matches_jax_after_a_deferral(fms):
    """``DecodeEngine.can_admit_pending()`` against the JAX engine's after
    every join and chunk of the churn script's first 8 joins: the answers
    and the deferred queues equal throughout, at least one join deferred
    (the pool full), and False while joins wait (each chunk first admits
    what fits) and once the queue is empty. Admission reads prompt
    lengths, pages and slots, never tokens, so the two engines' greedy
    streams need not agree."""
    jfm, fm, cfg = fms
    jeng = JDecodeEngine(jfm, **ENGINE_KW)
    eng = DecodeEngine(fm, **ENGINE_KW)
    seen = set()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for i, (p, name, n) in enumerate(_workload(cfg)[:8]):
            for e in (jeng, eng):
                e.join(f"t{i}", p, adapter_id=name, max_new_tokens=n, rid=i)
            assert eng.can_admit_pending() == jeng.can_admit_pending()
            assert eng.pending_rids() == jeng.pending_rids()
        assert eng.deferrals >= 1
        while eng.pending_count():
            seen.add(eng.can_admit_pending())
            jeng.step_chunk()
            eng.step_chunk()
            assert eng.can_admit_pending() == jeng.can_admit_pending()
            assert eng.pending_rids() == jeng.pending_rids()
    assert not eng.can_admit_pending() and not jeng.can_admit_pending()
    assert False in seen


@pytest.fixture(scope="module")
def jax_paged(fms):
    """The JAX paged engine, greedy, under the churn script: the logits of
    every sampler call, the host states and the finished streams."""
    jfm, _, cfg = fms
    jeng = JDecodeEngine(jfm, scale_refresh=REFRESH, **ENGINE_KW)
    jcalls = []

    def jsample(logits, keys):
        jax.debug.callback(lambda l: jcalls.append(np.asarray(l, np.float32)),
                           logits, ordered=True)
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), keys
    jeng._sample = jsample
    states, done = _drive(jeng, _workload(jfm.cfg))
    return jcalls, states, done, jeng


def test_paged_engine_teacher_forced_against_jax(fms, jax_paged):
    """Logits of every live row within the bound at every sampler call,
    and the host allocator state equal to the JAX engine's after every
    call. The script must have exercised sharing, deferral, head-of-line
    lookahead, preemption, recycling and the refresh."""
    _, fm, cfg = fms
    jcalls, jstates, jdone, jeng = jax_paged
    eng = DecodeEngine(fm, scale_refresh=REFRESH, **ENGINE_KW)
    calls = []

    def teacher(logits, gens):
        want = jcalls[len(calls)]
        live = np.ones(1, bool) if logits.shape[0] == 1 else np.array(
            [s is not None and not s.done for s in eng.slots])
        calls.append((logits.float().numpy(), live))
        return torch.as_tensor(want.argmax(-1), dtype=torch.int32), gens
    eng._sample = teacher
    states, done = _drive(eng, _workload(cfg))
    assert len(calls) == len(jcalls) and len(states) == len(jstates)
    for got, want in zip(states, jstates):
        assert got == want
    worst = max(np.abs(got[live] - want[live]).max()
                for (got, live), want in zip(calls, jcalls) if live.any())
    assert worst <= LOGIT_TOL, worst
    for s, js in zip(done, jdone):
        assert (s.rid, s.tokens, s.status) == (js.rid, js.tokens, js.status)
    assert len(done) == 12 and all(len(s.tokens) == s.max_new for s in done)
    assert eng.prefix_hits >= 2 and eng.deferrals >= 1
    assert eng.preemptions >= 1 and eng.scale_refreshes >= 1
    assert eng.hol_bypasses >= 1
    assert eng.free_page_count() == eng.total_pages - 1
    assert not eng._page_refs.any() and not eng._prefix_registry


def test_paged_no_new_shape_keys_after_warmup(fms):
    """After one warm join per prompt bucket, churn with page allocation,
    recycling, sharing, deferral and preemption adds no shape key."""
    _, fm, cfg = fms
    eng = DecodeEngine(fm, scale_refresh=REFRESH, **ENGINE_KW)
    rng = np.random.RandomState(3)
    for plen in eng.prompt_buckets:
        eng.join("w", rng.randint(0, cfg.vocab_size, plen), rid=-1,
                 adapter_id="lora0", max_new_tokens=2)
    eng.drain()
    eng.warm_decode_ladder()
    eng._rescale_fn()              # the refresh's one key, made on first use
    keys = eng.compile_count()
    _, done = _drive(eng, _workload(cfg))
    assert len(done) == 12 and eng.preemptions >= 1 and eng.deferrals >= 1
    assert eng.compile_count() == keys
    assert eng.free_page_count() == eng.total_pages - 1


# ---------------- stranded sharer through the serve loop ----------------

def test_stranded_sharer_wedge_recovered_by_serve_loop(fms):
    """A deferred join that only fit thanks to a shared prefix strands when
    its sharer leaves; the engine raises its wedge for direct users, the
    loop catches exactly that error, sheds the entry as
    ``rejected_stranded`` and keeps serving. Any other ValueError from the
    engine propagates out of the loop."""
    from repro_torch.core.request import Request
    from repro_torch.core.server import FMplexServer
    from repro_torch.core.vfm import TaskExtensions
    from repro_torch.serving.metrics import failure_counters
    _, fm, cfg = fms
    srv = FMplexServer("s0")
    srv.deploy_fm("fm0", fm, scheduler="bfq")
    srv.bind_task("gen", "fm0", extensions=TaskExtensions(adapter_id="lora0"))
    loop = srv.serve_loop("fm0", engine_kwargs=dict(
        num_slots=2, prompt_len=16, max_new=4, chunk=2, paged=True,
        page_size=4, total_pages=5, prompt_buckets=(8, 16),
        chunked_prefill=False))
    eng = loop._engine(create=True)
    rng = np.random.RandomState(31)
    prefix = rng.randint(0, cfg.vocab_size, 8).astype(np.int32)
    assert eng.join("gen", prefix, adapter_id="lora0", max_new_tokens=4,
                    rid=-5) >= 0
    big = Request("gen", 0.0, payload=np.concatenate(
        [prefix, rng.randint(0, cfg.vocab_size, 4).astype(np.int32)]),
        tokens=16.0, max_new_tokens=4)
    loop._inflight[big.rid] = big
    loop._admit_one(eng, srv.vfms_on("fm0"), big)
    assert eng.pending_rids() == [big.rid]        # deferred on the discount
    assert eng.cancel(-5) is not None             # the sharer leaves
    with pytest.raises(EngineWedged, match="no longer fit"):
        eng.step_chunk()
    assert loop.tick() == "decode"
    assert big.status == "rejected_stranded" and big.finish_time is not None
    assert loop.failures["wedge_recoveries"] == 1
    assert failure_counters([big], loop=loop)["wedge_recoveries"] == 1
    assert eng.pending_count() == 0
    assert eng.free_page_count() == eng.total_pages - 1
    eng.join("gen", prefix, adapter_id="lora0", max_new_tokens=4, rid=-6)

    def kernel_error():
        raise ValueError("a kernel's precondition")
    eng.step_chunk = kernel_error
    with pytest.raises(ValueError, match="precondition"):
        loop.tick()


# ---------------- refcount invariant under random churn ----------------

def _check_page_invariants(eng):
    """Every usable page's refcount equals its page-table mappings; a page
    is on the free list exactly when its refcount is 0 (and once); the
    registry references live pages only; live slots hold pages for their
    tokens; the trash page is never mapped."""
    held = [int(p) for s in range(eng.num_slots)
            for p in eng._ptab[s, :eng._held[s]]]
    c = collections.Counter(held)
    assert TRASH_PAGE not in c
    free = eng._free_pages
    assert len(free) == len(set(free)), "duplicate free-list entry"
    for p in range(1, eng.total_pages):
        assert eng._page_refs[p] == c.get(p, 0), p
        assert (eng._page_refs[p] == 0) == (p in set(free)), p
    for key, p in eng._prefix_registry.items():
        assert eng._page_refs[p] > 0 and eng._page_key.get(p) == key
    for s in range(eng.num_slots):
        slot = eng.slots[s]
        if slot is not None and not slot.done:
            assert eng._held[s] >= -(-max(int(eng._lens[s]), 1)
                                     // eng.page_size)


@settings(max_examples=8, deadline=None)
@given(ops=st.lists(st.tuples(st.integers(0, 6), st.integers(0, 7)),
                    min_size=4, max_size=18))
def test_paged_refcounts_never_leak_or_double_free(fms, ops):
    """Randomized join/decode/preempt/retire/cancel/deadline sequences over
    shared-prefix prompts, plus a mass retire followed by a late sharer:
    the refcounted free list never double-frees or leaks, unwinding one
    sharer never touches another's pages, terminally rejected entries carry
    a failure status, and a final drain frees the whole arena."""
    _, fm, cfg = fms
    eng = DecodeEngine(fm, num_slots=4, prompt_len=16, max_new=6, chunk=2,
                       paged=True, page_size=4, total_pages=21,
                       prompt_buckets=(4, 16), chunked_prefill=False)
    rng = np.random.RandomState(0)
    prefixes = [rng.randint(0, cfg.vocab_size, 8).astype(np.int32)
                for _ in range(2)]
    rid = 0
    rejected = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for op, a in ops:
            live = [i for i, s in enumerate(eng.slots) if s is not None]
            if op == 0:                                  # join, shared prefix
                sfx = np.random.RandomState(a).randint(
                    0, cfg.vocab_size, 1 + a % 5).astype(np.int32)
                eng.join(f"t{rid}", np.concatenate([prefixes[a % 2], sfx]),
                         adapter_id="lora0", max_new_tokens=1 + a % 6,
                         rid=rid)
                rid += 1
            elif op == 1:
                eng.step_chunk()
            elif op == 2 and live:
                eng._preempt(live[a % len(live)])
            elif op == 3 and live:
                eng.leave(live[a % len(live)])
            elif op == 4:                                # cancel by rid
                rids = [s.rid for s in eng.slots if s is not None] \
                    + eng.pending_rids()
                if rids:
                    assert eng.cancel(rids[a % len(rids)]) is not None
            elif op == 5 and live:                       # deadline expiry
                eng.slots[live[a % len(live)]].deadline = 0.0
                eng._expire_deadlines(time.perf_counter())
            elif op == 6:                                # mass retire, then
                for s in live:                           # a late sharer
                    eng.leave(s)
                sfx = np.random.RandomState(99 + a).randint(
                    0, cfg.vocab_size, 1 + a % 5).astype(np.int32)
                eng.join(f"late{rid}", np.concatenate([prefixes[a % 2], sfx]),
                         adapter_id="lora0", max_new_tokens=1 + a % 4,
                         rid=rid)
                rid += 1
            rejected += eng.take_rejected()
            _check_page_invariants(eng)
        for _ in range(200):
            if not (eng.active_count() or eng.pending_count()):
                break
            eng.step_chunk()
            _check_page_invariants(eng)
    assert not (eng.active_count() or eng.pending_count())
    assert eng.free_page_count() == eng.total_pages - 1
    assert (eng._page_refs[1:] == 0).all()
    assert not eng._prefix_registry and not eng._page_key
    rejected += eng.take_rejected()
    assert all(p.status != "ok" for p in rejected)


# ---------------- the CUDA kernel (GPU only) ----------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are built and run on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_paged_decode_kernel_on_gpu(cuda_device, case):
    """K4 vs its plain version with ragged lengths, a shared page and stale
    codes in unmapped pages: two bf16 ulps of the largest output (both
    accumulate in f32, in another order), and the same bits from a second
    call."""
    c = INT8_CASES[case]
    H, KV, hd, lens, window = (c["H"], c["KV"], c.get("hd", 64), c["lens"],
                               c.get("window"))
    B, ps = len(lens), 16
    MP = -(-c["S"] // ps)          # the table of a dense cache of S
    P = 1 + B * MP
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    dev = cuda_device
    q = torch.randn((B, H, hd), generator=gen, device=dev).to(torch.bfloat16)
    kp = torch.randint(-127, 128, (P, ps, KV, hd), generator=gen, device=dev,
                       dtype=torch.int8)
    vp = torch.randint(-127, 128, (P, ps, KV, hd), generator=gen, device=dev,
                       dtype=torch.int8)
    ks = torch.rand((P, KV), generator=gen, device=dev) * 0.05 + 1e-3
    vs = torch.rand((P, KV), generator=gen, device=dev) * 0.05 + 1e-3
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    pt = torch.zeros((B, MP), dtype=torch.int32, device=dev)
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    k = 0
    for b in range(B):
        n = -(-int(lens[b]) // ps)
        pt[b, :n] = perm[k:k + n].to(torch.int32)
        k += n
    pt[3, :2] = pt[2, :2]                          # COW: shared pages
    before = ops.LAUNCHES["paged_decode_attention"]
    got = ops.paged_decode_attention(q, kp, vp, ks, vs, pt, lens,
                                     window=window)
    want = ref.paged_decode_attention_ref(q, kp.transpose(1, 2),
                                          vp.transpose(1, 2), ks, vs, pt,
                                          lens, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_decode_attention"] == before + 1
    tol = 2 * 2.0 ** -8 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(got, ops.paged_decode_attention(
        q, kp, vp, ks, vs, pt, lens, window=window))

"""The port's captured executables (``repro_torch.core.graphs``), on the CPU
through the staging path every call after the first takes:

* ``Executable``: a changed non-tensor argument raises, a baked operand
  whose storage was replaced raises, the launches recorded at capture are
  added on every later call, and calls 1, 2 and 3 each give the eager
  result on fresh inputs;
* ``DecodeEngine`` on the dense pool and on the paged pool (chunked
  prefill, prefix sharing and scale refresh on; too few pages, so joins
  defer and streams are preempted), driven through join/leave churn in
  lockstep with the same engine under ``graphs.disabled()``: tokens, host
  state (tables, refcounts, free list, registry, counters) and the pool
  itself equal after every engine call;
* a decode key first used while streams are live leaves their tokens equal
  to an engine whose ladder was warmed while idle;
* the device page table and the adapter stack never move (the executables
  read them where they lie);
* ``compile_count`` equal to the JAX package's on the same calls.

The ``cuda``-marked twins run the graphed-against-eager checks on the card
and skip elsewhere.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core.decode_engine import DecodeEngine as JDecodeEngine  # noqa: E402
from repro.core.physical import PhysicalFM as JPhysicalFM  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import graphs  # noqa: E402
from repro_torch.core.decode_engine import DecodeEngine  # noqa: E402
from repro_torch.core.physical import PhysicalFM  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import lora as lora_mod  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: graphs are captured on the card")
    return torch.device("cuda", 0)


# ---------------- Executable ----------------

def _toy(w, x, n):
    """A closure with a baked weight, a staged input, a constant and two
    'launches' a call."""
    build.LAUNCHES["toy_kernel"] += 2
    return torch.tanh(w * x) + n, w


def test_executable_changed_constant_raises():
    w = torch.ones(4)
    exe = graphs.Executable(_toy, bake=(0,))
    exe(w, torch.zeros(4), 1)
    exe(w, torch.zeros(4), 1)
    with pytest.raises(ValueError, match="non-tensor"):
        exe(w, torch.zeros(4), 2)
    with pytest.raises(ValueError, match="staged"):
        exe(w, torch.zeros(5), 1)


def test_executable_replaced_baked_storage_raises():
    w = torch.ones(4)
    exe = graphs.Executable(_toy, bake=(0,))
    exe(w, torch.zeros(4), 1)
    exe(w, torch.zeros(4), 1)
    exe(w, torch.zeros(4), 1)
    with pytest.raises(ValueError, match="baked"):
        exe(w.clone(), torch.zeros(4), 1)       # same values, moved storage


def test_executable_adds_recorded_launches_on_every_call():
    w = torch.ones(4)
    exe = graphs.Executable(_toy, bake=(0,))
    before = build.LAUNCHES["toy_kernel"]
    for i in range(5):
        exe(w, torch.zeros(4), 1)
        assert build.LAUNCHES["toy_kernel"] == before + 2 * (i + 1)
    assert exe.launches == {"toy_kernel": 2}
    with graphs.disabled():                     # eager: the closure counts
        exe(w, torch.zeros(4), 1)
    assert build.LAUNCHES["toy_kernel"] == before + 12


def test_executable_calls_match_eager_on_fresh_inputs():
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(4, generator=gen)
    exe = graphs.Executable(_toy, bake=(0,))
    held = []
    for call in range(1, 5):
        x = torch.randn(4, generator=gen)
        got, w_out = exe(w, x, 3)
        assert w_out is w                       # an argument comes back as is
        torch.testing.assert_close(got, torch.tanh(w * x) + 3, rtol=0, atol=0)
        held.append((call, got, got.clone()))
    # outputs belong to the executable: the calls after capture share them
    assert held[2][1] is held[3][1] and held[1][1] is held[3][1]
    assert torch.equal(held[0][1], held[0][2])  # call 1 was eager


def test_executable_bakes_the_weight_where_it_lies():
    """A baked tensor updated in place is read at its new value (the pool,
    the page table and the adapter stack rely on it)."""
    w = torch.ones(4)
    exe = graphs.Executable(_toy, bake=(0,))
    x = torch.full((4,), 0.5)
    for _ in range(3):
        exe(w, x, 0)
    w.mul_(2.0)
    got, _ = exe(w, x, 0)
    torch.testing.assert_close(got, torch.tanh(2.0 * x), rtol=0, atol=0)


# ---------------- DecodeEngine: graphed against eager ----------------

def _cfg():
    """stablelm-1.6b cut to two layers of width 256 with head dim 64 (the
    kernels' head dims), small enough for the CPU."""
    return dataclasses.replace(get_config("stablelm-1.6b"), num_layers=2,
                               d_model=256, num_heads=4, num_kv_heads=4,
                               head_dim=64, d_ff=512, vocab_size=512)


def _fm(dev, n_adapters=3):
    cfg = _cfg()
    fm = PhysicalFM(cfg, seed=0, input_len=8, lora_rank=4,
                    lora_impl="segmented", seg_block_t=8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    for i in range(n_adapters):
        tree = lora_mod.init_single_adapter(gen, cfg, 4, device=dev)
        fm.adapters.add(f"lora{i}", tree_map(
            lambda t: torch.randn(t.shape, generator=gen, device=dev) * 0.15,
            tree))
    return fm


NAMES = ["lora0", "lora2", None, "lora1"]
KINDS = {
    "dense": dict(num_slots=4, prompt_len=16, max_new=10, chunk=2),
    # 13 usable pages of 4 for 4 slots of up to 16 + 10 tokens: joins defer
    # and streams are preempted; chunked prefill and a low refresh factor
    # put tail admissions and scale refreshes on the path
    "paged": dict(num_slots=4, prompt_len=16, max_new=10, chunk=2,
                  paged=True, page_size=4, total_pages=14,
                  chunked_prefill=True, scale_refresh=1.02),
}


def _prompts(vocab, n=14, seed=3):
    """Variable-length prompts; every third starts with one shared
    8-token prefix (two full pages; served under one adapter)."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, vocab, 8).astype(np.int32)
    out = []
    for i in range(n):
        p = rng.randint(0, vocab, int(rng.randint(2, 17))).astype(np.int32)
        if i % 3 == 0:
            p = np.concatenate([prefix, p])[:16]
        out.append(p)
    return out


def _host_state(eng) -> dict:
    s = {"slots": [None if x is None else (x.rid, list(x.tokens), x.status,
                                           x.done) for x in eng.slots],
         "pending": eng.pending_rids(),
         "counters": [eng.admissions, eng.tail_tokens_computed,
                      eng.quarantines, eng.steps],
         "compile_count": eng.compile_count(),
         "tokens": eng._tokens.cpu().tolist(),
         "slot_adapters": eng._slot_adapters.tolist()}
    if eng.paged:
        s.update(ptab=eng._ptab.tolist(), refs=eng._page_refs.tolist(),
                 free=list(eng._free_pages), held=eng._held.tolist(),
                 lens=eng._lens.tolist(),
                 registry=sorted(eng._prefix_registry.items()),
                 page_float=sorted(eng._page_float),
                 paged_counters=[eng.deferrals, eng.preemptions,
                                 eng.prefix_hits, eng.shared_pages_mapped,
                                 eng.prefill_tokens_saved,
                                 eng.scale_refreshes])
    return s


def _same(eg, ee):
    assert _host_state(eg) == _host_state(ee)
    for gsub, esub in zip(eg.pool, ee.pool):
        for name in gsub:
            assert torch.equal(gsub[name], esub[name]), name


def _lockstep(dev, kind):
    """The same churn script through a graphed engine and, in lockstep, the
    same engine under ``graphs.disabled()`` on the same FM: compare after
    every engine call. Returns the graphed engine."""
    fm = _fm(dev)
    eg = DecodeEngine(fm, **KINDS[kind])
    ee = DecodeEngine(fm, **KINDS[kind])

    def both(method, *a, **kw):
        got = getattr(eg, method)(*a, **kw)
        with graphs.disabled():
            want = getattr(ee, method)(*a, **kw)
        if method == "step_chunk":
            got = [(s.rid, s.tokens, s.status) for s in got]
            want = [(s.rid, s.tokens, s.status) for s in want]
        assert got == want
        _same(eg, ee)
    prompts = _prompts(fm.cfg.vocab_size)
    i = 0
    while i < len(prompts) or eg.active_count() or eg.pending_count():
        for _ in range(2):
            if i < len(prompts) and (eg.paged or eg.free_slots()):
                both("join", f"t{i}", prompts[i],
                     adapter_id="lora0" if i % 3 == 0 else NAMES[i % 4],
                     max_new_tokens=4 + i % 7, rid=i)
                i += 1
        both("step_chunk")
    return eg


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_graphed_engine_matches_eager_in_lockstep(kind):
    eg = _lockstep("cpu", kind)
    assert eg.admissions >= 14
    if kind == "paged":
        assert eg.deferrals > 0 and eg.preemptions > 0
        assert eg.prefill_tokens_saved > 0 and eg.scale_refreshes >= 3
    # the planes were called past their capture
    assert all(e.calls >= 3 for e in eg._fn_decode.values())
    assert any(e.calls >= 3 for e in eg._fn_write.values())
    assert any(e.calls >= 3 for e in eg._fn_prefill.values())
    if kind == "paged":
        assert eg._fn_rescale.calls >= 3


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_graphed_engine_matches_eager_in_lockstep_on_cuda(cuda_device, kind):
    eg = _lockstep(cuda_device, kind)
    assert all(e.captured for e in eg._fn_decode.values())


def _serve(eng, prompts, warm: bool):
    if warm:
        eng.warm_decode_ladder()
    for i in range(eng.num_slots):
        eng.join(f"t{i}", prompts[i], adapter_id=NAMES[i], max_new_tokens=9,
                 rid=i)
    done = eng.drain()
    return sorted((s.rid, s.tokens) for s in done)


def test_new_decode_key_under_live_streams_matches_a_warmed_engine():
    """The unwarmed engine meets its decode key (call 1, eager, then the
    capture) with four live streams; the warmed one captured it idle. A
    warm-up that ran on the live pool would advance the streams twice."""
    fm = _fm("cpu")
    prompts = _prompts(fm.cfg.vocab_size)
    warmed = DecodeEngine(fm, **KINDS["dense"])
    cold = DecodeEngine(fm, **KINDS["dense"])
    want = _serve(warmed, prompts, warm=True)
    assert all(e.calls >= 2 for e in warmed._fn_decode.values())
    assert _serve(cold, prompts, warm=False) == want
    for gsub, csub in zip(warmed.pool, cold.pool):
        assert torch.equal(gsub["len"], csub["len"])


def test_page_table_never_moves():
    fm = _fm("cpu")
    eng = DecodeEngine(fm, **KINDS["paged"])
    ptr = eng._ptab_dev.data_ptr()
    leaves = [sub["page_table"] for sub in eng.pool if "page_table" in sub]
    sync = eng._sync_page_table
    syncs = []

    def checked():
        sync()
        syncs.append(1)
        assert eng._ptab_dev.data_ptr() == ptr
        for sub in eng.pool:
            if "page_table" in sub:
                assert sub["page_table"].data_ptr() == ptr
        np.testing.assert_array_equal(eng._ptab_dev.numpy(), eng._ptab)
    eng._sync_page_table = checked
    for i, p in enumerate(_prompts(fm.cfg.vocab_size, n=8)):
        eng.join(f"t{i}", p, adapter_id=NAMES[i % 4], max_new_tokens=6,
                 rid=i)
        eng.step_chunk()
    eng.drain()
    assert len(syncs) > 5 and all(x.data_ptr() == ptr for x in leaves)


def test_adapter_stack_never_moves_within_capacity():
    fm = _fm("cpu", n_adapters=3)
    store = fm.adapters
    ptrs = [t.data_ptr() for t in tree_leaves(store.stacked())]

    def rebuilt():
        trees = store._trees + [store._zero_tree()
                                for _ in range(store.capacity() - len(store))]
        return lora_mod.stack_adapters(trees)

    def check():
        now = tree_leaves(store.stacked())
        assert [t.data_ptr() for t in now] == ptrs
        for a, b in zip(now, tree_leaves(rebuilt())):
            assert torch.equal(a, b)
    store.remove("lora1")                       # slots shift down
    check()
    store.add("lora3", tree_map(lambda t: t + 0.5, store._trees[0]))
    check()
    store.remove("lora0")
    store.remove("lora2")
    check()
    # a pooled executable keeps serving after the churn, as eager does
    x = np.random.RandomState(0).randn(2, 8, fm.cfg.d_model).astype(np.float32)
    idx = np.array([0, store.capacity()], np.int32)
    for _ in range(3):
        got = fm.run_batch(x, idx)
    with graphs.disabled():
        want = fm.run_batch(x, idx)
    np.testing.assert_array_equal(got, want)


def test_adapter_churn_within_capacity_adds_no_key():
    """Streams, then an adapter removed and another added (the capacity
    holds), then streams again: the graphed engine adds no executable and
    serves what the eager engine serves, call by call."""
    fm = _fm("cpu")
    eg = DecodeEngine(fm, **KINDS["dense"])
    ee = DecodeEngine(fm, **KINDS["dense"])
    prompts = _prompts(fm.cfg.vocab_size)

    def serve(names, rid0):
        for eng in (eg, ee):
            with graphs.disabled() if eng is ee else _nothing():
                for i, name in enumerate(names):
                    eng.join(f"t{i}", prompts[i], adapter_id=name,
                             max_new_tokens=5, rid=rid0 + i)
                done = eng.drain()
            yield sorted((d.rid, d.tokens) for d in done)
    a, b = serve(["lora0", "lora1", "lora2", None], 0)
    assert a == b
    keys = eg.compile_count()
    fm.adapters.remove("lora1")
    fm.adapters.add("lora3", tree_map(lambda t: t * -1.0,
                                      fm.adapters._trees[0]))
    a, b = serve(["lora3", "lora2", "lora0", "lora3"], 4)
    assert a == b and eg.compile_count() == keys


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.cuda
def test_graphed_pooled_forward_matches_eager_on_cuda(cuda_device):
    fm = _fm(cuda_device)
    rng = np.random.RandomState(1)
    for b in (1, 3, 8):
        x = rng.randn(b, 8, fm.cfg.d_model).astype(np.float32)
        idx = (np.arange(b) % 4).astype(np.int32)
        for _ in range(3):
            got = fm.run_batch(x, idx)
        with graphs.disabled():
            want = fm.run_batch(x, idx)
        np.testing.assert_array_equal(got, want)
    assert all(e.captured for fns in fm._fn_cache.values()
               for e in fns.values())


# ---------------- compile_count against the JAX package ----------------

@pytest.fixture(scope="module")
def jax_pair():
    """The JAX FM and the port's FM (reduced stablelm-1.6b, the JAX
    weights converted), segmented LoRA, two adapters."""
    jcfg = jreduced(jget_config("stablelm-1.6b"))
    cfg = reduced(get_config("stablelm-1.6b"))
    jfm = JPhysicalFM(jcfg, seed=0, input_len=8, lora_rank=4,
                      lora_impl="segmented", seg_block_t=8)
    fm = PhysicalFM(cfg, seed=0, input_len=8, lora_rank=4,
                    lora_impl="segmented", seg_block_t=8, device="cpu",
                    params=weights.to_torch(
                        jax.tree.map(np.asarray, jfm.params), device="cpu"))
    for i in range(2):
        tree = jfm.adapters._mod.init_single_adapter(
            jax.random.PRNGKey(i), jcfg, 4)
        jfm.adapters.add(f"lora{i}", tree)
        fm.adapters.add(f"lora{i}", weights.adapter_tree(
            jax.tree.map(np.asarray, tree), device="cpu"))
    return jfm, fm, cfg


def test_pooled_compile_count_equals_jax(jax_pair):
    """Batch sizes across buckets and two input lengths: one executable per
    (bucket, slot bucket, impl) and length, as ``jax.jit`` traces one per
    input shape."""
    jfm, fm, cfg = jax_pair
    rng = np.random.RandomState(2)
    for b, s in ((1, 8), (2, 8), (3, 8), (1, 4), (5, 8), (3, 4), (1, 8),
                 (8, 4), (2, 8), (4, 4)):
        x = rng.randn(b, s, cfg.d_model).astype(np.float32)
        idx = (np.arange(b) % 3).astype(np.int32)
        jfm.run_batch(x, idx)
        fm.run_batch(x, idx)
        assert fm.compile_count() == jfm.compile_count()
    assert fm.compile_count() == 7


def test_dense_engine_compile_count_equals_jax(jax_pair):
    jfm, fm, cfg = jax_pair
    kw = dict(num_slots=4, prompt_len=8, max_new=6, chunk=2)
    jeng, eng = JDecodeEngine(jfm, **kw), DecodeEngine(fm, **kw)
    names = ["lora0", None, "lora1"]
    for step in range(10):
        for e in (jeng, eng):
            if step < 7 and e.free_slots():
                p = np.random.RandomState(step).randint(
                    0, cfg.vocab_size, 1 + (3 * step) % 8).astype(np.int32)
                e.join(f"t{step}", p, adapter_id=names[step % 3],
                       max_new_tokens=2 + step % 4, rid=step)
            e.step_chunk()
        assert eng.compile_count() == jeng.compile_count()
    assert eng.compile_count() >= 3

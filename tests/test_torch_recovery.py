"""The port's durability plane against the JAX package's, on reduced
stablelm-1.6b and reduced whisper-base with the JAX weights and adapters
converted to the port:

* the host spill arena: the same put/get/peek/pop/evict sequence on both
  arenas with the same numpy blobs gives the same entries, bytes, counters
  and digests;
* the spill tier in the engine, teacher-forced against the JAX engine on
  ``tests/test_recovery.py``'s pressured pair (10 pages, 64 MiB arena): the
  host state (page tables, refcounts, free list, registry, spill counters,
  the arena's keys and bytes) equal after every call, logits within
  ``tests/test_torch_paged.py``'s paged bound;
* the port against itself where JAX's tests hold JAX against itself:
  sampled spill resume equal to the unpressured run, the budget-eviction
  fallback, corruption recomputed, a prefix spilled across an idle gap and
  a chunked sharer behind a restored prefix;
* snapshot/restore: mid-flight parity with the executables reused (no new
  key, none captured again, no second pool, every pool element rewritten:
  equal to a restore into a fresh pool), a tampered page, the disk round
  trip; the serve loop's ``checkpoint_restart`` under load and the device
  reset fault; whisper's cross state through a snapshot, teacher-forced
  against the JAX engine with the host state (``state_pool`` included)
  equal after every call;
* planted faults that each must be caught: a reused restore whose pool
  leaf is then replaced, a device reset that swaps leaves instead of
  scrambling them in place, a restore that skips zeroing unused pages.

Tolerances: host state and tokens of the port against itself are exact;
logits against JAX are bounded as in test_torch_paged.py (0.75: two bf16
models round in different places and the int8 cache carries the code
noise) and test_torch_encdec.py (whisper 1.0: the encoder's bf16 noise
reaches every cross-attention).
"""
import pytest

torch = pytest.importorskip("torch")

import time  # noqa: E402
import warnings  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core.decode_engine import DecodeEngine as JDecodeEngine  # noqa: E402
from repro.core.physical import PhysicalFM as JPhysicalFM  # noqa: E402
from repro.core.spill import HostSpillArena as JHostSpillArena  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import decode_engine as de  # noqa: E402
from repro_torch.core.decode_engine import DecodeEngine  # noqa: E402
from repro_torch.core.physical import PhysicalFM  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.core.spill import HostSpillArena  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.faults import (DeviceResetFault,  # noqa: E402
                                        SpillCorruptionFault, scramble_arena)
from repro_torch.serving.metrics import failure_counters  # noqa: E402

BT = 8
ADAPTER_SCALE = 0.05          # tests/test_recovery.py's adapter
PAGED_LOGIT_TOL = 0.75        # tests/test_torch_paged.py's bound
WHISPER_LOGIT_TOL = 1.0       # tests/test_torch_encdec.py's bound
ENC_LEN = 12


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite runs in parallel workers on shared
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _randomized_adapter(jfm, i, scale=ADAPTER_SCALE):
    tree = jfm.adapters._mod.init_single_adapter(
        jax.random.PRNGKey(i), jfm.cfg, jfm.adapters.rank)
    leaves, tdef = jax.tree.flatten(tree)
    ks = jax.random.split(jax.random.PRNGKey(100 + i), len(leaves))
    return jax.tree.unflatten(tdef, [
        jax.random.normal(k, leaf.shape, leaf.dtype) * scale
        for k, leaf in zip(ks, leaves)])


def _pair(arch, n_adapters):
    jcfg = jreduced(jget_config(arch))
    cfg = reduced(get_config(arch))
    jfm = JPhysicalFM(jcfg, seed=0, input_len=8, lora_rank=4,
                      lora_impl="segmented", seg_block_t=BT)
    fm = PhysicalFM(cfg, seed=0, input_len=8, lora_rank=4,
                    lora_impl="segmented", seg_block_t=BT, device="cpu",
                    params=weights.to_torch(jax.tree.map(np.asarray,
                                                         jfm.params),
                                            device="cpu"))
    for i in range(n_adapters):
        tree = _randomized_adapter(jfm, i)
        jfm.adapters.add(f"lora{i}", tree)
        fm.adapters.add(f"lora{i}", weights.adapter_tree(
            jax.tree.map(np.asarray, tree), device="cpu"))
    return jfm, fm, cfg


@pytest.fixture(scope="module")
def fms():
    return _pair("stablelm-1.6b", 1)


def _prompts(cfg, seed=1, n=2, plen=8):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab_size, plen).astype(np.int32)
            for _ in range(n)]


# ---------------- the host spill arena ----------------

def test_spill_arena_matches_jax_arena():
    """One put/get/peek/pop sequence with LRU evictions, a same-key
    replacement, an over-budget skip and a corrupted entry, on both arenas
    with the same numpy blobs: entries (in LRU order), bytes, counters and
    digests equal after every operation, and the corrupted entry fails
    verification on both."""
    rng = np.random.RandomState(0)

    def blob(n):
        return [{"k": rng.randint(-127, 128, (2, n, 4)).astype(np.int8),
                 "k_scale": rng.rand(2, n).astype(np.float32)}]
    ops = [("put", "a", blob(4)), ("put", "b", blob(4)), ("get", "a"),
           ("put", "c", blob(4)), ("peek", "b"), ("get", "b"),
           ("put", "big", blob(40)), ("put", "a", blob(2)), ("pop", "c"),
           ("get", "zz"), ("put", "d", blob(5)), ("put", "e", blob(3))]
    arenas = (HostSpillArena(140), JHostSpillArena(140))

    def state(a):
        return ([(k, e.nbytes, e.digest) for k, e in a._entries.items()],
                a.bytes_in_use, a.spills, a.skips, a.evictions, a.hits,
                a.misses)
    for op in ops:
        outs = []
        for a in arenas:
            if op[0] == "put":
                outs.append(a.put(op[1], [{k: v.copy() for k, v in d.items()}
                                          for d in op[2]]))
            else:
                e = getattr(a, op[0])(op[1])
                outs.append(None if e is None else e.digest)
        assert outs[0] == outs[1], op
        assert state(arenas[0]) == state(arenas[1]), op
    assert arenas[0].evictions >= 1 and arenas[0].skips == 1
    for a in arenas:
        e = next(iter(a._entries.values()))
        d = e.blob[0]["k"]
        d.view(np.uint8).reshape(-1)[::3] ^= 0xFF
        assert not e.verify()


# ---------------- the spill tier, teacher-forced against JAX ----------------

PAIR_KW = dict(num_slots=2, prompt_len=8, chunk=4, paged=True, page_size=4,
               top_k=8)


def _spill_state(eng):
    sp = eng.spill
    return {
        "ptab": eng._ptab.tolist(), "refs": eng._page_refs.tolist(),
        "free": list(eng._free_pages), "held": eng._held.tolist(),
        "lens": eng._lens.tolist(), "registry": dict(eng._prefix_registry),
        "page_key": dict(eng._page_key), "pending": eng.pending_rids(),
        "slots": [None if s is None else (s.rid, list(s.tokens), s.done,
                                          s.status) for s in eng.slots],
        "counters": [eng.preemptions, eng.deferrals, eng.admissions,
                     eng.steps, eng.spilled_pages, eng.restored_pages,
                     eng.spill_resumes, eng.spill_prefix_hits,
                     eng.digest_failures],
        "arena": None if sp is None else (
            [(k, e.nbytes) for k, e in sp._entries.items()],
            sp.bytes_in_use, sp.spills, sp.skips, sp.evictions),
        "resumes": [kind for kind, _ in eng.resume_costs],
    }


def _drive_pair(eng, cfg, max_new=24):
    """``_run_pair``'s script: two streams joined, then chunks until both
    retire; the host state after every call."""
    states = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for i, p in enumerate(_prompts(cfg)):
            eng.join(f"t{i}", p, adapter_id="lora0", max_new_tokens=max_new,
                     rid=i)
            states.append(_spill_state(eng))
        done = []
        while eng.active_count() or eng.pending_count():
            done += eng.step_chunk()
            states.append(_spill_state(eng))
    return states, {d.rid: d.tokens for d in done}


def _jax_recorder(jeng):
    calls = []

    def jsample(logits, keys):
        jax.debug.callback(lambda l: calls.append(np.asarray(l, np.float32)),
                           logits, ordered=True)
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), keys
    jeng._sample = jsample
    return calls


def _teacher(cur, jcalls, calls):
    """A port sampler fed the argmax of the matching JAX call, recording the
    port's logits and which rows were live (``cur["eng"]``: the engine
    being driven, swapped after a restore)."""
    def teacher(logits, gens):
        want = jcalls[len(calls)]
        eng = cur["eng"]
        live = np.ones(1, bool) if logits.shape[0] == 1 else np.array(
            [s is not None and not s.done for s in eng.slots])
        calls.append((logits.float().numpy(), live))
        return torch.as_tensor(want.argmax(-1), dtype=torch.int32), gens
    return teacher


def _worst(calls, jcalls):
    return max(np.abs(got[live] - want[live]).max()
               for (got, live), want in zip(calls, jcalls) if live.any())


def test_spill_engine_teacher_forced_against_jax(fms):
    """The pressured pair (10 pages, a 64 MiB arena) through both engines,
    greedy and teacher-forced: preemption spills a stream and resumes it
    from the host, and a released prefix spills; the host state, the spill
    counters and the arena's keys and bytes equal the JAX engine's after
    every call, and the logits stay within the paged bound."""
    jfm, fm, cfg = fms
    kw = dict(PAIR_KW, max_new=24, total_pages=10, spill_bytes=64 << 20)
    jeng = JDecodeEngine(jfm, **kw)
    jcalls = _jax_recorder(jeng)
    jstates, jdone = _drive_pair(jeng, cfg)
    eng = DecodeEngine(fm, **kw)
    calls = []
    eng._sample = _teacher({"eng": eng}, jcalls, calls)
    states, done = _drive_pair(eng, cfg)
    assert len(calls) == len(jcalls) and len(states) == len(jstates)
    for got, want in zip(states, jstates):
        assert got == want
    assert _worst(calls, jcalls) <= PAGED_LOGIT_TOL
    assert done == jdone
    assert eng.preemptions > 0 and eng.spill_resumes > 0
    assert eng.spilled_pages > 0 and eng.restored_pages > 0
    assert eng.digest_failures == 0
    assert eng.free_page_count() == eng.total_pages - 1


def _run_pair(fm, cfg, total_pages, *, spill_bytes=0, max_new=24,
              temperature=0.7):
    eng = DecodeEngine(fm, **PAIR_KW, max_new=max_new,
                       total_pages=total_pages, spill_bytes=spill_bytes,
                       temperature=temperature)
    _, done = _drive_pair(eng, cfg, max_new)
    return eng, done


def test_sampled_spill_resume_equals_unpressured_run(fms):
    """A preempted SAMPLED stream resumed from its host spill (pages,
    scales, trackers, last token and its generator's state) gives the
    exact tokens of a run never preempted."""
    _, fm, cfg = fms
    ref_eng, ref = _run_pair(fm, cfg, 40)
    assert ref_eng.preemptions == 0
    eng, got = _run_pair(fm, cfg, 10, spill_bytes=64 << 20)
    assert eng.preemptions > 0 and eng.spill_resumes > 0
    assert eng.spilled_pages > 0 and eng.restored_pages > 0
    assert eng.digest_failures == 0
    assert got == ref
    assert all(kind == "spill" for kind, _ in eng.resume_costs)
    assert eng.free_page_count() == eng.total_pages - 1


def test_spill_budget_eviction_falls_back_to_reprefill(fms):
    _, fm, cfg = fms
    eng, got = _run_pair(fm, cfg, 10, spill_bytes=1, temperature=0.0)
    assert eng.preemptions > 0 and eng.spill_resumes == 0
    assert eng.spill.skips > 0
    assert all(kind == "reprefill" for kind, _ in eng.resume_costs)
    assert all(len(t) == 24 for t in got.values())
    assert eng.free_page_count() == eng.total_pages - 1


def test_spill_corruption_detected_and_recomputed(fms):
    _, fm, cfg = fms
    eng = DecodeEngine(fm, **PAIR_KW, max_new=24, total_pages=10,
                       spill_bytes=64 << 20, temperature=0.0)

    class _Loop:                                 # faults.py's view of a loop
        def _engine(self):
            return eng

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for i, p in enumerate(_prompts(cfg)):
            eng.join(f"t{i}", p, adapter_id="lora0", max_new_tokens=24,
                     rid=i)
        corrupted = 0
        done = []
        for _ in range(200):
            if len(eng.spill) and not corrupted:
                fault = SpillCorruptionFault(1.0)
                fault.inject(_Loop())
                corrupted = fault.corrupted
            done += eng.step_chunk()
            if len(done) == 2:
                break
    assert corrupted > 0 and eng.preemptions > 0
    assert eng.digest_failures >= 1
    assert sorted(d.rid for d in done) == [0, 1]
    assert all(len(d.tokens) == 24 for d in done)
    assert eng.free_page_count() == eng.total_pages - 1


def _idle_gap(eng, pfx):
    """``test_prefix_spill_survives_idle_gap``'s script; returns the three
    streams and the counters after each phase."""
    eng.join("a", pfx, adapter_id="lora0", max_new_tokens=4, rid=10)
    (d1,) = eng.drain()
    after_first = (len(eng._prefix_registry), eng.spilled_pages)
    eng.join("b", pfx, adapter_id="lora0", max_new_tokens=4, rid=11)
    after_restore = (eng.spill_prefix_hits, eng.restored_pages,
                     len(eng._prefix_registry))
    eng.join("c", pfx, adapter_id="lora0", max_new_tokens=4, rid=12)
    done = {d.rid: d for d in eng.drain()}
    return d1, done, (after_first, after_restore, eng.prefix_hits,
                      eng.prefill_tokens_saved, eng.free_page_count())


def test_prefix_spill_survives_idle_gap_and_rededuplicates(fms):
    """A registered prefix whose last sharer retires spills to the host; a
    later join restores it (chunked: the leading pages, the last one
    recomputed privately), registers it again, and a third join maps the
    live restored pages. Same tokens in all three streams; the counters at
    every phase equal the JAX engine's on the same script."""
    jfm, fm, cfg = fms
    kw = dict(num_slots=2, prompt_len=16, max_new=6, chunk=2, paged=True,
              page_size=4, total_pages=20, spill_bytes=64 << 20,
              prompt_buckets=(8, 16))
    (pfx,) = _prompts(cfg, seed=5, n=1)
    d1, done, counts = _idle_gap(DecodeEngine(fm, **kw), pfx)
    _, _, jcounts = _idle_gap(JDecodeEngine(jfm, **kw), pfx)
    assert counts == jcounts
    (n_reg, spilled), (hits, restored, n_reg2), prefix_hits = counts[:3]
    assert n_reg == 0 and spilled >= 2
    assert hits == 1 and restored >= 1 and n_reg2 > 0
    assert prefix_hits >= 1
    assert done[11].tokens == d1.tokens == done[12].tokens
    assert counts[-1] == kw["total_pages"] - 1


def test_chunked_sharer_after_prefix_spill_restore(fms):
    """``tests/test_chunked_prefill.py``'s sharer joining after the
    prefix's last holder retired: the chunked engine restores the leading
    pages from the host (their float sidecars with them) and prefills the
    tail; its tokens equal the full-prefill engine's."""
    _, fm, cfg = fms
    rng = np.random.RandomState(34)
    prefix = rng.randint(0, cfg.vocab_size, 8).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.randint(0, cfg.vocab_size, 1 + i)
                               .astype(np.int32)]) for i in range(2)]
    ref = {}
    for chunked in (False, True):
        eng = DecodeEngine(fm, num_slots=4, prompt_len=16, max_new=6,
                           chunk=2, paged=True, page_size=4,
                           chunked_prefill=chunked, spill_bytes=64 << 20)
        eng.join("hold", prompts[0], adapter_id="lora0", max_new_tokens=6,
                 rid=0)
        (d0,) = eng.drain()
        assert len(eng._prefix_registry) == 0 and eng.spilled_pages > 0
        eng.join("late", prompts[1], adapter_id="lora0", max_new_tokens=6,
                 rid=1)
        if chunked:
            assert eng.spill_prefix_hits == 1 and eng.restored_pages >= 1
            assert eng.prefill_tokens_saved > 0
            # the float-mode tail ran: the restored pages' sidecars came back
            assert set(eng._page_float) >= {int(p) for p in eng._ptab[0, :2]}
        (d1,) = eng.drain()
        ref[chunked] = (d0.tokens, d1.tokens)
    assert ref[True] == ref[False]


# ---------------- engine snapshot / restore ----------------

MID_KW = dict(num_slots=2, prompt_len=8, max_new=12, chunk=2, paged=True,
              page_size=4, total_pages=20, top_k=8)


def _midflight(fm, cfg, spill_bytes=0, temperature=0.7):
    eng = DecodeEngine(fm, **MID_KW, temperature=temperature,
                       spill_bytes=spill_bytes)
    for i, p in enumerate(_prompts(cfg)):
        eng.join(f"t{i}", p, adapter_id="lora0", max_new_tokens=12,
                 rid=100 + i)
    eng.step_chunk()
    eng.step_chunk()
    return eng


def _executables(eng):
    """Every executable of the engine by shape key, with its call state."""
    out = {}
    for name in DecodeEngine._EXECUTABLES:
        v = getattr(eng, name)
        items = v.items() if isinstance(v, dict) else [(None, v)]
        for k, e in items:
            if e is not None:
                out[(name, k)] = (e, e.captured, e._cuda)
    return out


def _pool_diffs(a, b) -> list:
    """Names of the pool tensors where engines ``a`` and ``b`` differ."""
    return [(j, k) for j, (sa, sb) in enumerate(zip(a.pool, b.pool))
            for k in sa if not torch.equal(sa[k], sb[k])]


def _restored_pair(fm, snap, old):
    """The snapshot restored twice: reusing ``old`` (whose arena is
    scrambled in place first, as a device reset leaves it) and into a fresh
    pool."""
    scramble_arena(old)
    return (DecodeEngine.restore(fm, snap, reuse_jits_from=old),
            DecodeEngine.restore(fm, snap))


def test_snapshot_restore_midflight_parity_and_executable_reuse(
        fms, monkeypatch):
    """A sampled mid-flight snapshot restored over the old engine's
    scrambled arena, reusing its executables: every stream continues
    exactly as an uninterrupted run; no pool is allocated; the restored
    engine holds the old pool, page table and token buffer, every element
    equal to a restore into a fresh pool; ``compile_count`` and the
    executables (and which of them hold a graph) do not change."""
    _, fm, cfg = fms
    ref = {d.rid: d.tokens for d in _midflight(fm, cfg).drain()}
    eng = _midflight(fm, cfg)
    snap = eng.snapshot()
    keys, exes = eng.compile_count(), _executables(eng)
    pools = []
    init_cache = lm.init_cache

    def counting(*a, **kw):
        if kw.get("paged"):
            pools.append(1)
        return init_cache(*a, **kw)
    monkeypatch.setattr(lm, "init_cache", counting)
    scramble_arena(eng)
    eng2 = DecodeEngine.restore(fm, snap, reuse_jits_from=eng)
    assert not pools                            # no second pool
    fresh = DecodeEngine.restore(fm, snap)
    assert len(pools) == 1                      # a fresh restore allocates
    monkeypatch.undo()
    assert eng2.pool is eng.pool and eng2._ptab_dev is eng._ptab_dev
    assert eng2._tokens is eng._tokens
    assert _pool_diffs(eng2, fresh) == []
    assert torch.equal(eng2._ptab_dev, fresh._ptab_dev)
    got = {d.rid: d.tokens for d in eng2.drain()}
    assert got == ref
    assert eng2.digest_failures == 0
    assert eng2.compile_count() == keys
    assert _executables(eng2) == exes
    assert eng2.free_page_count() == eng2.total_pages - 1


def test_snapshot_digest_detects_tampered_page(fms):
    """A page whose content no longer matches its digest is never served:
    the stream mapping it re-queues through the fold and still finishes
    its budget."""
    _, fm, cfg = fms
    eng = _midflight(fm, cfg, spill_bytes=64 << 20, temperature=0.0)
    snap = eng.snapshot()
    snap.pages[0] = dict(snap.pages[0])
    snap.pages[0]["k"] = np.array(snap.pages[0]["k"])
    snap.pages[0]["k"][:, 0] ^= 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        eng2 = DecodeEngine.restore(fm, snap, reuse_jits_from=eng)
        assert eng2.digest_failures >= 1
        done = {d.rid: d for d in eng2.drain()}
    assert sorted(done) == [100, 101]
    assert all(len(d.tokens) == 12 for d in done.values())
    assert eng2.free_page_count() == eng2.total_pages - 1


def test_snapshot_disk_round_trip(fms, tmp_path):
    """npz + json and back, restored without reuse (a fresh pool and fresh
    executables, as a restore in another process): the same
    continuation."""
    _, fm, cfg = fms
    ref = {d.rid: d.tokens for d in _midflight(fm, cfg).drain()}
    eng = _midflight(fm, cfg)
    snap = eng.snapshot()
    out = ckpt.save_snapshot(tmp_path / "snap", snap)
    assert out.exists()
    loaded = ckpt.load_snapshot(tmp_path / "snap")
    assert loaded.page_digests == snap.page_digests
    assert loaded.config == snap.config
    eng2 = DecodeEngine.restore(fm, loaded)
    assert eng2.pool is not eng.pool and eng2.compile_count() == 0
    assert {d.rid: d.tokens for d in eng2.drain()} == ref
    assert eng2.digest_failures == 0


# ---------------- planted faults ----------------

def test_planted_reused_restore_with_a_replaced_pool_leaf_raises(fms):
    """Reused executables bake the pool by storage: a leaf replaced after a
    reused restore (as the JAX package's restore would build new arrays)
    makes the next decode raise instead of replaying against dead
    memory."""
    _, fm, cfg = fms
    eng = _midflight(fm, cfg, temperature=0.0)
    eng2 = DecodeEngine.restore(fm, eng.snapshot(), reuse_jits_from=eng)
    eng2.pool[0]["k"] = eng2.pool[0]["k"].clone()
    with pytest.raises(ValueError, match="baked tensor"):
        eng2.step_chunk()


def test_planted_device_reset_that_swaps_leaves_is_caught(fms):
    """A device reset that SWAPS the old arena's leaves for new tensors
    (instead of scrambling them in place) hands the restore storages the
    executables never baked: the next decode raises."""
    _, fm, cfg = fms
    eng = _midflight(fm, cfg, temperature=0.0)
    snap = eng.snapshot()
    for sub in eng.pool:
        sub["k"] = torch.full_like(sub["k"], 77)
        sub["v"] = torch.full_like(sub["v"], -77)
    eng2 = DecodeEngine.restore(fm, snap, reuse_jits_from=eng)
    with pytest.raises(ValueError, match="baked tensor"):
        eng2.step_chunk()


def test_planted_restore_that_skips_zeroing_is_caught(fms, monkeypatch):
    """A restore that writes the used pages but leaves the rest of the
    scrambled arena in place differs from a restore into a fresh pool,
    which is what the mid-flight test compares."""
    _, fm, cfg = fms
    eng = _midflight(fm, cfg, temperature=0.0)
    snap = eng.snapshot()

    def no_zero(t, idx, vals):
        if idx.numel():
            t.index_copy_(1, idx, vals)
    monkeypatch.setattr(de, "_fill_pages", no_zero)
    eng2, fresh = _restored_pair(fm, snap, eng)
    assert {k for _, k in _pool_diffs(eng2, fresh)} >= {"k", "v"}


# ---------------- serve loop: checkpoint_restart + device reset ----------

@pytest.fixture(scope="module")
def served(fms):
    from repro_torch.core.server import FMplexServer
    from repro_torch.core.vfm import TaskExtensions
    _, fm, cfg = fms
    fm.calibrate(sizes=(1, 2))
    srv = FMplexServer("s0")
    srv.deploy_fm("fm0", fm, scheduler="bfq")
    rng = np.random.RandomState(0)
    w = rng.randn(cfg.d_model, 2).astype(np.float32) * 0.1
    srv.bind_task("task0", "fm0", weight=1.0,
                  extensions=TaskExtensions(decoder=lambda f: f @ w,
                                            adapter_id="lora0"))
    loop = srv.serve_loop("fm0", engine_kwargs=dict(
        num_slots=2, prompt_len=8, max_new=16, chunk=2,
        paged=True, page_size=4, spill_bytes=64 << 20))
    loop.warmup(pooled_task="task0", gen_task="task0")
    return srv, cfg, loop


def _gen(cfg, rng, t=0.0, new=8):
    return Request("task0", t,
                   payload=rng.randint(0, cfg.vocab_size, 8).astype("int32"),
                   tokens=float(8 + new), max_new_tokens=new)


def test_loop_checkpoint_restart_under_load(served):
    """checkpoint_restart mid-flight loses nothing: in-flight streams
    finish ok with full budgets and carry ``resets_survived``; no key is
    added and the restored engine holds the old pool."""
    srv, cfg, loop = served
    rng = np.random.RandomState(3)
    reqs = [_gen(cfg, rng, new=10) for _ in range(3)]
    for r in reqs:
        loop.submit(r, time.perf_counter())
    while not srv.engines["fm0"].active_count():
        loop.tick()
    old = srv.engines["fm0"]
    keys = old.compile_count()
    r0 = loop.failures["resets_survived"]
    inflight = set(loop._inflight)
    loop.checkpoint_restart()
    new = srv.engines["fm0"]
    assert new is not old and new.pool is old.pool
    while loop._work_left():
        loop.tick()
    assert loop.failures["resets_survived"] == r0 + 1
    assert all(r.ok and len(r.result) == 10 for r in reqs)
    assert inflight and all(
        r.resets_survived == (1 if r.rid in inflight else 0) for r in reqs)
    fc = failure_counters(reqs, loop=loop, engine=new)
    assert fc["resets_survived"] >= 1 and fc["digest_failures"] == 0
    assert new.compile_count() == keys
    assert new.free_page_count() == new.total_pages - 1


def test_device_reset_fault_scrambles_then_survives(served):
    """The device reset scrambles the old arena in place, then restores
    over it: token parity with a fault-free run is exact."""
    srv, cfg, loop = served
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, cfg.vocab_size, 8).astype("int32")
               for _ in range(2)]

    def run(reset: bool):
        reqs = [Request("task0", 0.0, payload=p, tokens=16.0,
                        max_new_tokens=8) for p in prompts]
        for r in reqs:
            loop.submit(r, time.perf_counter())
        while srv.engines["fm0"].active_count() < 2:
            loop.tick()
        if reset:
            fault = DeviceResetFault()
            fault.inject(loop)
            assert fault.resets == 1
        while loop._work_left():
            loop.tick()
        return reqs

    clean = run(reset=False)
    hit = run(reset=True)
    assert all(r.ok for r in clean + hit)
    for rc, rh in zip(clean, hit):
        assert list(rh.result) == list(rc.result)
        assert rh.resets_survived == 1 and rc.resets_survived == 0
    eng = srv.engines["fm0"]
    assert eng.digest_failures == 0
    assert eng.free_page_count() == eng.total_pages - 1


# ---------------- whisper: the cross state through a snapshot ----------------

W_KW = dict(num_slots=4, prompt_len=8, prompt_buckets=(4, 8), max_new=8,
            chunk=2, enc_len=ENC_LEN, paged=True, page_size=4, total_pages=9)


@pytest.fixture(scope="module")
def wfms():
    return _pair("whisper-base", 2)


def _w_jobs(cfg, seed=21):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, cfg.vocab_size,
                         int(rng.randint(5, 9))).astype(np.int32),
             ("lora0", "lora1", None)[i % 3], int(rng.randint(5, 9)),
             (rng.randn(ENC_LEN, cfg.d_model) * 0.5).astype(np.float32))
            for i in range(5)]


def _w_state(eng):
    sp = eng.state_pool
    return {
        "slots": [None if s is None else (s.rid, list(s.tokens), s.done,
                                          s.status) for s in eng.slots],
        "state_pool": (sorted(sp.slots_in_use()), sp.gauges(), sp.allocs,
                       sp.frees),
        "pending": eng.pending_rids(),
        "ptab": eng._ptab.tolist(), "refs": eng._page_refs.tolist(),
        "free": list(eng._free_pages), "held": eng._held.tolist(),
        "lens": eng._lens.tolist(),
        "counters": [eng.admissions, eng.steps, eng.deferrals,
                     eng.preemptions, eng.digest_failures],
    }


def _w_drive(eng, cls, fm, jobs, on_restore=None, restore=True):
    """Joins (some defer), two chunks, a snapshot restored over the old
    engine (reusing its executables), then chunks to the end; the host
    state after every call."""
    states = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for i, (p, name, n, feats) in enumerate(jobs):
            eng.join(f"t{i}", p, adapter_id=name, max_new_tokens=n, rid=i,
                     enc_feats=feats)
            states.append(_w_state(eng))
        done = []
        for _ in range(2):
            done += eng.step_chunk()
            states.append(_w_state(eng))
        if restore:
            snap = eng.snapshot()
            # a preempted stream waits in the pending queue of the snapshot
            assert snap.dense_state is not None
            assert any(p.resume is not None for p in snap.pending)
            eng = cls.restore(fm, snap, reuse_jits_from=eng)
            if on_restore is not None:
                on_restore(eng)
            states.append(_w_state(eng))
        while eng.active_count() or eng.pending_count():
            done += eng.step_chunk()
            states.append(_w_state(eng))
    return states, sorted((d.rid, d.tokens, d.status) for d in done), eng


def test_whisper_snapshot_restore_teacher_forced_against_jax(wfms):
    """Whisper on the paged pool under pressure (joins defer, a stream is
    preempted), snapshotted mid-flight with its cross ``ck``/``cv`` and
    restored over the old engine: teacher-forced against the JAX engine on
    the same script, the host state (``state_pool`` included) equal after
    every call, logits within the whisper bound; and greedy, the port's
    restored run equals its uninterrupted run."""
    jfm, fm, cfg = wfms
    jobs = _w_jobs(cfg)
    jeng = JDecodeEngine(jfm, **W_KW)
    jcalls = _jax_recorder(jeng)

    def jrestored(e):
        e._sample = jeng._sample
    jstates, jdone, _ = _w_drive(jeng, JDecodeEngine, jfm, jobs, jrestored)
    eng = DecodeEngine(fm, **W_KW)
    calls, cur = [], {"eng": eng}
    eng._sample = _teacher(cur, jcalls, calls)

    def restored(e):
        e._sample = eng._sample
        cur["eng"] = e
        assert e.pool is eng.pool
    states, done, eng2 = _w_drive(eng, DecodeEngine, fm, jobs, restored)
    assert len(calls) == len(jcalls) and len(states) == len(jstates)
    for got, want in zip(states, jstates):
        assert got == want
    assert _worst(calls, jcalls) <= WHISPER_LOGIT_TOL
    assert done == jdone and len(done) == len(jobs)
    assert eng2.preemptions >= 1 and eng2.state_pool.slots_in_use() == set()
    # greedy, the port against itself: the restore changes no token
    _, plain, _ = _w_drive(DecodeEngine(fm, **W_KW), DecodeEngine, fm, jobs,
                           restore=False)
    _, restored_run, _ = _w_drive(DecodeEngine(fm, **W_KW), DecodeEngine, fm,
                                  jobs)
    assert restored_run == plain

"""The port's self-speculative decode plane against the JAX package's, on
reduced stablelm-1.6b with the JAX weights and adapters converted to the
port (``repro_torch.weights``), mirroring ``tests/test_speculative.py``:

* the verify window's plain version (T single-token paged reads) against
  the JAX oracle ``ref.paged_verify_attention_ref``, the model-layout op
  against the JAX op's one-gather XLA path and its Pallas path (T unrolled
  kernel calls, interpret mode), with and without a window;
* ``lm.verify_step`` against T sequential ``decode_step`` calls on copies
  of one paged cache: logits, codes, scales, lengths and running maxima;
* the speculative engine against a plain one (greedy streams equal): zero
  accepts on random weights, ``spec_force_fill``, an accept-heavy
  (copy-inclined) model under churn with a preemption that spills and
  resumes, the device length equal to the host's committed length after
  every chunk;
* no new executable across accept swings once both ladders are warm;
  charges that follow committed tokens; a sampled smoke run;
* the speculative engine held TEACHER-FORCED against the JAX speculative
  engine: logits of every live row at every sampler call within the paged
  pool's bound, and the host state (page tables, refcounts, lengths,
  counters, per-task accept stats, the accept EMA) EQUAL after every call;
* a speculative engine through ``snapshot``/``restore`` and the serve
  loop's warm-up of both ladders;
* the draft sentinel (one past the vocabulary) never reaching the
  embedding gather unclamped; the constructor's refusals and demotion;
* on a GPU only, the verify-window kernel against its plain version.

Tolerances: the plain versions compute the JAX oracles' f32 products in
another order (1e-5). ``verify_step`` against sequential steps runs every
dense product and norm over B * T rows instead of B, which may move a
bf16 activation by an ulp and an int8 code by one step (bound 2e-2 on
logits of magnitude ~4, codes within 1; measured equal at this width on
the CPU). The engines' logits are two bf16 models that round in different
places, with the paged pool carrying that noise in its int8 codes from
step to step (``test_torch_paged.py``: bound 0.75). Host state and greedy
tokens are exact.
"""
import pytest

torch = pytest.importorskip("torch")

import sys  # noqa: E402
import warnings  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core.decode_engine import DecodeEngine as JDecodeEngine  # noqa: E402
from repro.core.physical import PhysicalFM as JPhysicalFM  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import graphs  # noqa: E402
from repro_torch.core.decode_engine import DecodeEngine  # noqa: E402
from repro_torch.core.physical import PhysicalFM  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import lm  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
# the one verify case table, shared with chip_smoke.py's card check
from chip_smoke import VERIFY_CASES  # noqa: E402

BT = 8
KERNEL_TOL = 1e-5
STEP_TOL = 2e-2
LOGIT_TOL = 0.75


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite runs in parallel workers on shared
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------- the verify window's plain version and the op ----------

def _verify_case(seed=0, B=3, T=5, H=8, KV=2, hd=16, ps=8, P=11, MP=5,
                 lens=(9, 23, 1)):
    """Head-major arena and page tables sized so every row holds its
    base_len + T window positions (the speculative writes land above
    len); the JAX test's case."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, H, hd).astype(np.float32)
    kp = rng.randint(-127, 128, (P, KV, ps, hd)).astype(np.int8)
    vp = rng.randint(-127, 128, (P, KV, ps, hd)).astype(np.int8)
    ks = (rng.rand(P, KV) * 0.05 + 1e-3).astype(np.float32)
    vs = (rng.rand(P, KV) * 0.05 + 1e-3).astype(np.float32)
    pt = np.zeros((B, MP), np.int32)
    free = list(range(1, P))
    rng.shuffle(free)
    for b in range(B):
        for j in range(-(-(int(lens[b]) + T) // ps)):
            pt[b, j] = free.pop()
    return q, kp, vp, ks, vs, pt, np.asarray(lens, np.int32)


@pytest.mark.parametrize("window", [None, 6])
def test_verify_ref_matches_jax_oracle(window):
    """The plain version (head-major arena) against the JAX oracle: T
    single-token paged reads at successive lengths."""
    q, kp, vp, ks, vs, pt, base = _verify_case()
    want = jref.paged_verify_attention_ref(
        *map(jnp.asarray, (q, kp, vp, ks, vs, pt, base)), window=window)
    got = ref.paged_verify_attention_ref(
        *map(torch.tensor, (q, kp, vp, ks, vs, pt, base)), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


@pytest.mark.parametrize("window", [None, 6])
def test_verify_op_matches_jax_xla_path(window):
    """The op in the model layout (P, ps, KV, hd) against the JAX op's
    one-gather XLA path (per-position masks over one dequantized gather):
    only the order of the f32 sums separates them."""
    q, kp, vp, ks, vs, pt, base = _verify_case()
    km = np.ascontiguousarray(kp.transpose(0, 2, 1, 3))
    vm = np.ascontiguousarray(vp.transpose(0, 2, 1, 3))
    want = jops.paged_verify_attention(
        *map(jnp.asarray, (q, km, vm, ks, vs, pt, base)), window=window,
        backend="xla")
    got = ops.paged_verify_attention(
        *map(torch.tensor, (q, km, vm, ks, vs, pt, base)), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


def test_verify_op_matches_jax_pallas_path():
    """The JAX op's Pallas backend (T unrolled single-token kernel calls,
    interpret mode) agrees with the port's op too."""
    q, kp, vp, ks, vs, pt, base = _verify_case(seed=3, T=3)
    km = np.ascontiguousarray(kp.transpose(0, 2, 1, 3))
    vm = np.ascontiguousarray(vp.transpose(0, 2, 1, 3))
    want = jops.paged_verify_attention(
        *map(jnp.asarray, (q, km, vm, ks, vs, pt, base)), backend="pallas",
        interpret=True)
    got = ops.paged_verify_attention(
        *map(torch.tensor, (q, km, vm, ks, vs, pt, base)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)


def test_verify_op_routes_only_cpu_to_the_plain_version():
    """Another device than the CPU reaches the kernel or an error, never
    the plain version (a meta tensor stands in for one here)."""
    q = torch.empty((1, 5, 2, 16), device="meta")
    arena = torch.empty((2, 4, 2, 16), dtype=torch.int8, device="meta")
    sc = torch.empty((2, 2), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.paged_verify_attention(q, arena, arena, sc, sc,
                                   torch.zeros((1, 1), dtype=torch.int32),
                                   torch.ones(1, dtype=torch.int32))


# ---------------- the FMs: JAX weights and adapters in both ----------------

def _randomized_adapter(fm, i):
    tree = fm.adapters._mod.init_single_adapter(
        jax.random.PRNGKey(i), fm.cfg, fm.adapters.rank)
    leaves, tdef = jax.tree.flatten(tree)
    ks = jax.random.split(jax.random.PRNGKey(100 + i), len(leaves))
    return jax.tree.unflatten(tdef, [
        jax.random.normal(k, leaf.shape, leaf.dtype) * 0.05
        for k, leaf in zip(ks, leaves)])


def _copy_inclined(params):
    """The JAX test's accept-heavy double: every attention out-projection
    zeroed, so the logits depend only on the current token, the greedy
    chain becomes a bigram machine that cycles and the drafter's bigram
    matches start accepting."""
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: leaf * 0.0
        if any(getattr(k, "key", None) == "wo" for k in path) else leaf,
        params)


def _pair(copy_inclined: bool):
    jcfg = jreduced(jget_config("stablelm-1.6b"))
    cfg = reduced(get_config("stablelm-1.6b"))
    jfm = JPhysicalFM(jcfg, seed=0, input_len=8, lora_rank=4,
                      lora_impl="segmented", seg_block_t=BT)
    if copy_inclined:
        jfm.params = _copy_inclined(jfm.params)
    fm = PhysicalFM(cfg, seed=0, input_len=8, lora_rank=4,
                    lora_impl="segmented", seg_block_t=BT, device="cpu",
                    params=weights.to_torch(jax.tree.map(np.asarray,
                                                         jfm.params),
                                            device="cpu"))
    for i in range(2):
        tree = _randomized_adapter(jfm, i)
        jfm.adapters.add(f"lora{i}", tree)
        fm.adapters.add(f"lora{i}", weights.adapter_tree(
            jax.tree.map(np.asarray, tree), device="cpu"))
    return jfm, fm, cfg


@pytest.fixture(scope="module")
def fms():
    return _pair(False)


@pytest.fixture(scope="module")
def copy_fms():
    return _pair(True)


ENG_KW = dict(num_slots=2, prompt_len=16, max_new=24, chunk=4, paged=True,
              page_size=4, total_pages=48, prompt_buckets=(8, 16))


def _engine(fm, cls=DecodeEngine, **kw):
    return cls(fm, **{**ENG_KW, **kw})


def _streams(done):
    return {d.rid: list(d.tokens) for d in done}


def _dev_lens_match(eng):
    """The rollback invariant: every live slot's device length equals the
    host's committed length after every chunk."""
    for sub in eng.pool:
        if "page_table" in sub:
            dev = sub["len"].numpy()
            for s, st in enumerate(eng.slots):
                if st is not None and not st.done:
                    assert (dev[:, s] == int(eng._lens[s])).all(), \
                        (s, dev[:, s], eng._lens[s])


# ---------------- verify_step against sequential decode steps -----------

def test_verify_step_matches_sequential_decode_steps(fms):
    """One ``verify_step`` over a 5-token window on a copy of a live paged
    cache against five ``decode_step`` calls on another copy: the logits of
    window position j against step j's, the int8 codes and scales the
    window wrote, the lengths and the running maxima (the last position's
    and, through the stacks, every position's)."""
    _, fm, cfg = fms
    eng = _engine(fm, spec_k=4)
    rng = np.random.RandomState(7)
    for i, n in enumerate((6, 13)):        # 13: the window crosses a page
        eng.join(f"t{i}", rng.randint(0, cfg.vocab_size, n).astype(np.int32),
                 adapter_id="lora0", max_new_tokens=8, rid=i)
    eng._ensure_chunk_pages()
    eng._sync_page_table()
    T = 5
    toks = torch.tensor(rng.randint(0, cfg.vocab_size, (2, T)),
                        dtype=torch.int32)
    toks[:, 0] = eng._tokens
    aidx = torch.as_tensor(eng._slot_adapters)
    stack = fm.adapters.stacked()

    def clone():
        return [{k: v.clone() for k, v in sub.items()} for sub in eng.pool]
    full = torch.cat([eng._ptab_dev, eng._ptab_spec], dim=1)
    wide = []
    for sub in clone():
        nper, _, kv = sub["k_max"].shape
        wide.append(dict(sub, page_table=full.expand(nper, -1, -1),
                         k_cmax=torch.empty((nper, 2, T, kv)),
                         v_cmax=torch.empty((nper, 2, T, kv))))
    got, wide = lm.verify_step(fm.params, cfg, tokens=toks, cache=wide,
                               lora=stack, adapter_idx=aidx)
    seq = [dict(sub, page_table=full.expand(sub["k"].shape[0], -1, -1))
           for sub in clone()]
    maxes = []
    for j in range(T):
        want, seq = lm.decode_step(fm.params, cfg, tokens=toks[:, j],
                                   cache=seq, lora=stack, adapter_idx=aidx)
        np.testing.assert_allclose(got[:, j].numpy(), want.numpy(),
                                   atol=STEP_TOL, rtol=0)
        maxes.append([sub["k_max"].clone() for sub in seq])
    for a, b in zip(wide, seq):
        assert torch.equal(a["len"], b["len"])
        assert (a["k"].int() - b["k"].int()).abs().max() <= 1
        assert (a["v"].int() - b["v"].int()).abs().max() <= 1
        np.testing.assert_allclose(a["k_scale"].numpy(),
                                   b["k_scale"].numpy(), rtol=1e-6)
        np.testing.assert_allclose(a["k_max"].numpy(), b["k_max"].numpy(),
                                   rtol=1e-2)
    for j in range(T):
        for a, mx in zip(wide, maxes[j]):
            np.testing.assert_allclose(a["k_cmax"][:, :, j].numpy(),
                                       mx.numpy(), rtol=1e-2)


# ---------------- greedy parity against the plain engine ----------------

def test_spec_greedy_parity_zero_accept(fms):
    """Random weights never self-overlap: every draft misses, every
    speculative step commits one token, and the streams equal a plain
    engine's."""
    _, fm, cfg = fms
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (7, 16, 12, 5)]

    def run(eng):
        for i, p in enumerate(prompts):
            eng.join(f"t{i}", p, adapter_id=["lora0", None][i % 2],
                     max_new_tokens=10 + i, rid=i)
        return _streams(eng.drain())
    want = run(_engine(fm, spec_k=0))
    spec = _engine(fm, spec_k=4)
    assert run(spec) == want
    assert spec.spec_dispatches >= 1 and spec.draft_accepted == 0


def test_spec_force_fill_equals_plain(copy_fms):
    """``spec_force_fill``: every draft is the sentinel, so nothing is
    accepted even on the accept-heavy model, and the streams equal the
    plain engine's."""
    _, fm, cfg = copy_fms
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, cfg.vocab_size, 11).astype(np.int32)
               for _ in range(3)]

    def run(eng):
        for i, p in enumerate(prompts):
            eng.join(f"t{i}", p, max_new_tokens=12, rid=i)
        return _streams(eng.drain())
    want = run(_engine(fm, spec_k=0))
    spec = _engine(fm, spec_k=3, spec_force_fill=True, spec_disable_below=1.0)
    assert run(spec) == want
    assert spec.draft_accepted == 0 and spec.spec_dispatches >= 1


def test_spec_greedy_parity_accept_heavy_churn(copy_fms):
    """The copy-inclined model (accepts fire, rollback runs) through ragged
    churn: staggered budgets, joins mid-flight, a preemption at the second
    chunk that spills to the host and resumes. The streams equal the plain
    engine's, and the device length never drifts from the host's."""
    _, fm, cfg = copy_fms
    rng = np.random.RandomState(2)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 16, 6, 13, 8, 15)]
    budgets = [20, 9, 16, 24, 11, 18]

    def drive(spec_k):
        eng = _engine(fm, spec_k=spec_k, spec_disable_below=1.0,
                      spill_bytes=32 << 20)
        for i in (0, 1):
            eng.join(f"t{i}", prompts[i], adapter_id="lora0",
                     max_new_tokens=budgets[i], rid=i)
        done, nxt, steps = [], 2, 0
        while eng.active_count() or eng.pending or nxt < len(prompts):
            done += eng.step_chunk()
            steps += 1
            if spec_k:
                _dev_lens_match(eng)
            if steps == 2:
                live = [i for i, s in enumerate(eng.slots)
                        if s is not None and not s.done]
                if live:
                    eng._preempt(live[0])
            while nxt < len(prompts) and eng.free_slots() \
                    and not eng.pending:
                eng.join(f"t{nxt}", prompts[nxt],
                         adapter_id=[None, "lora1"][nxt % 2],
                         max_new_tokens=budgets[nxt], rid=nxt)
                nxt += 1
        return _streams(done), eng

    want, _ = drive(0)
    got, spec = drive(4)
    assert set(got) == set(range(len(prompts)))
    assert all(len(got[i]) == budgets[i] for i in got)
    assert got == want
    assert spec.draft_accepted > 0 and spec.preemptions >= 1
    assert spec.spill_resumes >= 1
    rates = spec.spec_task_accept_rates()
    assert rates and max(rates.values()) > 0.5
    assert spec.free_page_count() == spec.total_pages - 1


# ---------------- steady state, accounting, sampling ----------------

def test_spec_zero_recompiles_across_accept_swings(fms):
    """With both ladders warm, serving adds no executable however the
    accept rate swings: random weights drive it to zero, the EMA demotes
    to plain dispatches and the probes speculate again."""
    _, fm, cfg = fms
    eng = _engine(fm, spec_k=4, spec_probe_every=4)
    rng = np.random.RandomState(3)
    eng.join("w", rng.randint(0, cfg.vocab_size, 6), max_new_tokens=2,
             rid=-1)
    eng.join("w", rng.randint(0, cfg.vocab_size, 14), adapter_id="lora0",
             max_new_tokens=2, rid=-1)
    eng.drain()
    eng.warm_decode_ladder()
    eng.warm_speculative()
    keys = eng.compile_count()
    for c in eng.chunk_ladder():
        assert ("spec", eng.num_slots, fm.adapters.capacity(), c, 4) \
            in eng._fn_decode
    done, nxt = [], 0
    prompts = [rng.randint(0, cfg.vocab_size, 5 + (i * 3) % 11)
               for i in range(8)]
    while len(done) < len(prompts):
        while nxt < len(prompts) and eng.free_slots() and not eng.pending:
            eng.join(f"t{nxt}", prompts[nxt],
                     adapter_id=[None, "lora1"][nxt % 2],
                     max_new_tokens=6 + nxt % 5, rid=nxt)
            nxt += 1
        done += eng.step_chunk()
    assert eng.compile_count() == keys
    assert eng.spec_dispatches >= 1 and eng.spec_fallbacks >= 1


def test_spec_decode_charges_follow_committed_tokens(fms):
    """The per-(task, rid) charge log drains once and covers every token
    the engine kept."""
    _, fm, cfg = fms
    eng = _engine(fm, spec_k=2)
    rng = np.random.RandomState(4)
    eng.join("A", rng.randint(0, cfg.vocab_size, 9), max_new_tokens=8, rid=1)
    eng.join("B", rng.randint(0, cfg.vocab_size, 12), max_new_tokens=14,
             rid=2)
    done = _streams(eng.drain())
    charges = eng.take_decode_charges()
    assert eng.take_decode_charges() == {}
    assert set(charges) == {("A", 1), ("B", 2)}
    assert charges[("A", 1)] >= len(done[1]) - 1
    assert charges[("B", 2)] >= len(done[2]) - 1


def test_spec_sampled_mode_smoke(copy_fms):
    """Sampled speculation (each row's generator drawn once per window
    position, eager): it completes, stays inside the vocabulary and never
    lets the draft sentinel into a stream."""
    _, fm, cfg = copy_fms
    eng = _engine(fm, spec_k=3, temperature=0.8, top_k=8,
                  spec_disable_below=1.0)
    rng = np.random.RandomState(5)
    for i in range(3):
        eng.join(f"t{i}", rng.randint(0, cfg.vocab_size, 10),
                 max_new_tokens=12, rid=i)
    out = _streams(eng.drain())
    assert len(out) == 3 and eng.spec_dispatches >= 1
    for toks in out.values():
        assert len(toks) == 12
        assert all(0 <= t < cfg.vocab_size for t in toks)


def test_draft_sentinel_is_clamped_before_the_embedding(copy_fms,
                                                        monkeypatch):
    """Every draft is the sentinel (``spec_force_fill``, one past the
    vocabulary) and the drafter's misses are too: the embedding gather
    only ever sees ids inside the vocabulary (on the card an unclamped id
    is a device-side assert), and the sentinel never reaches a stream."""
    _, fm, cfg = copy_fms
    seen = []
    real = lm.embed

    def checked(w, tokens):
        seen.append(int(tokens.max()))
        assert int(tokens.max()) < w.shape[0] and int(tokens.min()) >= 0
        return real(w, tokens)
    monkeypatch.setattr(lm, "embed", checked)
    rng = np.random.RandomState(6)
    for force in (True, False):
        eng = _engine(fm, spec_k=4, spec_force_fill=force,
                      spec_disable_below=1.0)
        for i in range(2):
            eng.join(f"t{i}", rng.randint(0, cfg.vocab_size, 9),
                     max_new_tokens=10, rid=i)
        out = _streams(eng.drain())
        assert all(t < cfg.vocab_size for v in out.values() for t in v)
        assert eng.spec_dispatches >= 1
    assert seen and max(seen) == cfg.vocab_size - 1   # a clamped sentinel


def test_spec_constructor_refusals_and_demotion():
    """``spec_k > 0`` needs the paged pool (ValueError otherwise); an
    encoder-decoder stack demotes to plain decode with a RuntimeWarning."""
    cfg = reduced(get_config("stablelm-1.6b"))
    fm = PhysicalFM(cfg, seed=0, input_len=8, lora_rank=4, device="cpu")
    with pytest.raises(ValueError, match="paged=True"):
        DecodeEngine(fm, num_slots=2, prompt_len=8, max_new=4, spec_k=4)
    wcfg = reduced(get_config("whisper-base"))
    wfm = PhysicalFM(wcfg, seed=0, input_len=8, lora_rank=4, device="cpu")
    with pytest.warns(RuntimeWarning, match="demoted to plain decode"):
        eng = DecodeEngine(wfm, num_slots=2, prompt_len=8, max_new=4,
                           paged=True, page_size=4, spec_k=4, enc_len=16)
    assert eng.spec_k == 0 and eng._headroom_tokens() == eng.chunk
    spec = DecodeEngine(fm, num_slots=2, prompt_len=8, max_new=4, chunk=2,
                        paged=True, page_size=4, spec_k=3)
    # headroom: a chunk of 4-token windows; the plain planes see the
    # spec_k = 0 table width, the speculative room rides behind it
    assert spec._headroom_tokens() == 8
    assert spec.pages_per_slot == -(-(spec.s_max + 8) // 4)
    assert spec._ptab_dev.shape == (2, -(-spec.s_max // 4))
    assert spec._ptab_dev.data_ptr() == spec._ptab_store.data_ptr()
    assert all(sub["page_table"].shape[-1] == spec._ptab_dev.shape[1]
               for sub in spec.pool)


# ---------------- teacher-forced against the JAX speculative engine ------

TF_KW = dict(num_slots=2, prompt_len=16, max_new=14, chunk=4, paged=True,
             page_size=4, total_pages=22, prompt_buckets=(8, 16),
             spec_k=4, spec_disable_below=1.0)


def _tf_jobs(cfg, seed):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, cfg.vocab_size, 8).astype(np.int32)
    jobs = []
    for i in range(5):
        if i % 2 == 0:
            p = np.concatenate([prefix, rng.randint(
                0, cfg.vocab_size, 1 + i).astype(np.int32)])
            jobs.append((p, "lora0", 8 + i))
        else:
            jobs.append((rng.randint(0, cfg.vocab_size, 5 + 2 * i).astype(
                np.int32), [None, "lora1"][i % 3 == 0], 10 + i))
    return jobs


def _tf_state(eng):
    return {
        "ptab": eng._ptab.tolist(), "refs": eng._page_refs.tolist(),
        "free": list(eng._free_pages), "held": eng._held.tolist(),
        "lens": eng._lens.tolist(), "pending": eng.pending_rids(),
        "slots": [None if s is None else (s.rid, list(s.tokens), s.done)
                  for s in eng.slots],
        "counters": [eng.deferrals, eng.preemptions, eng.prefix_hits,
                     eng.admissions, eng.scale_refreshes, eng.steps,
                     eng.draft_proposed, eng.draft_accepted,
                     eng.spec_dispatches, eng.spec_commits,
                     eng.spec_fallbacks],
        "accept": (eng._spec_accept_ema, eng._spec_probe_interval,
                   {k: list(v) for k, v in eng._spec_task_stats.items()}),
    }


def _tf_drive(eng, jobs):
    states, done = [], []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for i in range(3):
            p, name, n = jobs[i]
            eng.join(f"t{i}", p, adapter_id=name, max_new_tokens=n, rid=i)
            states.append(_tf_state(eng))
        nxt = 3
        while eng.active_count() or eng.pending_count():
            done += eng.step_chunk()
            states.append(_tf_state(eng))
            if nxt < len(jobs) and eng.steps % 8 == 0:
                p, name, n = jobs[nxt]
                eng.join(f"t{nxt}", p, adapter_id=name, max_new_tokens=n,
                         rid=nxt)
                nxt += 1
                states.append(_tf_state(eng))
    return states, sorted(done, key=lambda s: s.rid)


@pytest.mark.parametrize("model", ["random", "copy_inclined"])
def test_spec_engine_teacher_forced_against_jax(request, model):
    """Every sampler call of the port's speculative engine (prefills and
    every window position) is answered with the JAX engine's greedy token
    at the same call; the logits of every live row must lie within the
    bound, and after every join and chunk the host state must EQUAL the JAX
    engine's: page tables, refcounts, free list, lengths, pending queue,
    slots, counters, the accept EMA and per-task accept stats. Random
    weights exercise the verify window's numerics (zero accepts); the
    copy-inclined model exercises acceptance and rollback."""
    jfm, fm, cfg = request.getfixturevalue(
        "fms" if model == "random" else "copy_fms")
    jobs = _tf_jobs(cfg, seed=21)
    jeng = JDecodeEngine(jfm, **TF_KW)
    jcalls = []

    def jsample(logits, keys):
        jax.debug.callback(lambda x: jcalls.append(np.asarray(x, np.float32)),
                           logits, ordered=True)
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), keys
    jeng._sample = jsample
    jstates, jdone = _tf_drive(jeng, jobs)

    eng = DecodeEngine(fm, **TF_KW)
    calls = []

    def teacher(logits, gens):
        want = jcalls[len(calls)]
        live = np.ones(1, bool) if logits.shape[0] == 1 else np.array(
            [s is not None and not s.done for s in eng.slots])
        calls.append((logits.float().numpy(), live))
        return torch.as_tensor(want.argmax(-1), dtype=torch.int32), gens
    eng._sample = teacher
    states, done = _tf_drive(eng, jobs)
    assert len(calls) == len(jcalls) and len(states) == len(jstates)
    for got, want in zip(states, jstates):
        assert got == want
    worst = max(np.abs(got[live] - want[live]).max()
                for (got, live), want in zip(calls, jcalls) if live.any())
    assert worst <= LOGIT_TOL, worst
    for s, js in zip(done, jdone):
        assert (s.rid, s.tokens, s.status) == (js.rid, js.tokens, js.status)
    assert len(done) == len(jobs) and eng.spec_dispatches >= 2
    if model == "copy_inclined":
        assert eng.draft_accepted > 0
    assert eng.free_page_count() == eng.total_pages - 1


# ---------------- snapshot/restore and the serve loop ----------------

def test_spec_snapshot_restore_midflight(copy_fms):
    """A speculative engine snapshotted after two chunks and restored over
    its own pool (reusing its executables) and into a fresh one: the
    configuration carries ``spec_k`` and its knobs, and both restored
    engines finish every stream as the uninterrupted run does, with no
    executable added."""
    _, fm, cfg = copy_fms
    kw = dict(spec_k=4, spec_disable_below=1.0, spec_probe_every=8)
    rng = np.random.RandomState(8)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (9, 14)]

    def midflight():
        eng = _engine(fm, **kw)
        for i, p in enumerate(prompts):
            eng.join(f"t{i}", p, max_new_tokens=20, rid=i)
        eng.step_chunk()
        eng.step_chunk()
        return eng
    want = _streams(midflight().drain())
    eng = midflight()
    snap = eng.snapshot()
    assert {k: snap.config[k] for k in kw} == kw
    keys = eng.compile_count()
    fresh = DecodeEngine.restore(fm, snap)
    again = DecodeEngine.restore(fm, snap, reuse_jits_from=eng)
    assert again.pool is eng.pool and again._ptab_store is eng._ptab_store
    assert again.spec_k == 4 and fresh.spec_k == 4
    assert _streams(again.drain()) == want
    assert again.compile_count() == keys
    assert _streams(fresh.drain()) == want
    assert again.draft_accepted > 0


def test_serve_loop_warms_both_ladders(fms):
    """``ServeLoop.warmup`` on a speculative engine runs the plain and the
    speculative executable of every ladder chunk, so a served trace adds
    no key; every request finishes with its budget."""
    import time

    from repro_torch.core.request import Request
    from repro_torch.core.server import FMplexServer
    from repro_torch.core.vfm import TaskExtensions
    _, fm, cfg = fms
    srv = FMplexServer("s0")
    srv.deploy_fm("fm0", fm, scheduler="bfq")
    srv.bind_task("gen", "fm0", extensions=TaskExtensions(adapter_id="lora0"))
    loop = srv.serve_loop("fm0", engine_kwargs=dict(
        num_slots=2, prompt_len=8, max_new=10, chunk=2, paged=True,
        page_size=4, spec_k=3, spec_probe_every=2))
    loop.warmup(gen_task="gen")
    eng = srv.engines["fm0"]
    cap = fm.adapters.capacity()
    for c in eng.chunk_ladder():
        assert ("spec", eng.num_slots, cap, c, 3) in eng._fn_decode
        assert (eng.num_slots, cap, c) in eng._fn_decode
    keys = eng.compile_count()
    rng = np.random.RandomState(9)
    reqs = [Request("gen", 0.0, payload=rng.randint(
        0, cfg.vocab_size, 4 + i).astype("int32"), tokens=12.0,
        max_new_tokens=8) for i in range(4)]
    for r in reqs:
        loop.submit(r, time.perf_counter())
    while loop._work_left():
        loop.tick()
    assert all(r.ok and len(r.result) == 8 for r in reqs)
    assert eng.compile_count() == keys
    assert eng.spec_dispatches >= 1


# ---------------- the CUDA kernel (GPU only) ----------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are built and run on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(VERIFY_CASES))
def test_verify_kernel_on_gpu(cuda_device, case):
    """The verify-window kernel against its plain version at chip_smoke's
    cases: two bf16 ulps of the largest output (both accumulate in f32, in
    another order), the same bits from a second call, one launch, and
    every window position bit-identical to K4 at its length."""
    import chip_smoke
    c = VERIFY_CASES[case]
    H, KV, T, MP = c["H"], c["KV"], c["T"], c["MP"]
    hd, window = c.get("hd", 64), c.get("window")
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    q, kp, vp, ks, vs, pt, base = chip_smoke.verify_inputs(
        gen, len(c["base"]), H, KV, hd, T, MP, c["base"], cuda_device)
    before = ops.LAUNCHES["paged_verify_attention"]
    got = ops.paged_verify_attention(q, kp, vp, ks, vs, pt, base,
                                     window=window)
    want = ref.paged_verify_attention_ref(q, kp.transpose(1, 2),
                                          vp.transpose(1, 2), ks, vs, pt,
                                          base, window=window)
    k4 = torch.stack([ops.paged_decode_attention(
        q[:, j].contiguous(), kp, vp, ks, vs, pt,
        (base + j + 1).to(torch.int32), window=window) for j in range(T)], 1)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["paged_verify_attention"] - before == 1
    tol = 2 * 2.0 ** -8 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(got, k4)
    assert torch.equal(got, ops.paged_verify_attention(
        q, kp, vp, ks, vs, pt, base, window=window))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [512, 1024, 2048])
def test_rmsnorm_kernel_row_invariant_on_gpu(cuda_device, d):
    """The rmsnorm kernel on the card: within one bf16 ulp of each
    element of its plain version, one launch a call, and the bits of 8
    rows (a decode step's) the same alone, among 40 rows (a verify
    forward's) and among 4176, at other indices, and 4160 rows the same
    in calls of 8 and of (8, 5, d): what lets a verify forward reproduce T
    sequential steps at full depth."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn((8 + 4176, d), generator=gen, device=cuda_device) * 3
    x = x.to(torch.bfloat16)
    w = 1 + 0.3 * torch.randn((d,), generator=gen, device=cuda_device)
    rows = x[:8].clone()
    before = ops.LAUNCHES["rmsnorm"]
    want = ops.rmsnorm(w, rows)
    assert ops.LAUNCHES["rmsnorm"] - before == 1
    plain = ref.rmsnorm(w, rows)
    assert ((want.float() - plain.float()).abs()
            <= 2.0 ** -7 * plain.float().abs()).all()
    for i in range(8):
        assert torch.equal(ops.rmsnorm(w, rows[i:i + 1]), want[i:i + 1])
    for n, at in ((40, 29), (4176, 3001)):
        batch = x[8:8 + n].clone()
        batch[at:at + 8] = rows
        assert torch.equal(ops.rmsnorm(w, batch)[at:at + 8], want)
    win = x[8:48].clone().view(8, 5, d)         # (B, T, d) as a verify step
    win[:, 4] = rows
    assert torch.equal(ops.rmsnorm(w, win)[:, 4], want)
    # every row of 4160 the same in one call, in calls of 8 rows and in
    # calls of (8, 5, d) (where PyTorch's f32 mean of squares differs)
    xs = x[8:8 + 4160]
    whole = ops.rmsnorm(w, xs)
    assert torch.equal(torch.cat([ops.rmsnorm(w, xs[i:i + 8])
                                  for i in range(0, 4160, 8)]), whole)
    assert torch.equal(torch.cat([
        ops.rmsnorm(w, xs[i:i + 40].view(8, 5, d)).view(40, d)
        for i in range(0, 4160, 40)]), whole)


def test_graphed_spec_engine_equals_eager(copy_fms):
    """The speculative executables through the graphs module's staging
    (calls 2 and later copy into static buffers, as on the card) against
    the same engine run eagerly under ``graphs.disabled()``: the same
    streams and counters."""
    _, fm, cfg = copy_fms
    rng = np.random.RandomState(10)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (11, 7, 15)]

    def run(eng):
        for i, p in enumerate(prompts):
            eng.join(f"t{i}", p, max_new_tokens=14, rid=i)
        return _streams(eng.drain()), (eng.draft_proposed,
                                       eng.draft_accepted, eng.spec_commits)
    graphed = run(_engine(fm, spec_k=4, spec_disable_below=1.0))
    with graphs.disabled():
        eager = run(_engine(fm, spec_k=4, spec_disable_below=1.0))
    assert graphed == eager and graphed[1][1] > 0

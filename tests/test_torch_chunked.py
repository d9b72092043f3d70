"""The port's chunked shared-prefix prefill and its prefill attention (K2)
against the JAX package's, on reduced stablelm-1.6b with the JAX weights and
adapters converted to the port:

* (a) the port's ``flash_attention`` (its plain route on the CPU) against
  the JAX jnp ``models.attention.flash_attention`` over causal or not, a
  window, GQA, queries that are a strict suffix, ragged ``kv_len``, a prefix
  with ragged ``prefix_len`` (0 included) and a prefix with ``kv_len``, in
  f32 and bf16; (b) against the Pallas K2 in interpret mode on the cases it
  takes;
* (c) ``ops.gather_prefix_kv`` exactly against the JAX op, with page vectors
  padded with the trash page;
* (d) ``lm.prefill`` with a prefix: logits and the tail cache;
* the tail-page scatter against the JAX engine's on the same float input:
  codes exact, the boundary page at the slot scale, the mapped prefix pages'
  scales folded into the slot scale;
* (e) the chunked paged engine TEACHER-FORCED against the JAX chunked engine
  through a churn script (sharer joins of mixed tail lengths, a page-aligned
  prompt that re-prefills its last page, COW divergence inside the boundary
  page, a pages-mode tail forced by dropping the same float sidecars on both
  engines, deferral and preemption), host allocator state EQUAL after every
  call;
* (f) chunked and full prefill give equal greedy and seeded top-k streams
  within the port; (g) no new shape key across sharer churn after warmup,
  and ``warm_chunked`` advances no slot's generator;
* (h) ``ServeLoop`` charges tails only and fills the hit/miss TTFT split;
* (i) on a GPU only, the K2 CUDA kernel against its plain version, split
  over the key axis (over one query tile and over several, causal and
  not) and at hd 128 too; on any host, the K2 wrapper's
  key-split plan (``flash_attention.splits``: the splits cover the key
  axis, tile multiples, from the shapes alone).

Tolerances: the plain attention computes the JAX function's f32 products in
another summation order (f32: 1e-5); in bf16 both round the probabilities
and the output to bf16, so they may land one bf16 ulp apart (two ulps of the
largest output, 2 * 2^-8 * max). The model and engine bounds are those of
test_torch_models.py and test_torch_paged.py with their reasons; each test
states what it measured.
"""
import pytest

torch = pytest.importorskip("torch")

import collections  # noqa: E402
import warnings  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core.decode_engine import DecodeEngine as JDecodeEngine  # noqa: E402
from repro.core.physical import PhysicalFM as JPhysicalFM  # noqa: E402
from repro.kernels import flash_attention as jpallas  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.decode_engine import TRASH_PAGE, DecodeEngine  # noqa: E402
from repro_torch.core.physical import PhysicalFM  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import lm  # noqa: E402

BT = 8
ADAPTER_SCALE = 0.15
F32_TOL = 1e-5
HIDDEN_TOL = (2e-2, 0.3)      # (relative L2, max abs): test_torch_models.py
LOGIT_TOL = (4e-2, 0.25)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite runs in parallel workers on shared
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------- (a), (b): the attention ----------------

# (B, Sq, Sk, H, KV, hd, Sp, causal, window, kv_len, prefix_len)
ATTN_CASES = {
    "causal": (2, 12, 12, 4, 4, 16, 0, True, None, None, None),
    "bidirectional": (2, 12, 12, 4, 2, 16, 0, False, None, None, None),
    "window": (2, 16, 16, 4, 2, 16, 0, True, 5, None, None),
    "gqa_suffix": (2, 5, 13, 8, 2, 16, 0, True, None, None, None),
    "kv_len": (3, 12, 12, 4, 4, 16, 0, True, None, (12, 7, 1), None),
    "window_kv_len": (2, 16, 16, 4, 1, 16, 0, True, 6, (16, 9), None),
    "prefix": (3, 8, 8, 4, 2, 16, 12, True, None, None, (12, 5, 0)),
    "prefix_kv_len": (3, 8, 8, 4, 4, 16, 16, True, None, (3, 8, 1),
                      (8, 0, 16)),
    "prefix_noncausal": (2, 6, 6, 4, 2, 16, 8, False, None, (6, 2), (3, 8)),
    # a key axis the kernel splits (8 CTAs over 1500 keys), trailing splits
    # empty past kv_len; hd 128
    "long_keys_kv_len": (1, 16, 1500, 8, 8, 16, 0, False, None, (100,),
                         None),
    "hd128_kv_len": (2, 12, 12, 4, 2, 128, 0, True, None, (12, 5), None),
    # causal over several query tiles, split over the key axis on the card
    # (64 CTAs over a 192-key prefix and 128 new keys: 3 splits, the second
    # crossing the prefix's end); whisper's encoder at one row (24 query
    # tiles in 2 splits)
    "causal_split_prefix": (1, 128, 128, 32, 32, 16, 192, True, None, (100,),
                            (150,)),
    "encoder_one_row": (1, 1500, 1500, 8, 8, 16, 0, False, None, None,
                        None),
    # qwen2-7b's heads (28 over 4: G 7, hd 128) with a prefix, and
    # h2o-danube-1.8b's (32 over 8, hd 80) under a window
    "qwen2_g7_suffix_kv_len": (2, 48, 80, 28, 4, 128, 0, True, None,
                               (80, 61), None),
    "qwen2_g7_prefix": (2, 16, 16, 28, 4, 128, 32, True, None, (16, 9),
                        (32, 5)),
    "h2o_hd80_window_kv_len": (2, 48, 80, 32, 8, 80, 0, True, 48, (80, 61),
                               None),
}


def _attn_inputs(case, seed=0):
    B, Sq, Sk, H, KV, hd, Sp, causal, window, kv_len, prefix_len = case
    rng = np.random.RandomState(seed)
    arrs = [rng.randn(*s).astype(np.float32) for s in
            ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd),
             (B, Sp, KV, hd), (B, Sp, KV, hd))]
    kw = {"causal": causal, "window": window}
    if kv_len is not None:
        kw["kv_len"] = np.asarray(kv_len, np.int32)
    if Sp:
        kw["prefix_len"] = np.asarray(prefix_len, np.int32)
    return arrs, kw


def _sees_a_key(case):
    """(B, Sq) bool: does the query see at least one valid key?"""
    B, Sq, Sk, _, _, _, Sp, causal, window, kv_len, prefix_len = case
    kpos = np.arange(Sp + Sk)
    qpos = Sp + Sk - Sq + np.arange(Sq)
    vis = np.ones((Sq, Sp + Sk), bool)
    if causal:
        vis &= qpos[:, None] >= kpos[None]
    if window is not None:
        vis &= (qpos[:, None] - kpos[None]) < window
    n_new = np.full(B, Sk) if kv_len is None else np.asarray(kv_len)
    ok = (kpos[None] >= Sp) & (kpos[None] - Sp < n_new[:, None])
    if Sp:
        ok |= kpos[None] < np.asarray(prefix_len)[:, None]
    return (vis[None] & ok[:, None]).any(axis=-1)


def _run_both(arrs, kw, dtype):
    q, k, v, pk, pv = arrs
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jkw, tkw = dict(kw), dict(kw)
    for name in ("kv_len", "prefix_len"):
        if name in kw:
            jkw[name], tkw[name] = jnp.asarray(kw[name]), \
                torch.tensor(kw[name])
    if "prefix_len" in kw:
        jkw.update(prefix_k=jnp.asarray(pk, jdt), prefix_v=jnp.asarray(pv, jdt))
        tkw.update(prefix_k=torch.tensor(pk).to(dtype),
                   prefix_v=torch.tensor(pv).to(dtype))
    want = jattn.flash_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                 jnp.asarray(v, jdt), **jkw)
    got = attn.flash_attention(torch.tensor(q).to(dtype),
                               torch.tensor(k).to(dtype),
                               torch.tensor(v).to(dtype), **tkw)
    assert got.dtype == dtype
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_flash_attention_matches_jax(name, dtype):
    """(a) The port's flash_attention, plain route, against the JAX jnp
    function on every row (rows with no valid key included: both return
    the mean of the masked values)."""
    got, want = _run_both(*_attn_inputs(ATTN_CASES[name]), dtype)
    tol = F32_TOL if dtype == torch.float32 else \
        2 * 2.0 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=F32_TOL)


def test_flash_attention_prefix_mask_is_exact():
    """A prefix key at prefix_len is masked and one just below it is not:
    shifting prefix_len by one moves the output by far more than the
    tolerance (the prefix mask is not off by one)."""
    arrs, kw = _attn_inputs(ATTN_CASES["prefix"], seed=3)
    base, _ = _run_both(arrs, kw, torch.float32)
    for shift in (-1, 1):
        kw2 = dict(kw, prefix_len=np.clip(kw["prefix_len"] + shift, 0, 12))
        moved, want = _run_both(arrs, kw2, torch.float32)
        np.testing.assert_allclose(moved, want, atol=F32_TOL, rtol=F32_TOL)
        changed = kw2["prefix_len"] != kw["prefix_len"]
        assert np.abs(moved - base)[changed].max() > 100 * F32_TOL


# the Pallas kernel takes no kv_len and no prefix, and tiles Sq and Sk
PALLAS_CASES = [(1, 4, 4, 32, 32, 16, True, None),
                (2, 4, 2, 16, 32, 16, True, None),
                (1, 4, 1, 32, 32, 16, True, 8),
                (2, 4, 2, 32, 32, 16, False, None),
                (2, 28, 4, 48, 48, 128, True, None),   # qwen2-7b: G 7
                (2, 32, 8, 48, 48, 80, True, 16)]      # h2o-danube: hd 80


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal,window", PALLAS_CASES)
def test_flash_attention_matches_pallas_interpret(B, H, KV, Sq, Sk, hd,
                                                  causal, window, dtype):
    """(b) Against the Pallas K2 in interpret mode (head-major layout), as
    tests/test_kernels.py runs it. The Pallas kernel keeps p in f32 for the
    P·V product where the jnp function rounds it to bf16, so in bf16 the
    bound is test_kernels.py's 3e-2; in f32 the two compute the same."""
    rng = np.random.RandomState(B * 100 + Sq)
    q, k, v = (rng.randn(B, s, h, hd).astype(np.float32)
               for s, h in ((Sq, H), (Sk, KV), (Sk, KV)))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jpallas.flash_attention(
        *(jnp.asarray(x.transpose(0, 2, 1, 3), jdt) for x in (q, k, v)),
        causal=causal, window=window, block_q=16, block_k=16, interpret=True)
    got = attn.flash_attention(*(torch.tensor(x).to(dtype) for x in (q, k, v)),
                               causal=causal, window=window)
    tol = F32_TOL if dtype == torch.float32 else 3e-2
    np.testing.assert_allclose(got.float().numpy().transpose(0, 2, 1, 3),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# (B, Sq, H, KV, keys): the timed shapes of chip_smoke.py and a few more
SPLIT_SHAPES = {
    "pooled": (32, 128, 32, 32, 128),
    "admission": (1, 128, 32, 32, 128),
    "tail": (1, 64, 32, 32, 192),
    "gqa": (2, 128, 32, 8, 128),
    "whisper_encoder": (1, 1500, 8, 8, 1500),
    "whisper_encoder_pooled": (4, 1500, 8, 8, 1500),
    "whisper_cross_prefill": (1, 64, 8, 8, 1500),
    "whisper_cross_short": (1, 16, 8, 8, 1500),
    "prefix_boundary": (1, 16, 32, 32, 1040),
    "causal_split_prefix": (1, 128, 32, 32, 320),
    "odd_keys": (1, 5, 4, 1, 129),
    "no_keys": (1, 4, 4, 4, 0),
}
SMS = 132                     # the H100's SMs


@pytest.mark.parametrize("name", list(SPLIT_SHAPES))
def test_flash_attention_split_plan(name):
    """The wrapper's key-split plan: the splits cover [0, keys) in order
    with no gap, no overlap and no empty split; each is a multiple of the
    key tile and, when there are several, at least the minimum; the CTAs
    are enough for about two an SM, or one split holds every key; the
    cross-attention prefill is split and the pooled forward is not."""
    from repro_torch.kernels import flash_attention as fa
    B, Sq, H, KV, keys = SPLIT_SHAPES[name]
    n, split_len = fa.splits(B, Sq, H, KV, keys, SMS)
    assert n >= 1 and split_len > 0 and split_len % fa._TILE == 0
    spans = [(i * split_len, min((i + 1) * split_len, keys))
             for i in range(n)]
    if keys:
        assert spans[0][0] == 0 and spans[-1][1] == keys
        assert all(hi > lo for lo, hi in spans)
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    else:
        assert n == 1
    if n > 1:
        assert split_len >= fa._MIN_SPLIT
    ctas = -(-Sq * (H // KV) // fa._ROWS) * KV * B
    if ctas >= 2 * SMS or keys < 2 * fa._MIN_SPLIT:
        assert n == 1
    if name == "whisper_cross_prefill":
        assert n > 1 and ctas * n >= 96
    if name in ("pooled", "tail"):
        assert n == 1
    if name in ("whisper_encoder", "causal_split_prefix"):
        assert n > 1            # several query tiles, each split too


def test_flash_attention_split_plan_takes_shapes_only():
    """The plan is a function of the shapes and the SM count alone (never
    of kv_len or prefix_len, which live on the device), so choosing it
    needs no host sync: the planner takes no length, and the wrapper's one
    call of it is built from shape names and the device index only (no
    length tensor, no read of a tensor's values)."""
    import ast
    import inspect

    from repro_torch.kernels import flash_attention as fa
    assert list(inspect.signature(fa.splits).parameters) == \
        ["B", "Sq", "H", "KV", "keys", "sms"]
    tree = ast.parse(inspect.getsource(fa.flash_attention))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == "splits"]
    assert len(calls) == 1
    nodes = [n for a in calls[0].args for n in ast.walk(a)]
    names = {n.id for n in nodes if isinstance(n, ast.Name)}
    attrs = {n.attr for n in nodes if isinstance(n, ast.Attribute)}
    assert names <= {"B", "Sq", "H", "KV", "Sp", "Sk", "build", "q"}, names
    assert attrs <= {"sm_count", "device", "index"}, attrs


def test_flash_attention_routes_only_cpu_to_the_plain_version():
    """Another device than the CPU reaches the kernel or an error, never the
    plain version (a meta tensor stands in for one here)."""
    q = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention(q, q, q)


# ---------------- (c) the prefix gather ----------------

def test_gather_prefix_kv_matches_jax_exactly():
    """(c) Same int8 arena, scales and prefix page vectors (padded with the
    trash page past each row's prefix) into both gathers: equal f32 K/V."""
    rng = np.random.RandomState(7)
    P, ps, KV, hd = 9, 4, 2, 16
    kp = rng.randint(-127, 128, (P, ps, KV, hd)).astype(np.int8)
    vp = rng.randint(-127, 128, (P, ps, KV, hd)).astype(np.int8)
    ks = (rng.rand(P, KV) * 0.05 + 1e-3).astype(np.float32)
    vs = (rng.rand(P, KV) * 0.05 + 1e-3).astype(np.float32)
    table = np.array([[3, 7, TRASH_PAGE, TRASH_PAGE],
                      [5, TRASH_PAGE, TRASH_PAGE, TRASH_PAGE],
                      [8, 1, 2, 6]], np.int32)
    jk, jv = jops.gather_prefix_kv(*(jnp.asarray(x) for x in
                                     (kp, vp, ks, vs, table)))
    k, v = ops.gather_prefix_kv(*(torch.tensor(x) for x in
                                  (kp, vp, ks, vs, table)))
    assert k.dtype == torch.float32 and tuple(k.shape) == (3, 16, KV, hd)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


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


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _assert_bf16_close(got, want, tol):
    got, want = _f32(got), _f32(want)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    worst = np.abs(got - want).max()
    assert rel <= tol[0] and worst <= tol[1], (rel, worst)


# ---------------- (d) prefill with a prefix ----------------

def test_prefill_with_prefix_matches_jax(fms):
    """(d) The tail of three prompts behind a prefix operand (bf16 K/V of
    every layer, prefix lengths 8, 3 and 0 of 8 positions, tail lengths 5,
    6 and 1 of 6) at absolute positions: the last-token logits and the tail
    cache of every layer within test_torch_models.py's bounds (measured
    on this input: logits rel-L2 6.9e-3, max 0.025 on |logits| up to 3.6;
    cache rel-L2 1.8e-3)."""
    jfm, fm, cfg = fms
    rng = np.random.RandomState(9)
    B, T, Sp = 3, 6, 8
    nper, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    toks = rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
    tail_len = np.array([5, 6, 1], np.int32)
    prefix_len = np.array([8, 3, 0], np.int32)
    pre = {n: (rng.randn(nper, B, Sp, kv, hd) * 2).astype(np.float32)
           for n in ("k", "v")}
    pos = prefix_len[:, None] + np.arange(T)[None]
    jcache = jlm.init_cache(jfm.cfg, B, T, kv_quant=False)
    jlogits, jcache = jlm.prefill(
        jfm.params, jfm.cfg, tokens=jnp.asarray(toks), cache=jcache,
        seq_lens=jnp.asarray(tail_len), pos=jnp.asarray(pos),
        prefix=[{n: jnp.asarray(pre[n], jnp.bfloat16) for n in pre}],
        prefix_len=jnp.asarray(prefix_len))
    cache = lm.init_cache(cfg, B, T, kv_quant=False, device="cpu")
    logits, cache = lm.prefill(
        fm.params, cfg, tokens=torch.tensor(toks), cache=cache,
        seq_lens=torch.tensor(tail_len), pos=torch.tensor(pos),
        prefix=[{n: torch.tensor(pre[n]).to(torch.bfloat16) for n in pre}],
        prefix_len=torch.tensor(prefix_len))
    _assert_bf16_close(logits, jlogits, LOGIT_TOL)
    for n in ("k", "v"):
        _assert_bf16_close(cache[0][n], jcache[0][n], HIDDEN_TOL)
    np.testing.assert_array_equal(cache[0]["len"].numpy(),
                                  np.asarray(jcache[0]["len"]))
    # the prefix matters: without it the logits leave the bound
    bare = lm.init_cache(cfg, B, T, kv_quant=False, device="cpu")
    alone, _ = lm.prefill(fm.params, cfg, tokens=torch.tensor(toks),
                          cache=bare, seq_lens=torch.tensor(tail_len),
                          pos=torch.tensor(pos))
    assert np.abs(_f32(alone) - _f32(jlogits))[:2].max() > 4 * LOGIT_TOL[1]


# ---------------- the tail-page scatter ----------------

WRITE_KW = dict(num_slots=2, prompt_len=16, max_new=8, chunk=2, paged=True,
                page_size=4)


def _subs_np(pool, keys):
    return [{k: np.asarray(sub[k], np.float32) if not isinstance(
        sub[k], torch.Tensor) else sub[k].float().numpy() for k in keys}
        for sub in pool]


def test_paged_tail_write_matches_jax(fms):
    """The same float tail cache and mapped prefix pages into both engines'
    tail scatter: codes exact, scales to 1e-6, the boundary page at the
    slot scale, and the slot scale folding in the prefix pages' scales
    (here the prefix pages carry the largest scale on some heads, so the
    slot scale is theirs there)."""
    jfm, fm, cfg = fms
    jeng, eng = JDecodeEngine(jfm, **WRITE_KW), DecodeEngine(fm, **WRITE_KW)
    npages, skip, true_len, slot = 2, 2, 13, 1   # tail of 5: pages 0, 1
    boundary = true_len // 4 - skip              # tail page 1
    rng = np.random.RandomState(4)
    shape = (cfg.num_layers, 1, npages * 4, cfg.num_kv_heads, cfg.head_dim)
    cache = []
    for _ in jeng.pool:
        kv = {n: (rng.randn(*shape) * (1 + rng.rand(*shape[:3])[..., None,
                                                                None]))
              .astype(np.float32) for n in ("k", "v")}
        for n in kv:
            kv[n][:, :, true_len - skip * 4:] = 0.0
        cache.append(kv)
    prefix_pages = np.array([6, 2, 0, 0], np.int32)   # 2 mapped, trash-padded
    pscale = (rng.rand(cfg.num_layers, cfg.num_kv_heads) * 0.08) \
        .astype(np.float32)
    for jsub, sub in zip(jeng.pool, eng.pool):
        for n in ("k_scale", "v_scale"):
            full = np.zeros(sub[n].shape, np.float32)
            full[:, 6] = pscale
            full[:, 2] = pscale * 0.5
            full[:, 0] = 10.0            # the trash page's scale: masked
            jsub[n] = jnp.asarray(full)
            sub[n].copy_(torch.tensor(full))
    tail_pages = np.array([5, 7], np.int32)
    jeng.pool = jeng._paged_tail_write_fn(npages)(
        jeng.pool, [{n: jnp.asarray(c[n]) for n in c} for c in cache],
        jnp.int32(slot), jnp.asarray(tail_pages), jnp.int32(true_len),
        jnp.int32(boundary), jnp.asarray(prefix_pages), jnp.int32(skip))
    eng.pool = eng._paged_tail_write_fn(npages)(
        eng.pool, [{n: torch.tensor(c[n]) for n in c} for c in cache],
        torch.tensor([slot]), torch.tensor(tail_pages).long(),
        torch.tensor([true_len], dtype=torch.int32), torch.tensor([boundary]),
        torch.tensor(prefix_pages).long(), torch.tensor([skip]))
    keys = ("k", "v", "k_scale", "v_scale", "slot_k_scale", "slot_v_scale",
            "len")
    for jsub, sub in zip(_subs_np(jeng.pool, keys), _subs_np(eng.pool, keys)):
        for n in ("k", "v"):
            np.testing.assert_array_equal(sub[n][:, [5, 7]],
                                          jsub[n][:, [5, 7]])
            np.testing.assert_allclose(sub[f"{n}_scale"], jsub[f"{n}_scale"],
                                       rtol=1e-6, atol=0)
            slot_sc = sub[f"slot_{n}_scale"][:, slot]
            np.testing.assert_allclose(slot_sc, jsub[f"slot_{n}_scale"][:,
                                                                        slot],
                                       rtol=1e-6)
            np.testing.assert_allclose(sub[f"{n}_scale"][:, 7], slot_sc,
                                       rtol=1e-6)
            tail_max = np.abs(cache[0][n][:, 0]).max(axis=(1, 3)) / 127.0
            assert (slot_sc >= pscale - 1e-9).all()
            assert (slot_sc > tail_max * (1 + 1e-6)).any()
            assert (slot_sc < 9.0).all()             # trash page masked
        assert (sub["len"][:, slot] == true_len).all()


# ---------------- (e) the chunked engine, teacher-forced ----------------

ENGINE_KW = dict(num_slots=4, prompt_len=16, prompt_buckets=(8, 16),
                 max_new=12, chunk=2, paged=True, page_size=4,
                 total_pages=13, chunked_prefill=True)
# measured on this script: at most 0.34 (95% of calls under 0.22) with
# |logits| up to 5.1: the int8 code noise of test_torch_paged.py, whose
# bound this keeps (the pages-mode tails attend those codes dequantized)
ENGINE_LOGIT_TOL = 0.75
DROP_BEFORE = 7           # rid before whose admission sidecars are dropped


def _workload(cfg, seed=21):
    """Sharers of one 8-token (2-page) prefix on lora0 with tails of 0 to 8
    tokens (the 8-token prompt is page-aligned: it re-prefills its last
    page; tails of 1-3 diverge inside the boundary page), mixed with random
    ragged prompts on the other adapters and the base model."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, cfg.vocab_size, 8).astype(np.int32)
    jobs, tails = [], iter((1, 5, 0, 2, 8, 3, 0, 6, 1, 4))
    for i in range(14):
        if i % 3 != 2:
            tail = rng.randint(0, cfg.vocab_size, next(tails))
            prompt, name = np.concatenate([prefix, tail.astype(np.int32)]), \
                "lora0"
        else:
            prompt = rng.randint(0, cfg.vocab_size,
                                 int(rng.randint(1, 17))).astype(np.int32)
            name = ("lora1", None, "lora2")[(i // 3) % 3]
        jobs.append((prompt, name, int(rng.randint(3, 13))))
    return jobs


def _host_state(eng):
    return {
        "ptab": eng._ptab.tolist(), "refs": eng._page_refs.tolist(),
        "free": list(eng._free_pages), "held": eng._held.tolist(),
        "lens": eng._lens.tolist(), "registry": dict(eng._prefix_registry),
        "page_key": dict(eng._page_key), "pending": eng.pending_rids(),
        "page_float": sorted(int(p) for p in eng._page_float),
        "admitted": [tuple(int(x) if i != 1 else x for i, x in enumerate(e))
                     for e in eng.admitted_log],
        "slots": [None if s is None else (s.rid, list(s.tokens), s.done)
                  for s in eng.slots],
        "counters": [eng.deferrals, eng.preemptions, eng.hol_bypasses,
                     eng.prefix_hits, eng.shared_pages_mapped,
                     eng.admissions, eng.steps, eng.prefill_tokens_saved,
                     eng.tail_tokens_computed],
    }


def _drop_sidecars_before(eng, rid):
    """Drop every float sidecar (as a lost host copy would) right before
    the admission of ``rid``, a sharer: it attends the int8 pages (pages
    mode), and so do later sharers until the prefix is registered afresh by
    a full admission."""
    admit = eng._admit_now

    def hooked(req):
        if req.rid == rid:
            eng._page_float.clear()
            eng._prefix_fp_cache.clear()
        return admit(req)
    eng._admit_now = hooked


def _drive(eng, jobs):
    """Joins straight into the engine (deferring when the pool is full),
    more joins between chunks, until everything has retired; the host
    state after every call."""
    states, done = [], []
    _drop_sidecars_before(eng, DROP_BEFORE)
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


@pytest.fixture(scope="module")
def jax_chunked(fms):
    """The JAX chunked paged engine, greedy, under the churn script: the
    logits of every sampler call, the host states, the finished streams."""
    jfm, _, cfg = fms
    jeng = JDecodeEngine(jfm, **ENGINE_KW)
    jcalls = []

    def jsample(logits, keys):
        jax.debug.callback(lambda l: jcalls.append(np.asarray(l, np.float32)),
                           logits, ordered=True)
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), keys
    jeng._sample = jsample
    states, done = _drive(jeng, _workload(jfm.cfg))
    return jcalls, states, done, jeng


def test_chunked_engine_teacher_forced_against_jax(fms, jax_chunked):
    """(e) Logits of every live row within the bound at every sampler call
    and the host state (tables, refcounts, free list, held pages, lengths,
    registry, sidecar key set, admitted log, counters) equal to the JAX
    engine's after every call. The script must have run tail admissions in
    both modes, a page-aligned re-prefill, deferral and preemption."""
    _, fm, cfg = fms
    jcalls, jstates, jdone, jeng = jax_chunked
    eng = DecodeEngine(fm, **ENGINE_KW)
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
    assert worst <= ENGINE_LOGIT_TOL, worst
    for s, js in zip(done, jdone):
        assert (s.rid, s.tokens, s.status) == (js.rid, js.tokens, js.status)
    assert len(done) == 14 and all(len(s.tokens) == s.max_new for s in done)
    modes = {k[3] for k in eng._fn_prefill if k[0] == "tail"}
    assert modes == {"float", "pages"}
    assert eng.prefill_tokens_saved > 0 and eng.prefix_hits >= 3
    assert eng.deferrals >= 1 and eng.preemptions >= 1
    # the page-aligned 8-token prompt re-prefilled its last page
    assert any(toks == 8 and tail == 4
               for _, _, toks, tail in states[-1]["admitted"])
    assert eng.free_page_count() == eng.total_pages - 1
    assert not eng._page_refs.any() and not eng._prefix_registry
    assert not eng._page_float and not eng._prefix_fp_cache


# ---------------- (f), (g): within the port ----------------

def _shared_prompts(cfg, seed, n_sharers=3, prefix_tokens=8):
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, cfg.vocab_size, prefix_tokens).astype(np.int32)
    return [np.concatenate([prefix, rng.randint(0, cfg.vocab_size,
                                                1 + i).astype(np.int32)])
            for i in range(n_sharers)]


@pytest.mark.parametrize("sampling", [dict(temperature=0.0),
                                      dict(temperature=0.7, top_k=8,
                                           sample_seed=3)],
                         ids=["greedy", "topk"])
def test_chunked_matches_full_prefill_in_the_port(fms, sampling):
    """(f) Engines differing only in ``chunked_prefill`` give equal token
    streams for every sharer, greedy and seeded top-k: the tail attends the
    prefix pages' float sidecars, the values a full prefill computes."""
    _, fm, cfg = fms
    prompts = _shared_prompts(cfg, seed=31) + _shared_prompts(cfg, seed=33,
                                                              n_sharers=2)
    outs = {}
    for chunked in (False, True):
        eng = DecodeEngine(fm, num_slots=8, prompt_len=16, max_new=6,
                           chunk=2, paged=True, page_size=4,
                           chunked_prefill=chunked, **sampling)
        for i, p in enumerate(prompts):
            eng.join(f"t{i}", p, adapter_id="lora0", max_new_tokens=6, rid=i)
        outs[chunked] = {d.rid: d.tokens for d in eng.drain()}
        if chunked:
            assert eng.prefill_tokens_saved == 3 * 8
            assert eng.tail_tokens_computed == \
                sum(len(p) for p in prompts) - 3 * 8
        else:
            assert eng.prefill_tokens_saved == 0
    assert outs[True] == outs[False]


def test_chunked_no_new_shape_keys_after_warmup(fms):
    """(g) After one warm join per prompt bucket, the decode ladder and
    ``warm_chunked``, the churn script (sharer joins of every tail bucket,
    both tail modes, deferral, preemption) adds no shape key; and
    ``warm_chunked`` leaves every slot generator's state unchanged."""
    _, fm, cfg = fms
    eng = DecodeEngine(fm, temperature=0.7, top_k=4, sample_seed=5,
                       **ENGINE_KW)
    rng = np.random.RandomState(3)
    for plen in eng.prompt_buckets:
        eng.join("w", rng.randint(0, cfg.vocab_size, plen), rid=-1,
                 max_new_tokens=2)
    eng.drain()
    eng.warm_decode_ladder()
    gens0 = [g.get_state().clone() for g in eng._keys]
    eng.warm_chunked()
    assert all(torch.equal(g.get_state(), s0)
               for g, s0 in zip(eng._keys, gens0))
    eng._rescale_fn()              # the refresh's one key, made on first use
    keys = eng.compile_count()
    assert {k for k in eng._fn_prefill if k[0] == "tail"} == {
        ("tail", fm.adapters.capacity(), tb, mode)
        for tb in eng.tail_buckets for mode in ("float", "pages")}
    _, done = _drive(eng, _workload(cfg))
    assert len(done) == 14 and eng.prefill_tokens_saved > 0
    assert eng.preemptions >= 1 and eng.deferrals >= 1
    assert eng.compile_count() == keys
    assert eng.free_page_count() == eng.total_pages - 1


# ---------------- (h) the serve loop ----------------

def _loop(fm, **engine_kw):
    from repro_torch.core.server import FMplexServer
    from repro_torch.core.vfm import TaskExtensions
    srv = FMplexServer("s0")
    srv.deploy_fm("fm0", fm, scheduler="bfq")
    srv.bind_task("gen", "fm0", extensions=TaskExtensions(adapter_id="lora0"))
    return srv, srv.serve_loop("fm0", engine_kwargs=dict(
        num_slots=4, prompt_len=16, max_new=4, chunk=2, paged=True,
        page_size=4, **engine_kw))


def test_serve_loop_charges_tails_and_splits_ttft(fms):
    """(h) A holder admits in full and a sharer admits its tail only: the
    loop charges the task the full prompt plus the TAIL (never the
    sharer's full prompt) and marks the sharer a prefix hit; a loop run
    over shared-prefix traffic fills both TTFT series, one sample per
    generative request, and its warmup warmed the tail planes."""
    from repro_torch.core.request import Request
    _, fm, cfg = fms
    srv, loop = _loop(fm)
    eng = loop._engine(create=True)
    holder, sharer = _shared_prompts(cfg, seed=41, n_sharers=2)
    reqs = [Request("gen", 0.0, payload=p, tokens=float(len(p) + 4),
                    max_new_tokens=4) for p in (holder, sharer)]
    vfms = srv.vfms_on("fm0")
    for r in reqs:
        loop._inflight[r.rid] = r
        loop._admit_one(eng, vfms, r)

    class Spy:
        charged = collections.Counter()

        def charge_tokens(self, vfms, charges, now):
            self.charged.update(charges)
    spy = Spy()
    loop._charge_admissions(spy, vfms, 0.0)
    assert spy.charged == {"gen": len(holder) + len(sharer) - 8}
    assert loop._prefix_hit_rids == {reqs[1].rid}
    eng.drain()

    srv2, loop2 = _loop(fm)
    loop2.warmup(gen_task="gen")
    eng2 = srv2.engines["fm0"]
    assert any(k[0] == "tail" for k in eng2._fn_prefill)
    trace = [Request("gen", 0.002 * i, payload=p, tokens=float(len(p) + 4),
                     max_new_tokens=4)
             for i, p in enumerate(_shared_prompts(cfg, seed=43,
                                                   n_sharers=4))]
    n_miss = len(loop2.ttft_miss_samples)       # the warmup's requests
    assert not loop2.ttft_hit_samples
    loop2.run(trace, max_wall=120)
    assert all(r.ok for r in trace)
    hits = len(loop2.ttft_hit_samples)
    misses = len(loop2.ttft_miss_samples) - n_miss
    assert hits >= 1 and misses >= 1 and hits + misses == len(trace)
    assert hits == eng2.prefix_hits
    from repro_torch.serving.metrics import mixed_stats, page_gauges
    split = mixed_stats(trace, ttft_split={
        "hit": loop2.ttft_hit_samples,
        "miss": loop2.ttft_miss_samples})["ttft_split"]
    assert split["prefix_hit_n"] == len(loop2.ttft_hit_samples)
    assert page_gauges(eng2)["prefill_tokens_saved"] == \
        eng2.prefill_tokens_saved > 0


# ---------------- (i) the CUDA kernel (GPU only) ----------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are built and run on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["causal", "window_kv_len", "gqa_suffix",
                                  "prefix_kv_len", "long_keys_kv_len",
                                  "hd128_kv_len", "causal_split_prefix",
                                  "encoder_one_row"])
def test_flash_attention_kernel_on_gpu(cuda_device, case):
    """K2 vs its plain version on the card, hd widened to at least 64 (the
    long-keys, causal-split and one-row encoder cases run split over the
    key axis): two bf16 ulps of the largest output over the rows that see
    a key (the kernel returns zeros on a row with none, the plain version
    JAX's mean)."""
    B, Sq, Sk, H, KV, hd, Sp, causal, window, kv_len, prefix_len = \
        ATTN_CASES[case]
    hd = max(hd, 64)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    dev = cuda_device

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = r(B, Sq, H, hd), r(B, Sk, KV, hd), r(B, Sk, KV, hd)
    kw = {"causal": causal, "window": window}
    if kv_len is not None:
        kw["kv_len"] = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    if Sp:
        kw.update(prefix_k=r(B, Sp, KV, hd), prefix_v=r(B, Sp, KV, hd),
                  prefix_len=torch.tensor(prefix_len, dtype=torch.int32,
                                          device=dev))
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    rows = torch.as_tensor(_sees_a_key(ATTN_CASES[case]), device=dev)
    tol = 2 * 2.0 ** -8 * want.float()[rows].abs().max().item()
    assert (got.float() - want.float()).abs()[rows].max().item() <= tol

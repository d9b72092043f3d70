"""The port's encoder-decoder serving and its float flash-decode (K5)
against the JAX package's, on reduced whisper-base (2 decoder and 2 encoder
layers, d 64, 4 heads of 16) with the JAX weights and adapters converted to
the port, and encoder frames made from a seed with numpy:

* (a) K5's plain version (``ops.decode_attention`` on the CPU) against the
  JAX jnp ``models.attention.decode_attention`` and against the Pallas K5
  in interpret mode, over B, MHA and GQA, S a block multiple or not, hd,
  f32 and bf16, a window, and lengths of 1, S and ragged;
* (b) the float dense pool: ``self_attention_decode`` on a bf16 cache
  against JAX (output and the written cache row);
* (c) the model: ``forward``, var-len ``prefill(enc_embeds=)`` and
  teacher-forced ``decode_step`` logits against JAX; the JAX whisper tree
  loads leaf for leaf;
* (d) the cache plan equal to JAX's; ``StateSlotPool``'s strict
  alloc/free;
* (e) the pooled forward (``PhysicalFM.run_batch``) against JAX;
* (f) the engine on the dense int8, dense float and paged int8 pools,
  TEACHER-FORCED against the JAX engine under join/leave/cancel churn (and
  on the paged pool deferral and preemption): host state (slot table,
  ``state_pool`` in-use set and gauges, and on the paged pool tables,
  refcounts, free list) EQUAL after every call; the strict frame count, the
  zero-frame default and the demoted prefix sharing;
* (g) ``ServeLoop`` end to end on reduced whisper;
* (h) on a GPU only, the K5 CUDA kernel against its plain version.

Tolerances: the plain K5 computes the jnp function's f32 products in
another summation order (f32: 1e-5); in bf16 both round the probabilities
and the output to bf16, so they may land one bf16 ulp apart (two ulps of
the largest output). The Pallas kernel keeps the probabilities in f32, so
in bf16 the bound is tests/test_kernels.py's 3e-2. The model and engine
bounds are bf16 noise floors, stated and measured beside each test (see
test_torch_models.py for why bf16 models are compared by relative L2 plus a
per-element ceiling).
"""
import pytest

torch = pytest.importorskip("torch")

import warnings  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core.cache_manager import CachePlan as JCachePlan  # noqa: E402
from repro.core.decode_engine import DecodeEngine as JDecodeEngine  # noqa: E402
from repro.core.physical import PhysicalFM as JPhysicalFM  # noqa: E402
from repro.kernels import decode_attention as jpallas  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.common import NO_SHARD  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.cache_manager import (CachePlan, StateSlotPool,  # noqa: E402
                                            dense_state_keys)
from repro_torch.core.decode_engine import DecodeEngine  # noqa: E402
from repro_torch.core.physical import PhysicalFM  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402

F32_TOL = 1e-5
PALLAS_BF16_TOL = 3e-2
BT = 8
ADAPTER_SCALE = 0.15
FRAME_SCALE = 0.5
ENC_LEN = 12
# Bounds, (relative L2, max abs), with what this file's inputs measured on
# the CPU. The encoder's bf16 rounding noise (its output differs by ~1e-2
# between the frameworks, as a 2-layer decoder's does) reaches the decoder
# through every cross-attention, so these sit above test_torch_models.py's
# decoder-only floors. It is noise, not a fault: fed the JAX encoder's
# output, the port's decoder matches at the decoder-only floor
# (test_decoder_on_the_jax_encoder_output_matches_tightly).
HIDDEN_TOL = (6e-2, 0.4)      # forward hidden: 4.1e-2, 0.27 (|h| <= 3.3)
ENCODER_TOL = (2e-2, 0.15)    # encoder output: 9.6e-3, 0.094 (|e| <= 4)
DECODER_TOL = (2e-2, 0.15)    # decoder on the JAX encoder: 9.7e-3, 0.090
CROSS_KV_TOL = (2e-2, 0.6)    # stored cross K/V: 8.8e-3, 0.33 (|x| <= 13.6)
LOGIT_TOL = (6e-2, 0.4)       # prefill + 4 decode steps: 4.3e-2, 0.28
#                               (int8), 2.9e-2, 0.13 (float), |l| <= 3.7
POOLED_TOL = (5e-2, 0.2)      # pooled features: 2.8e-2, 0.10 (|f| <= 2.5)
# teacher-forced engine logits, worst call: 0.87 (int8 pools: the cross
# noise moves int8 codes too, as in test_torch_paged.py) and 0.53 (float
# pool); 95% of calls <= 0.5, a single admission prefill up to 0.50, with
# |logits| <= 4.2. Other frames move the logits by 3.3
# (test_frames_move_the_logits) and the host state is held exactly.
ENGINE_LOGIT_TOL = 1.0


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite runs in parallel workers on shared
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def assert_bf16_close(got, want, tol):
    """Relative L2 error and largest element difference within ``tol``."""
    got, want = _f32(got), _f32(want)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    worst = np.abs(got - want).max()
    assert rel <= tol[0] and worst <= tol[1], (rel, worst)


# ---------------- (a) the plain version of K5 ----------------

def _decode_case(seed, B, H, KV, S, hd, lens):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, hd).astype(np.float32)
    k = rng.randn(B, S, KV, hd).astype(np.float32)
    v = rng.randn(B, S, KV, hd).astype(np.float32)
    if lens == "ragged":
        lens = rng.randint(1, S + 1, B)
    elif lens == "full":
        lens = np.full(B, S)
    else:
        lens = np.full(B, lens)
    return q, k, v, np.asarray(lens, np.int32)


DECODE_SHAPES = [(2, 8, 2, 256, 64),    # GQA, S a block multiple
                 (3, 4, 4, 100, 32),    # MHA, S no multiple of any block
                 (1, 4, 1, 75, 16),     # MQA, odd S
                 (3, 28, 4, 128, 128),  # qwen2-7b's group of 7
                 (3, 32, 8, 100, 80)]   # h2o-danube-1.8b's hd 80


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("lens", [1, "full", "ragged"])
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("B,H,KV,S,hd", DECODE_SHAPES)
def test_decode_attention_plain_matches_jax(B, H, KV, S, hd, window, lens,
                                            dtype):
    """The op's plain route (model layout) against the JAX jnp function:
    the probabilities round to the cache dtype before P·V on both sides."""
    q, k, v, ln = _decode_case(S + B, B, H, KV, S, hd, lens)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jattn.decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(ln), window=window), np.float32)
    got = attn.decode_attention(torch.tensor(q).to(dtype),
                                torch.tensor(k).to(dtype),
                                torch.tensor(v).to(dtype), torch.tensor(ln),
                                window=window)
    assert got.dtype == dtype
    tol = F32_TOL if dtype == torch.float32 else \
        2 * 2.0 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                               rtol=F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("B,H,KV,S,hd,block_s", [(3, 28, 4, 128, 128, 64),
                                                 (3, 32, 8, 128, 80, 64),
                                                 (2, 8, 2, 256, 64, 64),
                                                 (3, 4, 4, 96, 32, 32)])
def test_decode_attention_plain_matches_pallas_interpret(B, H, KV, S, hd,
                                                         block_s, window,
                                                         dtype):
    """Against the Pallas K5 in interpret mode (head-major, ``block_s``
    dividing S), as tests/test_kernels.py runs it. In f32 the two compute
    the same; in bf16 the Pallas kernel keeps p in f32 (bound 3e-2)."""
    q, k, v, ln = _decode_case(7 * B + S, B, H, KV, S, hd, "ragged")
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jpallas.decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(k.transpose(0, 2, 1, 3), jdt),
        jnp.asarray(v.transpose(0, 2, 1, 3), jdt), jnp.asarray(ln),
        window=window, block_s=block_s, interpret=True)
    got = ops.decode_attention(torch.tensor(q).to(dtype),
                               torch.tensor(k).to(dtype),
                               torch.tensor(v).to(dtype), torch.tensor(ln),
                               window=window)
    tol = F32_TOL if dtype == torch.float32 else PALLAS_BF16_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_decode_attention_rounds_p_to_the_cache_dtype():
    """Two values that cancel: the output is a small difference of large
    products, so the bf16 rounding of the probabilities (the jnp function's
    ``p.astype(v_cache.dtype)``) moves it by hundreds of the output's bf16
    ulps. The plain version matches the jnp function there; the same
    attention with f32 probabilities does not."""
    from repro_torch.kernels import ref
    rng = np.random.RandomState(5)
    bf = torch.bfloat16
    q = torch.tensor(rng.randn(1, 1, 16), dtype=torch.float32).to(bf)
    k = torch.tensor(rng.randn(1, 2, 1, 16), dtype=torch.float32).to(bf)
    s = (q[0, 0].float() @ k[0, :, 0].float().T) / 4.0
    p = torch.softmax(s, dim=-1).double()
    v1 = torch.tensor(rng.randn(16) * 100.0)
    v = torch.stack([v1, -v1 * p[0] / p[1]])[None, :, None].to(bf)
    ln = torch.tensor([2], dtype=torch.int32)
    want = np.asarray(jattn.decode_attention(
        *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
        jnp.asarray(ln.numpy())), np.float32)
    got = attn.decode_attention(q, k, v, ln).float().numpy()
    f32_p = ref.decode_attention_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                                     ln).float().numpy()
    ulp = 2.0 ** -8 * np.abs(want).max()
    assert np.abs(got - want).max() <= 2 * ulp
    assert np.abs(f32_p - want).max() > 50 * ulp


def test_decode_attention_routes_only_cpu_to_the_plain_version():
    """The model function goes through the op, and another device than the
    CPU reaches the kernel or an error, never the plain version (a meta
    tensor stands in for one here)."""
    q = torch.empty((1, 2, 16), device="meta")
    kv = torch.empty((1, 8, 2, 16), device="meta")
    ln = torch.ones(1, dtype=torch.int32)
    for fn in (ops.decode_attention, attn.decode_attention):
        with pytest.raises(ValueError, match="no kernel for device"):
            fn(q, kv, kv, ln)


def test_split_plan_covers_every_position():
    """The wrapper's split of S over CTAs: each split a multiple of 32, at
    least 256 positions unless S is shorter, the splits covering S exactly
    once, at most 8 (a pair's splits are one thread-block cluster) and no
    more CTAs than two an SM (one wave); one split when the (row, kv head)
    pairs already fill the card."""
    from repro_torch.kernels.decode_attention import splits
    for pairs, S in ((64, 1500), (16, 1500), (256, 161), (1, 33), (8, 4096),
                     (1, 100000)):
        n, sl = splits(pairs, S, 132)
        assert sl % 32 == 0 and (n - 1) * sl < S <= n * sl
        assert sl >= min(256, 32 * -(-S // 32))
        assert n <= 8 and (n == 1 or n * pairs <= 2 * 132)
    assert splits(64, 1500, 132) == (4, 384)
    assert splits(256, 161, 132)[0] == 1


# ---------------- the weights ----------------

@pytest.fixture(scope="module")
def model():
    jcfg = jreduced(jget_config("whisper-base"))
    cfg = reduced(get_config("whisper-base"))
    assert (cfg.num_layers, cfg.encoder_layers, cfg.d_model) == \
        (jcfg.num_layers, jcfg.encoder_layers, jcfg.d_model)
    jparams = jlm.init_model(jax.random.PRNGKey(0), jcfg)
    params = weights.model_params(jax.tree.map(np.asarray, jparams),
                                  device="cpu")
    return jcfg, cfg, jparams, params


def test_whisper_tree_loads_leaf_for_leaf(model):
    """Same structure (decoder with ln_x/cross, encoder subtree), same
    values; attention, cross and MLP matrices cast once to bf16 in both
    stacks, norms and the head kept f32."""
    jcfg, cfg, jparams, params = model
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    raw = weights.to_torch(jax.tree.map(np.asarray, jparams), device="cpu")

    def at(tree, path):
        for p in path:
            tree = tree[p.key if hasattr(p, "key") else p.idx]
        return tree
    assert len(jflat) == len(tree_leaves(params))
    for path, leaf in jflat:
        got, plain = at(params, path), at(raw, path)
        np.testing.assert_array_equal(plain.numpy(), np.asarray(leaf))
        names = [getattr(p, "key", None) for p in path]
        matrix = any(n in ("attn", "cross", "ffn") for n in names) \
            or names[-1] == "embed"
        assert got.dtype == (torch.bfloat16 if matrix else torch.float32)
        np.testing.assert_array_equal(
            got.float().numpy(),
            np.asarray(jnp.asarray(leaf).astype(jnp.bfloat16 if matrix
                                                 else jnp.float32),
                       np.float32))
    assert set(params["layers"][0]) == {"ln1", "attn", "ln_x", "cross",
                                        "ln2", "ffn"}
    assert "bq" not in params["layers"][0]["cross"]
    assert params["encoder"]["layers"][0]["attn"]["wq"].shape[0] == \
        cfg.encoder_layers


# ---------------- (b) the float dense pool ----------------

def test_float_pool_self_attention_decode_matches_jax(model):
    """One decode step of a decoder self-attention on a bf16 dense cache
    (ragged lengths, one row at length 0): output and the written cache
    row against JAX."""
    jcfg, cfg, jparams, params = model
    rng = np.random.RandomState(3)
    B, S = 3, 10
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    x = (rng.randn(B, 1, cfg.d_model) * 0.5).astype(np.float32)
    k = rng.randn(B, S, kv, hd).astype(np.float32)
    v = rng.randn(B, S, kv, hd).astype(np.float32)
    ln = np.array([4, 0, 9], np.int32)
    jp = jax.tree.map(lambda t: t[0], jparams["layers"][0]["attn"])
    p = {n: t[0] for n, t in params["layers"][0]["attn"].items()}
    jcache = {"k": jnp.asarray(k, jnp.bfloat16),
              "v": jnp.asarray(v, jnp.bfloat16), "len": jnp.asarray(ln)}
    cache = {"k": torch.tensor(k).to(torch.bfloat16),
             "v": torch.tensor(v).to(torch.bfloat16),
             "len": torch.tensor(ln)}
    jout, jcache = jattn.self_attention_decode(
        jp, jnp.asarray(x, jnp.bfloat16), jcache, jcfg, NO_SHARD,
        pos=jnp.asarray(ln)[:, None])
    out, cache = attn.self_attention_decode(
        p, torch.tensor(x).to(torch.bfloat16), cache, cfg,
        pos=torch.tensor(ln)[:, None])
    assert_bf16_close(out, jout, (2e-2, 0.05))
    np.testing.assert_array_equal(cache["len"].numpy(),
                                  np.asarray(jcache["len"]))
    for n in ("k", "v"):
        assert_bf16_close(cache[n], jcache[n], (1e-2, 0.05))


# ---------------- (c) the model ----------------

def _lora(cfg, seed=5, na=4):
    """A random q/v LoRA stack (3 adapters and a zero pad slot)."""
    rng = np.random.RandomState(seed)
    nper, d, r = cfg.num_layers, cfg.d_model, 4
    out = cfg.num_heads * cfg.head_dim
    tree = [{p: {"a": (rng.randn(nper, na, d, r) * 0.2).astype(np.float32),
                 "b": (rng.randn(nper, na, r, out) * 0.2).astype(np.float32)}
             for p in ("q", "v")}]
    for p in ("q", "v"):
        tree[0][p]["b"][:, na - 1] = 0.0
    return jax.tree.map(jnp.asarray, tree), weights.adapter_tree(tree,
                                                                 device="cpu")


@pytest.mark.parametrize("kv_quant", [True, False], ids=["int8", "float"])
def test_prefill_and_decode_match_jax(model, kv_quant):
    """``forward`` hidden states, then var-len ``prefill(enc_embeds=)`` and
    four teacher-forced ``decode_step`` calls (cross-attention decode
    through K5's plain version; self-attention on the int8 or the float
    pool): logits against JAX over all calls."""
    jcfg, cfg, jparams, params = model
    jlora, lora = _lora(cfg)
    rng = np.random.RandomState(0)
    B, S = 3, 7
    toks = rng.randint(0, cfg.vocab_size, (B, S + 4)).astype(np.int32)
    enc = (rng.randn(B, ENC_LEN, cfg.d_model) * FRAME_SCALE).astype(np.float32)
    aidx = np.array([0, 3, 2], np.int32)
    sl = np.array([7, 3, 5], np.int32)
    jh, _, _ = jlm.forward(jparams, jcfg, tokens=jnp.asarray(toks[:, :S]),
                           enc_embeds=jnp.asarray(enc), lora=jlora,
                           adapter_idx=jnp.asarray(aidx))
    h, _ = lm.forward(params, cfg, tokens=torch.tensor(toks[:, :S]).long(),
                      enc_embeds=torch.tensor(enc), lora=lora,
                      adapter_idx=torch.tensor(aidx))
    assert_bf16_close(h, jh, HIDDEN_TOL)
    jc = jlm.init_cache(jcfg, B, 16, kv_quant=kv_quant, enc_len=ENC_LEN)
    c = lm.init_cache(cfg, B, 16, kv_quant=kv_quant, enc_len=ENC_LEN,
                      device="cpu")
    jl, jc = jlm.prefill(jparams, jcfg, tokens=jnp.asarray(toks[:, :S]),
                         enc_embeds=jnp.asarray(enc), cache=jc, lora=jlora,
                         adapter_idx=jnp.asarray(aidx),
                         seq_lens=jnp.asarray(sl))
    tl, c = lm.prefill(params, cfg, tokens=torch.tensor(toks[:, :S]).long(),
                       enc_embeds=torch.tensor(enc), cache=c, lora=lora,
                       adapter_idx=torch.tensor(aidx),
                       seq_lens=torch.tensor(sl))
    for jsub, sub in zip(jc, c):             # the stored cross K/V
        for n in ("ck", "cv"):
            assert_bf16_close(sub[n], jsub[n], CROSS_KV_TOL)
    want, got = [np.asarray(jl)], [tl.numpy()]
    for t in range(4):
        nt = toks[:, S + t]
        jl, jc = jlm.decode_step(jparams, jcfg, tokens=jnp.asarray(nt),
                                 cache=jc, lora=jlora,
                                 adapter_idx=jnp.asarray(aidx))
        tl, c = lm.decode_step(params, cfg, tokens=torch.tensor(nt).long(),
                               cache=c, lora=lora,
                               adapter_idx=torch.tensor(aidx))
        want.append(np.asarray(jl))
        got.append(tl.numpy())
    assert_bf16_close(np.stack(got), np.stack(want), LOGIT_TOL)


def test_decoder_on_the_jax_encoder_output_matches_tightly(model,
                                                          monkeypatch):
    """The decoder alone (self-attention, cross-attention, MLP) fed the
    JAX encoder's own output: the hidden states match at the decoder-only
    bf16 floor, so the looser whole-model bounds are the encoder's
    rounding noise carried through the cross-attention."""
    from repro.models import blocks as jblk
    from repro.models.layers import rmsnorm as jrmsnorm
    jcfg, cfg, jparams, params = model
    rng = np.random.RandomState(0)
    B, S = 3, 7
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    enc = (rng.randn(B, ENC_LEN, cfg.d_model) * FRAME_SCALE).astype(np.float32)
    e, _, _ = jlm._stack_forward(
        jparams["encoder"]["layers"],
        [jblk.SubLayer(kind="attn", has_moe=False, has_ffn=True)],
        jnp.asarray(enc, jnp.bfloat16), jcfg, NO_SHARD, mode="full",
        cache=None, pos=jnp.arange(ENC_LEN)[None], pos3=None, causal=False,
        enc_out=None, remat=False)
    jenc = np.asarray(jrmsnorm(jparams["encoder"]["final_norm"], e,
                               jcfg.norm_eps), np.float32)
    assert_bf16_close(lm.encode(params, cfg, torch.tensor(enc)), jenc,
                      ENCODER_TOL)
    monkeypatch.setattr(lm, "encode", lambda p, c, x: torch.tensor(jenc).to(
        torch.bfloat16))
    jh, _, _ = jlm.forward(jparams, jcfg, tokens=jnp.asarray(toks),
                           enc_embeds=jnp.asarray(enc))
    h, _ = lm.forward(params, cfg, tokens=torch.tensor(toks).long(),
                      enc_embeds=torch.tensor(enc))
    assert_bf16_close(h, jh, DECODER_TOL)


def test_frames_move_the_logits(model):
    """The encoder's frames reach the decoder: other frames move the logits
    by far more than the parity bound (a dropped cross-attention would
    pass the parity tests only if the bound were loose)."""
    _, cfg, _, params = model
    rng = np.random.RandomState(1)
    toks = torch.tensor(rng.randint(0, cfg.vocab_size, (1, 6))).long()
    outs = []
    for seed in (2, 3):
        enc = np.random.RandomState(seed).randn(1, ENC_LEN, cfg.d_model)
        c = lm.init_cache(cfg, 1, 8, enc_len=ENC_LEN, device="cpu")
        lg, _ = lm.prefill(params, cfg, tokens=toks, cache=c,
                           enc_embeds=torch.tensor(enc * FRAME_SCALE,
                                                   dtype=torch.float32))
        outs.append(lg.numpy())
    assert np.abs(outs[0] - outs[1]).max() > 4 * LOGIT_TOL[1]


# ---------------- (d) the cache plan and the state-slot pool ----------------

@pytest.mark.parametrize("arch", ["whisper-base", "stablelm-1.6b"])
@pytest.mark.parametrize("paged", [True, False])
def test_cache_plan_matches_jax(arch, paged):
    jplan = JCachePlan.for_config(jreduced(jget_config(arch)), paged)
    plan = CachePlan.for_config(reduced(get_config(arch)), paged)
    got = {f: getattr(plan, f) for f in ("paged", "has_attention",
                                         "has_recurrent", "has_encoder",
                                         "prefix_sharing_ok",
                                         "chunked_prefill_ok",
                                         "speculative_ok", "spill_resume_ok",
                                         "needs_state_slots")}
    assert got == {f: getattr(jplan, f) for f in got}
    assert [(s.kind, s.paged, s.grows, s.has_cross, s.fixed_state)
            for s in plan.sublayers] == \
        [(s.kind, s.paged, s.grows, s.has_cross, s.fixed_state)
         for s in jplan.sublayers]
    if arch == "whisper-base":
        assert plan.has_encoder and plan.needs_state_slots
        assert not plan.prefix_sharing_ok and not plan.speculative_ok


def test_state_slot_pool_is_strict():
    pool = StateSlotPool(3)
    pool.alloc(1)
    pool.alloc(2)
    with pytest.raises(RuntimeError, match="double-allocated"):
        pool.alloc(1)
    pool.free(1)
    with pytest.raises(RuntimeError, match="double-freed"):
        pool.free(1)
    pool.note_deferral()
    assert pool.slots_in_use() == {2} and pool.available() == 2
    assert pool.gauges() == {"state_slots_total": 3, "state_slots_in_use": 1,
                             "state_slots_peak": 2, "state_slot_deferrals": 1}
    assert (pool.allocs, pool.frees) == (2, 1)
    assert dense_state_keys({"k": 0, "v": 0, "len": 0, "ck": 0, "cv": 0}) \
        == ["ck", "cv"]
    assert dense_state_keys({"k": 0, "page_table": 0}) == []


# ---------------- (e) the pooled forward ----------------

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
    jcfg = jreduced(jget_config("whisper-base"))
    cfg = reduced(get_config("whisper-base"))
    jfm = JPhysicalFM(jcfg, seed=0, input_len=8, lora_rank=4,
                      lora_impl="segmented", seg_block_t=BT)
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


def test_pooled_forward_matches_jax(fms):
    """Stub frames to the encoder, a BOS-only decoder stream with the
    requests' adapters, pooled over positions: features against JAX."""
    jfm, fm, cfg = fms
    rng = np.random.RandomState(9)
    embeds = (rng.randn(3, 8, cfg.d_model) * FRAME_SCALE).astype(np.float32)
    aidx = np.array([0, fm.adapters.capacity(), 1], np.int32)
    want = jfm.run_batch(embeds, aidx)
    got = fm.run_batch(embeds, aidx)
    assert got.shape == (3, cfg.d_model)
    assert_bf16_close(got, want, POOLED_TOL)


# ---------------- (f) the engine, teacher-forced against JAX ----------------

POOLS = {
    "dense_int8": dict(paged=False),
    "dense_float": dict(paged=False, kv_quant=False),
    # 8 usable pages of 4: a stream grows to 4-5 pages, so joins defer and
    # live streams are preempted
    "paged": dict(paged=True, page_size=4, total_pages=9),
}
ENGINE_KW = dict(num_slots=4, prompt_len=8, prompt_buckets=(4, 8), max_new=8,
                 chunk=2, enc_len=ENC_LEN)


def _workload(cfg, seed=21):
    """Ragged prompts on both adapters and the base model, most with their
    own random frames, some frameless (the zero-frame default)."""
    rng = np.random.RandomState(seed)
    jobs = []
    for i in range(10):
        prompt = rng.randint(0, cfg.vocab_size,
                             int(rng.randint(2, 9))).astype(np.int32)
        feats = None if i % 4 == 1 else \
            (rng.randn(ENC_LEN, cfg.d_model) * FRAME_SCALE).astype(np.float32)
        jobs.append((prompt, ("lora0", "lora1", None)[i % 3],
                     int(rng.randint(5, 9)), feats))
    return jobs


def _host_state(eng):
    sp = eng.state_pool
    st = {
        "slots": [None if s is None else (s.rid, list(s.tokens), s.done,
                                          s.status) for s in eng.slots],
        "state_pool": (sorted(sp.slots_in_use()), sp.gauges(), sp.allocs,
                       sp.frees),
        "pending": eng.pending_rids(),
        "counters": [eng.admissions, eng.steps, eng.quarantines, eng.cancels],
    }
    if eng.paged:
        st.update(ptab=eng._ptab.tolist(), refs=eng._page_refs.tolist(),
                  free=list(eng._free_pages), held=eng._held.tolist(),
                  lens=eng._lens.tolist(),
                  paged_counters=[eng.deferrals, eng.preemptions,
                                  eng.prefix_hits])
    return st


def _drive(eng, jobs):
    """Joins (straight into the engine; the paged pool defers when full,
    the dense one is only joined into a free slot), a cancel of the latest
    joined stream after four steps (live or deferred), more joins between
    chunks, until everything has retired; the host state after every
    call."""
    states, done, cancelled = [], [], None
    todo = list(enumerate(jobs))

    def join_next():
        i, (p, name, n, feats) = todo.pop(0)
        eng.join(f"t{i}", p, adapter_id=name, max_new_tokens=n, rid=i,
                 enc_feats=feats)
        states.append(_host_state(eng))

    with warnings.catch_warnings():      # folded resume prompts truncate
        warnings.simplefilter("ignore", RuntimeWarning)
        while todo and (eng.paged or eng.free_slots()) and len(todo) > 4:
            join_next()
        while eng.active_count() or eng.pending_count() or todo:
            done += eng.step_chunk()
            states.append(_host_state(eng))
            if cancelled is None and eng.steps >= 4:
                live = [s.rid for s in eng.slots
                        if s is not None and not s.done]
                got = eng.cancel((eng.pending_rids() or [max(live)])[-1])
                cancelled = got[0] if got else "gone"
                states.append(_host_state(eng))
            if todo and (eng.paged or eng.free_slots()):
                join_next()
    return states, sorted(done, key=lambda s: s.rid), cancelled


@pytest.fixture(scope="module")
def jax_runs(fms):
    """The JAX engine on each pool, greedy, under the churn script: the
    logits of every sampler call, the host states, the finished streams."""
    jfm, _, cfg = fms
    out = {}
    for name, kw in POOLS.items():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            jeng = JDecodeEngine(jfm, **ENGINE_KW, **kw)
        jcalls = []

        def jsample(logits, keys, jcalls=jcalls):
            jax.debug.callback(
                lambda l: jcalls.append(np.asarray(l, np.float32)), logits,
                ordered=True)
            return jnp.argmax(logits, axis=-1).astype(jnp.int32), keys
        jeng._sample = jsample
        out[name] = (jcalls, *_drive(jeng, _workload(cfg)), jeng)
    return out


@pytest.mark.parametrize("pool", list(POOLS))
def test_engine_teacher_forced_against_jax(fms, jax_runs, pool):
    """Logits of every live row within the bound at every sampler call and
    the host state equal to the JAX engine's after every call; every state
    slot free at the end; on the paged pool the script deferred and
    preempted (a preempted stream re-prefilled against its stored frames)
    and no page leaked."""
    _, fm, cfg = fms
    jcalls, jstates, jdone, jcancel, jeng = jax_runs[pool]
    eng = DecodeEngine(fm, **ENGINE_KW, **POOLS[pool])
    calls = []

    def teacher(logits, gens):
        want = jcalls[len(calls)]
        live = np.ones(1, bool) if logits.shape[0] == 1 else np.array(
            [s is not None and not s.done for s in eng.slots])
        calls.append((logits.float().numpy(), live))
        return torch.as_tensor(want.argmax(-1), dtype=torch.int32), gens
    eng._sample = teacher
    states, done, cancelled = _drive(eng, _workload(cfg))
    assert len(calls) == len(jcalls) and len(states) == len(jstates)
    for got, want in zip(states, jstates):
        assert got == want
    worst = max(np.abs(got[live] - want[live]).max()
                for (got, live), want in zip(calls, jcalls) if live.any())
    assert worst <= ENGINE_LOGIT_TOL, worst
    assert cancelled == jcancel and cancelled in ("slot", "pending")
    for s, js in zip(done, jdone):
        assert (s.rid, s.tokens, s.status) == (js.rid, js.tokens, js.status)
    assert len(done) + 1 == 10
    assert eng.state_pool.slots_in_use() == set()
    assert eng.state_pool.allocs == eng.state_pool.frees >= 9
    if pool == "paged":
        assert not eng.prefix_sharing and not eng.chunked_prefill
        assert eng.deferrals >= 1 and eng.preemptions >= 1
        assert eng.free_page_count() == eng.total_pages - 1
        assert not eng._page_refs.any()


def test_frame_count_is_strict_and_frameless_joins_default_to_zeros(fms):
    """``test_whisper_enc_dec_decodes_through_engine``'s checks in the
    port: the engine sizes the cross state to enc_len (default prompt_len),
    demotes prefix sharing, rejects a join with the wrong frame count
    before touching any state, and a frameless join decodes exactly like
    one given zero frames."""
    _, fm, cfg = fms
    eng = DecodeEngine(fm, num_slots=2, prompt_len=8, max_new=6, chunk=2,
                       paged=True, page_size=8)
    assert eng.enc_len == 8 and eng.state_pool is not None
    assert not eng.prefix_sharing
    assert eng.pool[0]["ck"].shape[2] == 8
    rng = np.random.RandomState(1)
    feats = (rng.randn(eng.enc_len, cfg.d_model) * 0.1).astype(np.float32)
    p = rng.randint(0, cfg.vocab_size, 5).astype(np.int32)
    with pytest.raises(ValueError, match="exactly enc_len=8 frames"):
        eng.join("t", p, max_new_tokens=2, rid=1, enc_feats=feats[:-1])
    assert eng.active_count() == 0 and eng.state_pool.allocs == 0
    eng.join("t", p, max_new_tokens=3, rid=2)
    (d0,) = eng.drain()
    eng.join("t", p, max_new_tokens=3, rid=3,
             enc_feats=np.zeros_like(feats))
    (d1,) = eng.drain()
    eng.join("t", p, max_new_tokens=3, rid=4, enc_feats=feats)
    (d2,) = eng.drain()
    assert d0.tokens == d1.tokens and len(d0.tokens) == 3
    assert d2.tokens != d0.tokens
    assert eng.state_pool.slots_in_use() == set()


# ---------------- (g) the serve loop ----------------

def test_serve_loop_serves_whisper_end_to_end(fms):
    """``FMplexServer``/``ServeLoop.run`` on reduced whisper with the paged
    pool: pooled frame requests and generative requests carrying their own
    frames (and some without) all finish ok with their token budgets; the
    stream's frames reach its tokens (the same prompt with other frames
    decodes otherwise); every state slot and page is free at the end and
    the metrics carry the state-slot gauges."""
    from repro_torch.core.request import Request
    from repro_torch.core.server import FMplexServer
    from repro_torch.core.vfm import TaskExtensions
    from repro_torch.serving.metrics import mixed_stats, page_gauges
    _, fm, cfg = fms
    srv = FMplexServer("s0")
    srv.deploy_fm("fm0", fm, scheduler="bfq")
    rng = np.random.RandomState(4)
    for i in range(2):
        w = torch.tensor(rng.randn(cfg.d_model, 3).astype(np.float32))
        srv.bind_task(f"task{i}", "fm0", extensions=TaskExtensions(
            decoder=(lambda ww: lambda f: torch.as_tensor(f).float() @ ww)(w),
            adapter_id=f"lora{i}"))
    loop = srv.serve_loop("fm0", engine_kwargs=dict(
        num_slots=2, prompt_len=8, max_new=4, chunk=2, enc_len=ENC_LEN,
        paged=True, page_size=4))
    loop.warmup(pooled_task="task0", gen_task="task1", pooled_n=2)
    eng = srv.engines["fm0"]
    prompt = rng.randint(0, cfg.vocab_size, 6).astype(np.int32)
    trace = []
    for i in range(6):
        trace.append(Request(f"task{i % 2}", 0.001 * i, payload=(
            rng.randn(8, cfg.d_model) * FRAME_SCALE).astype(np.float32)))
    gen = []
    for i in range(6):
        r = Request("task1", 0.001 * i, payload=prompt, tokens=10.0,
                    max_new_tokens=4)
        if i < 4:
            r.enc_feats = (np.random.RandomState(50 + i % 2).randn(
                ENC_LEN, cfg.d_model) * FRAME_SCALE).astype(np.float32)
        gen.append(r)
    loop.run(trace + gen)
    for r in trace + gen:
        assert r.ok and r.result is not None, (r.rid, r.status)
    assert all(np.all(np.isfinite(r.result)) for r in trace)
    assert all(len(r.result) == 4 for r in gen)
    # the same frames give the same stream; other frames another one
    assert list(gen[0].result) == list(gen[2].result)
    assert list(gen[1].result) == list(gen[3].result)
    assert list(gen[4].result) == list(gen[5].result)
    assert len({tuple(gen[i].result) for i in (0, 1, 4)}) > 1
    assert eng.state_pool.slots_in_use() == set()
    assert eng.free_page_count() == eng.total_pages - 1
    gauges = page_gauges(eng)
    assert gauges["state_slots_in_use"] == 0
    assert gauges["state_slots_peak"] == 2
    assert mixed_stats(trace + gen, engine=eng)["state_slots"] == \
        eng.state_pool.gauges()


# ---------------- (h) on a GPU only ----------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are built and run on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,S,hd,window,max_len",
                         [(8, 8, 8, 1500, 64, None, None),
                          (8, 32, 8, 161, 64, None, None),
                          (8, 8, 2, 1500, 64, 700, None),
                          (3, 32, 32, 161, 64, 48, None),
                          (8, 16, 8, 1500, 32, None, None),
                          (8, 64, 8, 1500, 128, None, None),
                          (8, 64, 8, 1500, 64, 300, None),
                          (8, 8, 8, 1500, 64, None, 383),
                          (8, 8, 4, 2048, 64, None, None)])
def test_decode_attention_kernel_on_gpu(cuda_device, B, H, KV, S, hd,
                                        window, max_len):
    """K5 against its plain version on the card, two bf16 ulps of the
    largest output (every length >= 1: no empty row), at hd 32/64/128 and
    G 1 to 8, with lengths that end inside the first of the split's splits
    (``max_len``), over 8 splits (S 2048 at 32 pairs), and the same bits
    from a second call."""
    from repro_torch.kernels import ref
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((B, H, hd), generator=gen, device=cuda_device).to(
        torch.bfloat16)
    k = torch.randn((B, S, KV, hd), generator=gen, device=cuda_device).to(
        torch.bfloat16)
    v = torch.randn((B, S, KV, hd), generator=gen, device=cuda_device).to(
        torch.bfloat16)
    ln = torch.randint(1, (max_len or S) + 1, (B,), generator=gen,
                       device=cuda_device, dtype=torch.int32)
    got = ops.decode_attention(q, k, v, ln, window=window)
    again = ops.decode_attention(q, k, v, ln, window=window)
    want = ref.decode_attention_ref(q, k.transpose(1, 2), v.transpose(1, 2),
                                    ln, window=window, p_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    tol = 2 * 2.0 ** -8 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(got, again)

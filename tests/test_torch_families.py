"""The other attention-only families in the port against the JAX package:
qwen2-7b (GQA 28/4, G 7, a qkv bias), h2o-danube-1.8b (hd 80, a sliding
window), minitron-8b (GQA 32/8) and qwen2-vl-72b (M-RoPE over stub patch
embeddings, a qkv bias), with the JAX weights carried across by
``repro_torch.weights``:

* the four configs equal to JAX's field by field at full size;
* ``apply_mrope`` against JAX's at distinct (t, h, w) streams;
* the plain versions of K3 (against the Pallas kernel in interpret mode),
  K4 and the verify window (against the JAX oracle and the ops' XLA
  paths) at the shapes these models add, (hd 128, G 7) and (hd 80, G 4, a
  window); K1, K2, K3 and K5 at these shapes are further cases of
  tests/test_torch_kernels.py, test_torch_chunked.py and
  test_torch_encdec.py;
* model parity at reduced width (forward, variable-length prefill and
  teacher-forced int8 decode; the decode-versus-forward contract of
  ``tests/test_models.py``): qwen2 at ``reduced()`` and at a G-7 cut, h2o
  at ``reduced()`` (window 64) with prompts past the window and at a
  head-dim-80 cut, minitron, qwen2-vl with ``embeds`` and non-trivial
  ``pos3``; the qkv bias and the adapters' B randomized first (both
  initialise to zeros), and a planted fault (the bias dropped) missing the
  JAX logits by far more than the bound;
* qwen2-vl's pooled forward through ``PhysicalFM`` (a decoder LM fed patch
  embeddings, vocab > 0);
* the dense int8 and paged engines (``chunked_prefill=False``) for the
  qwen2 G-7 cut and h2o (its window binding) held teacher-forced against
  the JAX engines under churn, the host state equal after every call;
* a chunked tail admission on a windowed model raises in both packages.

Tolerances. The plain kernels compute the JAX oracles' f32 products in
another order: 1e-5. The models
are two bf16 models that round in different places (test_torch_models.py):
the bound is the bf16 noise floor over the whole tensor (relative L2) plus
a per-element ceiling a wrong op would break, stablelm's: hidden (2e-2,
0.3), logits (4e-2, 0.25). The query and key projections are drawn at the
model's real fan-in (``_fan_in_and_bias``): at the package's init the G-7 cut's
keys come out 8x too large, attention goes near one-hot and one bf16 ulp
flips which key a query attends, which put both bf16 models 0.04-0.14 rel
L2 from each other and as far from an f32 run. Measured (rel L2, max):
hidden up to 0.0071 and 0.039, the logits of prefill and six decode steps
(stacked) up to 0.0078 and 0.055, the engines' logits (every live row of
every sampler call, stacked, held to the logit bound) up to 0.0085 and
0.051. The planted fault, the qkv bias dropped, misses the JAX logits by
0.29-0.41 rel L2, over FAULT_MARGIN (4) times the bound. Host state is
exact.
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402
import warnings  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core.decode_engine import DecodeEngine as JDecodeEngine  # noqa: E402
from repro.core.physical import PhysicalFM as JPhysicalFM  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention_int8 import \
    decode_attention_int8 as jpallas_k3  # noqa: E402
from repro.kernels.segmented_lora import segment_metadata as jsegment_metadata  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.decode_engine import DecodeEngine  # noqa: E402
from repro_torch.core.physical import PhysicalFM  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.segmented_lora import padded_tokens, segment_metadata  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402

FAMILIES = ("qwen2-7b", "h2o-danube-1.8b", "minitron-8b", "qwen2-vl-72b")
KERNEL_TOL = 1e-5
HIDDEN_TOL = (2e-2, 0.3)      # (relative L2, max abs), as test_torch_models
LOGIT_TOL = (4e-2, 0.25)
ENGINE_TOL = LOGIT_TOL        # every live row of every sampler call
FAULT_MARGIN = 4
LORA_SCALE = 0.2
BIAS_SCALE = 0.5
BT = 8
NA = 4                        # adapter stack: 3 adapters and a zero pad slot


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


def _close(got, want, tol):
    got, want = _f32(got), _f32(want)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    worst = np.abs(got - want).max()
    assert rel <= tol[0] and worst <= tol[1], (rel, worst)
    return rel, worst


# ---------------- configs ----------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_config_equals_jax(arch):
    """Every field, the parameter count and the reduced cut."""
    got, want = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert dataclasses.asdict(reduced(got)) == dataclasses.asdict(
        jreduced(want))


# ---------------- M-RoPE ----------------

@pytest.mark.parametrize("hd,sections", [(128, (16, 24, 24)), (16, (4, 6, 6)),
                                         (16, (1, 1, 1))])
def test_apply_mrope_matches_jax(hd, sections):
    """Distinct t, h and w streams; sections that fill hd / 2 (qwen2-vl's),
    overrun it (the reduced config's) and fall short of it (padded with the
    last stream). f32 on both sides; equal to RoPE where t = h = w."""
    rng = np.random.RandomState(hd + sum(sections))
    x = rng.randn(2, 7, 3, hd).astype(np.float32)
    pos3 = rng.randint(0, 50, (2, 7, 3)).astype(np.int32)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), sections,
                               1e4)
    got = layers.apply_mrope(torch.tensor(x), torch.tensor(pos3), sections,
                             1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    text = np.repeat(pos3[..., :1], 3, axis=-1)
    np.testing.assert_allclose(
        layers.apply_mrope(torch.tensor(x), torch.tensor(text), sections,
                           1e4).numpy(),
        layers.apply_rope(torch.tensor(x), torch.tensor(text[..., 0]),
                          1e4).numpy(), atol=1e-6, rtol=1e-6)


# ---------------- the plain kernels at the new (hd, G) ----------------

# (H, KV, hd, window): qwen2-7b's group of 7 at hd 128, h2o-danube's hd 80
# with its group of 4 under a window
SHAPES = {"qwen2_g7": (28, 4, 128, None), "h2o_hd80": (32, 8, 80, 48)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_int8_decode_plain_matches_pallas_interpret(shape):
    """K3's plain version against the Pallas K3 in interpret mode, as
    tests/test_kernels.py runs it (f32 on both sides: 1e-5; the JAX
    oracle and XLA path at these shapes: tests/test_torch_kernels.py)."""
    H, KV, hd, window = SHAPES[shape]
    B, S = 3, 128
    rng = np.random.RandomState(hd)
    q = rng.randn(B, H, hd).astype(np.float32)
    k, v = (rng.randn(B, KV, S, hd).astype(np.float32) for _ in range(2))
    lens = np.array([S, 1, 77], np.int32)
    kq, vq, ks, vs = (np.asarray(t) for t in jops.quantize_kv(
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3))))
    kh, vh = kq.transpose(0, 2, 1, 3), vq.transpose(0, 2, 1, 3)
    got = ref.decode_attention_int8_ref(*map(torch.tensor, (
        q, kh, vh, ks, vs, lens)), window=window)
    pallas = jpallas_k3(*map(jnp.asarray, (q, kh, vh, ks, vs, lens)),
                        window=window, block_s=64, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


def _arena(rng, B, KV, hd, ps, MP, lens):
    """Random int8 pages (stale codes everywhere), per-page scales and a
    table of distinct pages per stream, rows 0 and 2 sharing a page."""
    P = 1 + B * MP
    kp, vp = (rng.randint(-127, 128, (P, ps, KV, hd)).astype(np.int8)
              for _ in range(2))
    ks, vs = ((rng.rand(P, KV) * 0.05 + 1e-3).astype(np.float32)
              for _ in range(2))
    pt = np.zeros((B, MP), np.int32)
    free = list(range(1, P))
    rng.shuffle(free)
    for b, n in enumerate(lens):
        for j in range(min(MP, -(-int(n) // ps))):
            pt[b, j] = free.pop()
    pt[2, 0] = pt[0, 0]
    return kp, vp, ks, vs, pt


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_paged_and_verify_plain_match_jax(shape):
    """K4's and the verify window's plain versions (model layout) against
    the JAX ops' XLA paths, and K4's against the JAX oracle on the
    head-major arena (f32: 1e-5)."""
    H, KV, hd, window = SHAPES[shape]
    B, ps, MP, T = 3, 8, 12, 5
    rng = np.random.RandomState(hd + 1)
    lens = np.array([96, 1, 60], np.int32)
    kp, vp, ks, vs, pt = _arena(rng, B, KV, hd, ps, MP, lens + T)
    q = rng.randn(B, H, hd).astype(np.float32)
    want = jops.paged_decode_attention(*map(jnp.asarray, (
        q, kp, vp, ks, vs, pt, lens)), window=window, backend="xla")
    got = ops.paged_decode_attention(*map(torch.tensor, (
        q, kp, vp, ks, vs, pt, lens)), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)
    kh, vh = (np.ascontiguousarray(a.transpose(0, 2, 1, 3)) for a in (kp, vp))
    want_h = jref.paged_decode_attention_ref(*map(jnp.asarray, (
        q, kh, vh, ks, vs, pt, lens)), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_h),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)
    qt = rng.randn(B, T, H, hd).astype(np.float32)
    want_v = jops.paged_verify_attention(*map(jnp.asarray, (
        qt, kp, vp, ks, vs, pt, lens)), window=window, backend="xla")
    got_v = ops.paged_verify_attention(*map(torch.tensor, (
        qt, kp, vp, ks, vs, pt, lens)), window=window)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


# ---------------- the models against JAX ----------------

CUTS = {
    "qwen2": ("qwen2-7b", {}),
    "qwen2_g7": ("qwen2-7b", dict(num_heads=7, num_kv_heads=1,
                                  head_dim=16)),
    "h2o": ("h2o-danube-1.8b", {}),
    "h2o_hd80": ("h2o-danube-1.8b", dict(num_heads=4, num_kv_heads=1,
                                         head_dim=80)),
    "minitron": ("minitron-8b", {}),
    "qwen2_vl": ("qwen2-vl-72b", {}),
}


def _fan_in_and_bias(np_params, rng, cfg):
    """The query and key projections at the model's real fan-in, and the
    qkv bias leaves (they initialise to zeros) drawn at BIAS_SCALE, in
    place. The packages' init takes the heads axis of a (d, heads, hd)
    projection as its fan-in: at the G-7 cut's one kv head the keys come
    out sqrt(64)x too large and attention near one-hot, where one bf16 ulp
    flips which key a query attends (as chip_smoke.fan_in_qk says for
    whisper); scaled by sqrt(heads / d) they are drawn at 1/sqrt(d)."""
    for sub in np_params["layers"]:
        for name, heads in (("wq", cfg.num_heads), ("wk", cfg.num_kv_heads)):
            sub["attn"][name] = sub["attn"][name] * np.float32(
                (heads / cfg.d_model) ** 0.5)
        for name in ("bq", "bk", "bv"):
            if name in sub["attn"]:
                t = sub["attn"][name]
                sub["attn"][name] = (rng.randn(*t.shape) * BIAS_SCALE
                                     ).astype(t.dtype)
    return np_params


def _randomized(jcfg, seed):
    """JAX weights with a random qkv bias, and a LoRA stack of NA slots
    with random A and B at LORA_SCALE (the last slot zero: the base
    model), as numpy trees."""
    rng = np.random.RandomState(seed + 1)
    np_params = _fan_in_and_bias(jax.tree.map(np.asarray, jlm.init_model(
        jax.random.PRNGKey(seed), jcfg)), rng, jcfg)
    nper, d, r = jcfg.num_layers, jcfg.d_model, 4
    outs = {"q": jcfg.num_heads * jcfg.head_dim,
            "v": jcfg.num_kv_heads * jcfg.head_dim}
    np_lora = [{p: {"a": (rng.randn(nper, NA, d, r) * LORA_SCALE)
                    .astype(np.float32),
                    "b": (rng.randn(nper, NA, r, outs[p]) * LORA_SCALE)
                    .astype(np.float32)} for p in ("q", "v")}]
    for p in ("q", "v"):
        np_lora[0][p]["b"][:, NA - 1] = 0.0
    return np_params, np_lora


@pytest.fixture(scope="module", params=sorted(CUTS))
def model(request):
    arch, over = CUTS[request.param]
    jcfg, cfg = jreduced(jget_config(arch), **over), \
        reduced(get_config(arch), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    np_params, np_lora = _randomized(jcfg, seed=len(request.param))
    return dict(name=request.param, jcfg=jcfg, cfg=cfg, np_params=np_params,
                jparams=jax.tree.map(jnp.asarray, np_params),
                params=weights.model_params(np_params, device="cpu"),
                jlora=jax.tree.map(jnp.asarray, np_lora),
                lora=weights.adapter_tree(np_lora, device="cpu"))


def _segs(aidx, seq_len):
    ids = np.repeat(np.asarray(aidx, np.int32), seq_len)
    tp = padded_tokens(len(ids), min(len(aidx), NA + 2), BT)
    perm, inv, blocks = segment_metadata(ids, NA, BT, tp)
    jp, ji, jb = jsegment_metadata(ids, NA, BT, tp)
    return ({"perm": jnp.asarray(jp), "inv": jnp.asarray(ji),
             "block_adapter": jnp.asarray(jb), "block_t": BT},
            {"perm": torch.tensor(perm, dtype=torch.long),
             "inv": torch.tensor(inv, dtype=torch.long),
             "block_adapter": torch.tensor(blocks), "block_t": BT})


def _inputs(m, rng, B, S):
    """Token prompts, or for qwen2-vl patch embeddings with M-RoPE streams
    (t the patch's frame, h and w its place on a 4 x 5 grid): the JAX and
    the port's keyword arguments."""
    cfg = m["cfg"]
    if cfg.mrope_sections is None:
        toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
        return dict(tokens=jnp.asarray(toks)), \
            dict(tokens=torch.tensor(toks).long())
    emb = (rng.randn(B, S, cfg.d_model) * 0.5).astype(np.float32)
    s = np.arange(S)
    pos3 = np.stack([s // 20, (s % 20) // 5, s % 5], -1)[None].repeat(B, 0)
    pos3 = (pos3 + rng.randint(0, 3, (B, 1, 3))).astype(np.int32)
    return dict(embeds=jnp.asarray(emb), pos3=jnp.asarray(pos3)), \
        dict(embeds=torch.tensor(emb), pos3=torch.tensor(pos3))


def test_forward_matches_jax(model):
    """Hidden states of a forward (gather LoRA; qwen2-vl from patch
    embeddings with distinct t/h/w streams), and the h2o cuts with more
    positions than their window."""
    rng = np.random.RandomState(0)
    B, S = 3, 80 if model["cfg"].sliding_window else 12
    jkw, kw = _inputs(model, rng, B, S)
    aidx = np.array([0, NA - 1, 2], np.int32)
    jh, _, _ = jlm.forward(model["jparams"], model["jcfg"], lora=model["jlora"],
                           adapter_idx=jnp.asarray(aidx), **jkw)
    h, _ = lm.forward(model["params"], model["cfg"], lora=model["lora"],
                      adapter_idx=torch.tensor(aidx), **kw)
    assert h.dtype == torch.bfloat16 and tuple(h.shape) == (
        B, S, model["cfg"].d_model)
    _close(h, jh, HIDDEN_TOL)


def _prefill_decode(m, params, lens, steps, seed=1, jax_side=True):
    """Variable-length prefill (segmented LoRA, mixed adapters and a base
    row) into a dense int8 cache, then ``steps`` teacher-forced decode
    steps: the logits of every call (JAX's when ``jax_side``)."""
    cfg = m["jcfg"] if jax_side else m["cfg"]
    rng = np.random.RandomState(seed)
    B, S = len(lens), max(lens)
    jkw, kw = _inputs(m, rng, B, S)
    toks = rng.randint(0, cfg.vocab_size, (B, steps)).astype(np.int32)
    aidx = np.array([1, NA - 1, 0, 2][:B], np.int32)
    jseg_p, seg_p = _segs(aidx, S)
    jseg_d, seg_d = _segs(aidx, 1)
    s_max = S + steps + 1
    out = []
    if jax_side:
        c = jlm.init_cache(cfg, B, s_max, kv_quant=True)
        log, c = jlm.prefill(params, cfg, cache=c, lora=m["jlora"],
                             adapter_idx=jnp.asarray(aidx),
                             lora_impl="segmented", lora_seg=jseg_p,
                             seq_lens=jnp.asarray(lens), **jkw)
        out.append(np.asarray(log))
        for t in range(steps):
            log, c = jlm.decode_step(params, cfg, tokens=jnp.asarray(toks[:, t]),
                                     cache=c, lora=m["jlora"],
                                     adapter_idx=jnp.asarray(aidx),
                                     lora_impl="segmented", lora_seg=jseg_d)
            out.append(np.asarray(log))
        return out, np.asarray(c[0]["len"])
    c = lm.init_cache(cfg, B, s_max, kv_quant=True, device="cpu")
    log, c = lm.prefill(params, cfg, cache=c, lora=m["lora"],
                        adapter_idx=torch.tensor(aidx), lora_impl="segmented",
                        lora_seg=seg_p, seq_lens=torch.tensor(lens), **kw)
    out.append(log)
    for t in range(steps):
        log, c = lm.decode_step(params, cfg, tokens=torch.tensor(toks[:, t]).long(),
                                cache=c, lora=m["lora"],
                                adapter_idx=torch.tensor(aidx),
                                lora_impl="segmented", lora_seg=seg_d)
        assert lm.finite_logits(log).all()
        out.append(log)
    return out, c[0]["len"].numpy()


def _lens(m):
    """Prompt lengths: past the window (64) for the h2o cuts."""
    return [80, 70, 65, 9] if m["cfg"].sliding_window else [8, 3, 5, 1]


def test_prefill_and_int8_decode_match_jax(model):
    """Right-padded prompts of different true lengths (the h2o cuts' past
    their window, so K2's and K3's window masks bind), mixed adapters and a
    base row: the prefill logits, then teacher-forced decode steps on the
    dense int8 pool (qwen2-vl's prompt is patch embeddings with M-RoPE
    streams, its decode text positions, t = h = w)."""
    lens = np.array(_lens(model), np.int32)
    want, jlen = _prefill_decode(model, model["jparams"], lens, 6)
    got, glen = _prefill_decode(model, model["params"], lens, 6,
                                jax_side=False)
    _close(np.stack([_f32(g) for g in got]), np.stack(want), LOGIT_TOL)
    np.testing.assert_array_equal(glen, jlen)


def test_bounds_see_the_qkv_bias(model):
    """The qkv bias reaches the logits: the port with the bias leaves
    zeroed (the init's value) misses the JAX prefill logits by at least
    FAULT_MARGIN times the bound. Configs without a bias have nothing to
    drop."""
    if not model["cfg"].qkv_bias:
        assert "bq" not in model["params"]["layers"][0]["attn"]
        return
    zeroed = {**model["params"], "layers": [
        {**sub, "attn": {k: torch.zeros_like(v) if k in ("bq", "bk", "bv")
                         else v for k, v in sub["attn"].items()}}
        for sub in model["params"]["layers"]]}
    lens = np.array(_lens(model), np.int32)
    want, _ = _prefill_decode(model, model["jparams"], lens, 0)
    got, _ = _prefill_decode(model, zeroed, lens, 0, jax_side=False)
    g, w = _f32(got[0]), _f32(want[0])
    rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    assert rel > FAULT_MARGIN * LOGIT_TOL[0], rel


def test_pooled_forward_of_a_vision_backbone_matches_jax():
    """qwen2-vl's pooled forward through ``PhysicalFM.run_batch``: patch
    embeddings into a decoder LM with a vocabulary (its head unused),
    plain RoPE at the patch index as the JAX package runs it, per-request
    adapters, mean-pooled."""
    jcfg = jreduced(jget_config("qwen2-vl-72b"))
    cfg = reduced(get_config("qwen2-vl-72b"))
    jfm = JPhysicalFM(jcfg, seed=0, input_len=8, lora_rank=4,
                      lora_impl="gather")
    fm = PhysicalFM(cfg, seed=0, input_len=8, lora_rank=4, lora_impl="gather",
                    device="cpu", params=weights.to_torch(
                        jax.tree.map(np.asarray, jfm.params), device="cpu"))
    for i in range(2):
        tree = jax.tree.map(
            lambda t, i=i: np.random.RandomState(i).randn(*t.shape).astype(
                np.float32) * LORA_SCALE,
            jax.tree.map(np.asarray, jfm.adapters._mod.init_single_adapter(
                jax.random.PRNGKey(i), jcfg, 4)))
        jfm.adapters.add(f"a{i}", jax.tree.map(jnp.asarray, tree))
        fm.adapters.add(f"a{i}", weights.adapter_tree(tree, device="cpu"))
    x = np.random.RandomState(3).randn(5, 8, cfg.d_model).astype(np.float32)
    aidx = np.array([0, 1, 2, 0, 1], np.int32)        # 2: no adapter
    want = jfm.run_batch(x, aidx)
    got = fm.run_batch(x, aidx)
    assert got.shape == (5, cfg.d_model) and np.isfinite(got).all()
    _close(got, want, HIDDEN_TOL)


def test_chunked_tail_admission_with_a_window_raises_in_both():
    """A chunked tail admission attends a prefix; a sliding window over a
    prefix is refused by both packages' prefill attention (JAX asserts,
    the port raises), so a windowed model runs the paged pool with
    ``chunked_prefill=False``."""
    q = np.zeros((1, 4, 2, 16), np.float32)
    pre = np.zeros((1, 8, 2, 16), np.float32)
    with pytest.raises(AssertionError):
        jattn.flash_attention(*(jnp.asarray(q),) * 3, window=4,
                              prefix_k=jnp.asarray(pre),
                              prefix_v=jnp.asarray(pre),
                              prefix_len=jnp.asarray([8]))
    with pytest.raises(ValueError, match="window over a prefix"):
        ops.flash_attention(*(torch.tensor(q),) * 3, window=4,
                            prefix_k=torch.tensor(pre),
                            prefix_v=torch.tensor(pre),
                            prefix_len=torch.tensor([8]))


# ---------------- the engines, teacher-forced against JAX ----------------

ENGINE_CUTS = {"qwen2_g7": CUTS["qwen2_g7"], "h2o": CUTS["h2o"]}
POOLS = {
    "dense": dict(num_slots=3, prompt_len=96, prompt_buckets=(32, 96),
                  max_new=10, chunk=2),
    "paged": dict(num_slots=3, prompt_len=96, prompt_buckets=(32, 96),
                  max_new=10, chunk=2, paged=True, page_size=8,
                  total_pages=30, chunked_prefill=False),
}


@pytest.fixture(scope="module", params=sorted(ENGINE_CUTS))
def engine_fms(request):
    """Both packages' FMs of a cut (JAX weights, bias randomized) with
    three randomized adapters."""
    arch, over = ENGINE_CUTS[request.param]
    jcfg, cfg = jreduced(jget_config(arch), **over), \
        reduced(get_config(arch), **over)
    jfm = JPhysicalFM(jcfg, seed=0, input_len=8, lora_rank=4,
                      lora_impl="segmented", seg_block_t=BT)
    np_params = _fan_in_and_bias(jax.tree.map(np.asarray, jfm.params),
                           np.random.RandomState(5), jcfg)
    jfm.params = jax.tree.map(jnp.asarray, np_params)
    fm = PhysicalFM(cfg, seed=0, input_len=8, lora_rank=4,
                    lora_impl="segmented", seg_block_t=BT, device="cpu",
                    params=weights.to_torch(np_params, device="cpu"))
    for i in range(3):
        tree = jax.tree.map(
            lambda t, i=i: np.random.RandomState(50 + i).randn(*t.shape)
            .astype(np.float32) * 0.15,
            jax.tree.map(np.asarray, jfm.adapters._mod.init_single_adapter(
                jax.random.PRNGKey(i), jcfg, 4)))
        jfm.adapters.add(f"lora{i}", jax.tree.map(jnp.asarray, tree))
        fm.adapters.add(f"lora{i}", weights.adapter_tree(tree, device="cpu"))
    return request.param, jfm, fm, cfg


def _workload(cfg, seed=11):
    """Prompts of 9-90 tokens (past the h2o cut's window of 64), a
    16-token prefix shared by three of them on lora0 (two admitted
    together), the other adapters and the base model."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(0, cfg.vocab_size, 16).astype(np.int32)
    jobs = []
    for i, n in enumerate((90, 40, 70, 33, 85, 20, 66, 9)):
        if i in (0, 1, 5):
            prompt = np.concatenate([prefix, rng.randint(
                0, cfg.vocab_size, n - 16).astype(np.int32)])
            name = "lora0"
        else:
            prompt = rng.randint(0, cfg.vocab_size, n).astype(np.int32)
            name = ("lora1", None, "lora2")[i % 3]
        jobs.append((prompt, name, int(rng.randint(3, 11))))
    return jobs


def _host_state(eng):
    st = {"slots": [None if s is None else (s.rid, list(s.tokens), s.done)
                    for s in eng.slots],
          "pending": eng.pending_rids(),
          "counters": [getattr(eng, n, None) for n in (
              "deferrals", "preemptions", "admissions", "steps")]}
    if eng.paged:
        st.update(ptab=np.asarray(eng._ptab).tolist(),
                  refs=np.asarray(eng._page_refs).tolist(),
                  free=list(eng._free_pages), lens=np.asarray(
                      eng._lens).tolist(),
                  registry=dict(eng._prefix_registry),
                  hits=eng.prefix_hits)
    return st


def _drive(eng, jobs):
    """Four joins, then a join every other chunk until every stream has
    retired; the host state after every call."""
    states, done = [], []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for i in range(4):
            p, name, n = jobs[i]
            eng.join(f"t{i}", p, adapter_id=name, max_new_tokens=n, rid=i)
            states.append(_host_state(eng))
        nxt = 4
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


@pytest.mark.parametrize("pool", sorted(POOLS))
def test_engine_teacher_forced_against_jax(engine_fms, pool):
    """The port's engine fed the JAX engine's greedy tokens: every live
    row's logits within the bound at every sampler call, the host state
    (slots, tokens, pending queue, counters; the paged pool's tables,
    refcounts, free list, lengths and prefix registry) equal after every
    call, every stream finished with its budget."""
    name, jfm, fm, cfg = engine_fms
    kw = POOLS[pool]
    jeng = JDecodeEngine(jfm, **kw)
    jcalls = []

    def jsample(logits, keys):
        jax.debug.callback(lambda l: jcalls.append(np.asarray(l, np.float32)),
                           logits, ordered=True)
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), keys
    jeng._sample = jsample
    jstates, jdone = _drive(jeng, _workload(cfg))
    eng = DecodeEngine(fm, **kw)
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
    _close(np.concatenate([got[live] for got, live in calls]),
           np.concatenate([want[live] for (_, live), want
                           in zip(calls, jcalls)]), ENGINE_TOL)
    assert [(s.rid, s.tokens, s.status) for s in done] == \
        [(s.rid, s.tokens, s.status) for s in jdone]
    assert len(done) == 8 and all(len(s.tokens) == s.max_new for s in done)
    if pool == "paged":
        assert eng.prefix_hits >= 1
        assert eng.free_page_count() == eng.total_pages - 1

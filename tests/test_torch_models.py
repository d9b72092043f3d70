"""The port's model (``repro_torch.models.lm``) against the JAX package's on
reduced stablelm-1.6b (2 layers, d 64, hd 16): the same weights (JAX's,
converted by ``repro_torch.weights``), the same numpy inputs, both LoRA
impls, through ``forward``, variable-length ``prefill`` and teacher-forced
``decode_step`` on the dense int8 pool.

Tolerance: both sides keep activations in bf16 and round after every op
(XLA and PyTorch sum and fuse differently, so a value can land one bf16 ulp,
2^-8 relative, apart), and an ulp of K/V can move one int8 code. The two
bf16 models differ by about as much as EITHER differs from an f32 run of the
same weights, so the bound is the bf16 noise floor, taken over the whole
tensor (relative L2 error) plus a per-element ceiling that a wrong op, O(1),
would break. The LoRA stack is random at a scale (0.2) where each adapter
moves the logits by far more than that: dropping the deltas, swapping two
adapters or skipping the inverse permutation misses the JAX logits by
rel-L2 >= 0.54 and max >= 2.4, over 13x and 9x the logit bound
(``test_parity_bounds_catch_lora_faults`` holds a 4x margin).

  quantity                          measured (rel-L2, max)   bound
  hidden states (|h| up to 3.5)     1.4e-2, 0.098            2e-2, 0.3
  f32 logits (|logit| up to 3.6),   3.2e-2, 0.16             4e-2, 0.25
  prefill + 6 int8 decode steps"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.kernels.segmented_lora import segment_metadata as jsegment_metadata  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.segmented_lora import padded_tokens, segment_metadata  # noqa: E402
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
LOGIT_TOL = (4e-2, 0.25)
FAULT_MARGIN = 4
LORA_SCALE = 0.2
BT = 8
NA = 4          # adapter stack (3 adapters + a zero pad slot); NA == base


@pytest.fixture(scope="module")
def setup():
    jcfg = jreduced(jget_config("stablelm-1.6b"))
    cfg = reduced(get_config("stablelm-1.6b"))
    assert (cfg.num_layers, cfg.d_model, cfg.head_dim) == \
        (jcfg.num_layers, jcfg.d_model, jcfg.head_dim)
    jparams = jlm.init_model(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    params = weights.model_params(np_params, device="cpu")
    # a randomized LoRA stack (B != 0) at LORA_SCALE, so each adapter moves
    # the model far outside the bounds (test_parity_bounds_catch_lora_faults)
    rng = np.random.RandomState(5)
    nper, d, r = cfg.num_layers, cfg.d_model, 4
    out = cfg.num_heads * cfg.head_dim
    np_lora = [{p: {"a": (rng.randn(nper, NA, d, r) * LORA_SCALE)
                    .astype(np.float32),
                    "b": (rng.randn(nper, NA, r, out) * LORA_SCALE)
                    .astype(np.float32)}
                for p in ("q", "v")}]
    for p in ("q", "v"):
        np_lora[0][p]["b"][:, NA - 1] = 0.0          # the zero pad slot
    jlora = jax.tree.map(jnp.asarray, np_lora)
    lora = weights.adapter_tree(np_lora, device="cpu")
    return jcfg, cfg, jparams, params, jlora, lora


def _segs(aidx, seq_len):
    """Both packages' segment metadata for one co-batch."""
    ids = np.repeat(np.asarray(aidx, np.int32), seq_len)
    tp = padded_tokens(len(ids), min(len(aidx), NA + 2), BT)
    perm, inv, blocks = segment_metadata(ids, NA, BT, tp)
    jp, ji, jb = jsegment_metadata(ids, NA, BT, tp)
    jseg = {"perm": jnp.asarray(jp), "inv": jnp.asarray(ji),
            "block_adapter": jnp.asarray(jb), "block_t": BT}
    seg = {"perm": torch.tensor(perm, dtype=torch.long),
           "inv": torch.tensor(inv, dtype=torch.long),
           "block_adapter": torch.tensor(blocks), "block_t": BT}
    return jseg, seg


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def assert_bf16_close(got, want, tol):
    """Relative L2 error and largest element difference within ``tol``."""
    got, want = _f32(got), _f32(want)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    worst = np.abs(got - want).max()
    assert rel <= tol[0] and worst <= tol[1], (rel, worst)


@pytest.mark.parametrize("impl", ["gather", "segmented"])
def test_forward_matches_jax(setup, impl):
    jcfg, cfg, jparams, params, jlora, lora = setup
    rng = np.random.RandomState(0)
    B, S = 3, 12
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    aidx = np.array([0, NA, 2], np.int32)
    jseg, seg = _segs(aidx, S) if impl == "segmented" else (None, None)
    jh, _, _ = jlm.forward(jparams, jcfg, tokens=jnp.asarray(toks), lora=jlora,
                           adapter_idx=jnp.asarray(aidx), lora_impl=impl,
                           lora_seg=jseg)
    h, _ = lm.forward(params, cfg, tokens=torch.tensor(toks).long(), lora=lora,
                      adapter_idx=torch.tensor(aidx), lora_impl=impl,
                      lora_seg=seg)
    assert h.dtype == torch.bfloat16 and tuple(h.shape) == (B, S, cfg.d_model)
    assert_bf16_close(h, jh, HIDDEN_TOL)


@pytest.mark.parametrize("impl", ["gather", "segmented"])
def test_prefill_varlen_and_int8_decode_match_jax(setup, impl):
    """Right-padded prompts of different true lengths, mixed adapters and a
    base-model row: prefill logits (from each row's last real token), the
    int8 cache it writes, then teacher-forced decode steps."""
    jcfg, cfg, jparams, params, jlora, lora = setup
    rng = np.random.RandomState(1)
    B, S, steps = 4, 8, 6
    toks = rng.randint(0, cfg.vocab_size, (B, S + steps)).astype(np.int32)
    lens = np.array([8, 3, 5, 1], np.int32)
    aidx = np.array([1, NA, 0, 2], np.int32)
    s_max = S + steps + 1
    jseg_p, seg_p = _segs(aidx, S) if impl == "segmented" else (None, None)
    jseg_d, seg_d = _segs(aidx, 1) if impl == "segmented" else (None, None)
    jc = jlm.init_cache(jcfg, B, s_max, kv_quant=True)
    jlog, jc = jlm.prefill(jparams, jcfg, tokens=jnp.asarray(toks[:, :S]),
                           cache=jc, lora=jlora, adapter_idx=jnp.asarray(aidx),
                           lora_impl=impl, lora_seg=jseg_p,
                           seq_lens=jnp.asarray(lens))
    c = lm.init_cache(cfg, B, s_max, kv_quant=True, device="cpu")
    log, c = lm.prefill(params, cfg, tokens=torch.tensor(toks[:, :S]).long(),
                        cache=c, lora=lora, adapter_idx=torch.tensor(aidx),
                        lora_impl=impl, lora_seg=seg_p,
                        seq_lens=torch.tensor(lens))
    assert_bf16_close(log, jlog, LOGIT_TOL)
    # the cache: same lengths. The first layer's K/V come from the embedding
    # through one norm and projection, which both sides round alike: its
    # scales agree to f32 roundoff (measured 1e-7) and its int8 codes are
    # equal. Deeper layers carry the drift of the hidden states before them:
    # their scales (max |K| per row, linear in those states) are held to the
    # hidden states' relative bound (measured 1.2e-2), and a code moves by
    # 127 x (K's drift + the scale's) plus one rounding step: at most 4
    # codes and under a tenth of them (measured 3 and 6%)
    np.testing.assert_array_equal(c[0]["len"].numpy(), np.asarray(jc[0]["len"]))
    for name in ("k_scale", "v_scale"):
        got_s, want_s = c[0][name].numpy(), np.asarray(jc[0][name])
        np.testing.assert_allclose(got_s[0], want_s[0], rtol=1e-6)
        np.testing.assert_allclose(got_s[1:], want_s[1:], rtol=HIDDEN_TOL[0])
    for name in ("k", "v"):
        dq = np.abs(c[0][name].numpy().astype(int)
                    - np.asarray(jc[0][name]).astype(int))
        assert dq[0].max() == 0, dq[0].max()
        assert dq[1:].max() <= 4 and (dq[1:] > 0).mean() < 0.1, \
            (dq[1:].max(), (dq[1:] > 0).mean())
    for t in range(steps):
        tok = toks[np.arange(B), np.minimum(lens + t, S + steps - 1)]
        jlog, jc = jlm.decode_step(jparams, jcfg, tokens=jnp.asarray(tok),
                                   cache=jc, lora=jlora,
                                   adapter_idx=jnp.asarray(aidx),
                                   lora_impl=impl, lora_seg=jseg_d)
        log, c = lm.decode_step(params, cfg, tokens=torch.tensor(tok).long(),
                                cache=c, lora=lora,
                                adapter_idx=torch.tensor(aidx),
                                lora_impl=impl, lora_seg=seg_d)
        assert_bf16_close(log, jlog, LOGIT_TOL)
        assert lm.finite_logits(log).all()
    np.testing.assert_array_equal(c[0]["len"].numpy(), np.asarray(jc[0]["len"]))


def _faulty_seg(fault, aidx, seq_len):
    """Segment metadata for ``aidx`` with one planted routing fault."""
    _, seg = _segs(aidx, seq_len)
    if fault == "swapped":             # adapters 0 and 2 trade places
        swap = np.where(aidx == 0, 2, np.where(aidx == 2, 0, aidx))
        _, seg = _segs(swap.astype(np.int32), seq_len)
    elif fault == "unsorted":          # deltas left in adapter-sorted order
        seg = dict(seg, inv=torch.arange(len(seg["inv"])))
    return seg


@pytest.mark.parametrize("fault", ["dropped", "swapped", "unsorted"])
def test_parity_bounds_catch_lora_faults(setup, fault):
    """The bounds above see the LoRA: the port with a planted routing fault
    (no deltas; two adapters swapped; the inverse permutation skipped) misses
    the JAX prefill logits by at least FAULT_MARGIN times the bound."""
    jcfg, cfg, jparams, params, jlora, lora = setup
    rng = np.random.RandomState(1)
    B, S = 4, 8
    toks = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    aidx = np.array([1, NA, 0, 2], np.int32)
    jseg, _ = _segs(aidx, S)
    jlog, _ = jlm.prefill(jparams, jcfg, tokens=jnp.asarray(toks),
                          cache=jlm.init_cache(jcfg, B, S + 1, kv_quant=True),
                          lora=jlora, adapter_idx=jnp.asarray(aidx),
                          lora_impl="segmented", lora_seg=jseg)
    log, _ = lm.prefill(params, cfg, tokens=torch.tensor(toks).long(),
                        cache=lm.init_cache(cfg, B, S + 1, kv_quant=True,
                                            device="cpu"),
                        lora=None if fault == "dropped" else lora,
                        adapter_idx=torch.tensor(aidx), lora_impl="segmented",
                        lora_seg=_faulty_seg(fault, aidx, S))
    got, want = _f32(log), _f32(jlog)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    worst = np.abs(got - want).max()
    assert rel > FAULT_MARGIN * LOGIT_TOL[0] and \
        worst > FAULT_MARGIN * LOGIT_TOL[1], (rel, worst)


def test_segmented_matches_gather_in_the_port(setup):
    """Within the port the two LoRA impls agree to f32 roundoff before the
    bf16 cast: the same deltas, summed in another order."""
    _, cfg, _, params, _, lora = setup
    rng = np.random.RandomState(2)
    B, S = 5, 8
    toks = torch.tensor(rng.randint(0, cfg.vocab_size, (B, S))).long()
    aidx = np.array([0, 2, NA, 1, 0], np.int32)
    _, seg = _segs(aidx, S)
    outs = [lm.forward(params, cfg, tokens=toks, lora=lora,
                       adapter_idx=torch.tensor(aidx), lora_impl=impl,
                       lora_seg=seg if impl == "segmented" else None)[0]
            for impl in ("gather", "segmented")]
    assert_bf16_close(outs[1], outs[0], HIDDEN_TOL)


def test_unported_paths_raise():
    cfg = reduced(get_config("stablelm-1.6b"))
    import dataclasses
    # encoder-decoder stacks are ported: their cache carries the per-slot
    # cross K/V beside the paged arena (tests/test_torch_encdec.py)
    encdec = dataclasses.replace(cfg, is_encoder_decoder=True)
    spec = lm.cache_spec(encdec, 2, 8, kv_quant=True, paged=True,
                         num_pages=4, enc_len=5)
    assert spec[0]["ck"].shape == (cfg.num_layers, 2, 5, cfg.num_kv_heads,
                                   cfg.head_dim)
    # MoE and Mamba stacks are ported (tests/test_torch_moe.py,
    # test_torch_recurrent.py, test_torch_hybrid.py): a MoE stack's paged
    # cache is attention's, a hybrid's carries the Mamba state per slot
    moe = dataclasses.replace(cfg, num_experts=4, experts_per_token=2)
    spec = lm.cache_spec(moe, 2, 8, kv_quant=True, paged=True, num_pages=4)
    assert "page_table" in spec[0]
    assert "router" in lm.model_spec(moe)["layers"][0]["ffn"]
    hybrid = dataclasses.replace(cfg, block_pattern=("mamba", "attn"))
    assert "mamba" in lm.model_spec(hybrid)["layers"][0]
    spec = lm.cache_spec(hybrid, 2, 8, kv_quant=True, paged=True, num_pages=4)
    assert sorted(spec[0]) == ["conv", "ssm"] and "page_table" in spec[1]
    # what stays unported raises: the verify window through a recurrent
    # sublayer (speculation demotes on such stacks) and a MoE dispatch
    # the port does not know ("ep" needs a device mesh: gshard without)
    params = lm.init_model(torch.Generator().manual_seed(0), hybrid,
                           device="cpu")
    cache = lm.init_cache(hybrid, 1, 8, kv_quant=True, paged=True,
                          num_pages=4, device="cpu")
    with pytest.raises(ValueError, match="no 'verify' mode"):
        lm.verify_step(params, hybrid, tokens=torch.zeros((1, 2),
                                                          dtype=torch.long),
                       cache=cache)
    from repro_torch.models import moe as moe_mod
    with pytest.raises(ValueError, match="unknown MoE dispatch"):
        moe_mod.moe_ffn(lm.init_model(torch.Generator().manual_seed(0), moe,
                                      device="cpu")["layers"][0]["ffn"],
                        torch.zeros((1, 2, cfg.d_model)), k=2,
                        dispatch="dense")

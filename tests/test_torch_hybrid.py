"""The MoE, Mamba and xLSTM stacks in the port against the JAX package:
olmoe-1b-7b and grok-1-314b (attention + MoE), jamba-v0.1-52b (Mamba +
attention 1:7, MoE every other layer), xlstm-125m (mLSTM + sLSTM) and
``tests/test_hybrid_serving.py``'s ``HYB`` stack (one sublayer of each
cache kind: Mamba, attention, mLSTM, sLSTM), reduced (d 64), the JAX
weights carried across by ``repro_torch.weights``:

* the four configs equal to JAX's field by field, each period layout equal
  to JAX's at full size and reduced, and every leaf of each JAX tree loaded
  at its use-site dtype (the MoE router and the recurrences' gate and decay
  leaves f32);
* model parity: the forward, a variable-length prefill (segmented LoRA,
  mixed adapters and a base row) and six teacher-forced decode steps on
  the dense int8 pool;
* the engine (``tests/test_hybrid_serving.py``'s tests, on the port): the
  cache plan equal to JAX's; variable-length paged admission equal to the
  exact-length teacher-forced reference; churn with zero new shape keys;
  the demotions (speculation, prefix sharing, the spill tier, and a paged
  pool on a stack without attention); the state-slot admission gate and
  gauges; snapshot/restore of the recurrent state; the serve loop end to
  end; and the port's engine on the dense and paged pools teacher-forced
  against the JAX engine under churn, the host state equal after every
  call (HYB and jamba).

The attention q/k and the mLSTM q/k/v projections are drawn at their real
fan-in (``_fan_in``): the packages' init takes the heads axis of a (d,
heads, hd) projection as its fan-in, which makes attention near one-hot
and the mLSTM normalizer pass near zero, where one bf16 ulp is amplified
(as test_torch_families.py says for attention); at the init draws the two
bf16 models sit 0.05-0.2 rel L2 apart, as far as an f32 run of the port
sits from either.

Tolerances: two bf16 models rounding in different places, held by
relative L2 plus a per-element ceiling (test_torch_models.py). MoE and
recurrent stacks carry more bf16 noise than stablelm's two attention
layers (gated recurrences and routing over 4-8 layers): hidden (5e-2,
0.5), logits (5e-2, 0.35). Measured here (rel L2, max): hidden up to
0.020 and 0.10, the logits of prefill and decode and the engines' up to
0.037 and 0.29 (|logits| up to 4.4). On a MoE stack a token whose router
input lies within bf16 noise of a tie takes other experts in the two
packages (``Routes``): each row is compared up to its first such flip,
and the positions left out are counted. Host state is exact; the port's
own engine against the port's exact-length reference is token-exact.
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
from repro.configs.base import ModelConfig as JModelConfig  # noqa: E402
from repro.core.cache_manager import CachePlan as JCachePlan  # noqa: E402
from repro.core.decode_engine import DecodeEngine as JDecodeEngine  # noqa: E402
from repro.core.physical import PhysicalFM as JPhysicalFM  # noqa: E402
from repro.kernels.segmented_lora import segment_metadata as jsegment_metadata  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import ATTN, MAMBA, MLSTM, SLSTM, ModelConfig  # noqa: E402
from repro_torch.core.cache_manager import CachePlan, dense_state_keys  # noqa: E402
from repro_torch.core.decode_engine import DecodeEngine  # noqa: E402
from repro_torch.core.physical import PhysicalFM  # noqa: E402
from repro_torch.kernels.segmented_lora import padded_tokens, segment_metadata  # noqa: E402
from repro_torch.models import blocks, lm, moe  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402

ARCHS = ("olmoe-1b-7b", "grok-1-314b", "jamba-v0.1-52b", "xlstm-125m")
HIDDEN_TOL = (5e-2, 0.5)      # (relative L2, max abs)
LOGIT_TOL = (5e-2, 0.35)
ENGINE_TOL = LOGIT_TOL
LORA_SCALE = 0.2
BT = 8
NA = 4                        # adapter stack: 3 adapters and a zero pad slot

_HYB = dict(name="hyb-serve", family="hybrid", num_layers=4, d_model=64,
            num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
            vocab_size=128, block_pattern=(MAMBA, ATTN, MLSTM, SLSTM))
HYB = ModelConfig(**_HYB)
JHYB = JModelConfig(**_HYB)
CUTS = {"olmoe": "olmoe-1b-7b", "grok": "grok-1-314b",
        "jamba": "jamba-v0.1-52b", "xlstm": "xlstm-125m", "hyb": None}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(cut):
    arch = CUTS[cut]
    if arch is None:
        return JHYB, HYB
    return jreduced(jget_config(arch)), reduced(get_config(arch))


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol):
    got, want = _f32(got), _f32(want)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    worst = np.abs(got - want).max()
    assert rel <= tol[0] and worst <= tol[1], (rel, worst)
    return rel, worst


def _fan_in(np_params, cfg):
    """The attention q/k and the mLSTM q/k/v projections at their real
    fan-in, in place (module docstring)."""
    for sub in np_params["layers"]:
        if "attn" in sub:
            for name, heads in (("wq", cfg.num_heads),
                                ("wk", cfg.num_kv_heads)):
                sub["attn"][name] = sub["attn"][name] * np.float32(
                    (heads / cfg.d_model) ** 0.5)
        if "mlstm" in sub:
            di = sub["mlstm"]["wq"].shape[1]
            for name in ("wq", "wk", "wv"):
                sub["mlstm"][name] = sub["mlstm"][name] * np.float32(
                    (cfg.num_heads / di) ** 0.5)
    return np_params


class Routes:
    """Both packages' expert choices at every MoE call: each token's set of
    top-k experts from its own router input ((B, S, k) a call, sorted). A
    token whose router input sits within bf16 noise of a tie may take
    another expert in one package than in the other (the router inputs
    differ by ~1e-2 relative), which moves its output by O(1) and, through
    the recurrences and attention, every later position of its row. So the
    comparisons below stop each row at its first such flip and count the
    positions they leave out; a wrong routing rule flips most tokens."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        jorig, orig = jblocks.moe_ffn, blocks.moe_ffn

        def jrecord(p, x, *, k, **kw):
            logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32),
                                p["router"].astype(jnp.float32))
            _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
            jax.debug.callback(lambda i: self.jax.append(
                np.sort(np.asarray(i), axis=-1)), idx, ordered=True)
            return jorig(p, x, k=k, **kw)

        def record(p, x, *, k, **kw):
            _, idx = moe.top_k(torch.softmax(
                x.float() @ p["router"].float(), dim=-1), k)
            self.port.append(np.sort(idx.numpy(), axis=-1))
            return orig(p, x, k=k, **kw)
        monkeypatch.setattr(jblocks, "moe_ffn", jrecord)
        monkeypatch.setattr(blocks, "moe_ffn", record)

    def first_flip(self, lo, hi, lens=None):
        """(B,) the first position of each row where a call in [lo, hi)
        (one forward's) routes a token to another expert set in the two
        packages (positions past ``lens`` are pads), S where none does;
        None on a stack without MoE."""
        if hi <= lo:
            return None
        assert len(self.jax) == len(self.port)
        flip = np.stack([(a != b).any(-1) for a, b in zip(
            self.jax[lo:hi], self.port[lo:hi])]).any(0)          # (B, S)
        B, S = flip.shape
        if lens is not None:
            flip &= np.arange(S)[None] < np.asarray(lens)[:, None]
        return np.where(flip, np.arange(S)[None], S).min(axis=1)


# ---------------- configs, layouts, leaves ----------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax(arch):
    """Every field, the parameter count and the reduced cut."""
    got, want = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.param_count() == want.param_count()
    assert dataclasses.asdict(reduced(got)) == dataclasses.asdict(
        jreduced(want))


@pytest.mark.parametrize("cut", sorted(CUTS))
def test_period_layout_matches_jax(cut):
    """The period layout (kind, MoE, FFN) of the full config and its
    reduced cut; none raises."""
    jcfg, cfg = _cfgs(cut)
    pairs = [(jcfg, cfg)]
    if CUTS[cut] is not None:
        pairs.append((jget_config(CUTS[cut]), get_config(CUTS[cut])))
    for jc, c in pairs:
        got = [(s.kind, s.has_moe, s.has_ffn) for s in blocks.period_layout(c)]
        want = [(s.kind, s.has_moe, s.has_ffn)
                for s in jblocks.period_layout(jc)]
        assert got == want
        assert blocks.period_len(c) == jblocks.period_len(jc)


@pytest.mark.parametrize("cut", sorted(CUTS))
def test_tree_loads_leaf_for_leaf(cut):
    """Every leaf of the JAX tree lands in the port's tree (the port's
    ``model_spec`` shapes) at its use-site dtype, and ``lm.init_model``
    draws the same structure at the same dtypes."""
    jcfg, cfg = _cfgs(cut)
    np_params = jax.tree.map(np.asarray, jlm.init_model(
        jax.random.PRNGKey(0), jcfg))
    params = weights.model_params(np_params, device="cpu")
    spec = lm.model_spec(cfg)
    drawn = lm.init_model(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    assert len(tree_leaves(params)) == len(jax.tree.leaves(np_params)) == \
        len(tree_leaves(spec)) == len(tree_leaves(drawn))
    for j, sub in enumerate(spec["layers"]):
        for part, leaves in sub.items():
            if not isinstance(leaves, dict):
                assert params["layers"][j][part].dtype == torch.float32
                continue
            for name, s in leaves.items():
                want = lm.use_dtype(part, name) or torch.float32
                t = params["layers"][j][part][name]
                assert tuple(t.shape) == tuple(s.shape), (part, name)
                assert t.dtype == want, (part, name)
                assert drawn["layers"][j][part][name].dtype == want
                np.testing.assert_array_equal(
                    t.float().numpy(), np.asarray(
                        np_params["layers"][j][part][name]).astype(
                        np.float32) if want == torch.float32 else
                    torch.tensor(np_params["layers"][j][part][name]).to(
                        want).float().numpy())
    kept = {(p, n) for sub in spec["layers"] for p, v in sub.items()
            if isinstance(v, dict) for n in v if lm.use_dtype(p, n) is None}
    if cfg.num_experts:
        assert ("ffn", "router") in kept
    if MAMBA in cfg.blocks:
        assert {("mamba", "A_log"), ("mamba", "D"),
                ("mamba", "dt_bias")} <= kept
    if SLSTM in cfg.blocks:
        assert {("slstm", "r"), ("slstm", "b"), ("mlstm", "b_if")} <= kept


# ---------------- the models against JAX ----------------

@pytest.fixture(scope="module", params=sorted(CUTS))
def model(request):
    jcfg, cfg = _cfgs(request.param)
    rng = np.random.RandomState(len(request.param) + 1)
    np_params = _fan_in(jax.tree.map(np.asarray, jlm.init_model(
        jax.random.PRNGKey(len(request.param)), jcfg)), jcfg)
    nper = jcfg.num_layers // jblocks.period_len(jcfg)
    d, r = jcfg.d_model, 4
    outs = {"q": jcfg.num_heads * jcfg.head_dim,
            "v": jcfg.num_kv_heads * jcfg.head_dim}
    np_lora = []
    for lay in jblocks.period_layout(jcfg):
        if lay.kind != ATTN:
            np_lora.append({})
            continue
        sub = {p: {"a": (rng.randn(nper, NA, d, r) * LORA_SCALE)
                   .astype(np.float32),
                   "b": (rng.randn(nper, NA, r, outs[p]) * LORA_SCALE)
                   .astype(np.float32)} for p in ("q", "v")}
        for p in ("q", "v"):
            sub[p]["b"][:, NA - 1] = 0.0
        np_lora.append(sub)
    return dict(name=request.param, jcfg=jcfg, cfg=cfg,
                jparams=jax.tree.map(jnp.asarray, np_params),
                params=weights.model_params(np_params, device="cpu"),
                jlora=jax.tree.map(jnp.asarray, np_lora),
                lora=weights.adapter_tree(np_lora, device="cpu"))


def _segs(aidx, seq_len):
    ids = np.repeat(np.asarray(aidx, np.int32), seq_len)
    tp = padded_tokens(len(ids), min(len(aidx), NA + 2), BT)
    perm, inv, blocks_ = segment_metadata(ids, NA, BT, tp)
    jp, ji, jb = jsegment_metadata(ids, NA, BT, tp)
    return ({"perm": jnp.asarray(jp), "inv": jnp.asarray(ji),
             "block_adapter": jnp.asarray(jb), "block_t": BT},
            {"perm": torch.tensor(perm, dtype=torch.long),
             "inv": torch.tensor(inv, dtype=torch.long),
             "block_adapter": torch.tensor(blocks_), "block_t": BT})


def test_forward_matches_jax(model, monkeypatch):
    """Hidden states of a forward with gather LoRA and a base row (on a
    MoE stack each row up to its first routing flip between the packages,
    ``Routes``; at least a third of the positions: jamba's three rows flip
    at positions 8, 7 and 2 at this seed)."""
    routes = Routes(monkeypatch)
    rng = np.random.RandomState(0)
    B, S = 3, 12
    toks = rng.randint(0, model["cfg"].vocab_size, (B, S)).astype(np.int32)
    aidx = np.array([0, NA - 1, 2], np.int32)
    jh, _, _ = jlm.forward(model["jparams"], model["jcfg"],
                           tokens=jnp.asarray(toks), lora=model["jlora"],
                           adapter_idx=jnp.asarray(aidx))
    jh = np.asarray(jh, np.float32)
    h, _ = lm.forward(model["params"], model["cfg"],
                      tokens=torch.tensor(toks).long(), lora=model["lora"],
                      adapter_idx=torch.tensor(aidx))
    assert h.dtype == torch.bfloat16
    first = routes.first_flip(0, len(routes.port))
    if first is None:
        _close(h, jh, HIDDEN_TOL)
        return
    keep = np.arange(S)[None] < first[:, None]
    print(f"{model['name']}: {int((~keep).sum())} of {B * S} positions at "
          f"or after a routing flip")
    assert keep.sum() >= B * S // 3
    _close(_f32(h)[keep], jh[keep], HIDDEN_TOL)


def test_prefill_and_int8_decode_match_jax(model, monkeypatch):
    """Right-padded prompts of true lengths 8, 3, 5 and 1 (segmented LoRA,
    mixed adapters and a base row) prefilled into the dense int8 pool, then
    six teacher-forced decode steps: every call's logits (on a MoE stack a
    row's up to its first routing flip between the packages, ``Routes``;
    at least half of them), the cache's leaves and dtypes, and the per-row
    lengths where the stack has attention."""
    routes = Routes(monkeypatch)
    cfg, jcfg = model["cfg"], model["jcfg"]
    lens = np.array([8, 3, 5, 1], np.int32)
    B, S, steps = 4, 8, 6
    rng = np.random.RandomState(1)
    prompt = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    toks = rng.randint(0, cfg.vocab_size, (B, steps)).astype(np.int32)
    aidx = np.array([1, NA - 1, 0, 2], np.int32)
    jseg_p, seg_p = _segs(aidx, S)
    jseg_d, seg_d = _segs(aidx, 1)
    s_max = S + steps + 1
    jc = jlm.init_cache(jcfg, B, s_max, kv_quant=True)
    log, jc = jlm.prefill(model["jparams"], jcfg, tokens=jnp.asarray(prompt),
                          cache=jc, lora=model["jlora"],
                          adapter_idx=jnp.asarray(aidx),
                          lora_impl="segmented", lora_seg=jseg_p,
                          seq_lens=jnp.asarray(lens))
    want = [np.asarray(log)]
    for t in range(steps):
        log, jc = jlm.decode_step(model["jparams"], jcfg,
                                  tokens=jnp.asarray(toks[:, t]), cache=jc,
                                  lora=model["jlora"],
                                  adapter_idx=jnp.asarray(aidx),
                                  lora_impl="segmented", lora_seg=jseg_d)
        want.append(np.asarray(log))
    c = lm.init_cache(cfg, B, s_max, kv_quant=True, device="cpu")
    log, c = lm.prefill(model["params"], cfg, tokens=torch.tensor(
        prompt).long(), cache=c, lora=model["lora"],
        adapter_idx=torch.tensor(aidx), lora_impl="segmented",
        lora_seg=seg_p, seq_lens=torch.tensor(lens))
    n = len(routes.port)                   # MoE calls of one forward
    got = [log]
    for t in range(steps):
        log, c = lm.decode_step(model["params"], cfg,
                                tokens=torch.tensor(toks[:, t]).long(),
                                cache=c, lora=model["lora"],
                                adapter_idx=torch.tensor(aidx),
                                lora_impl="segmented", lora_seg=seg_d)
        assert lm.finite_logits(log).all()
        got.append(log)
    got, want = np.stack([_f32(g) for g in got]), np.stack(want)
    first = routes.first_flip(0, n, lens)
    if first is None:
        _close(got, want, LOGIT_TOL)
    else:
        # call 0 reads position lens - 1, decode step t position lens + t,
        # whose own token may flip too
        for t in range(steps):
            step = routes.first_flip(n * (t + 1), n * (t + 2))
            first = np.where(step == 0, np.minimum(first, lens + t), first)
        pos = np.concatenate([lens[None] - 1,
                              lens[None] + np.arange(steps)[:, None]])
        keep = pos < first[None]
        print(f"{model['name']}: {int((~keep).sum())} of {keep.size} "
              f"logit rows at or after a routing flip")
        assert keep.sum() >= keep.size // 2
        _close(got[keep], want[keep], LOGIT_TOL)
    for j, (sub, jsub) in enumerate(zip(c, jc)):
        assert sorted(sub) == sorted(jsub)
        for k in sub:
            assert sub[k].dtype == getattr(torch, str(jsub[k].dtype)), (j, k)
        if "len" in sub:
            np.testing.assert_array_equal(sub["len"].numpy(),
                                          np.asarray(jsub["len"]))


# ---------------- the engine (tests/test_hybrid_serving.py) ----------------

@pytest.fixture(scope="module")
def hyb_fm():
    fm = PhysicalFM(HYB, seed=0, input_len=16, lora_rank=4, device="cpu")
    fm.adapters.new("lora0", seed=0)
    return fm


def _engine(fm, **kw):
    """Engine constructor with capability-demotion warnings silenced (the
    demotions themselves are held by the tests that target them)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return DecodeEngine(fm, **kw)


def _greedy_reference(fm, prompt, steps, s_max):
    """Exact-length (unpadded) prefill + greedy decode on a dense int8 cache
    of the port: what the bucketed paged engine must match token for
    token on any stack."""
    cfg = fm.cfg
    ai = torch.full((1,), fm.adapters.capacity(), dtype=torch.int32)
    cache = lm.init_cache(cfg, 1, s_max, kv_quant=True, device="cpu")
    lg, cache = lm.prefill(fm.params, cfg, tokens=torch.tensor(
        prompt[None]).long(), cache=cache, lora=fm.adapters.stacked(),
        adapter_idx=ai, lora_impl="gather")
    toks = [int(lg.argmax(-1)[0])]
    for _ in range(steps - 1):
        lg, cache = lm.decode_step(fm.params, cfg, tokens=torch.tensor(
            [toks[-1]]), cache=cache, lora=fm.adapters.stacked(),
            adapter_idx=ai, lora_impl="gather")
        toks.append(int(lg.argmax(-1)[0]))
    return toks


@pytest.mark.parametrize("cut", ["hyb", "jamba", "xlstm", "olmoe"])
@pytest.mark.parametrize("paged", [True, False])
def test_cache_plan_matches_jax(cut, paged):
    jcfg, cfg = _cfgs(cut)
    jplan, plan = JCachePlan.for_config(jcfg, paged), \
        CachePlan.for_config(cfg, paged)
    fields = ("paged", "has_attention", "has_recurrent", "has_encoder",
              "prefix_sharing_ok", "chunked_prefill_ok", "speculative_ok",
              "spill_resume_ok", "needs_state_slots")
    assert {f: getattr(plan, f) for f in fields} == \
        {f: getattr(jplan, f) for f in fields}
    assert [(s.kind, s.paged, s.grows, s.has_cross, s.fixed_state)
            for s in plan.sublayers] == \
        [(s.kind, s.paged, s.grows, s.has_cross, s.fixed_state)
         for s in jplan.sublayers]


def test_dense_state_keys_cover_recurrent_state():
    """A snapshot carries every leaf of a recurrent sub, the sidecars of a
    cross-attention sub, and nothing of an attention cache's own K/V."""
    pool = lm.init_cache(HYB, 2, 24, kv_quant=True, paged=True, page_size=8,
                         num_pages=7, device="cpu")
    assert [dense_state_keys(s) for s in pool] == \
        [["conv", "ssm"], [], ["C", "m", "n"], ["c", "h", "m", "n"]]


def test_hybrid_paged_varlen_admission_matches_reference(hyb_fm):
    """The hybrid stack joins the bucketed right-padded admission path:
    greedy tokens equal the exact-length dense reference."""
    eng = _engine(hyb_fm, num_slots=2, prompt_len=16, max_new=8, chunk=2,
                  paged=True, page_size=8)
    assert eng.plan.has_recurrent and eng.state_pool is not None
    rng = np.random.RandomState(7)
    for plen in (3, 9, 16):                      # buckets 4, 16, 16
        p = rng.randint(0, HYB.vocab_size, plen).astype(np.int32)
        eng.join("t", p, max_new_tokens=6, rid=0)
        (d,) = eng.drain()
        assert d.tokens == _greedy_reference(hyb_fm, p, 6, eng.s_max)
    assert eng.state_pool.slots_in_use() == set()


def test_hybrid_churn_zero_new_keys(hyb_fm):
    """Join/leave churn over prompt lengths and budgets on the hybrid paged
    engine adds no shape key once each bucket is warm."""
    eng = _engine(hyb_fm, num_slots=4, prompt_len=16, max_new=6, chunk=2,
                  paged=True, page_size=8, prompt_buckets=(4, 16))
    rng = np.random.RandomState(3)
    for plen in (4, 16):
        eng.join("w", rng.randint(0, HYB.vocab_size, plen),
                 adapter_id="lora0", max_new_tokens=2, rid=-1)
    eng.drain()
    keys = eng.compile_count()
    done = []
    for i, plen in enumerate((1, 3, 7, 9, 13, 16, 2, 11)):
        eng.join(f"t{i}", rng.randint(0, HYB.vocab_size, plen),
                 adapter_id="lora0" if i % 2 else None,
                 max_new_tokens=2 + i % 3, rid=i)
        if not eng.free_slots():
            done += eng.step_chunk()
    done += eng.drain()
    assert len(done) == 8
    assert eng.compile_count() == keys
    assert eng.state_pool.slots_in_use() == set()
    assert eng.state_pool.peak_in_use >= 2


def test_hybrid_demotes_speculation_and_prefix_sharing(hyb_fm):
    """spec_k > 0 warns and demotes to plain decode (recurrent state cannot
    rewind); prefix sharing and chunked prefill demote silently; the
    engine still serves, and an unpaged spec_k demotes before the
    paged-required check."""
    with pytest.warns(RuntimeWarning, match="demoted to plain decode"):
        eng = DecodeEngine(hyb_fm, num_slots=2, prompt_len=16, max_new=4,
                           chunk=2, paged=True, page_size=8, spec_k=2)
    assert eng.spec_k == 0
    assert eng.prefix_sharing is False and eng.chunked_prefill is False
    p = np.arange(8, dtype=np.int32) % HYB.vocab_size
    eng.join("t", p, max_new_tokens=4, rid=0)
    (d,) = eng.drain()
    assert d.tokens == _greedy_reference(hyb_fm, p, 4, eng.s_max)
    with pytest.warns(RuntimeWarning, match="demoted to plain decode"):
        eng2 = DecodeEngine(hyb_fm, num_slots=2, prompt_len=16, max_new=4,
                            chunk=2, paged=False, spec_k=2)
    assert eng2.spec_k == 0 and not eng2.paged


def test_hybrid_demotes_spill_tier(hyb_fm):
    with pytest.warns(RuntimeWarning, match="spill tier demoted"):
        eng = DecodeEngine(hyb_fm, num_slots=2, prompt_len=16, max_new=4,
                           chunk=2, paged=True, page_size=8,
                           spill_bytes=32 << 20)
    assert eng.spill is None


def test_pure_recurrent_paged_demotes_to_dense_pool():
    """paged=True on xLSTM (no attention) warns and runs the dense slot
    pool, with exact greedy parity."""
    cfg = reduced(get_config("xlstm-125m"))
    fm = PhysicalFM(cfg, seed=0, input_len=8, lora_rank=4, device="cpu")
    with pytest.warns(RuntimeWarning, match="no attention sublayers"):
        eng = DecodeEngine(fm, num_slots=2, prompt_len=8, max_new=4, chunk=2,
                           paged=True, page_size=8)
    assert not eng.paged and not eng.plan.paged
    assert eng.state_pool is not None
    p = np.random.RandomState(5).randint(0, cfg.vocab_size, 6).astype(
        np.int32)
    eng.join("t", p, max_new_tokens=4, rid=0)
    (d,) = eng.drain()
    assert d.tokens == _greedy_reference(fm, p, 4, eng.s_max)
    assert eng.state_pool.slots_in_use() == set()


def test_state_slot_admission_gate_and_gauges(hyb_fm):
    """With the state pool exhausted ``can_admit`` defers (the deferral
    gauge ticks) while decode slots are free; the gauges surface it."""
    from repro_torch.serving.metrics import mixed_stats, page_gauges
    eng = _engine(hyb_fm, num_slots=2, prompt_len=16, max_new=4, chunk=2,
                  paged=True, page_size=8)
    sp = eng.state_pool
    p = np.arange(8, dtype=np.int32) % HYB.vocab_size
    eng.join("a", p, max_new_tokens=4, rid=0)
    assert sp.slots_in_use() == {0} and sp.in_use_count() == 1
    assert eng.can_admit(prompt_tokens=8)
    sp.alloc(1)
    assert eng.free_slots()
    before = sp.slot_deferrals
    assert not eng.can_admit(prompt_tokens=8)
    assert sp.slot_deferrals == before + 1
    sp.free(1)
    assert eng.can_admit(prompt_tokens=8)
    g = page_gauges(eng)
    assert g["state_slots_total"] == eng.num_slots
    assert g["state_slots_in_use"] == 1 and g["state_slots_peak"] >= 1
    assert g["state_slot_deferrals"] == before + 1
    eng.drain()
    assert sp.slots_in_use() == set()
    stats = mixed_stats([], engine=eng)
    assert stats["state_slots"]["state_slots_in_use"] == 0
    assert stats["state_slots"]["state_slot_deferrals"] == before + 1


def test_hybrid_snapshot_restore_resumes_recurrent_state(hyb_fm):
    """A snapshot mid-flight captures every recurrent leaf beside the used
    pages; after a disk-format round trip, a restore onto the old engine's
    pool (pages AND recurrent state scrambled: a simulated device reset)
    and a fresh restore both resume every stream token-exact, with no new
    shape key on the reused one."""
    eng = _engine(hyb_fm, num_slots=2, prompt_len=16, max_new=8, chunk=2,
                  paged=True, page_size=8)
    rng = np.random.RandomState(11)
    ps = [rng.randint(0, HYB.vocab_size, n).astype(np.int32) for n in (7, 12)]
    want = [_greedy_reference(hyb_fm, p, 8, eng.s_max) for p in ps]
    for i, p in enumerate(ps):
        eng.join(f"t{i}", p, max_new_tokens=8, rid=i)
    eng.step_chunk()
    snap = eng.snapshot()
    assert [sorted(s) if s else None for s in snap.dense_state] == \
        [["conv", "ssm"], None, ["C", "m", "n"], ["c", "h", "m", "n"]]
    snap2 = type(snap).from_host_payload(*snap.to_host_payload())
    keys = eng.compile_count()
    for sub in eng.pool:
        for k, t in sub.items():
            if k in ("k", "v") or k in dense_state_keys(sub):
                t.fill_(77)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        reused = DecodeEngine.restore(hyb_fm, snap2, reuse_jits_from=eng)
        fresh = DecodeEngine.restore(hyb_fm, snap2)
    for e in (reused, fresh):
        assert e.state_pool.slots_in_use() == {0, 1}
        done = sorted(e.drain(), key=lambda s: s.rid)
        assert [d.tokens for d in done] == want
        assert e.state_pool.slots_in_use() == set()
    assert reused.compile_count() == keys


def test_serve_loop_hybrid_end_to_end(hyb_fm):
    """The hybrid FM serves through the event loop: warm-up, mixed-length
    generative churn, no new shape key after warm-up, state pool drained."""
    from repro_torch.core.request import Request
    from repro_torch.core.server import FMplexServer
    from repro_torch.core.vfm import TaskExtensions
    hyb_fm.calibrate(sizes=(1, 2, 4))
    srv = FMplexServer("s-hyb")
    srv.deploy_fm("fm0", hyb_fm, scheduler="bfq")
    srv.bind_task("gen", "fm0", weight=1.0,
                  extensions=TaskExtensions(adapter_id="lora0"))
    loop = srv.serve_loop("fm0", engine_kwargs=dict(
        num_slots=2, prompt_len=16, max_new=8, chunk=2, paged=True,
        page_size=8))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        loop.warmup(gen_task="gen")
    eng = srv.engines["fm0"]
    assert eng.state_pool is not None
    keys = eng.compile_count()
    rng = np.random.RandomState(2)
    trace = [Request("gen", 0.0, payload=rng.randint(
        0, HYB.vocab_size, 3 + 3 * i).astype("int32"), tokens=float(20),
        max_new_tokens=3 + i) for i in range(4)]
    loop.run(list(trace), max_wall=120)
    assert all(r.ok and len(r.result) == r.max_new_tokens for r in trace)
    assert eng.compile_count() == keys
    assert eng.state_pool.slots_in_use() == set()


# ---------------- the engines, teacher-forced against JAX ----------------

POOLS = {
    "dense": dict(num_slots=2, prompt_len=16, prompt_buckets=(8, 16),
                  max_new=6, chunk=2),
    "paged": dict(num_slots=2, prompt_len=16, prompt_buckets=(8, 16),
                  max_new=6, chunk=2, paged=True, page_size=8,
                  total_pages=7),
}
ENGINE_RUNS = [("hyb", "dense"), ("hyb", "paged"), ("jamba", "paged")]


def _engine_fms(cut):
    """Both packages' FMs of a cut (the JAX weights at real fan-in), with
    two random adapters."""
    jcfg, cfg = _cfgs(cut)
    jfm = JPhysicalFM(jcfg, seed=0, input_len=8, lora_rank=4,
                      lora_impl="segmented", seg_block_t=BT)
    np_params = _fan_in(jax.tree.map(np.asarray, jfm.params), jcfg)
    jfm.params = jax.tree.map(jnp.asarray, np_params)
    fm = PhysicalFM(cfg, seed=0, input_len=8, lora_rank=4,
                    lora_impl="segmented", seg_block_t=BT, device="cpu",
                    params=weights.to_torch(np_params, device="cpu"))
    for i in range(2):
        tree = jax.tree.map(
            lambda t, i=i: np.random.RandomState(50 + i).randn(*t.shape)
            .astype(np.float32) * 0.15,
            jax.tree.map(np.asarray, jfm.adapters._mod.init_single_adapter(
                jax.random.PRNGKey(i), jcfg, 4)))
        jfm.adapters.add(f"lora{i}", jax.tree.map(jnp.asarray, tree))
        fm.adapters.add(f"lora{i}", weights.adapter_tree(tree, device="cpu"))
    return jfm, fm, cfg


def _workload(cfg, seed=11):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, cfg.vocab_size, n).astype(np.int32),
             ("lora0", None, "lora1")[i % 3], int(rng.randint(2, 7)))
            for i, n in enumerate((14, 5, 16, 9, 3, 12))]


def _host_state(eng):
    st = {"slots": [None if s is None else (s.rid, list(s.tokens), s.done)
                    for s in eng.slots],
          "pending": eng.pending_rids(),
          "state_slots": sorted(eng.state_pool.slots_in_use()),
          "gauges": eng.state_pool.gauges(),
          "counters": [getattr(eng, n, None) for n in (
              "deferrals", "preemptions", "admissions", "steps")]}
    if eng.paged:
        st.update(ptab=np.asarray(eng._ptab).tolist(),
                  refs=np.asarray(eng._page_refs).tolist(),
                  free=list(eng._free_pages),
                  lens=np.asarray(eng._lens).tolist())
    return st


def _drive(eng, jobs):
    """Two joins, then a join after every chunk (on the dense pool when a
    slot is free; the paged pool of 7 pages queues, defers and preempts)
    until every stream has retired."""
    states, done = [], []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for i in range(2):
            p, name, n = jobs[i]
            eng.join(f"t{i}", p, adapter_id=name, max_new_tokens=n, rid=i)
            states.append(_host_state(eng))
        nxt = 2
        while eng.active_count() or eng.pending_count():
            done += eng.step_chunk()
            states.append(_host_state(eng))
            if nxt < len(jobs) and (eng.paged or eng.free_slots()):
                p, name, n = jobs[nxt]
                eng.join(f"t{nxt}", p, adapter_id=name, max_new_tokens=n,
                         rid=nxt)
                nxt += 1
                states.append(_host_state(eng))
    return states, sorted(done, key=lambda s: s.rid)


@pytest.mark.parametrize("cut,pool", ENGINE_RUNS)
def test_engine_teacher_forced_against_jax(cut, pool):
    """The port's engine fed the JAX engine's greedy tokens: every live
    row's logits within the bound at every sampler call, the host state
    (slots, tokens, pending queue, state slots and gauges, counters; the
    paged pool's tables, refcounts, free list and lengths) equal after
    every call, every stream finished with its budget."""
    jfm, fm, cfg = _engine_fms(cut)
    kw = POOLS[pool]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jeng = JDecodeEngine(jfm, **kw)
        eng = DecodeEngine(fm, **kw)
    jcalls = []

    def jsample(logits, keys):
        jax.debug.callback(lambda l: jcalls.append(np.asarray(l, np.float32)),
                           logits, ordered=True)
        return jnp.argmax(logits, axis=-1).astype(jnp.int32), keys
    jeng._sample = jsample
    jstates, jdone = _drive(jeng, _workload(cfg))
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
    assert len(done) == 6 and all(len(s.tokens) == s.max_new for s in done)
    assert eng.state_pool.slots_in_use() == set()
    if pool == "paged":
        assert eng.preemptions + eng.deferrals > 0
        assert eng.free_page_count() == eng.total_pages - 1

"""The port's MoE feed-forward (``repro_torch.models.moe``) against the JAX
package's ``models/moe.py``, on reduced olmoe-1b-7b and jamba-v0.1-52b
(d 64, 4 experts, top-2, d_ff 128) with the JAX weights converted leaf for
leaf and inputs made from a seed with numpy:

* the router: its f32 logits, gates, top-k expert ids and load-balance
  loss; ties taken at the lower index as ``jax.lax.top_k`` takes them;
* ``_positions`` (the k-major capacity cumsum) with and without a pad mask,
  and ``capacity``'s rounding;
* gshard and scatter dispatch against JAX at the real capacity, f32 and
  bf16, over sequence subgroups, and with capacity drops forced by a skewed
  router; a row holding a token whose JAX k-th and (k+1)-th probabilities
  are within a relative 1e-5 (where one f32 ulp may swap an expert) is
  counted and reported, and every other row's routing must be equal;
* against the per-token oracle ``moe_ref`` with the capacity lifted (the
  JAX package's ``test_moe_matches_dense_oracle``) and subgroup invariance;
* ``tests/test_hybrid_serving.py::test_moe_routing_excludes_pad_tokens``'s
  three properties (pad content does not reach a real token, pad outputs
  are zero, an all-true mask changes nothing).

Tolerances. f32: both sides compute the same products in another summation
order: 1e-5 (the oracle bound of the JAX package's own test). bf16 (the
served dtypes: expert matrices and activations bf16, the router f32): the
expert products round to bf16 in other places, so outputs are held by
relative L2 2e-2 and a per-element ceiling of 0.1 (measured up to 0.0055
and 0.023 here, outputs up to 2.4).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.common import init_params as jinit_params  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import moe  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = (2e-2, 0.1)        # (relative L2, max abs)
TIE_GAP = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _params(arch, seed=0, skew=0.0):
    """JAX MoE weights of the reduced ``arch`` as numpy, and both packages'
    trees (the port's f32). ``skew`` adds a bias towards expert 0 through
    the router's first input row (drops at the real capacity)."""
    jcfg = jreduced(jget_config(arch))
    npp = jax.tree.map(np.asarray, jinit_params(jax.random.PRNGKey(seed),
                                                jmoe.moe_spec(jcfg)))
    if skew:
        npp["router"] = npp["router"].copy()
        npp["router"][0, 0] += skew
    return (jcfg, jax.tree.map(jnp.asarray, npp),
            {k: torch.tensor(v) for k, v in npp.items()})


def _bf16(p):
    return {k: v if k == "router" else v.to(torch.bfloat16)
            for k, v in p.items()}


def _x(B, S, d, seed=3):
    """Inputs with a positive first feature (the one ``skew`` weights)."""
    x = np.random.RandomState(seed).randn(B, S, d).astype(np.float32)
    x[..., 0] = np.abs(x[..., 0]) + 0.5
    return x


def _near_ties(jp, x, k):
    """Tokens whose JAX k-th and (k+1)-th router probabilities lie within
    a relative TIE_GAP of each other (their log-probabilities, the logits
    less one constant, within TIE_GAP): one f32 ulp of the logits may swap
    which expert they take."""
    logits = np.asarray(jnp.einsum("...d,de->...e",
                                   jnp.asarray(x, jnp.float32), jp["router"]))
    s = -np.sort(-logits, axis=-1)
    return s[..., k - 1] - s[..., k] < TIE_GAP


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    worst = np.abs(got - want).max()
    assert rel <= tol[0] and worst <= tol[1], (rel, worst)


# ---------------- router, top-k, positions, capacity ----------------

def test_router_matches_jax():
    """f32 logits, gates, expert ids and the load-balance loss of one
    group: the ids exactly (no near-tie among these tokens), the rest to
    1e-5."""
    jcfg, jp, p = _params("olmoe-1b-7b")
    x = _x(1, 24, jcfg.d_model)[0]
    assert not _near_ties(jp, x, 2).any()
    jg, ji, jaux = jmoe._router(jp, jnp.asarray(x), 2)
    g, i, aux = moe._router(p, torch.tensor(x), 2)
    np.testing.assert_allclose(
        (torch.tensor(x) @ p["router"]).numpy(),
        np.asarray(jnp.asarray(x) @ jp["router"]), atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=F32_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=F32_TOL)
    assert float(aux) > 0


def test_top_k_takes_the_lower_index_on_a_tie():
    """Exact ties, as ``jax.lax.top_k`` orders them: the lower index first
    (``torch.topk`` promises no order on a tie)."""
    probs = np.array([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        v, i = moe.top_k(torch.tensor(probs), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("pad", [False, True])
def test_positions_match_jax(pad):
    """The k-major cumsum: slot positions and the keep mask, exactly, for
    ids drawn so that experts overflow a capacity of 5 (and with the last
    7 tokens marked pads)."""
    rng = np.random.RandomState(5)
    g, k, e, cap = 24, 2, 4, 5
    idx = np.stack([rng.choice(e, k, replace=False) for _ in range(g)])
    valid = np.arange(g) < (g - 7) if pad else None
    jpos, jkeep = jmoe._positions(jnp.asarray(idx), e, cap,
                                  valid=None if valid is None
                                  else jnp.asarray(valid))
    pos, keep = moe._positions(torch.tensor(idx), e, cap,
                               valid=None if valid is None
                               else torch.tensor(valid))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert not keep.all()                     # the capacity binds
    # batched rows route alone: row 1's result is row 1's own
    pos2, keep2 = moe._positions(torch.tensor(np.stack([idx[::-1], idx])), e,
                                 cap, valid=None if valid is None else
                                 torch.tensor(np.stack([valid, valid])))
    np.testing.assert_array_equal(pos2[1].numpy(), pos.numpy())
    np.testing.assert_array_equal(keep2[1].numpy(), keep.numpy())


@pytest.mark.parametrize("g,k,e", [(1, 8, 64), (1, 2, 16), (128, 8, 64),
                                   (128, 2, 16), (7, 2, 4), (33, 2, 8),
                                   (1024, 2, 8)])
def test_capacity_matches_jax(g, k, e):
    assert moe.capacity(g, k, e) == jmoe.capacity(g, k, e)
    if g == 1:
        assert moe.capacity(g, k, e) == k      # decode: no drop


# ---------------- dispatch against JAX ----------------

CASES = {
    # (arch, B, S, subgroup, router skew)
    "olmoe_one_group": ("olmoe-1b-7b", 2, 16, 1024, 0.0),
    "olmoe_subgroups": ("olmoe-1b-7b", 2, 24, 8, 0.0),
    "jamba_drops": ("jamba-v0.1-52b", 3, 32, 1024, 1.5),
    "olmoe_decode": ("olmoe-1b-7b", 5, 1, 1024, 0.0),
}


def _settled_rows(jp, x, k, case, dispatch):
    """Rows without a near-tie token (one token's flip moves the capacity
    positions of the rest of its row); the others are counted and
    reported."""
    ties = _near_ties(jp, x, k).any(axis=-1)
    print(f"{case} {dispatch}: {int(ties.sum())} of {len(ties)} rows hold a "
          f"near-tie token")
    assert (~ties).sum() >= len(ties) - 1
    return ~ties


@pytest.mark.parametrize("dispatch", ["gshard", "scatter"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dispatch_matches_jax_f32(case, dispatch):
    """f32 weights and activations at the real capacity: outputs to 1e-5
    on every row whose routing is settled (``_settled_rows``; every row at
    these seeds), the aux loss to 1e-5 where every row is settled."""
    arch, B, S, sub, skew = CASES[case]
    jcfg, jp, p = _params(arch, skew=skew)
    x = _x(B, S, jcfg.d_model)
    k = jcfg.experts_per_token
    jout, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), k=k, dispatch=dispatch,
                              subgroup=sub)
    out, aux = moe.moe_ffn(p, torch.tensor(x), k=k, dispatch=dispatch,
                           subgroup=sub)
    rows = _settled_rows(jp, x, k, case, dispatch)
    np.testing.assert_allclose(out.numpy()[rows], np.asarray(jout)[rows],
                               atol=F32_TOL, rtol=F32_TOL)
    if rows.all():
        np.testing.assert_allclose(float(aux), float(jaux), atol=F32_TOL)


def test_capacity_drops_tokens_as_jax_does():
    """The skewed router overflows expert 0 at the real capacity: the port
    keeps and drops exactly the (token, choice) pairs JAX does, so the
    dropped tokens' outputs (zero, or one expert's share) agree."""
    jcfg, jp, p = _params("jamba-v0.1-52b", skew=1.5)
    B, S, k, e = 3, 32, jcfg.experts_per_token, jcfg.num_experts
    x = _x(B, S, jcfg.d_model)
    cap = moe.capacity(S, k, e)
    keeps = []
    rows = _settled_rows(jp, x, k, "jamba_drops", "positions")
    for b in np.nonzero(rows)[0]:
        jg, ji, _ = jmoe._router(jp, jnp.asarray(x[b]), k)
        _, jkeep = jmoe._positions(ji, e, cap)
        g, i, _ = moe._router(p, torch.tensor(x[b]), k)
        _, keep = moe._positions(i, e, cap)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
        keeps.append(keep.numpy())
    dropped = int((~np.stack(keeps)).sum())
    assert dropped > 0, "the skew must overflow an expert"
    print(f"capacity {cap}: {dropped} of {B * S * k} choices dropped")


@pytest.mark.parametrize("dispatch", ["gshard", "scatter"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dispatch_matches_jax_bf16(case, dispatch):
    """The served dtypes: bf16 activations and expert matrices, the router
    f32 (``lm.use_dtype``), against JAX given the same bf16 input."""
    arch, B, S, sub, skew = CASES[case]
    jcfg, jp, p = _params(arch, skew=skew)
    x = _x(B, S, jcfg.d_model)
    xb = torch.tensor(x).to(torch.bfloat16)
    k = jcfg.experts_per_token
    jout, _ = jmoe.moe_ffn(jp, jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                           k=k, dispatch=dispatch, subgroup=sub)
    out, _ = moe.moe_ffn(_bf16(p), xb, k=k, dispatch=dispatch, subgroup=sub)
    assert out.dtype == torch.bfloat16
    rows = _settled_rows(jp, xb.float().numpy(), k, case, dispatch)
    _close(out[torch.tensor(rows)], np.asarray(jout, np.float32)[rows],
           BF16_TOL)


def test_router_weight_stays_f32_in_the_served_model():
    """``lm.use_dtype`` keeps the router f32 (a bf16 router would route
    otherwise) and casts the experts to bf16."""
    from repro_torch.models import lm
    assert lm.use_dtype("ffn", "router") is None
    assert lm.use_dtype("ffn", "wi_gate") == torch.bfloat16
    assert lm.use_dtype("ffn", "wo") == torch.bfloat16


# ---------------- the oracle, subgroups, pads ----------------

@pytest.mark.parametrize("dispatch", ["gshard", "scatter"])
def test_moe_matches_dense_oracle(dispatch, monkeypatch):
    """Capacity lifted (as the JAX package's test lifts it): both
    dispatches equal the per-token oracle, the port's and JAX's, to 1e-5,
    and the aux loss is positive."""
    monkeypatch.setattr(moe, "capacity", lambda g, k, e, factor=1.25: g * k)
    jcfg, jp, p = _params("olmoe-1b-7b")
    x = _x(2, 8, jcfg.d_model)
    k = jcfg.experts_per_token
    out, aux = moe.moe_ffn(p, torch.tensor(x), k=k, dispatch=dispatch)
    ref = moe.moe_ref(p, torch.tensor(x), k=k)
    jref = jmoe.moe_ref(jp, jnp.asarray(x), k=k)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=F32_TOL)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), atol=F32_TOL)
    assert float(aux) > 0


def test_moe_subgroup_invariance(monkeypatch):
    """Scanned subgroups agree with one big group when nothing drops."""
    monkeypatch.setattr(moe, "capacity", lambda g, k, e, factor=1.25: 4096)
    jcfg, _, p = _params("olmoe-1b-7b")
    x = torch.tensor(_x(2, 16, jcfg.d_model))
    a, _ = moe.moe_ffn(p, x, k=2, subgroup=16)
    b, _ = moe.moe_ffn(p, x, k=2, subgroup=4)
    assert float((a - b).abs().max()) < F32_TOL


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("dispatch", ["gshard", "scatter"])
def test_moe_routing_excludes_pad_tokens(dispatch, dtype):
    """Var-len MoE prefill: pads claim no capacity and contribute zero, so
    a real token's result is bit-invariant to the pad CONTENT of its
    bucket; an all-true mask equals no mask; and the masked output equals
    JAX's (f32)."""
    jcfg, jp, p = _params("jamba-v0.1-52b")
    if dtype == "bf16":
        p = _bf16(p)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    B, S, d = 2, 16, jcfg.d_model
    x = torch.tensor(_x(B, S, d, seed=1)).to(tdt)
    valid = torch.arange(S)[None] < torch.tensor([11, 16])[:, None]
    o1, _ = moe.moe_ffn(p, x, k=2, dispatch=dispatch, valid=valid)
    xg = torch.where(valid[..., None], x, torch.full_like(x, 123.0))
    o2, _ = moe.moe_ffn(p, xg, k=2, dispatch=dispatch, valid=valid)
    assert torch.equal(o1[0, :11], o2[0, :11])
    assert torch.equal(o1[1], o2[1])
    assert torch.equal(o1[0, 11:], torch.zeros((S - 11, d), dtype=tdt))
    o3, _ = moe.moe_ffn(p, x, k=2, dispatch=dispatch)
    o4, _ = moe.moe_ffn(p, x, k=2, dispatch=dispatch,
                        valid=torch.ones((B, S), dtype=torch.bool))
    np.testing.assert_allclose(o3.float().numpy(), o4.float().numpy(),
                               atol=1e-6)
    if dtype == "f32":
        jo, _ = jmoe.moe_ffn(jp, jnp.asarray(x.numpy()), k=2,
                             dispatch=dispatch, valid=jnp.asarray(
                                 valid.numpy()))
        np.testing.assert_allclose(o1.numpy(), np.asarray(jo), atol=F32_TOL)


def test_ep_dispatch_falls_back_to_gshard_without_a_mesh():
    """``dispatch="ep"`` with no device mesh routes as gshard (the JAX
    fallback); an unknown dispatch raises."""
    jcfg, _, p = _params("olmoe-1b-7b")
    x = torch.tensor(_x(2, 8, jcfg.d_model))
    a, _ = moe.moe_ffn(p, x, k=2, dispatch="ep")
    b, _ = moe.moe_ffn(p, x, k=2, dispatch="gshard")
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        moe.moe_ffn(p, x, k=2, dispatch="dense")


def test_config_moe_fields_equal_jax():
    for arch in ("olmoe-1b-7b", "grok-1-314b", "jamba-v0.1-52b"):
        got, want = get_config(arch), jget_config(arch)
        assert (got.num_experts, got.experts_per_token, got.moe_every,
                got.moe_dispatch) == (want.num_experts,
                                      want.experts_per_token,
                                      want.moe_every, want.moe_dispatch)
        assert reduced(got).num_experts == jreduced(want).num_experts

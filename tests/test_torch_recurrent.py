"""The port's recurrent blocks (``repro_torch.models.mamba`` and
``repro_torch.models.xlstm``) against the JAX package's, on reduced
jamba-v0.1-52b (Mamba: d 64, expand 2, d_state 16, d_conv 4) and reduced
xlstm-125m (mLSTM of 4 heads of 32, sLSTM of 128 cells), the JAX weights
converted leaf for leaf and inputs made from a seed with numpy:

* full sequences, each block alone, in f32 and in the served dtypes (bf16
  activations and matrices, the gate and decay leaves f32:
  ``lm.use_dtype``): outputs and the returned states;
* variable length: right-padded rows (``seq_lens``) against an unpadded
  run of the port itself, row by row: bit-identical outputs at the valid
  positions and bit-identical states (Mamba zeroes ``dt`` at a pad, so a
  pad step is an exact identity; the xLSTM cells carry their state through
  pads); and the padded run against JAX's;
* decode continuity: a prefill of S positions, then decode steps from the
  returned state, equal a forward over the whole sequence, and JAX's
  decode steps;
* at the model: a Mamba stack's prefill + decode steps equal its forward
  (``tests/test_models.py::test_mamba_decode_continuity``), and the xLSTM
  decode state does not grow with the sequence
  (``test_xlstm_long_decode_constant_state``).

The mLSTM projections are drawn at their real fan-in (the package's init
takes the heads axis of a (di, heads, hd) projection as its fan-in: q, k
and v come out sqrt(di / heads) too large, and the normalizer |n . q|
passes near zero at some positions, where a rounding difference is
amplified without bound).

Tolerances. f32: the same products summed in another order: 5e-5
relative L2 (measured up to 1.1e-5, the mLSTM's, whose stabilized
exponentials amplify the order) and 1e-3 per element. bf16: the matrices
round to bf16 in other places: relative L2 2e-2 (measured up to 7.5e-3) and
0.1 per element (measured 0.063, |y| up to 11) for outputs; states,
computed in f32 from bf16 inputs, 2e-2 relative L2 (measured 4.9e-3). Decode continuity within the port: f32 as
above; bf16 one bf16 ulp of the largest output (a decode step's products
have other shapes than the forward's).
"""
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro.models.common import NO_SHARD  # noqa: E402
from repro.models.common import init_params as jinit_params  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import lm, mamba, xlstm  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402

F32_TOL = (5e-5, 1e-3)        # (relative L2, max abs)
BF16_TOL = (2e-2, 0.1)
STATE_BF16_TOL = (2e-2, float("inf"))

BLOCKS = {
    "mamba": ("jamba-v0.1-52b", jmamba.mamba_spec, jmamba.mamba_forward,
              mamba.mamba_forward),
    "mlstm": ("xlstm-125m", jxlstm.mlstm_spec, jxlstm.mlstm_forward,
              xlstm.mlstm_forward),
    "slstm": ("xlstm-125m", jxlstm.slstm_spec, jxlstm.slstm_forward,
              xlstm.slstm_forward),
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol):
    got, want = _f32(got), _f32(want)
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    worst = np.abs(got - want).max()
    assert rel <= tol[0] and worst <= tol[1], (rel, worst)
    return rel, worst


def fan_in(npp, heads):
    """The mLSTM q/k/v projections (di, heads, hd) at their real fan-in
    (di), in place."""
    di = npp["wq"].shape[0]
    for name in ("wq", "wk", "wv"):
        npp[name] = npp[name] * np.float32((heads / di) ** 0.5)
    return npp


def _block(name, seed=1):
    """(jcfg, cfg, JAX params, the port's f32 params) of one block."""
    arch, jspec, _, _ = BLOCKS[name]
    jcfg, cfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    npp = jax.tree.map(np.asarray, jinit_params(jax.random.PRNGKey(seed),
                                                jspec(jcfg)))
    if name == "mlstm":
        npp = fan_in(npp, jcfg.num_heads)
    return jcfg, cfg, jax.tree.map(jnp.asarray, npp), \
        {k: torch.tensor(v) for k, v in npp.items()}


def _served(name, p):
    return {k: v.to(lm.use_dtype(name, k)) if lm.use_dtype(name, k)
            else v for k, v in p.items()}


def _x(B, S, d, seed=0):
    return np.random.RandomState(seed).randn(B, S, d).astype(np.float32)


def _states(name, st):
    """A block's state as a dict (Mamba returns a (conv, ssm) pair)."""
    if name == "mamba":
        return {"conv": st[0], "ssm": st[1]}
    return dict(st)


def _jrun(name, jcfg, jp, x, **kw):
    _, _, jfwd, _ = BLOCKS[name]
    y, st = jfwd(jp, x, jcfg, NO_SHARD, **kw)
    return y, _states(name, st)


def _run(name, cfg, p, x, **kw):
    _, _, _, fwd = BLOCKS[name]
    y, st = fwd(p, x, cfg, **kw)
    return y, _states(name, st)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name, dtype):
    """A full sequence of each block against JAX: the output and every
    leaf of the returned state."""
    jcfg, cfg, jp, p = _block(name)
    x = _x(2, 12, cfg.d_model)
    if dtype == "bf16":
        p = _served(name, p)
        xt = torch.tensor(x).to(torch.bfloat16)
        jx = jnp.asarray(xt.float().numpy(), jnp.bfloat16)
        tol, stol = BF16_TOL, STATE_BF16_TOL
    else:
        xt, jx, tol, stol = torch.tensor(x), jnp.asarray(x), F32_TOL, F32_TOL
    jy, jst = _jrun(name, jcfg, jp, jx)
    y, st = _run(name, cfg, p, xt)
    assert y.dtype == xt.dtype and tuple(y.shape) == x.shape
    _close(y, jy, tol)
    assert sorted(st) == sorted(jst)
    for k in st:
        assert st[k].dtype == (torch.bfloat16 if k == "conv" and
                               dtype == "bf16" else torch.float32), k
        _close(st[k], jst[k], stol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_variable_length_is_exact(name, dtype):
    """Right-padded rows of true lengths 12, 7 and 1 in a bucket of 12:
    each row's valid outputs and its final state are bit-identical to an
    unpadded run of that row (three copies of it at its true length, so
    that every product keeps the batch's row count: on the CPU a product of
    one row takes a matrix-vector path with other roundings, as a card's
    library may); the padded run is JAX's."""
    jcfg, cfg, jp, p = _block(name)
    tdt = torch.float32
    if dtype == "bf16":
        p, tdt = _served(name, p), torch.bfloat16
    lens = [12, 7, 1]
    x = torch.tensor(_x(3, 12, cfg.d_model, seed=2)).to(tdt)
    y, st = _run(name, cfg, p, x, seq_lens=torch.tensor(lens))
    for b, n in enumerate(lens):
        yb, stb = _run(name, cfg, p, x[b:b + 1, :n].expand(
            len(lens), -1, -1).contiguous())
        assert torch.equal(y[b, :n], yb[0]), (b, n)
        for k in st:
            assert torch.equal(st[k][b], stb[k][0]), (b, k)
    if dtype == "f32":
        jy, jst = _jrun(name, jcfg, jp, jnp.asarray(x.numpy()),
                        seq_lens=jnp.asarray(lens))
        for b, n in enumerate(lens):
            _close(y[b, :n], np.asarray(jy)[b, :n], F32_TOL)
        for k in st:
            _close(st[k], jst[k], F32_TOL)


def _decode(name, cfg, p, x, S, jax_side=None):
    """Prefill x[:, :S] (the state from its init), then one decode step a
    position from the carried state: the decode steps' outputs."""
    if jax_side is not None:
        jcfg, jp = jax_side
        _, st = _jrun(name, jcfg, jp, x[:, :S])
        outs = []
        for t in range(S, x.shape[1]):
            if name == "mamba":
                y, stt = jmamba.mamba_decode(jp, x[:, t:t + 1], jcfg,
                                             NO_SHARD, st["conv"], st["ssm"])
            else:
                y, stt = BLOCKS[name][2](jp, x[:, t:t + 1], jcfg, NO_SHARD,
                                         state=st)
            st = _states(name, stt)
            outs.append(np.asarray(y, np.float32))
        return np.concatenate(outs, axis=1)
    _, st = _run(name, cfg, p, x[:, :S])
    outs = []
    for t in range(S, x.shape[1]):
        if name == "mamba":
            y, stt = mamba.mamba_decode(p, x[:, t:t + 1], cfg, st["conv"],
                                        st["ssm"])
        else:
            y, stt = BLOCKS[name][3](p, x[:, t:t + 1], cfg, state=st)
        st = _states(name, stt)
        outs.append(y)
    return torch.cat(outs, dim=1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_decode_continuity(name, dtype):
    """Prefill 8 positions, then 4 decode steps from the returned state:
    equal to one forward over 12 positions (the port's), and to JAX's
    decode steps on the same state path."""
    jcfg, cfg, jp, p = _block(name)
    tdt = torch.float32
    if dtype == "bf16":
        p, tdt = _served(name, p), torch.bfloat16
    x = torch.tensor(_x(2, 12, cfg.d_model, seed=4)).to(tdt)
    dec = _decode(name, cfg, p, x, 8)
    full, _ = _run(name, cfg, p, x)
    if dtype == "f32":
        _close(dec, full[:, 8:], F32_TOL)
        jdec = _decode(name, jcfg, None, jnp.asarray(x.numpy()), 8,
                       jax_side=(jcfg, jp))
        _close(dec, jdec, F32_TOL)
    else:
        ulp = 2.0 ** -8 * float(full[:, 8:].float().abs().max())
        assert float((dec.float() - full[:, 8:].float()).abs().max()) <= ulp


def test_prefill_starts_from_the_init_state_not_the_pool_zeros():
    """A prefill's xLSTM scan starts from ``*_init_state`` (m = -1e30); the
    pool's zeroed cache (m = 0) is another start, with another stabilizer
    path and another state, which is why a prefill passes no state."""
    _, cfg, _, p = _block("mlstm")
    _, scfg, _, sp = _block("slstm")
    x = torch.tensor(_x(4, 1, cfg.d_model, seed=5))      # the first step
    for fwd, init, c, prm in (
            (xlstm.mlstm_forward, xlstm.mlstm_init_state, cfg, p),
            (xlstm.slstm_forward, xlstm.slstm_init_state, scfg, sp)):
        st_init = init(c, 4, "cpu")
        assert float(st_init["m"].max()) == float(np.float32(-1e30))
        y0, st0 = fwd(prm, x, c)
        y1, st1 = fwd(prm, x, c, state=st_init)
        assert torch.equal(y0, y1) and torch.equal(st0["m"], st1["m"])
        zeros = {k: torch.zeros_like(v) for k, v in st_init.items()}
        yz, stz = fwd(prm, x, c, state=zeros)
        assert not torch.equal(st0["m"], stz["m"])
        assert not torch.equal(y0, yz)


# ---------------- at the model ----------------

def test_mamba_stack_decode_continuity():
    """A Mamba + attention stack without experts (jamba cut: every block of
    its period, d_ff dense): prefill 8 tokens, decode 3, and the 4th decode
    step's logits equal a forward over 12 tokens' last position, as
    tests/test_models.py holds JAX's (bound 2e-1 there; 5e-2 here, bf16,
    measured 0.0104 with logits up to 3.3)."""
    jcfg = dataclasses.replace(jreduced(jget_config("jamba-v0.1-52b")),
                               num_experts=0, experts_per_token=0)
    cfg = dataclasses.replace(reduced(get_config("jamba-v0.1-52b")),
                              num_experts=0, experts_per_token=0)
    npp = jax.tree.map(np.asarray, jlm.init_model(jax.random.PRNGKey(0), jcfg))
    params = weights.model_params(npp, device="cpu")
    B, S = 1, 12
    toks = torch.tensor(np.random.RandomState(2).randint(
        0, cfg.vocab_size, (B, S)))
    cache = lm.init_cache(cfg, B, S, device="cpu")
    _, cache = lm.prefill(params, cfg, tokens=toks[:, :8], cache=cache)
    for t in range(8, S - 1):
        _, cache = lm.decode_step(params, cfg, tokens=toks[:, t], cache=cache)
    logits, _ = lm.decode_step(params, cfg, tokens=toks[:, S - 1], cache=cache)
    x, _ = lm.forward(params, cfg, tokens=toks)
    full = x[:, -1].float() @ params["head"].float()
    assert float((full - logits).abs().max()) < 5e-2


def test_xlstm_long_decode_constant_state():
    """The xLSTM decode state does not grow with the sequence: the cache
    of s_max 100 and of s_max 100000 hold the same number of elements, as
    JAX's."""
    cfg = reduced(get_config("xlstm-125m"))
    size = lambda c: sum(int(np.prod(s.shape)) for s in tree_leaves(c))
    c1 = lm.cache_spec(cfg, batch=1, s_max=100)
    c2 = lm.cache_spec(cfg, batch=1, s_max=100000)
    assert size(c1) == size(c2) > 0
    jcfg = jreduced(jget_config("xlstm-125m"))
    jc = jlm.cache_spec(jcfg, batch=1, s_max=100)
    assert size(c1) == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        jc, is_leaf=lambda x: hasattr(x, "shape")))

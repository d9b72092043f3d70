"""Gradients in the port, on the CPU.

* The plain versions' autograd (``kernels.ops`` routes CPU tensors to
  ``kernels.ref``, which is differentiable as written) against ``jax.grad``
  of the JAX package's jnp functions on the same inputs: the prefill
  attention (``models.attention.flash_attention``: causal and not, GQA, a
  window, ragged ``kv_len``, queries a strict suffix of the keys, tiles of
  8 so the online softmax crosses tiles) and ``models.layers.rmsnorm`` (dx
  and dw). This is the function the card's backward kernels are held to in
  ``chip_smoke.py``.
* The rmsnorm backward kernel's body (``csrc/rmsnorm.cu``: dx one warp a
  row, dw in two fixed-order passes) compiled by g++ against the stand-in
  headers of ``tests/cuda_host/`` and held to the plain version's autograd;
  each row's dx bits the same alone and among other rows.
* What runs without a card: the backward wrappers refuse CPU tensors, their
  ctypes bindings match the C signatures, the prefix operand refuses a
  gradient, and every kernel without a backward (K1, K3, K4, the verify
  window, K5, the prefix gather) raises on an input that requires grad on
  either device instead of cutting the graph, while it runs as before
  without one.

Tolerances: in f32 both sides compute the same function in another
summation order: 2e-5 of the largest gradient element. In bf16 both round
the inputs, the probabilities and the results to bf16 at the same points
and sum in other orders: rel L2 <= 1e-2 of each gradient. The kernel body
computes in f32 and rounds dx once to bf16: within two bf16 ulps of each
element plus 1e-5 of the row's largest |dx| (the dx formula subtracts two
terms, and where they cancel the f32 roundings of each side are what is
left); dw (f32 sums over rows in another order) within 1e-5 rel.
"""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
STUBS = Path(__file__).resolve().parent / "cuda_host"
EPS = 1e-5

# (B, Sq, Sk, H, KV, hd, causal, window, kv_len)
ATTN_CASES = {
    "causal": (2, 24, 24, 4, 4, 16, True, None, None),
    "bidirectional": (2, 24, 24, 4, 4, 16, False, None, None),
    "gqa": (2, 16, 16, 8, 2, 16, True, None, None),
    "window": (1, 32, 32, 4, 2, 16, True, 6, None),
    "kv_len": (3, 16, 16, 4, 4, 16, True, None, (16, 9, 3)),
    "suffix": (2, 8, 24, 4, 4, 32, True, None, None),
}


def _attn_inputs(case, seed=0):
    B, Sq, Sk, H, KV, hd, causal, window, kv_len = case
    r = np.random.RandomState(seed)
    q, dout = (r.randn(B, Sq, H, hd).astype(np.float32) for _ in range(2))
    k, v = (r.randn(B, Sk, KV, hd).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, window=window, q_chunk=8, kv_chunk=8)
    return (q, k, v, dout), kw, kv_len


def _port_grads(q, k, v, dout, kw, kv_len, dtype):
    ts = [torch.tensor(a).to(dtype).requires_grad_(True) for a in (q, k, v)]
    if kv_len is not None:
        kw = dict(kw, kv_len=torch.tensor(kv_len, dtype=torch.int32))
    out = ops.flash_attention(*ts, **kw)
    out.backward(torch.tensor(dout).to(dtype))
    return [t.grad.float().numpy() for t in ts]


def _jax_grads(q, k, v, dout, kw, kv_len, jdt):
    if kv_len is not None:
        kw = dict(kw, kv_len=jnp.asarray(kv_len, jnp.int32))

    def f(q, k, v):
        out = jattn.flash_attention(q, k, v, **kw)
        return jnp.sum(out.astype(jnp.float32) *
                       jnp.asarray(dout, jdt).astype(jnp.float32))
    g = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a, jdt)
                                         for a in (q, k, v)))
    return [np.asarray(x, np.float32) for x in g]


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_flash_attention_grad_matches_jax(name, dtype):
    """dq, dk, dv of the plain prefill attention against ``jax.grad`` of
    the JAX jnp function for the same output cotangent."""
    (q, k, v, dout), kw, kv_len = _attn_inputs(ATTN_CASES[name])
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    got = _port_grads(q, k, v, dout, kw, kv_len, dtype)
    want = _jax_grads(q, k, v, dout, kw, kv_len, jdt)
    for g, w, n in zip(got, want, "qkv"):
        assert np.isfinite(g).all() and np.abs(w).max() > 0, n
        if dtype == torch.float32:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=2e-5 * np.abs(w).max(), err_msg=n)
        else:
            assert _rel_l2(g, w) <= 1e-2, (n, _rel_l2(g, w))


def _norm_inputs(d, rows, seed=0):
    r = np.random.RandomState(seed + d)
    x = (r.randn(rows, d) * r.uniform(0.1, 8.0, (rows, 1))).astype(np.float32)
    w = (1.0 + 0.3 * r.randn(d)).astype(np.float32)
    dy = r.randn(rows, d).astype(np.float32)
    return x, w, dy


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [64, 1024])
def test_rmsnorm_grad_matches_jax(d, dtype):
    """dx and dw of the plain rmsnorm (x in ``dtype``, w f32, as the models
    run) against ``jax.grad`` of the JAX ``layers.rmsnorm``."""
    x, w, dy = _norm_inputs(d, 12)
    tx = torch.tensor(x).to(dtype).requires_grad_(True)
    tw = torch.tensor(w).requires_grad_(True)
    out = ops.rmsnorm(tw, tx, EPS)
    out.backward(torch.tensor(dy).to(dtype))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def f(w, x):
        y = jlayers.rmsnorm(w, x, EPS).astype(jnp.float32)
        return jnp.sum(y * jnp.asarray(dy, jdt).astype(jnp.float32))
    jw, jx = jax.grad(f, argnums=(0, 1))(jnp.asarray(w),
                                        jnp.asarray(x, jdt))
    for g, want in ((tx.grad, jx), (tw.grad, jw)):
        g, want = g.float().numpy(), np.asarray(want, np.float32)
        if dtype == torch.float32:
            np.testing.assert_allclose(g, want, rtol=0,
                                       atol=2e-5 * np.abs(want).max())
        else:
            assert _rel_l2(g, want) <= 1e-2


# ---------------- the rmsnorm backward kernel's body on the CPU ----------

_GLUE = r"""
#include "rmsnorm.cu"
using namespace rmsnorm;

extern "C" int host_rmsnorm_bwd(const void* x, const void* dy, const void* w,
                                void* dx, void* dw, void* rstd, void* part,
                                int rows, int d, long sx, long sdy,
                                float eps) {
  host_launch((rows + kRows - 1) / kRows, kThreads, [&] {
    rmsnorm_bwd_kernel((const __nv_bfloat16*)x, (const __nv_bfloat16*)dy,
                       (const float*)w, (__nv_bfloat16*)dx,
                       dw ? (float*)rstd : nullptr, rows, d, sx, sdy, eps);
  });
  if (dw == nullptr) return 0;
  const int chunks = (rows + kDwRows - 1) / kDwRows;
  const int cols = (d + kDwThreads - 1) / kDwThreads;
  host_launch(cols, chunks, kDwThreads, [&] {
    rmsnorm_bwd_dw_partial((const __nv_bfloat16*)x, (const __nv_bfloat16*)dy,
                           (const float*)rstd, (float*)part, rows, d, sx,
                           sdy);
  });
  host_launch(cols, kDwThreads, [&] {
    rmsnorm_bwd_dw_sum((const float*)part, (float*)dw, chunks, d);
  });
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel body for the CPU")
    d = tmp_path_factory.mktemp("rmsnorm_bwd_host")
    (d / "glue.cpp").write_text(_GLUE)
    so = d / "rmsnorm_bwd_host.so"
    done = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         f"-I{STUBS}", f"-I{CSRC}", "-o", str(so), str(d / "glue.cpp")],
        capture_output=True, text=True)
    if done.returncode != 0 and "barrier" in done.stderr:
        pytest.skip("g++ without C++20 <barrier>")
    assert done.returncode == 0, done.stderr
    lib = ctypes.CDLL(str(so))
    lib.host_rmsnorm_bwd.argtypes = [ctypes.c_void_p] * 7 + \
        [ctypes.c_int] * 2 + [ctypes.c_long] * 2 + [ctypes.c_float]
    return lib


def _host_bwd(lib, w, x, dy, need_dw=True):
    rows, d = x.shape
    dx = torch.empty_like(x)
    dw = torch.empty(d) if need_dw else None
    rstd = torch.empty(rows)
    part = torch.empty(-(-rows // 64) * d)
    assert lib.host_rmsnorm_bwd(
        x.data_ptr(), dy.data_ptr(), w.data_ptr(), dx.data_ptr(),
        None if dw is None else dw.data_ptr(), rstd.data_ptr(),
        part.data_ptr(), rows, d, x.stride(0), dy.stride(0), EPS) == 0
    return dx, dw


@pytest.mark.parametrize("d,rows", [(64, 5), (1024, 70)])
def test_rmsnorm_bwd_kernel_body_matches_plain(host_lib, d, rows):
    """dx and dw of the kernel body against the plain version's autograd
    on the same bf16 x and dy (two dw chunks at 70 rows)."""
    x, w, dy = _norm_inputs(d, rows, seed=3)
    tx = torch.tensor(x).to(torch.bfloat16)
    tdy = torch.tensor(dy).to(torch.bfloat16)
    tw = torch.tensor(w)
    dx, dw = _host_bwd(host_lib, tw, tx, tdy)
    xr, wr = tx.clone().requires_grad_(True), tw.clone().requires_grad_(True)
    ref.rmsnorm(wr, xr, EPS).backward(tdy)
    g, want = dx.float(), xr.grad.float()
    floor = 1e-5 * want.abs().amax(dim=1, keepdim=True)
    assert ((g - want).abs() <= 2 * 2.0 ** -8 * want.abs() + floor).all()
    assert (dw - wr.grad).abs().max() <= 1e-5 * wr.grad.abs().max()


def test_rmsnorm_bwd_kernel_body_is_row_invariant(host_lib):
    """Five rows' dx alone, at other indices among 70 rows, and read
    through strided views of x and dy: the same bits; and with or without
    dw."""
    d = 128
    x, w, dy = _norm_inputs(d, 75, seed=4)
    tx = torch.tensor(x).to(torch.bfloat16)
    tdy = torch.tensor(dy).to(torch.bfloat16)
    tw = torch.tensor(w)
    rows, grads = tx[:5].clone(), tdy[:5].clone()
    want, _ = _host_bwd(host_lib, tw, rows, grads)
    for i in range(5):
        got, _ = _host_bwd(host_lib, tw, rows[i:i + 1].clone(),
                           grads[i:i + 1].clone(), need_dw=False)
        assert torch.equal(got, want[i:i + 1])
    bx, bg = tx[5:].clone(), tdy[5:].clone()
    bx[41:46], bg[41:46] = rows, grads
    assert torch.equal(_host_bwd(host_lib, tw, bx, bg)[0][41:46], want)
    wide_x = torch.zeros((5, 2 * d), dtype=tx.dtype)
    wide_g = torch.zeros((5, 3 * d), dtype=tx.dtype)
    wide_x[:, d:], wide_g[:, 2 * d:] = rows, grads
    assert torch.equal(
        _host_bwd(host_lib, tw, wide_x[:, d:], wide_g[:, 2 * d:])[0], want)


# ---------------- what runs without a card ----------------

def test_backward_wrappers_refuse_cpu_tensors():
    q = torch.zeros((1, 4, 2, 32), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash.flash_attention_bwd(q, q, q, q, lse, q)
    x = torch.zeros((4, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rms.rmsnorm_bwd(torch.ones(64), x, x)


def test_backward_bindings_match_the_c_signatures(monkeypatch):
    """The backward kernels' ``argtypes`` have the count and kinds of their
    ``extern "C"`` entry points (rmsnorm's, in the same library as its
    forward, are held by test_torch_kernels' binding test)."""
    from test_torch_kernels import _c_signatures, _FakeLibrary
    kinds = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
             ctypes.c_int64: "int64", ctypes.c_float: "float"}
    fake = _FakeLibrary()
    monkeypatch.setattr(build, "load", lambda name: fake)
    flash._bwd_lib()
    sigs = _c_signatures((build.CSRC / build.SOURCES["flash_attention_bwd"])
                         .read_text())
    assert sigs and set(fake.fns) == set(sigs)
    for name, want in sigs.items():
        assert [kinds[t] for t in fake.fns[name].argtypes] == want, name
        assert fake.fns[name].restype is ctypes.c_int


def test_cpu_gradient_flows_through_the_plain_versions():
    """On the CPU the attention and the norm carry autograd history: a
    gradient reaches q, k, v, x and w."""
    r = np.random.RandomState(1)
    q, k, v = (torch.tensor(r.randn(1, 8, 2, 16), dtype=torch.float32,
                            requires_grad=True) for _ in range(3))
    w = torch.ones(16, requires_grad=True)
    out = ops.rmsnorm(w, ops.flash_attention(q, k, v, causal=False))
    out.square().sum().backward()
    assert all(t.grad is not None and t.grad.abs().max() > 0
               for t in (q, k, v, w))


def test_prefix_operand_refuses_a_gradient():
    q = torch.zeros((1, 4, 2, 16), requires_grad=True)
    pk = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="serving-only"):
        ops.flash_attention(q, q, q, prefix_k=pk, prefix_v=pk,
                            prefix_len=torch.tensor([2]))


def _serving_calls(grad: bool):
    """One call of each kernel without a backward, on CPU tensors, the
    query (or x) requiring grad when ``grad``."""
    r = np.random.RandomState(2)
    B, H, KV, hd, S, P, ps = 2, 4, 2, 16, 8, 4, 4

    def f(*shape):
        return torch.tensor(r.randn(*shape), dtype=torch.float32)
    q = f(B, H, hd).requires_grad_(grad)
    lens = torch.tensor([3, 8], dtype=torch.int32)
    kc = f(B, S, KV, hd)
    k8 = torch.randint(-127, 127, (B, S, KV, hd), dtype=torch.int8)
    sc = f(B, KV).abs() + 0.01
    kp = torch.randint(-127, 127, (P, ps, KV, hd), dtype=torch.int8)
    psc = (f(P, KV).abs() + 0.01).requires_grad_(grad)
    table = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    x = f(16, 8).requires_grad_(grad)
    return {
        "decode_attention": lambda: ops.decode_attention(q, kc, kc, lens),
        "decode_attention_int8": lambda: ops.decode_attention_int8(
            q, k8, k8, sc, sc, lens),
        "paged_decode_attention": lambda: ops.paged_decode_attention(
            q, kp, kp, psc, psc, table, lens),
        "paged_verify_attention": lambda: ops.paged_verify_attention(
            q[:, None], kp, kp, psc, psc, table, torch.tensor([2, 3])),
        "segmented_lora": lambda: ops.segmented_lora(
            x, torch.tensor([0, 1]), f(2, 8, 4), f(2, 4, 6), block_t=8),
        "gather_prefix_kv": lambda: ops.gather_prefix_kv(
            kp, kp, psc, psc, table),
    }


@pytest.mark.parametrize("name", ["decode_attention", "decode_attention_int8",
                                  "paged_decode_attention",
                                  "paged_verify_attention", "segmented_lora",
                                  "gather_prefix_kv"])
def test_kernels_without_a_backward_refuse_a_gradient(name):
    """An input that requires grad raises ``ValueError`` (on the CPU too,
    where the plain version could differentiate: the card's kernel could
    not); under ``no_grad``, or without such an input, the call runs."""
    with pytest.raises(ValueError, match="has no backward"):
        _serving_calls(True)[name]()
    with torch.no_grad():
        assert torch.isfinite(_serving_calls(True)[name]()[0]).all()
    assert torch.isfinite(_serving_calls(False)[name]()[0]).all()

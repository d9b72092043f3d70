"""Gradients in the port, on the CPU.

* The plain versions' autograd (``kernels.ops`` routes CPU tensors to
  ``kernels.ref``, which is differentiable as written) against ``jax.grad``
  of the JAX package's jnp functions on the same inputs: the prefill
  attention (``models.attention.flash_attention``: causal and not, GQA, a
  window, ragged ``kv_len``, queries a strict suffix of the keys, tiles of
  8 so the online softmax crosses tiles) and ``models.layers.rmsnorm`` (dx
  and dw). This is the function the card's backward kernels are held to in
  ``chip_smoke.py``.
* The rmsnorm backward kernel's body (``csrc/rmsnorm.cu``: one launch, dx
  one warp a row, dw's partial rows summed in a fixed order by a second
  launch) compiled by g++ against the stand-in headers of
  ``tests/cuda_host/`` and held to the plain version's autograd; each
  row's dx bits the same alone and among other rows; dx bit for bit the
  first backward kernel's, dw bit for bit a numpy re-statement of
  its order; the plan (``kernels/rmsnorm.py::_bwd_plan``) a function of
  the shapes that takes every row once.
* The prefill attention backward's plan (``flash_attention._bwd_plan``):
  a function of the shapes alone; moment-large's training shape takes the
  one fused launch; the split passes' walks, emulated as the kernels cut
  them, cover every query tile and every key tile
  exactly once and every visible (query, key) pair, at every
  ``chip_smoke.FLASH_BWD_CASES`` shape and at the reduced configs'.
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
import inspect
import shutil
import subprocess
import sys
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
sys.path.insert(0, str(ROOT))
from chip_smoke import FLASH_BWD_CASES  # noqa: E402

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
    # moment-large's training shape cut to size: 64 patches, not causal, G 1
    # (the fused backward's path on the card)
    "keys64": (2, 64, 64, 2, 2, 16, False, None, None),
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
namespace rmsnorm {

// The first backward kernel's dx, as it was, one warp a CTA: the
// order the redesigned kernel keeps.
__global__ void old_bwd_dx(const __nv_bfloat16* x, const __nv_bfloat16* dy,
                           const float* w, __nv_bfloat16* dx, int rows,
                           int d, int64_t sx, int64_t sdy, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x;
  if (row >= rows) return;
  const __nv_bfloat16* xr = x + row * sx;
  const __nv_bfloat16* gr = dy + row * sdy;
  __nv_bfloat16* orow = dx + static_cast<int64_t>(row) * d;
  const int chunks = d / kChunk;
  float ss = 0.f, sg = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    float v[kChunk], g[kChunk];
    load_chunk(xr, c, v);
    load_chunk(gr, c, g);
    for (int i = 0; i < kChunk; ++i) {
      ss = fmaf(v[i], v[i], ss);
      sg = fmaf(v[i], w[c * kChunk + i] * g[i], sg);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
    sg += __shfl_xor_sync(0xffffffffu, sg, o);
  }
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  const float k = (sg / static_cast<float>(d)) * (r * r * r);
  for (int c = lane; c < chunks; c += 32) {
    float v[kChunk], g[kChunk];
    load_chunk(xr, c, v);
    load_chunk(gr, c, g);
    uint32_t u[4];
    for (int i = 0; i < 4; ++i) {
      const int e = c * kChunk + 2 * i;
      u[i] = pack2(r * (w[e] * g[2 * i]) - v[2 * i] * k,
                   r * (w[e + 1] * g[2 * i + 1]) - v[2 * i + 1] * k);
    }
    uint4 t;
    t.x = u[0]; t.y = u[1]; t.z = u[2]; t.w = u[3];
    *reinterpret_cast<uint4*>(orow + c * kChunk) = t;
  }
}
}  // namespace rmsnorm
using namespace rmsnorm;

// The launcher's two launches on the CPU under the plan (warps a CTA, rows
// a warp), through the instance the launcher picks for d or, with
// `generic`, the runtime loop (CPL 0); dw null: dx alone.
extern "C" int host_rmsnorm_bwd(const void* x, const void* dy, const void* w,
                                void* dx, void* dw, void* part, int rows,
                                int d, long sx, long sdy, float eps,
                                int warps, int per_warp, int generic) {
  const int ctas = (rows + warps * per_warp - 1) / (warps * per_warp);
  auto run = [&](auto cpl) {
    constexpr int C = decltype(cpl)::value <= 16 ? decltype(cpl)::value : 0;
    host_launch(ctas, 32 * warps, [&] {
      if (dw != nullptr)
        rmsnorm_bwd_kernel<C, true>(
            (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy,
            (const float*)w, (__nv_bfloat16*)dx, (float*)part, rows, d, sx,
            sdy, eps, per_warp);
      else
        rmsnorm_bwd_kernel<C, false>(
            (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy,
            (const float*)w, (__nv_bfloat16*)dx, nullptr, rows, d, sx, sdy,
            eps, per_warp);
    });
  };
  if (generic) run(std::integral_constant<int, 0>{});
  else with_chunks_per_lane(d, run);
  if (dw == nullptr) return 0;
  host_launch((d / 4 + kSumPieces - 1) / kSumPieces, kSumPieces * kSumGroups,
              [&] {
    rmsnorm_bwd_dw_sum((const float4*)part, (float*)dw, ctas, d);
  });
  return 0;
}

extern "C" int host_old_bwd_dx(const void* x, const void* dy, const void* w,
                               void* dx, int rows, int d, long sx, long sdy,
                               float eps) {
  host_launch(rows, 32, [&] {
    old_bwd_dx((const __nv_bfloat16*)x, (const __nv_bfloat16*)dy,
               (const float*)w, (__nv_bfloat16*)dx, rows, d, sx, sdy, eps);
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
    lib.host_rmsnorm_bwd.argtypes = [ctypes.c_void_p] * 6 + \
        [ctypes.c_int] * 2 + [ctypes.c_long] * 2 + [ctypes.c_float] + \
        [ctypes.c_int] * 3
    lib.host_old_bwd_dx.argtypes = [ctypes.c_void_p] * 4 + \
        [ctypes.c_int] * 2 + [ctypes.c_long] * 2 + [ctypes.c_float]
    return lib


def _host_bwd(lib, w, x, dy, need_dw=True, plan=None, generic=False):
    """The kernel body's dx and dw on rows ``x`` / ``dy`` (read through
    their strides) under ``plan`` ((warps, rows a warp); default: the
    wrapper's ``_bwd_plan``)."""
    rows, d = x.shape
    warps, per_warp = plan or rms._bwd_plan(rows, d)[:2]
    ctas = -(-rows // (warps * per_warp))
    dx = torch.empty_like(x)
    dw = torch.empty(d) if need_dw else None
    part = torch.empty(ctas * d)
    assert lib.host_rmsnorm_bwd(
        x.data_ptr(), dy.data_ptr(), w.data_ptr(), dx.data_ptr(),
        None if dw is None else dw.data_ptr(), part.data_ptr(), rows, d,
        x.stride(0), dy.stride(0), EPS, warps, per_warp, int(generic)) == 0
    return dx, dw


def _bf16_inputs(d, rows, seed):
    x, w, dy = _norm_inputs(d, rows, seed=seed)
    return (torch.tensor(x).to(torch.bfloat16), torch.tensor(w),
            torch.tensor(dy).to(torch.bfloat16))


@pytest.mark.parametrize("d,rows", [(64, 5), (1024, 70)])
def test_rmsnorm_bwd_kernel_body_matches_plain(host_lib, d, rows):
    """dx and dw of the kernel body against the plain version's autograd
    on the same bf16 x and dy (at 70 rows under a plan of 2 warps and 3
    rows a warp: 12 partial rows, over two dw_sum warps)."""
    tx, tw, tdy = _bf16_inputs(d, rows, seed=3)
    dx, dw = _host_bwd(host_lib, tw, tx, tdy,
                       plan=(2, 3) if rows > 8 else None)
    xr, wr = tx.clone().requires_grad_(True), tw.clone().requires_grad_(True)
    ref.rmsnorm(wr, xr, EPS).backward(tdy)
    g, want = dx.float(), xr.grad.float()
    floor = 1e-5 * want.abs().amax(dim=1, keepdim=True)
    assert ((g - want).abs() <= 2 * 2.0 ** -8 * want.abs() + floor).all()
    assert (dw - wr.grad).abs().max() <= 1e-5 * wr.grad.abs().max()


def test_rmsnorm_bwd_kernel_body_is_row_invariant(host_lib):
    """Five rows' dx alone, at other indices among 70 rows (under two
    plans), and read through strided views of x and dy: the same bits; and
    with or without dw."""
    d = 128
    tx, tw, tdy = _bf16_inputs(d, 75, seed=4)
    rows, grads = tx[:5].clone(), tdy[:5].clone()
    want, _ = _host_bwd(host_lib, tw, rows, grads)
    for i in range(5):
        got, _ = _host_bwd(host_lib, tw, rows[i:i + 1].clone(),
                           grads[i:i + 1].clone(), need_dw=False)
        assert torch.equal(got, want[i:i + 1])
    bx, bg = tx[5:].clone(), tdy[5:].clone()
    bx[41:46], bg[41:46] = rows, grads
    for plan in (None, (4, 3)):
        assert torch.equal(
            _host_bwd(host_lib, tw, bx, bg, plan=plan)[0][41:46], want)
    wide_x = torch.zeros((5, 2 * d), dtype=tx.dtype)
    wide_g = torch.zeros((5, 3 * d), dtype=tx.dtype)
    wide_x[:, d:], wide_g[:, 2 * d:] = rows, grads
    assert torch.equal(
        _host_bwd(host_lib, tw, wide_x[:, d:], wide_g[:, 2 * d:])[0], want)


# every width the kernel has an instance for, and the generic loop's
BWD_WIDTHS = (64, 512, 768, 1024, 2048, 2560, 3584, 4096, 6144, 8192)


@pytest.mark.parametrize("d", BWD_WIDTHS)
def test_rmsnorm_bwd_dx_keeps_the_first_kernels_bits(host_lib, d):
    """dx of the redesigned body, through the instance the launcher picks
    for d and through the generic loop, with dw and without, equals the
    first backward kernel's (``old_bwd_dx`` above) bit for bit on
    24 rows of spread magnitudes."""
    tx, tw, tdy = _bf16_inputs(d, 24, seed=5)
    old = torch.empty_like(tx)
    assert host_lib.host_old_bwd_dx(
        tx.data_ptr(), tdy.data_ptr(), tw.data_ptr(), old.data_ptr(), 24, d,
        d, d, EPS) == 0
    for generic in (False, True):
        for need_dw in (True, False):
            got, _ = _host_bwd(host_lib, tw, tx, tdy, need_dw=need_dw,
                               generic=generic)
            assert torch.equal(got.view(torch.int16),
                               old.view(torch.int16)), (generic, need_dw)


def _pinned_r(x, eps):
    """r = 1 / sqrt(sum(x^2) / d + eps) per row in the kernel's order
    (``test_torch_rmsnorm._pinned_order``: lane l's chunks l, l + 32, ...
    in order, the xor tree), numpy float32."""
    rows, d = x.shape
    chunks = x.reshape(rows, d // 8, 8)
    lanes = np.zeros((rows, 32), np.float32)
    for lane in range(32):
        s = np.zeros(rows, np.float32)
        for c in range(lane, d // 8, 32):
            for i in range(8):
                v = chunks[:, c, i]
                s = s + v * v
        lanes[:, lane] = s
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ o]
    return np.float32(1) / np.sqrt(lanes[:, 0] / np.float32(d)
                                   + np.float32(eps))


def _pinned_dw(x, dy, eps, warps, per_warp, groups=32):
    """dw in the kernel's documented order, numpy float32, one rounding an
    operation: each element's (x * r) * dy; warp v of CTA b sums its rows
    (b * warps * T + t * warps + v, t < T) in order from zero; the CTA adds
    its warps' sums in warp order (a partial row); dw_sum's group u sums
    block u of ``groups`` equal blocks of partial rows in order from zero,
    and the groups' sums meet in the pairwise tree (at each level h =
    groups / 2, ..., 1, group u < h adds group u + h)."""
    rows, d = x.shape
    p = (x * _pinned_r(x, eps)[:, None]) * dy
    ctas = -(-rows // (warps * per_warp))
    parts = np.zeros((ctas, d), np.float32)
    for b in range(ctas):
        acc = np.zeros((warps, d), np.float32)
        for t in range(per_warp):
            for v in range(warps):
                row = b * warps * per_warp + t * warps + v
                if row < rows:
                    acc[v] = acc[v] + p[row]
        s = acc[0]
        for v in range(1, warps):
            s = s + acc[v]
        parts[b] = s
    per = -(-ctas // groups)
    red = np.zeros((groups, d), np.float32)
    for u in range(groups):
        p0 = min(ctas, u * per)
        for q in range(p0, min(ctas, p0 + per)):
            red[u] = red[u] + parts[q]
    h = groups // 2
    while h:
        red[:h] = red[:h] + red[h:2 * h]
        h //= 2
    return red[0]


@pytest.mark.parametrize("d,rows,plan", [
    (64, 1, None), (64, 70, (1, 1)), (768, 40, (8, 1)), (1024, 90, (4, 2)),
    (2048, 33, (8, 4)), (2048, 140, (2, 1)), (8192, 9, (1, 2))])
def test_rmsnorm_bwd_dw_order_is_pinned(host_lib, d, rows, plan):
    """dw of the kernel body equals a numpy float32 re-statement of its
    fixed order (``_pinned_dw``) bit for bit, under the wrapper's plan or
    a given one (several warps a CTA and rows a warp, a last CTA short of
    rows, more partial rows than dw_sum's groups), through the instance the
    launcher picks and the generic loop; and twice the same bits."""
    tx, tw, tdy = _bf16_inputs(d, rows, seed=6)
    warps, per_warp = plan or rms._bwd_plan(rows, d)[:2]
    want = _pinned_dw(tx.float().numpy(), tdy.float().numpy(), EPS, warps,
                      per_warp)
    for generic in (False, True):
        _, dw = _host_bwd(host_lib, tw, tx, tdy, plan=(warps, per_warp),
                          generic=generic)
        assert np.array_equal(dw.numpy().view(np.uint32),
                              want.view(np.uint32)), generic
    _, again = _host_bwd(host_lib, tw, tx, tdy, plan=(warps, per_warp))
    assert torch.equal(dw, again)


# (rows, d) the rmsnorm backward takes on the training paths and beyond:
# moment's 1024 x 1024, stablelm's LM step 4096 x 2048, a row, a decode
# step's rows, the checks' 4176, every instance's width
RMS_PLAN_SHAPES = [(1024, 1024), (4096, 2048), (1, 64), (8, 2048),
                   (4176, 4096), (1025, 768), (2112, 512), (1056, 8192),
                   (70, 6144), (12345, 2560), (3, 3584)]


def test_rmsnorm_bwd_plan_is_a_function_of_shapes_alone(monkeypatch):
    """``rms._bwd_plan`` takes (rows, d) only, asks nothing of the card
    (every ``torch.cuda`` query raises here), and gives the same plan on
    every call; its shared memory fits the card's 227 KB a CTA."""
    assert list(inspect.signature(rms._bwd_plan).parameters) == ["rows", "d"]

    def refuse(*a, **k):
        raise AssertionError("the plan asked the card")
    for name in ("get_device_properties", "current_device", "device_count"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    for rows, d in RMS_PLAN_SHAPES:
        warps, per_warp, ctas = rms._bwd_plan(rows, d)
        assert (warps, per_warp, ctas) == rms._bwd_plan(rows, d)
        assert 1 <= warps <= 8 and per_warp >= 1
        assert 4 * d * (1 + warps) <= 227 * 1024
        assert ctas <= rms._BWD_SMS * rms._BWD_CTAS_PER_SM


@pytest.mark.parametrize("rows,d", RMS_PLAN_SHAPES)
def test_rmsnorm_bwd_plan_covers_every_row_once(rows, d):
    """The rows the plan's CTAs and warps take (CTA b, warp v, t < T:
    b * warps * T + t * warps + v, skipping those past the last row) are
    every row exactly once; the partial rows dw_sum's groups take are
    every CTA's exactly once."""
    warps, per_warp, ctas = rms._bwd_plan(rows, d)
    b, t, v = np.meshgrid(np.arange(ctas), np.arange(per_warp),
                          np.arange(warps), indexing="ij")
    got = (b * warps * per_warp + t * warps + v).ravel()
    got = got[got < rows]
    assert np.array_equal(np.sort(got), np.arange(rows))
    per = -(-ctas // 32)
    blocks = [range(min(ctas, u * per), min(ctas, min(ctas, u * per) + per))
              for u in range(32)]
    assert sorted(q for blk in blocks for q in blk) == list(range(ctas))


# ---------------- the backward's plan ----------------

def _plan_shapes():
    """(label, B, Sq, Sk, KV, G, hd, causal, window, kv_len) of every
    ``FLASH_BWD_CASES`` entry and of the reduced configs' attention (hd
    16) at training and prompt lengths."""
    from repro_torch.configs.base import get_config, list_configs, reduced
    out = []
    for name, (B, S, H, KV, hd, causal, window, kv_len) in \
            FLASH_BWD_CASES.items():
        out.append((name, B, S, S, KV, H // KV, hd, causal, window, kv_len))
    for arch in list_configs():
        c = reduced(get_config(arch))
        G = c.num_heads // c.num_kv_heads
        for S in (8, 64, 65, 200):
            out.append((f"{arch}-{S}", 2, S, S, c.num_kv_heads, G, c.head_dim,
                        arch not in ("moment-large", "whisper-base"),
                        c.sliding_window, (S, max(1, S // 3))))
    return out


PLAN_SHAPES = _plan_shapes()


def test_backward_plan_is_a_function_of_shapes_alone(monkeypatch):
    """``_bwd_plan`` takes shapes only, asks nothing of the card (every
    device query raises here) and gives the same plan on every call; its
    splits lie in 1 .. 8 (one portable cluster)."""
    assert list(inspect.signature(flash._bwd_plan).parameters) == [
        "B", "Sq", "Sk", "KV", "G", "hd", "causal", "window"]

    def no_card(*a, **k):
        raise AssertionError("the plan asked the card")
    monkeypatch.setattr(build, "sm_count", no_card)
    for fn in ("device_count", "get_device_properties", "is_available",
               "current_device"):
        monkeypatch.setattr(torch.cuda, fn, no_card)
    for _, B, Sq, Sk, KV, G, hd, causal, window, _ in PLAN_SHAPES:
        plan = flash._bwd_plan(B, Sq, Sk, KV, G, hd, causal, window)
        assert plan == flash._bwd_plan(B, Sq, Sk, KV, G, hd, causal, window)
        fused, n_dq, n_dkv = plan
        assert isinstance(fused, bool)
        assert 1 <= n_dq <= 8 and 1 <= n_dkv <= 8
        assert not fused or (n_dq, n_dkv) == (1, 1)


def test_moment_training_shape_takes_one_launch():
    """moment-large fine-tuned (16 series of 64 patches, 16 heads of 64,
    not causal) runs the fused backward; whisper's 1500 frames split both
    passes over the card's SMs; no shape past 64 keys is fused."""
    B, S, H, KV, hd, causal, window, _ = FLASH_BWD_CASES["moment"]
    assert flash._bwd_plan(B, S, S, KV, H // KV, hd, causal, window) == \
        (True, 1, 1)
    B, S, H, KV, hd, causal, window, _ = FLASH_BWD_CASES["whisper_encoder"]
    fused, n_dq, n_dkv = flash._bwd_plan(B, S, S, KV, H // KV, hd, causal,
                                         window)
    assert not fused and n_dq > 1 and n_dkv > 1
    assert not flash._bwd_plan(1, 65, 65, 1, 1, 64, True, None)[0]


def _visible(Sq, Sk, causal, window, kend):
    """(Sq, Sk) bool: the forward's masks for one batch row."""
    qpos = np.arange(Sq)[:, None] + (Sk - Sq)
    kpos = np.arange(Sk)[None, :]
    vis = (kpos < kend) & np.ones((Sq, 1), bool)
    if causal:
        vis &= qpos >= kpos
    if window is not None:
        vis &= qpos - kpos < window
    return vis


def _exactly_once(n, parts):
    """The kernels' split rule (split s of ``parts`` takes items [s n /
    parts, (s + 1) n / parts) of a walk of n) partitions range(n)."""
    seen = [i for s in range(parts)
            for i in range(s * n // parts, (s + 1) * n // parts)]
    return seen == list(range(n))


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=[s[0] for s in PLAN_SHAPES])
def test_backward_split_covers_every_tile_once(shape):
    """The backward's walks as the kernels cut them: the fused CTA holds
    every key and query of its (row, kv head); otherwise every query tile
    (dQ pass) and key tile (dK/dV pass) has one CTA per split, the splits'
    shares of its walk partition it, and the walk holds every key (query)
    a visible pair needs, in every batch row's ``kv_len``."""
    _, B, Sq, Sk, KV, G, hd, causal, window, kv_len = shape
    fused, n_dq, n_dkv = flash._bwd_plan(B, Sq, Sk, KV, G, hd, causal, window)
    rows, tile, keys, qtile = (flash._ROWS, flash._TILE, flash._BWD_KEYS,
                               flash._BWD_QTILE)
    if fused:
        assert Sq <= Sk <= keys
        return
    bq = rows // G
    q_off = Sk - Sq
    for b in range(B):
        kend = min(Sk, kv_len[b % len(kv_len)]) if kv_len else Sk
        vis = _visible(Sq, Sk, causal, window, kend)
        # dQ pass: CTA x takes query tile x // n_dq, split x % n_dq
        tiles = {}
        for x in range(-(-Sq // bq) * n_dq):
            tiles.setdefault(x // n_dq, []).append(x % n_dq)
        assert all(v == list(range(n_dq)) for v in tiles.values())
        for t in tiles:
            q0 = t * bq
            qhi = q_off + min(Sq, q0 + bq) - 1
            hi = min(kend, qhi + 1) if causal else kend
            lo = max(0, q_off + q0 - window + 1) if window else 0
            ntiles = -(-(hi - lo) // tile) if hi > lo else 0
            assert _exactly_once(ntiles, n_dq)
            need = np.nonzero(vis[q0:q0 + bq].any(axis=0))[0]
            assert ((need >= lo) & (need < lo + ntiles * tile)).all()
        # dK/dV pass: CTA x takes key tile x // n_dkv, split x % n_dkv,
        # walking (head, query tile) pairs
        for kt in range(-(-Sk // keys)):
            j0 = kt * keys
            kmax = min(j0 + keys, kend) - 1
            i_lo, i_hi = 0, (Sq if kmax >= j0 else 0)
            if causal:
                i_lo = max(i_lo, j0 - q_off)
            if window:
                i_hi = min(i_hi, kmax + window - q_off)
            nqt = -(-(i_hi - i_lo) // qtile) if i_hi > i_lo else 0
            assert _exactly_once(G * nqt, n_dkv)
            need = np.nonzero(vis[:, j0:j0 + keys].any(axis=1))[0]
            assert ((need >= i_lo) & (need < i_lo + nqt * qtile)).all()


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

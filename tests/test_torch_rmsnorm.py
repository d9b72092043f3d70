"""RMS norm in the port: the plain version (``kernels.ref.rmsnorm``, what
``ops.rmsnorm`` runs on the CPU) against the JAX package's
``models/layers.py::rmsnorm`` at the model widths, the routing (only CPU
tensors reach the plain version), and the CUDA kernel's body
(``csrc/rmsnorm.cu``) compiled by g++ for the CPU against the stand-in
headers in ``tests/cuda_host/`` (one std::thread per CUDA thread): held to
the plain version, and each row's output bits the same whatever the row
count of the call and wherever the row sits in it, which is what the
kernel exists for (PyTorch's f32 mean on the card reduces in an order
that follows the row count).

Tolerances: bf16 outputs within one bf16 ulp of each element (2^-7 of its
magnitude: both sides compute in f32, summing the squares in another
order, and round once to bf16); f32 outputs within 1e-5 of the largest
output (the same f32 work in another order). The row-invariance checks
are exact. The kernel-body tests skip where g++ with C++20 is missing."""
import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
np = pytest.importorskip("numpy")
jnp = pytest.importorskip("jax.numpy")

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
STUBS = Path(__file__).resolve().parent / "cuda_host"

# every width the kernel has an instance for: the reduced configs (64),
# whisper-base (512), xlstm-125m (768), moment-large (1024), stablelm
# (2048), h2o-danube (2560), qwen2-7b (3584), minitron-8b (4096), grok
# (6144), qwen2-vl-72b (8192)
WIDTHS = (64, 512, 768, 1024, 2048, 2560, 3584, 4096, 6144, 8192)
EPS = 1e-5

_GLUE = r"""
#include "rmsnorm.cu"
using namespace rmsnorm;

// the instance the launcher picks for d, or with `generic` the runtime
// loop (CPL 0) that takes any d
extern "C" int host_rmsnorm(const void* x, const void* w, void* out,
                            int rows, int d, long sx, float eps,
                            int generic) {
  auto run = [&](auto cpl) {
    host_launch(rows, kFwdThreads, [&] {
      rmsnorm_kernel<decltype(cpl)::value>(
          (const __nv_bfloat16*)x, (const float*)w, (__nv_bfloat16*)out,
          rows, d, sx, eps);
    });
  };
  if (generic) run(std::integral_constant<int, 0>{});
  else with_chunks_per_lane(d, run);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel body for the CPU")
    d = tmp_path_factory.mktemp("rmsnorm_host")
    (d / "glue.cpp").write_text(_GLUE)
    so = d / "rmsnorm_host.so"
    done = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         f"-I{STUBS}", f"-I{CSRC}", "-o", str(so), str(d / "glue.cpp")],
        capture_output=True, text=True)
    if done.returncode != 0 and "barrier" in done.stderr:
        pytest.skip("g++ without C++20 <barrier>")
    assert done.returncode == 0, done.stderr
    lib = ctypes.CDLL(str(so))
    lib.host_rmsnorm.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
        + [ctypes.c_long, ctypes.c_float, ctypes.c_int]
    return lib


def _run(lib, w, x, generic=False):
    """The kernel body on rows ``x`` (rows, d), read through its strides:
    the instance the launcher picks for d, or the generic loop."""
    out = torch.empty(x.shape, dtype=x.dtype)
    assert x.dtype == torch.bfloat16 and w.dtype == torch.float32
    assert x.stride(1) == 1
    rc = lib.host_rmsnorm(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                          x.shape[0], x.shape[1], x.stride(0), EPS,
                          int(generic))
    assert rc == 0
    return out


def _inputs(d, rows, x_dtype=torch.bfloat16, w_dtype=torch.float32,
            seed=0):
    r = np.random.RandomState(seed + d)
    x = (r.randn(rows, d) * r.uniform(0.1, 8.0, (rows, 1))).astype(np.float32)
    w = (1.0 + 0.3 * r.randn(d)).astype(np.float32)
    return (torch.from_numpy(w).to(w_dtype),
            torch.from_numpy(x).to(x_dtype))


def _close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    if got.dtype == torch.bfloat16:
        assert ((g - w).abs() <= 2.0 ** -7 * w.abs()).all()
    else:
        assert (g - w).abs().max().item() <= 1e-5 * w.abs().max().item()


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", WIDTHS + (96,))
def test_rmsnorm_plain_matches_jax(d, x_dtype):
    """``ops.rmsnorm`` on the CPU (the plain version) against JAX's
    ``layers.rmsnorm`` on the same numpy inputs, (2, 3, d) activations."""
    w, x = _inputs(d, 6, x_dtype)
    x = x.reshape(2, 3, d)
    got = ops.rmsnorm(w, x, EPS)
    jdt = jnp.bfloat16 if x_dtype == torch.bfloat16 else jnp.float32
    want = jlayers.rmsnorm(jnp.asarray(w.numpy()),
                           jnp.asarray(x.float().numpy()).astype(jdt), EPS)
    _close(got, torch.from_numpy(np.array(want.astype(jnp.float32))).to(
        x_dtype))


def test_rmsnorm_routes_only_cpu_to_the_plain_version():
    """Another device than the CPU reaches the kernel or an error, never
    the plain version (a meta tensor stands in for one here); the kernel's
    wrapper refuses CPU tensors."""
    w = torch.ones(64, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.rmsnorm(w, torch.empty((4, 64), device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        rms.rmsnorm(torch.ones(64), torch.ones((4, 64), dtype=torch.bfloat16))


@pytest.mark.parametrize("d", WIDTHS)
def test_rmsnorm_kernel_body_matches_plain(host_lib, d):
    """The kernel body against the plain version at the model widths, 40
    rows of spread magnitudes (bf16 activations, f32 weights, as the models
    run)."""
    w, x = _inputs(d, 40)
    _close(_run(host_lib, w, x), ref.rmsnorm(w, x, EPS))


@pytest.mark.parametrize("d", WIDTHS)
def test_rmsnorm_kernel_body_is_row_invariant(host_lib, d):
    """Eight rows normalised alone, as a batch of 8 (a decode step's
    rows), inside batches of 40 (a verify forward's) and of 4176 rows at
    other indices among other rows, and read through a strided view: the
    same bits every time."""
    w, x = _inputs(d, 8 + 4176, seed=1)
    rows = x[:8].clone()
    want = _run(host_lib, w, rows)
    for i in range(8):
        assert torch.equal(_run(host_lib, w, rows[i:i + 1].clone()),
                           want[i:i + 1])
    for n, at in ((40, 29), (4176, 3001)):
        batch = x[8:8 + n].clone()
        batch[at:at + 8] = rows
        assert torch.equal(_run(host_lib, w, batch)[at:at + 8], want)
    wide = torch.zeros((8, 2 * d), dtype=x.dtype)
    wide[:, d:] = rows
    assert torch.equal(_run(host_lib, w, wide[:, d:]), want)


def _pinned_order(w, x, eps):
    """The kernel's documented order in numpy float32, one rounding per
    operation: lane l sums the squares of its 8-element chunks l, l + 32,
    ... in order (a bf16 square is exact in f32, so the kernel's fma is a
    multiply then an add), the lanes meet in the xor tree (offsets 16, 8,
    4, 2, 1), r = 1 / sqrt(sum / d + eps) (the host stand-in's rsqrtf),
    each output (x * r) * w, rounded to bf16 (nearest even). Returns the
    bf16 bits (uint16)."""
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
    r = np.float32(1) / np.sqrt(lanes[:, 0] / np.float32(d) + np.float32(eps))
    out = (x * r[:, None]) * w[None, :]
    u = out.view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


@pytest.mark.parametrize("d", WIDTHS)
def test_rmsnorm_kernel_body_order_is_pinned(host_lib, d):
    """The kernel body's output bits, through the instance the launcher
    picks for d and through the generic loop, equal a numpy float32
    emulation of the documented order (``_pinned_order``) bit for bit,
    on 256 rows of spread magnitudes: the order the first row-invariant
    kernel defined, held without its source."""
    w, x = _inputs(d, 256, seed=2)
    want = _pinned_order(w.numpy(), x.float().numpy(), EPS)
    for generic in (False, True):
        got = _run(host_lib, w, x, generic).view(torch.int16).numpy()
        assert np.array_equal(got.view(np.uint16), want), generic

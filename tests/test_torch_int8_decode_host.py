"""The int8 flash-decode kernels' CUDA body (``csrc/int8_decode.cuh``: K3
``decode_int8_kernel``, K4 ``paged_decode_kernel`` and its verify window
``paged_verify_kernel``) compiled by g++ for the CPU against the stand-in
headers in ``tests/cuda_host/`` (one std::thread per CUDA thread, barriers
for ``__syncthreads`` and the warp shuffles) and run at the card's case
shapes, cut to one kv head, against the plain versions in
``kernels/ref.py``, which
``test_torch_kernels.py`` and ``test_torch_paged.py`` hold against the JAX
package. This checks the kernel's logic here, where no GPU or nvcc is: the
lane groups of every (hd, G) instantiation, the rounds of passes and their
second register buffer, windows, ragged and empty rows, the page lookup
(a shift or a division), table entries outside [0, P), lengths past the
cache or table; and the verify window at ``VERIFY_CASES`` (T 1 to 10,
windows that cross a page, G 1 to 8), its body in the lean register form
and each window position bit-identical to K4's body (K4's own form) at its
length. Tolerance: two bf16 ulps of the largest output, as on the card (both
sides accumulate in f32, in another order, and round to bf16). Skipped
where g++ with C++20 is missing."""
import ctypes
import math
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
STUBS = Path(__file__).resolve().parent / "cuda_host"

sys.path.insert(0, str(ROOT))
from chip_smoke import INT8_CASES, VERIFY_CASES  # noqa: E402

_GLUE = r"""
#include "int8_decode.cuh"
namespace int8_decode {
alignas(16) unsigned char int8_decode_smem[1 << 18];
}
using namespace int8_decode;

#define HD_G_SWITCH(CALL)                                   \
  switch (hd * 16 + G) {                                    \
    case 32 * 16 + 1: CALL(32, 1); break;                   \
    case 32 * 16 + 2: CALL(32, 2); break;                   \
    case 32 * 16 + 4: CALL(32, 4); break;                   \
    case 32 * 16 + 8: CALL(32, 8); break;                   \
    case 64 * 16 + 1: CALL(64, 1); break;                   \
    case 64 * 16 + 2: CALL(64, 2); break;                   \
    case 64 * 16 + 4: CALL(64, 4); break;                   \
    case 64 * 16 + 8: CALL(64, 8); break;                   \
    case 128 * 16 + 1: CALL(128, 1); break;                 \
    case 128 * 16 + 2: CALL(128, 2); break;                 \
    case 128 * 16 + 4: CALL(128, 4); break;                 \
    case 128 * 16 + 8: CALL(128, 8); break;                 \
    default: return 1;                                      \
  }                                                         \
  return 0;

extern "C" int host_decode_int8(
    const void* q, const void* kq, const void* vq, const void* ks,
    const void* vs, const void* lengths, void* out, int B, int KV, int G,
    int S, int hd, int64_t skb, int64_t skh, int64_t sks, int64_t svb,
    int64_t svh, int64_t svs, int window, float sm_scale) {
#define DENSE(HD, GG)                                                       \
  host_launch(B * KV, kThreads, [&] {                                       \
    decode_int8_kernel<HD, GG>(                                             \
        (const __nv_bfloat16*)q, (const int8_t*)kq, (const int8_t*)vq,      \
        (const float*)ks, (const float*)vs, (const int32_t*)lengths,        \
        (__nv_bfloat16*)out, KV, S, skb, skh, sks, svb, svh, svs, window,   \
        sm_scale);                                                          \
  })
  HD_G_SWITCH(DENSE)
}

extern "C" int host_paged_decode(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* pt, const void* lengths, void* out, int B,
    int KV, int G, int P, int ps, int MP, int hd, int64_t skp, int64_t sks,
    int64_t skh, int64_t svp, int64_t svs, int64_t svh, int window,
    float sm_scale) {
  const int shift = (ps & (ps - 1)) == 0 ? __builtin_ctz(ps) : -1;
#define PAGED(HD, GG)                                                       \
  host_launch(B * KV, kThreads, [&] {                                       \
    paged_decode_kernel<HD, GG>(                                            \
        (const __nv_bfloat16*)q, (const int8_t*)kp, (const int8_t*)vp,      \
        (const float*)ks, (const float*)vs, (const int32_t*)pt,             \
        (const int32_t*)lengths, (__nv_bfloat16*)out, KV, P, ps, shift, MP, \
        skp, sks, skh, svp, svs, svh, window, sm_scale);                    \
  })
  HD_G_SWITCH(PAGED)
}

extern "C" int host_paged_verify(
    const void* q, const void* kp, const void* vp, const void* ks,
    const void* vs, const void* pt, const void* base, void* out, int B,
    int KV, int G, int T, int P, int ps, int MP, int hd, int64_t skp,
    int64_t sks, int64_t skh, int64_t svp, int64_t svs, int64_t svh,
    int64_t qsb, int64_t qst, int64_t osb, int64_t ost, int window,
    float sm_scale) {
  const int pshift = (ps & (ps - 1)) == 0 ? __builtin_ctz(ps) : -1;
#define VERIFY_ARGS                                                         \
  (const __nv_bfloat16*)q, (const int8_t*)kp, (const int8_t*)vp,            \
      (const float*)ks, (const float*)vs, (const int32_t*)pt,               \
      (const int32_t*)base, (__nv_bfloat16*)out, KV, P, ps, pshift, MP,     \
      skp, sks, skh, svp, svs, svh, window, sm_scale, 1, qsb, qst, osb, ost
#define VERIFY(HD, GG)                                                      \
  host_launch(B * KV, T, kThreads, [&] {                                    \
    paged_verify_kernel<HD, GG>(VERIFY_ARGS);                               \
  })
  HD_G_SWITCH(VERIFY)
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel body for the CPU")
    d = tmp_path_factory.mktemp("int8_decode_host")
    (d / "glue.cpp").write_text(_GLUE)
    so = d / "int8_decode_host.so"
    done = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         f"-I{STUBS}", f"-I{CSRC}", "-o", str(so), str(d / "glue.cpp")],
        capture_output=True, text=True)
    if done.returncode != 0 and "barrier" in done.stderr:
        pytest.skip("g++ without C++20 <barrier>")
    assert done.returncode == 0, done.stderr
    lib = ctypes.CDLL(str(so))
    P_, I_, L_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.host_decode_int8.argtypes = [P_] * 7 + [I_] * 5 + [L_] * 6 + \
        [I_, ctypes.c_float]
    lib.host_paged_decode.argtypes = [P_] * 8 + [I_] * 7 + [L_] * 6 + \
        [I_, ctypes.c_float]
    lib.host_paged_verify.argtypes = [P_] * 8 + [I_] * 8 + [L_] * 10 + \
        [I_, ctypes.c_float]
    return lib


def _check(got, want):
    err = (got.float() - want.float()).abs().max().item()
    tol = 2 * 2.0 ** -8 * want.float().abs().max().item() + 1e-6
    assert err <= tol, (err, tol)


# (B, H, KV, hd, S, lens, window): chip_smoke's K3/K4 case table, the one
# the card checks (every (hd, G) instantiation, windows, whisper's shape, a
# window across a pass, caches of several rounds), cut to one kv head (G
# kept: one CTA a row, 128 threads each, so the CPU build stays light on
# the cores other tests share); plus a row of length 0 (zeros), which the
# card's table does not hold, with two kv heads
CASES = {
    **{name: (len(c["lens"]), c["H"] // c["KV"], 1, c.get("hd", 64), c["S"],
              c["lens"], c.get("window"))
       for name, c in INT8_CASES.items()},
    "empty_row": (2, 2, 2, 64, 161, [0, 5], None),
}


def _inputs(gen, B, H, KV, hd, lens):
    q = torch.randn((B, H, hd), generator=gen).to(torch.bfloat16)
    return q, torch.tensor(lens, dtype=torch.int32)


@pytest.mark.parametrize("name", sorted(CASES))
def test_dense_kernel_body_matches_plain(host_lib, name):
    """K3's body on (B, KV, S, hd) views of the pool's (B, S, KV, hd) codes,
    per-(b, h) scales; a length past S reads S positions."""
    B, H, KV, hd, S, lens, window = CASES[name]
    gen = torch.Generator().manual_seed(11)
    q, ln = _inputs(gen, B, H, KV, hd, lens)
    kq = torch.randint(-127, 128, (B, S, KV, hd), generator=gen,
                       dtype=torch.int8)
    vq = torch.randint(-127, 128, (B, S, KV, hd), generator=gen,
                       dtype=torch.int8)
    ks = torch.rand((B, KV), generator=gen) * 0.05 + 1e-3
    vs = torch.rand((B, KV), generator=gen) * 0.05 + 1e-3
    kh, vh = kq.transpose(1, 2), vq.transpose(1, 2)
    out = torch.empty_like(q)
    rc = host_lib.host_decode_int8(
        q.data_ptr(), kh.data_ptr(), vh.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), ln.data_ptr(), out.data_ptr(), B, KV, H // KV, S, hd,
        *kh.stride()[:3], *vh.stride()[:3], -1 if window is None else window,
        1 / math.sqrt(hd))
    assert rc == 0
    want = ref.decode_attention_int8_ref(q, kh, vh, ks, vs, ln, window=window)
    want[ln <= 0] = 0              # the kernel's zeros for an empty row
    _check(out, want)


def _paged(gen, B, KV, hd, ps, MP, lens):
    """An arena of stale random codes, per-page scales, and a table of
    distinct pages per stream (entries past a stream's last page 0)."""
    P = 1 + B * MP
    kp = torch.randint(-127, 128, (P, ps, KV, hd), generator=gen,
                       dtype=torch.int8)
    vp = torch.randint(-127, 128, (P, ps, KV, hd), generator=gen,
                       dtype=torch.int8)
    ks = torch.rand((P, KV), generator=gen) * 0.05 + 1e-3
    vs = torch.rand((P, KV), generator=gen) * 0.05 + 1e-3
    perm = (torch.randperm(P - 1, generator=gen) + 1).tolist()
    pt = torch.zeros((B, MP), dtype=torch.int32)
    for b, n in enumerate(lens):
        k = min(MP, -(-n // ps))
        pt[b, :k] = torch.tensor(perm[:k], dtype=torch.int32)
        perm = perm[k:]
    return P, kp, vp, ks, vs, pt


def _run_paged(lib, q, kp, vp, ks, vs, pt, ln, window):
    B, H, hd = q.shape
    P, ps, KV, _ = kp.shape
    out = torch.empty_like(q)
    rc = lib.host_paged_decode(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), pt.data_ptr(), ln.data_ptr(), out.data_ptr(), B, KV,
        H // KV, P, ps, pt.shape[1], hd, kp.stride(0), kp.stride(1),
        kp.stride(2), vp.stride(0), vp.stride(1), vp.stride(2),
        -1 if window is None else window, 1 / math.sqrt(hd))
    assert rc == 0
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_paged_kernel_body_matches_plain(host_lib, name):
    """K4's body through a table of pages of 16 (a shift), the arena in the
    model layout (P, ps, KV, hd), per-(page, h) scales."""
    B, H, KV, hd, S, lens, window = CASES[name]
    gen = torch.Generator().manual_seed(12)
    q, ln = _inputs(gen, B, H, KV, hd, lens)
    MP = -(-S // 16)
    _, kp, vp, ks, vs, pt = _paged(gen, B, KV, hd, 16, MP, lens)
    out = _run_paged(host_lib, q, kp, vp, ks, vs, pt, ln, window)
    want = ref.paged_decode_attention_ref(q, kp.transpose(1, 2),
                                          vp.transpose(1, 2), ks, vs, pt, ln,
                                          window=window)
    want[ln <= 0] = 0
    _check(out, want)


@pytest.mark.parametrize("ps,lens,window", [(12, [120, 7, 61], 50),
                                            (8, [200, 3, 40], None)])
def test_paged_kernel_body_page_sizes(host_lib, ps, lens, window):
    """A page size that is no power of two (the lookup divides) and one
    whose table a length overruns (positions past MP * ps are not read)."""
    gen = torch.Generator().manual_seed(13)
    B, H, KV, hd, MP = len(lens), 8, 4, 64, 10
    q, ln = _inputs(gen, B, H, KV, hd, lens)
    _, kp, vp, ks, vs, pt = _paged(gen, B, KV, hd, ps, MP, lens)
    out = _run_paged(host_lib, q, kp, vp, ks, vs, pt, ln, window)
    want = ref.paged_decode_attention_ref(q, kp.transpose(1, 2),
                                          vp.transpose(1, 2), ks, vs, pt,
                                          ln.clamp(max=MP * ps), window=window)
    _check(out, want)


def test_paged_kernel_body_masks_entries_outside_the_arena(host_lib):
    """Table entries -1 and P are never dereferenced: their positions are
    masked, as if the stream did not hold them."""
    gen = torch.Generator().manual_seed(14)
    B, H, KV, hd, ps, MP = 3, 4, 2, 64, 16, 11
    lens = [176, 40, 100]
    q, ln = _inputs(gen, B, H, KV, hd, lens)
    P, kp, vp, ks, vs, pt = _paged(gen, B, KV, hd, ps, MP, lens)
    pt[0, 0], pt[1, 1], pt[2, 6] = -1, P, 10 ** 6
    out = _run_paged(host_lib, q, kp, vp, ks, vs, pt, ln, None)
    # the plain version on the arena with those pages' positions masked
    pos = torch.arange(MP * ps)
    page = pt.long()[:, pos // ps]                           # (B, MP * ps)
    keep = (page >= 0) & (page < P) & (pos[None] < ln[:, None])
    safe = page.clamp(0, P - 1)
    k = kp[safe, pos % ps].float() * ks[safe][..., None]    # (B, S, KV, hd)
    v = vp[safe, pos % ps].float() * vs[safe][..., None]
    qf = q.float().view(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k) / math.sqrt(hd)
    s = s.masked_fill(~keep[:, None, None], float("-inf"))
    want = torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, -1), v)
    _check(out, want.reshape(B, H, hd).to(torch.bfloat16))


def _verify_arena(gen, B, KV, hd, ps, MP, T, base):
    """An arena of stale random codes, per-page scales, and a table of
    distinct pages covering each stream's base + T positions (entries past
    them 0; streams 2 and 3 share their first two pages when both hold
    two)."""
    P = 1 + B * MP
    kp = torch.randint(-127, 128, (P, ps, KV, hd), generator=gen,
                       dtype=torch.int8)
    vp = torch.randint(-127, 128, (P, ps, KV, hd), generator=gen,
                       dtype=torch.int8)
    ks = torch.rand((P, KV), generator=gen) * 0.05 + 1e-3
    vs = torch.rand((P, KV), generator=gen) * 0.05 + 1e-3
    perm = (torch.randperm(P - 1, generator=gen) + 1).tolist()
    pt = torch.zeros((B, MP), dtype=torch.int32)
    npg = [min(MP, -(-(n + T) // ps)) for n in base]
    for b, k in enumerate(npg):
        pt[b, :k] = torch.tensor(perm[:k], dtype=torch.int32)
        perm = perm[k:]
    if B > 3 and min(npg[2], npg[3]) >= 2:
        pt[3, :2] = pt[2, :2]
    return P, kp, vp, ks, vs, pt


def _run_verify(lib, q, kp, vp, ks, vs, pt, base, window):
    """The verify kernel body, one launch for the window, one CTA a
    position."""
    B, T, H, hd = q.shape
    P, ps, KV, _ = kp.shape
    out = torch.empty_like(q)
    rc = lib.host_paged_verify(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), pt.data_ptr(), base.data_ptr(), out.data_ptr(), B, KV,
        H // KV, T, P, ps, pt.shape[1], hd, *kp.stride()[:3],
        *vp.stride()[:3], q.stride(0), q.stride(1), out.stride(0),
        out.stride(1), -1 if window is None else window, 1 / math.sqrt(hd))
    assert rc == 0
    return out


def _per_position_k4(lib, q, kp, vp, ks, vs, pt, base, window):
    """K4's body at each window position's length."""
    return torch.stack([_run_paged(lib, q[:, j].contiguous(), kp, vp, ks, vs,
                                   pt, base + j + 1, window)
                        for j in range(q.shape[1])], dim=1)


@pytest.mark.parametrize("name", sorted(VERIFY_CASES))
def test_verify_kernel_body_matches_plain(host_lib, name):
    """The verify window's body at chip_smoke's cases, cut to one kv head
    (G kept), against T single-token plain reads at the successive
    lengths base + j + 1, each position equal to K4's body at its length
    bit for bit (the lean register form against K4's)."""
    c = VERIFY_CASES[name]
    G, T, MP, hd = c["H"] // c["KV"], c["T"], c["MP"], c.get("hd", 64)
    base, window = c["base"], c.get("window")
    B = len(base)
    gen = torch.Generator().manual_seed(15)
    q = torch.randn((B, T, G, hd), generator=gen).to(torch.bfloat16)
    P, kp, vp, ks, vs, pt = _verify_arena(gen, B, 1, hd, 16, MP, T, base)
    bl = torch.tensor(base, dtype=torch.int32)
    want = ref.paged_verify_attention_ref(q, kp.transpose(1, 2),
                                          vp.transpose(1, 2), ks, vs, pt, bl,
                                          window=window)
    k4 = _per_position_k4(host_lib, q, kp, vp, ks, vs, pt, bl, window)
    out = _run_verify(host_lib, q, kp, vp, ks, vs, pt, bl, window)
    _check(out, want)
    assert torch.equal(out, k4)


def test_verify_kernel_body_page_size_and_outside_entries(host_lib):
    """A page size that is no power of two (the lookup divides), a window
    whose positions run past the table (read up to MP * ps only) and a
    table entry outside the arena (its positions masked)."""
    gen = torch.Generator().manual_seed(16)
    B, H, KV, hd, ps, MP, T = 3, 4, 2, 64, 12, 6, 5
    base = [20, 0, 69]                          # row 2 runs past 72
    q = torch.randn((B, T, H, hd), generator=gen).to(torch.bfloat16)
    P, kp, vp, ks, vs, pt = _verify_arena(gen, B, KV, hd, ps, MP, T, base)
    bl = torch.tensor(base, dtype=torch.int32)
    want = ref.paged_verify_attention_ref(q, kp.transpose(1, 2),
                                          vp.transpose(1, 2), ks, vs, pt, bl,
                                          window=30)
    out = _run_verify(host_lib, q, kp, vp, ks, vs, pt, bl, 30)
    _check(out, want)
    pt[1, 0] = P                                 # never dereferenced
    k4 = _per_position_k4(host_lib, q, kp, vp, ks, vs, pt, bl, None)
    out = _run_verify(host_lib, q, kp, vp, ks, vs, pt, bl, None)
    assert torch.isfinite(out.float()).all()
    # row 1's first position sees only position 0, on the masked page: no
    # valid position, zeros
    assert (out[1, 0].float() == 0).all()
    assert torch.equal(out, k4)

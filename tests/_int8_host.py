"""Shared by the host tests of the int8 flash-decode kernels' CUDA bodies
(``tests/test_torch_int8_decode_host.py``: K3's dense bodies;
``tests/test_torch_int8_paged_host.py``: K4; ``tests/test_torch_int8_
verify_host.py``: the verify window; ``tests/test_torch_int8_split_host.py``:
K3's split body, its merge and the stand-ins of its primitives): the g++
glue around ``csrc/int8_decode.cuh`` and ``csrc/int8_split_decode.cuh``,
the build of a host library against ``tests/cuda_host/`` (one std::thread
per CUDA thread, a warp barrier per exchange), the case tables and the
helpers that make inputs and run the bodies. pytest does not collect this
module (no ``test_`` prefix).

The case tables are chip_smoke's, the ones the card checks, cut to one kv
head (G kept: one CTA a row, 128 threads each, so the CPU build stays light
on the cores other tests share). Tolerance: two bf16 ulps of the largest
output, as on the card (both sides accumulate in f32, in another order, and
round to bf16)."""
import ctypes
import math
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
STUBS = Path(__file__).resolve().parent / "cuda_host"

sys.path.insert(0, str(ROOT))
from chip_smoke import INT8_CASES, VERIFY_CASES  # noqa: E402,F401

_HEAD = r"""
#include "int8_split_decode.cuh"
namespace int8_decode {
alignas(16) unsigned char int8_decode_smem[1 << 18];
}
using namespace int8_decode;

#define HD_G_SWITCH(CALL)                                   \
  switch (hd * 16 + G) {                                    \
    case 32 * 16 + 1: CALL(32, 1); break;                 \
    case 32 * 16 + 2: CALL(32, 2); break;                 \
    case 32 * 16 + 4: CALL(32, 4); break;                 \
    case 32 * 16 + 6: CALL(32, 6); break;                 \
    case 32 * 16 + 7: CALL(32, 7); break;                 \
    case 32 * 16 + 8: CALL(32, 8); break;                 \
    case 64 * 16 + 1: CALL(64, 1); break;                 \
    case 64 * 16 + 2: CALL(64, 2); break;                 \
    case 64 * 16 + 4: CALL(64, 4); break;                 \
    case 64 * 16 + 6: CALL(64, 6); break;                 \
    case 64 * 16 + 7: CALL(64, 7); break;                 \
    case 64 * 16 + 8: CALL(64, 8); break;                 \
    case 80 * 16 + 1: CALL(80, 1); break;                 \
    case 80 * 16 + 2: CALL(80, 2); break;                 \
    case 80 * 16 + 4: CALL(80, 4); break;                 \
    case 80 * 16 + 6: CALL(80, 6); break;                 \
    case 80 * 16 + 7: CALL(80, 7); break;                 \
    case 80 * 16 + 8: CALL(80, 8); break;                 \
    case 128 * 16 + 1: CALL(128, 1); break;               \
    case 128 * 16 + 2: CALL(128, 2); break;               \
    case 128 * 16 + 4: CALL(128, 4); break;               \
    case 128 * 16 + 6: CALL(128, 6); break;               \
    case 128 * 16 + 7: CALL(128, 7); break;               \
    case 128 * 16 + 8: CALL(128, 8); break;               \
    default: return 1;                                      \
  }                                                         \
  return 0;
"""

# the one-CTA body (K3 without the log-sum-exp epilogue)
_DENSE = r"""
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
"""

# the split body and, for nsplit > 1, the merge (as decode_attention_int8.cu
# launches them); lse null: the bf16 output, else f32 out_f32 and lse
_SPLIT = r"""
extern "C" int host_decode_int8_split(
    const void* q, const void* kq, const void* vq, const void* ks,
    const void* vs, const void* lengths, void* out, void* out_f32,
    void* lse, void* work, int B, int KV, int G, int S, int hd, int nsplit,
    int64_t skb, int64_t skh, int64_t sks, int64_t svb, int64_t svh,
    int64_t svs, int window, int key_offset, float sm_scale) {
  float* part_o = (float*)work;
  float* part_ml = part_o + (int64_t)B * KV * nsplit * G * hd;
#define SPLIT(HD, GG)                                                       \
  host_launch(B * KV * nsplit, kThreads, [&] {                              \
    decode_int8_split_kernel<HD, GG>(                                       \
        (const __nv_bfloat16*)q, (const int8_t*)kq, (const int8_t*)vq,      \
        (const float*)ks, (const float*)vs, (const int32_t*)lengths,        \
        (__nv_bfloat16*)out, KV, S, skb, skh, sks, svb, svh, svs, window,   \
        sm_scale, key_offset, (float*)out_f32, (float*)lse, nsplit,         \
        part_o, part_ml);                                                   \
  });                                                                       \
  if (nsplit > 1)                                                           \
    host_launch(B * KV * GG, HD, [&] {                                      \
      merge_kernel(part_o, part_ml, (__nv_bfloat16*)out, (float*)out_f32,   \
                   (float*)lse, GG, HD, nsplit);                            \
    })
  HD_G_SWITCH(SPLIT)
}

// one warp of the mma.sync stand-in: d (16 x 8 f32) = a (16 x 16 f16
// bits, row-major) b (16 x 8 f16 bits, row-major k x n) + c, each lane's
// fragments gathered by the PTX ISA's layout
extern "C" void host_mma_f16(const uint16_t* a, const uint16_t* b,
                             const float* c, float* d) {
  host_launch(1, 32, [&] {
    const int l = threadIdx.x, g = l / 4, t = l % 4;
    auto two = [](uint16_t lo, uint16_t hi) { return uint32_t(lo) | (uint32_t(hi) << 16); };
    const uint32_t fa[4] = {
        two(a[g * 16 + 2 * t], a[g * 16 + 2 * t + 1]),
        two(a[(g + 8) * 16 + 2 * t], a[(g + 8) * 16 + 2 * t + 1]),
        two(a[g * 16 + 2 * t + 8], a[g * 16 + 2 * t + 9]),
        two(a[(g + 8) * 16 + 2 * t + 8], a[(g + 8) * 16 + 2 * t + 9])};
    const uint32_t b0 = two(b[(2 * t) * 8 + g], b[(2 * t + 1) * 8 + g]);
    const uint32_t b1 = two(b[(2 * t + 8) * 8 + g], b[(2 * t + 9) * 8 + g]);
    float acc[4] = {c[g * 8 + 2 * t], c[g * 8 + 2 * t + 1],
                    c[(g + 8) * 8 + 2 * t], c[(g + 8) * 8 + 2 * t + 1]};
    mma_f16_16816(acc, fa, b0, b1);
    d[g * 8 + 2 * t] = acc[0];
    d[g * 8 + 2 * t + 1] = acc[1];
    d[(g + 8) * 8 + 2 * t] = acc[2];
    d[(g + 8) * 8 + 2 * t + 1] = acc[3];
  });
}

// the f16 helpers of the split body on n words: codes_f16x2 of each byte
// pair (out 2n words), f16x2_pack of n float pairs (out n words)
extern "C" void host_codes_f16(const uint32_t* x, uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) {
    out[2 * i] = codes_f16x2<0>(x[i] ^ 0x80808080u);
    out[2 * i + 1] = codes_f16x2<2>(x[i] ^ 0x80808080u);
  }
}
extern "C" void host_pack_f16(const float* f, uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) out[i] = f16x2_pack(f[2 * i], f[2 * i + 1]);
}

// cp.async's stand-in: one thread copies n 16-byte chunks of src to dst
// in groups of `group`, committing each, then waits with wait_group<1>
// (ready[0]: how many chunks of dst equal src then) and wait_group<0>
// (ready[1])
extern "C" void host_cp_async(const unsigned char* src, unsigned char* dst,
                              int n, int group, int* ready) {
  host_launch(1, 1, [&] {
    for (int i = 0; i < n; ++i) {
      cp_async16(dst + 16 * i, src + 16 * i);
      if ((i + 1) % group == 0 || i + 1 == n) cp_async_commit();
    }
    auto landed = [&] {
      int k = 0;
      for (int i = 0; i < n; ++i) k += std::memcmp(dst + 16 * i, src + 16 * i, 16) == 0;
      return k;
    };
    cp_async_wait<1>();
    ready[0] = landed();
    cp_async_wait<0>();
    ready[1] = landed();
  });
}
"""

# the paged body (K4)
_PAGED = r"""
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
"""

# the verify window (its K4 comparisons need _PAGED too)
_VERIFY = r"""
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

_PARTS = {"dense": _DENSE, "split": _SPLIT, "paged": _PAGED,
          "verify": _VERIFY}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_ARGTYPES = {
    "dense": {"host_decode_int8": [_P] * 7 + [_I] * 5 + [_L] * 6 + [_I, _F]},
    "split": {"host_decode_int8_split":
              [_P] * 10 + [_I] * 6 + [_L] * 6 + [_I, _I, _F],
              "host_mma_f16": [_P] * 4,
              "host_codes_f16": [_P, _P, _I],
              "host_pack_f16": [_P, _P, _I],
              "host_cp_async": [_P, _P, _I, _I, _P]},
    "paged": {"host_paged_decode": [_P] * 8 + [_I] * 7 + [_L] * 6 + [_I, _F]},
    "verify": {"host_paged_verify":
               [_P] * 8 + [_I] * 8 + [_L] * 10 + [_I, _F]},
}


def build(tmp_path_factory, parts):
    """Compile the glue of ``parts`` (keys of ``_PARTS``) into a host
    library and load it (skips where g++ with C++20 is missing)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel body for the CPU")
    d = tmp_path_factory.mktemp("int8_host_" + "_".join(parts))
    (d / "glue.cpp").write_text(_HEAD + "".join(_PARTS[p] for p in parts))
    so = d / "int8_host.so"
    done = subprocess.run(
        [gxx, "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread",
         f"-I{STUBS}", f"-I{CSRC}", "-o", str(so), str(d / "glue.cpp")],
        capture_output=True, text=True)
    if done.returncode != 0 and "barrier" in done.stderr:
        pytest.skip("g++ without C++20 <barrier>")
    assert done.returncode == 0, done.stderr
    lib = ctypes.CDLL(str(so))
    for p in parts:
        for fn, types in _ARGTYPES[p].items():
            getattr(lib, fn).argtypes = types
    return lib


def check(got, want):
    """Within two bf16 ulps of the largest output."""
    err = (got.float() - want.float()).abs().max().item()
    tol = 2 * 2.0 ** -8 * want.float().abs().max().item() + 1e-6
    assert err <= tol, (err, tol)


# (B, H, KV, hd, S, lens, window, card KV): chip_smoke's K3/K4 case table
# (every (hd, G) instantiation, windows, whisper's shape, a window across a
# pass, caches of several rounds), cut to one kv head, and the card's kv
# heads (the split plan is the card's); plus a row of length 0 (zeros),
# which the card's table does not hold, with two kv heads
CASES = {
    **{name: (len(c["lens"]), c["H"] // c["KV"], 1, c.get("hd", 64), c["S"],
              c["lens"], c.get("window"), c["KV"])
       for name, c in INT8_CASES.items()},
    "empty_row": (2, 2, 2, 64, 161, [0, 5], None, 2),
}


def inputs(gen, B, H, KV, hd, lens):
    q = torch.randn((B, H, hd), generator=gen).to(torch.bfloat16)
    return q, torch.tensor(lens, dtype=torch.int32)


def dense_cache(gen, B, S, KV, hd):
    """int8 codes (B, S, KV, hd) of K and V and per-(b, h) scales."""
    kq = torch.randint(-127, 128, (B, S, KV, hd), generator=gen,
                       dtype=torch.int8)
    vq = torch.randint(-127, 128, (B, S, KV, hd), generator=gen,
                       dtype=torch.int8)
    ks = torch.rand((B, KV), generator=gen) * 0.05 + 1e-3
    vs = torch.rand((B, KV), generator=gen) * 0.05 + 1e-3
    return kq, vq, ks, vs


def run_split(lib, q, kh, vh, ks, vs, ln, window, nsplit, key_offset=0,
              return_lse=False):
    """The split body (and the merge for nsplit > 1) on (B, KV, S, hd)
    views: the bf16 output, or (o f32, lse) with ``return_lse``."""
    B, H, hd = q.shape
    _, KV, S, _ = kh.shape
    G = H // KV
    out = torch.empty_like(q)
    o = torch.empty((B, H, hd)) if return_lse else None
    lse = torch.empty((B, H)) if return_lse else None
    work = torch.empty(max(1, B * KV * nsplit * G * (hd + 2)))
    rc = lib.host_decode_int8_split(
        q.data_ptr(), kh.data_ptr(), vh.data_ptr(), ks.data_ptr(),
        vs.data_ptr(), ln.data_ptr(), out.data_ptr(),
        None if o is None else o.data_ptr(),
        None if lse is None else lse.data_ptr(), work.data_ptr(), B, KV, G,
        S, hd, nsplit, *kh.stride()[:3], *vh.stride()[:3],
        -1 if window is None else window, key_offset, 1 / math.sqrt(hd))
    assert rc == 0
    return (o, lse) if return_lse else out


def paged_arena(gen, B, KV, hd, ps, MP, lens):
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


def run_paged(lib, q, kp, vp, ks, vs, pt, ln, window):
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


def verify_arena(gen, B, KV, hd, ps, MP, T, base):
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


def run_verify(lib, q, kp, vp, ks, vs, pt, base, window):
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


def per_position_k4(lib, q, kp, vp, ks, vs, pt, base, window):
    """K4's body at each window position's length."""
    return torch.stack([run_paged(lib, q[:, j].contiguous(), kp, vp, ks, vs,
                                  pt, base + j + 1, window)
                        for j in range(q.shape[1])], dim=1)

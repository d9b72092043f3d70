"""K3's body on the pieces of a dense int8 cache split over its sequence
(``csrc/int8_decode.cuh``: ``decode_int8_kernel<HD, G, true>``, a key
offset and the log-sum-exp epilogue) compiled by g++ for the CPU against
the stand-in headers in ``tests/cuda_host/``, as
``tests/test_torch_int8_decode_host.py`` compiles the whole cache's
kernels, and held against the plain version ``kernels.ref.
decode_attention_int8_ref`` with ``key_offset`` and ``return_lse``. This
checks the piece's range (a window across pieces, pieces past the length,
several rounds of passes a piece) and the epilogue where no GPU or nvcc is.

Tolerances: a piece's f32 output within 1e-5 of its largest value and its
log-sum-exp within 1e-4 of the plain version's (f32 on both sides, summed
in another order); the pieces merged (``merge_partials``) within two bf16
ulps of the whole cache's bf16 call, as on the card; the whole cache with
the epilogue at offset 0 exactly the call without it once rounded to bf16.
Skipped where g++ with C++20 is missing."""
import ctypes
import math
import shutil
import subprocess
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models.attention import merge_partials  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
STUBS = Path(__file__).resolve().parent / "cuda_host"

_GLUE = r"""
#include "int8_decode.cuh"
namespace int8_decode {
alignas(16) unsigned char int8_decode_smem[1 << 18];
}
using namespace int8_decode;

// K3 on a piece: lse null runs the bf16 body, else the f32 and lse one
extern "C" int host_decode_int8_piece(
    const void* q, const void* kq, const void* vq, const void* ks,
    const void* vs, const void* lengths, void* out, void* out_f32,
    void* lse, int B, int KV, int G, int S, int hd, int64_t skb,
    int64_t skh, int64_t sks, int64_t svb, int64_t svh, int64_t svs,
    int window, int key_offset, float sm_scale) {
#define PIECE(HD, GG)                                                       \
  host_launch(B * KV, kThreads, [&] {                                       \
    if (lse != nullptr)                                                     \
      decode_int8_kernel<HD, GG, true>(                                     \
          (const __nv_bfloat16*)q, (const int8_t*)kq, (const int8_t*)vq,    \
          (const float*)ks, (const float*)vs, (const int32_t*)lengths,      \
          nullptr, KV, S, skb, skh, sks, svb, svh, svs, window, sm_scale,   \
          key_offset, (float*)out_f32, (float*)lse);                        \
    else                                                                    \
      decode_int8_kernel<HD, GG>(                                           \
          (const __nv_bfloat16*)q, (const int8_t*)kq, (const int8_t*)vq,    \
          (const float*)ks, (const float*)vs, (const int32_t*)lengths,      \
          (__nv_bfloat16*)out, KV, S, skb, skh, sks, svb, svh, svs, window, \
          sm_scale, key_offset);                                            \
  })
  switch (hd * 16 + G) {
    case 64 * 16 + 1: PIECE(64, 1); break;
    case 80 * 16 + 4: PIECE(80, 4); break;
    case 128 * 16 + 4: PIECE(128, 4); break;
    default: return 1;
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel body for the CPU")
    d = tmp_path_factory.mktemp("int8_piece_host")
    (d / "glue.cpp").write_text(_GLUE)
    so = d / "int8_piece_host.so"
    done = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         f"-I{STUBS}", f"-I{CSRC}", "-o", str(so), str(d / "glue.cpp")],
        capture_output=True, text=True)
    if done.returncode != 0 and "barrier" in done.stderr:
        pytest.skip("g++ without C++20 <barrier>")
    assert done.returncode == 0, done.stderr
    lib = ctypes.CDLL(str(so))
    P_, I_, L_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.host_decode_int8_piece.argtypes = [P_] * 9 + [I_] * 5 + [L_] * 6 + \
        [I_, I_, ctypes.c_float]
    return lib


# (G, hd, S, pieces, lens, window), one kv head: a window across pieces
# (the first pieces wholly before it), lengths that leave later pieces
# empty, h2o-danube's (hd 80, G 4: two rounds of passes in a 64-position
# piece) and a G 4 hd 128 shape
PIECE_CASES = {
    "g1_window": (1, 64, 128, 4, [128, 1, 60, 70], 40),
    "h2o": (4, 80, 256, 4, [256, 150, 64, 65], 90),
    "g4_hd128": (4, 128, 192, 2, [192, 1, 96, 130], None),
}


@pytest.mark.parametrize("name", sorted(PIECE_CASES))
def test_dense_kernel_body_pieces_with_offset_and_lse(host_lib, name):
    """K3's body on each piece of a split cache, at its key offset, with
    the log-sum-exp epilogue: each piece's (o, lse) against the plain
    version's; a piece without a valid key o = 0 and lse = -inf; the
    pieces merged within two bf16 ulps of the whole cache's call; the
    whole cache with the epilogue at offset 0 rounds to the bits of the
    call without it."""
    G, hd, S, npieces, lens, window = PIECE_CASES[name]
    B, KV = len(lens), 1
    gen = torch.Generator().manual_seed(17)
    q = torch.randn((B, G, hd), generator=gen).to(torch.bfloat16)
    ln = torch.tensor(lens, dtype=torch.int32)
    kq = torch.randint(-127, 128, (B, S, KV, hd), generator=gen,
                       dtype=torch.int8)
    vq = torch.randint(-127, 128, (B, S, KV, hd), generator=gen,
                       dtype=torch.int8)
    ks = torch.rand((B, KV), generator=gen) * 0.05 + 1e-3
    vs = torch.rand((B, KV), generator=gen) * 0.05 + 1e-3
    w = -1 if window is None else window

    def run(lo, hi, lse_out):
        kh = kq[:, lo:hi].transpose(1, 2)
        vh = vq[:, lo:hi].transpose(1, 2)
        out = torch.empty_like(q)
        o = torch.empty((B, G, hd))
        lse = torch.empty((B, G))
        assert host_lib.host_decode_int8_piece(
            q.data_ptr(), kh.data_ptr(), vh.data_ptr(), ks.data_ptr(),
            vs.data_ptr(), ln.data_ptr(), out.data_ptr(), o.data_ptr(),
            lse.data_ptr() if lse_out else None, B, KV, G, hi - lo, hd,
            *kh.stride()[:3], *vh.stride()[:3], w, lo,
            1 / math.sqrt(hd)) == 0
        return (o, lse) if lse_out else out

    def piece(lo, hi):
        o, lse = run(lo, hi, True)
        want_o, want_lse = ref.decode_attention_int8_ref(
            q, kq[:, lo:hi].transpose(1, 2), vq[:, lo:hi].transpose(1, 2),
            ks, vs, ln, window=window, key_offset=lo, return_lse=True)
        assert (o - want_o).abs().max() <= 1e-5 * want_o.abs().max() + 1e-7
        fin = torch.isfinite(want_lse)
        assert torch.equal(fin, torch.isfinite(lse))
        assert ((lse - want_lse).abs()[fin] <= 1e-4).all()
        assert (o[~fin] == 0).all() and torch.isneginf(lse[~fin]).all()
        return o, lse

    n = S // npieces
    parts = [piece(i * n, (i + 1) * n) for i in range(npieces)]
    assert any(not torch.isfinite(p[1]).all() for p in parts)
    merged, _ = merge_partials(torch.stack([p[0] for p in parts]),
                               torch.stack([p[1] for p in parts]))
    whole, _ = piece(0, S)
    out = run(0, S, False)
    assert torch.equal(whole.to(torch.bfloat16), out)
    err = (merged.to(torch.bfloat16).float() - out.float()).abs().max()
    assert err <= 2 * 2.0 ** -8 * out.float().abs().max() + 1e-6

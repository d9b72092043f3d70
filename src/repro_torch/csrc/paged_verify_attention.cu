// The speculative verify window against the paged int8 KV arena, for Hopper
// (sm_90a): K4 extended from one query position to T.
//
// Replaces the TPU kernel path of
// src/repro/kernels/ops.py::paged_verify_attention (:132), whose Pallas
// backend unrolls T single-token calls of
// src/repro/kernels/paged_decode_attention.py::paged_decode_attention
// (pl.pallas_call at :122) and whose XLA backend gathers the pages once for
// all T positions. Same function: for every (batch row b, kv head h) the G =
// H / KV query heads of each window position j attend the int8 keys/values
// of positions [max(0, len_j - window), len_j), len_j = base_len + j + 1,
// through row b of the page table, dequantized with the (page, kv head)
// scales; softmax in f32; output in q's dtype, (B, T, H, hd). A row with no
// valid position gives zeros; a table entry outside [0, P) is never
// dereferenced.
//
// What bounds it: as K4 (int8_decode.cuh), not the bytes of the pages (a
// few MB, about a microsecond at 3.35 TB/s) but the chain of dependent
// round trips (length and table, then the K/V rows) and the instructions:
// K4's lane layout at G = 1 converts every int8 code and runs its FMAs once
// per window position, so T positions issue T times K4's instructions.
// The design keeps K4's arithmetic per position, bit for bit, and runs the
// positions at once: one CTA per (row, kv head, position), each running
// K4's body at its position's length on the arena (L2 serves the rows the
// positions share; device memory is read about once). The body runs lean
// (int8_decode.cuh, attend<..., kLean>): no round read ahead, a round's K
// words and then its V words loaded in two batches each, and passes wholly
// past a position's range skipped, which takes the hd 64, G 1 body from
// K4's 245 registers to 80, six CTAs an SM instead of two. Every position
// runs K4's lane layout, passes, rounds and merge at its length, so its
// output is bit-identical to a K4 call's: the speculative engine's
// attention is the plain engine's, to the bit. (One walk with the G * T
// rows as one group of heads would convert each code once, but needs
// another lane layout than K4's at G = 1, whose accumulators do not fit
// T-fold; that layout rounds differently, and a 24-layer stack amplifies
// its one-ulp differences into other greedy tokens: PERF.md.)

#include "int8_decode.cuh"

namespace {

using namespace int8_decode;

struct Args {
  const void *q, *kp, *vp, *ks, *vs, *ptab, *lengths;
  void* out;
  int B, KV, P, ps, MP;
  int64_t skp, sks, skh, svp, svs, svh;
  int window;
  float sm_scale;
  int T;
  int64_t qsb, qst, osb, ost;
  cudaStream_t stream;
};

template <int HD, int G>
cudaError_t launch(const Args& a) {
  // the merge and the staged table row and scales (12 bytes a table
  // entry): past 48 KB the kernel must opt in
  const size_t dyn = smem_bytes<HD, G>(a.MP);
  if (dyn > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_verify_kernel<HD, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (err != cudaSuccess) return err;
  }
  int ps_shift = -1;
  if ((a.ps & (a.ps - 1)) == 0)
    for (ps_shift = 0; (1 << ps_shift) < a.ps; ++ps_shift) {}
  // window position j at length base_len + 1 + j: lead 1
  paged_verify_kernel<HD, G><<<dim3(a.B * a.KV, a.T), kThreads, dyn, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const int8_t*>(a.kp),
      static_cast<const int8_t*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int32_t*>(a.ptab),
      static_cast<const int32_t*>(a.lengths),
      static_cast<__nv_bfloat16*>(a.out), a.KV, a.P, a.ps, ps_shift, a.MP,
      a.skp, a.sks, a.skh, a.svp, a.svs, a.svh, a.window, a.sm_scale, 1,
      a.qsb, a.qst, a.osb, a.ost);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_g(int G, const Args& a) {
  switch (G) {
    case 1: return launch<HD, 1>(a);
    case 2: return launch<HD, 2>(a);
    case 4: return launch<HD, 4>(a);
    case 6: return launch<HD, 6>(a);
    case 7: return launch<HD, 7>(a);
    case 8: return launch<HD, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, T, KV * G, hd) bf16 through element strides qsb (row) and qst
// (window position), unit head and hd strides, every query row 16-byte
// aligned; kp/vp int8 arenas addressed as (P, ps, KV, hd) through the
// element strides s*p, s*s, s*h (hd stride 1, rows 16-byte aligned);
// k_scale/v_scale (P, KV) f32 contiguous; page_table (B, MP) int32
// contiguous; base_len (B,) int32: window position j attends base_len + j
// + 1 positions; out (B, T, KV * G, hd) through osb, ost. window <= 0 means
// no window. Returns a cudaError_t (0 on success).
extern "C" int paged_verify_launch(const void* q, const void* kp, const void* vp,
                                   const void* k_scale, const void* v_scale,
                                   const void* page_table, const void* base_len,
                                   void* out, int B, int KV, int G, int T,
                                   int P, int ps, int MP, int hd, int64_t skp,
                                   int64_t sks, int64_t skh, int64_t svp,
                                   int64_t svs, int64_t svh, int64_t qsb,
                                   int64_t qst, int64_t osb, int64_t ost,
                                   int window, float sm_scale, void* stream) {
  if (ps <= 0 || MP < 0 || T <= 0) return cudaErrorInvalidValue;
  const Args a{q, kp, vp, k_scale, v_scale, page_table, base_len, out,
               B, KV, P, ps, MP, skp, sks, skh, svp, svs, svh, window,
               sm_scale, T, qsb, qst, osb, ost,
               static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 32:  return launch_g<32>(G, a);
    case 64:  return launch_g<64>(G, a);
    case 80:  return launch_g<80>(G, a);
    case 128: return launch_g<128>(G, a);
    default:  return cudaErrorInvalidValue;
  }
}

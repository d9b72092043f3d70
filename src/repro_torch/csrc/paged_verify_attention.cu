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
// What bounds it: as K4 (int8_decode.cuh), not the bytes of the pages but
// the chain of dependent round trips (length and table, then the K/V rows)
// and the instructions per code, now for T positions. The design: one CTA
// per (row, kv head) reads its table row once, copies the int8 K/V rows of
// the union of the T positions' ranges from the arena into shared memory
// ONCE, with the T positions' query rows (16 bytes a thread, all in flight
// together), then runs K4's body for
// each window position in turn on the staged rows, at that position's own
// length (paged_verify_kernel in int8_decode.cuh). So a verify step reads a
// stream's pages from device memory once, where T unrolled K4 launches read
// them T times and pay T launch latencies; and since every position runs
// K4's lane layout, passes, rounds and merge at its length, its output is
// bit-identical to a K4 call's: the speculative engine's attention is the
// plain engine's, to the bit. (Walking once with the G * T rows as one
// group of heads would need another lane layout than K4's at G = 1, whose
// accumulators do not fit T-fold; that layout rounds differently, and on an
// H100 a 24-layer random-weight stack amplified its one-ulp differences to
// 0.36 relative L2 of the logits.)
// Staging needs 2 * hd bytes a position of the union (26 KB at stablelm's
// 208 positions, hd 64); where that exceeds the card's shared memory a
// block, each position walks the arena itself (the Paged source; L1/L2
// serve the repeats).

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

template <int HD, int G, bool kStaged>
cudaError_t launch_kernel(const Args& a, int ps_shift, int span, size_t dyn) {
  if (dyn > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_verify_kernel<HD, G, kStaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dyn));
    if (err != cudaSuccess) return err;
  }
  paged_verify_kernel<HD, G, kStaged><<<a.B * a.KV, kThreads, dyn, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const int8_t*>(a.kp),
      static_cast<const int8_t*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int32_t*>(a.ptab),
      static_cast<const int32_t*>(a.lengths),
      static_cast<__nv_bfloat16*>(a.out), a.KV, a.P, a.ps, ps_shift, a.MP,
      a.skp, a.sks, a.skh, a.svp, a.svs, a.svh, a.window, a.sm_scale, a.T, 1,
      span, a.qsb, a.qst, a.osb, a.ost);
  return cudaGetLastError();
}

template <int HD, int G>
cudaError_t launch(const Args& a) {
  int ps_shift = -1;
  if ((a.ps & (a.ps - 1)) == 0)
    for (ps_shift = 0; (1 << ps_shift) < a.ps; ++ps_shift) {}
  // the staged rows: every position the union of the T ranges can hold
  const int cap = a.MP * a.ps;
  const int span =
      a.window > 0 && a.window + a.T - 1 < cap ? a.window + a.T - 1 : cap;
  const size_t staged = verify_smem_bytes<HD, G>(a.MP, span, a.T);
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (staged <= static_cast<size_t>(optin))
    return launch_kernel<HD, G, true>(a, ps_shift, span, staged);
  return launch_kernel<HD, G, false>(a, ps_shift, 0, smem_bytes<HD, G>(a.MP));
}

template <int HD>
cudaError_t launch_g(int G, const Args& a) {
  switch (G) {
    case 1: return launch<HD, 1>(a);
    case 2: return launch<HD, 2>(a);
    case 4: return launch<HD, 4>(a);
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
    case 128: return launch_g<128>(G, a);
    default:  return cudaErrorInvalidValue;
  }
}

// One-token flash-decode against the paged int8 KV arena, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/paged_decode_attention.py::paged_decode_attention (Pallas,
// pl.pallas_call at :122). Same function: for every (batch row b, kv head h)
// the G = H / KV query heads of the group attend the int8 keys/values of
// positions [max(0, len - window), len) of stream b. Position s lives in arena
// page page_table[b, s / ps] at offset s % ps, and each (page, kv head) has its
// own k and v scale; the codes are dequantized in registers and the softmax is
// taken in f32; output in q's dtype. Rows may map the same pages (copy-on-write
// prefix sharing): the gather only reads. A row with no valid position gives
// zeros.
//
// Two bodies, chosen by the wrapper from shapes only
// (kernels/paged_decode_attention.py, `plan`): the one-CTA body of
// int8_decode.cuh (paged_decode_kernel, shared with the dense kernel), one
// CTA a (row, kv head), for many pairs over a short span (stablelm's and
// whisper's pools); and the split body of int8_split_decode.cuh
// (paged_split_kernel, then paged_merge_kernel where a row meets several
// cells) everywhere else: few pairs, long spans (h2o-danube's window,
// qwen2-7b's and jamba's groups). What bounds each and their designs are in
// those headers; this file launches them. In the one-CTA body the TPU kernel
// walks the table as a sequential grid axis with the table scalar-prefetched;
// here the CTA of a (row, kv head) reads its table row into shared memory
// once, together with the length (one round trip, one barrier), then issues
// its K/V loads (rows of hd int8, strided by KV * hd in the model layout
// (P, ps, KV, hd)) and, beside them, the scales of the pages it visits, which
// it stages in shared memory too. Only positions in [lo, hi), hi = min(len,
// MP * ps), are read, so pages past ceil(len / ps) and pages wholly before the
// window are never touched (the Pallas kernel's pl.when(jnp.any(mask))). A
// table entry outside [0, P) is never dereferenced: its positions count as
// masked.

#include "int8_decode.cuh"
#include "int8_split_decode.cuh"

// The build compiles this file as four objects at once (kernels/build.py,
// PARTS), each with -DKERNEL_PART=i, and links them into one library:
// part 0 holds the entry point and the launchers of hd 32, parts 1-3 those
// of hd 64, 80 and 128. Without KERNEL_PART it is one translation unit.
namespace k4_launch {  // named: the parts link to each other's launch_g

using namespace int8_decode;

struct Args {
  const void *q, *kp, *vp, *ks, *vs, *ptab, *lengths;
  void* out;
  int B, KV, P, ps, MP;
  int64_t skp, sks, skh, svp, svs, svh;
  int window;
  float sm_scale;
  int cell, nsplit;    // nsplit 0: the one-CTA body; >= 1: the split body
  float* work;         // nsplit > 1: the splits' partials
  cudaStream_t stream;
};

template <int HD, int G>
cudaError_t launch(const Args& a) {
  // a page size that is a power of two is looked up by a shift
  int ps_shift = -1;
  if ((a.ps & (a.ps - 1)) == 0)
    for (ps_shift = 0; (1 << ps_shift) < a.ps; ++ps_shift) {}
  if (a.nsplit >= 1) {
    const int64_t qsb = static_cast<int64_t>(a.KV) * G * HD;
    return paged_split_launch<HD, G, false>(
        static_cast<const __nv_bfloat16*>(a.q), static_cast<const int8_t*>(a.kp),
        static_cast<const int8_t*>(a.vp), static_cast<const float*>(a.ks),
        static_cast<const float*>(a.vs), static_cast<const int32_t*>(a.ptab),
        static_cast<const int32_t*>(a.lengths),
        static_cast<__nv_bfloat16*>(a.out), a.B, a.KV, a.P, a.ps, ps_shift,
        a.MP, a.skp, a.sks, a.skh, a.svp, a.svs, a.svh, a.window, a.sm_scale,
        0, 1, qsb, 0, qsb, 0, a.cell, a.nsplit, a.work, a.stream);
  }
  // the merge and the staged table row and scales (12 bytes a table
  // entry): past 48 KB the kernel must opt in
  const size_t dyn = smem_bytes<HD, G>(a.MP);
  if (dyn > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<HD, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (err != cudaSuccess) return err;
  }
  paged_decode_kernel<HD, G><<<a.B * a.KV, kThreads, dyn, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const int8_t*>(a.kp),
      static_cast<const int8_t*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int32_t*>(a.ptab),
      static_cast<const int32_t*>(a.lengths),
      static_cast<__nv_bfloat16*>(a.out), a.KV, a.P, a.ps, ps_shift, a.MP,
      a.skp, a.sks, a.skh, a.svp, a.svs, a.svh, a.window, a.sm_scale);
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

}  // namespace k4_launch

#if defined(KERNEL_PART) && KERNEL_PART != 0
#if KERNEL_PART == 1
template cudaError_t k4_launch::launch_g<64>(int, const k4_launch::Args&);
#elif KERNEL_PART == 2
template cudaError_t k4_launch::launch_g<80>(int, const k4_launch::Args&);
#elif KERNEL_PART == 3
template cudaError_t k4_launch::launch_g<128>(int, const k4_launch::Args&);
#else
#error "paged_decode_attention.cu has parts 0-3"
#endif
#else
#if defined(KERNEL_PART)
extern template cudaError_t k4_launch::launch_g<64>(int, const k4_launch::Args&);
extern template cudaError_t k4_launch::launch_g<80>(int, const k4_launch::Args&);
extern template cudaError_t k4_launch::launch_g<128>(int, const k4_launch::Args&);
#endif

// q (B, KV * G, hd) bf16 contiguous, 16-byte aligned; kp/vp int8 arenas
// addressed as (P, ps, KV, hd) through the element strides s*p (page), s*s
// (position), s*h (kv head), hd stride 1 and every row 16-byte aligned;
// k_scale/v_scale (P, KV) f32 contiguous; page_table (B, MP) int32
// contiguous; lengths (B,) int32; out like q. window <= 0 means no window.
// nsplit 0 runs the one-CTA body; nsplit >= 1 the split body over cells of
// `cell` keys (a multiple of 64), nsplit a (row, kv head), and for nsplit >
// 1 work holds B * KV * nsplit * ceil(G / 16) * 16 * (hd + 2) f32 of
// partials. Returns a cudaError_t (0 on success).
extern "C" int paged_decode_launch(const void* q, const void* kp, const void* vp,
                                   const void* k_scale, const void* v_scale,
                                   const void* page_table, const void* lengths,
                                   void* out, void* work, int B, int KV, int G,
                                   int P, int ps, int MP, int hd, int cell,
                                   int nsplit, int64_t skp, int64_t sks,
                                   int64_t skh, int64_t svp, int64_t svs,
                                   int64_t svh, int window, float sm_scale,
                                   void* stream) {
  using namespace k4_launch;
  if (ps <= 0 || MP < 0 || nsplit < 0) return cudaErrorInvalidValue;
  const Args a{q, kp, vp, k_scale, v_scale, page_table, lengths, out,
               B, KV, P, ps, MP, skp, sks, skh, svp, svs, svh, window,
               sm_scale, cell, nsplit, static_cast<float*>(work),
               static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 32:  return launch_g<32>(G, a);
    case 64:  return launch_g<64>(G, a);
    case 80:  return launch_g<80>(G, a);
    case 128: return launch_g<128>(G, a);
    default:  return cudaErrorInvalidValue;
  }
}
#endif  // the entry point: part 0, or the whole file

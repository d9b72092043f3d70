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
// Two bodies, the one K4's plan picks at the same shapes
// (kernels/paged_decode_attention.py, `plan`), so that each window position
// stays bit-identical to K4 at its length. Where K4 keeps its one-CTA body
// (many pairs over short spans: stablelm's and whisper's pools), the window
// keeps K4's arithmetic per position and runs the positions at once: one
// CTA per (row, kv head, position), each running
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
//
// Everywhere else (few pairs, long spans: h2o-danube's window, qwen2-7b's
// and jamba's groups) K4 runs its split body (int8_split_decode.cuh:
// paged_split_kernel), and so does the window (paged_verify_split_kernel,
// the same body with 16 rows a tile), on one walk for all T
// positions: the G heads of the T positions are the A rows of the tensor-
// core products (G T rows in tiles of 16, one CTA per (row, kv head, cell,
// tile)), so each cell's pages are staged once for the tile's positions,
// each row masked at its own length, with its own softmax statistics and its
// position's q scale. The cells sit on a grid of absolute positions and the
// stages at absolute multiples of 16, the same for K4 at every length, and
// a stage outside a row's range leaves that row as it was: each row does
// K4's arithmetic at its length, bit for bit.

#include "int8_decode.cuh"
#include "int8_split_decode.cuh"

// The build compiles this file as four objects at once (kernels/build.py,
// PARTS), each with -DKERNEL_PART=i, and links them into one library:
// part 0 holds the entry point and the launchers of hd 32, parts 1-3 those
// of hd 64, 80 and 128. Without KERNEL_PART it is one translation unit.
namespace kv_launch {  // named: the parts link to each other's launch_g

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
  int cell, nsplit;    // nsplit 0: one CTA a position; >= 1: the split body
  float* work;         // nsplit > 1: the splits' partials
  cudaStream_t stream;
};

template <int HD, int G>
cudaError_t launch(const Args& a) {
  int ps_shift = -1;
  if ((a.ps & (a.ps - 1)) == 0)
    for (ps_shift = 0; (1 << ps_shift) < a.ps; ++ps_shift) {}
  // window position j at length base_len + 1 + j: lead 1
  if (a.nsplit >= 1)
    return paged_split_launch<HD, G, true>(
        static_cast<const __nv_bfloat16*>(a.q), static_cast<const int8_t*>(a.kp),
        static_cast<const int8_t*>(a.vp), static_cast<const float*>(a.ks),
        static_cast<const float*>(a.vs), static_cast<const int32_t*>(a.ptab),
        static_cast<const int32_t*>(a.lengths),
        static_cast<__nv_bfloat16*>(a.out), a.B, a.KV, a.P, a.ps, ps_shift,
        a.MP, a.skp, a.sks, a.skh, a.svp, a.svs, a.svh, a.window, a.sm_scale,
        1, a.T, a.qsb, a.qst, a.osb, a.ost, a.cell, a.nsplit, a.work,
        a.stream);
  // the merge and the staged table row and scales (12 bytes a table
  // entry): past 48 KB the kernel must opt in
  const size_t dyn = smem_bytes<HD, G>(a.MP);
  if (dyn > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_verify_kernel<HD, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (err != cudaSuccess) return err;
  }
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

}  // namespace kv_launch

#if defined(KERNEL_PART) && KERNEL_PART != 0
#if KERNEL_PART == 1
template cudaError_t kv_launch::launch_g<64>(int, const kv_launch::Args&);
#elif KERNEL_PART == 2
template cudaError_t kv_launch::launch_g<80>(int, const kv_launch::Args&);
#elif KERNEL_PART == 3
template cudaError_t kv_launch::launch_g<128>(int, const kv_launch::Args&);
#else
#error "paged_verify_attention.cu has parts 0-3"
#endif
#else
#if defined(KERNEL_PART)
extern template cudaError_t kv_launch::launch_g<64>(int, const kv_launch::Args&);
extern template cudaError_t kv_launch::launch_g<80>(int, const kv_launch::Args&);
extern template cudaError_t kv_launch::launch_g<128>(int, const kv_launch::Args&);
#endif

// q (B, T, KV * G, hd) bf16 through element strides qsb (row) and qst
// (window position), unit head and hd strides, every query row 16-byte
// aligned; kp/vp int8 arenas addressed as (P, ps, KV, hd) through the
// element strides s*p, s*s, s*h (hd stride 1, rows 16-byte aligned);
// k_scale/v_scale (P, KV) f32 contiguous; page_table (B, MP) int32
// contiguous; base_len (B,) int32: window position j attends base_len + j
// + 1 positions; out (B, T, KV * G, hd) through osb, ost. window <= 0 means
// no window. nsplit 0 runs one CTA a position; nsplit >= 1 the split body
// over cells of `cell` keys (K4's plan), nsplit a (row, kv head), and for
// nsplit > 1 work holds B * KV * nsplit * ceil(T * G / 16) * 16 * (hd + 2)
// f32 of partials. Returns a cudaError_t (0 on success).
extern "C" int paged_verify_launch(const void* q, const void* kp, const void* vp,
                                   const void* k_scale, const void* v_scale,
                                   const void* page_table, const void* base_len,
                                   void* out, void* work, int B, int KV, int G,
                                   int T, int P, int ps, int MP, int hd,
                                   int cell, int nsplit, int64_t skp,
                                   int64_t sks, int64_t skh, int64_t svp,
                                   int64_t svs, int64_t svh, int64_t qsb,
                                   int64_t qst, int64_t osb, int64_t ost,
                                   int window, float sm_scale, void* stream) {
  using namespace kv_launch;
  if (ps <= 0 || MP < 0 || T <= 0 || nsplit < 0) return cudaErrorInvalidValue;
  const Args a{q, kp, vp, k_scale, v_scale, page_table, base_len, out,
               B, KV, P, ps, MP, skp, sks, skh, svp, svs, svh, window,
               sm_scale, T, qsb, qst, osb, ost, cell, nsplit,
               static_cast<float*>(work), static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 32:  return launch_g<32>(G, a);
    case 64:  return launch_g<64>(G, a);
    case 80:  return launch_g<80>(G, a);
    case 128: return launch_g<128>(G, a);
    default:  return cudaErrorInvalidValue;
  }
}
#endif  // the entry point: part 0, or the whole file

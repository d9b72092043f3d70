// One-token flash-decode against a dense int8 KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention_int8.py::decode_attention_int8 (Pallas,
// pl.pallas_call at :114). Same function: for every (batch row b, kv head h)
// the G = H / KV query heads of the group attend the int8 keys/values of
// positions [max(0, len - window), len) of row b, dequantized in registers
// with the per-(b, h) scales; softmax in f32; output in q's dtype. Positions
// past the length (a ragged tail of S included) are masked here: the cache
// length S = prompt + max_new + 1 need not be a multiple of any block. A row
// with no valid position gives zeros.
//
// Two bodies, chosen by the wrapper from shapes only
// (kernels/decode_attention_int8.py, `plan`): the one-CTA body of
// int8_decode.cuh (decode_int8_kernel, shared with the paged kernel), one
// CTA a (row, kv head), for many pairs over a short span (stablelm's 256
// pairs at 161 positions); and the split body of int8_split_decode.cuh
// (decode_int8_split_kernel, then merge_kernel when a pair has several
// splits) everywhere else: few pairs, long spans. What bounds each and their
// designs are in those headers; this file launches them. The source of
// position s is row b of the cache, read as (B, KV, S, hd) through the
// strides of the model layout (B, S, KV, hd), never copied.

#include "int8_decode.cuh"
#include "int8_split_decode.cuh"

// The build compiles this file as four objects at once (kernels/build.py,
// PARTS), each with -DKERNEL_PART=i, and links them into one library:
// part 0 holds the entry point and the launchers of hd 32, parts 1-3 those
// of hd 64, 80 and 128 (each part instantiates its head dim's kernels).
// Without KERNEL_PART the file is one translation unit, as before.
namespace k3_launch {  // named: the parts link to each other's launch_g

using namespace int8_decode;

// The kernel's arguments past q.. out, in its order.
struct Args {
  int KV, S;
  int64_t skb, skh, sks, svb, svh, svs;
  int window;
  float sm_scale;
  int key_offset;
  float* out_f32;
  float* lse;
  int nsplit;          // 0: the one-CTA body; >= 1: the split body
  float* work;         // nsplit > 1: the splits' partials
};

template <int HD, int G>
cudaError_t launch(const void* q, const void* kq, const void* vq,
                   const void* ks, const void* vs, const void* lengths,
                   void* out, int B, const Args& a, cudaStream_t stream) {
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const int8_t*>(kq);
  const auto* vp = static_cast<const int8_t*>(vq);
  const auto* ksp = static_cast<const float*>(ks);
  const auto* vsp = static_cast<const float*>(vs);
  const auto* lp = static_cast<const int32_t*>(lengths);
  auto* op = static_cast<__nv_bfloat16*>(out);
  if (a.nsplit >= 1) {
    constexpr size_t smem = split_smem_bytes<HD, G>();
    static const cudaError_t attr = cudaFuncSetAttribute(
        decode_int8_split_kernel<HD, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return attr;
    float* part_o = a.work;
    float* part_ml = a.nsplit > 1
        ? a.work + static_cast<int64_t>(B) * a.KV * a.nsplit * G * HD
        : nullptr;
    decode_int8_split_kernel<HD, G>
        <<<B * a.KV * a.nsplit, kThreads, smem, stream>>>(
            qp, kp, vp, ksp, vsp, lp, op, a.KV, a.S, a.skb, a.skh, a.sks,
            a.svb, a.svh, a.svs, a.window, a.sm_scale, a.key_offset,
            a.out_f32, a.lse, a.nsplit, part_o, part_ml);
    if (a.nsplit > 1) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      merge_kernel<<<B * a.KV * G, HD, 0, stream>>>(
          part_o, part_ml, op, a.out_f32, a.lse, G, HD, a.nsplit);
    }
  } else if (a.lse != nullptr) {
    decode_int8_kernel<HD, G, true><<<B * a.KV, kThreads, smem_bytes<HD, G>(0), stream>>>(
        qp, kp, vp, ksp, vsp, lp, op, a.KV, a.S, a.skb, a.skh, a.sks, a.svb,
        a.svh, a.svs, a.window, a.sm_scale, a.key_offset, a.out_f32, a.lse);
  } else {
    decode_int8_kernel<HD, G><<<B * a.KV, kThreads, smem_bytes<HD, G>(0), stream>>>(
        qp, kp, vp, ksp, vsp, lp, op, a.KV, a.S, a.skb, a.skh, a.sks, a.svb,
        a.svh, a.svs, a.window, a.sm_scale, a.key_offset);
  }
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_g(int G, const void* q, const void* kq, const void* vq,
                     const void* ks, const void* vs, const void* lengths,
                     void* out, int B, const Args& a, cudaStream_t st) {
  switch (G) {
    case 1: return launch<HD, 1>(q, kq, vq, ks, vs, lengths, out, B, a, st);
    case 2: return launch<HD, 2>(q, kq, vq, ks, vs, lengths, out, B, a, st);
    case 4: return launch<HD, 4>(q, kq, vq, ks, vs, lengths, out, B, a, st);
    case 6: return launch<HD, 6>(q, kq, vq, ks, vs, lengths, out, B, a, st);
    case 7: return launch<HD, 7>(q, kq, vq, ks, vs, lengths, out, B, a, st);
    case 8: return launch<HD, 8>(q, kq, vq, ks, vs, lengths, out, B, a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace k3_launch

#define K3_LAUNCH_G_PARAMS int, const void*, const void*, const void*,     \
    const void*, const void*, const void*, void*, int,                     \
    const k3_launch::Args&, cudaStream_t

#if defined(KERNEL_PART) && KERNEL_PART != 0
#if KERNEL_PART == 1
template cudaError_t k3_launch::launch_g<64>(K3_LAUNCH_G_PARAMS);
#elif KERNEL_PART == 2
template cudaError_t k3_launch::launch_g<80>(K3_LAUNCH_G_PARAMS);
#elif KERNEL_PART == 3
template cudaError_t k3_launch::launch_g<128>(K3_LAUNCH_G_PARAMS);
#else
#error "decode_attention_int8.cu has parts 0-3"
#endif
#else
#if defined(KERNEL_PART)
extern template cudaError_t k3_launch::launch_g<64>(K3_LAUNCH_G_PARAMS);
extern template cudaError_t k3_launch::launch_g<80>(K3_LAUNCH_G_PARAMS);
extern template cudaError_t k3_launch::launch_g<128>(K3_LAUNCH_G_PARAMS);
#endif

// q (B, KV * G, hd) bf16 contiguous, 16-byte aligned; kq/vq int8 addressed
// as (B, KV, S, hd) through the element strides s*b, s*h, s*s (hd stride 1,
// every row 16-byte aligned); k_scale/v_scale (B, KV) f32; lengths (B,)
// int32; out like q. window <= 0 means no window. key_offset: the global
// position of local key 0 (a piece of a cache split over its sequence).
// With a non-null lse ((B, KV * G) f32) the output goes to out_f32 ((B, KV *
// G, hd) f32) and out is not written (int8_decode.cuh). nsplit 0 runs the
// one-CTA body; nsplit >= 1 the split body with nsplit CTAs a (row, kv
// head), and for nsplit > 1 work holds B * KV * nsplit * G * (hd + 2) f32
// of partials. Returns a cudaError_t (0 on success).
extern "C" int decode_int8_launch(const void* q, const void* kq, const void* vq,
                                  const void* k_scale, const void* v_scale,
                                  const void* lengths, void* out, void* out_f32,
                                  void* lse, void* work, int B, int KV, int G,
                                  int S, int hd, int nsplit, int64_t skb,
                                  int64_t skh, int64_t sks, int64_t svb,
                                  int64_t svh, int64_t svs, int window,
                                  int key_offset, float sm_scale, void* stream) {
  using namespace k3_launch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lse != nullptr && out_f32 == nullptr) return cudaErrorInvalidValue;
  if (nsplit < 0 || (nsplit > 1 && work == nullptr)) return cudaErrorInvalidValue;
  const Args a{KV, S, skb, skh, sks, svb, svh, svs, window, sm_scale,
               key_offset, static_cast<float*>(out_f32),
               static_cast<float*>(lse), nsplit, static_cast<float*>(work)};
  switch (hd) {
    case 32:  return launch_g<32>(G, q, kq, vq, k_scale, v_scale, lengths, out, B, a, st);
    case 64:  return launch_g<64>(G, q, kq, vq, k_scale, v_scale, lengths, out, B, a, st);
    case 80:  return launch_g<80>(G, q, kq, vq, k_scale, v_scale, lengths, out, B, a, st);
    case 128: return launch_g<128>(G, q, kq, vq, k_scale, v_scale, lengths, out, B, a, st);
    default:  return cudaErrorInvalidValue;
  }
}
#endif  // the entry point: part 0, or the whole file

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
// What bounds it, and the design: int8_decode.cuh, which holds this kernel
// (decode_int8_kernel) and the paged one (paged_decode_attention.cu) on one
// body; this file launches it. Here the source of position s is row b of
// the cache, read as (B, KV, S, hd) through the strides of the model layout
// (B, S, KV, hd), never copied; the length and the two scales are read
// first, with no barrier before the K/V loads.

#include "int8_decode.cuh"

namespace {

using namespace int8_decode;

template <int HD, int G>
cudaError_t launch(const void* q, const void* kq, const void* vq,
                   const void* ks, const void* vs, const void* lengths,
                   void* out, int B, int KV, int S, int64_t skb, int64_t skh,
                   int64_t sks, int64_t svb, int64_t svh, int64_t svs,
                   int window, float sm_scale, cudaStream_t stream) {
  decode_int8_kernel<HD, G><<<B * KV, kThreads, smem_bytes<HD, G>(0), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(kq),
      static_cast<const int8_t*>(vq), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int32_t*>(lengths),
      static_cast<__nv_bfloat16*>(out), KV, S, skb, skh, sks, svb, svh, svs,
      window, sm_scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_g(int G, const void* q, const void* kq, const void* vq,
                     const void* ks, const void* vs, const void* lengths,
                     void* out, int B, int KV, int S, int64_t skb, int64_t skh,
                     int64_t sks, int64_t svb, int64_t svh, int64_t svs,
                     int window, float sm_scale, cudaStream_t st) {
  switch (G) {
    case 1: return launch<HD, 1>(q, kq, vq, ks, vs, lengths, out, B, KV, S, skb, skh, sks, svb, svh, svs, window, sm_scale, st);
    case 2: return launch<HD, 2>(q, kq, vq, ks, vs, lengths, out, B, KV, S, skb, skh, sks, svb, svh, svs, window, sm_scale, st);
    case 4: return launch<HD, 4>(q, kq, vq, ks, vs, lengths, out, B, KV, S, skb, skh, sks, svb, svh, svs, window, sm_scale, st);
    case 6: return launch<HD, 6>(q, kq, vq, ks, vs, lengths, out, B, KV, S, skb, skh, sks, svb, svh, svs, window, sm_scale, st);
    case 7: return launch<HD, 7>(q, kq, vq, ks, vs, lengths, out, B, KV, S, skb, skh, sks, svb, svh, svs, window, sm_scale, st);
    case 8: return launch<HD, 8>(q, kq, vq, ks, vs, lengths, out, B, KV, S, skb, skh, sks, svb, svh, svs, window, sm_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, KV * G, hd) bf16 contiguous, 16-byte aligned; kq/vq int8 addressed
// as (B, KV, S, hd) through the element strides s*b, s*h, s*s (hd stride 1,
// every row 16-byte aligned); k_scale/v_scale (B, KV) f32; lengths (B,)
// int32; out like q. window <= 0 means no window. Returns a cudaError_t
// (0 on success).
extern "C" int decode_int8_launch(const void* q, const void* kq, const void* vq,
                                  const void* k_scale, const void* v_scale,
                                  const void* lengths, void* out, int B, int KV,
                                  int G, int S, int hd, int64_t skb, int64_t skh,
                                  int64_t sks, int64_t svb, int64_t svh,
                                  int64_t svs, int window, float sm_scale,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:  return launch_g<32>(G, q, kq, vq, k_scale, v_scale, lengths, out, B, KV, S, skb, skh, sks, svb, svh, svs, window, sm_scale, st);
    case 64:  return launch_g<64>(G, q, kq, vq, k_scale, v_scale, lengths, out, B, KV, S, skb, skh, sks, svb, svh, svs, window, sm_scale, st);
    case 80:  return launch_g<80>(G, q, kq, vq, k_scale, v_scale, lengths, out, B, KV, S, skb, skh, sks, svb, svh, svs, window, sm_scale, st);
    case 128: return launch_g<128>(G, q, kq, vq, k_scale, v_scale, lengths, out, B, KV, S, skb, skh, sks, svb, svh, svs, window, sm_scale, st);
    default:  return cudaErrorInvalidValue;
  }
}

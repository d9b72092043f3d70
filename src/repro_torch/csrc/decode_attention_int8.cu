// One-token flash-decode against a dense int8 KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// src/repro/kernels/decode_attention_int8.py::decode_attention_int8 (Pallas,
// pl.pallas_call at :114). Same function: for every (batch row b, kv head h)
// the G = H / KV query heads of the group attend the int8 keys/values of
// positions [max(0, len - window), len) of row b, dequantized in registers
// with the per-(b, h) scales; softmax in f32; output in q's dtype. Positions
// past the length (a ragged tail of S included) are masked here: the cache
// length S = prompt + max_new + 1 need not be a multiple of any block.
//
// What bounds it on this card: bytes. Each valid position costs 2*hd int8
// bytes of K/V for 4*G*hd flops, so at G = 1 (stablelm is MHA) the kernel
// does ~2 flops per byte, hundreds of times below the compute roof; the
// only lever is to stream the cache once, as int8, and to keep enough CTAs
// in flight.
//
// Design: one CTA per (b, kv head), 4 warps. The TPU kernel walks S as a
// sequential grid axis carrying (m, l, acc) in scratch; here nothing carries
// across CTAs, so the CTA loops over S itself: warp w takes the 32-position
// chunks w, w + 4, ... and keeps its own online softmax (m, l and the
// head_dim accumulator, all in registers, for all G heads of the group).
// A lane owns one position of the chunk: it loads that position's key AND
// value rows as 16-byte vectors together (both loads in flight at once),
// dots the key against q (in shared memory, read as a broadcast), so the G
// heads share one K read, and parks the value row in the warp's shared
// buffer. For the value update the chunk's probabilities are broadcast by
// shuffle and each lane accumulates head_dim / 32 output dims from that
// buffer. The 4 warp states are merged through shared memory at the end.
// Only the chunks that hold valid positions are read, so short streams cost
// what they hold, not S.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float byte_at(uint32_t w, int j) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * j)));
}

template <int HD, int G>
__global__ void __launch_bounds__(kThreads)
decode_int8_kernel(const __nv_bfloat16* __restrict__ q,
                   const int8_t* __restrict__ kq, const int8_t* __restrict__ vq,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int32_t* __restrict__ lengths,
                   __nv_bfloat16* __restrict__ out, int KV, int S,
                   int64_t skb, int64_t skh, int64_t sks, int64_t svb,
                   int64_t svh, int64_t svs, int window, float sm_scale) {
  constexpr int kVec = HD / 16;           // 16-byte vectors per key row
  constexpr int kPerLane = HD / 32;       // output dims owned per lane
  __shared__ float qs[G * HD];
  __shared__ float wm[kWarps * G];
  __shared__ float wl[kWarps * G];
  __shared__ float wacc[kWarps * G * HD];
  __shared__ __align__(16) int8_t vbuf[kWarps][32 * HD];   // a chunk's V rows

  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const __nv_bfloat16* qg = q + (static_cast<int64_t>(b) * KV + h) * G * HD;
  for (int i = threadIdx.x; i < G * HD; i += kThreads)
    qs[i] = __bfloat162float(qg[i]);
  __syncthreads();

  const int len = lengths[b];
  const int s_hi = min(len, S);
  const int s_lo = window > 0 ? max(0, len - window) : 0;
  const float kscale = k_scale[b * KV + h] * sm_scale;
  const int8_t* kbase = kq + b * skb + h * skh;
  const int8_t* vbase = vq + b * svb + h * svh;

  float m[G], l[G], acc[G][kPerLane];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) acc[g][e] = 0.f;
  }

  const int c_begin = s_lo / 32;
  const int c_end = s_hi > s_lo ? (s_hi + 31) / 32 : c_begin;
  for (int c = c_begin + warp; c < c_end; c += kWarps) {
    const int s = c * 32 + lane;
    const bool valid = s >= s_lo && s < s_hi;
    uint4 kr[kVec], vr[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      kr[i] = valid ? reinterpret_cast<const uint4*>(kbase + s * sks)[i]
                    : make_uint4(0u, 0u, 0u, 0u);
      vr[i] = valid ? reinterpret_cast<const uint4*>(vbase + s * svs)[i]
                    : make_uint4(0u, 0u, 0u, 0u);
    }
    int8_t* vrow_s = vbuf[warp];
    __syncwarp();                            // previous chunk's reads done
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      reinterpret_cast<uint4*>(vrow_s + lane * HD)[i] = vr[i];
    __syncwarp();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float* qv = qs + g * HD;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const uint32_t w4[4] = {kr[i].x, kr[i].y, kr[i].z, kr[i].w};
#pragma unroll
        for (int wi = 0; wi < 4; ++wi)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            dot = fmaf(qv[16 * i + 4 * wi + j], byte_at(w4[wi], j), dot);
      }
      const float score = valid ? dot * kscale : -INFINITY;
      const float m_chunk = warp_max(score);
      if (m_chunk == -INFINITY) continue;    // warp-uniform
      const float m_new = fmaxf(m[g], m_chunk);
      const float corr = m[g] == -INFINITY ? 0.f : expf(m[g] - m_new);
      const float p = valid ? expf(score - m_new) : 0.f;
      l[g] = l[g] * corr + warp_sum(p);
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) acc[g][e] *= corr;
#pragma unroll 8
      for (int i = 0; i < 32; ++i) {
        const float pi = __shfl_sync(0xffffffffu, p, i);
        const int8_t* vrow = vrow_s + i * HD;
#pragma unroll
        for (int e = 0; e < kPerLane; ++e)
          acc[g][e] = fmaf(pi, static_cast<float>(vrow[lane + 32 * e]), acc[g][e]);
      }
    }
  }

  // ---- merge the 4 warp states ----
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < kPerLane; ++e)
      wacc[(warp * G + g) * HD + lane + 32 * e] = acc[g][e];
  }
  __syncthreads();
  const float vscale = v_scale[b * KV + h];
  __nv_bfloat16* og = out + (static_cast<int64_t>(b) * KV + h) * G * HD;
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD, dd = i % HD;
    float mx = -INFINITY;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float lsum = 0.f, o = 0.f;
    if (mx != -INFINITY) {
      for (int w = 0; w < kWarps; ++w) {
        const float mw = wm[w * G + g];
        if (mw == -INFINITY) continue;
        const float wt = expf(mw - mx);
        lsum += wl[w * G + g] * wt;
        o += wacc[(w * G + g) * HD + dd] * wt;
      }
      o = o * vscale / fmaxf(lsum, 1e-30f);
    }
    og[i] = __float2bfloat16(o);
  }
}

template <int HD, int G>
cudaError_t launch(const void* q, const void* kq, const void* vq,
                   const void* ks, const void* vs, const void* lengths,
                   void* out, int B, int KV, int S, int64_t skb, int64_t skh,
                   int64_t sks, int64_t svb, int64_t svh, int64_t svs,
                   int window, float sm_scale, cudaStream_t stream) {
  decode_int8_kernel<HD, G><<<B * KV, kThreads, 0, stream>>>(
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
    case 8: return launch<HD, 8>(q, kq, vq, ks, vs, lengths, out, B, KV, S, skb, skh, sks, svb, svh, svs, window, sm_scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, KV * G, hd) bf16 contiguous; kq/vq int8 addressed as (B, KV, S, hd)
// through the element strides s*b, s*h, s*s (hd stride 1, every row 16-byte
// aligned); k_scale/v_scale (B, KV) f32; lengths (B,) int32; out like q.
// window <= 0 means no window. Returns a cudaError_t (0 on success).
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
    case 128: return launch_g<128>(G, q, kq, vq, k_scale, v_scale, lengths, out, B, KV, S, skb, skh, sks, svb, svh, svs, window, sm_scale, st);
    default:  return cudaErrorInvalidValue;
  }
}

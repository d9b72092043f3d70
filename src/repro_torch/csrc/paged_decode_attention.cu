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
// prefix sharing): the gather only reads.
//
// What bounds it on this card: bytes. Each valid position costs 2*hd int8
// bytes of K/V for 4*G*hd flops, about 2 flops per byte at G = 1; the lever
// is to read only the pages a stream holds, once, as int8.
//
// Design (K3's, with the gather): one CTA per (b, kv head), 4 warps. The TPU
// kernel walks the table as a sequential grid axis j with the table
// scalar-prefetched; here the CTA reads its own table row and loops over the
// stream's positions itself: warp w takes the 32-position chunks w, w + 4, ...
// and keeps its own online softmax (m, l and the head_dim accumulator for all
// G heads, in registers). Only chunks that hold positions in [lo, hi) are
// visited, hi = min(len, MP * ps), so pages past ceil(len / ps) and pages
// wholly before the window are never read (the Pallas kernel's
// pl.when(jnp.any(mask))); positions inside a visited chunk are masked by the
// length and the window. A lane owns one position: it looks up its page,
// loads that position's key and value rows (hd int8 each, strided by KV * hd
// in the model layout (P, ps, KV, hd)) as 16-byte vectors, both in flight at
// once, dots the key against q (in shared memory, a broadcast read) scaled by
// its page's k scale, and parks the value row in the warp's shared buffer.
// For the value update each lane's probability times its page's v scale is
// broadcast by shuffle and each lane accumulates head_dim / 32 output dims.
// The 4 warp states merge through shared memory at the end. A table entry
// outside [0, P) is never dereferenced: its positions count as masked.

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
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const int8_t* __restrict__ kp, const int8_t* __restrict__ vp,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ page_table,
                    const int32_t* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, int KV, int P, int ps,
                    int MP, int64_t skp, int64_t sks, int64_t skh, int64_t svp,
                    int64_t svs, int64_t svh, int window, float sm_scale) {
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
  const int s_hi = min(len, MP * ps);
  const int s_lo = window > 0 ? max(0, len - window) : 0;
  const int32_t* prow = page_table + static_cast<int64_t>(b) * MP;
  const int8_t* kbase = kp + h * skh;
  const int8_t* vbase = vp + h * svh;

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
    bool valid = s >= s_lo && s < s_hi;
    int page = 0;
    if (valid) {
      page = prow[s / ps];
      valid = page >= 0 && page < P;
    }
    const int off = valid ? s % ps : 0;
    float ksc = 0.f, vsc = 0.f;
    uint4 kr[kVec], vr[kVec];
    if (valid) {
      const int8_t* krow = kbase + page * skp + off * sks;
      const int8_t* vrow = vbase + page * svp + off * svs;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        kr[i] = reinterpret_cast<const uint4*>(krow)[i];
        vr[i] = reinterpret_cast<const uint4*>(vrow)[i];
      }
      ksc = k_scale[page * KV + h] * sm_scale;
      vsc = v_scale[page * KV + h];
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        kr[i] = make_uint4(0u, 0u, 0u, 0u);
        vr[i] = make_uint4(0u, 0u, 0u, 0u);
      }
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
      const float score = valid ? dot * ksc : -INFINITY;
      const float m_chunk = warp_max(score);
      if (m_chunk == -INFINITY) continue;    // warp-uniform
      const float m_new = fmaxf(m[g], m_chunk);
      const float corr = m[g] == -INFINITY ? 0.f : expf(m[g] - m_new);
      const float p = valid ? expf(score - m_new) : 0.f;
      l[g] = l[g] * corr + warp_sum(p);
      m[g] = m_new;
      const float pv = p * vsc;             // this position's v dequant folded in
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) acc[g][e] *= corr;
#pragma unroll 8
      for (int i = 0; i < 32; ++i) {
        const float pi = __shfl_sync(0xffffffffu, pv, i);
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
      o = o / fmaxf(lsum, 1e-30f);
    }
    og[i] = __float2bfloat16(o);
  }
}

struct Args {
  const void *q, *kp, *vp, *ks, *vs, *ptab, *lengths;
  void* out;
  int B, KV, P, ps, MP;
  int64_t skp, sks, skh, svp, svs, svh;
  int window;
  float sm_scale;
  cudaStream_t stream;
};

template <int HD, int G>
cudaError_t launch(const Args& a) {
  paged_decode_kernel<HD, G><<<a.B * a.KV, kThreads, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const int8_t*>(a.kp),
      static_cast<const int8_t*>(a.vp), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int32_t*>(a.ptab),
      static_cast<const int32_t*>(a.lengths),
      static_cast<__nv_bfloat16*>(a.out), a.KV, a.P, a.ps, a.MP, a.skp, a.sks,
      a.skh, a.svp, a.svs, a.svh, a.window, a.sm_scale);
  return cudaGetLastError();
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

// q (B, KV * G, hd) bf16 contiguous; kp/vp int8 arenas addressed as
// (P, ps, KV, hd) through the element strides s*p (page), s*s (position),
// s*h (kv head), hd stride 1 and every row 16-byte aligned; k_scale/v_scale
// (P, KV) f32 contiguous; page_table (B, MP) int32 contiguous; lengths (B,)
// int32; out like q. window <= 0 means no window. Returns a cudaError_t
// (0 on success).
extern "C" int paged_decode_launch(const void* q, const void* kp, const void* vp,
                                   const void* k_scale, const void* v_scale,
                                   const void* page_table, const void* lengths,
                                   void* out, int B, int KV, int G, int P,
                                   int ps, int MP, int hd, int64_t skp,
                                   int64_t sks, int64_t skh, int64_t svp,
                                   int64_t svs, int64_t svh, int window,
                                   float sm_scale, void* stream) {
  const Args a{q, kp, vp, k_scale, v_scale, page_table, lengths, out,
               B, KV, P, ps, MP, skp, sks, skh, svp, svs, svh, window,
               sm_scale, static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 32:  return launch_g<32>(G, a);
    case 64:  return launch_g<64>(G, a);
    case 128: return launch_g<128>(G, a);
    default:  return cudaErrorInvalidValue;
  }
}

// GQA prefill flash attention with a key-length mask and a prefix segment,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (Pallas, pl.pallas_call at :88) and computes the superset
// of it that serving needs, the JAX package's jnp
// src/repro/models/attention.py::flash_attention: for batch row b and query
// head h (kv head h / G, GQA), query i at position q_off + i attends the keys
// [prefix keys at positions 0 .. Sp-1, new keys at positions Sp .. Sp+Sk-1],
// q_off = Sp + Sk - Sq (the queries are the suffix). Masked: a prefix key at
// or past prefix_len[b]; a new key at or past kv_len[b]; with `causal`, a key
// after the query; with a window, a key window or more positions before it.
// Scores and the accumulator are f32; each probability is rounded to bf16
// (the value dtype) before the P.V product, and the output is acc / max(l,
// 1e-30), as in the JAX function. A query row with no valid key at all
// returns zeros (JAX returns the mean of the masked values there; no such
// row occurs on the serving path).
//
// What bounds it on this card: bytes. At the serving shapes (S <= 128,
// hd = 64) the function does about 32 flops per byte it must move (q, k, v
// read once, out written once), far below the ~295 at which the bf16 tensor
// cores would wait on memory. This first kernel runs its products on the
// CUDA cores in f32 (67 TFLOP/s), so its own limit is operations: a pooled
// layer's ~2.2 GFLOP take ~32 us there at best. The design keeps each K/V
// tile's reuse in shared memory, so device memory sees a K/V row once per
// query tile, and skips tiles the masks empty; tensor cores (mma, wgmma) are
// later work.
//
// Design: one CTA per (query tile, kv head, batch row) serves the G query
// heads that share the kv head, 64 rows of (query, head) per CTA (64 / G
// queries). HD / 16 consecutive lanes own one row, 16 head dims each: q and
// the accumulator live in registers. K and V tiles of 32 keys are staged in
// shared memory with 16-byte loads (a 128-byte key row per 8 lanes) straight
// from the model layout (B, S, KV, hd) by strides: no transposed copy, and
// the prefix is a second key segment walked before the new keys, never
// concatenated. Per tile each row computes its 32 scores (partial dots
// reduced across its lanes by shuffles), takes the tile maximum, rescales
// its running sum and accumulator once, and adds the rounded probabilities
// times V. The tile range of each segment is cut to what the CTA's queries
// can see (causal end, window start, kv_len, prefix_len read on the device:
// no host sync); masks inside a tile are per key, so Sq, Sk and Sp need not
// be tile multiples.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;   // (query, head) rows per CTA
constexpr int kTile = 32;   // keys per shared-memory tile

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void unpack16(const uint4* src, float* dst) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 u = src[i];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dst[8 * i + 2 * j] = bf_lo(w[j]);
      dst[8 * i + 2 * j + 1] = bf_hi(w[j]);
    }
  }
}

struct Seg {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  int64_t skb, sks, skh, svb, svs, svh;
};

template <int HD>
__global__ void __launch_bounds__(kRows * (HD / 16))
flash_attention_kernel(const __nv_bfloat16* __restrict__ q, Seg pre, Seg cur,
                       const int32_t* __restrict__ kv_len,
                       const int32_t* __restrict__ prefix_len,
                       __nv_bfloat16* __restrict__ out, int Sq, int Sk, int Sp,
                       int KV, int G, int64_t sqb, int64_t sqs, int64_t sqh,
                       int causal, int window, float sm_scale) {
  constexpr int L = HD / 16;              // lanes per row
  constexpr int kThreads = kRows * L;
  constexpr int kVecRow = HD / 8;         // 16-byte vectors per key row
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * HD];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * HD];

  const int tid = threadIdx.x;
  const int row = tid / L, lane = tid % L;
  const int bq = kRows / G;               // queries per CTA
  const int qi = blockIdx.x * bq + row / G;
  const int g = row % G;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int h = kvh * G + g;
  const bool row_live = qi < Sq;
  const int q_off = Sp + Sk - Sq;
  const int qpos = q_off + qi;
  // the CTA's query positions (for the tile ranges)
  const int qpos_lo = q_off + blockIdx.x * bq;
  const int qpos_hi = q_off + min(Sq, (blockIdx.x + 1) * bq) - 1;

  float qf[16], acc[16];
  if (row_live) {
    const uint4* src = reinterpret_cast<const uint4*>(
        q + b * sqb + qi * sqs + h * sqh + lane * 16);
    unpack16(src, qf);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) qf[e] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int segi = 0; segi < 2; ++segi) {
    const Seg sg = segi == 0 ? pre : cur;
    if (sg.k == nullptr) continue;
    const int base = segi == 0 ? 0 : Sp;
    const int n = segi == 0 ? Sp : Sk;
    int limit = n;
    if (segi == 0) limit = min(n, max(0, prefix_len[b]));
    else if (kv_len != nullptr) limit = min(n, max(0, kv_len[b]));
    // keys [lo, hi) of this segment that any query of the CTA can see
    int hi = limit;
    if (causal) hi = min(hi, qpos_hi - base + 1);
    int lo = 0;
    if (window > 0) lo = max(0, qpos_lo - window + 1 - base);
    lo = (lo / kTile) * kTile;
    const __nv_bfloat16* kb = sg.k + b * sg.skb + kvh * sg.skh;
    const __nv_bfloat16* vb = sg.v + b * sg.svb + kvh * sg.svh;
    for (int j0 = lo; j0 < hi; j0 += kTile) {
      __syncthreads();                    // previous tile's reads done
      for (int i = tid; i < kTile * kVecRow; i += kThreads) {
        const int r = i / kVecRow, c = i % kVecRow;
        const int j = j0 + r;
        uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
        if (j < limit) {
          kk = reinterpret_cast<const uint4*>(kb + j * sg.sks)[c];
          vv = reinterpret_cast<const uint4*>(vb + j * sg.svs)[c];
        }
        reinterpret_cast<uint4*>(ks)[i] = kk;
        reinterpret_cast<uint4*>(vs)[i] = vv;
      }
      __syncthreads();
      float s[kTile];
      float m_tile = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        float kf[16];
        unpack16(reinterpret_cast<const uint4*>(ks + j * HD + lane * 16), kf);
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) dot = fmaf(qf[e], kf[e], dot);
#pragma unroll
        for (int o = L / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        const int jj = j0 + j;
        const int kpos = base + jj;
        bool ok = jj < limit;
        if (causal) ok = ok && qpos >= kpos;
        if (window > 0) ok = ok && (qpos - kpos) < window;
        s[j] = ok ? dot * sm_scale : -INFINITY;
        m_tile = fmaxf(m_tile, s[j]);
      }
      if (m_tile == -INFINITY) continue;  // uniform across the row's lanes
      const float m_new = fmaxf(m, m_tile);
      const float corr = expf(m - m_new);   // m = -inf: 0
      l *= corr;
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] *= corr;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const float p = expf(s[j] - m_new);  // masked: 0
        l += p;
        const float pb = round_bf16(p);
        float vf[16];
        unpack16(reinterpret_cast<const uint4*>(vs + j * HD + lane * 16), vf);
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] = fmaf(pb, vf[e], acc[e]);
      }
      m = m_new;
    }
  }

  if (!row_live) return;
  const float inv = l > 0.f ? 1.f / fmaxf(l, 1e-30f) : 0.f;
  uint32_t packed[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const __nv_bfloat162 two = __floats2bfloat162_rn(acc[2 * e] * inv,
                                                     acc[2 * e + 1] * inv);
    packed[e] = *reinterpret_cast<const uint32_t*>(&two);
  }
  const int H = KV * G;
  uint4* dst = reinterpret_cast<uint4*>(
      out + ((static_cast<int64_t>(b) * Sq + qi) * H + h) * HD + lane * 16);
  dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
  dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
}

template <int HD>
cudaError_t launch(const __nv_bfloat16* q, const Seg& pre, const Seg& cur,
                   const int32_t* kv_len, const int32_t* prefix_len,
                   __nv_bfloat16* out, int B, int Sq, int Sk, int Sp, int KV,
                   int G, int64_t sqb, int64_t sqs, int64_t sqh, int causal,
                   int window, float sm_scale, cudaStream_t stream) {
  const int bq = kRows / G;
  const dim3 grid((Sq + bq - 1) / bq, KV, B);
  flash_attention_kernel<HD><<<grid, kRows * (HD / 16), 0, stream>>>(
      q, pre, cur, kv_len, prefix_len, out, Sq, Sk, Sp, KV, G, sqb, sqs, sqh,
      causal, window, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, KV * G, hd) bf16 with element strides sqb/sqs/sqh; k/v (B, Sk,
// KV, hd) bf16 with strides sk*/sv* (batch, position, kv head); pk/pv the
// prefix (B, Sp, KV, hd) with strides sp*/spv* or null (Sp = 0); every head
// row has unit hd stride and is 16-byte aligned. kv_len and prefix_len are
// (B,) int32 on the device or null (prefix_len is required with a prefix).
// out (B, Sq, KV * G, hd) bf16 contiguous. window <= 0 means no window. G
// divides 64 and hd is 32, 64 or 128. Returns a cudaError_t (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const void* pk,
    const void* pv, const void* kv_len, const void* prefix_len, void* out,
    int B, int Sq, int Sk, int Sp, int KV, int G, int hd, int64_t sqb,
    int64_t sqs, int64_t sqh, int64_t skb, int64_t sks, int64_t skh,
    int64_t svb, int64_t svs, int64_t svh, int64_t spb, int64_t sps,
    int64_t sph, int64_t spvb, int64_t spvs, int64_t spvh, int causal,
    int window, float sm_scale, void* stream) {
  if (G <= 0 || kRows % G || B <= 0 || Sq <= 0 || KV <= 0)
    return cudaErrorInvalidValue;
  const Seg cur{static_cast<const __nv_bfloat16*>(k),
                static_cast<const __nv_bfloat16*>(v), skb, sks, skh, svb, svs,
                svh};
  const Seg pre{static_cast<const __nv_bfloat16*>(pk),
                static_cast<const __nv_bfloat16*>(pv), spb, sps, sph, spvb,
                spvs, spvh};
  const auto* qq = static_cast<const __nv_bfloat16*>(q);
  const auto* kl = static_cast<const int32_t*>(kv_len);
  const auto* pl = static_cast<const int32_t*>(prefix_len);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:  return launch<32>(qq, pre, cur, kl, pl, o, B, Sq, Sk, Sp, KV, G,
                                sqb, sqs, sqh, causal, window, sm_scale, st);
    case 64:  return launch<64>(qq, pre, cur, kl, pl, o, B, Sq, Sk, Sp, KV, G,
                                sqb, sqs, sqh, causal, window, sm_scale, st);
    case 128: return launch<128>(qq, pre, cur, kl, pl, o, B, Sq, Sk, Sp, KV,
                                 G, sqb, sqs, sqh, causal, window, sm_scale,
                                 st);
    default:  return cudaErrorInvalidValue;
  }
}

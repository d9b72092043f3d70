// One-token GQA flash-decode against a float (bf16) KV cache, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (Pallas, pl.pallas_call at :96) and computes what the
// models call, the JAX package's jnp src/repro/models/attention.py::
// decode_attention: for batch row b and kv head h, the G = H / KV query heads
// of the group attend the keys/values of positions [max(0, len - window),
// min(len, S)) of row b; scores and the accumulator are f32, each
// probability is rounded to bf16 (the cache dtype) before the P.V product,
// the output is rounded to bf16. The Pallas kernel keeps p in f32 and needs
// S to be a multiple of its block; here S is any length (1500 encoder frames
// in a cross-attention decode, an odd s_max in a float pool) and the ragged
// tail is masked per position. A row with no valid key returns zeros (JAX
// returns the mean of the masked values; neither serving path has such a
// row: a cross row sees all enc_len frames, a pool row's length is >= 1
// after its write).
//
// What bounds it on this card: bytes. Each valid position costs 4 * hd
// bytes of bf16 K/V for 4 * G * hd flops, about G flops per byte, hundreds
// of times below the compute roof: the only levers are to stream the cache
// once and to keep enough bytes in flight.
//
// Design: K3's structure (one online softmax per warp, merged at the end)
// with the position range split over CTAs. A CTA serves one (row, kv head)
// pair and one split of the positions; when the pairs are few (a cross
// decode at 8 slots x 8 heads: 64 pairs for 132 SMs) the wrapper splits S so
// that about two CTAs per SM are in flight, and a second, small kernel
// merges the splits' (max, sum, accumulator) partials: no atomics. Inside a
// CTA, warp w takes the 32-position chunks w, w + 4, ... of its split. A
// lane owns one position: it loads the key row into registers with 16-byte
// loads and dots it with the G query heads (q in shared memory, read as a
// broadcast: the group shares one K read), while its value row streams into
// the warp's shared buffer by cp.async (no registers held, overlapping the
// dots). For P.V the chunk's rounded probabilities are broadcast by shuffle
// and each lane accumulates hd / 32 output dims from the buffer. The cache
// is read in the model layout (B, S, KV, hd) by strides: the cross-attention
// sidecars and the float pool are views, never copied or transposed.
// Lengths are read on the device: no host sync.

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

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int HD, int G>
struct Smem {
  // the warps' V buffers during the loop, the warps' accumulators after it
  static constexpr int kVBytes = kWarps * 32 * HD * 2;
  static constexpr int kAccBytes = kWarps * G * HD * 4;
  static constexpr int kBytes = kVBytes > kAccBytes ? kVBytes : kAccBytes;
};

template <int HD, int G>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const int32_t* __restrict__ lengths,
              __nv_bfloat16* __restrict__ out, float* __restrict__ part_m,
              float* __restrict__ part_l, float* __restrict__ part_acc, int KV,
              int S, int split_len, int64_t skb, int64_t sks, int64_t skh,
              int64_t svb, int64_t svs, int64_t svh, int window,
              float sm_scale) {
  constexpr int kVec = HD / 8;            // 16-byte vectors per bf16 row
  constexpr int kPerLane = HD / 32;       // output dims owned per lane
  __shared__ float qs[G * HD];
  __shared__ float wm[kWarps * G];
  __shared__ float wl[kWarps * G];
  __shared__ __align__(16) unsigned char raw[Smem<HD, G>::kBytes];

  const int bh = blockIdx.x;
  const int b = bh / KV, h = bh % KV;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const __nv_bfloat16* qg = q + static_cast<int64_t>(bh) * G * HD;
  for (int i = threadIdx.x; i < G * HD; i += kThreads)
    qs[i] = __bfloat162float(qg[i]);
  __syncthreads();

  const int len = lengths[b];
  const int s_lo = max(window > 0 ? max(0, len - window) : 0, split * split_len);
  const int s_hi = min(min(len, S), (split + 1) * split_len);
  const __nv_bfloat16* kbase = k + b * skb + h * skh;
  const __nv_bfloat16* vbase = v + b * svb + h * svh;
  __nv_bfloat16* vbuf = reinterpret_cast<__nv_bfloat16*>(raw) + warp * 32 * HD;

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
    const int src = valid ? s : s_lo;     // an in-range row (not read if !valid)
    __syncwarp();                          // previous chunk's reads of vbuf done
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      cp_async16(vbuf + lane * HD + 8 * i, vbase + src * svs + 8 * i, valid);
    uint4 kr[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      kr[i] = valid ? reinterpret_cast<const uint4*>(kbase + s * sks)[i]
                    : make_uint4(0u, 0u, 0u, 0u);
    float score[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float* qv = qs + g * HD;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const uint32_t w4[4] = {kr[i].x, kr[i].y, kr[i].z, kr[i].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dot = fmaf(qv[8 * i + 2 * j], bf_lo(w4[j]), dot);
          dot = fmaf(qv[8 * i + 2 * j + 1], bf_hi(w4[j]), dot);
        }
      }
      score[g] = valid ? dot * sm_scale : -INFINITY;
    }
    cp_async_wait_all();
    __syncwarp();                          // every lane's V row has landed
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_chunk = warp_max(score[g]);
      if (m_chunk == -INFINITY) continue;  // warp-uniform
      const float m_new = fmaxf(m[g], m_chunk);
      const float corr = m[g] == -INFINITY ? 0.f : expf(m[g] - m_new);
      const float p = valid ? expf(score[g] - m_new) : 0.f;
      l[g] = l[g] * corr + warp_sum(p);
      m[g] = m_new;
      const float pb = round_bf16(p);      // p in the cache dtype, as in JAX
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) acc[g][e] *= corr;
#pragma unroll 8
      for (int i = 0; i < 32; ++i) {
        const float pi = __shfl_sync(0xffffffffu, pb, i);
        const __nv_bfloat16* vrow = vbuf + i * HD;
#pragma unroll
        for (int e = 0; e < kPerLane; ++e)
          acc[g][e] = fmaf(pi, __bfloat162float(vrow[lane + 32 * e]), acc[g][e]);
      }
    }
  }

  // ---- merge the 4 warp states (the V buffers become the accumulators) ----
  __syncthreads();
  float* wacc = reinterpret_cast<float*>(raw);
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
    }
    if (nsplit == 1) {
      out[static_cast<int64_t>(bh) * G * HD + i] =
          __float2bfloat16(mx == -INFINITY ? 0.f : o / fmaxf(lsum, 1e-30f));
    } else {
      const int64_t pg = (static_cast<int64_t>(bh) * nsplit + split) * G + g;
      part_acc[pg * HD + dd] = o;
      if (dd == 0) {
        part_m[pg] = mx;
        part_l[pg] = lsum;
      }
    }
  }
}

// Combine the splits' partials of one (row, kv head) pair: rescale each
// split's sum and accumulator to the largest max and divide once.
template <int HD>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ part_m, const float* __restrict__ part_l,
             const float* __restrict__ part_acc, __nv_bfloat16* __restrict__ out,
             int G, int nsplit) {
  const int bh = blockIdx.x;
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD, dd = i % HD;
    const int64_t p0 = static_cast<int64_t>(bh) * nsplit * G + g;
    float mx = -INFINITY;
    for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, part_m[p0 + s * G]);
    float lsum = 0.f, o = 0.f;
    if (mx != -INFINITY) {
      for (int s = 0; s < nsplit; ++s) {
        const float ms = part_m[p0 + s * G];
        if (ms == -INFINITY) continue;
        const float wt = expf(ms - mx);
        lsum += part_l[p0 + s * G] * wt;
        o += part_acc[(p0 + s * G) * HD + dd] * wt;
      }
    }
    out[static_cast<int64_t>(bh) * G * HD + i] =
        __float2bfloat16(mx == -INFINITY ? 0.f : o / fmaxf(lsum, 1e-30f));
  }
}

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int32_t* lengths;
  __nv_bfloat16* out;
  float* part_m;
  float* part_l;
  float* part_acc;
  int B, KV, G, S, nsplit, split_len;
  int64_t skb, sks, skh, svb, svs, svh;
  int window;
  float sm_scale;
};

template <int HD, int G>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(a.B * a.KV, a.nsplit);
  decode_kernel<HD, G><<<grid, kThreads, 0, stream>>>(
      a.q, a.k, a.v, a.lengths, a.out, a.part_m, a.part_l, a.part_acc, a.KV,
      a.S, a.split_len, a.skb, a.sks, a.skh, a.svb, a.svs, a.svh, a.window,
      a.sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  merge_kernel<HD><<<a.B * a.KV, kThreads, 0, stream>>>(
      a.part_m, a.part_l, a.part_acc, a.out, G, a.nsplit);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_g(const Args& a, cudaStream_t st) {
  switch (a.G) {
    case 1: return launch<HD, 1>(a, st);
    case 2: return launch<HD, 2>(a, st);
    case 4: return launch<HD, 4>(a, st);
    case 8: return launch<HD, 8>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, KV * G, hd) bf16 contiguous; k/v bf16 addressed as (B, S, KV, hd)
// through the element strides s*b, s*s, s*h (hd stride 1, every row 16-byte
// aligned); lengths (B,) int32 on the device; out like q. With nsplit > 1
// the positions are cut into splits of split_len (a multiple of 32) and
// part_m/part_l (B * KV * nsplit * G) and part_acc (... * hd) f32 hold the
// partials the merge kernel combines; with nsplit == 1 they may be null.
// window <= 0 means no window. Returns a cudaError_t (0 on success).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* part_m, void* part_l, void* part_acc, int B, int KV,
    int G, int S, int hd, int nsplit, int split_len, int64_t skb, int64_t sks,
    int64_t skh, int64_t svb, int64_t svs, int64_t svh, int window,
    float sm_scale, void* stream) {
  if (B <= 0 || KV <= 0 || nsplit <= 0 || split_len <= 0 || split_len % 32 ||
      (nsplit > 1 && (part_m == nullptr || part_l == nullptr ||
                      part_acc == nullptr)))
    return cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               static_cast<const int32_t*>(lengths),
               static_cast<__nv_bfloat16*>(out),
               static_cast<float*>(part_m),
               static_cast<float*>(part_l),
               static_cast<float*>(part_acc),
               B, KV, G, S, nsplit, split_len, skb, sks, skh, svb, svs, svh,
               window, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:  return launch_g<32>(a, st);
    case 64:  return launch_g<64>(a, st);
    case 128: return launch_g<128>(a, st);
    default:  return cudaErrorInvalidValue;
  }
}

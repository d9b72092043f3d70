// RMS norm over the last dim, for Hopper (sm_90a), row-invariant by
// construction.
//
// Replaces the jnp function src/repro/models/layers.py::rmsnorm (:29), which
// XLA fuses on the TPU; there is no Pallas kernel for it. Function: x (rows,
// d) bf16 is taken to f32, multiplied by rsqrt(mean(x^2) + eps), then by w
// in f32, and written back in bf16.
//
// Why a kernel: PyTorch's f32 mean on the card reduces in an order that
// follows the number of rows, so the same row normalised among 40 rows (a
// speculative verify forward) and among 8 (a decode step) can differ in its
// last bit, and a deep stack amplifies that (chip_smoke.check_rmsnorm
// reports it: on an H100, at d 2048, the f32 mean of squares of 810 of
// 4160 rows differed between calls of 8 rows and of 40). Here a row's bits depend only
// on the row, w, eps and d: one warp a row, whichever CTA it lands in; lane
// l accumulates the squares of its 16-byte chunks l, l + 32, l + 64, ... in
// that order (one fma chain a lane), then a fixed xor-shuffle tree sums the
// lanes. The launch (one row a CTA of one warp) depends on nothing but
// constants, and no row is ever split.
//
// What bounds it on this card: the bytes (x and w read once, the output
// written once), under a microsecond of transfer at the decode shapes,
// where the time is latency: a launch and the round trips a warp makes.
// So the kernel is instantiated for every width the port's configs use
// (chunks a lane known at compile time): a lane issues all its x loads and
// (up to d 4096) its w loads as 16-byte vectors before its first fma,
// keeps x in registers for the output, and a decode step's 8 rows run as
// 8 CTAs on 8 SMs: one round trip for the row, one for the stores. It takes
// what the models give it: bf16 activations, f32 weights (lm.cast_params
// keeps the norms in f32).
//
// The gradient (rmsnorm_bwd_launch, for training) replaces the gradient
// XLA derives for the jnp function. Bytes bound it: x and dy read once, dx
// written once (and w, dw). The first form read x and dy three
// times and took three launches for dw; this one reads them once, from one
// launch that also leaves dw's partial sums: one warp a row, the lane's x
// and dy chunks loaded as 16-byte vectors before its first fma and kept
// in registers for the second use (an instance per width up to 16 chunks
// a lane, the generic loop above that), w in registers up to d 1024 and
// staged once a CTA in shared memory above. dx keeps the first form's arithmetic in its order (so its
// bits, and row invariance); dw is summed in a fixed order with no
// atomics: each warp over its rows in shared memory, the CTA's warps in
// order into one partial row, then a small second launch over the
// partial rows (rmsnorm_bwd_dw_sum). The plan (warps a CTA, rows a warp)
// is a function of (rows, d) alone (kernels/rmsnorm.py::_bwd_plan), so
// two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <type_traits>

namespace rmsnorm {

constexpr int kFwdThreads = 32;           // the forward: one row a CTA
constexpr int kPrefetchW = 16;            // chunks a lane whose w is loaded
                                          // up front (d <= 4096)
constexpr int kChunk = 8;                 // bf16 elements in 16 bytes
constexpr int kBwdWarps = 8;              // the gradient: most warps a CTA
constexpr int kSumPieces = 8;             // dw_sum: float4 pieces a CTA
constexpr int kSumGroups = 32;            // dw_sum: blocks of partial rows

// chunk c (16 bytes) of a bf16 row as f32
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* row, int c,
                                           float (&v)[kChunk]) {
  const uint4 t = *reinterpret_cast<const uint4*>(row + c * kChunk);
  const uint32_t u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// 16 bytes global -> shared without registers (cp.async; a plain copy in
// a host build of the body), complete once copy_async_wait_all returns in
// the thread that issued it
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<unsigned>(__cvta_generic_to_shared(dst))),
                  "l"(src)
               : "memory");
#else
  std::memcpy(dst, src, 16);
#endif
}

__device__ __forceinline__ void copy_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// f32 pairs -> bf16x2, round to nearest even
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return uint32_t(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (uint32_t(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

// The forward's row: one warp, lane l owning chunks l, l + 32, ... (below
// d / kChunk) in that order. CPL (chunks a lane, at most) fixes the trip
// count at compile time, so every load of x and of w is issued before the
// first fma and the row stays in registers for the output: x is read once.
// w's loads come first too: into registers up to kPrefetchW chunks a lane;
// past that (d 6144 and 8192) they would hold 192 or 256 registers and
// spill, so they are asynchronous copies into the lane's own slots of
// shared memory (copy16_async), read back after the shuffle tree.
// CPL 0 is the generic form (a runtime trip count, any d a multiple of
// kChunk). The order of every f32 operation is the generic form's: a
// lane's fma chain over its chunks in order, the xor tree, rsqrtf, then
// (x * r) * w per element.
template <int CPL>
__device__ __forceinline__ void rmsnorm_row(
    const __nv_bfloat16* __restrict__ xr, const float* __restrict__ w,
    __nv_bfloat16* __restrict__ orow, int d, float eps, int lane) {
  const int chunks = d / kChunk;
  if constexpr (CPL == 0) {
    float ss = 0.f;
    for (int c = lane; c < chunks; c += 32) {
      float v[kChunk];
      load_chunk(xr, c, v);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) ss = fmaf(v[i], v[i], ss);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    for (int c = lane; c < chunks; c += 32) {
      float v[kChunk];
      load_chunk(xr, c, v);
      uint32_t u[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        u[i] = pack2((v[2 * i] * r) * w[c * kChunk + 2 * i],
                     (v[2 * i + 1] * r) * w[c * kChunk + 2 * i + 1]);
      uint4 t;
      t.x = u[0]; t.y = u[1]; t.z = u[2]; t.w = u[3];
      *reinterpret_cast<uint4*>(orow + c * kChunk) = t;
    }
  } else {
    constexpr bool kW = CPL <= kPrefetchW;
    uint4 xs[CPL];
    float4 ws[kW ? CPL : 1][2];
    __shared__ __align__(16) float4 wsm[kW ? 1 : 2 * 32 * CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
        if constexpr (kW) {
          ws[i][0] = *reinterpret_cast<const float4*>(w + c * kChunk);
          ws[i][1] = *reinterpret_cast<const float4*>(w + c * kChunk + 4);
        } else {
          copy16_async(&wsm[2 * c], w + c * kChunk);
          copy16_async(&wsm[2 * c + 1], w + c * kChunk + 4);
        }
        xs[i] = *reinterpret_cast<const uint4*>(xr + c * kChunk);
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      if (lane + 32 * i < chunks) {
        const uint32_t u[4] = {xs[i].x, xs[i].y, xs[i].z, xs[i].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float lo = __uint_as_float(u[k] << 16);
          const float hi = __uint_as_float(u[k] & 0xffff0000u);
          ss = fmaf(lo, lo, ss);
          ss = fmaf(hi, hi, ss);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float r = rsqrtf(ss / static_cast<float>(d) + eps);
    if constexpr (!kW) copy_async_wait_all();
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
        float4 w0, w1;
        if constexpr (kW) {
          w0 = ws[kW ? i : 0][0];
          w1 = ws[kW ? i : 0][1];
        } else {
          w0 = wsm[2 * c];
          w1 = wsm[2 * c + 1];
        }
        const float wv[kChunk] = {w0.x, w0.y, w0.z, w0.w,
                                  w1.x, w1.y, w1.z, w1.w};
        const uint32_t u[4] = {xs[i].x, xs[i].y, xs[i].z, xs[i].w};
        uint32_t p[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          p[k] = pack2((__uint_as_float(u[k] << 16) * r) * wv[2 * k],
                       (__uint_as_float(u[k] & 0xffff0000u) * r) *
                           wv[2 * k + 1]);
        uint4 t;
        t.x = p[0]; t.y = p[1]; t.z = p[2]; t.w = p[3];
        *reinterpret_cast<uint4*>(orow + c * kChunk) = t;
      }
    }
  }
}

// Row blockIdx.x of bf16 x (rows at stride sx, in elements) with f32 w;
// out contiguous; d a multiple of kChunk (and at most 32 * CPL * kChunk
// for CPL > 0). One warp a CTA, so a decode step's 8 rows run on 8 SMs.
template <int CPL>
__global__ void __launch_bounds__(kFwdThreads)
rmsnorm_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
               __nv_bfloat16* __restrict__ out, int rows, int d, int64_t sx,
               float eps) {
  const int row = blockIdx.x;
  if (row >= rows) return;
  rmsnorm_row<CPL>(x + row * sx, w, out + static_cast<int64_t>(row) * d, d,
                   eps, threadIdx.x % 32);
}

// Calls f(std::integral_constant<int, CPL>{}) with the CPL of the kernel
// instance that takes width d: the least count of chunks a lane that covers
// d where the port's configs have such a width (d 64 to 8192), else 0.
template <typename F>
void with_chunks_per_lane(int d, F&& f) {
  switch ((d / kChunk + 31) / 32) {
    case 1:  f(std::integral_constant<int, 1>{}); return;    // d <= 256
    case 2:  f(std::integral_constant<int, 2>{}); return;    // 512
    case 3:  f(std::integral_constant<int, 3>{}); return;    // 768
    case 4:  f(std::integral_constant<int, 4>{}); return;    // 1024
    case 8:  f(std::integral_constant<int, 8>{}); return;    // 2048
    case 10: f(std::integral_constant<int, 10>{}); return;   // 2560
    case 14: f(std::integral_constant<int, 14>{}); return;   // 3584
    case 16: f(std::integral_constant<int, 16>{}); return;   // 4096
    case 24: f(std::integral_constant<int, 24>{}); return;   // 6144
    case 32: f(std::integral_constant<int, 32>{}); return;   // 8192
    default: f(std::integral_constant<int, 0>{}); return;
  }
}

// The gradient's dynamic shared memory: w (d floats), then with dw one
// slice of d floats a warp for its dw sums; dw_sum's warp sums. Every
// array is float4 pieces in half-major order: piece h * chunks + c holds
// elements 8c + 4h .. 8c + 4h + 3, so a warp's lanes (chunks l, l + 32,
// ...) touch consecutive pieces. (A host build runs the body on the CPU
// one CTA at a time: one array serves every CTA.)
#ifdef __CUDACC__
extern __shared__ __align__(16) float4 rmsnorm_bwd_smem[];
#else
alignas(16) inline float4 rmsnorm_bwd_smem[1 << 15];
#endif

// w's chunk c (8 floats) from its half-major copy in shared memory
__device__ __forceinline__ void w_chunk(const float4* wsm, int chunks, int c,
                                        float (&wv)[kChunk]) {
  const float4 a = wsm[c], b = wsm[chunks + c];
  wv[0] = a.x; wv[1] = a.y; wv[2] = a.z; wv[3] = a.w;
  wv[4] = b.x; wv[5] = b.y; wv[6] = b.z; wv[7] = b.w;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// A lane's x and dy chunks of one row as 16-byte vectors (CPL > 0), and
// their loads, issued together.
template <int CPL>
struct RowRegs {
  uint4 x[CPL], g[CPL];
};
template <>
struct RowRegs<0> {};

// w held by the lane in registers (its chunks' 8 floats as two float4s),
// loaded with the first row: up to 4 chunks a lane (d <= 1024), where the
// 32 registers are cheap. Wider rows stage w once a CTA in shared memory
// (cp.async) and wait for it at a CTA barrier, which cost ~1.3 us of a
// 1024 x 1024 call on an H100 80GB HBM3 at 700 W (in registers: 7.4 ->
// 5.7 us with dw, 5.0 -> 3.7 without); at d 2048 the registers would cost
// the second CTA an SM that the plan counts on.
template <int CPL>
constexpr bool kWRegs = CPL > 0 && CPL <= 4;
template <int CPL>
struct WRegs {
  float4 w[kWRegs<CPL> ? CPL : 1][2];
};

template <int CPL>
__device__ __forceinline__ void load_row(RowRegs<CPL>& rr,
                                         const __nv_bfloat16* __restrict__ xr,
                                         const __nv_bfloat16* __restrict__ gr,
                                         int chunks, int lane) {
  if constexpr (CPL > 0) {
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
        rr.x[i] = *reinterpret_cast<const uint4*>(xr + c * kChunk);
        rr.g[i] = *reinterpret_cast<const uint4*>(gr + c * kChunk);
      }
    }
  }
}

// One row's gradient by one warp: with r = rsqrt(mean(x^2) + eps) (the
// forward's sum, in its order and tree, so r has the forward's bits) and
// g = w * dy,
//   dx = r * g - x * r^3 * mean(x * g),
// in f32, rounded once to bf16. The lane's chunks accumulate sum(x * g)
// in the order of sum(x^2) (one fma chain each, chunk by chunk, element
// by element), the same xor tree sums the lanes, and each element is
// r * (w * g) - x * k: the arithmetic of the first backward kernel,
// so a row's dx bits depend on the row, dy's row, w and eps only.
// With DW the lane adds (x * r) * dy of each of its elements to its warp's
// slice `acc` (a multiply, a multiply, an add, each rounded: the order is
// pinned, never contracted).
// CPL (chunks a lane, at most; 1 to 16) fixes the trip count: the row
// comes in `rr`, loaded before (load_row), and stays in registers for the
// second use. CPL 0 is the generic form (any d a multiple of kChunk, x
// and dy loaded in each pass), which also takes d 6144 and 8192: there x
// and dy would hold 192 or 256 registers a lane.
template <int CPL, bool DW>
__device__ __forceinline__ void rmsnorm_bwd_row(
    const RowRegs<CPL>& rr, const WRegs<CPL>& wr,
    const __nv_bfloat16* __restrict__ xr,
    const __nv_bfloat16* __restrict__ gr, const float4* wsm, float4* acc,
    __nv_bfloat16* __restrict__ orow, int d, float eps, int lane) {
  const int chunks = d / kChunk;
  float ss = 0.f, sg = 0.f;
  // f(c, v, g, wv) for each chunk c = lane + 32 i of the lane, in order,
  // with its x, dy and w as f32
  auto each = [&](auto&& f) {
    float v[kChunk], g[kChunk], wv[kChunk];
    if constexpr (CPL > 0) {
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        if (c < chunks) {
          const uint32_t u[4] = {rr.x[i].x, rr.x[i].y, rr.x[i].z, rr.x[i].w};
          const uint32_t h[4] = {rr.g[i].x, rr.g[i].y, rr.g[i].z, rr.g[i].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            v[2 * k] = __uint_as_float(u[k] << 16);
            v[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
            g[2 * k] = __uint_as_float(h[k] << 16);
            g[2 * k + 1] = __uint_as_float(h[k] & 0xffff0000u);
          }
          if constexpr (kWRegs<CPL>) {
            const float4 a = wr.w[i][0], b = wr.w[i][1];
            wv[0] = a.x; wv[1] = a.y; wv[2] = a.z; wv[3] = a.w;
            wv[4] = b.x; wv[5] = b.y; wv[6] = b.z; wv[7] = b.w;
          } else {
            w_chunk(wsm, chunks, c, wv);
          }
          f(c, v, g, wv);
        }
      }
    } else {
      for (int c = lane; c < chunks; c += 32) {
        load_chunk(xr, c, v);
        load_chunk(gr, c, g);
        w_chunk(wsm, chunks, c, wv);
        f(c, v, g, wv);
      }
    }
  };
  each([&](int, const float (&v)[kChunk], const float (&g)[kChunk],
           const float (&wv)[kChunk]) {
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      ss = fmaf(v[e], v[e], ss);
      sg = fmaf(v[e], wv[e] * g[e], sg);
    }
  });
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
    sg += __shfl_xor_sync(0xffffffffu, sg, o);
  }
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  const float k = (sg / static_cast<float>(d)) * (r * r * r);
  each([&](int c, const float (&v)[kChunk], const float (&g)[kChunk],
           const float (&wv)[kChunk]) {
    uint32_t u[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      u[e] = pack2(r * (wv[2 * e] * g[2 * e]) - v[2 * e] * k,
                   r * (wv[2 * e + 1] * g[2 * e + 1]) - v[2 * e + 1] * k);
    uint4 t;
    t.x = u[0]; t.y = u[1]; t.z = u[2]; t.w = u[3];
    *reinterpret_cast<uint4*>(orow + c * kChunk) = t;
    if constexpr (DW) {
      float p[kChunk];
#pragma unroll
      for (int e = 0; e < kChunk; ++e)
        p[e] = __fmul_rn(__fmul_rn(v[e], r), g[e]);
      acc[c] = add4(acc[c], make_float4(p[0], p[1], p[2], p[3]));
      acc[chunks + c] = add4(acc[chunks + c],
                             make_float4(p[4], p[5], p[6], p[7]));
    }
  });
}

// The gradient's launch: CTA b of `warps` warps holds rows b * warps * T
// + t * warps + v (warp v, t = 0 .. T - 1 in order, T = rows_per_warp),
// one row a warp at a time. A warp's first row is loaded before w (into
// registers, or staged into shared memory), so the round trips overlap.
// (Loading the next row while this one is computed, at twice the
// registers, was no faster on the card: two CTAs an SM overlap rows
// instead, kernels/rmsnorm.py::_bwd_plan.) With DW
// (`part` not null) each warp sums its rows' (x * r) * dy in row order in
// its shared slice (from zero), then the CTA adds the slices in warp
// order and writes them as partial row b of `part` (half-major float4
// pieces, 16-byte stores). dy rows at stride sdy.
template <int CPL, bool DW>
__global__ void __launch_bounds__(32 * kBwdWarps)
rmsnorm_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ dy,
                   const float* __restrict__ w, __nv_bfloat16* __restrict__ dx,
                   float* __restrict__ part, int rows, int d, int64_t sx,
                   int64_t sdy, float eps, int rows_per_warp) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32, nthreads = blockDim.x;
  const int chunks = d / kChunk, pieces = d / 4;
  float4* wsm = rmsnorm_bwd_smem;
  float4* acc = wsm + pieces * (1 + warp);
  int row = blockIdx.x * warps * rows_per_warp + warp;
  RowRegs<CPL> rr;
  WRegs<CPL> wr;
  if (row < rows) load_row(rr, x + row * sx, dy + row * sdy, chunks, lane);
  if constexpr (kWRegs<CPL>) {
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
        wr.w[i][0] = *reinterpret_cast<const float4*>(w + c * kChunk);
        wr.w[i][1] = *reinterpret_cast<const float4*>(w + c * kChunk + 4);
      }
    }
  } else {
    for (int q = threadIdx.x; q < pieces; q += nthreads)
      copy16_async(&wsm[(q & 1) * chunks + q / 2], w + 4 * q);
  }
  if constexpr (DW) {
    for (int j = lane; j < pieces; j += 32)
      acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncwarp();
  }
  if constexpr (!kWRegs<CPL>) {
    copy_async_wait_all();
    __syncthreads();
  }
  // (row < rows is warp-uniform, and so for every later t)
  for (int t = 0; t < rows_per_warp && row < rows; ++t, row += warps) {
    if (t > 0) load_row(rr, x + row * sx, dy + row * sdy, chunks, lane);
    rmsnorm_bwd_row<CPL, DW>(rr, wr, x + row * sx, dy + row * sdy, wsm,
                             acc, dx + static_cast<int64_t>(row) * d, d,
                             eps, lane);
  }
  if constexpr (DW) {
    __syncthreads();
    float4* out = reinterpret_cast<float4*>(part) +
                  static_cast<int64_t>(blockIdx.x) * pieces;
    for (int j = threadIdx.x; j < pieces; j += nthreads) {
      float4 s = wsm[pieces + j];
      for (int v = 1; v < warps; ++v) s = add4(s, wsm[pieces * (1 + v) + j]);
      out[j] = s;
    }
  }
}

// dw from the kernel's `nparts` partial rows: CTA blockIdx.x owns
// kSumPieces float4 pieces; its thread group u (kSumPieces threads, one a
// piece) sums the partial rows of block u of kSumGroups equal blocks (the
// last ones shorter, maybe empty) in row order from zero, then the groups'
// sums meet in a fixed pairwise tree in shared memory (at each level h =
// kSumGroups / 2, ..., 1, group u < h adds group u + h). A fixed order:
// dw's bits depend on the plan (rows and d) and the data only.
__global__ void __launch_bounds__(kSumPieces * kSumGroups)
rmsnorm_bwd_dw_sum(const float4* __restrict__ part, float* __restrict__ dw,
                   int nparts, int d) {
  const int piece = threadIdx.x % kSumPieces, grp = threadIdx.x / kSumPieces;
  const int chunks = d / kChunk, pieces = d / 4;
  const int j = blockIdx.x * kSumPieces + piece;
  const int per = (nparts + kSumGroups - 1) / kSumGroups;
  const int p0 = min(nparts, grp * per), p1 = min(nparts, p0 + per);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (j < pieces) {
    for (int p = p0; p < p1; ++p)
      s = add4(s, part[static_cast<int64_t>(p) * pieces + j]);
  }
  float4* red = rmsnorm_bwd_smem;         // [kSumGroups][kSumPieces]
  red[threadIdx.x] = s;
  for (int h = kSumGroups / 2; h > 0; h /= 2) {
    __syncthreads();
    if (grp < h)
      red[threadIdx.x] = add4(red[threadIdx.x],
                              red[threadIdx.x + h * kSumPieces]);
  }
  if (grp == 0 && j < pieces) {
    const int col = (j % chunks) * kChunk + (j / chunks) * 4;
    *reinterpret_cast<float4*>(dw + col) = red[piece];
  }
}

}  // namespace rmsnorm

// The launcher needs nvcc; a host build (g++, for the CPU tests) takes the
// kernel alone.
#ifdef __CUDACC__
// x: rows of d bf16 elements at row stride sx (elements; unit element
// stride, every row 16-byte aligned); w: d f32; out: rows x d bf16
// contiguous. Returns a cudaError_t (0 on success).
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out,
                              int rows, int d, int64_t sx, float eps,
                              void* stream) {
  using namespace rmsnorm;
  if (rows < 0 || d <= 0 || d % kChunk) return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  with_chunks_per_lane(d, [&](auto cpl) {
    rmsnorm_kernel<decltype(cpl)::value>
        <<<rows, kFwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const float*>(w), static_cast<__nv_bfloat16*>(out),
            rows, d, sx, eps);
  });
  return cudaGetLastError();
}

// The gradient of rmsnorm_launch's function: x and dy rows of d bf16 at row
// strides sx and sdy (unit element stride, 16-byte aligned rows); w: d f32
// (16-byte aligned); dx: rows x d bf16 contiguous. The plan (`warps` a CTA,
// `rows_per_warp`) comes from the shapes (kernels/rmsnorm.py::_bwd_plan).
// With dw not null, part (ctas x d f32, ctas = ceil(rows / (warps *
// rows_per_warp))) is scratch and dw (d f32) receives the weight's
// gradient in a second launch, summed over the rows in a fixed order;
// without, one launch. Returns a cudaError_t.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* dy,
                                  const void* w, void* dx, void* dw,
                                  void* part, int rows, int d, int64_t sx,
                                  int64_t sdy, float eps, int warps,
                                  int rows_per_warp, void* stream) {
  using namespace rmsnorm;
  const bool with_dw = dw != nullptr;
  const size_t smem = sizeof(float) * d * (1 + (with_dw ? warps : 0));
  if (rows < 0 || d <= 0 || d % kChunk || warps < 1 || warps > kBwdWarps ||
      rows_per_warp < 1 || smem > 227 * 1024 ||
      (with_dw && part == nullptr))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (rows == 0) {
    if (with_dw) cudaMemsetAsync(dw, 0, sizeof(float) * d, st);
    return cudaGetLastError();
  }
  const int ctas = (rows + warps * rows_per_warp - 1) / (warps * rows_per_warp);
  cudaError_t err = cudaSuccess;
  with_chunks_per_lane(d, [&](auto cpl) {
    constexpr int C = decltype(cpl)::value <= 16 ? decltype(cpl)::value : 0;
    auto launch = [&](auto kernel) {
      if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return;
      }
      kernel<<<ctas, 32 * warps, smem, st>>>(
          static_cast<const __nv_bfloat16*>(x),
          static_cast<const __nv_bfloat16*>(dy),
          static_cast<const float*>(w), static_cast<__nv_bfloat16*>(dx),
          static_cast<float*>(part), rows, d, sx, sdy, eps, rows_per_warp);
      err = cudaGetLastError();
    };
    if (with_dw) launch(rmsnorm_bwd_kernel<C, true>);
    else launch(rmsnorm_bwd_kernel<C, false>);
  });
  if (err != cudaSuccess || !with_dw) return err;
  rmsnorm_bwd_dw_sum<<<(d / 4 + kSumPieces - 1) / kSumPieces,
                       kSumPieces * kSumGroups,
                       sizeof(float4) * kSumPieces * kSumGroups, st>>>(
      static_cast<const float4*>(part), static_cast<float*>(dw), ctas, d);
  return cudaGetLastError();
}
#endif  // __CUDACC__

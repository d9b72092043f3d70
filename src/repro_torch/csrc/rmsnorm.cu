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
// The gradient (rmsnorm_bwd_launch, for training through the task API)
// replaces the gradient XLA derives for the jnp function: dx by one warp a
// row with the forward's reduction order (row-invariant in the same way),
// and, when the weight needs one, dw in two fixed-order passes (partial
// sums over chunks of 64 rows, then the chunks in order: no atomics, so two
// calls give the same bits). Bytes bound it too: x and dy read twice (the
// second time from L1/L2), dx written, and x and dy once more for dw.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <type_traits>

namespace rmsnorm {

constexpr int kFwdThreads = 32;           // the forward: one row a CTA
constexpr int kPrefetchW = 16;            // chunks a lane whose w is loaded
                                          // up front (d <= 4096)
constexpr int kRows = 4;                  // the gradient: rows (warps) a CTA
constexpr int kThreads = 32 * kRows;
constexpr int kChunk = 8;                 // bf16 elements in 16 bytes
constexpr int kDwRows = 64;               // rows a dw partial sums
constexpr int kDwThreads = 256;           // columns a dw CTA covers

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

// The gradient, one warp a row as in the forward, which it mirrors: with
// r = rsqrt(mean(x^2) + eps) (the forward's sum, in its order and tree,
// so r has the forward's bits) and g = w * dy,
//   dx = r * g - x * r^3 * mean(x * g),
// in f32, rounded once to bf16. The lane's chunks accumulate sum(x * g) in
// the order of sum(x^2), and the same xor tree sums the lanes, so a row's
// dx bits depend on the row, dy's row, w and eps only. With `rstd` not
// null, lane 0 writes r for the dw passes. dy rows at stride sdy.
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ dy,
                   const float* __restrict__ w, __nv_bfloat16* __restrict__ dx,
                   float* __restrict__ rstd, int rows, int d, int64_t sx,
                   int64_t sdy, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRows + threadIdx.x / 32;
  if (row >= rows) return;                // warp-uniform
  const __nv_bfloat16* xr = x + row * sx;
  const __nv_bfloat16* gr = dy + row * sdy;
  __nv_bfloat16* orow = dx + static_cast<int64_t>(row) * d;
  const int chunks = d / kChunk;
  float ss = 0.f, sg = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    float v[kChunk], g[kChunk];
    load_chunk(xr, c, v);
    load_chunk(gr, c, g);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      ss = fmaf(v[i], v[i], ss);
      sg = fmaf(v[i], w[c * kChunk + i] * g[i], sg);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
    sg += __shfl_xor_sync(0xffffffffu, sg, o);
  }
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  const float k = (sg / static_cast<float>(d)) * (r * r * r);
  if (rstd != nullptr && lane == 0) rstd[row] = r;
  for (int c = lane; c < chunks; c += 32) {
    float v[kChunk], g[kChunk];
    load_chunk(xr, c, v);
    load_chunk(gr, c, g);
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = c * kChunk + 2 * i;
      u[i] = pack2(r * (w[e] * g[2 * i]) - v[2 * i] * k,
                   r * (w[e + 1] * g[2 * i + 1]) - v[2 * i + 1] * k);
    }
    uint4 t;
    t.x = u[0]; t.y = u[1]; t.z = u[2]; t.w = u[3];
    *reinterpret_cast<uint4*>(orow + c * kChunk) = t;
  }
}

// dw's partial sums: column `col` of row chunk blockIdx.y (kDwRows rows)
// sums (x * r) * dy over its rows in order into part[chunk * d + col].
__global__ void __launch_bounds__(kDwThreads)
rmsnorm_bwd_dw_partial(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ dy,
                       const float* __restrict__ rstd,
                       float* __restrict__ part, int rows, int d, int64_t sx,
                       int64_t sdy) {
  const int col = blockIdx.x * kDwThreads + threadIdx.x;
  if (col >= d) return;
  const int r0 = blockIdx.y * kDwRows, r1 = min(rows, r0 + kDwRows);
  float acc = 0.f;
  for (int row = r0; row < r1; ++row)
    acc = fmaf(__bfloat162float(x[row * sx + col]) * rstd[row],
               __bfloat162float(dy[row * sdy + col]), acc);
  part[static_cast<int64_t>(blockIdx.y) * d + col] = acc;
}

// dw[col] = the chunks' partials summed in chunk order.
__global__ void __launch_bounds__(kDwThreads)
rmsnorm_bwd_dw_sum(const float* __restrict__ part, float* __restrict__ dw,
                   int nchunks, int d) {
  const int col = blockIdx.x * kDwThreads + threadIdx.x;
  if (col >= d) return;
  float s = 0.f;
  for (int c = 0; c < nchunks; ++c) s += part[static_cast<int64_t>(c) * d + col];
  dw[col] = s;
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
// strides sx and sdy (unit element stride, 16-byte aligned rows); w: d f32;
// dx: rows x d bf16 contiguous. With dw not null, rstd (rows f32) and part
// (ceil(rows / 64) x d f32) are scratch and dw (d f32) receives the weight's
// gradient, summed over the rows in a fixed order. Returns a cudaError_t.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* dy,
                                  const void* w, void* dx, void* dw,
                                  void* rstd, void* part, int rows, int d,
                                  int64_t sx, int64_t sdy, float eps,
                                  void* stream) {
  using namespace rmsnorm;
  if (rows < 0 || d <= 0 || d % kChunk ||
      (dw != nullptr && (rstd == nullptr || part == nullptr)))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (rows == 0) {
    if (dw != nullptr) cudaMemsetAsync(dw, 0, sizeof(float) * d, st);
    return cudaGetLastError();
  }
  rmsnorm_bwd_kernel<<<(rows + kRows - 1) / kRows, kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dy), static_cast<const float*>(w),
      static_cast<__nv_bfloat16*>(dx),
      dw != nullptr ? static_cast<float*>(rstd) : nullptr, rows, d, sx, sdy,
      eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dw == nullptr) return err;
  const int nchunks = (rows + kDwRows - 1) / kDwRows;
  const int cols = (d + kDwThreads - 1) / kDwThreads;
  rmsnorm_bwd_dw_partial<<<dim3(cols, nchunks), kDwThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dy), static_cast<const float*>(rstd),
      static_cast<float*>(part), rows, d, sx, sdy);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_dw_sum<<<cols, kDwThreads, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(dw), nchunks, d);
  return cudaGetLastError();
}
#endif  // __CUDACC__

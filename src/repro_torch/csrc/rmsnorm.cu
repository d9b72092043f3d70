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
// on the row, w, eps and d: one warp a row, whichever CTA or warp slot it
// lands in; lane l accumulates the squares of its 16-byte chunks l, l + 32,
// l + 64, ... in that order (one fma chain a lane), then a fixed xor-shuffle
// tree sums the lanes. The launch (rows per CTA, threads) depends on nothing
// but constants, and no row is ever split.
//
// What bounds it on this card: the bytes (x read once for the sum and again,
// from L1/L2, for the output; w; the output), a few microseconds at the
// decode shapes, where it is launch- and latency-bound (8 rows: 2 CTAs).
// It takes what the models give it: bf16 activations, f32 weights
// (lm.cast_params keeps the norms in f32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rmsnorm {

constexpr int kRows = 4;                  // rows (warps) a CTA
constexpr int kThreads = 32 * kRows;
constexpr int kChunk = 8;                 // bf16 elements in 16 bytes

// Row r = blockIdx.x * kRows + warp of bf16 x (rows at stride sx, in
// elements) with f32 w; out contiguous; d a multiple of kChunk.
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
               __nv_bfloat16* __restrict__ out, int rows, int d, int64_t sx,
               float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRows + threadIdx.x / 32;
  if (row >= rows) return;                // warp-uniform
  const __nv_bfloat16* xr = x + row * sx;
  __nv_bfloat16* orow = out + static_cast<int64_t>(row) * d;
  const int chunks = d / kChunk;
  // this lane's chunk c (16 bytes) as f32
  auto load = [&](int c, float (&v)[kChunk]) {
    const uint4 t = *reinterpret_cast<const uint4*>(xr + c * kChunk);
    const uint32_t u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(u[i] << 16);
      v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  };
  float ss = 0.f;
  for (int c = lane; c < chunks; c += 32) {
    float v[kChunk];
    load(c, v);
#pragma unroll
    for (int i = 0; i < kChunk; ++i) ss = fmaf(v[i], v[i], ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  for (int c = lane; c < chunks; c += 32) {
    float v[kChunk];
    load(c, v);
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lo = (v[2 * i] * r) * w[c * kChunk + 2 * i];
      const float hi = (v[2 * i + 1] * r) * w[c * kChunk + 2 * i + 1];
      u[i] = uint32_t(__bfloat16_as_ushort(__float2bfloat16(lo))) |
             (uint32_t(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
    }
    uint4 t;
    t.x = u[0]; t.y = u[1]; t.z = u[2]; t.w = u[3];
    *reinterpret_cast<uint4*>(orow + c * kChunk) = t;
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
  rmsnorm_kernel<<<(rows + kRows - 1) / kRows, kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<__nv_bfloat16*>(out), rows, d, sx, eps);
  return cudaGetLastError();
}
#endif  // __CUDACC__

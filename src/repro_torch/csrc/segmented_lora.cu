// Segmented multi-adapter LoRA (SGMV) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/segmented_lora.py::segmented_lora
// (Pallas, pl.pallas_call at :72). Same function: the token batch is sorted by
// adapter and padded so every block of `block_t` rows belongs to ONE adapter;
// block i computes y_blk = (x_blk @ A[a_i]) @ B[a_i] with f32 accumulation and
// writes it in x's dtype (bf16). An id outside [0, NA) is the "no adapter"
// sentinel and writes a zero block (the pad rows of the sort must get
// defined zeros, never be skipped).
//
// What bounds it on this card: bytes. Per block the work is
// 2*block_t*r*(d + out) flops against 2*block_t*(d + out) bytes of bf16
// activations, i.e. r flops per byte (16 at r = 16), far below the
// ~295 flops/byte where an H100 stops being memory bound. The adapter weights
// (NA x (d*r + r*out) f32) are shared by every block of an adapter and stay in
// L2 (50 MB) across blocks.
//
// Design: one CTA per (token block, output column range). The CTA loads its
// block's adapter id itself (the TPU version gets it by scalar prefetch).
// Phase 1 computes h = x_blk @ A (block_t x R, f32): d is walked in tiles
// of kt rows; each tile of A (contiguous) and of x (transposed to k-major,
// converted to f32) is copied into shared memory with coalesced 16-byte
// loads, and each thread accumulates a 4-row x 4-column block of h in
// registers over its slice of the tile's k (two conflict-free float4
// shared loads per 16 FMAs); the k-slices are summed through shared memory
// at the end. Phase 2 gives every thread one output column: it keeps that
// column of B (R floats) in registers and writes h @ B for all block_t
// rows, coalesced across the warp. The column range per CTA is chosen by
// the host so that small decode batches (a few blocks) still spread over
// the SMs, while large pooled batches recompute h for only a few column
// ranges. No tensor cores yet (A is f32, and the JAX kernel multiplies in
// f32): a wgmma/TMA version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBytes = 48 * 1024;

template <int R>
__global__ void __launch_bounds__(kThreads)
sgmv_kernel(const __nv_bfloat16* __restrict__ x,
            const int32_t* __restrict__ block_adapter,
            const float* __restrict__ a, const float* __restrict__ b,
            __nv_bfloat16* __restrict__ y, int d, int out, int na,
            int block_t, int cols_per_cta, int kt) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int blk = blockIdx.x;
  const int n_begin = blockIdx.y * cols_per_cta;
  const int n_end = min(out, n_begin + cols_per_cta);
  const int aid = block_adapter[blk];
  const int64_t row0 = static_cast<int64_t>(blk) * block_t;

  if (aid < 0 || aid >= na) {               // sentinel block: zero delta
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int t = 0; t < block_t; ++t)
      for (int n = n_begin + threadIdx.x; n < n_end; n += kThreads)
        y[(row0 + t) * out + n] = zero;
    return;
  }

  constexpr int nq = R / 4;                 // column quads of h
  const int ks = kThreads / ((block_t / 4) * nq);   // k slices
  const int jq = threadIdx.x % nq;          // lanes: jq fastest, then s,
  const int s = (threadIdx.x / nq) % ks;    // so shared reads of A and x
  const int tg = threadIdx.x / (nq * ks);   // are conflict-free
  const float* A = a + static_cast<int64_t>(aid) * d * R;
  const float* B = b + static_cast<int64_t>(aid) * R * out;
  float* As = smem;                         // kt x R
  float* Xs = smem + kt * R;                // kt x block_t (k-major)

  // ---- phase 1: h = x_blk @ A over tiles of kt rows of d ----
  float acc[4][4] = {};
  for (int k0 = 0; k0 < d; k0 += kt) {
    const int kc = min(kt, d - k0);
    __syncthreads();                        // previous tile consumed
    const float4* Ag = reinterpret_cast<const float4*>(A + static_cast<int64_t>(k0) * R);
    for (int i = threadIdx.x; i < kc * nq; i += kThreads)
      smem4[i] = Ag[i];
    for (int i = threadIdx.x; i < block_t * (kc / 8); i += kThreads) {
      const int t = i % block_t, k8 = i / block_t;
      const uint4 v = *reinterpret_cast<const uint4*>(
          x + (row0 + t) * d + k0 + 8 * k8);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a bf16 is the high half of an f32: shift, do not convert
        Xs[(8 * k8 + 2 * e) * block_t + t] = __uint_as_float(w[e] << 16);
        Xs[(8 * k8 + 2 * e + 1) * block_t + t] =
            __uint_as_float(w[e] & 0xffff0000u);
      }
    }
    __syncthreads();
    for (int k = s; k < kc; k += ks) {
      const float4 av = reinterpret_cast<const float4*>(As + k * R)[jq];
      const float4 xv = reinterpret_cast<const float4*>(Xs + k * block_t)[tg];
      const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] = fmaf(xr[r], av.x, acc[r][0]);
        acc[r][1] = fmaf(xr[r], av.y, acc[r][1]);
        acc[r][2] = fmaf(xr[r], av.z, acc[r][2]);
        acc[r][3] = fmaf(xr[r], av.w, acc[r][3]);
      }
    }
  }
  // sum the k slices: red[s][t][j] (ks * block_t * R == 16 * kThreads floats)
  __syncthreads();
  float* red = smem;
  float* h = smem + 16 * kThreads > Xs + kt * block_t
                 ? smem + 16 * kThreads : Xs + kt * block_t;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    reinterpret_cast<float4*>(red)[(s * block_t + 4 * tg + r) * nq + jq] =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  for (int i = threadIdx.x; i < block_t * R; i += kThreads) {
    float sum = 0.f;
    for (int q = 0; q < ks; ++q) sum += red[q * block_t * R + i];
    h[i] = sum;                             // h[t * R + j]
  }
  __syncthreads();

  // ---- phase 2: y[:, n] = h @ B[:, n], one column per thread ----
  for (int n = n_begin + threadIdx.x; n < n_end; n += kThreads) {
    float bc[R];
#pragma unroll
    for (int j = 0; j < R; ++j) bc[j] = B[static_cast<int64_t>(j) * out + n];
    for (int tt = 0; tt < block_t; ++tt) {
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) sum = fmaf(h[tt * R + j], bc[j], sum);
      y[(row0 + tt) * out + n] = __float2bfloat16(sum);
    }
  }
}

template <int R>
cudaError_t launch(const void* x, const void* block_adapter, const void* a,
                   const void* b, void* y, int num_blocks, int d, int out,
                   int na, int block_t, int col_ctas, cudaStream_t stream) {
  // the largest tile (a multiple of 8 rows, at most 256) whose A and x
  // copies plus h fit in 48 KB; the k-slice sums reuse the tile space
  const int floats = kSmemBytes / 4 - block_t * R;
  int kt = min(256, floats / (R + block_t)) / 8 * 8;
  if (kt < 8) return cudaErrorInvalidValue;
  const int region = max(kt * (R + block_t), 16 * kThreads);
  const size_t smem = sizeof(float) * static_cast<size_t>(region + block_t * R);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sgmv_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int cols_per_cta = (out + col_ctas - 1) / col_ctas;
  dim3 grid(num_blocks, col_ctas);
  sgmv_kernel<R><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const int32_t*>(block_adapter),
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<__nv_bfloat16*>(y), d, out, na, block_t, cols_per_cta, kt);
  return cudaGetLastError();
}

}  // namespace

// x (T, d) bf16; block_adapter (T / block_t,) int32; a (NA, d, r) f32;
// b (NA, r, out) f32; y (T, out) bf16. All contiguous and 16-byte aligned;
// d % 8 == 0; block_t % 4 == 0 with (block_t / 4) * (r / 4) dividing 256.
// Returns a cudaError_t (0 on success); -1 for a rank without an
// instantiation or a block shape the thread layout does not cover.
extern "C" int sgmv_launch(const void* x, const void* block_adapter,
                           const void* a, const void* b, void* y,
                           int num_blocks, int d, int r, int out, int na,
                           int block_t, int col_ctas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_t <= 0 || block_t % 4 || d % 8 || r % 4 ||
      kThreads % ((block_t / 4) * (r / 4)))
    return -1;
  switch (r) {
    case 4:  return launch<4>(x, block_adapter, a, b, y, num_blocks, d, out, na, block_t, col_ctas, s);
    case 8:  return launch<8>(x, block_adapter, a, b, y, num_blocks, d, out, na, block_t, col_ctas, s);
    case 16: return launch<16>(x, block_adapter, a, b, y, num_blocks, d, out, na, block_t, col_ctas, s);
    case 32: return launch<32>(x, block_adapter, a, b, y, num_blocks, d, out, na, block_t, col_ctas, s);
    case 64: return launch<64>(x, block_adapter, a, b, y, num_blocks, d, out, na, block_t, col_ctas, s);
    default: return -1;
  }
}

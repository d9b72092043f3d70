// Segmented multi-adapter LoRA (SGMV) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/segmented_lora.py::segmented_lora
// (Pallas, pl.pallas_call at :72). Same function: the token batch is sorted by
// adapter and padded so every block of `block_t` rows belongs to ONE adapter;
// block i computes y_blk = (x_blk @ A[a_i]) @ B[a_i] with f32 products and
// accumulation (h = x_blk @ A stays f32 between the two products, as in the
// JAX kernel) and writes it in x's dtype (bf16). An id outside [0, NA) is the
// "no adapter" sentinel and writes a zero block (the pad rows of the sort
// must get defined zeros, never be skipped).
//
// What bounds it on this card: bytes, and at decode the latency of a small
// grid. Per block the work is 2*block_t*r*(d + out) flops against
// 2*block_t*(d + out) bytes of bf16 activations, r flops per byte (16 at
// r = 16), far below the ~295 flops/byte where an H100 stops being memory
// bound; the adapter weights (NA x (d*r + r*out) f32) are shared by every
// block of an adapter and stay in L2 (50 MB). At decode (6 blocks of 16
// rows, d = out = 2048) the bytes take a fraction of a microsecond, so what
// counts is how many dependent round trips to memory each CTA makes and
// whether the grid covers the SMs.
//
// Design: the shrink/expand split of GPU SGMV kernels (Punica, S-LoRA), two
// kernels launched from one entry point.
// * Shrink, grid (blocks, d-splits): CTA (i, s) computes the partial
//   h_s = x_blk[:, k-range s] @ A[a_i][k-range s] (block_t x r, f32) and
//   writes it to a workspace; no atomics. The host plans the d-split from
//   the shapes so that a decode batch of a few blocks still puts about one
//   CTA on every SM (at most kSumChunk splits), and a pooled batch, whose
//   blocks already fill the card, takes one split. A CTA copies its A rows
//   (f32) and x rows (bf16) into shared memory by cp.async in tiles of kt
//   rows, two tiles in flight: at decode the whole slice is one tile, one
//   round trip. Each thread accumulates a 4-row x 4-column block of h over
//   its slice of the tile's k (one conflict-free float4 shared load of A per
//   16 FMAs), and the slices are summed through shared memory in a fixed
//   order. Sentinel blocks skip.
// * Expand, grid (blocks, ranges of kCols columns): the CTA sums its
//   block's d-split partials in split order (all loads in flight at once;
//   the same bits on every run) into h in shared memory, transposed so one
//   float4 read gives four rows; each thread owns 4 adjacent columns and a
//   quarter of the rows: float4 reads of B (each B row read once per CTA),
//   4 x 4 FMAs per h column, 8-byte bf16 stores. Sentinel blocks write
//   zeros and read nothing.
// No tensor cores: the JAX kernel multiplies in f32, and at rank 16 the
// decode work is ~12.6 MFLOP.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kShrinkRing = 40 * 1024;    // two tiles of A and x, bytes
constexpr int kQuads = 64;                // column quads an expand CTA owns
constexpr int kRowGroups = 4;             // row quads walked in parallel
constexpr int kExpandThreads = kQuads * kRowGroups;
constexpr int kCols = 4 * kQuads;         // columns an expand CTA owns
constexpr int kSumChunk = 16;             // d-split partials loaded at once

// 16 bytes global -> shared, asynchronous.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A bf16 is the high half of an f32: shift, do not convert.
__device__ __forceinline__ float bf16_bits(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

template <int R>
__global__ void __launch_bounds__(kThreads)
shrink_kernel(const __nv_bfloat16* __restrict__ x,
              const int32_t* __restrict__ block_adapter,
              const float* __restrict__ a, float* __restrict__ ws, int d,
              int na, int block_t, int split_len, int kt) {
  extern __shared__ float4 smem4[];
  const int blk = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int aid = block_adapter[blk];
  if (aid < 0 || aid >= na) return;         // sentinel: the expand writes 0
  const int k_lo = split * split_len;
  const int k_hi = min(d, k_lo + split_len);
  const int n_tiles = (k_hi - k_lo + kt - 1) / kt;
  const int64_t row0 = static_cast<int64_t>(blk) * block_t;
  const float* A = a + static_cast<int64_t>(aid) * d * R;

  // a tile: kt rows of A (kt x R f32, contiguous), then x (block_t x kt
  // bf16, row t of the block at t * kt)
  const int stage_bytes = kt * R * 4 + block_t * kt * 2;
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem4);
  auto issue = [&](int t) {
    if (t < n_tiles) {
      const int k0 = k_lo + t * kt, kc = min(kt, k_hi - k0);
      unsigned char* st = ring + (t & 1) * stage_bytes;
      const float4* Ag = reinterpret_cast<const float4*>(A + static_cast<int64_t>(k0) * R);
      for (int i = threadIdx.x; i < kc * R / 4; i += kThreads)
        cp_async16(reinterpret_cast<float4*>(st) + i, Ag + i);
      __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(st + kt * R * 4);
      const int pieces = kc / 8;            // 16-byte pieces per x row
      for (int i = threadIdx.x; i < block_t * pieces; i += kThreads) {
        const int tt = i / pieces, p = i % pieces;
        cp_async16(xs + tt * kt + 8 * p, x + (row0 + tt) * d + k0 + 8 * p);
      }
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  constexpr int nq = R / 4;                 // column quads of h
  const int ks = kThreads / ((block_t / 4) * nq);   // k slices
  const int jq = threadIdx.x % nq;          // lanes: jq fastest, then s,
  const int s = (threadIdx.x / nq) % ks;    // so shared reads of A and x
  const int tg = threadIdx.x / (nq * ks);   // are conflict-free
  float acc[4][4] = {};
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<1>();
    __syncthreads();                        // tile t landed for every thread
    const unsigned char* st = ring + (t & 1) * stage_bytes;
    const float* As = reinterpret_cast<const float*>(st);
    const uint16_t* xs = reinterpret_cast<const uint16_t*>(st + kt * R * 4) + 4 * tg * kt;
    const int kc = min(kt, k_hi - (k_lo + t * kt));
    for (int k = s; k < kc; k += ks) {
      const float4 av = reinterpret_cast<const float4*>(As + k * R)[jq];
      float xr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) xr[r] = bf16_bits(xs[r * kt + k]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] = fmaf(xr[r], av.x, acc[r][0]);
        acc[r][1] = fmaf(xr[r], av.y, acc[r][1]);
        acc[r][2] = fmaf(xr[r], av.z, acc[r][2]);
        acc[r][3] = fmaf(xr[r], av.w, acc[r][3]);
      }
    }
    __syncthreads();                        // tile t read: its slot is free
    issue(t + 2);
  }
  cp_async_wait<0>();

  // sum the k slices in slice order: red[s][t][j] (ks * block_t * R ==
  // 16 * kThreads floats, in the ring's space)
  float* red = reinterpret_cast<float*>(smem4);
#pragma unroll
  for (int r = 0; r < 4; ++r)
    reinterpret_cast<float4*>(red)[(s * block_t + 4 * tg + r) * nq + jq] =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  float* out = ws + (static_cast<int64_t>(blk) * nsplit + split) * block_t * R;
  for (int i = threadIdx.x; i < block_t * R; i += kThreads) {
    float sum = 0.f;
    for (int q = 0; q < ks; ++q) sum += red[q * block_t * R + i];
    out[i] = sum;                           // h_s[t * R + j]
  }
}

template <int R>
__global__ void __launch_bounds__(kExpandThreads)
expand_kernel(const float* __restrict__ ws,
              const int32_t* __restrict__ block_adapter,
              const float* __restrict__ b, __nv_bfloat16* __restrict__ y,
              int out, int na, int block_t, int nsplit) {
  __shared__ __align__(16) float ht[16 * kThreads];   // h^T: ht[j * block_t + t]
  const int blk = blockIdx.x;
  const int aid = block_adapter[blk];
  const int64_t row0 = static_cast<int64_t>(blk) * block_t;
  const int cq = threadIdx.x % kQuads, rg = threadIdx.x / kQuads;
  const int n = blockIdx.y * kCols + 4 * cq;
  // 16-byte B rows and 8-byte y quads where the widths allow
  const bool vec = out % 4 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;

  if (aid < 0 || aid >= na) {               // sentinel block: zero delta
    if (n >= out) return;
    for (int t = rg; t < block_t; t += kRowGroups) {
      __nv_bfloat16* yr = y + (row0 + t) * out + n;
      if (vec) {
        *reinterpret_cast<uint2*>(yr) = make_uint2(0u, 0u);
      } else {
        for (int c = 0; c < 4 && n + c < out; ++c) yr[c] = __float2bfloat16(0.f);
      }
    }
    return;
  }

  // h = the d-split partials summed in split order, kSumChunk loads in
  // flight at a time (past the last split a chunk adds zeros)
  const float* part = ws + static_cast<int64_t>(blk) * nsplit * block_t * R;
  for (int i = threadIdx.x; i < block_t * R; i += kExpandThreads) {
    float sum = 0.f;
    for (int q0 = 0; q0 < nsplit; q0 += kSumChunk) {
      float v[kSumChunk];
#pragma unroll
      for (int u = 0; u < kSumChunk; ++u)
        v[u] = q0 + u < nsplit ? part[static_cast<int64_t>(q0 + u) * block_t * R + i] : 0.f;
#pragma unroll
      for (int u = 0; u < kSumChunk; ++u) sum += v[u];
    }
    ht[(i % R) * block_t + i / R] = sum;
  }
  __syncthreads();
  if (n >= out) return;

  const float* B = b + static_cast<int64_t>(aid) * R * out + n;
  for (int t0 = 4 * rg; t0 < block_t; t0 += 4 * kRowGroups) {
    float acc[4][4] = {};
#pragma unroll 16
    for (int j = 0; j < R; ++j) {
      float bv[4];
      if (vec) {
        const float4 b4 = *reinterpret_cast<const float4*>(B + static_cast<int64_t>(j) * out);
        bv[0] = b4.x; bv[1] = b4.y; bv[2] = b4.z; bv[3] = b4.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          bv[c] = n + c < out ? B[static_cast<int64_t>(j) * out + c] : 0.f;
      }
      const float4 hv = *reinterpret_cast<const float4*>(ht + j * block_t + t0);
      const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(hr[r], bv[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      __nv_bfloat16* yr = y + (row0 + t0 + r) * out + n;
      if (vec) {
        const __nv_bfloat162 lo = __floats2bfloat162_rn(acc[r][0], acc[r][1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[r][2], acc[r][3]);
        uint2 w;
        w.x = *reinterpret_cast<const uint32_t*>(&lo);
        w.y = *reinterpret_cast<const uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(yr) = w;
      } else {
        for (int c = 0; c < 4 && n + c < out; ++c) yr[c] = __float2bfloat16(acc[r][c]);
      }
    }
  }
}

template <int R>
cudaError_t launch(const void* x, const void* block_adapter, const void* a,
                   const void* b, void* y, void* ws, int num_blocks, int d,
                   int out, int na, int block_t, int nsplit, int split_len,
                   cudaStream_t stream) {
  // tile rows: the largest multiple of 8 (at most the split) whose two
  // stages of A and x fit the ring; the k-slice sums reuse the space
  const int row_bytes = R * 4 + block_t * 2;
  int kt = min(kShrinkRing / (2 * row_bytes), (split_len + 7) / 8 * 8) / 8 * 8;
  if (kt < 8) return cudaErrorInvalidValue;
  const size_t smem = max(2 * kt * row_bytes, 16 * kThreads * 4);
  shrink_kernel<R><<<dim3(num_blocks, nsplit), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const int32_t*>(block_adapter), static_cast<const float*>(a),
      static_cast<float*>(ws), d, na, block_t, split_len, kt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  expand_kernel<R><<<dim3(num_blocks, (out + kCols - 1) / kCols),
                     kExpandThreads, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const int32_t*>(block_adapter),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y), out, na,
      block_t, nsplit);
  return cudaGetLastError();
}

}  // namespace

// x (T, d) bf16; block_adapter (T / block_t,) int32; a (NA, d, r) f32;
// b (NA, r, out) f32; y (T, out) bf16; ws (num_blocks * nsplit * block_t * r)
// f32 scratch. x, a and y contiguous and 16-byte aligned, b contiguous;
// d % 8 == 0; block_t % 4 == 0 with (block_t / 4) * (r / 4) dividing 256;
// d cut into nsplit splits of split_len rows (a multiple of 8). Returns a
// cudaError_t (0 on success); -1 for a rank without an instantiation or a
// shape the thread layout does not cover.
extern "C" int sgmv_launch(const void* x, const void* block_adapter,
                           const void* a, const void* b, void* y, void* ws,
                           int num_blocks, int d, int r, int out, int na,
                           int block_t, int nsplit, int split_len,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (block_t <= 0 || block_t % 4 || d % 8 || r % 4 || split_len % 8 ||
      nsplit <= 0 || split_len <= 0 ||
      kThreads % ((block_t / 4) * (r / 4)))
    return -1;
  switch (r) {
    case 4:  return launch<4>(x, block_adapter, a, b, y, ws, num_blocks, d, out, na, block_t, nsplit, split_len, s);
    case 8:  return launch<8>(x, block_adapter, a, b, y, ws, num_blocks, d, out, na, block_t, nsplit, split_len, s);
    case 16: return launch<16>(x, block_adapter, a, b, y, ws, num_blocks, d, out, na, block_t, nsplit, split_len, s);
    case 32: return launch<32>(x, block_adapter, a, b, y, ws, num_blocks, d, out, na, block_t, nsplit, split_len, s);
    case 64: return launch<64>(x, block_adapter, a, b, y, ws, num_blocks, d, out, na, block_t, nsplit, split_len, s);
    default: return -1;
  }
}

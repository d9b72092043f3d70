// Host stand-in for the parts of the CUDA runtime and device library that
// the kernels in src/repro_torch/csrc/ (int8_decode.cuh,
// int8_split_decode.cuh, rmsnorm.cu) use, so that g++ can compile their
// bodies for the CPU (tests/_int8_host.py and the test files that import
// it, tests/test_torch_rmsnorm.py, tests/test_torch_autograd.py). A grid
// runs one CTA at a time; each CUDA thread is a std::thread; __syncthreads
// is a barrier of the CTA. A warp-wide exchange (__shfl_xor_sync, and the
// mma.sync stand-in) writes the lane's words into one of two slot arrays,
// meets the warp at one barrier and reads: the arrays alternate, so the
// next exchange's writes cannot meet this one's reads (a lane writes again
// only after the next barrier, which every lane reaches after its reads).
// Every lane of a warp must reach each exchange (as on the card).
// __shared__ is empty: the one shared array, declared extern, is defined
// by the test as a plain global. cp.async copies are deferred to the wait
// that covers their group, so a body that reads a stage before waiting
// for it reads stale bytes here too.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __device__
#define __host__
#define __global__
#define __shared__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) __attribute__((aligned(n)))

typedef int cudaError_t;

struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim;

struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

template <class T> inline T __ldg(const T* p) { return *p; }
inline float __uint_as_float(unsigned u) { float f; std::memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; std::memcpy(&u, &f, 4); return u; }
inline float __int_as_float(int u) { float f; std::memcpy(&f, &u, 4); return f; }
inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = (uint64_t(y) << 32) | x;
  unsigned r = 0;
  for (int n = 0; n < 4; ++n)
    r |= unsigned((v >> (8 * ((s >> (4 * n)) & 7))) & 0xff) << (8 * n);
  return r;
}

constexpr int kHostWords = 8;              // words a lane puts into an exchange

struct HostGrid {
  std::unique_ptr<std::barrier<>> cta;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<uint32_t> words;           // 2 x threads x kHostWords
};
inline HostGrid host_grid;
inline thread_local int host_parity = 0;  // which slot array the next exchange uses

inline void __syncthreads() { host_grid.cta->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  host_grid.warps[threadIdx.x / 32]->arrive_and_wait();
}

// Put this lane's n words into the exchange, meet the warp, and return the
// warp's slots (lane l's words at [l * kHostWords]).
inline const uint32_t* host_exchange(const uint32_t* mine, int n) {
  const int t = threadIdx.x, w = t / 32;
  uint32_t* slots = host_grid.words.data() +
                    static_cast<size_t>(host_parity) * blockDim.x * kHostWords;
  std::memcpy(slots + t * kHostWords, mine, 4 * n);
  host_parity ^= 1;
  host_grid.warps[w]->arrive_and_wait();
  return slots + w * 32 * kHostWords;
}

inline float __shfl_xor_sync(unsigned, float v, int o) {
  const uint32_t u = __float_as_uint(v);
  const uint32_t* warp = host_exchange(&u, 1);
  return __uint_as_float(warp[((threadIdx.x % 32) ^ o) * kHostWords]);
}

// ---- f16 and the primitives of the split body (int8_split_decode.cuh) ----

inline float f16_to_float(uint32_t h) {
  const uint32_t sign = (h & 0x8000u) << 16, e = (h >> 10) & 0x1f, m = h & 0x3ff;
  if (e == 0) {                                   // zero or subnormal
    const float v = std::ldexp(static_cast<float>(m), -24);
    return sign ? -v : v;
  }
  const uint32_t u = e == 31 ? sign | 0x7f800000u | (m << 13)
                             : sign | ((e + 112) << 23) | (m << 13);
  return __uint_as_float(u);
}

// f32 -> f16 bits, round to nearest even (subnormals, overflow to inf)
inline uint32_t f16_from_float(float f) {
  const uint32_t u = __float_as_uint(f), sign = (u >> 16) & 0x8000u;
  const float a = std::fabs(f);
  if (std::isnan(f)) return sign | 0x7e00u;
  if (a >= 65520.f) return sign | 0x7c00u;        // rounds past the largest
  if (a < 6.103515625e-05f) {                     // subnormal: units of 2^-24
    return sign | static_cast<uint32_t>(std::nearbyint(std::ldexp(a, 24)));
  }
  const uint32_t au = u & 0x7fffffffu;
  const uint32_t e = (au >> 23) - 112, m = au & 0x7fffffu;
  uint32_t h = (e << 10) | (m >> 13);
  const uint32_t rest = m & 0x1fffu;
  if (rest > 0x1000u || (rest == 0x1000u && (h & 1u))) ++h;
  return sign | h;
}

inline uint32_t f16x2_pack(float lo, float hi) {
  return f16_from_float(lo) | (f16_from_float(hi) << 16);
}

inline uint32_t f16x2_sub(uint32_t a, uint32_t b) {
  return f16_from_float(f16_to_float(a & 0xffffu) - f16_to_float(b & 0xffffu)) |
         (f16_from_float(f16_to_float(a >> 16) - f16_to_float(b >> 16)) << 16);
}

// mma.sync.m16n8k16.row.col.f32.f16.f16.f32 over the warp, by the PTX ISA's
// fragment layout (lane = 4 g + t): A's registers 0-3 hold (row g, k 2t
// and 2t + 1), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..); B's two
// hold (k 2t and 2t + 1, column g), (k 2t + 8.., g); C's four are (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1). Low half = the lower k. The
// products are exact in f32; they are summed in k order onto c.
inline void mma_f16_16816(float* c, const uint32_t* a, uint32_t b0,
                          uint32_t b1) {
  const uint32_t mine[6] = {a[0], a[1], a[2], a[3], b0, b1};
  const uint32_t* warp = host_exchange(mine, 6);
  auto half = [](uint32_t w, int k) { return f16_to_float(k & 1 ? w >> 16 : w & 0xffffu); };
  auto A = [&](int r, int k) {
    const int lane = 4 * (r & 7) + (k & 7) / 2;
    return half(warp[lane * kHostWords + (k >= 8 ? 2 : 0) + (r >= 8 ? 1 : 0)], k);
  };
  auto B = [&](int k, int n) {
    const int lane = 4 * n + (k & 7) / 2;
    return half(warp[lane * kHostWords + 4 + (k >= 8 ? 1 : 0)], k);
  };
  const int l = threadIdx.x % 32, g = l / 4, t = l % 4;
  for (int i = 0; i < 4; ++i) {
    const int r = g + 8 * (i / 2), n = 2 * t + (i % 2);
    float s = c[i];
    for (int k = 0; k < 16; ++k) s += A(r, k) * B(k, n);
    c[i] = s;
  }
}

// cp.async: a 16-byte copy queued in this thread's open group; commit
// closes the group; wait<N> performs every group but the N newest
struct HostCopy { void* dst; const void* src; };
inline thread_local std::vector<std::vector<HostCopy>> host_copy_groups;
inline thread_local std::vector<HostCopy> host_copy_open;

inline void cp_async16(void* dst, const void* src) {
  host_copy_open.push_back({dst, src});
}
inline void cp_async_commit() {
  host_copy_groups.push_back(std::move(host_copy_open));
  host_copy_open.clear();
}
template <int N>
inline void cp_async_wait() {
  while (host_copy_groups.size() > static_cast<size_t>(N)) {
    for (const HostCopy& c : host_copy_groups.front()) std::memcpy(c.dst, c.src, 16);
    host_copy_groups.erase(host_copy_groups.begin());
  }
}

// Run `body` as a grid of gx x gy CTAs of `threads` threads, one CTA at a
// time. The `threads` std::threads are started once for the grid and walk
// the CTAs together, meeting at the CTA barrier after each one (so a body
// that returns early waits there for the rest of its CTA), which keeps a
// grid of thousands of CTAs from starting thousands of threads each.
inline void host_launch(int gx, int gy, int threads,
                        const std::function<void()>& body) {
  host_grid.cta = std::make_unique<std::barrier<>>(threads);
  host_grid.warps.clear();
  for (int w = 0; w < threads / 32; ++w)
    host_grid.warps.push_back(std::make_unique<std::barrier<>>(32));
  host_grid.words.assign(2 * static_cast<size_t>(threads) * kHostWords, 0u);
  blockDim.x = threads;
  std::vector<std::thread> ts;
  for (int t = 0; t < threads; ++t)
    ts.emplace_back([&, t] {
      threadIdx.x = t;
      for (int y = 0; y < gy; ++y)
        for (int x = 0; x < gx; ++x) {
          blockIdx.x = x;
          blockIdx.y = y;
          host_parity = 0;
          host_copy_groups.clear();
          host_copy_open.clear();
          body();
          host_grid.cta->arrive_and_wait();
        }
    });
  for (auto& th : ts) th.join();
}

// A grid of `grid` CTAs along x.
inline void host_launch(int grid, int threads, const std::function<void()>& body) {
  host_launch(grid, 1, threads, body);
}

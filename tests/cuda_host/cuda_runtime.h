// Host stand-in for the parts of the CUDA runtime and device library that
// the kernels in src/repro_torch/csrc/ (int8_decode.cuh, rmsnorm.cu) use, so
// that g++ can compile their bodies for the CPU
// (tests/test_torch_int8_decode_host.py, tests/test_torch_rmsnorm.py,
// tests/test_torch_autograd.py). A
// grid runs one CTA at a time; each CUDA thread is a std::thread;
// __syncthreads is a barrier of the CTA and __shfl_xor_sync an exchange
// through a per-warp slot array between two barriers of the warp, so every
// lane of a warp must reach each shuffle (as on the card). __shared__ is
// empty: the one shared array, declared extern, is defined by the test as
// a plain global.
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

struct HostGrid {
  std::unique_ptr<std::barrier<>> cta;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<float> slots;
};
inline HostGrid host_grid;

inline void __syncthreads() { host_grid.cta->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  host_grid.warps[threadIdx.x / 32]->arrive_and_wait();
}

inline float __shfl_xor_sync(unsigned, float v, int o) {
  const int t = threadIdx.x, w = t / 32, l = t % 32;
  host_grid.slots[t] = v;
  host_grid.warps[w]->arrive_and_wait();
  const float r = host_grid.slots[w * 32 + (l ^ o)];
  host_grid.warps[w]->arrive_and_wait();
  return r;
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
  host_grid.slots.assign(threads, 0.f);
  blockDim.x = threads;
  std::vector<std::thread> ts;
  for (int t = 0; t < threads; ++t)
    ts.emplace_back([&, t] {
      threadIdx.x = t;
      for (int y = 0; y < gy; ++y)
        for (int x = 0; x < gx; ++x) {
          blockIdx.x = x;
          blockIdx.y = y;
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

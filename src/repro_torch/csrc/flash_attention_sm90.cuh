// The Hopper body of the prefill flash attention (K2), beside the mma.sync
// body of flash_attention.cu: the same function (see that file's head) for
// calls without a prefix segment, on wgmma and TMA. The wrapper's plan
// (kernels/flash_attention.py::plan, shapes only) picks the body, the rows
// a CTA holds (64 or 128) and the key split; flash_attention_sm90_launch in
// flash_attention.cu launches this body and, for several splits, the mma
// body's merge kernel.
//
// What bounds it on this card: bytes at the pooled forwards (stablelm's
// B=32 x 128 positions x 32 heads of 64: 67 MB against 2.2 GFLOP of causal
// products, 20 us at 3.35 TB/s) and operations at whisper's bidirectional
// encoder (1500 x 1500 x 8 heads of 64: 4.6 GFLOP, 4.7 us at 989 TFLOP/s).
// The mma.sync body misses both: its 64-row CTAs walk a (row, kv head)
// pair's keys once per query tile (1.5x the bytes at the pooled shape),
// each CTA pays a DRAM round trip before its first product with two
// 32-key stages in flight, and mma.sync m16n8k16 keeps the tensor cores at
// ~12% of their rate on the encoder. This body:
//
// - Work items. An item is (query tile, kv head, batch row, key split).
//   The grid holds as many CTAs as fit the card at once (or fewer, one an
//   item), each walking items blockIdx.x, + gridDim.x, ...: the producer
//   loads the next item's Q and first K/V tiles while the consumers finish
//   this one, so DRAM stays busy across items (a CTA an item left the card
//   loading in lockstep waves, idle between them).
// - Rows. One or two consumer warpgroups (NWG) of 64 (query, head) rows
//   each, packed as in the mma body: row r = (query r / G, head r % G), so
//   the G heads sharing a kv head share every K/V tile; rows from
//   (64 NWG / G) G on are dead (G 7 with 128 rows: 18 queries in 126 rows).
//   At 128 rows a 128-token pooled row's keys are walked once for each
//   (row, kv head).
// - Producer and consumers. A producer warpgroup after the consumers gives
//   its registers to them (setmaxnreg) and one of its threads issues every
//   load by TMA (cp.async.bulk.tensor, 128-byte swizzle): each item's Q into
//   one of two Q buffers, and K and V tiles (128 keys at hd 64, 64 at hd
//   128) into a ring of two stages that runs on across items, each buffer
//   and stage a full mbarrier (the TMA's transaction bytes) and an empty
//   one. The
//   tensor maps cover the model layout (B, S, heads, hd) by its strides;
//   keys and queries past the tensor read as zeros (the masks make them
//   inert) and output rows past it are not written. The maps are kernel
//   parameters (__grid_constant__), so a captured CUDA graph replays them.
// - Both products on wgmma. S = Q K^T is m64nKk16 with both operands
//   K-major in swizzled shared memory; P V is m64nHDk16 with P the register
//   A operand (the S accumulator rounded to bf16 in place: the fragment
//   layouts coincide) and V the MN-major B operand straight from its
//   row-major tile, so nothing is transposed.
// - Overlap. Within a warpgroup, tile t's S = Q K^T and tile t - 1's P V
//   are issued together and the softmax of tile t runs while P V is on the
//   tensor cores (the accumulator is rescaled after it lands); across
//   warpgroups and CTAs on an SM, one's softmax runs beside another's
//   products.
// - The epilogue writes each row's bf16 output into its own Q rows (the
//   128-byte swizzle); the producer stores the item's rows from there by
//   TMA once every consumer warp has arrived, before the buffer takes the
//   Q of the item after next.
// - The kernel's name keeps "flash_attention_kernel" (as the mma body's
//   merge does), so that a profile filtered on it counts every K2 pass.
// - Same semantics as the mma body: the masks (kv_len, the causal end, the
//   window start) per element where a tile can reach them, the tile range
//   cut to what the item's queries see, and per warpgroup to what its own
//   queries see (lengths read on the device); f32 accumulation, l summed
//   from f32 p, only the P operand rounded; out = acc / max(l, 1e-30),
//   zeros for a row without a valid key; the log-sum-exp for the backward;
//   the key split's f32 partials for the mma body's merge.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {
namespace fa90 {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// keys a K/V tile (tools/flash_plan.py's A/B): at hd 64, 128 with one
// consumer warpgroup, 192 with two and no causal or window mask (fewer,
// wider S products: whisper's encoder), but 64 with two under a mask (a
// 128-token causal row's two 64-row halves then walk one and two tiles);
// at hd 128, 64 (the S accumulator and the output's within the
// consumers' registers)
constexpr int key_tile(int hd, int nwg, bool masked) {
  return hd != 64 ? 64 : nwg == 1 ? 128 : masked ? 64 : 192;
}

// Q buffers: an item's Q, then its output, is in one while the next
// item's Q lands in the other (a third gained nothing on the card)
constexpr int kQBufs = 2;

// the ring's stages: two where two CTAs share an SM, else as many as fit
// beside the Q buffers (at most six: three items of a pooled forward's 128
// keys at 64 a tile)
constexpr int clamp_to(int x, int lo, int hi) {
  return x < lo ? lo : x > hi ? hi : x;
}

constexpr int ring_stages(int hd, int nwg, int kn) {
  return nwg == 1 ? 2
                  : clamp_to((220 * 1024 - kQBufs * 64 * nwg * hd * 2) /
                                 (4 * kn * hd),
                             2, 6);
}

struct Args {
  const int32_t* kv_len;      // (B,) or null
  float* part_m;              // split partials (nsplit > 1), else null
  float* part_l;
  float* part_acc;
  float* lse;                 // (B, KV * G, Sq) or null
  int B, Sq, Sk, KV, G, nsplit, split_len, causal, window;
  int nqt, nitems;            // query tiles, items
  float sm_scale;
};

// shared memory: kQBufs Q buffers (HD / 64 column halves of kRows x 128
// bytes each; an item's output is staged in its Q buffer), then kStages x
// (K tile, V tile), each tile HD / 64 halves of kKeyTile x 128 bytes, then
// the barriers; 1024 bytes of slack align the base. CTAs an SM: two at one
// consumer warpgroup, one at two. The producer warpgroup gives its
// registers to the consumers (setmaxnreg): kConsumerRegs each, the CTA's
// share of the register file at launch (128 or 168 a thread) less the
// producer's kProducerRegs.
template <int HD, int NWG, int KN>
struct Layout {
  static constexpr int kRows = 64 * NWG;
  static constexpr int kKeyTile = KN;
  static constexpr int kThreads = 128 * (NWG + 1);
  static constexpr int kMinBlocks = NWG == 1 ? 2 : 1;
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs =
      NWG == 1 ? 256 - kProducerRegs : (504 - kProducerRegs) / 16 * 8;
  static constexpr int kStages = ring_stages(HD, NWG, KN);
  static constexpr int kQBytes = kRows * HD * 2;
  static constexpr int kTileBytes = kKeyTile * HD * 2;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kRingOffset = kQBufs * kQBytes;
  static constexpr int kBarOffset = kRingOffset + kStages * kStageBytes;
  static constexpr int kBytes =
      kBarOffset + 8 * (2 * kQBufs + 2 * kStages) + 1024;
};

// one work item: its place and the keys it walks, tiles of kKeyTile from
// lo; keys at or past kcut are masked (kv_len, the split's end)
struct Item {
  int q0, kvh, b, split, qlast, kcut, lo, hi, ntiles;
};

template <int KN>
__device__ __forceinline__ Item item_at(const Args& a, int idx, int bq) {
  Item w;
  const int qt = idx % a.nqt;
  int rest = idx / a.nqt;
  w.split = rest % a.nsplit;
  rest /= a.nsplit;
  w.kvh = rest % a.KV;
  w.b = rest / a.KV;
  w.q0 = qt * bq;
  w.qlast = min(a.Sq, w.q0 + bq) - 1;
  const int q_off = a.Sk - a.Sq;
  w.kcut = a.Sk;
  if (a.kv_len != nullptr) w.kcut = min(w.kcut, max(0, a.kv_len[w.b]));
  const int s_lo = w.split * a.split_len;
  w.kcut = min(w.kcut, s_lo + a.split_len);
  w.lo = s_lo;
  w.hi = w.kcut;
  if (a.window > 0) w.lo = max(w.lo, q_off + w.q0 - a.window + 1);
  if (a.causal) w.hi = min(w.hi, q_off + w.qlast + 1);
  w.ntiles = w.hi > w.lo ? (w.hi - w.lo + KN - 1) / KN : 0;
  return w;
}

__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * kLn2 : -INFINITY;
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else if constexpr (N == 128) wgmma_ss_n128(d, da, db, accumulate);
  else wgmma_ss_n192(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// named barriers of the two consumer warpgroups' turns at the tensor cores
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

template <int HD, int NWG, int KN>
__global__ void __launch_bounds__(Layout<HD, NWG, KN>::kThreads,
                                  Layout<HD, NWG, KN>::kMinBlocks)
flash_attention_kernel_sm90(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap to,
                            const Args a) {
  using L = Layout<HD, NWG, KN>;
  constexpr int kStages = L::kStages;
  constexpr int kHalves = HD / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = base + L::kRingOffset;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(base + L::kBarOffset);
  uint64_t* ostaged = qfull + kQBufs;   // an item's output is in its buffer
  uint64_t* full = ostaged + kQBufs;
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = a.G, Sq = a.Sq;
  const int bq = L::kRows / G;          // queries an item
  const int live_rows = bq * G;         // rows from here on are dead

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kQBufs; ++i) {
      mbar_init(&qfull[i], 1);
      mbar_init(&ostaged[i], 4 * NWG);
    }
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * NWG) {
    // the producer warpgroup: its first warp loads each item's Q, then its
    // K/V tiles into the ring; its registers go to the consumers
    regs_dealloc<L::kProducerRegs>();
    if (warp != 4 * NWG) return;
    if (lane == 0) {
      tma_prefetch(&tq);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      tma_prefetch(&to);
    }
    // item m's output, staged by the consumers in its Q buffer, to the
    // tensor by TMA; the buffer is free again once the store has read it
    auto store = [&](int m) {
      const int qb = m % kQBufs;
      mbar_wait(&ostaged[qb], (m / kQBufs) & 1);
      if (a.nsplit == 1) {
        const Item w = item_at<KN>(a, blockIdx.x + m * gridDim.x, bq);
#pragma unroll
        for (int h = 0; h < kHalves; ++h)
          tma_store_4d(&to, base + qb * L::kQBytes + h * L::kRows * 128,
                       64 * h, w.kvh * G, w.q0, w.b);
        tma_store_commit();
      }
    };
    int it = 0;                         // tiles loaded so far (the ring)
    int n = 0;                          // items so far (the Q buffers)
    for (int idx = blockIdx.x; idx < a.nitems; idx += gridDim.x, ++n) {
      const Item w = item_at<KN>(a, idx, bq);
      const int qb = n % kQBufs;
      if (lane == 0) {
        // item n - 2's store goes out; the one from this buffer has read
        // it before Q lands there
        if (n >= 2) store(n - 2);
        if (n >= kQBufs) tma_store_wait_read<kQBufs - 2>();
        mbar_expect_tx(&qfull[qb], live_rows * HD * 2);
#pragma unroll
        for (int h = 0; h < kHalves; ++h)
          tma_load_4d(base + qb * L::kQBytes + h * L::kRows * 128, &tq,
                      &qfull[qb], 64 * h, w.kvh * G, w.q0, w.b);
      }
      for (int t = 0; t < w.ntiles; ++t, ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(&empty[s], (it / kStages - 1) & 1);
        unsigned char* kt = ring + s * L::kStageBytes;
        const int j0 = w.lo + t * KN;
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * L::kTileBytes);
#pragma unroll
          for (int h = 0; h < kHalves; ++h) {
            tma_load_4d(kt + h * KN * 128, &tk, &full[s], 64 * h, w.kvh, j0,
                        w.b);
            tma_load_4d(kt + L::kTileBytes + h * KN * 128, &tv, &full[s],
                        64 * h, w.kvh, j0, w.b);
          }
        }
      }
    }
    if (lane == 0) {
      for (int m = max(0, n - 2); m < n; ++m) store(m);
      tma_store_wait_all();
    }
    return;
  }

  // the consumers: warpgroup wg holds rows [64 wg, 64 wg + 64), warp wl of
  // it 16 of them, this lane rows g and g + 8 of those
  regs_alloc<L::kConsumerRegs>();
  const int wg = warp / 4, wl = warp % 4;
  const int g = lane / 4, t4 = lane % 4;
  const int H = a.KV * G;
  const int r0 = 64 * wg + 16 * wl + g;
  const int q_off = a.Sk - Sq;
  const float sl2 = a.sm_scale * kLog2e;
  // this lane's rows, the warp's and the warpgroup's as queries of an item
  int rq[2], rhead[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    rq[rh] = (r0 + 8 * rh) / G;
    rhead[rh] = (r0 + 8 * rh) % G;
  }
  const int wq_lo = (64 * wg + 16 * wl) / G;
  const int wq_hi = (64 * wg + 16 * wl + 15) / G;
  const int gq_lo = (64 * wg) / G;
  const int gq_hi = min(64 * wg + 63, live_rows - 1) / G;
  // the operands' descriptors at the base of shared memory; a tile's is
  // this plus its offset in 16-byte units
  const uint64_t dk0 = desc_sw128(base, 16, 1024);
  const uint64_t dv0 = desc_sw128(base, KN * 128, 1024);
  // Two warpgroups without causal or window masks walk the same tiles of
  // each item, and take turns at the tensor cores (named barriers 2 and
  // 3): one issues its products while the other runs its softmax.
  // Warpgroup 1 gives the first turn away.
  const bool turns = NWG == 2 && !a.causal && a.window <= 0;
  if (turns && wg == 1) turn_pass(2);
  auto turn_begin = [&]() {
    if (turns) turn_wait(2 + wg);
  };
  auto turn_end = [&]() {
    if (turns) turn_pass(3 - wg);
  };
  int it = 0, n = 0;
  for (int idx = blockIdx.x; idx < a.nitems; idx += gridDim.x, ++n) {
    const Item w = item_at<KN>(a, idx, bq);
    const int qb = n % kQBufs;
    unsigned char* qs = base + qb * L::kQBytes;
    const int qa = qb * L::kQBytes + wg * 64 * 128;   // this warpgroup's Q
    int qpos[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) qpos[rh] = q_off + w.q0 + rq[rh];
    // the warp's query positions (mask need) and the warpgroup's (its
    // tiles)
    const int wpos_lo = q_off + w.q0 + wq_lo;
    const int wpos_hi = q_off + w.q0 + wq_hi;
    const int gfirst = w.q0 + gq_lo;
    const int glast = min(w.qlast, w.q0 + gq_hi);
    int t0 = 0, t1 = turns ? w.ntiles : 0;
    if (!turns && gfirst <= glast && w.ntiles > 0) {
      int wlo = w.lo, whi = w.hi;
      if (a.window > 0) wlo = max(wlo, q_off + gfirst - a.window + 1);
      if (a.causal) whi = min(whi, q_off + glast + 1);
      if (whi > wlo) {
        t0 = (wlo - w.lo) / KN;
        t1 = min(w.ntiles, (whi - w.lo + KN - 1) / KN);
      }
    }

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float sc[KN / 2];
    uint32_t pa[KN / 16][4];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    float corr[2];

    // a tile this warpgroup's queries cannot see: wait for it (so that the
    // empty barrier's phases stay in step with the producer) and release it
    auto skip = [&](int t) {
      const int s = (it + t) % kStages;
      mbar_wait(&full[s], ((it + t) / kStages) & 1);
      if (lane == 0) mbar_arrive(&empty[s]);
    };
    // S = Q K^T of tile t (issued, not waited for)
    auto issue_s = [&](int t) {
      const int kt = L::kRingOffset + ((it + t) % kStages) * L::kStageBytes;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_ss<KN>(
            sc, dk0 + ((qa + (kk / 4) * L::kRows * 128 + (kk % 4) * 32) >> 4),
            dk0 + ((kt + (kk / 4) * KN * 128 + (kk % 4) * 32) >> 4), kk > 0);
      wgmma_commit();
    };
    // acc += P V of tile t (issued, not waited for): P the softmax's
    // probabilities in bf16, V MN-major (transposed)
    auto issue_pv = [&](int t) {
      const int vt = L::kRingOffset + ((it + t) % kStages) * L::kStageBytes +
                     L::kTileBytes;
#pragma unroll
      for (int kt2 = 0; kt2 < KN / 16; ++kt2)
        wgmma_rs<HD>(o, pa[kt2], dv0 + ((vt + kt2 * 16 * 128) >> 4));
      wgmma_commit();
    };
    // the softmax of tile t's scores in sc: the masks, each row's new max
    // (the accumulator's rescale into corr), p into sc and l
    auto softmax = [&](int t) {
      const int j0 = w.lo + t * KN;
      const bool need = j0 + KN > w.kcut ||
                        (a.causal && j0 + KN - 1 > wpos_lo) ||
                        (a.window > 0 && wpos_hi - j0 >= a.window);
      if (need) {
        // each row's visible keys as [klo, khi) relative to this lane's
        // first column of the tile: column 8 j + e is visible iff
        // klo <= 8 j + e < khi
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          int khi = w.kcut, klo = j0;
          if (a.causal) khi = min(khi, qpos[rh] + 1);
          if (a.window > 0) klo = max(klo, qpos[rh] - a.window + 1);
          khi -= j0 + 2 * t4;
          klo -= j0 + 2 * t4;
#pragma unroll
          for (int j = 0; j < KN / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = sc[4 * j + 2 * rh + e];
              x = (8 * j + e < khi && 8 * j + e >= klo) ? x : -INFINITY;
            }
        }
      }
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < KN / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * rh], sc[4 * j + 2 * rh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // the scale is positive: the max of raw scores scales to the max
        const float m_new = fmaxf(m[rh], mx * sl2);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        corr[rh] = fast_exp2(m[rh] - m_use);   // m = -inf: 0
        m[rh] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < KN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            // masked: exp2(-inf) = 0
            const float p =
                fast_exp2(fmaf(sc[4 * j + 2 * rh + e], sl2, -m_use));
            sum += p;
            sc[4 * j + 2 * rh + e] = p;
          }
        }
        l[rh] = l[rh] * corr[rh] + sum;
      }
    };
    // the accumulator to the new max, and the probabilities to bf16
    auto rescale_pack = [&]() {
#pragma unroll
      for (int d = 0; d < HD / 8; ++d) {
        o[4 * d] *= corr[0];
        o[4 * d + 1] *= corr[0];
        o[4 * d + 2] *= corr[1];
        o[4 * d + 3] *= corr[1];
      }
#pragma unroll
      for (int kt2 = 0; kt2 < KN / 16; ++kt2) {
        pa[kt2][0] = pack_bf16(sc[8 * kt2], sc[8 * kt2 + 1]);
        pa[kt2][1] = pack_bf16(sc[8 * kt2 + 2], sc[8 * kt2 + 3]);
        pa[kt2][2] = pack_bf16(sc[8 * kt2 + 4], sc[8 * kt2 + 5]);
        pa[kt2][3] = pack_bf16(sc[8 * kt2 + 6], sc[8 * kt2 + 7]);
      }
    };
    mbar_wait(&qfull[qb], (n / kQBufs) & 1);
    for (int t = 0; t < t0; ++t) skip(t);
    if (t1 > t0) {
      // the first tile alone, then each tile's S with the previous tile's
      // P V, the softmax between the two waits
      mbar_wait(&full[(it + t0) % kStages], ((it + t0) / kStages) & 1);
      turn_begin();
      wgmma_fence();
      issue_s(t0);
      turn_end();
      wgmma_wait<0>();
      fence_regs<KN / 2>(sc);
      softmax(t0);
      rescale_pack();
      for (int t = t0 + 1; t < t1; ++t) {
        mbar_wait(&full[(it + t) % kStages], ((it + t) / kStages) & 1);
        turn_begin();
        wgmma_fence();
        issue_s(t);
        issue_pv(t - 1);
        turn_end();
        wgmma_wait<1>();
        fence_regs<KN / 2>(sc);
        softmax(t);
        wgmma_wait<0>();
        fence_regs<HD / 2>(o);
        if (lane == 0) mbar_arrive(&empty[(it + t - 1) % kStages]);
        rescale_pack();
      }
      turn_begin();
      wgmma_fence();
      issue_pv(t1 - 1);
      turn_end();
      wgmma_wait<0>();
      fence_regs<HD / 2>(o);
      if (lane == 0) mbar_arrive(&empty[(it + t1 - 1) % kStages]);
    }
    for (int t = t1; t < w.ntiles; ++t) skip(t);
    it += w.ntiles;

#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 1);
      l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 2);
    }
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int r = r0 + 8 * rh;
      const int qi = w.q0 + rq[rh];
      const bool live = qi < Sq && r < live_rows;
      const int h = w.kvh * G + rhead[rh];
      const int64_t row = (static_cast<int64_t>(w.b) * Sq + qi) * H + h;
      if (a.nsplit > 1) {
        // f32 partials of this split, unnormalised (m in log2 units)
        if (!live) continue;
        const int64_t prow = row * a.nsplit + w.split;
        if (t4 == 0) {
          a.part_m[prow] = m[rh];
          a.part_l[prow] = l[rh];
        }
#pragma unroll
        for (int d = 0; d < HD / 8; ++d)
          *reinterpret_cast<float2*>(a.part_acc + prow * HD + 8 * d +
                                     2 * t4) =
              make_float2(o[4 * d + 2 * rh], o[4 * d + 2 * rh + 1]);
        continue;
      }
      if (live && a.lse != nullptr && t4 == 0)
        a.lse[(static_cast<int64_t>(w.b) * H + h) * Sq + qi] =
            row_lse(m[rh], l[rh]);
      const float inv = l[rh] > 0.f ? 1.f / fmaxf(l[rh], 1e-30f) : 0.f;
      // the row's output into its own Q row: 16-byte chunk c of row r at
      // chunk c ^ (r % 8) of its half, as the TMA store reads it
#pragma unroll
      for (int d = 0; d < HD / 8; ++d)
        *reinterpret_cast<uint32_t*>(
            qs + (d / 8) * L::kRows * 128 + r * 128 +
            (((d % 8) ^ (r % 8)) * 16) + 4 * t4) =
            pack_bf16(o[4 * d + 2 * rh] * inv, o[4 * d + 2 * rh + 1] * inv);
    }
    // this warp is done with the item's Q buffer and its output rows are
    // there: the producer stores the item once every warp has arrived
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(&ostaged[qb]);
  }
}

// the number of CTAs of one instantiation an SM holds (the first call
// raises its shared-memory limit)
template <int HD, int NWG, int KN>
int blocks_per_sm() {
  using L = Layout<HD, NWG, KN>;
  static int per_sm = 0;
  if (per_sm == 0 &&
      (cudaFuncSetAttribute(flash_attention_kernel_sm90<HD, NWG, KN>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            L::kBytes) != cudaSuccess ||
       cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, flash_attention_kernel_sm90<HD, NWG, KN>, L::kThreads,
           L::kBytes) != cudaSuccess))
    per_sm = 0;
  return per_sm;
}

template <int HD, int NWG, int KN>
cudaError_t launch_kn(const CUtensorMap& tq, const CUtensorMap& tk,
                      const CUtensorMap& tv, const CUtensorMap& to,
                      const Args& a, int sms, cudaStream_t stream) {
  using L = Layout<HD, NWG, KN>;
  const int per_sm = blocks_per_sm<HD, NWG, KN>();
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  const int grid = min(a.nitems, per_sm * sms);
  flash_attention_kernel_sm90<HD, NWG, KN>
      <<<grid, L::kThreads, L::kBytes, stream>>>(tq, tk, tv, to, a);
  return cudaGetLastError();
}

// the instantiation at this key tile (key_tile's)
template <int HD, int NWG>
cudaError_t launch(int kn, const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, const CUtensorMap& to,
                   const Args& a, int sms, cudaStream_t stream) {
  if constexpr (HD == 64 && NWG == 1)
    return launch_kn<64, 1, 128>(tq, tk, tv, to, a, sms, stream);
  else if constexpr (HD == 64)
    return kn == 64 ? launch_kn<64, 2, 64>(tq, tk, tv, to, a, sms, stream)
                    : launch_kn<64, 2, 192>(tq, tk, tv, to, a, sms, stream);
  else
    return launch_kn<HD, NWG, 64>(tq, tk, tv, to, a, sms, stream);
}

}  // namespace fa90
}  // namespace

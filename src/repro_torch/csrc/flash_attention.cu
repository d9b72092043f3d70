// GQA prefill flash attention with a key-length mask and a prefix segment,
// for Hopper (sm_90a), on the tensor cores.
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
// Both products take bf16 operands and accumulate in f32, as the JAX
// function's einsums do (preferred_element_type=f32); the running sum l adds
// the f32 probabilities, and only the P operand of P.V is rounded to bf16,
// as in JAX. The output is acc / max(l, 1e-30). A query row with no valid
// key returns zeros (JAX returns the mean of the masked values there; no
// such row occurs on the serving path).
//
// Two bodies compute it: this file's, on mma.sync (below; every call with
// a prefix, hd 32 and 80, and calls of fewer than 128 queries), and the
// Hopper body on wgmma and TMA (flash_attention_sm90.cuh, launched by
// flash_attention_sm90_launch at the end of this file; the pooled
// forwards, admissions and whisper's encoder). The wrapper's plan
// (kernels/flash_attention.py::plan) picks one from the shapes.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16):
// bytes at the serving shapes of stablelm (the pooled forward, B=32 x 128
// positions x 32 heads of 64, does ~32 flops per byte it must move; an
// admission or a tail prefill at one row does fewer) and at whisper's
// cross-attention prefill (64 queries against 1500 frames); operations at
// whisper's bidirectional encoder (1500 x 1500 x 8 heads: 4.6 GFLOP on
// 6 MB). The design answers each: the products run on the tensor cores,
// so the encoder is not held to the CUDA cores' 67 TFLOP/s; K/V tiles
// stream through shared memory by cp.async while the previous tile is
// computed, so copies overlap the math; and where the CTAs are too few to
// cover the card's 132 SMs, the key split multiplies them, so the byte
// shapes at one row keep enough copies in flight.
//
// Design: one CTA of 4 warps per (query tile, kv head, batch row, key
// split) serves the G query heads that share the kv head: 64 rows of
// (query, head), row r = (query r / G, head r % G), 16 rows per warp, so a
// CTA holds bq = 64 / G queries. Where G does not divide 64 (qwen2-7b's G 7:
// 9 queries, rows 0-62) the rows from bq * G on are dead: their Q is zero,
// they are computed with the rest (the tensor-core tiles are whole) and
// never stored. Both
// products run on the tensor cores as mma.sync m16n8k16 bf16 -> f32. Q is
// staged once in shared memory and held as A fragments in registers
// (ldmatrix.x4). S = Q K^T takes each 32-key K tile as the .col B operand
// straight from its row-major (key, hd) shared-memory rows (ldmatrix, no
// transpose); P.V reuses the S accumulators as the A operand, packed to
// bf16x2 in registers (P never touches shared memory), with V's B fragments
// from ldmatrix.trans on its row-major tile. Shared rows are padded by 16
// bytes so that ldmatrix reads no bank twice. Masks apply per element of the
// S fragment from its (row, column) -> (query position, key position) map,
// and only on tiles that a mask can reach; each tile rescales (m, l, acc)
// once, the row max and sum reduced over the 4 lanes of a quad. The tile
// range of each segment is cut to what the CTA's queries can see (causal
// end, window start, kv_len, prefix_len read on the device: no host sync),
// so Sq, Sk and Sp need not be tile multiples. K and V tiles are copied
// from the model layout (B, S, KV, hd) by strides with 16-byte cp.async.cg
// (rows past a length zero-filled through the copy's src-size; the masks
// make them inert) into a ring of two stages, Q joining the first copy
// group: nothing is transposed, and the prefix is a second key segment
// walked before the new keys, never concatenated.
//
// Key split: when the (query tile, kv head, row) CTAs are too few to fill
// the card (whisper's cross-attention prefill: 1 x 8 x 1), the wrapper cuts
// the key axis [0, Sp + Sk) into splits of split_len keys (a multiple of the
// tile), chosen from the shapes alone. Each split writes f32 partials (m,
// l, acc); flash_attention_kernel_merge rescales them to the largest max and
// divides once, with no atomics. A split that the lengths or masks leave
// empty has m = -inf and l = 0 and gets zero weight.
//
// Training: with a non-null lse pointer the kernel (or, split, the merge)
// also writes each row's natural log-sum-exp of its scaled scores, (B, H,
// Sq) f32, which flash_attention_bwd.cu reads to recompute P. Serving passes
// null; the output's arithmetic is the same either way.
//
// Build (nvcc -O3 for sm_90a, ptxas -v, as chip_smoke.py prints it): 119
// registers at hd 64, 117 at hd 32, 166 at hd 80, 222 at hd 128, the merge
// 32; no spills. hd 80 (h2o-danube) runs 5 k-steps of Q K^T (the last
// one's K fragments by ldmatrix.x2) and 10 output column tiles (5
// ldmatrix.x4.trans pairs); its 176-byte padded rows start eight ldmatrix
// rows in eight distinct 16-byte bank groups (176 = 11 x 16, 11 odd). The
// SASS (cuobjdump -sass, counted by chip_smoke.py) holds
// HMMA.16816.F32.BF16 for both products. On the card, 32-key tiles were as
// fast as 64-key tiles or faster at every timed K2 shape, and a third
// pipeline stage gained nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_sm90.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kRows = 64;      // (query, head) rows per CTA
constexpr int kWarps = 4;      // 16 rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;      // keys per shared-memory tile
constexpr int kStages = 2;     // K/V tiles in flight or in use
constexpr int kPad = 8;        // bf16 padding per shared row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The natural log-sum-exp of a row's scaled scores from its running max m
// (log2 units) and sum l (relative to m): -inf for a row with no valid key
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? (m + log2f(l)) * kLn2 : -INFINITY;
}

struct Seg {
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  int64_t skb, sks, skh, svb, svs, svh;
};

struct Args {
  const __nv_bfloat16* q;
  Seg pre, cur;
  const int32_t* kv_len;
  const int32_t* prefix_len;
  __nv_bfloat16* out;
  float* part_m;
  float* part_l;
  float* part_acc;
  float* lse;                 // (B, H, Sq) f32 or null (serving)
  int B, Sq, Sk, Sp, KV, G, nsplit, split_len;
  int64_t sqb, sqs, sqh;
  int causal, window;
  float sm_scale;
};

// The keys of one segment that a CTA walks: [lo, hi) in the segment's own
// positions, tiles of kTile from lo; keys at or past kend are masked.
struct Walk {
  const __nv_bfloat16* kb;
  const __nv_bfloat16* vb;
  int64_t sks, svs;
  int base, lo, kend, ntiles;
};

__device__ __forceinline__ Walk walk(const Args& a, int segi, int b, int kvh,
                                     int s_lo, int s_hi, int qpos_lo,
                                     int qpos_hi) {
  const Seg& sg = segi == 0 ? a.pre : a.cur;
  Walk w{};
  w.base = segi == 0 ? 0 : a.Sp;
  const int n = segi == 0 ? a.Sp : a.Sk;
  if (sg.k == nullptr || n == 0) return w;
  int limit = n;
  if (segi == 0) limit = min(n, max(0, a.prefix_len[b]));
  else if (a.kv_len != nullptr) limit = min(n, max(0, a.kv_len[b]));
  w.kend = min(limit, s_hi - w.base);
  int hi = w.kend;
  if (a.causal) hi = min(hi, qpos_hi - w.base + 1);
  w.lo = max(0, s_lo - w.base);
  if (a.window > 0) w.lo = max(w.lo, qpos_lo - a.window + 1 - w.base);
  w.ntiles = hi > w.lo ? (hi - w.lo + kTile - 1) / kTile : 0;
  w.kb = sg.k + b * sg.skb + kvh * sg.skh;
  w.vb = sg.v + b * sg.svb + kvh * sg.svh;
  w.sks = sg.sks;
  w.svs = sg.svs;
  return w;
}

// Start the copy of tile t of the walk (w0's tiles, then w1's) into one
// stage of K and V rows.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* ks,
                                          __nv_bfloat16* vs, const Walk& w0,
                                          const Walk& w1, int t, int tid) {
  constexpr int LD = HD + kPad, kVec = HD / 8;
  // 16-byte pieces of a tile, and copies a thread makes (the last round
  // partial where kThreads does not divide them: hd 80, 320 pieces)
  constexpr int kPieces = kTile * kVec;
  const bool first = t < w0.ntiles;
  const Walk w = first ? w0 : w1;
  const int j0 = w.lo + (first ? t : t - w0.ntiles) * kTile;
#pragma unroll
  for (int n = 0; n < (kPieces + kThreads - 1) / kThreads; ++n) {
    const int i = tid + n * kThreads;
    if (kPieces % kThreads != 0 && i >= kPieces) break;
    const int r = i / kVec, c = i % kVec;
    const int j = j0 + r;
    const bool valid = j < w.kend;
    const int jc = valid ? j : 0;
    cp_async16(ks + r * LD + c * 8, w.kb + jc * w.sks + c * 8, valid);
    cp_async16(vs + r * LD + c * 8, w.vb + jc * w.svs + c * 8, valid);
  }
}

// four CTAs an SM at hd <= 64 (27 KB of shared memory each), three at 80
// (33 KB; at most 168 registers), two at 128
template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 4 : (HD <= 80 ? 3 : 2))
flash_attention_kernel(const Args a) {
  constexpr int LD = HD + kPad;         // shared row stride (elements)
  constexpr int kVec = HD / 8;          // 16-byte vectors per row
  constexpr int KC = HD / 16;           // k-steps of Q K^T
  constexpr int NT = kTile / 8;         // key columns of 8 per tile
  constexpr int DT = HD / 8;            // output columns of 8
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Q rows, then two stages of (K tile, V tile)
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kv = qs + kRows * LD;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = a.G, Sq = a.Sq, H = a.KV * a.G;
  const int bq = kRows / G;             // queries per CTA
  const int live_rows = bq * G;         // rows from here on are dead
  const int q0 = blockIdx.x * bq;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z % a.nsplit, b = blockIdx.z / a.nsplit;
  const int q_off = a.Sp + a.Sk - Sq;
  // the CTA's and the warp's query positions (tile ranges, mask need)
  const int qpos_lo = q_off + q0;
  const int qpos_hi = q_off + min(Sq, q0 + bq) - 1;
  const int wpos_lo = q_off + q0 + (warp * 16) / G;
  const int wpos_hi = q_off + q0 + (warp * 16 + 15) / G;
  // this lane's two rows of each fragment: g and g + 8 of the warp's 16
  const int g = lane / 4, t4 = lane % 4;
  int qpos[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh)
    qpos[rh] = q_off + q0 + (warp * 16 + g + 8 * rh) / G;

  const int s_lo = split * a.split_len;
  const int s_hi = min(a.Sp + a.Sk, s_lo + a.split_len);
  const Walk w0 = walk(a, 0, b, kvh, s_lo, s_hi, qpos_lo, qpos_hi);
  const Walk w1 = walk(a, 1, b, kvh, s_lo, s_hi, qpos_lo, qpos_hi);
  const int ntiles = w0.ntiles + w1.ntiles;

  // Q rows of the CTA (zeros past Sq and in dead rows) and the first tile:
  // one copy group
  static_assert(kRows * kVec % kThreads == 0, "Q copies");
#pragma unroll
  for (int n = 0; n < kRows * kVec / kThreads; ++n) {
    const int i = tid + n * kThreads;
    const int r = i / kVec, c = i % kVec;
    const int qi = q0 + r / G, h = kvh * G + r % G;
    const bool live = qi < Sq && r < live_rows;
    cp_async16(qs + r * LD + c * 8,
               a.q + b * a.sqb + (live ? qi : 0) * a.sqs + h * a.sqh + c * 8,
               live);
  }
  // one copy group per tile (Q joins the first), kStages - 1 ahead
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < ntiles) {
      __nv_bfloat16* nk = kv + p * 2 * kTile * LD;
      load_tile<HD>(nk, nk + kTile * LD, w0, w1, p, tid);
    }
    cp_async_commit();
  }
  uint32_t qa[KC][4];

  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
    o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = a.sm_scale * kLog2e;

  // a ring of kStages tiles: tiles t + 1 .. t + kStages - 1 are in
  // flight while tile t is computed
  for (int t = 0; t < ntiles; ++t) {
    const bool first = t < w0.ntiles;
    const Walk w = first ? w0 : w1;
    const int j0 = w.lo + (first ? t : t - w0.ntiles) * kTile;
    if (t + kStages - 1 < ntiles) {     // into the stage tile t - 1 freed
      __nv_bfloat16* nk =
          kv + ((t + kStages - 1) % kStages) * 2 * kTile * LD;
      load_tile<HD>(nk, nk + kTile * LD, w0, w1, t + kStages - 1, tid);
    }
    cp_async_commit();                  // empty groups keep the count
    cp_async_wait<kStages - 1>();
    __syncthreads();                    // tile t (and Q) landed for all
    if (t == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        ldsm_x4(smem_u32(qs + (warp * 16 + (lane & 15)) * LD + kc * 16 +
                         (lane >> 4) * 8),
                qa[kc]);
    }
    const __nv_bfloat16* ks = kv + (t % kStages) * 2 * kTile * LD;
    const __nv_bfloat16* vs = ks + kTile * LD;

    // S = Q K^T: 16 rows x kTile keys per warp, f32
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; kc += 2) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bk[4];
        if (kc + 1 < KC) {              // two k-steps: 32 dims of 8 keys
          ldsm_x4(smem_u32(ks + (8 * j + (lane & 7)) * LD + kc * 16 +
                           (lane >> 3) * 8),
                  bk);
          mma_bf16(s[j], qa[kc], bk[0], bk[1]);
          mma_bf16(s[j], qa[kc + 1], bk[2], bk[3]);
        } else {                        // the odd last k-step (hd 80)
          ldsm_x2(smem_u32(ks + (8 * j + (lane & 7)) * LD + kc * 16 +
                           ((lane >> 3) & 1) * 8),
                  bk);
          mma_bf16(s[j], qa[kc], bk[0], bk[1]);
        }
      }
    }

    // masks, only where one can reach this warp's rows in this tile
    const int kpos0 = w.base + j0;
    const bool need = j0 + kTile > w.kend ||
                      (a.causal && kpos0 + kTile - 1 > wpos_lo) ||
                      (a.window > 0 && wpos_hi - kpos0 >= a.window);
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[j][2 * rh + e];
          if (need) {
            const int jj = j0 + 8 * j + 2 * t4 + e;
            const int kpos = w.base + jj;
            bool ok = jj < w.kend;
            if (a.causal) ok = ok && qpos[rh] >= kpos;
            if (a.window > 0) ok = ok && qpos[rh] - kpos < a.window;
            if (!ok) x = -INFINITY;
          }
          s[j][2 * rh + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // the scale is positive: the max of raw scores scales to the max
      const float m_new = fmaxf(m[rh], mx * sl2);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = fast_exp2(m[rh] - m_use);   // m = -inf: 0
      m[rh] = m_new;
      l[rh] *= corr;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        o[d][2 * rh] *= corr;
        o[d][2 * rh + 1] *= corr;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // masked: exp2(-inf) = 0
          const float p = fast_exp2(fmaf(s[j][2 * rh + e], sl2, -m_use));
          l[rh] += p;
          s[j][2 * rh + e] = p;
        }
      }
    }

    // acc += P V: P from the S accumulators (bf16 in registers)
#pragma unroll
    for (int kt = 0; kt < kTile / 16; ++kt) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kt][0], s[2 * kt][1]);
      pa[1] = pack_bf16(s[2 * kt][2], s[2 * kt][3]);
      pa[2] = pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]);
      pa[3] = pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]);
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(smem_u32(vs + (16 * kt + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * LD +
                               8 * d + (lane >> 4) * 8),
                      bv);
        mma_bf16(o[d], pa, bv[0], bv[1]);
        mma_bf16(o[d + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();                    // this stage's reads done
  }
  cp_async_wait<0>();                   // no tile: Q's copy still lands
  __syncthreads();

#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 1);
    l[rh] += __shfl_xor_sync(0xffffffffu, l[rh], 2);
  }
  if (a.nsplit > 1) {
    // f32 partials of this split, unnormalised (m in log2 units)
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int r = warp * 16 + g + 8 * rh;
      const int qi = q0 + r / G;
      if (qi >= Sq || r >= live_rows) continue;
      const int h = kvh * G + r % G;
      const int64_t prow =
          ((static_cast<int64_t>(b) * Sq + qi) * H + h) * a.nsplit + split;
      if (t4 == 0) {
        a.part_m[prow] = m[rh];
        a.part_l[prow] = l[rh];
      }
#pragma unroll
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<float2*>(a.part_acc + prow * HD + 8 * d + 2 * t4) =
            make_float2(o[d][2 * rh], o[d][2 * rh + 1]);
    }
    return;
  }
  // the log-sum-exp of each live row (the backward's P), when asked for
  if (a.lse != nullptr && t4 == 0) {
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int r = warp * 16 + g + 8 * rh;
      const int qi = q0 + r / G;
      if (qi < Sq && r < live_rows)
        a.lse[(static_cast<int64_t>(b) * H + kvh * G + r % G) * Sq + qi] =
            row_lse(m[rh], l[rh]);
    }
  }
  // normalise, stage the warp's 16 rows in its own Q rows, store 16 bytes
  // a lane
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const float inv = l[rh] > 0.f ? 1.f / fmaxf(l[rh], 1e-30f) : 0.f;
    __nv_bfloat16* dst = qs + (warp * 16 + g + 8 * rh) * LD + 2 * t4;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<uint32_t*>(dst + 8 * d) =
          pack_bf16(o[d][2 * rh] * inv, o[d][2 * rh + 1] * inv);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kVec; i += 32) {
    const int r = warp * 16 + i / kVec, c = i % kVec;
    const int qi = q0 + r / G;
    if (qi >= Sq || r >= live_rows) continue;
    const int h = kvh * G + r % G;
    *reinterpret_cast<uint4*>(
        a.out + ((static_cast<int64_t>(b) * Sq + qi) * H + h) * HD + c * 8) =
        *reinterpret_cast<const uint4*>(qs + r * LD + c * 8);
  }
}

// Combine the key splits' partials of each output element: rescale each
// split's sum and accumulator to the largest max and divide once. Rows are
// (batch, query, head) in the output's order, nsplit partials each. The
// name keeps "flash_attention_kernel" so that a profile filtered on it
// counts both of K2's passes.
template <int HD>
__global__ void __launch_bounds__(256)
flash_attention_kernel_merge(const float* __restrict__ part_m,
                             const float* __restrict__ part_l,
                             const float* __restrict__ part_acc,
                             __nv_bfloat16* __restrict__ out,
                             float* __restrict__ lse, int64_t rows, int Sq,
                             int H, int nsplit) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= rows * HD) return;
  const int64_t row = i / HD;
  const int dd = static_cast<int>(i % HD);
  const float* pm = part_m + row * nsplit;
  float mx = -INFINITY;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, pm[s]);
  float lsum = 0.f, o = 0.f;
  if (mx != -INFINITY) {
    for (int s = 0; s < nsplit; ++s) {
      if (pm[s] == -INFINITY) continue;
      const float wt = fast_exp2(pm[s] - mx);
      lsum += part_l[row * nsplit + s] * wt;
      o += part_acc[(row * nsplit + s) * HD + dd] * wt;
    }
  }
  out[i] = __float2bfloat16(lsum > 0.f ? o / fmaxf(lsum, 1e-30f) : 0.f);
  if (lse != nullptr && dd == 0) {    // row = (b * Sq + qi) * H + h
    const int64_t h = row % H, bq = row / H;
    lse[(bq / Sq * H + h) * Sq + bq % Sq] = row_lse(mx, lsum);
  }
}

// the merge of nsplit > 1 key splits' partials into out (and lse)
template <int HD>
cudaError_t launch_merge(const float* part_m, const float* part_l,
                         const float* part_acc, __nv_bfloat16* out,
                         float* lse, int B, int Sq, int H, int nsplit,
                         cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(B) * Sq * H;
  const int64_t blocks = (rows * HD + 255) / 256;
  flash_attention_kernel_merge<HD>
      <<<static_cast<unsigned>(blocks), 256, 0, stream>>>(
          part_m, part_l, part_acc, out, lse, rows, Sq, H, nsplit);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = (kRows + 2 * kStages * kTile) * (HD + kPad) * 2;
  cudaError_t err;
  if (smem > 48 * 1024) {   // hd 128 only: past the default dynamic limit
    err = cudaFuncSetAttribute(flash_attention_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
  }
  const int bq = kRows / a.G;
  const dim3 grid((a.Sq + bq - 1) / bq, a.KV, a.B * a.nsplit);
  flash_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nsplit == 1) return err;
  return launch_merge<HD>(a.part_m, a.part_l, a.part_acc, a.out, a.lse, a.B,
                          a.Sq, a.KV * a.G, a.nsplit, stream);
}

}  // namespace

// q (B, Sq, KV * G, hd) bf16 with element strides sqb/sqs/sqh; k/v (B, Sk,
// KV, hd) bf16 with strides sk*/sv* (batch, position, kv head); pk/pv the
// prefix (B, Sp, KV, hd) with strides sp*/spv* or null (Sp = 0); every head
// row has unit hd stride and is 16-byte aligned. kv_len and prefix_len are
// (B,) int32 on the device or null (prefix_len is required with a prefix).
// out (B, Sq, KV * G, hd) bf16 contiguous. The key axis [0, Sp + Sk) is cut
// into nsplit splits of split_len keys (a multiple of 32); with nsplit > 1,
// part_m/part_l (B * Sq * KV * G * nsplit) and part_acc (... * hd) f32 hold
// the partials the merge kernel combines, else they may be null. window <=
// 0 means no window. lse, when not null, receives each row's natural
// log-sum-exp of its scaled scores, (B, KV * G, Sq) f32 contiguous (-inf for
// a row with no valid key): the backward recomputes P from it. Written or
// not, out's bits are the same. 1 <= G <= 64 (a CTA holds 64 / G queries; where G
// does not divide 64 its last rows are dead) and hd is 32, 64, 80 or 128.
// Returns a cudaError_t (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, const void* pk,
    const void* pv, const void* kv_len, const void* prefix_len, void* out,
    void* part_m, void* part_l, void* part_acc, void* lse, int B, int Sq,
    int Sk, int Sp,
    int KV, int G, int hd, int nsplit, int split_len, int64_t sqb,
    int64_t sqs, int64_t sqh, int64_t skb, int64_t sks, int64_t skh,
    int64_t svb, int64_t svs, int64_t svh, int64_t spb, int64_t sps,
    int64_t sph, int64_t spvb, int64_t spvs, int64_t spvh, int causal,
    int window, float sm_scale, void* stream) {
  if (G <= 0 || G > kRows || B <= 0 || Sq <= 0 || KV <= 0 || nsplit <= 0 ||
      split_len <= 0 || split_len % kTile ||
      (nsplit > 1 && (part_m == nullptr || part_l == nullptr ||
                      part_acc == nullptr)) ||
      (pk != nullptr && prefix_len == nullptr))
    return cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(q),
               Seg{static_cast<const __nv_bfloat16*>(pk),
                   static_cast<const __nv_bfloat16*>(pv), spb, sps, sph, spvb,
                   spvs, spvh},
               Seg{static_cast<const __nv_bfloat16*>(k),
                   static_cast<const __nv_bfloat16*>(v), skb, sks, skh, svb,
                   svs, svh},
               static_cast<const int32_t*>(kv_len),
               static_cast<const int32_t*>(prefix_len),
               static_cast<__nv_bfloat16*>(out),
               static_cast<float*>(part_m),
               static_cast<float*>(part_l),
               static_cast<float*>(part_acc),
               static_cast<float*>(lse),
               B, Sq, Sk, Sp, KV, G, nsplit, split_len, sqb, sqs, sqh,
               causal, window, sm_scale};
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:  return launch<32>(a, st);
    case 64:  return launch<64>(a, st);
    case 80:  return launch<80>(a, st);
    case 128: return launch<128>(a, st);
    default:  return cudaErrorInvalidValue;
  }
}

// The Hopper body (flash_attention_sm90.cuh) on the same operands, without
// a prefix: q, k, v, kv_len, out, the split partials, lse, the shapes and
// strides as flash_attention_launch takes them (every stride a multiple of
// 8 elements, the bases 16-byte aligned: the TMA's rule), hd 64 or 128,
// rows 64 or 128 (query, head) rows a CTA (one or two consumer
// warpgroups; G <= 64), nsplit splits of split_len keys merged by the mma body's merge kernel. Returns a
// cudaError_t (0 on success; cudaErrorInvalidValue where a tensor map
// cannot be encoded).
extern "C" int flash_attention_sm90_launch(
    const void* q, const void* k, const void* v, const void* kv_len,
    void* out, void* part_m, void* part_l, void* part_acc, void* lse, int B,
    int Sq, int Sk, int KV, int G, int hd, int rows, int nsplit,
    int split_len, int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb,
    int64_t sks, int64_t skh, int64_t svb, int64_t svs, int64_t svh,
    int causal, int window, float sm_scale, void* stream) {
  if (G <= 0 || G > 64 || B <= 0 || Sq <= 0 || KV <= 0 || nsplit <= 0 ||
      split_len <= 0 || (rows != 64 && rows != 128) ||
      (hd != 64 && hd != 128) ||
      (nsplit > 1 && (part_m == nullptr || part_l == nullptr ||
                      part_acc == nullptr)))
    return cudaErrorInvalidValue;
  const int H = KV * G, bq = rows / G;
  CUtensorMap tq, tk, tv, to;
  const int64_t qdim[4] = {hd, H, Sq, B}, qstride[4] = {1, sqh, sqs, sqb};
  const int64_t ostride[4] = {1, hd, static_cast<int64_t>(H) * hd,
                              static_cast<int64_t>(Sq) * H * hd};
  const int64_t kdim[4] = {hd, KV, Sk, B};
  const int64_t kstride[4] = {1, skh, sks, skb};
  const int64_t vstride[4] = {1, svh, svs, svb};
  const uint32_t qbox[4] = {64, static_cast<uint32_t>(G),
                            static_cast<uint32_t>(bq), 1};
  const int kn = fa90::key_tile(hd, rows / 64, causal || window > 0);
  const uint32_t kbox[4] = {64, 1, static_cast<uint32_t>(kn), 1};
  if (!bf16_map_4d(&tq, q, qdim, qstride, qbox) ||
      !bf16_map_4d(&tk, k, kdim, kstride, kbox) ||
      !bf16_map_4d(&tv, v, kdim, vstride, kbox) ||
      !bf16_map_4d(&to, out, qdim, ostride, qbox))
    return cudaErrorInvalidValue;
  const int nqt = (Sq + bq - 1) / bq;
  const fa90::Args a{static_cast<const int32_t*>(kv_len),
                     static_cast<float*>(part_m),
                     static_cast<float*>(part_l),
                     static_cast<float*>(part_acc),
                     static_cast<float*>(lse),
                     B, Sq, Sk, KV, G, nsplit, split_len, causal, window,
                     nqt, nqt * KV * B * nsplit, sm_scale};
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return cudaErrorInvalidValue;
  }
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (hd == 64)
    err = rows == 64 ? fa90::launch<64, 1>(kn, tq, tk, tv, to, a, sms, st)
                     : fa90::launch<64, 2>(kn, tq, tk, tv, to, a, sms, st);
  else
    err = rows == 64 ? fa90::launch<128, 1>(kn, tq, tk, tv, to, a, sms, st)
                     : fa90::launch<128, 2>(kn, tq, tk, tv, to, a, sms, st);
  if (err != cudaSuccess || nsplit == 1) return err;
  return hd == 64
             ? launch_merge<64>(a.part_m, a.part_l, a.part_acc,
                                static_cast<__nv_bfloat16*>(out), a.lse, B,
                                Sq, H, nsplit, st)
             : launch_merge<128>(a.part_m, a.part_l, a.part_acc,
                                 static_cast<__nv_bfloat16*>(out), a.lse, B,
                                 Sq, H, nsplit, st);
}

// The gradient of the GQA prefill flash attention (flash_attention.cu), for
// Hopper (sm_90a), on the tensor cores.
//
// Replaces no TPU kernel: the JAX package trains through its jnp
// src/repro/models/attention.py::flash_attention (:50) and lets XLA derive
// the gradient; the port's forward is the hand-written K2 (whose TPU
// counterpart is src/repro/kernels/flash_attention.py::flash_attention,
// pl.pallas_call at :88), so its gradient is hand-written too. Function:
// for batch row b, query head h (kv head h / G) and query i at position
// q_off + i (q_off = Sk - Sq: the queries are the suffix of the keys), with
// the forward's masks (a key at or past kv_len[b]; with `causal`, a key
// after the query; with a window, a key window or more positions before
// it):
//   P_ij  = exp(scale * q_i.k_j - lse_i)        (lse from the forward)
//   D_i   = sum_d dO_id O_id
//   dS_ij = P_ij (dO_i.v_j - D_i)
//   dq_i  = scale sum_j dS_ij k_j,  dk_j = scale sum_(i,h in group) dS_ij q_i,
//   dv_j  = sum_(i,h in group) P_ij dO_i
// Every product takes bf16 operands and accumulates in f32 (P and dS are
// rounded to bf16 as the A operand of their products, as the forward rounds
// P); the outputs are bf16. A query row with no valid key (lse = -inf) has
// P = 0 and zero gradients, matching the forward's zeros for it. No prefix
// segment: the prefix operand is serving-only.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16):
// operations at long keys (five products of (Sq x Sk x hd) per head, 2.5x
// the forward's), bytes at the training shapes of moment-large (64 patches:
// each CTA reads its tiles a few times and computes little). The design:
// every product on the tensor cores (mma.sync m16n8k16); P and dS never
// leave registers (each is recomputed from the scores where it is used:
// the dQ pass and the dK/dV pass recompute S and dP themselves); the tiles
// stream through shared memory by cp.async two stages deep; and no atomics:
// each output element is written by exactly one CTA after a loop in a fixed
// order, so two calls give the same bits.
//
// Three kernels, launched in order on one stream:
//  1. flash_attention_bwd_dsum: D (B, H, Sq) f32, one warp a row.
//  2. flash_attention_bwd_dq_kernel: one CTA of 4 warps per (query tile,
//     kv head, row), the forward's row map (64 rows of (query, head), 16 a
//     warp, 64 / G queries a CTA, dead rows where G does not divide 64).
//     Q and dO are held as A fragments; over the 32-key tiles the CTA's
//     queries see: S = Q K^T, dP = dO V^T, dS in registers, dQ += dS K (K's
//     B fragments by ldmatrix.trans).
//  3. flash_attention_bwd_dkv_kernel: one CTA of 4 warps per (64-key tile,
//     kv head, row), 16 keys a warp, so every product is taken transposed:
//     S^T = K Q^T and dP^T = V dO^T (keys as the M rows), P^T and dS^T
//     packed from the accumulators as A operands, dV += P^T dO and dK +=
//     dS^T Q (B fragments by ldmatrix.trans). The CTA walks the G query
//     heads of its group, then the 32-query tiles that see its keys, and
//     writes dK and dV once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 64;      // dQ pass: (query, head) rows per CTA
constexpr int kTile = 32;      // dQ pass: keys per tile
constexpr int kKeys = 64;      // dK/dV pass: keys per CTA, 16 a warp
constexpr int kQTile = 32;     // dK/dV pass: queries per tile
constexpr int kPad = 8;        // bf16 padding per shared row
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;            // (B, H, Sq), natural log
  float* dsum;                 // D (B, H, Sq)
  const int32_t* kv_len;       // (B,) or null
  __nv_bfloat16* dq;           // (B, Sq, H, hd) contiguous
  __nv_bfloat16* dk;           // (B, Sk, KV, hd) contiguous
  __nv_bfloat16* dv;
  int B, Sq, Sk, KV, G;
  int64_t sqb, sqs, sqh, skb, sks, skh, svb, svs, svh;
  int64_t sob, sos, soh, sdb, sds, sdh;
  int causal, window;
  float sm_scale;
};

// lse (natural) -> the exponent offset of P in log2 units; +inf (P = 0) for
// a row with no valid key (-inf) and for a row past Sq
__device__ __forceinline__ float lse2_of(const Args& a, int64_t idx,
                                         bool live) {
  if (!live) return INFINITY;
  const float x = a.lse[idx];
  return x == -INFINITY ? INFINITY : x * kLog2e;
}

// ---------------- 1. D = rowsum(dO * O) ----------------

__global__ void __launch_bounds__(256)
flash_attention_bwd_dsum(const Args a, int hd) {
  const int H = a.KV * a.G;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<int64_t>(a.B) * H * a.Sq) return;  // warp-uniform
  const int i = static_cast<int>(row % a.Sq);
  const int h = static_cast<int>((row / a.Sq) % H);
  const int b = static_cast<int>(row / (static_cast<int64_t>(a.Sq) * H));
  const __nv_bfloat162* orow = reinterpret_cast<const __nv_bfloat162*>(
      a.o + b * a.sob + i * a.sos + h * a.soh);
  const __nv_bfloat162* drow = reinterpret_cast<const __nv_bfloat162*>(
      a.dout + b * a.sdb + i * a.sds + h * a.sdh);
  float s = 0.f;
  for (int p = lane; p < hd / 2; p += 32) {
    const float2 x = __bfloat1622float2(orow[p]);
    const float2 y = __bfloat1622float2(drow[p]);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) a.dsum[row] = s;
}

// the masks of the forward for query position qpos and key kpos (< kend)
__device__ __forceinline__ bool visible(const Args& a, int qpos, int kpos,
                                        int kend) {
  bool ok = kpos < kend;
  if (a.causal) ok = ok && qpos >= kpos;
  if (a.window > 0) ok = ok && qpos - kpos < a.window;
  return ok;
}

// S (16 rows x 8 * NT columns, f32) += A (16 x HD, A fragments from
// shared rows `arow` of stride LD) * B^T, B's rows (the columns) from
// shared rows `brow`: the forward's Q K^T step
template <int HD, int NT>
__device__ __forceinline__ void rows_times_rows(float (*s)[4],
                                                const __nv_bfloat16* arow,
                                                const __nv_bfloat16* brow,
                                                int lane) {
  constexpr int LD = HD + kPad, KC = HD / 16;
#pragma unroll
  for (int kc = 0; kc < KC; kc += 2) {
    uint32_t a0[4], a1[4];
    ldsm_x4(smem_u32(arow + (lane & 15) * LD + kc * 16 + (lane >> 4) * 8),
            a0);
    if (kc + 1 < KC)
      ldsm_x4(smem_u32(arow + (lane & 15) * LD + (kc + 1) * 16 +
                       (lane >> 4) * 8),
              a1);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bk[4];
      if (kc + 1 < KC) {              // two k-steps: 32 dims of 8 columns
        ldsm_x4(smem_u32(brow + (8 * j + (lane & 7)) * LD + kc * 16 +
                         (lane >> 3) * 8),
                bk);
        mma_bf16(s[j], a0, bk[0], bk[1]);
        mma_bf16(s[j], a1, bk[2], bk[3]);
      } else {                        // the odd last k-step (hd 80)
        ldsm_x2(smem_u32(brow + (8 * j + (lane & 7)) * LD + kc * 16 +
                         ((lane >> 3) & 1) * 8),
                bk);
        mma_bf16(s[j], a0, bk[0], bk[1]);
      }
    }
  }
}

// acc (16 x HD, f32) += X (16 x 16 * KT, packed from accumulators x) * R
// (16 * KT rows of HD in shared memory at `rrow`, stride LD): the
// forward's P V step
template <int HD, int KT>
__device__ __forceinline__ void acc_times_rows(float (*acc)[4],
                                               float (*x)[4],
                                               const __nv_bfloat16* rrow,
                                               int lane) {
  constexpr int LD = HD + kPad, DT = HD / 8;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    uint32_t pa[4];
    pa[0] = pack_bf16(x[2 * kt][0], x[2 * kt][1]);
    pa[1] = pack_bf16(x[2 * kt][2], x[2 * kt][3]);
    pa[2] = pack_bf16(x[2 * kt + 1][0], x[2 * kt + 1][1]);
    pa[3] = pack_bf16(x[2 * kt + 1][2], x[2 * kt + 1][3]);
#pragma unroll
    for (int d = 0; d < DT; d += 2) {
      uint32_t bv[4];
      ldsm_x4_trans(smem_u32(rrow + (16 * kt + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * LD +
                             8 * d + (lane >> 4) * 8),
                    bv);
      mma_bf16(acc[d], pa, bv[0], bv[1]);
      mma_bf16(acc[d + 1], pa, bv[2], bv[3]);
    }
  }
}

// copy ROWS rows of HD bf16, rows r0 .. r0 + ROWS - 1 of `base` at
// `stride`, into shared rows of stride LD, 16 bytes a copy; rows at or past
// `limit` are zeros (their copy reads nothing: its source is row 0)
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* base,
                                          int64_t stride, int r0, int limit,
                                          int tid) {
  constexpr int LD = HD + kPad, kVec = HD / 8, kPieces = ROWS * kVec;
#pragma unroll
  for (int n = 0; n < (kPieces + kThreads - 1) / kThreads; ++n) {
    const int i = tid + n * kThreads;
    if (kPieces % kThreads != 0 && i >= kPieces) break;
    const int r = i / kVec, c = i % kVec;
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * LD + c * 8,
               base + (ok ? r0 + r : 0) * stride + c * 8, ok);
  }
}

// ---------------- 2. dQ ----------------

template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 80 ? 3 : 2)
flash_attention_bwd_dq_kernel(const Args a) {
  constexpr int LD = HD + kPad, kVec = HD / 8, KC = HD / 16;
  constexpr int NT = kTile / 8, DT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Q rows, dO rows, then two stages of (K tile, V tile)
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kRows * LD;
  __nv_bfloat16* kv = dos + kRows * LD;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = a.G, Sq = a.Sq, H = a.KV * G;
  const int bq = kRows / G, live_rows = bq * G;
  const int q0 = blockIdx.x * bq, kvh = blockIdx.y, b = blockIdx.z;
  const int q_off = a.Sk - Sq;
  const int qpos_lo = q_off + q0;
  const int qpos_hi = q_off + min(Sq, q0 + bq) - 1;
  const int wpos_lo = q_off + q0 + (warp * 16) / G;
  const int wpos_hi = q_off + q0 + (warp * 16 + 15) / G;
  const int g = lane / 4, t4 = lane % 4;
  int qpos[2];
  float lse2[2], dsum[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int r = warp * 16 + g + 8 * rh;
    const int qi = q0 + r / G;
    const bool live = qi < Sq && r < live_rows;
    const int64_t idx =
        (static_cast<int64_t>(b) * H + kvh * G + r % G) * Sq + (live ? qi : 0);
    qpos[rh] = q_off + qi;
    lse2[rh] = lse2_of(a, idx, live);
    dsum[rh] = live ? a.dsum[idx] : 0.f;
  }
  // the key tiles the CTA's queries see
  int kend = a.Sk;
  if (a.kv_len != nullptr) kend = min(kend, max(0, a.kv_len[b]));
  int hi = kend;
  if (a.causal) hi = min(hi, qpos_hi + 1);
  int lo = 0;
  if (a.window > 0) lo = max(lo, qpos_lo - a.window + 1);
  const int ntiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;
  const __nv_bfloat16* kb = a.k + b * a.skb + kvh * a.skh;
  const __nv_bfloat16* vb = a.v + b * a.svb + kvh * a.svh;

  // Q and dO rows (zeros past Sq and in dead rows) join the first tile's
  // copy group
  static_assert(kRows * kVec % kThreads == 0, "Q copies");
#pragma unroll
  for (int n = 0; n < kRows * kVec / kThreads; ++n) {
    const int i = tid + n * kThreads;
    const int r = i / kVec, c = i % kVec;
    const int qi = q0 + r / G, h = kvh * G + r % G;
    const bool live = qi < Sq && r < live_rows;
    const int qc = live ? qi : 0;
    cp_async16(qs + r * LD + c * 8,
               a.q + b * a.sqb + qc * a.sqs + h * a.sqh + c * 8, live);
    cp_async16(dos + r * LD + c * 8,
               a.dout + b * a.sdb + qc * a.sds + h * a.sdh + c * 8, live);
  }
  if (ntiles > 0) {
    load_rows<HD, kTile>(kv, kb, a.sks, lo, kend, tid);
    load_rows<HD, kTile>(kv + kTile * LD, vb, a.svs, lo, kend, tid);
  }
  cp_async_commit();

  uint32_t qa[KC][4], da[KC][4];
  float dq[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;
  const float sl2 = a.sm_scale * kLog2e;

  for (int t = 0; t < ntiles; ++t) {
    const int j0 = lo + t * kTile;
    if (t + 1 < ntiles) {               // into the stage tile t - 1 freed
      __nv_bfloat16* nk = kv + ((t + 1) % 2) * 2 * kTile * LD;
      const int jn = j0 + kTile;
      load_rows<HD, kTile>(nk, kb, a.sks, jn, kend, tid);
      load_rows<HD, kTile>(nk + kTile * LD, vb, a.svs, jn, kend, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                    // tile t (and Q, dO) landed
    if (t == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        ldsm_x4(smem_u32(qs + (warp * 16 + (lane & 15)) * LD + kc * 16 +
                         (lane >> 4) * 8),
                qa[kc]);
        ldsm_x4(smem_u32(dos + (warp * 16 + (lane & 15)) * LD + kc * 16 +
                         (lane >> 4) * 8),
                da[kc]);
      }
    }
    const __nv_bfloat16* ks = kv + (t % 2) * 2 * kTile * LD;
    const __nv_bfloat16* vs = ks + kTile * LD;

    // S = Q K^T and dP = dO V^T: 16 rows x kTile keys a warp, f32
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] =
          dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; kc += 2) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bk[4], bv[4];
        if (kc + 1 < KC) {
          ldsm_x4(smem_u32(ks + (8 * j + (lane & 7)) * LD + kc * 16 +
                           (lane >> 3) * 8),
                  bk);
          ldsm_x4(smem_u32(vs + (8 * j + (lane & 7)) * LD + kc * 16 +
                           (lane >> 3) * 8),
                  bv);
          mma_bf16(s[j], qa[kc], bk[0], bk[1]);
          mma_bf16(s[j], qa[kc + 1], bk[2], bk[3]);
          mma_bf16(dp[j], da[kc], bv[0], bv[1]);
          mma_bf16(dp[j], da[kc + 1], bv[2], bv[3]);
        } else {
          ldsm_x2(smem_u32(ks + (8 * j + (lane & 7)) * LD + kc * 16 +
                           ((lane >> 3) & 1) * 8),
                  bk);
          ldsm_x2(smem_u32(vs + (8 * j + (lane & 7)) * LD + kc * 16 +
                           ((lane >> 3) & 1) * 8),
                  bv);
          mma_bf16(s[j], qa[kc], bk[0], bk[1]);
          mma_bf16(dp[j], da[kc], bv[0], bv[1]);
        }
      }
    }
    // dS = P (dP - D), P recomputed from the forward's lse; masks only
    // where one can reach this warp's rows in this tile
    const bool need = j0 + kTile > kend ||
                      (a.causal && j0 + kTile - 1 > wpos_lo) ||
                      (a.window > 0 && wpos_hi - j0 >= a.window);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rh = e / 2;
        float p = fast_exp2(fmaf(s[j][e], sl2, -lse2[rh]));
        if (need && !visible(a, qpos[rh], j0 + 8 * j + 2 * t4 + (e & 1),
                             kend))
          p = 0.f;
        s[j][e] = p * (dp[j][e] - dsum[rh]);
      }
    }
    // dQ += dS K (K's B fragments transposed from its row-major tile)
    acc_times_rows<HD, kTile / 16>(dq, s, ks, lane);
    __syncthreads();                    // this stage's reads done
  }
  cp_async_wait<0>();                   // no tile: Q's copy still lands
  __syncthreads();

  // scale, stage the warp's 16 rows in its own Q rows, store 16 bytes a
  // lane
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    __nv_bfloat16* dst = qs + (warp * 16 + g + 8 * rh) * LD + 2 * t4;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<uint32_t*>(dst + 8 * d) =
          pack_bf16(dq[d][2 * rh] * a.sm_scale, dq[d][2 * rh + 1] * a.sm_scale);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kVec; i += 32) {
    const int r = warp * 16 + i / kVec, c = i % kVec;
    const int qi = q0 + r / G;
    if (qi >= Sq || r >= live_rows) continue;
    const int h = kvh * G + r % G;
    *reinterpret_cast<uint4*>(
        a.dq + ((static_cast<int64_t>(b) * Sq + qi) * H + h) * HD + c * 8) =
        *reinterpret_cast<const uint4*>(qs + r * LD + c * 8);
  }
}

// ---------------- 3. dK and dV ----------------

// three CTAs an SM up to hd 64; at hd 80 the dK and dV accumulators (80
// registers) spilled under three's 168-register cap, so two from hd 80
template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 3 : 2)
flash_attention_bwd_dkv_kernel(const Args a) {
  constexpr int LD = HD + kPad, DT = HD / 8, NQ = kQTile / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // K rows, V rows, then two stages of (Q tile, dO tile), then two stages
  // of (lse2, D) for the tile's queries
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kKeys * LD;
  __nv_bfloat16* qd = vs + kKeys * LD;
  float* ld = reinterpret_cast<float*>(qd + 2 * 2 * kQTile * LD);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = a.G, Sq = a.Sq, H = a.KV * G;
  const int j0 = blockIdx.x * kKeys, kvh = blockIdx.y, b = blockIdx.z;
  const int q_off = a.Sk - Sq;
  const int g = lane / 4, t4 = lane % 4;
  int kend = a.Sk;
  if (a.kv_len != nullptr) kend = min(kend, max(0, a.kv_len[b]));
  // the queries that see a valid key of this tile: [i_lo, i_hi)
  const int kmax = min(j0 + kKeys, kend) - 1;
  int i_lo = 0, i_hi = kmax >= j0 ? Sq : 0;
  if (a.causal) i_lo = max(i_lo, j0 - q_off);
  if (a.window > 0) i_hi = min(i_hi, kmax + a.window - q_off);
  const int nqt = i_hi > i_lo ? (i_hi - i_lo + kQTile - 1) / kQTile : 0;
  const int nit = G * nqt;              // (head, query tile) pairs

  // this tile's K and V rows (zeros at and past kend) join the first
  // stage's copy group
  if (nit > 0) {
    load_rows<HD, kKeys>(ks, a.k + b * a.skb + kvh * a.skh, a.sks, j0, kend,
                         tid);
    load_rows<HD, kKeys>(vs, a.v + b * a.svb + kvh * a.svh, a.svs, j0, kend,
                         tid);
  }
  // stage `st` <- iteration `it`: Q and dO rows of its head and queries,
  // and their lse2 and D
  auto load_it = [&](int it, int st) {
    const int h = kvh * G + it / nqt;
    const int i0 = i_lo + (it % nqt) * kQTile;
    __nv_bfloat16* qst = qd + st * 2 * kQTile * LD;
    load_rows<HD, kQTile>(qst, a.q + b * a.sqb + h * a.sqh, a.sqs, i0, Sq,
                          tid);
    load_rows<HD, kQTile>(qst + kQTile * LD, a.dout + b * a.sdb + h * a.sdh,
                          a.sds, i0, Sq, tid);
    if (tid < kQTile) {
      const int qi = i0 + tid;
      const bool live = qi < Sq;
      const int64_t idx =
          (static_cast<int64_t>(b) * H + h) * Sq + (live ? qi : 0);
      ld[st * 2 * kQTile + tid] = lse2_of(a, idx, live);
      ld[st * 2 * kQTile + kQTile + tid] = live ? a.dsum[idx] : 0.f;
    }
  };
  if (nit > 0) load_it(0, 0);
  cp_async_commit();

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
    dk[d][0] = dk[d][1] = dk[d][2] = dk[d][3] = dv[d][0] = dv[d][1] =
        dv[d][2] = dv[d][3] = 0.f;
  const float sl2 = a.sm_scale * kLog2e;
  int kpos[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) kpos[rh] = j0 + warp * 16 + g + 8 * rh;

  for (int it = 0; it < nit; ++it) {
    if (it + 1 < nit) load_it(it + 1, (it + 1) % 2);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                    // iteration it's tiles landed
    const int st = it % 2;
    const int i0 = i_lo + (it % nqt) * kQTile;
    const __nv_bfloat16* qst = qd + st * 2 * kQTile * LD;
    const __nv_bfloat16* dst = qst + kQTile * LD;
    const float* lse2 = ld + st * 2 * kQTile;
    const float* dsum = lse2 + kQTile;

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x kQTile queries a warp
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] =
          dp[j][2] = dp[j][3] = 0.f;
    rows_times_rows<HD, NQ>(s, ks + warp * 16 * LD, qst, lane);
    rows_times_rows<HD, NQ>(dp, vs + warp * 16 * LD, dst, lane);
    // P^T into s, dS^T into dp
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t4 + (e & 1);
        float p = fast_exp2(fmaf(s[j][e], sl2, -lse2[c]));
        if (!visible(a, q_off + i0 + c, kpos[e / 2], kend)) p = 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dsum[c]);
      }
    }
    // dV += P^T dO, dK += dS^T Q
    acc_times_rows<HD, kQTile / 16>(dv, s, dst, lane);
    acc_times_rows<HD, kQTile / 16>(dk, dp, qst, lane);
    __syncthreads();                    // this stage's reads done
  }
  cp_async_wait<0>();

  // every key row of the tile below Sk, zeros where no query saw it
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    if (kpos[rh] >= a.Sk) continue;
    const int64_t row =
        ((static_cast<int64_t>(b) * a.Sk + kpos[rh]) * a.KV + kvh) * HD;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      *reinterpret_cast<uint32_t*>(a.dk + row + 8 * d + 2 * t4) =
          pack_bf16(dk[d][2 * rh] * a.sm_scale,
                    dk[d][2 * rh + 1] * a.sm_scale);
      *reinterpret_cast<uint32_t*>(a.dv + row + 8 * d + 2 * t4) =
          pack_bf16(dv[d][2 * rh], dv[d][2 * rh + 1]);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int LD = HD + kPad;
  constexpr int dq_smem = (2 * kRows + 2 * 2 * kTile) * LD * 2;
  constexpr int dkv_smem =
      (2 * kKeys + 2 * 2 * kQTile) * LD * 2 + 2 * 2 * kQTile * 4;
  cudaError_t err = allow_smem(flash_attention_bwd_dq_kernel<HD>, dq_smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_attention_bwd_dkv_kernel<HD>, dkv_smem);
  if (err != cudaSuccess) return err;
  const int64_t rows = static_cast<int64_t>(a.B) * a.KV * a.G * a.Sq;
  flash_attention_bwd_dsum<<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                             stream>>>(a, HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int bq = kRows / a.G;
  flash_attention_bwd_dq_kernel<HD>
      <<<dim3((a.Sq + bq - 1) / bq, a.KV, a.B), kThreads, dq_smem, stream>>>(
          a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_attention_bwd_dkv_kernel<HD>
      <<<dim3((a.Sk + kKeys - 1) / kKeys, a.KV, a.B), kThreads, dkv_smem,
         stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q (B, Sq, KV * G, hd), k/v (B, Sk, KV, hd), o (the forward's output) and
// dout (B, Sq, KV * G, hd): bf16, read by the element strides given (batch,
// position, head), every head row with unit hd stride and 16-byte aligned.
// lse: (B, KV * G, Sq) f32 contiguous, as the forward wrote it; kv_len: (B,)
// int32 on the device or null; dsum: (B, KV * G, Sq) f32 scratch. dq (B,
// Sq, KV * G, hd), dk and dv (B, Sk, KV, hd): bf16 contiguous, every
// element written. window <= 0 means no window. 1 <= G <= 64, hd 32, 64, 80
// or 128. Returns a cudaError_t (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* kv_len, void* dsum,
    void* dq, void* dk, void* dv, int B, int Sq, int Sk, int KV, int G,
    int hd, int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb, int64_t sks,
    int64_t skh, int64_t svb, int64_t svs, int64_t svh, int64_t sob,
    int64_t sos, int64_t soh, int64_t sdb, int64_t sds, int64_t sdh,
    int causal, int window, float sm_scale, void* stream) {
  if (G <= 0 || G > kRows || B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               static_cast<const __nv_bfloat16*>(o),
               static_cast<const __nv_bfloat16*>(dout),
               static_cast<const float*>(lse),
               static_cast<float*>(dsum),
               static_cast<const int32_t*>(kv_len),
               static_cast<__nv_bfloat16*>(dq),
               static_cast<__nv_bfloat16*>(dk),
               static_cast<__nv_bfloat16*>(dv),
               B, Sq, Sk, KV, G, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh,
               sob, sos, soh, sdb, sds, sdh, causal, window, sm_scale};
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:  return launch<32>(a, st);
    case 64:  return launch<64>(a, st);
    case 80:  return launch<80>(a, st);
    case 128: return launch<128>(a, st);
    default:  return cudaErrorInvalidValue;
  }
}

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
// bytes at short keys (moment-large's training: 64 patches, 16.8 MB for
// 0.68 GFLOP), operations at long keys (five products of (Sq x Sk x hd)
// per head, 2.5x the forward's: whisper's 1500 frames). Every product runs
// on the tensor cores (mma.sync m16n8k16); P and dS are recomputed from
// the scores where they are used; tiles stream through shared memory by
// cp.async two stages deep; and no atomics: each output element is summed
// in a fixed order and written once, so two calls give the same bits. The
// wrapper's plan (flash_attention.py::_bwd_plan, from the shapes alone)
// picks one of two decompositions:
//
// Short keys (Sk <= kKeys = 64): one launch, flash_attention_bwd_fused.
// One CTA of 4 warps per (kv head, row) holds every key (16 a warp) and
// every query (Sq <= Sk), and walks the G heads of the group. Per head: Q,
// dO and O land (the next head's in the other stage); D comes from dO and
// O in shared memory; S^T = K Q^T and dP^T = V dO^T with the keys as the M
// rows, P^T and dS^T packed from the accumulators as A operands, dV += P^T
// dO and dK += dS^T Q; dS^T goes to shared memory once (bf16) and each
// warp takes its 16 queries' dQ = scale dS K from it (A by ldmatrix.trans)
// and writes them: no other CTA adds to them. So q, k, v, o, dO and lse
// are read once and dq, dk, dv written once: the bytes the bound counts.
//
// Long keys: two launches.
//  1. flash_attention_bwd_dq_kernel: one CTA of 4 warps per (query tile,
//     kv head, row, key split), the forward's row map (64 rows of (query,
//     head), 16 a warp, 64 / G queries a CTA, dead rows where G does not
//     divide 64). It computes D for its rows first (the split-0 CTA writes
//     it for pass 2), holds Q and dO as A fragments and, over its split's
//     32-key tiles: S = Q K^T, dP = dO V^T, dS in registers, dQ += dS K.
//  2. flash_attention_bwd_dkv_kernel: one CTA of 4 warps per (64-key tile,
//     kv head, row, query split), 16 keys a warp, every product transposed
//     as in the fused kernel, walking its split's share of the (query head,
//     32-query tile) pairs that see its keys.
// Where the (tile, kv head, row) CTAs leave the card's SMs short (whisper's
// 1500 frames: 192 a pass on 132 SMs), the plan splits a pass's walk over
// up to 8 CTAs, launched as one thread-block cluster: each CTA writes its
// f32 partial into its own shared memory, and after a cluster barrier CTA
// s sums rows [64 s / n, 64 (s + 1) / n) of every partial over the
// cluster's distributed shared memory in rank order, scales and writes
// them. The split changes the rounding of the sum (a fixed order per
// plan), never whether two calls agree. Both passes were also built on
// Hopper's wgmma (64-row warpgroup products, tiles in the no-swizzle
// core-matrix layout by cp.async, S and dP double-buffered so the next
// tile's products ran under this tile's dS): right at every case, slower
// than these mma.sync passes at every long-key case (PERF.md §6), so every
// product here stays on mma.sync.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 64;      // dQ pass: (query, head) rows per CTA
constexpr int kTile = 32;      // dQ pass: keys per tile
constexpr int kKeys = 64;      // dK/dV pass and fused: keys per CTA, 16 a warp
constexpr int kQTile = 32;     // dK/dV pass: queries per tile (fused: per half)
constexpr int kPad = 8;        // bf16 padding per shared row
constexpr int kMaxSplits = 8;  // the portable cluster size
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;            // (B, H, Sq), natural log
  float* dsum;                 // D (B, H, Sq): written by pass 1, read by 2
  const int32_t* kv_len;       // (B,) or null
  __nv_bfloat16* dq;           // (B, Sq, H, hd) contiguous
  __nv_bfloat16* dk;           // (B, Sk, KV, hd) contiguous
  __nv_bfloat16* dv;
  int B, Sq, Sk, KV, G;
  int64_t sqb, sqs, sqh, skb, sks, skh, svb, svs, svh;
  int64_t sob, sos, soh, sdb, sds, sdh;
  int causal, window;
  float sm_scale;
  int dq_splits, dkv_splits;   // CTAs (one cluster) a pass's walk is cut in
};

// lse (natural) -> the exponent offset of P in log2 units; +inf (P = 0) for
// a row with no valid key (-inf) and for a row past Sq
__device__ __forceinline__ float lse2_of(const Args& a, int64_t idx,
                                         bool live) {
  if (!live) return INFINITY;
  const float x = a.lse[idx];
  return x == -INFINITY ? INFINITY : x * kLog2e;
}

// The cluster barrier (every thread of every CTA of the cluster): this
// thread's writes, shared memory included, are visible to the cluster once
// every thread has arrived.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// D of `rows` rows of dO and O in shared memory (stride LD), two threads a
// row, each over half of hd in order, the halves added by one shuffle:
// thread pairs (2r, 2r + 1) take row r, and both return its D
template <int HD>
__device__ __forceinline__ float row_dsum(const __nv_bfloat16* dos,
                                          const __nv_bfloat16* os, int tid) {
  constexpr int LD = HD + kPad;
  const int r = tid / 2, half = tid % 2;
  const __nv_bfloat162* orow =
      reinterpret_cast<const __nv_bfloat162*>(os + r * LD + half * (HD / 2));
  const __nv_bfloat162* drow =
      reinterpret_cast<const __nv_bfloat162*>(dos + r * LD + half * (HD / 2));
  float s = 0.f;
#pragma unroll
  for (int p = 0; p < HD / 4; ++p) {
    const float2 x = __bfloat1622float2(orow[p]);
    const float2 y = __bfloat1622float2(drow[p]);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
  }
  return s + __shfl_xor_sync(0xffffffffu, s, 1);
}

// the f32 partial rows [r0, r1) of width HD (stride LM floats) summed over
// the nsplit CTAs of the cluster in rank order: fn(row, col, float4 sum)
// for every 4 columns
template <int HD, typename F>
__device__ __forceinline__ void merge_rows(float* part, int r0, int r1,
                                           int nsplit, int tid, F&& fn) {
  constexpr int LM = HD + 8, Q4 = HD / 4;
  cg::cluster_group cluster = cg::this_cluster();
  for (int i = tid; i < (r1 - r0) * Q4; i += kThreads) {
    const int r = r0 + i / Q4, c = (i % Q4) * 4;
    float* at = part + r * LM + c;
    float4 s = *reinterpret_cast<const float4*>(cluster.map_shared_rank(at, 0));
    for (int p = 1; p < nsplit; ++p) {
      const float4 x =
          *reinterpret_cast<const float4*>(cluster.map_shared_rank(at, p));
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    fn(r, c, s);
  }
}

// four f32 values * scale -> four bf16 at dst (8 bytes)
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 s,
                                       float scale) {
  uint2 o;
  o.x = pack_bf16(s.x * scale, s.y * scale);
  o.y = pack_bf16(s.z * scale, s.w * scale);
  *reinterpret_cast<uint2*>(dst) = o;
}

// a warp's 16 x HD f32 accumulator fragments (rows warp * 16 + g + 8 rh,
// columns 8 d + 2 t4) into shared rows of stride LM floats
template <int HD>
__device__ __forceinline__ void stash_rows(float* part, const float (*acc)[4],
                                           int warp, int lane) {
  constexpr int LM = HD + 8, DT = HD / 8;
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh)
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<float2*>(part + (warp * 16 + g + 8 * rh) * LM + 8 * d +
                                 2 * t4) =
          make_float2(acc[d][2 * rh], acc[d][2 * rh + 1]);
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

// ---------------- short keys: one fused launch ----------------

// one CTA an SM from hd 80 (its shared memory: 100 KB at hd 80, 150 at
// 128), two below
template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 2 : 1)
flash_attention_bwd_fused(const Args a) {
  constexpr int LD = HD + kPad, kVec = HD / 8, DT = HD / 8;
  constexpr int NQ = kQTile / 8, LS = kKeys + kPad;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // K rows, V rows, two stages of (Q, dO, O) rows, dS^T (keys x queries),
  // then two stages of (lse2, D) for the head's queries
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kKeys * LD;
  __nv_bfloat16* stg = vs + kKeys * LD;
  __nv_bfloat16* dst = stg + 2 * 3 * kKeys * LD;
  float* ld = reinterpret_cast<float*>(dst + kKeys * LS);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = a.G, Sq = a.Sq, H = a.KV * G;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int q_off = a.Sk - Sq;
  const int g = lane / 4, t4 = lane % 4;
  int kend = a.Sk;
  if (a.kv_len != nullptr) kend = min(kend, max(0, a.kv_len[b]));

  // every key (zeros at and past kend) joins the first head's copy group
  load_rows<HD, kKeys>(ks, a.k + b * a.skb + kvh * a.skh, a.sks, 0, kend, tid);
  load_rows<HD, kKeys>(vs, a.v + b * a.svb + kvh * a.svh, a.svs, 0, kend, tid);
  // stage `st` <- head gi of the group: its Q, dO and O rows (zeros past
  // Sq) and its lse2
  auto load_head = [&](int gi, int st) {
    const int h = kvh * G + gi;
    __nv_bfloat16* base = stg + st * 3 * kKeys * LD;
    load_rows<HD, kKeys>(base, a.q + b * a.sqb + h * a.sqh, a.sqs, 0, Sq,
                         tid);
    load_rows<HD, kKeys>(base + kKeys * LD, a.dout + b * a.sdb + h * a.sdh,
                         a.sds, 0, Sq, tid);
    load_rows<HD, kKeys>(base + 2 * kKeys * LD, a.o + b * a.sob + h * a.soh,
                         a.sos, 0, Sq, tid);
    if (tid < kKeys) {
      const bool live = tid < Sq;
      ld[st * 2 * kKeys + tid] = lse2_of(
          a, (static_cast<int64_t>(b) * H + h) * Sq + (live ? tid : 0), live);
    }
  };
  load_head(0, 0);
  cp_async_commit();

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
    dk[d][0] = dk[d][1] = dk[d][2] = dk[d][3] = dv[d][0] = dv[d][1] =
        dv[d][2] = dv[d][3] = 0.f;
  const float sl2 = a.sm_scale * kLog2e;
  int kpos[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) kpos[rh] = warp * 16 + g + 8 * rh;

  for (int gi = 0; gi < G; ++gi) {
    const int st = gi % 2, h = kvh * G + gi;
    if (gi + 1 < G) load_head(gi + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                    // head gi's rows landed
    const __nv_bfloat16* qst = stg + st * 3 * kKeys * LD;
    const __nv_bfloat16* dost = qst + kKeys * LD;
    __nv_bfloat16* ost = const_cast<__nv_bfloat16*>(dost + kKeys * LD);
    const float* lse2 = ld + st * 2 * kKeys;
    float* dsum = ld + st * 2 * kKeys + kKeys;
    {
      const float s = row_dsum<HD>(dost, ost, tid);
      if (tid % 2 == 0) dsum[tid / 2] = s;
    }
    __syncthreads();                    // D of every query

    // two halves of 32 queries: S^T = K Q^T and dP^T = V dO^T (16 keys a
    // warp), P^T and dS^T in registers, dV += P^T dO, dK += dS^T Q, and
    // dS^T to shared memory for dQ
#pragma unroll 1
    for (int c = 0; c < kKeys / kQTile; ++c) {
      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] =
            dp[j][2] = dp[j][3] = 0.f;
      rows_times_rows<HD, NQ>(s, ks + warp * 16 * LD, qst + c * kQTile * LD,
                              lane);
      rows_times_rows<HD, NQ>(dp, vs + warp * 16 * LD, dost + c * kQTile * LD,
                              lane);
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c * kQTile + 8 * j + 2 * t4 + (e & 1);
          float p = fast_exp2(fmaf(s[j][e], sl2, -lse2[col]));
          if (!visible(a, q_off + col, kpos[e / 2], kend)) p = 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - dsum[col]);
        }
      }
      acc_times_rows<HD, kQTile / 16>(dv, s, dost + c * kQTile * LD, lane);
      acc_times_rows<HD, kQTile / 16>(dk, dp, qst + c * kQTile * LD, lane);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh)
          *reinterpret_cast<uint32_t*>(
              dst + (warp * 16 + g + 8 * rh) * LS + c * kQTile + 8 * j +
              2 * t4) = pack_bf16(dp[j][2 * rh], dp[j][2 * rh + 1]);
    }
    __syncthreads();                    // dS^T whole; O no longer read

    // dQ = scale dS K for the warp's 16 queries: dS as A fragments from
    // dS^T (ldmatrix.trans), K's B fragments transposed from its rows; the
    // result staged in the warp's own O rows, then stored 16 bytes a lane
    uint32_t af[kKeys / 16][4];
#pragma unroll
    for (int kt = 0; kt < kKeys / 16; ++kt)
      ldsm_x4_trans(smem_u32(dst + (16 * kt + (lane >> 4) * 8 + (lane & 7)) *
                                       LS +
                             warp * 16 + ((lane >> 3) & 1) * 8),
                    af[kt]);
#pragma unroll
    for (int d = 0; d < DT; d += 2) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kt = 0; kt < kKeys / 16; ++kt) {
        uint32_t bk[4];
        ldsm_x4_trans(smem_u32(ks + (16 * kt + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * LD +
                               8 * d + (lane >> 4) * 8),
                      bk);
        mma_bf16(acc[0], af[kt], bk[0], bk[1]);
        mma_bf16(acc[1], af[kt], bk[2], bk[3]);
      }
#pragma unroll
      for (int dd = 0; dd < 2; ++dd)
#pragma unroll
        for (int rh = 0; rh < 2; ++rh)
          *reinterpret_cast<uint32_t*>(ost + (warp * 16 + g + 8 * rh) * LD +
                                       8 * (d + dd) + 2 * t4) =
              pack_bf16(acc[dd][2 * rh] * a.sm_scale,
                        acc[dd][2 * rh + 1] * a.sm_scale);
    }
    __syncwarp();
    for (int i = lane; i < 16 * kVec; i += 32) {
      const int r = warp * 16 + i / kVec, c = i % kVec;
      if (r >= Sq) continue;
      *reinterpret_cast<uint4*>(
          a.dq + ((static_cast<int64_t>(b) * Sq + r) * H + h) * HD + c * 8) =
          *reinterpret_cast<const uint4*>(ost + r * LD + c * 8);
    }
    __syncthreads();                    // this stage's reads done
  }
  cp_async_wait<0>();

  // every key row below Sk, zeros where no query saw it
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

// ---------------- long keys, pass 1: D and dQ ----------------

// three CTAs an SM up to hd 64; at hd 80 (168 registers, its D and split
// state) it spilled under three's cap, so two from hd 80
template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 3 : 2)
flash_attention_bwd_dq_kernel(const Args a) {
  constexpr int LD = HD + kPad, kVec = HD / 8, KC = HD / 16;
  constexpr int NT = kTile / 8, DT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Q rows, dO rows, O rows, two stages of (K tile, V tile), then D of the
  // rows; after the walk the stages hold this split's f32 partial dQ
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kRows * LD;
  __nv_bfloat16* os = dos + kRows * LD;
  __nv_bfloat16* kv = os + kRows * LD;
  float* dsm = reinterpret_cast<float*>(kv + 2 * 2 * kTile * LD);
  float* part = reinterpret_cast<float*>(kv);
  static_assert(kRows * (HD + 8) * 4 <= 2 * 2 * kTile * LD * 2,
                "the partial fits in the stages");

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = a.G, Sq = a.Sq, H = a.KV * G;
  const int nsplit = a.dq_splits, split = blockIdx.x % nsplit;
  const int bq = kRows / G, live_rows = bq * G;
  const int q0 = (blockIdx.x / nsplit) * bq, kvh = blockIdx.y, b = blockIdx.z;
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
  }
  // the key tiles the CTA's queries see, and this split's share of them
  int kend = a.Sk;
  if (a.kv_len != nullptr) kend = min(kend, max(0, a.kv_len[b]));
  int hi = kend;
  if (a.causal) hi = min(hi, qpos_hi + 1);
  int lo = 0;
  if (a.window > 0) lo = max(lo, qpos_lo - a.window + 1);
  const int ntiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;
  const int t_lo = split * ntiles / nsplit;
  const int t_hi = (split + 1) * ntiles / nsplit;
  const __nv_bfloat16* kb = a.k + b * a.skb + kvh * a.skh;
  const __nv_bfloat16* vb = a.v + b * a.svb + kvh * a.svh;

  // Q, dO and O rows (zeros past Sq and in dead rows) and the first tile
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
    cp_async16(os + r * LD + c * 8,
               a.o + b * a.sob + qc * a.sos + h * a.soh + c * 8, live);
  }
  if (t_lo < t_hi) {
    const int j0 = lo + t_lo * kTile;
    load_rows<HD, kTile>(kv, kb, a.sks, j0, kend, tid);
    load_rows<HD, kTile>(kv + kTile * LD, vb, a.svs, j0, kend, tid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // D of the CTA's rows (zero in dead rows); split 0 writes it for pass 2
  {
    const float s = row_dsum<HD>(dos, os, tid);
    const int r = tid / 2, qi = q0 + r / G;
    if (tid % 2 == 0) {
      dsm[r] = s;
      if (split == 0 && qi < Sq && r < live_rows)
        a.dsum[(static_cast<int64_t>(b) * H + kvh * G + r % G) * Sq + qi] = s;
    }
  }
  __syncthreads();
  uint32_t qa[KC][4], da[KC][4];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) dsum[rh] = dsm[warp * 16 + g + 8 * rh];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    ldsm_x4(smem_u32(qs + (warp * 16 + (lane & 15)) * LD + kc * 16 +
                     (lane >> 4) * 8),
            qa[kc]);
    ldsm_x4(smem_u32(dos + (warp * 16 + (lane & 15)) * LD + kc * 16 +
                     (lane >> 4) * 8),
            da[kc]);
  }

  float dq[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;
  const float sl2 = a.sm_scale * kLog2e;

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    const int j0 = lo + t * kTile;
    if (t + 1 < t_hi) {                 // into the stage tile t - 1 freed
      __nv_bfloat16* nk = kv + (st ^ 1) * 2 * kTile * LD;
      load_rows<HD, kTile>(nk, kb, a.sks, j0 + kTile, kend, tid);
      load_rows<HD, kTile>(nk + kTile * LD, vb, a.svs, j0 + kTile, kend, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                    // tile t landed
    const __nv_bfloat16* ks = kv + st * 2 * kTile * LD;
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
  cp_async_wait<0>();
  __syncthreads();

  if (nsplit == 1) {
    // scale, stage the warp's 16 rows in its own Q rows, store 16 bytes a
    // lane
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      __nv_bfloat16* dst = qs + (warp * 16 + g + 8 * rh) * LD + 2 * t4;
#pragma unroll
      for (int d = 0; d < DT; ++d)
        *reinterpret_cast<uint32_t*>(dst + 8 * d) = pack_bf16(
            dq[d][2 * rh] * a.sm_scale, dq[d][2 * rh + 1] * a.sm_scale);
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
    return;
  }
  // split: the partials meet over the cluster; CTA `split` sums its share
  // of the rows in rank order
  stash_rows<HD>(part, dq, warp, lane);
  cluster_sync();
  merge_rows<HD>(part, split * kRows / nsplit, (split + 1) * kRows / nsplit,
                 nsplit, tid, [&](int r, int c, float4 s) {
                   const int qi = q0 + r / G;
                   if (qi >= Sq || r >= live_rows) return;
                   const int h = kvh * G + r % G;
                   store4(a.dq + ((static_cast<int64_t>(b) * Sq + qi) * H +
                                  h) * HD + c,
                          s, a.sm_scale);
                 });
  cluster_sync();                       // every read of this CTA's partial
}

// ---------------- long keys, pass 2: dK and dV ----------------

// three CTAs an SM up to hd 64; at hd 80 the dK and dV accumulators (80
// registers) spilled under three's 168-register cap, so two from hd 80
template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 3 : 2)
flash_attention_bwd_dkv_kernel(const Args a) {
  constexpr int LD = HD + kPad, DT = HD / 8, NQ = kQTile / 8;
  constexpr int LM = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // K rows, V rows, then two stages of (Q tile, dO tile), then two stages
  // of (lse2, D) for the tile's queries; after the walk the rows hold this
  // split's f32 partial dK, then dV
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kKeys * LD;
  __nv_bfloat16* qd = vs + kKeys * LD;
  float* ld = reinterpret_cast<float*>(qd + 2 * 2 * kQTile * LD);
  float* part = reinterpret_cast<float*>(smem_raw);
  static_assert(2 * kKeys * LM * 4 <= (2 * kKeys + 4 * kQTile) * LD * 2,
                "the partials fit in the rows");

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int G = a.G, Sq = a.Sq, H = a.KV * G;
  const int nsplit = a.dkv_splits, split = blockIdx.x % nsplit;
  const int j0 = (blockIdx.x / nsplit) * kKeys, kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int q_off = a.Sk - Sq;
  const int g = lane / 4, t4 = lane % 4;
  int kend = a.Sk;
  if (a.kv_len != nullptr) kend = min(kend, max(0, a.kv_len[b]));
  // the queries that see a valid key of this tile: [i_lo, i_hi); this
  // split walks (head, query tile) pairs [it_lo, it_hi) of the G * nqt
  const int kmax = min(j0 + kKeys, kend) - 1;
  int i_lo = 0, i_hi = kmax >= j0 ? Sq : 0;
  if (a.causal) i_lo = max(i_lo, j0 - q_off);
  if (a.window > 0) i_hi = min(i_hi, kmax + a.window - q_off);
  const int nqt = i_hi > i_lo ? (i_hi - i_lo + kQTile - 1) / kQTile : 0;
  const int nit = G * nqt;
  const int it_lo = split * nit / nsplit, it_hi = (split + 1) * nit / nsplit;

  // this tile's K and V rows (zeros at and past kend) join the first
  // stage's copy group
  if (it_lo < it_hi) {
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
  if (it_lo < it_hi) load_it(it_lo, 0);
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

  for (int it = it_lo; it < it_hi; ++it) {
    const int st = (it - it_lo) & 1;
    if (it + 1 < it_hi) load_it(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();                    // iteration it's tiles landed
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

  if (nsplit == 1) {
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
    return;
  }
  // split: the partials meet over the cluster; CTA `split` sums its share
  // of the key rows in rank order
  __syncthreads();                      // K and V no longer read
  stash_rows<HD>(part, dk, warp, lane);
  stash_rows<HD>(part + kKeys * LM, dv, warp, lane);
  cluster_sync();
  const int r0 = split * kKeys / nsplit, r1 = (split + 1) * kKeys / nsplit;
  auto out_row = [&](int r) {
    return ((static_cast<int64_t>(b) * a.Sk + j0 + r) * a.KV + kvh) * HD;
  };
  merge_rows<HD>(part, r0, r1, nsplit, tid, [&](int r, int c, float4 s) {
    if (j0 + r < a.Sk) store4(a.dk + out_row(r) + c, s, a.sm_scale);
  });
  merge_rows<HD>(part + kKeys * LM, r0, r1, nsplit, tid,
                 [&](int r, int c, float4 s) {
                   if (j0 + r < a.Sk) store4(a.dv + out_row(r) + c, s, 1.f);
                 });
  cluster_sync();                       // every read of this CTA's partials
}

template <typename K>
cudaError_t allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

// `kernel` over `grid`, its x the tiles times `nsplit`: the splits of a
// tile one thread-block cluster of nsplit CTAs along x
template <typename K>
cudaError_t launch_split(K kernel, dim3 grid, int nsplit, int smem,
                         const Args& a, cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (nsplit == 1) {
    kernel<<<grid, kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <int HD>
cudaError_t launch(const Args& a, bool fused, cudaStream_t stream) {
  constexpr int LD = HD + kPad;
  if (fused) {
    constexpr int smem =
        (8 * kKeys * LD + kKeys * (kKeys + kPad)) * 2 + 4 * kKeys * 4;
    cudaError_t err = allow_smem(flash_attention_bwd_fused<HD>, smem);
    if (err != cudaSuccess) return err;
    flash_attention_bwd_fused<HD>
        <<<dim3(a.KV, a.B), kThreads, smem, stream>>>(a);
    return cudaGetLastError();
  }
  constexpr int dq_smem = (3 * kRows + 2 * 2 * kTile) * LD * 2 + kRows * 4;
  constexpr int dkv_smem =
      (2 * kKeys + 2 * 2 * kQTile) * LD * 2 + 2 * 2 * kQTile * 4;
  const int bq = kRows / a.G;
  cudaError_t err = launch_split(
      flash_attention_bwd_dq_kernel<HD>,
      dim3((a.Sq + bq - 1) / bq * a.dq_splits, a.KV, a.B), a.dq_splits,
      dq_smem, a, stream);
  if (err != cudaSuccess) return err;
  return launch_split(
      flash_attention_bwd_dkv_kernel<HD>,
      dim3((a.Sk + kKeys - 1) / kKeys * a.dkv_splits, a.KV, a.B),
      a.dkv_splits, dkv_smem, a, stream);
}

}  // namespace

// q (B, Sq, KV * G, hd), k/v (B, Sk, KV, hd), o (the forward's output) and
// dout (B, Sq, KV * G, hd): bf16, read by the element strides given (batch,
// position, head), every head row with unit hd stride and 16-byte aligned.
// lse: (B, KV * G, Sq) f32 contiguous, as the forward wrote it; kv_len: (B,)
// int32 on the device or null. dq (B, Sq, KV * G, hd), dk and dv (B, Sk,
// KV, hd): bf16 contiguous, every element written. window <= 0 means no
// window. 1 <= G <= 64, hd 32, 64, 80 or 128. The plan (the wrapper's
// _bwd_plan): `fused` (needs Sq <= Sk <= 64: one launch, dsum unused and may be
// null), else dsum (B, KV * G, Sq) f32 scratch and the CTAs (1 to 8, one
// cluster) the dQ and the dK/dV walks are split over. Returns a
// cudaError_t (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, const void* kv_len, void* dsum,
    void* dq, void* dk, void* dv, int B, int Sq, int Sk, int KV, int G,
    int hd, int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb, int64_t sks,
    int64_t skh, int64_t svb, int64_t svs, int64_t svh, int64_t sob,
    int64_t sos, int64_t soh, int64_t sdb, int64_t sds, int64_t sdh,
    int causal, int window, float sm_scale, int fused, int dq_splits,
    int dkv_splits, void* stream) {
  if (G <= 0 || G > kRows || B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0)
    return cudaErrorInvalidValue;
  if (fused ? (Sk > kKeys || Sq > Sk)
            : (dsum == nullptr || dq_splits < 1 || dq_splits > kMaxSplits ||
               dkv_splits < 1 || dkv_splits > kMaxSplits))
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
               sob, sos, soh, sdb, sds, sdh, causal, window, sm_scale,
               fused ? 1 : dq_splits, fused ? 1 : dkv_splits};
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:  return launch<32>(a, fused != 0, st);
    case 64:  return launch<64>(a, fused != 0, st);
    case 80:  return launch<80>(a, fused != 0, st);
    case 128: return launch<128>(a, fused != 0, st);
    default:  return cudaErrorInvalidValue;
  }
}

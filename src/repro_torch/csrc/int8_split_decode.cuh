// K3's split body, for Hopper (sm_90a): the dense int8 flash-decode
// (decode_attention_int8.cu) for few (row, kv head) pairs and long key
// ranges, where the one-CTA body of int8_decode.cuh leaves the card idle.
// Same function as that body: for row b and kv head h the G query heads of
// the group attend the int8 keys/values of [max(0, len - window), len) that
// lie in the cache piece [key_offset, key_offset + S), dequantized on the
// fly with the per-(b, h) scales; a row without a valid key gives zeros
// (o 0 and lse -inf under the log-sum-exp epilogue). The Dense source policy
// of int8_decode.cuh supplies the range and the scales.
//
// What bounds it on this card: the bytes of the cache (2 hd bytes a key) at
// the long shapes (jamba's 524288 keys: 1.07 GB, 320 us at 3.35 TB/s), and
// at the serving shapes the round trips of a short walk. The one-CTA body
// walks a pair's keys with one CTA of 4 warps, 32 keys a round trip at G >=
// 4, on at most B * KV SMs: 8 of 132 for the long_500k cells. So:
//
// - The keys are split over CTAs: nsplit CTAs a (row, kv head) pair, planned
//   on the host from shapes only (kernels/decode_attention_int8.py, `plan`),
//   and CTA i takes the i-th share of its row's own range, rounded up to a
//   CTA pass (so that rows shorter than the plan balance too). With one
//   split the CTA writes the output; with more, each writes an f32 partial
//   (its accumulator, max and sum) and a second launch (merge_kernel) merges
//   them in split order: the same bits on every call, no atomics.
// - Each warp walks its own stages (16 CH keys: a CTA pass is 4 of them) in
//   a ring of kStages in shared memory, filled by 16-byte cp.async with
//   kStages - 1 stages in flight, so the loads wait on nothing the math
//   holds. The warps meet only at the end, to merge their (m, l, o).
// - The G heads score 16 keys at once on the tensor cores: mma.sync m16n8k16
//   f16 -> f32, S = Q K^T with the heads as the A rows (padded to 16) and P V
//   with P as A, as flash attention does. int8 codes become f16 exactly in
//   two instructions a pair (the byte, offset by 128, into the mantissa of
//   1024 by PRMT, then 1152 subtracted), so no conversion unit is used. q is
//   scaled by a power of two into f16's range (its max to [2^14, 2^15)) and
//   the scale is folded into the score scale: exact. p is rounded to f16
//   (11 significant bits) for P V; both products accumulate in f32.
// - The layout of each fragment is chosen so that a lane's share of a key
//   row is one 32-bit word: the dims of a k-chunk and the keys of a P V chunk
//   are permuted consistently on both sides of each product (pi below), and
//   V's 4 x 4 byte blocks are transposed in registers by PRMT. 16-byte
//   chunks of a row are XOR-swizzled in shared memory so that a warp's reads
//   hit distinct banks (hd 128 and 64; hd 80 and 32 have 2-way conflicts).
// - The scales are per (row, kv head): k's is folded into the scores, v's
//   applied once at the end.
//
// The primitives (cp.async, mma.sync, f16x2 packing and subtraction) are
// defined below for the card; a host build (tests/cuda_host/) supplies
// stand-ins of the same names, so that g++ runs this body on the CPU.

#pragma once

#include "int8_decode.cuh"

namespace int8_decode {

#ifdef __CUDACC__
// 16 bytes global -> shared, asynchronous (no registers)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// c (16 x 8 f32) += a (16 x 16 f16, row) * b (16 x 8 f16, col)
__device__ __forceinline__ void mma_f16_16816(float* c, const uint32_t* a,
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> f16x2 (lo in the low half), round to nearest even
__device__ __forceinline__ uint32_t f16x2_pack(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.f16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// a - b on two f16 lanes, round to nearest even
__device__ __forceinline__ uint32_t f16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
#endif

constexpr uint32_t kF16High = 0x64646464u;     // f16 1024's high byte, 4 times
constexpr uint32_t kF16Bias = 0x64806480u;     // f16x2 1152 = 1024 + 128

// Two int8 codes (bytes J and J + 1 of x, already offset: x ^ 0x80808080)
// as f16x2, exactly: PRMT puts each byte under 0x64 (f16 1024 + byte), then
// 1152 is subtracted.
template <int J>
__device__ __forceinline__ uint32_t codes_f16x2(uint32_t x) {
  return f16x2_sub(__byte_perm(x, kF16High, 0x4040u | J | ((J + 1) << 8)),
                   kF16Bias);
}

// Tiles of the split body at head dim HD: a warp stage holds CH chunks of
// 16 keys (its K rows, then its V rows, hd bytes each: 4-5 KB), a CTA pass
// is one stage a warp, a ring holds kStages stages a warp.
template <int HD>
struct SplitTile {
  static constexpr int CH = HD >= 128 ? 1 : (HD >= 64 ? 2 : 4);
  static constexpr int KEYS = 16 * CH;                // keys a warp stage
  static constexpr int PASS = kWarps * KEYS;          // keys a CTA pass
  static constexpr int NCH = HD / 16;                 // 16-byte chunks a row
  static constexpr int NKC = HD / 16;                 // k-chunks of Q K^T
  static constexpr int NT = HD / 8;                   // n-tiles of P V
  static constexpr int NB4 = HD / 32;                 // P V blocks of 32 dims
  static constexpr int kStages = 3;
  static constexpr int STAGE = 2 * KEYS * HD;         // bytes
  static constexpr int COPIES = KEYS * NCH / 32;      // cp.async a lane a row set
  static_assert(HD % 16 == 0 && (KEYS * NCH) % 32 == 0, "split tiles");
  // the 16-byte chunk XOR of key row r of a stage (K and V tiles): chosen
  // by a search over XOR-linear maps of r's low 4 bits for the fewest bank
  // conflicts of the reads below; hd 80 (5 chunks a row) is not swizzled
  static __device__ __forceinline__ int swk(int r) {
    return HD == 128 ? ((r & 1) | ((r >> 1) & 6))
         : HD == 64 ? ((r >> 2) & 3) : HD == 32 ? ((r >> 2) & 1) : 0;
  }
  static __device__ __forceinline__ int swv(int r) {
    return HD == 128 ? ((r >> 1) & 6) : HD == 64 ? ((r >> 1) & 2) : 0;
  }
};

// Dynamic shared memory of the split body: the warps' rings, which the
// warps' merge (kWarps x G x HD accumulators, kWarps x G (m, l)) reuses.
template <int HD, int G>
__host__ __device__ constexpr size_t split_smem_bytes() {
  constexpr size_t ring = static_cast<size_t>(kWarps) *
                          SplitTile<HD>::kStages * SplitTile<HD>::STAGE;
  constexpr size_t merge = sizeof(float) * (kWarps * G * HD + 2 * kWarps * G);
  return ring > merge ? ring : merge;
}

// Key pi(j, n) of a 16-key chunk is column n of S-tile j (j = 0, 1), so that
// a lane's scores of S-tiles 0 and 1 are its keys 4t .. 4t + 3, the keys of
// its A fragment of P (k indices 2t, 2t + 1, 2t + 8, 2t + 9) in P V.
__device__ __forceinline__ int split_pi(int j, int n) {
  return 4 * (n >> 1) + 2 * j + (n & 1);
}

// The split body: CTA blockIdx.x = pair * nsplit + split, pair = b * KV + h.
// nsplit 1: the output (bf16 out, or with lse non-null f32 out_f32 and lse)
// is written here. nsplit > 1: part_o (pairs * nsplit, G, HD) f32 gets the
// CTA's accumulator times v's scale, relative to its max, and part_ml
// (pairs * nsplit, G, 2) its max (log2 units) and sum; merge_kernel writes
// the output.
template <int HD, int G>
__global__ void __launch_bounds__(kThreads)
decode_int8_split_kernel(const __nv_bfloat16* __restrict__ q,
                         const int8_t* __restrict__ kq,
                         const int8_t* __restrict__ vq,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int32_t* __restrict__ lengths,
                         __nv_bfloat16* __restrict__ out, int KV, int S,
                         int64_t skb, int64_t skh, int64_t sks, int64_t svb,
                         int64_t svh, int64_t svs, int window, float sm_scale,
                         int key_offset, float* __restrict__ out_f32,
                         float* __restrict__ lse, int nsplit,
                         float* __restrict__ part_o,
                         float* __restrict__ part_ml) {
  using T = SplitTile<HD>;
  constexpr int KEYS = T::KEYS, NS = T::kStages, NCH = T::NCH;
  unsigned char* smem = int8_decode_smem;
  const int pair = blockIdx.x / nsplit, split = blockIdx.x % nsplit;
  const int b = pair / KV, h = pair % KV;
  const Dense src(kq, vq, k_scale, v_scale, lengths, b, h, KV, S, skb, skh,
                  sks, svb, svh, svs, window, sm_scale, key_offset);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;    // a fragment's row and column pair

  // this CTA's share of the row's range, in whole CTA passes
  const int span = src.s_hi - src.s_lo;
  const int per = (span + nsplit - 1) / nsplit;
  const int share = (per + T::PASS - 1) / T::PASS * T::PASS;
  const int lo = min(src.s_lo + split * share, src.s_hi);
  const int hi = min(lo + share, src.s_hi);
  const int ntile = (hi - lo + KEYS - 1) / KEYS;
  const int nst = ntile > warp ? (ntile - warp + kWarps - 1) / kWarps : 0;

  unsigned char* ring = smem + warp * NS * T::STAGE;
  // stage i of this warp: tile warp + kWarps i of the CTA's range, into
  // slot i % NS; rows past the range are not copied (their scores are
  // masked, and P V multiplies their stale codes by p = 0)
  auto issue = [&](int i) {
    const int s0 = lo + (warp + kWarps * i) * KEYS;
    const int nk = min(KEYS, hi - s0);
    unsigned char* ks = ring + (i % NS) * T::STAGE;
    unsigned char* vs = ks + KEYS * HD;
#pragma unroll
    for (int u = 0; u < T::COPIES; ++u) {
      const int idx = lane + 32 * u;
      const int r = idx / NCH, c = idx % NCH;
      if (r < nk) {
        const int64_t s = s0 + r;
        cp_async16(ks + r * HD + 16 * (c ^ T::swk(r)),
                   src.kbase + s * src.sks + 16 * c);
        cp_async16(vs + r * HD + 16 * (c ^ T::swv(r)),
                   src.vbase + s * src.svs + 16 * c);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nst) issue(i);
    cp_async_commit();
  }

  // q as the A fragments of Q K^T: row g (a head; rows >= G and 8-15 zero),
  // k-chunk c's logical dims (2t, 2t + 1 | 2t + 8, 2t + 9) are the physical
  // dims 16 c + 4 t + (0, 1 | 2, 3); scaled by a power of two so that the
  // largest |q| of the group lies in [2^14, 2^15) (exact; f16 holds it)
  uint32_t qa[T::NKC][2];
  float qmax = 0.f;
  {
    float qf[T::NKC][4];
#pragma unroll
    for (int c = 0; c < T::NKC; ++c) {
      uint2 w = {0u, 0u};
      if (g < G)
        w = *reinterpret_cast<const uint2*>(
            q + static_cast<int64_t>(pair) * G * HD + g * HD + 16 * c + 4 * t);
      qf[c][0] = __uint_as_float(w.x << 16);
      qf[c][1] = __uint_as_float(w.x & 0xffff0000u);
      qf[c][2] = __uint_as_float(w.y << 16);
      qf[c][3] = __uint_as_float(w.y & 0xffff0000u);
#pragma unroll
      for (int e = 0; e < 4; ++e) qmax = fmaxf(qmax, fabsf(qf[c][e]));
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
      qmax = fmaxf(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
    // biased exponent E of qmax: scale 2^(141 - E), clamped to normal floats
    const int E = min(max(static_cast<int>(__float_as_uint(qmax) >> 23), 15), 254);
    const float qs = __uint_as_float(static_cast<uint32_t>(268 - E) << 23);
    qmax = __uint_as_float(static_cast<uint32_t>(E - 14) << 23);   // 1 / qs
#pragma unroll
    for (int c = 0; c < T::NKC; ++c) {
      qa[c][0] = f16x2_pack(qf[c][0] * qs, qf[c][1] * qs);
      qa[c][1] = f16x2_pack(qf[c][2] * qs, qf[c][3] * qs);
    }
  }
  const float kscale = src.kscale * qmax;   // log2 units, q's scale undone

  // online softmax of row g (the same over the four lanes t of a row): m
  // the max (log2 units), l this lane's share of the sum, acc the P V
  // fragments (c0, c1: row g; c2, c3: rows 8-15, zero)
  float m = -INFINITY, l = 0.f;
  float acc[T::NT][4];
#pragma unroll
  for (int n = 0; n < T::NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < nst; ++i) {
    cp_async_wait<NS - 2>();
    __syncwarp();
    const unsigned char* ks = ring + (i % NS) * T::STAGE;
    const unsigned char* vs = ks + KEYS * HD;
    const int nk = min(KEYS, hi - (lo + (warp + kWarps * i) * KEYS));
#pragma unroll
    for (int kc = 0; kc < T::CH; ++kc) {
      if (16 * kc >= nk) break;                 // warp-uniform
      // S = Q K^T over the chunk's 16 keys: S-tile j column n is key
      // 16 kc + pi(j, n); this lane gives column g, and gets row g's
      // scores of keys 4t .. 4t + 3 (sc[j][0..1])
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int c = 0; c < T::NKC; ++c) {
        const uint32_t a[4] = {qa[c][0], 0u, qa[c][1], 0u};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = 16 * kc + split_pi(j, g);
          const uint32_t x = *reinterpret_cast<const uint32_t*>(
                                 ks + r * HD + 16 * (c ^ T::swk(r)) + 4 * t) ^
                             0x80808080u;
          mma_f16_16816(sc[j], a, codes_f16x2<0>(x), codes_f16x2<2>(x));
        }
      }
      float s[4] = {sc[0][0] * kscale, sc[0][1] * kscale, sc[1][0] * kscale,
                    sc[1][1] * kscale};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (16 * kc + 4 * t + e >= nk) s[e] = -INFINITY;
      float mx = fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (mx > m) {                   // mx is finite: the chunk has a key
        const float corr = exp2f(m - mx);       // 0 while m is -inf
        l *= corr;
#pragma unroll
        for (int n = 0; n < T::NT; ++n) {
          acc[n][0] *= corr;
          acc[n][1] *= corr;
        }
        m = mx;
      }
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f(s[e] - m);
        l += p[e];
      }
      const uint32_t pa[4] = {f16x2_pack(p[0], p[1]), 0u,
                              f16x2_pack(p[2], p[3]), 0u};
      // P V: this lane gives keys 4t .. 4t + 3 of column g of each n-tile:
      // in a block of 32 dims, n-tile 4 blk + jj's column n is dim 32 blk +
      // 4 n + jj; its four rows' words, transposed by PRMT, hold them
      const unsigned char* vrow = vs + (16 * kc + 4 * t) * HD;
#pragma unroll
      for (int blk = 0; blk < T::NB4; ++blk) {
        uint32_t x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * kc + 4 * t + e;
          x[e] = *reinterpret_cast<const uint32_t*>(
                     vrow + e * HD + 16 * ((2 * blk + (g >> 2)) ^ T::swv(r)) +
                     4 * (g & 3)) ^
                 0x80808080u;
        }
        const uint32_t lo01 = __byte_perm(x[0], x[1], 0x5140u);
        const uint32_t hi01 = __byte_perm(x[0], x[1], 0x7362u);
        const uint32_t lo23 = __byte_perm(x[2], x[3], 0x5140u);
        const uint32_t hi23 = __byte_perm(x[2], x[3], 0x7362u);
        mma_f16_16816(acc[4 * blk], pa, codes_f16x2<0>(lo01), codes_f16x2<0>(lo23));
        mma_f16_16816(acc[4 * blk + 1], pa, codes_f16x2<2>(lo01), codes_f16x2<2>(lo23));
        mma_f16_16816(acc[4 * blk + 2], pa, codes_f16x2<0>(hi01), codes_f16x2<0>(hi23));
        mma_f16_16816(acc[4 * blk + 3], pa, codes_f16x2<2>(hi01), codes_f16x2<2>(hi23));
      }
      if constexpr (HD % 32 != 0) {
        // hd 80's last 16 dims: n-tiles 8 and 9, column n is dim 64 + 2 n +
        // jj, two bytes a row (chunk 4, not swizzled)
        uint32_t x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[e] = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(
                     vrow + e * HD + 32 * T::NB4 + 2 * g)) ^
                 0x8080u;
        const uint32_t lo01 = __byte_perm(x[0], x[1], 0x5140u);
        const uint32_t lo23 = __byte_perm(x[2], x[3], 0x5140u);
        mma_f16_16816(acc[4 * T::NB4], pa, codes_f16x2<0>(lo01), codes_f16x2<0>(lo23));
        mma_f16_16816(acc[4 * T::NB4 + 1], pa, codes_f16x2<2>(lo01), codes_f16x2<2>(lo23));
      }
    }
    __syncwarp();                     // the slot is read: it may be refilled
    if (i + NS - 1 < nst) issue(i + NS - 1);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // ---- the warps' merge, in warp order: row g's accumulator (dims of its
  // fragments), max and sum to shared memory, then one thread an output
  // element ----
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  __syncthreads();                    // every ring is read
  float* wacc = reinterpret_cast<float*>(smem);
  float* wm = wacc + kWarps * G * HD;
  float* wl = wm + kWarps * G;
  if (g < G) {
    float* row = wacc + (warp * G + g) * HD;
#pragma unroll
    for (int blk = 0; blk < T::NB4; ++blk)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        row[32 * blk + 8 * t + jj] = acc[4 * blk + jj][0];
        row[32 * blk + 8 * t + 4 + jj] = acc[4 * blk + jj][1];
      }
    if constexpr (HD % 32 != 0) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        row[32 * T::NB4 + 4 * t + jj] = acc[4 * T::NB4 + jj][0];
        row[32 * T::NB4 + 4 * t + 2 + jj] = acc[4 * T::NB4 + jj][1];
      }
    }
    if (t == 0) {
      wm[warp * G + g] = m;
      wl[warp * G + g] = l;
    }
  }
  __syncthreads();
  const int64_t base = static_cast<int64_t>(pair) * G * HD;
  const int64_t piece = static_cast<int64_t>(pair) * nsplit + split;
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int gg = i / HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * G + gg]);
    float o = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = wm[w * G + gg];
      const float wt = mw == -INFINITY ? 0.f : exp2f(mw - mx);
      o = fmaf(wacc[w * G * HD + i], wt, o);
      lsum = fmaf(wl[w * G + gg], wt, lsum);
    }
    o *= src.vscale;
    if (nsplit > 1) {
      part_o[piece * G * HD + i] = o;
      if (i % HD == 0) {
        part_ml[(piece * G + gg) * 2] = mx;
        part_ml[(piece * G + gg) * 2 + 1] = lsum;
      }
    } else {
      const float val = mx == -INFINITY ? 0.f : o / lsum;
      if (lse != nullptr) {
        out_f32[base + i] = val;
        if (i % HD == 0)
          lse[static_cast<int64_t>(pair) * G + gg] =
              mx == -INFINITY ? -INFINITY : (mx + log2f(lsum)) * 0.6931471805599453f;
      } else {
        out[base + i] = __float2bfloat16(val);
      }
    }
  }
}

// The splits' merge: one CTA of hd threads a (pair, head g), blockIdx.x =
// pair * G + g; the nsplit partials in split order (max, then the weighted
// sums), the output as the split body writes it with one split. The loops
// are unrolled so that a batch of splits' loads is in flight at once (the
// sums keep split order: unrolling reorders loads, not additions). Static:
// each object of a library built in parts holds its own copy.
static __global__ void __launch_bounds__(128)
merge_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
             __nv_bfloat16* __restrict__ out, float* __restrict__ out_f32,
             float* __restrict__ lse, int G, int HD, int nsplit) {
  const int pair = blockIdx.x / G, g = blockIdx.x % G;
  const int d = threadIdx.x;
  const int64_t first = static_cast<int64_t>(pair) * nsplit;
  float mx = -INFINITY;
#pragma unroll 8
  for (int i = 0; i < nsplit; ++i)
    mx = fmaxf(mx, __ldg(part_ml + ((first + i) * G + g) * 2));
  float o = 0.f, lsum = 0.f;
#pragma unroll 8
  for (int i = 0; i < nsplit; ++i) {
    const float mi = __ldg(part_ml + ((first + i) * G + g) * 2);
    const float wt = mi == -INFINITY ? 0.f : exp2f(mi - mx);
    o = fmaf(__ldg(part_o + ((first + i) * G + g) * HD + d), wt, o);
    lsum = fmaf(__ldg(part_ml + ((first + i) * G + g) * 2 + 1), wt, lsum);
  }
  const float val = mx == -INFINITY ? 0.f : o / lsum;
  const int64_t at = static_cast<int64_t>(blockIdx.x) * HD + d;
  if (lse != nullptr) {
    out_f32[at] = val;
    if (d == 0)
      lse[blockIdx.x] = mx == -INFINITY ? -INFINITY
                                        : (mx + log2f(lsum)) * 0.6931471805599453f;
  } else {
    out[at] = __float2bfloat16(val);
  }
}

}  // namespace int8_decode

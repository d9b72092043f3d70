// The split body of the int8 flash-decode kernels, for Hopper (sm_90a):
// K3 (decode_attention_int8.cu), K4 (paged_decode_attention.cu) and the
// verify window (paged_verify_attention.cu) for few (row, kv head) pairs and
// long key ranges, where the one-CTA body of int8_decode.cuh leaves the card
// idle. Same functions as that body: for row b and kv head h the G query
// heads of the group attend the int8 keys/values of [max(0, len - window),
// len), dequantized on the fly with their scales; a row without a valid key
// gives zeros. One walk (split_walk) serves all three; a source policy
// supplies the keys, the ranges and the scales: DenseSplit (K3: int8_
// decode.cuh's Dense, one range and one scale pair a (row, kv head), the
// piece of a split cache at key_offset, o 0 and lse -inf under the log-sum-
// exp epilogue) and PagedSplit (K4 and the verify window: int8_decode.cuh's
// Paged, the page table, a scale pair a (page, kv head), a range a row).
//
// What bounds it on this card: the bytes of the cache (2 hd bytes a key) at
// the long shapes (jamba's 524288 keys: 1.07 GB, 320 us at 3.35 TB/s), and
// at the serving shapes the round trips of a short walk. The one-CTA body
// walks a pair's keys with one CTA of 4 warps, 32 keys a round trip at G >=
// 4, on at most B * KV SMs: 8 of 132 for the long_500k cells, 64 for
// h2o-danube's serving window. So:
//
// - The keys are split over CTAs, planned on the host from shapes only
//   (kernels/decode_attention_int8.py and paged_decode_attention.py,
//   `plan`). K3: nsplit CTAs a (row, kv head) pair, CTA i taking the i-th
//   share of its row's own range, rounded up to a CTA pass (so that rows
//   shorter than the plan balance too). K4 and the verify window: a grid of
//   cells of absolute positions, [i C, (i + 1) C) with C a multiple of a
//   CTA pass, each CTA one cell, so that a key's cell, stage and warp do not
//   depend on the row's length (below). With one split the CTA writes the
//   output; with more, each writes an f32 partial (its accumulator, max and
//   sum) and a second launch (merge_kernel, paged_merge_kernel) merges them
//   in split order, skipping those without a key: the same bits on every
//   call, no atomics.
// - Each warp walks its own stages (16 CH keys: a CTA pass is 4 of them) in
//   a ring of kStages in shared memory, filled by 16-byte cp.async with
//   kStages - 1 stages in flight, so the loads wait on nothing the math
//   holds. The warps meet only at the end, to merge their (m, l, o).
// - The heads score 16 keys at once on the tensor cores: mma.sync m16n8k16
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
// - Scales: K3's are per (row, kv head): k's is folded into the scores, v's
//   applied once at the end. K4's are per page: a stage is 16 keys, one
//   page at the pool's page size; k's scale is folded into each score, and
//   each page's P V is taken from zero and added to the accumulator times
//   its v scale (a 16-key chunk across two pages, at a page size that 16
//   does not divide, takes one product a page).
// - The verify window (T positions, position j at length base + j + 1)
//   runs K4's walk once for all T positions: their G T heads are the A rows
//   of the products, in tiles of 16 (rows 8-15 live in the window's form
//   of the kernel; K4's G <= 8 heads fill rows 0-7 of its form), each
//   row masked at its own range, with its own (m, l) and rescales and its
//   position's q scale. Every row then does a K4 call's arithmetic at its
//   length: the same cells, stages and warps (absolute positions), and a
//   chunk without a valid key for a row leaves that row's state as it was
//   (p = 0 also while its max is -inf), so the extra stages and cells of
//   the other positions are no-ops for it; the merge adds the non-empty
//   cells in the same order. Each window position is bit-identical to K4
//   at its length, which keeps greedy speculation lossless.
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

// Tiles of the split walk at head dim HD: a warp stage holds CH chunks of
// 16 keys (its K rows, then its V rows, hd bytes each), a CTA pass is one
// stage a warp, a ring holds NS stages a warp. K3 takes CH 1, 2 or 4 by head
// dim and 3 stages (4-5 KB a stage); K4 and the verify window take one chunk
// a stage (a page at the pool's page size of 16) in a deeper ring
// (PagedTile), so that a stage never spans two pages' scales.
template <int HD, int CH_ = (HD >= 128 ? 1 : (HD >= 64 ? 2 : 4)), int NS_ = 3>
struct SplitTile {
  static constexpr int CH = CH_;
  static constexpr int KEYS = 16 * CH;                // keys a warp stage
  static constexpr int PASS = kWarps * KEYS;          // keys a CTA pass
  static constexpr int NCH = HD / 16;                 // 16-byte chunks a row
  static constexpr int NKC = HD / 16;                 // k-chunks of Q K^T
  static constexpr int NT = HD / 8;                   // n-tiles of P V
  static constexpr int NB4 = HD / 32;                 // P V blocks of 32 dims
  static constexpr int kStages = NS_;
  static constexpr int STAGE = 2 * KEYS * HD;         // bytes
  static constexpr int COPIES = (KEYS * NCH + 31) / 32;   // cp.async a lane a row set
  static_assert(HD % 16 == 0, "split tiles");
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

// The paged walk's tiles: 16-key stages, 8-16 KB of a warp's stages in flight.
template <int HD>
using PagedTile = SplitTile<HD, 1, HD >= 80 ? 4 : (HD >= 64 ? 6 : 8)>;

// Dynamic shared memory of K3's split body: the warps' rings, which the
// warps' merge (kWarps x G x HD accumulators, kWarps x G (m, l)) reuses.
template <int HD, int G>
__host__ __device__ constexpr size_t split_smem_bytes() {
  constexpr size_t ring = static_cast<size_t>(kWarps) *
                          SplitTile<HD>::kStages * SplitTile<HD>::STAGE;
  constexpr size_t merge = sizeof(float) * (kWarps * G * HD + 2 * kWarps * G);
  return ring > merge ? ring : merge;
}

// The paged split body's: the rings (reused by the merge of a tile's 16
// rows), each position's largest |q| (16 floats), then the CTA's share of
// the table row and its pages' k and v scales (n_ent entries, 12 bytes each).
template <int HD>
__host__ __device__ constexpr size_t paged_split_core_bytes() {
  constexpr size_t ring = static_cast<size_t>(kWarps) *
                          PagedTile<HD>::kStages * PagedTile<HD>::STAGE;
  constexpr size_t merge = sizeof(float) * (kWarps * 16 * HD + 2 * kWarps * 16);
  return ((ring > merge ? ring : merge) + 15) / 16 * 16;
}
template <int HD>
__host__ __device__ constexpr size_t paged_split_smem_bytes(int n_ent) {
  return paged_split_core_bytes<HD>() + sizeof(float) * 16 +
         12 * static_cast<size_t>(n_ent);
}

// Key pi(j, n) of a 16-key chunk is column n of S-tile j (j = 0, 1), so that
// a lane's scores of S-tiles 0 and 1 are its keys 4t .. 4t + 3, the keys of
// its A fragment of P (k indices 2t, 2t + 1, 2t + 8, 2t + 9) in P V.
__device__ __forceinline__ int split_pi(int j, int n) {
  return 4 * (n >> 1) + 2 * j + (n & 1);
}

// The B fragments of P V for block blk of 32 dims (n-tiles 4 blk .. 4 blk +
// 3) of chunk kc: this lane gives keys 4t .. 4t + 3 of column g of each
// n-tile; n-tile 4 blk + jj's column n is dim 32 blk + 4 n + jj, and its
// four rows' words, transposed by PRMT, hold them. vrow: the chunk's key row
// 4t in the stage's V tile.
template <class T>
__device__ __forceinline__ void v_frags(const unsigned char* vrow, int kc,
                                        int t, int g, int blk,
                                        uint32_t (&bf)[4][2]) {
  constexpr int HD = T::NCH * 16;
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
  bf[0][0] = codes_f16x2<0>(lo01); bf[0][1] = codes_f16x2<0>(lo23);
  bf[1][0] = codes_f16x2<2>(lo01); bf[1][1] = codes_f16x2<2>(lo23);
  bf[2][0] = codes_f16x2<0>(hi01); bf[2][1] = codes_f16x2<0>(hi23);
  bf[3][0] = codes_f16x2<2>(hi01); bf[3][1] = codes_f16x2<2>(hi23);
}

// hd 80's last 16 dims: n-tiles 8 and 9, column n is dim 64 + 2 n + jj, two
// bytes a row (chunk 4, not swizzled).
template <class T>
__device__ __forceinline__ void v_tail(const unsigned char* vrow, int g,
                                       uint32_t (&bf)[2][2]) {
  constexpr int HD = T::NCH * 16;
  uint32_t x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    x[e] = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(
               vrow + e * HD + 32 * T::NB4 + 2 * g)) ^
           0x8080u;
  const uint32_t lo01 = __byte_perm(x[0], x[1], 0x5140u);
  const uint32_t lo23 = __byte_perm(x[2], x[3], 0x5140u);
  bf[0][0] = codes_f16x2<0>(lo01); bf[0][1] = codes_f16x2<0>(lo23);
  bf[1][0] = codes_f16x2<2>(lo01); bf[1][1] = codes_f16x2<2>(lo23);
}

// One warp's walk over its stages of the CTA's keys, with the online
// softmax of the tile's row g and, with kR2, row g + 8 (m and l: this
// lane's share of a row's max, in log2 units, and sum; acc: the P V
// fragments, c0 and c1 row g, c2 and c3 row g + 8). The source policy Pol
// gives:
//   base, klo, khi: stage k holds keys [base + k KEYS, base + (k + 1) KEYS);
//     the CTA walks stages [klo, khi), warp w those with k = w (mod
//     kWarps), kStages - 1 in flight;
//   clo, chi: the keys copied into a stage (the rest stays stale, and is
//     masked for every row);
//   copy(s, kr, vr): key s's K/V rows (false: none, nothing copied);
//   scores(c0, t, sc, s): the scores s[h][e] of keys c0 + 4t + e (row
//     halves h) of the chunk at c0, from their S fragments sc, scaled to
//     log2 units, -inf where masked;
//   kScaleV: P V scaled by the v scale of each page (segment(lo, a1, hi,
//     vs): the keys [lo, hi) of one page from lo, and its scale; false: no
//     page there) before it is accumulated; else v's scale is the caller's.
// prologue() runs once the first stages are in flight, and fills qa: the A
// fragments of Q K^T (row g's logical dims 2t, 2t + 1, then row g + 8's,
// then row g's 2t + 8, 2t + 9, then row g + 8's; a k-chunk's logical dims
// are physical dims 16 c + 4 t + 0, 1 | 2, 3). A chunk with no valid key for
// a row leaves that row's m, l and acc as they were, bit for bit.
template <class T, bool kR2, class Pol, class Prologue>
__device__ __forceinline__ void split_walk(const Pol& pol, unsigned char* ring,
                                           Prologue prologue,
                                           uint32_t (&qa)[T::NKC][4],
                                           float (&m)[2], float (&l)[2],
                                           float (&acc)[T::NT][4]) {
  constexpr int HD = T::NCH * 16, KEYS = T::KEYS, NS = T::kStages;
  constexpr int NCH = T::NCH, NH = kR2 ? 2 : 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;    // a fragment's row and column pair
  // this warp's first stage: the first k >= klo with k = warp (mod kWarps)
  const int kf = pol.klo + ((warp - pol.klo) % kWarps + kWarps) % kWarps;
  const int nst = pol.khi > kf ? (pol.khi - kf + kWarps - 1) / kWarps : 0;

  unsigned char* wring = ring + warp * NS * T::STAGE;
  // stage i of this warp: stage kf + kWarps i, into slot i % NS; rows
  // outside [clo, chi) are not copied (their scores are masked, and P V
  // multiplies their stale codes by p = 0)
  auto issue = [&](int i) {
    const int s0 = pol.base + (kf + kWarps * i) * KEYS;
    unsigned char* ks = wring + (i % NS) * T::STAGE;
    unsigned char* vs = ks + KEYS * HD;
#pragma unroll
    for (int u = 0; u < T::COPIES; ++u) {
      const int idx = lane + 32 * u;
      const int r = idx / NCH, c = idx % NCH;
      const int s = s0 + r;
      const int8_t* kr;
      const int8_t* vr;
      if (r < KEYS && s >= pol.clo && s < pol.chi && pol.copy(s, kr, vr)) {
        cp_async16(ks + r * HD + 16 * (c ^ T::swk(r)), kr + 16 * c);
        cp_async16(vs + r * HD + 16 * (c ^ T::swv(r)), vr + 16 * c);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < nst) issue(i);
    cp_async_commit();
  }
  prologue();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < T::NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int i = 0; i < nst; ++i) {
    cp_async_wait<NS - 2>();
    __syncwarp();
    const unsigned char* ks = wring + (i % NS) * T::STAGE;
    const unsigned char* vs = ks + KEYS * HD;
    const int s0 = pol.base + (kf + kWarps * i) * KEYS;
#pragma unroll
    for (int kc = 0; kc < T::CH; ++kc) {
      const int c0 = s0 + 16 * kc;
      if (c0 >= pol.chi) break;                 // warp-uniform
      // S = Q K^T over the chunk's 16 keys: S-tile j column n is key
      // 16 kc + pi(j, n); this lane gives column g, and gets rows g's and
      // g + 8's scores of keys 4t .. 4t + 3 (sc[j][0..1] and sc[j][2..3])
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int c = 0; c < T::NKC; ++c) {
        const uint32_t a[4] = {qa[c][0], kR2 ? qa[c][1] : 0u, qa[c][2],
                               kR2 ? qa[c][3] : 0u};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int r = 16 * kc + split_pi(j, g);
          const uint32_t x = *reinterpret_cast<const uint32_t*>(
                                 ks + r * HD + 16 * (c ^ T::swk(r)) + 4 * t) ^
                             0x80808080u;
          mma_f16_16816(sc[j], a, codes_f16x2<0>(x), codes_f16x2<2>(x));
        }
      }
      float s[2][4];
      pol.scores(c0, t, sc, s);
      float p[2][4];
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        float mx = fmaxf(fmaxf(s[h][0], s[h][1]), fmaxf(s[h][2], s[h][3]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (mx > m[h]) {                // mx is finite: the row has a key here
          const float corr = exp2f(m[h] - mx);  // 0 while m is -inf
          l[h] *= corr;
#pragma unroll
          for (int n = 0; n < T::NT; ++n) {
            acc[n][2 * h] *= corr;
            acc[n][2 * h + 1] *= corr;
          }
          m[h] = mx;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a masked key gives 0, also while m is -inf (no key yet)
          p[h][e] = s[h][e] == -INFINITY ? 0.f : exp2f(s[h][e] - m[h]);
          l[h] += p[h][e];
        }
      }
      const unsigned char* vrow = vs + (16 * kc + 4 * t) * HD;
      if constexpr (!Pol::kScaleV) {
        const uint32_t pa[4] = {f16x2_pack(p[0][0], p[0][1]),
                                kR2 ? f16x2_pack(p[1][0], p[1][1]) : 0u,
                                f16x2_pack(p[0][2], p[0][3]),
                                kR2 ? f16x2_pack(p[1][2], p[1][3]) : 0u};
#pragma unroll
        for (int blk = 0; blk < T::NB4; ++blk) {
          uint32_t bf[4][2];
          v_frags<T>(vrow, kc, t, g, blk, bf);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            mma_f16_16816(acc[4 * blk + jj], pa, bf[jj][0], bf[jj][1]);
        }
        if constexpr (HD % 32 != 0) {
          uint32_t bf[2][2];
          v_tail<T>(vrow, g, bf);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
            mma_f16_16816(acc[4 * T::NB4 + jj], pa, bf[jj][0], bf[jj][1]);
        }
      } else {
        // P V of each page's keys of the chunk (one page at a page size
        // that 16 divides), from 0 and scaled by its v scale into acc
        const int a0 = max(c0, pol.clo), a1 = min(c0 + 16, pol.chi);
        for (int lo = a0; lo < a1;) {   // warp-uniform
          int hi;
          float vsc;
          if (pol.segment(lo, a1, hi, vsc)) {
            // a page's keys (p is 0 outside [a0, a1): one page, p itself)
            const bool whole = lo == a0 && hi == a1;
            float q4[2][4];
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int key = c0 + 4 * t + e;
                q4[h][e] = whole || (key >= lo && key < hi) ? p[h][e] : 0.f;
              }
            const uint32_t pa[4] = {f16x2_pack(q4[0][0], q4[0][1]),
                                    kR2 ? f16x2_pack(q4[1][0], q4[1][1]) : 0u,
                                    f16x2_pack(q4[0][2], q4[0][3]),
                                    kR2 ? f16x2_pack(q4[1][2], q4[1][3]) : 0u};
            auto add = [&](float (&a)[4], uint32_t b0, uint32_t b1) {
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              mma_f16_16816(d, pa, b0, b1);
#pragma unroll
              for (int e = 0; e < 2 * NH; ++e) a[e] = fmaf(d[e], vsc, a[e]);
            };
#pragma unroll
            for (int blk = 0; blk < T::NB4; ++blk) {
              uint32_t bf[4][2];
              v_frags<T>(vrow, kc, t, g, blk, bf);
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) add(acc[4 * blk + jj], bf[jj][0], bf[jj][1]);
            }
            if constexpr (HD % 32 != 0) {
              uint32_t bf[2][2];
              v_tail<T>(vrow, g, bf);
#pragma unroll
              for (int jj = 0; jj < 2; ++jj) add(acc[4 * T::NB4 + jj], bf[jj][0], bf[jj][1]);
            }
          }
          lo = hi;
        }
      }
    }
    __syncwarp();                     // the slot is read: it may be refilled
    if (i + NS - 1 < nst) issue(i + NS - 1);
    cp_async_commit();
  }
  cp_async_wait<0>();
}

// The warps' merge of the walk's state, in warp order, for NR rows of the
// tile (rows g and, with kR2, g + 8 below NR): each row's accumulator (the
// dims of its fragments), max and sum to shared memory (the rings, all
// read), then one thread an output element: store(i, o, mx, lsum), i = row
// * HD + dim, o the warps' accumulators weighted to the merged max mx, lsum
// the weighted sum. A fixed order: the same bits on every call.
template <class T, bool kR2, int NR, class Store>
__device__ __forceinline__ void split_merge_warps(unsigned char* smem,
                                                  const float (&m)[2],
                                                  float (&l)[2],
                                                  const float (&acc)[T::NT][4],
                                                  Store store) {
  constexpr int HD = T::NCH * 16, NH = kR2 ? 2 : 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  __syncthreads();                    // every ring is read
  float* wacc = reinterpret_cast<float*>(smem);
  float* wm = wacc + kWarps * NR * HD;
  float* wl = wm + kWarps * NR;
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    const int gr = g + 8 * h;
    if (gr < NR) {
      float* row = wacc + (warp * NR + gr) * HD;
#pragma unroll
      for (int blk = 0; blk < T::NB4; ++blk)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          row[32 * blk + 8 * t + jj] = acc[4 * blk + jj][2 * h];
          row[32 * blk + 8 * t + 4 + jj] = acc[4 * blk + jj][2 * h + 1];
        }
      if constexpr (HD % 32 != 0) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          row[32 * T::NB4 + 4 * t + jj] = acc[4 * T::NB4 + jj][2 * h];
          row[32 * T::NB4 + 4 * t + 2 + jj] = acc[4 * T::NB4 + jj][2 * h + 1];
        }
      }
      if (t == 0) {
        wm[warp * NR + gr] = m[h];
        wl[warp * NR + gr] = l[h];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NR * HD; i += kThreads) {
    const int gg = i / HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * NR + gg]);
    float o = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = wm[w * NR + gg];
      const float wt = mw == -INFINITY ? 0.f : exp2f(mw - mx);
      o = fmaf(wacc[w * NR * HD + i], wt, o);
      lsum = fmaf(wl[w * NR + gg], wt, lsum);
    }
    store(i, o, mx, lsum);
  }
}

// K3's source in the walk: the row's own range [s_lo, s_hi), CTA `split`
// taking the split-th share of it rounded up to whole CTA passes (so rows
// shorter than the plan balance too); one k scale for the (row, kv head),
// folded into the scores, and one v scale, applied after the walk.
template <int HD>
struct DenseSplit {
  using T = SplitTile<HD>;
  static constexpr bool kScaleV = false;
  const Dense& src;
  int base, klo, khi, clo, chi;
  float kscale = 0.f;                   // set by the prologue: q's scale undone

  __device__ __forceinline__ DenseSplit(const Dense& s, int split, int nsplit)
      : src(s) {
    const int span = src.s_hi - src.s_lo;
    const int per = (span + nsplit - 1) / nsplit;
    const int share = (per + T::PASS - 1) / T::PASS * T::PASS;
    clo = min(src.s_lo + split * share, src.s_hi);
    chi = min(clo + share, src.s_hi);
    base = clo;
    klo = 0;
    khi = (chi - clo + T::KEYS - 1) / T::KEYS;
  }
  __device__ __forceinline__ bool copy(int s, const int8_t*& kr,
                                       const int8_t*& vr) const {
    kr = src.kbase + s * src.sks;
    vr = src.vbase + s * src.svs;
    return true;
  }
  __device__ __forceinline__ void scores(int c0, int t, const float (&sc)[2][4],
                                         float (&s)[2][4]) const {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[0][e] = sc[e >> 1][e & 1] * kscale;
      if (c0 + 4 * t + e >= chi) s[0][e] = -INFINITY;
    }
  }
};

// q's scale into f16: a power of two that puts qmax, the largest |q| of a
// position's G heads, in [2^14, 2^15) (exact; f16 holds every q), as qs;
// returns 1 / qs, by which the scores are scaled back.
__device__ __forceinline__ float q_scale(float qmax, float& qs) {
  // biased exponent E of qmax: scale 2^(141 - E), clamped to normal floats
  const int E = min(max(static_cast<int>(__float_as_uint(qmax) >> 23), 15), 254);
  qs = __uint_as_float(static_cast<uint32_t>(268 - E) << 23);
  return __uint_as_float(static_cast<uint32_t>(E - 14) << 23);
}

// K3's split body: CTA blockIdx.x = pair * nsplit + split, pair = b * KV +
// h. nsplit 1: the output (bf16 out, or with lse non-null f32 out_f32 and
// lse) is written here. nsplit > 1: part_o (pairs * nsplit, G, HD) f32 gets
// the CTA's accumulator times v's scale, relative to its max, and part_ml
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
  unsigned char* smem = int8_decode_smem;
  const int pair = blockIdx.x / nsplit, split = blockIdx.x % nsplit;
  const int b = pair / KV, h = pair % KV;
  const Dense src(kq, vq, k_scale, v_scale, lengths, b, h, KV, S, skb, skh,
                  sks, svb, svh, svs, window, sm_scale, key_offset);
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  DenseSplit<HD> pol(src, split, nsplit);

  // q as the A fragments of Q K^T: row g a head (rows >= G and 8-15 zero);
  // the largest |q| of the group from the fragments
  uint32_t qa[T::NKC][4];
  auto prologue = [&] {
    float qf[T::NKC][4];
    float qmax = 0.f;
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
    float qs;
    qmax = q_scale(qmax, qs);
#pragma unroll
    for (int c = 0; c < T::NKC; ++c) {
      qa[c][0] = f16x2_pack(qf[c][0] * qs, qf[c][1] * qs);
      qa[c][2] = f16x2_pack(qf[c][2] * qs, qf[c][3] * qs);
      qa[c][1] = qa[c][3] = 0u;
    }
    pol.kscale = src.kscale * qmax;     // log2 units, q's scale undone
  };
  float m[2], l[2], acc[T::NT][4];
  split_walk<T, false>(pol, smem, prologue, qa, m, l, acc);

  const int64_t base = static_cast<int64_t>(pair) * G * HD;
  const int64_t piece = static_cast<int64_t>(pair) * nsplit + split;
  split_merge_warps<T, false, G>(smem, m, l, acc,
                                 [&](int i, float o, float mx, float lsum) {
    const int gg = i / HD;
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
  });
}

// The paged source in the walk (K4 and the verify window): the keys of one
// cell [c_lo, c_lo + C) of the grid of absolute positions, stages at
// absolute multiples of 16 (so a stage's warp is fixed by its position),
// the union of the tile's rows' ranges copied; key s through the CTA's
// share of the table row (entries e0 ..), its page's k scale folded into
// each score and its v scale into each page's P V. A table entry outside
// [0, P) is never dereferenced: its keys are masked. Each row h (g, g + 8)
// is masked at its own range [rlo, rhi), and scores in its position's q
// scale (qmx).
struct PagedSplit {
  static constexpr bool kScaleV = true;
  const Paged& src;
  const int* tab;                       // the share: entry e0 + i at i
  const float* ksc;
  const float* vsc;
  int e0;
  bool page16 = false;                  // ps a multiple of 16: a chunk, one page
  int base = 0, klo = 0, khi = 0, clo = 0, chi = 0;
  int rlo[2] = {0, 0}, rhi[2] = {0, 0};
  float qmx[2] = {1.f, 1.f};

  __device__ __forceinline__ bool copy(int s, const int8_t*& kr,
                                       const int8_t*& vr) const {
    const int j = src.entry(s);
    const int page = tab[j - e0];
    if (page < 0) return false;
    src.at(page, s - j * src.ps, kr, vr);
    return true;
  }
  // (every chunk the walk takes meets [clo, chi); at a page size that 16
  // divides its 16 keys lie on one page, looked up once)
  __device__ __forceinline__ void scores(int c0, int t, const float (&sc)[2][4],
                                         float (&s)[2][4]) const {
    if (page16) {
      const int j = src.entry(max(c0, clo)) - e0;
      const bool ok = tab[j] >= 0;
      const float ks = ksc[j];
      const float kq[2] = {ks * qmx[0], ks * qmx[1]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = c0 + 4 * t + e;
#pragma unroll
        for (int h = 0; h < 2; ++h)
          s[h][e] = ok && key >= rlo[h] && key < rhi[h]
                        ? sc[e >> 1][2 * h + (e & 1)] * kq[h]
                        : -INFINITY;
      }
      return;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = c0 + 4 * t + e;
      const bool in = key >= clo && key < chi;
      const int j = in ? src.entry(key) - e0 : 0;
      const bool ok = in && tab[j] >= 0;
      const float ks = ksc[j];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        s[h][e] = ok && key >= rlo[h] && key < rhi[h]
                      ? sc[e >> 1][2 * h + (e & 1)] * (ks * qmx[h])
                      : -INFINITY;
    }
  }
  __device__ __forceinline__ bool segment(int lo, int a1, int& hi,
                                          float& vs) const {
    const int j = src.entry(lo);
    hi = min(a1, (j + 1) * src.ps);
    vs = vsc[j - e0];
    return tab[j - e0] >= 0;
  }
};

// K4 and the verify window on the split walk. Row R of a (row b, kv head h)
// pair is head R % G of window position j = R / G (T positions; K4: T 1),
// which attends [max(0, L - window), min(L, MP ps)) with L = lengths[b] +
// lead + j (K4: lead 0; the verify window: 1). The T G rows go in tiles of
// 16, the A rows of the products (kR2, the verify window: rows 8-15 live;
// without it, K4, a tile holds at most 8 rows, its G heads). CTA blockIdx.x = (pair * nsplit +
// split) * ntile + tile takes cell c0 + split of the grid of `cell` keys
// (c0: with a window shorter than the table, the cell of position 0's first
// key, else 0) and tile `tile`'s rows: every row does the arithmetic of a
// K4 call at its length (the same cells, stages, warps, per-row statistics
// and its position's q scale; stages outside a row's range leave it as it
// was), so each window position is bit-identical to K4 at its length.
// nsplit 1: the output is written here; else part_o (pieces, 16, HD) and
// part_ml (pieces, 16, 2), piece = blockIdx.x, and paged_merge_kernel
// writes it. n_ent: the room for the cell's share of the table row
// (paged_split_smem_bytes), (cell - 1) / ps + 2 entries.
#define PAGED_SPLIT_PARAMS                                                   \
  const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ kp,         \
      const int8_t* __restrict__ vp, const float* __restrict__ k_scale,       \
      const float* __restrict__ v_scale,                                      \
      const int32_t* __restrict__ page_table,                                 \
      const int32_t* __restrict__ lengths, __nv_bfloat16* __restrict__ out,   \
      int KV, int P, int ps, int ps_shift, int MP, int64_t skp, int64_t sks,  \
      int64_t skh, int64_t svp, int64_t svs, int64_t svh, int window,         \
      float sm_scale, int lead, int T, int64_t qsb, int64_t qst, int64_t osb, \
      int64_t ost, int cell, int nsplit, int ntile, int n_ent,                \
      float* __restrict__ part_o, float* __restrict__ part_ml
#define PAGED_SPLIT_ARGS                                                     \
  q, kp, vp, k_scale, v_scale, page_table, lengths, out, KV, P, ps, ps_shift, \
      MP, skp, sks, skh, svp, svs, svh, window, sm_scale, lead, T, qsb, qst,  \
      osb, ost, cell, nsplit, ntile, n_ent, part_o, part_ml

template <int HD, int G, bool kR2>
__device__ __forceinline__ void paged_split_body(PAGED_SPLIT_PARAMS) {
  using TT = PagedTile<HD>;
  constexpr int NR = kR2 ? 16 : 8, NH = kR2 ? 2 : 1;
  unsigned char* smem = int8_decode_smem;
  float* qm = reinterpret_cast<float*>(smem + paged_split_core_bytes<HD>());
  int* tab = reinterpret_cast<int*>(qm + 16);
  float* ksc = reinterpret_cast<float*>(tab + n_ent);
  float* vsc = ksc + n_ent;
  const int tile = blockIdx.x % ntile;
  const int split = blockIdx.x / ntile % nsplit;
  const int pair = blockIdx.x / ntile / nsplit;
  const int b = pair / KV, h = pair % KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int S = MP * ps;
  // this tile's rows [r0, r1) and positions j0 .. j1
  const int r0 = 16 * tile, r1 = min(r0 + NR, T * G);
  const int j0 = r0 / G, j1 = (r1 - 1) / G;
  const __nv_bfloat16* qpair = q + b * qsb + static_cast<int64_t>(h) * G * HD;

  // q first (it needs nothing loaded): rows g and g + 8's fragment words,
  // and each position's largest |q| over its G heads, a warp a position
  uint2 qw[2][TT::NKC];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
    const int R = r0 + g + 8 * hh;
#pragma unroll
    for (int c = 0; c < TT::NKC; ++c) {
      qw[hh][c] = {0u, 0u};
      if (R < r1)
        qw[hh][c] = *reinterpret_cast<const uint2*>(
            qpair + (R / G) * qst + (R % G) * HD + 16 * c + 4 * t);
    }
  }
  for (int j = j0 + warp; j <= j1; j += kWarps) {
    const uint32_t* pw = reinterpret_cast<const uint32_t*>(qpair + j * qst);
    constexpr int NW = G * HD / 2, NL = (NW + 31) / 32;   // words, a lane's
    uint32_t w[NL];
#pragma unroll
    for (int k = 0; k < NL; ++k)        // every load in flight at once
      w[k] = lane + 32 * k < NW ? pw[lane + 32 * k] : 0u;
    float mx = 0.f;
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      mx = fmaxf(mx, fabsf(__uint_as_float(w[k] << 16)));
      mx = fmaxf(mx, fabsf(__uint_as_float(w[k] & 0xffff0000u)));
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) qm[j - j0] = mx;
  }

  const int len0 = __ldg(lengths + b) + lead;    // position 0's length
  auto hi_of = [&](int j) { return min(max(len0 + j, 0), S); };
  auto lo_of = [&](int j) {
    return window > 0 ? min(max(0, len0 + j - window), hi_of(j)) : 0;
  };
  // this CTA's cell, and the cell's share of the table row (entries
  // outside [0, P) as -1); without a window shorter than the table the
  // cell needs no length
  const int c_lo = ((window > 0 && window < S ? lo_of(0) / cell : 0) + split) * cell;
  const Paged src(kp, vp, h, P, ps, ps_shift, skp, sks, skh, svp, svs, svh);
  const int e0 = src.entry(min(c_lo, S));
  const int ne = c_lo < S ? src.entry(min(c_lo + cell, S) - 1) - e0 + 1 : 0;
  const int32_t* prow = page_table + static_cast<int64_t>(b) * MP + e0;
  for (int i = threadIdx.x; i < ne; i += kThreads) {
    const int page = __ldg(prow + i);
    tab[i] = page >= 0 && page < P ? page : -1;
  }
  PagedSplit pol{src, tab, ksc, vsc, e0, ps % 16 == 0};
  pol.clo = max(c_lo, lo_of(j0));
  pol.chi = max(pol.clo, min(c_lo + cell, hi_of(j1)));
  pol.base = c_lo;
  pol.klo = (pol.clo - c_lo) / 16;
  pol.khi = pol.chi > pol.clo ? (pol.chi - c_lo + 15) / 16 : pol.klo;
  __syncthreads();                      // the share and qm

  uint32_t qa[TT::NKC][4];
  auto prologue = [&] {
    // the share's pages' scales (k's times sm_scale log2(e)), beside the
    // first stages' loads
    for (int i = threadIdx.x; i < ne; i += kThreads) {
      const int page = tab[i];
      float ks = 0.f, vs = 0.f;
      if (page >= 0) {
        ks = __ldg(k_scale + page * KV + h) * sm_scale * kLog2e;
        vs = __ldg(v_scale + page * KV + h);
      }
      ksc[i] = ks;
      vsc[i] = vs;
    }
    // rows g and g + 8: their range, q in its position's scale (zero, and
    // masked everywhere, past the last row)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int R = r0 + g + 8 * hh;
      float qs = 0.f;
      if (hh < NH && R < r1) {
        const int j = R / G;
        pol.rlo[hh] = lo_of(j);
        pol.rhi[hh] = hi_of(j);
        pol.qmx[hh] = q_scale(qm[j - j0], qs);
      }
#pragma unroll
      for (int c = 0; c < TT::NKC; ++c) {
        const uint2 w = hh < NH ? qw[hh][c] : uint2{0u, 0u};
        qa[c][hh] = f16x2_pack(__uint_as_float(w.x << 16) * qs,
                               __uint_as_float(w.x & 0xffff0000u) * qs);
        qa[c][2 + hh] = f16x2_pack(__uint_as_float(w.y << 16) * qs,
                                   __uint_as_float(w.y & 0xffff0000u) * qs);
      }
    }
    __syncthreads();                    // the scales
  };
  float m[2], l[2], acc[TT::NT][4];
  split_walk<TT, kR2>(pol, smem, prologue, qa, m, l, acc);

  const int64_t piece = blockIdx.x;
  split_merge_warps<TT, kR2, NR>(smem, m, l, acc,
                                 [&](int i, float o, float mx, float lsum) {
    const int r = i / HD, d = i % HD;
    const int R = r0 + r;
    if (R >= r1) return;
    if (nsplit > 1) {
      part_o[(piece * 16 + r) * HD + d] = o;
      if (d == 0) {
        part_ml[(piece * 16 + r) * 2] = mx;
        part_ml[(piece * 16 + r) * 2 + 1] = lsum;
      }
    } else {
      out[b * osb + (R / G) * ost + (static_cast<int64_t>(h) * G + R % G) * HD + d] =
          __float2bfloat16(mx == -INFINITY ? 0.f : o / lsum);
    }
  });
}

// The kernels of the two forms: K4's (rows 0-7) and the verify window's
// (16 rows a tile), one body. K4's is bounded to one block an SM: without
// it ptxas held its hd 32 instantiations at 64-72 registers and spilled
// 4-16 bytes, as it did K5's; bounded so, the verify window's form took
// 142 registers at hd 80 against 126, three CTAs an SM instead of four
// (70.1 against 55.4 us at h2o's window on an H100 at 700 W,
// tools/k3_plan.py).
template <int HD, int G>
__global__ void __launch_bounds__(kThreads, 1)
paged_split_kernel(PAGED_SPLIT_PARAMS) {
  paged_split_body<HD, G, false>(PAGED_SPLIT_ARGS);
}
template <int HD, int G>
__global__ void __launch_bounds__(kThreads)
paged_verify_split_kernel(PAGED_SPLIT_PARAMS) {
  paged_split_body<HD, G, true>(PAGED_SPLIT_ARGS);
}
#undef PAGED_SPLIT_PARAMS
#undef PAGED_SPLIT_ARGS

// The splits' merge of one output row from the partials of its nsplit
// pieces first, first + stride, .. (rows rows a piece, this one row `row`):
// the max, then the weighted sums in split order (a piece without a valid
// key weighs 0); returns o, and mx and lsum. The loops are unrolled so that
// a batch of splits' loads is in flight at once (the sums keep split order:
// unrolling reorders loads, not additions).
__device__ __forceinline__ float merge_splits(const float* __restrict__ part_o,
                                              const float* __restrict__ part_ml,
                                              int64_t first, int stride,
                                              int rows, int row, int HD,
                                              int nsplit, int d, float& mx,
                                              float& lsum) {
  mx = -INFINITY;
#pragma unroll 8
  for (int i = 0; i < nsplit; ++i)
    mx = fmaxf(mx, __ldg(part_ml + ((first + static_cast<int64_t>(i) * stride) * rows + row) * 2));
  float o = 0.f;
  lsum = 0.f;
#pragma unroll 8
  for (int i = 0; i < nsplit; ++i) {
    const int64_t at = (first + static_cast<int64_t>(i) * stride) * rows + row;
    const float mi = __ldg(part_ml + at * 2);
    const float wt = mi == -INFINITY ? 0.f : exp2f(mi - mx);
    o = fmaf(__ldg(part_o + at * HD + d), wt, o);
    lsum = fmaf(__ldg(part_ml + at * 2 + 1), wt, lsum);
  }
  return o;
}

// K3's merge: one CTA of hd threads a (pair, head g), blockIdx.x = pair * G
// + g; the output as the split body writes it with one split. Static: each
// object of a library built in parts holds its own copy.
static __global__ void __launch_bounds__(128)
merge_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
             __nv_bfloat16* __restrict__ out, float* __restrict__ out_f32,
             float* __restrict__ lse, int G, int HD, int nsplit) {
  const int pair = blockIdx.x / G, g = blockIdx.x % G;
  const int d = threadIdx.x;
  float mx, lsum;
  const float o = merge_splits(part_o, part_ml, static_cast<int64_t>(pair) * nsplit,
                               1, G, g, HD, nsplit, d, mx, lsum);
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

// K4's and the verify window's merge: one CTA of hd threads an output row,
// blockIdx.x = pair * T G + R (row R of the pair: head R % G of window
// position R / G), its pieces those of its tile in split order.
static __global__ void __launch_bounds__(128)
paged_merge_kernel(const float* __restrict__ part_o,
                   const float* __restrict__ part_ml,
                   __nv_bfloat16* __restrict__ out, int KV, int G, int HD,
                   int T, int nsplit, int ntile, int64_t osb, int64_t ost) {
  const int rows = T * G;
  const int pair = blockIdx.x / rows, R = blockIdx.x % rows;
  const int b = pair / KV, h = pair % KV, j = R / G, gg = R % G;
  const int d = threadIdx.x;
  float mx, lsum;
  const float o = merge_splits(part_o, part_ml,
                               static_cast<int64_t>(pair) * nsplit * ntile + R / 16,
                               ntile, 16, R % 16, HD, nsplit, d, mx, lsum);
  out[b * osb + j * ost + (static_cast<int64_t>(h) * G + gg) * HD + d] =
      __float2bfloat16(mx == -INFINITY ? 0.f : o / lsum);
}

#ifdef __CUDACC__
// Launch K4's or the verify window's split body: q (B, T, KV G, HD) bf16
// through the element strides qsb, qst (K4: T 1); out alike through osb,
// ost; window position j of row b at length lengths[b] + lead + j; cells of
// `cell` keys, nsplit a pair; for nsplit > 1, work holds B KV nsplit ntile
// 16 (HD + 2) f32 of partials and the merge follows. kR2: rows 8-15 of a
// tile live (the verify window; K4's G <= 8 heads fill rows 0-7).
// Static: each library (K4's, the verify window's) and each of its objects
// keeps its own copy, and its own record of the opt-in below (a function-
// local static of a function with external linkage is one object across
// every loaded library, so one library's opt-in would stand for the
// other's kernel).
template <int HD, int G, bool kR2>
static cudaError_t paged_split_launch(const __nv_bfloat16* q, const int8_t* kp,
                                      const int8_t* vp, const float* k_scale,
                                      const float* v_scale,
                                      const int32_t* page_table,
                                      const int32_t* lengths,
                                      __nv_bfloat16* out, int B, int KV, int P,
                                      int ps, int ps_shift, int MP,
                                      int64_t skp, int64_t sks, int64_t skh,
                                      int64_t svp, int64_t svs, int64_t svh,
                                      int window, float sm_scale, int lead,
                                      int T, int64_t qsb, int64_t qst,
                                      int64_t osb, int64_t ost, int cell,
                                      int nsplit, float* work,
                                      cudaStream_t stream) {
  if (cell <= 0 || cell % 64 != 0 || nsplit < 1 || (nsplit > 1 && work == nullptr) ||
      (!kR2 && T * G > 8))
    return cudaErrorInvalidValue;
  const int ntile = (T * G + 15) / 16;
  const int n_ent = (cell - 1) / ps + 2;
  const size_t smem = paged_split_smem_bytes<HD>(n_ent);
  // the kernel's shared memory opt-in, raised to the largest asked so far
  auto* kernel = [] {                   // only the form asked for is built
    if constexpr (kR2) return paged_verify_split_kernel<HD, G>;
    else return paged_split_kernel<HD, G>;
  }();
  static size_t allowed = 0;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  float* part_o = work;
  float* part_ml = nsplit > 1
      ? work + static_cast<int64_t>(B) * KV * nsplit * ntile * 16 * HD
      : nullptr;
  kernel<<<B * KV * nsplit * ntile, kThreads, smem, stream>>>(
      q, kp, vp, k_scale, v_scale, page_table, lengths, out, KV, P, ps,
      ps_shift, MP, skp, sks, skh, svp, svs, svh, window, sm_scale, lead, T,
      qsb, qst, osb, ost, cell, nsplit, ntile, n_ent, part_o, part_ml);
  if (nsplit > 1) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    paged_merge_kernel<<<B * KV * T * G, HD, 0, stream>>>(
        part_o, part_ml, out, KV, G, HD, T, nsplit, ntile, osb, ost);
  }
  return cudaGetLastError();
}
#endif

}  // namespace int8_decode

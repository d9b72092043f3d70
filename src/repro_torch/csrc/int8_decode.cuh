// One kernel body for the int8 flash-decode kernels, for Hopper (sm_90a):
// the dense pool's (decode_attention_int8.cu, K3), the paged pool's
// (paged_decode_attention.cu, K4) and the paged pool's speculative verify
// window (paged_verify_attention.cu: K4 over T window positions). They
// differ only in how position s of row b finds its K/V rows and its two
// scales, which a source policy supplies: Dense reads row b of a (B, KV, S,
// hd) cache with the (b, h) scales; Paged looks position s up in row b of
// the page table, reads the arena (P, ps, KV, hd) and takes the (page, h)
// scales.
//
// Function (both): for batch row b and kv head h, the G = H / KV query heads
// of the group attend the int8 keys/values of positions [max(0, len -
// window), min(len, S)), dequantized in registers; softmax in f32; output
// bf16. A row with no valid position gives zeros. A page-table entry outside
// [0, P) is never dereferenced: its positions count as masked.
//
// K3 also decodes a piece of a dense cache split over its sequence (one
// piece a rank): key_offset o is the global position of local key 0, and
// the CTA attends the global range [max(0, len - window), len) where it
// meets [o, o + S). With the log-sum-exp epilogue (attend's kLse) the
// output is f32, normalised over the keys the piece saw, and each head's
// natural log-sum-exp of its scaled scores goes beside it; a piece with no
// valid key gives o = 0 and lse = -inf (K5's conventions), so the pieces
// merge by one lse-weighted sum. The epilogue is a template argument: K4,
// the verify window and K3 without it compile to the code they had.
//
// What bounds it on this card: at the serving shapes, not the bytes (a
// few MB, about a microsecond at 3.35 TB/s) but the chain of dependent
// memory round trips (the length and the page table, then the K/V rows)
// and the instructions issued after the last byte lands: every int8 code
// costs a conversion and an FMA, and each warp's softmax bookkeeping and
// merge are fixed costs. (A copy-only build of this kernel, the same loads
// and no math, takes about 3 us at the stablelm shape against a 1 us byte
// bound.) The design keeps the chain to two round trips, puts every K/V
// load of a CTA in flight at once, and keeps the per-warp work small:
//
// - One CTA of kWarps (4) warps per (row, kv head). The head dim is split
//   over lanes: a group of LPP neighbouring lanes holds one position, each
//   lane DPL dims (16 bytes of K and of V at G = 1; fewer for larger
//   groups, whose accumulators would not fit), so a warp covers 32 / LPP
//   positions in a pass and the CTA kWarps times that. LPP is hd / DPL
//   rounded up to a power of two, so that a group's lanes divide the warp
//   and its dot reduces by xor-shuffles: at hd 80 the groups are 5, 10 or
//   20 live lanes in 8, 16 or 32, the rest idle (they load nothing, add
//   zeros to the dot and store no accumulator). The other layout, 64 dims
//   in power-of-two groups plus a second pass over dims 64-79, keeps every
//   lane busy but doubles the shuffles and the merge's code paths; hd 80
//   (h2o-danube) is one model, so the simple form is the one kept.
// - Passes are taken in rounds of D (kDepth: 6 at G = 1, 192 positions at
//   hd 64), held in registers: a round's loads are all issued at once, and
//   round r + 1 is issued into a second register buffer before round r is
//   consumed, so the serving shapes (one round) cost one round trip and a
//   longer stream keeps a round in flight.
// - int8 codes become f32 without the conversion unit (I2F issues at a
//   quarter of the FMA rate): the byte, offset by 128, is placed in the
//   mantissa of 2^23 by one PRMT and 2^23 + 128 is subtracted, exactly.
// - The dot of a position is reduced over its lane group by log2(LPP)
//   xor-shuffles (several partial sums before it). The softmax runs per
//   round in two phases: the round's scores, one warp max (m, in the log2
//   domain, uniform over the warp, so a rescale is a warp-uniform branch
//   taken at most once a round), then P.V, each lane accumulating its own
//   DPL dims straight from its V registers.
// - The merge: each lane group's accumulator and each warp's (m, l) go to
//   shared memory, and every thread sums a share of them for one output
//   element; the shares meet by xor-shuffles. A fixed order: the same bits
//   on every call.
//
// The verify window (paged_verify_kernel), where K4's plan picks this body,
// runs it once per window position j, at length base_len + j + 1, with
// K4's lane layout, passes,
// rounds and merge for that length, so each position's output is
// bit-identical to a K4 call at its length: a verify step computes what T
// sequential decode steps compute. The positions run at once, one CTA
// each, and the body runs lean there (one register buffer; see attend) so
// that six CTAs share an SM.
//
// K3, K4 and the verify window have a second body for few (row, kv head)
// pairs and long spans, their keys split over CTAs: int8_split_decode.cuh.
// It uses this file's Dense and Paged source policies and nothing of
// attend.
//
// Built with -DINT8_DECODE_COPY_ONLY, the kernels only load what they would
// read (the same prologue and the same loads) and write a token output: the
// floor of this design at a shape (tools/kernel_ab.py --floor).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace int8_decode {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRoundBytes = 96;           // K bytes a lane holds in a round
constexpr float kLog2e = 1.4426950408889634f;

// Layout of the head dim over lanes for a group of G heads: DPL dims a lane
// (its K and V bytes of a position), LPP lanes a position (the LPA lanes
// that hold its HD dims, rounded up to a power of two), kDepth passes of
// K/V held in registers (a round), NP partial sums of the dot.
template <int HD, int G>
struct Tile {
  static constexpr int DPL = G <= 1 ? 16 : (G == 2 ? 8 : 4);
  static constexpr int W = DPL / 4;                 // 32-bit words a row
  static constexpr int LPA = HD / DPL;              // live lanes a position
  static constexpr int LPP = LPA <= 2 ? 2 : LPA <= 4 ? 4 : LPA <= 8 ? 8
                           : LPA <= 16 ? 16 : 32;   // lanes a position
  static constexpr int PPW = 32 / LPP;              // positions a warp-pass
  static constexpr int PCTA = PPW * kWarps;         // positions a CTA-pass
  // (at G 7, 8 passes a round left K3 at 255 registers with 4 bytes of
  // spill stores, by ptxas on sm_90a: 6 passes there, and at grok-1's G 6)
  static constexpr int kDepth = G == 6 || G == 7 ? 6
                              : kRoundBytes / DPL < 8 ? kRoundBytes / DPL : 8;
  static constexpr int NP = W < 4 / G ? W : (4 / G > 0 ? 4 / G : 1);
  static_assert(HD % DPL == 0 && LPA >= 2 && LPA <= 32, "lane groups");
};

// The byte j of x (already offset: x ^ 0x80808080) as the f32 value of the
// int8 code it came from: 2^23 + (code + 128) by PRMT, minus 2^23 + 128.
template <int J>
__device__ __forceinline__ float code_f32(uint32_t x) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u | J)) - 8388736.f;
}

template <int W>
__device__ __forceinline__ void load_row(const int8_t* p, uint32_t (&w)[W]) {
  // (global memory, read-only path)
  if constexpr (W == 4) {
    const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = t.x; w[1] = t.y; w[2] = t.z; w[3] = t.w;
  } else if constexpr (W == 2) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = t.x; w[1] = t.y;
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

// Dense pool (K3): row b of k/v addressed as (B, KV, S, hd) through element
// strides, one k and one v scale per (b, h). key_offset: the global position
// of local position 0 (0 for a whole cache); the range is local.
struct Dense {
  const int8_t* kbase;
  const int8_t* vbase;
  int64_t sks, svs;
  float kscale, vscale;         // kscale holds sm_scale * log2(e)
  int s_lo, s_hi;

  // The length, the window and the scales: no barrier (nothing staged).
  __device__ __forceinline__ Dense(const int8_t* kq, const int8_t* vq,
                                   const float* k_scale, const float* v_scale,
                                   const int32_t* lengths, int b, int h, int KV,
                                   int S, int64_t skb, int64_t skh, int64_t sks_,
                                   int64_t svb, int64_t svh, int64_t svs_,
                                   int window, float sm_scale,
                                   int key_offset = 0)
      : kbase(kq + b * skb + h * skh), vbase(vq + b * svb + h * svh),
        sks(sks_), svs(svs_) {
    const int len = __ldg(lengths + b) - key_offset;
    kscale = __ldg(k_scale + b * KV + h) * sm_scale * kLog2e;
    vscale = __ldg(v_scale + b * KV + h);
    s_hi = min(max(len, 0), S);
    s_lo = window > 0 ? min(max(0, len - window), s_hi) : 0;
  }
  // Where position s's K/V rows start; a tag for scales() (-1: masked).
  __device__ __forceinline__ int row(int s, const int8_t*& kr, const int8_t*& vr) const {
    kr = kbase + s * sks;
    vr = vbase + s * svs;
    return 0;
  }
  __device__ __forceinline__ void scales(int, float& ks, float& vs) const {
    ks = kscale;
    vs = vscale;
  }
};

// Paged pool (K4): position s lives in page table[b, s / ps] at offset
// s % ps of the arena (P, ps, KV, hd), read through element strides; one k
// and one v scale per (page, h). The CTA stages its table row and the
// scales of the pages it visits in shared memory (tab, ksc, vsc: MP each).
struct Paged {
  const int8_t* kbase;
  const int8_t* vbase;
  int64_t skp, sks, svp, svs;
  int ps, ps_shift, P;                  // ps_shift: log2(ps), or -1
  const int* tab;
  float* ksc;
  float* vsc;
  int s_lo, s_hi;

  // The length and the table row (loaded together), one barrier. The
  // scales follow in staged(), called once the first round's K/V loads are
  // issued, so that those loads and the scales' overlap. The verify window
  // passes lead: the length is lengths[b] + lead (K4: 0).
  __device__ __forceinline__ Paged(const int8_t* kp, const int8_t* vp,
                                   const int32_t* page_table,
                                   const int32_t* lengths, int b, int h, int MP,
                                   int P_, int ps_, int ps_shift_, int64_t skp_,
                                   int64_t sks_, int64_t skh, int64_t svp_,
                                   int64_t svs_, int64_t svh, int window,
                                   int* tab_s, float* ksc_s, float* vsc_s,
                                   int lead = 0)
      : kbase(kp + h * skh), vbase(vp + h * svh), skp(skp_), sks(sks_),
        svp(svp_), svs(svs_), ps(ps_), ps_shift(ps_shift_), P(P_),
        tab(tab_s), ksc(ksc_s), vsc(vsc_s) {
    const int32_t* prow = page_table + static_cast<int64_t>(b) * MP;
    for (int j = threadIdx.x; j < MP; j += kThreads) tab_s[j] = __ldg(prow + j);
    const int len = __ldg(lengths + b) + lead;
    s_hi = min(len, MP * ps);
    s_lo = window > 0 ? max(0, len - window) : 0;
    __syncthreads();
  }
  // The addressing alone (the split body, int8_split_decode.cuh, stages its
  // own share of the table row and of the scales; tab, ksc, vsc, s_lo and
  // s_hi are not set).
  __device__ __forceinline__ Paged(const int8_t* kp, const int8_t* vp, int h,
                                   int P_, int ps_, int ps_shift_, int64_t skp_,
                                   int64_t sks_, int64_t skh, int64_t svp_,
                                   int64_t svs_, int64_t svh)
      : kbase(kp + h * skh), vbase(vp + h * svh), skp(skp_), sks(sks_),
        svp(svp_), svs(svs_), ps(ps_), ps_shift(ps_shift_), P(P_) {}
  // The table entry (page index j = s / ps) of position s.
  __device__ __forceinline__ int entry(int s) const {
    return ps_shift >= 0 ? s >> ps_shift : s / ps;
  }
  // Where the K/V rows of offset `off` of page `page` (inside [0, P)) start.
  __device__ __forceinline__ void at(int page, int off, const int8_t*& kr,
                                     const int8_t*& vr) const {
    kr = kbase + page * skp + off * sks;
    vr = vbase + page * svp + off * svs;
  }
  __device__ __forceinline__ int row(int s, const int8_t*& kr, const int8_t*& vr) const {
    const int j = ps_shift >= 0 ? s >> ps_shift : s / ps;
    const int page = tab[j];
    if (page < 0 || page >= P) return -1;
    const int off = s - j * ps;
    kr = kbase + page * skp + off * sks;
    vr = vbase + page * svp + off * svs;
    return j;
  }
  // Stage the scales of the visited pages (j in [s_lo / ps, ceil(s_hi /
  // ps)), the entry inside [0, P)), then the barrier after which scales()
  // may read them.
  __device__ __forceinline__ void staged(const float* k_scale, const float* v_scale,
                                         int h, int KV, float sm_scale) const {
    const int j_lo = s_lo / ps;
    const int j_hi = s_hi > s_lo ? (s_hi + ps - 1) / ps : j_lo;
    for (int j = j_lo + static_cast<int>(threadIdx.x); j < j_hi; j += kThreads) {
      const int page = tab[j];
      float ks = 0.f, vs = 0.f;
      if (page >= 0 && page < P) {
        ks = __ldg(k_scale + page * KV + h) * sm_scale * kLog2e;
        vs = __ldg(v_scale + page * KV + h);
      }
      ksc[j] = ks;
      vsc[j] = vs;
    }
    __syncthreads();
  }
  __device__ __forceinline__ void scales(int j, float& ks, float& vs) const {
    ks = ksc[j];
    vs = vsc[j];
  }
};

// Shared memory of the merge (floats): every lane group's accumulators
// (kThreads / LPP groups x G x HD), then each warp's (m, l) per head.
template <int HD, int G>
struct MergePlan {
  static constexpr int kStates = kThreads / Tile<HD, G>::LPP;
  static constexpr int kAcc = 0;
  static constexpr int kM = kStates * G * HD;
  static constexpr int kL = kM + kWarps * G;
  static constexpr int kFloats = kL + kWarps * G;
};

// The body. `src` has read the length (and staged the table); `stage` is
// called once after the first passes' loads are issued (the paged source
// stores its scales there and synchronises). q: this (row, kv head)'s G x
// HD bf16 query heads; out: its G x HD outputs; merge: MergePlan floats.
// kLse (K3 on a piece of a split cache): the outputs go to of32 (G x HD
// f32) instead, unrounded, and each head's natural log-sum-exp to lse (G
// floats): ln 2 (m + log2 l) of the merged max m and sum l, in the log2
// units the body scores in; o = 0 and lse = -inf where no key was valid.
// Rounded to bf16, of32 is what out would hold.
// K3 and K4 read a round ahead into two register buffers. kLean (the
// verify window's positions, many CTAs an SM): no round ahead, a round's K
// words loaded in two batches, the scores, then its V words in two
// batches, and a pass wholly past the range not computed (its scores would
// be -inf); the passes, rounds and arithmetic are the same, so are the
// bits (the lean loop below mirrors consume's arithmetic line for line;
// the host test holds the verify window, lean, against K4 bit for bit at
// G 1 to 8), in a third of the registers (80 against K4's 245 at hd 64,
// G 1, by ptxas: six CTAs an SM instead of two). Why two forms: K3 and K4
// built lean, on an H100 at 700 W (tools/kernel_ab.py, two turns each),
// took 7.7-8.1 us against 5.0 (K4, stablelm), 5.2 against 3.9 (K4,
// whisper) and 6.3-6.6 against 4.7 (K3, stablelm): one CTA a (row, kv
// head) waits for the scores before it loads a round's V words, and
// nothing else on the SM hides that round trip; lean K3 also spilled.
template <int HD, int G, bool kLean = false, bool kLse = false, class Src,
          class Stage>
__device__ __forceinline__ void attend(const Src& src, Stage stage,
                                       const __nv_bfloat16* __restrict__ qg,
                                       __nv_bfloat16* __restrict__ og,
                                       float* merge,
                                       float* __restrict__ of32 = nullptr,
                                       float* __restrict__ lse = nullptr) {
  using T = Tile<HD, G>;
  constexpr int DPL = T::DPL, W = T::W, LPP = T::LPP, PPW = T::PPW;
  constexpr int PCTA = T::PCTA, D = T::kDepth, NP = T::NP;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / LPP, sub = lane % LPP;
  // a lane that holds dims of its position (every lane unless hd / DPL is
  // no power of two); an idle lane holds zero codes and a zero query
  const bool live = T::LPA == LPP || sub < T::LPA;

  const int s_lo = src.s_lo, s_hi = src.s_hi;
  const int n_pass = s_hi > s_lo ? (s_hi - s_lo + PCTA - 1) / PCTA : 0;
  const int s0 = s_lo + warp * PPW + grp;   // this lane's position in pass 0

  // two register buffers of D passes each (this lane's K and V words of a
  // pass, and the pass's tag): round r of D passes lives in buffer r % 2,
  // and round r + 1 is issued before round r is consumed
  uint32_t kb0[D][W], vb0[D][W], kb1[D][W], vb1[D][W];
  int tag0[D], tag1[D];
  auto issue = [&](int r, uint32_t (&kb)[D][W], uint32_t (&vb)[D][W],
                   int (&tag)[D]) {
#pragma unroll
    for (int u = 0; u < D; ++u) {
      const int p = r * D + u;
      const int s = s0 + p * PCTA;
      tag[u] = -1;
      const int8_t* kr = nullptr;
      const int8_t* vr = nullptr;
      if (p < n_pass && s < s_hi) tag[u] = src.row(s, kr, vr);
      if (tag[u] >= 0 && live) {
        load_row<W>(kr + sub * DPL, kb[u]);
        load_row<W>(vr + sub * DPL, vb[u]);
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i) kb[u][i] = vb[u][i] = 0x80808080u;
      }
    }
  };
  const int n_round = (n_pass + D - 1) / D;
  // the lean path's round, in LS batches of SB passes: its tags, and the K
  // words of one batch (V words are loaded after the round's scores, a
  // batch at a time). Two batches: half a round's words live at once
  constexpr int LS = 2, SB = (D + LS - 1) / LS;
  int ltag[D];
  uint32_t lkw[SB][W];
  auto lean_issue = [&](int r, int h) {     // h: the batch (unrolled)
    const int np = min(D, n_pass - r * D);  // passes in range: CTA-uniform
#pragma unroll
    for (int k = 0; k < SB; ++k) {
      const int u = h * SB + k;
      if (u >= D) break;
      const int s = s0 + (r * D + u) * PCTA;
      const int8_t* kr = nullptr;
      const int8_t* vr = nullptr;
      ltag[u] = u < np && s < s_hi ? src.row(s, kr, vr) : -1;
      if (ltag[u] >= 0 && live) {
        load_row<W>(kr + sub * DPL, lkw[k]);
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i) lkw[k][i] = 0x80808080u;
      }
    }
  };
  if constexpr (kLean) {
    if (n_round > 0) lean_issue(0, 0);
  } else {
    issue(0, kb0, vb0, tag0);
    if (n_round > 1) issue(1, kb1, vb1, tag1);
  }

  // this lane's DPL dims of the G query heads, f32 (q is 16-byte aligned,
  // so a slice of 2 * DPL bytes is aligned to its size)
  float qr[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const __nv_bfloat16* qp = qg + g * HD + (live ? sub : 0) * DPL;
    uint32_t qw[DPL / 2];
    if (!live) {
#pragma unroll
      for (int k = 0; k < DPL / 2; ++k) qw[k] = 0u;
    } else if constexpr (DPL >= 8) {
#pragma unroll
      for (int i = 0; i < DPL / 8; ++i) {
        const uint4 t = *reinterpret_cast<const uint4*>(qp + 8 * i);
        qw[4 * i] = t.x; qw[4 * i + 1] = t.y; qw[4 * i + 2] = t.z; qw[4 * i + 3] = t.w;
      }
    } else {
      const uint2 t = *reinterpret_cast<const uint2*>(qp);
      qw[0] = t.x; qw[1] = t.y;
    }
#pragma unroll
    for (int k = 0; k < DPL / 2; ++k) {
      qr[g][2 * k] = __uint_as_float(qw[k] << 16);
      qr[g][2 * k + 1] = __uint_as_float(qw[k] & 0xffff0000u);
    }
  }
  stage();

  // online softmax over rounds: the running max m is the warp's (uniform
  // over its lane groups), updated once a round from the round's scores,
  // so a rescale is a warp-uniform branch taken only when the max rises
  // (never within one round); l and the accumulator are the lane group's
  float m[G], l[G], acc[G][DPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;
  }
#ifdef INT8_DECODE_COPY_ONLY
  uint32_t sink = 0;
#endif
  auto consume = [&](uint32_t (&kb)[D][W], uint32_t (&vb)[D][W],
                     const int (&tag)[D]) {
#ifdef INT8_DECODE_COPY_ONLY
#pragma unroll
    for (int u = 0; u < D; ++u)
#pragma unroll
      for (int i = 0; i < W; ++i) sink ^= kb[u][i] ^ vb[u][i];
#else
    // the scores of the round's passes (-inf where masked)
    float sc[D][G];
#pragma unroll
    for (int u = 0; u < D; ++u) {
      float part[G][NP];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int t = 0; t < NP; ++t) part[g][t] = 0.f;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const uint32_t x = kb[u][i] ^ 0x80808080u;
        const float k0 = code_f32<0>(x), k1 = code_f32<1>(x);
        const float k2 = code_f32<2>(x), k3 = code_f32<3>(x);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float d = part[g][i % NP];
          d = fmaf(qr[g][4 * i], k0, d);
          d = fmaf(qr[g][4 * i + 1], k1, d);
          d = fmaf(qr[g][4 * i + 2], k2, d);
          d = fmaf(qr[g][4 * i + 3], k3, d);
          part[g][i % NP] = d;
        }
      }
      float ks, vs;
      src.scales(tag[u] >= 0 ? tag[u] : 0, ks, vs);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = part[g][0];
#pragma unroll
        for (int t = 1; t < NP; ++t) dot += part[g][t];
#pragma unroll
        for (int o = LPP / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        sc[u][g] = tag[u] >= 0 ? dot * ks : -INFINITY;
      }
    }
    // the round's max over the warp, and the rescale if it rose
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = sc[0][g];
#pragma unroll
      for (int u = 1; u < D; ++u) mx = fmaxf(mx, sc[u][g]);
#pragma unroll
      for (int o = LPP; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      if (mx > m[g]) {                      // warp-uniform
        if (m[g] != -INFINITY) {
          const float corr = exp2f(m[g] - mx);
          l[g] *= corr;
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[g][e] *= corr;
        }
        m[g] = mx;
      }
    }
    // P.V straight from the V words
#pragma unroll
    for (int u = 0; u < D; ++u) {
      if (tag[u] >= 0) {
        float ks, vs;
        src.scales(tag[u], ks, vs);
        float vf[DPL];
#pragma unroll
        for (int i = 0; i < W; ++i) {
          const uint32_t x = vb[u][i] ^ 0x80808080u;
          vf[4 * i] = code_f32<0>(x);
          vf[4 * i + 1] = code_f32<1>(x);
          vf[4 * i + 2] = code_f32<2>(x);
          vf[4 * i + 3] = code_f32<3>(x);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = exp2f(sc[u][g] - m[g]);
          l[g] += p;
          const float pv = p * vs;
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[g][e] = fmaf(pv, vf[e], acc[g][e]);
        }
      }
    }
#endif
  };
  if constexpr (kLean) {
    // the arithmetic below is consume's, in the same order: keep them in
    // step
    for (int r = 0; r < n_round; ++r) {     // CTA-uniform
      const int np = min(D, n_pass - r * D);
      const int (&tag)[D] = ltag;
#ifdef INT8_DECODE_COPY_ONLY
      (void)np;
#pragma unroll
      for (int h = 0; h < LS; ++h) {
        if (r > 0 || h > 0) lean_issue(r, h);
#pragma unroll
        for (int k = 0; k < SB; ++k) {
          const int u = h * SB + k;
          if (u >= D) break;
          uint32_t vw[W] = {};
          if (tag[u] >= 0 && live) {
            const int8_t* kr;
            const int8_t* vr;
            src.row(s0 + (r * D + u) * PCTA, kr, vr);
            load_row<W>(vr + sub * DPL, vw);
          }
#pragma unroll
          for (int i = 0; i < W; ++i) sink ^= lkw[k][i] ^ vw[i];
        }
      }
#else
      float sc[D][G];
#pragma unroll
      for (int h = 0; h < LS; ++h) {
        if (r > 0 || h > 0) lean_issue(r, h);
#pragma unroll
        for (int k = 0; k < SB; ++k) {
          const int u = h * SB + k;
          if (u >= D) break;
          if (u >= np) {                    // CTA-uniform
#pragma unroll
            for (int g = 0; g < G; ++g) sc[u][g] = -INFINITY;
            continue;
          }
          float part[G][NP];
#pragma unroll
          for (int g = 0; g < G; ++g)
#pragma unroll
            for (int t = 0; t < NP; ++t) part[g][t] = 0.f;
#pragma unroll
          for (int i = 0; i < W; ++i) {
            const uint32_t x = lkw[k][i] ^ 0x80808080u;
            const float k0 = code_f32<0>(x), k1 = code_f32<1>(x);
            const float k2 = code_f32<2>(x), k3 = code_f32<3>(x);
#pragma unroll
            for (int g = 0; g < G; ++g) {
              float d = part[g][i % NP];
              d = fmaf(qr[g][4 * i], k0, d);
              d = fmaf(qr[g][4 * i + 1], k1, d);
              d = fmaf(qr[g][4 * i + 2], k2, d);
              d = fmaf(qr[g][4 * i + 3], k3, d);
              part[g][i % NP] = d;
            }
          }
          float ks, vs;
          src.scales(tag[u] >= 0 ? tag[u] : 0, ks, vs);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            float dot = part[g][0];
#pragma unroll
            for (int t = 1; t < NP; ++t) dot += part[g][t];
#pragma unroll
            for (int o = LPP / 2; o > 0; o >>= 1)
              dot += __shfl_xor_sync(0xffffffffu, dot, o);
            sc[u][g] = tag[u] >= 0 ? dot * ks : -INFINITY;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = sc[0][g];
#pragma unroll
        for (int u = 1; u < D; ++u) mx = fmaxf(mx, sc[u][g]);
#pragma unroll
        for (int o = LPP; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        if (mx > m[g]) {                    // warp-uniform
          if (m[g] != -INFINITY) {
            const float corr = exp2f(m[g] - mx);
            l[g] *= corr;
#pragma unroll
            for (int e = 0; e < DPL; ++e) acc[g][e] *= corr;
          }
          m[g] = mx;
        }
      }
#pragma unroll
      for (int h = 0; h < LS; ++h) {
        uint32_t vw[SB][W];
#pragma unroll
        for (int k = 0; k < SB; ++k) {
          const int u = h * SB + k;
          if (u >= D) break;
          if (tag[u] >= 0 && live) {
            const int8_t* kr;
            const int8_t* vr;
            src.row(s0 + (r * D + u) * PCTA, kr, vr);
            load_row<W>(vr + sub * DPL, vw[k]);
          } else if (!live) {
#pragma unroll
            for (int i = 0; i < W; ++i) vw[k][i] = 0x80808080u;
          }
        }
#pragma unroll
        for (int k = 0; k < SB; ++k) {
          const int u = h * SB + k;
          if (u >= D) break;
          if (tag[u] >= 0) {
            float ks, vs;
            src.scales(tag[u], ks, vs);
            float vf[DPL];
#pragma unroll
            for (int i = 0; i < W; ++i) {
              const uint32_t x = vw[k][i] ^ 0x80808080u;
              vf[4 * i] = code_f32<0>(x);
              vf[4 * i + 1] = code_f32<1>(x);
              vf[4 * i + 2] = code_f32<2>(x);
              vf[4 * i + 3] = code_f32<3>(x);
            }
#pragma unroll
            for (int g = 0; g < G; ++g) {
              const float p = exp2f(sc[u][g] - m[g]);
              l[g] += p;
              const float pv = p * vs;
#pragma unroll
              for (int e = 0; e < DPL; ++e) acc[g][e] = fmaf(pv, vf[e], acc[g][e]);
            }
          }
        }
      }
#endif
    }
  } else {
    for (int r = 0; r < n_round; r += 2) {  // CTA-uniform
      consume(kb0, vb0, tag0);
      if (r + 2 < n_round) issue(r + 2, kb0, vb0, tag0);
      if (r + 1 >= n_round) break;
      consume(kb1, vb1, tag1);
      if (r + 3 < n_round) issue(r + 3, kb1, vb1, tag1);
    }
  }

#ifdef INT8_DECODE_COPY_ONLY
  // a token output, stored only if the loads gave this pattern (so that
  // they are not dropped): the floor of the loads and the prologue
  if constexpr (kLse) {
    if (threadIdx.x < G * HD) of32[threadIdx.x] = 0.f;
    if (sink == 0x9e3779b9u) lse[0] = 1.f;
  } else {
    if (threadIdx.x < G * HD) og[threadIdx.x] = __float2bfloat16(0.f);
    if (sink == 0x9e3779b9u) og[0] = __float2bfloat16(1.f);
  }
  (void)merge;
#else
  // ---- merge: each lane group's accumulator and each warp's (m, l) go to
  // shared memory; then every thread sums a share of the groups for one
  // output element, weighted by its warp's exp2(m - max), and the shares
  // are summed by xor-shuffles: a fixed order, the same bits every call ----
  using M = MergePlan<HD, G>;
  constexpr int OUT = G * HD;
  constexpr int NS = M::kStates;            // lane groups of the CTA
  float* wacc = merge + M::kAcc;
  float* wm = merge + M::kM;
  float* wl = merge + M::kL;
  const int state = warp * PPW + grp;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int o = LPP; o < 32; o <<= 1) l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
    if (lane == 0) {
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = l[g];
    }
    if (live) {
#pragma unroll
      for (int e = 0; e < DPL; e += 4)
        *reinterpret_cast<float4*>(wacc + state * OUT + g * HD + sub * DPL + e) =
            make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2], acc[g][e + 3]);
    }
  }
  __syncthreads();
  // R threads (neighbouring lanes) share an output element, each NS / R
  // lane groups (those of NS / R / PPW warps)
  constexpr int R = OUT >= kThreads ? 1 : kThreads / OUT;
  constexpr int SPR = NS / R;
  static_assert(R <= 32 && NS % R == 0 && SPR % PPW == 0, "merge shares");
  const int r = threadIdx.x % R;
  for (int i = threadIdx.x / R; i < OUT; i += kThreads / R) {
    const int g = i / HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float o = 0.f;
#pragma unroll
    for (int w0 = 0; w0 < SPR / PPW; ++w0) {
      const int w = r * (SPR / PPW) + w0;
      const float mw = wm[w * G + g];
      const float wt = mw == -INFINITY ? 0.f : exp2f(mw - mx);
#pragma unroll
      for (int k = 0; k < PPW; ++k) o = fmaf(wacc[(w * PPW + k) * OUT + i], wt, o);
    }
#pragma unroll
    for (int off = R / 2; off > 0; off >>= 1) o += __shfl_xor_sync(0xffffffffu, o, off);
    if (r == 0) {
      float lsum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = wm[w * G + g];
        lsum = fmaf(wl[w * G + g], mw == -INFINITY ? 0.f : exp2f(mw - mx), lsum);
      }
      const float val = mx == -INFINITY ? 0.f : o / lsum;
      if constexpr (kLse) {
        of32[i] = val;
        if (i % HD == 0)
          lse[i / HD] = mx == -INFINITY ? -INFINITY
                                        : (mx + log2f(lsum)) * 0.6931471805599453f;
      } else {
        og[i] = __float2bfloat16(val);
      }
    }
  }
#endif
}

// A CTA's shared memory, all dynamic: the merge (MergePlan floats), then,
// for the paged kernel, its staged table row and the pages' k and v scales
// (MP int32 and 2 x MP floats). (A host build that runs the body on the
// CPU defines int8_decode_smem itself, one array a CTA.)
#ifndef int8_decode_smem
extern __shared__ __align__(16) unsigned char int8_decode_smem[];
#endif

template <int HD, int G>
__host__ __device__ constexpr size_t smem_bytes(int MP) {
  return sizeof(float) * MergePlan<HD, G>::kFloats + 12 * static_cast<size_t>(MP);
}

// K3: one CTA per (row b, kv head h), blockIdx.x = b * KV + h. kLse: a
// piece of a split cache at key_offset, out_f32 (B, KV * G, HD) and lse
// (B, KV * G) written in place of out (attend).
template <int HD, int G, bool kLse = false>
__global__ void __launch_bounds__(kThreads)
decode_int8_kernel(const __nv_bfloat16* __restrict__ q,
                   const int8_t* __restrict__ kq, const int8_t* __restrict__ vq,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale,
                   const int32_t* __restrict__ lengths,
                   __nv_bfloat16* __restrict__ out, int KV, int S,
                   int64_t skb, int64_t skh, int64_t sks, int64_t svb,
                   int64_t svh, int64_t svs, int window, float sm_scale,
                   int key_offset = 0, float* __restrict__ out_f32 = nullptr,
                   float* __restrict__ lse = nullptr) {
  float* merge = reinterpret_cast<float*>(int8_decode_smem);
  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const Dense src(kq, vq, k_scale, v_scale, lengths, b, h, KV, S, skb, skh,
                  sks, svb, svh, svs, window, sm_scale, key_offset);
  const int64_t bh = static_cast<int64_t>(b) * KV + h;
  const int64_t base = bh * G * HD;
  if constexpr (kLse)
    attend<HD, G, false, true>(src, [] {}, q + base, nullptr, merge,
                               out_f32 + base, lse + bh * G);
  else
    attend<HD, G>(src, [] {}, q + base, out + base, merge);
}

// K4: one CTA per (row b, kv head h), blockIdx.x = b * KV + h; ps_shift is
// log2(ps) for a power-of-two page size, else -1.
template <int HD, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const int8_t* __restrict__ kp, const int8_t* __restrict__ vp,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ page_table,
                    const int32_t* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, int KV, int P, int ps,
                    int ps_shift, int MP, int64_t skp, int64_t sks, int64_t skh,
                    int64_t svp, int64_t svs, int64_t svh, int window,
                    float sm_scale) {
  float* merge = reinterpret_cast<float*>(int8_decode_smem);
  int* tab = reinterpret_cast<int*>(merge + MergePlan<HD, G>::kFloats);
  float* ksc = reinterpret_cast<float*>(tab + MP);
  float* vsc = ksc + MP;
  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const Paged src(kp, vp, page_table, lengths, b, h, MP, P, ps, ps_shift, skp,
                  sks, skh, svp, svs, svh, window, tab, ksc, vsc);
  const int64_t base = (static_cast<int64_t>(b) * KV + h) * G * HD;
  attend<HD, G>(src, [&] { src.staged(k_scale, v_scale, h, KV, sm_scale); },
                q + base, out + base, merge);
}

// The verify window: window position j = blockIdx.y of row b attends
// lengths[b] + lead + j positions (lead 1: position j sits at absolute
// position base_len + j); its query and output rows start at q + b * qsb +
// j * qst and out + b * osb + j * ost (head h's G rows follow); blockIdx.x
// = b * KV + h. One CTA a position, reading the arena as K4 does (L2
// serves the rows the positions share), running K4's body at its own
// length, so its output is bit-identical to a K4 call; the body runs
// lean (attend), so that six CTAs share an SM. Shared memory: smem_bytes.
template <int HD, int G>
__global__ void __launch_bounds__(kThreads)
paged_verify_kernel(const __nv_bfloat16* __restrict__ q,
                    const int8_t* __restrict__ kp, const int8_t* __restrict__ vp,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int32_t* __restrict__ page_table,
                    const int32_t* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, int KV, int P, int ps,
                    int ps_shift, int MP, int64_t skp, int64_t sks, int64_t skh,
                    int64_t svp, int64_t svs, int64_t svh, int window,
                    float sm_scale, int lead, int64_t qsb, int64_t qst,
                    int64_t osb, int64_t ost) {
  float* merge = reinterpret_cast<float*>(int8_decode_smem);
  int* tab = reinterpret_cast<int*>(merge + MergePlan<HD, G>::kFloats);
  float* ksc = reinterpret_cast<float*>(tab + MP);
  float* vsc = ksc + MP;
  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const int j = blockIdx.y;
  const int64_t qo = b * qsb + j * qst + static_cast<int64_t>(h) * G * HD;
  const int64_t oo = b * osb + j * ost + static_cast<int64_t>(h) * G * HD;
  const Paged src(kp, vp, page_table, lengths, b, h, MP, P, ps, ps_shift, skp,
                  sks, skh, svp, svs, svh, window, tab, ksc, vsc, lead + j);
  attend<HD, G, true>(src, [&] { src.staged(k_scale, v_scale, h, KV, sm_scale); },
                      q + qo, out + oo, merge);
}

}  // namespace int8_decode

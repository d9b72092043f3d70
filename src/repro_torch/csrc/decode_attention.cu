// One-token GQA flash-decode against a float (bf16) KV cache, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (Pallas, pl.pallas_call at :96) and computes what the
// models call, the JAX package's jnp src/repro/models/attention.py::
// decode_attention: for batch row b and kv head h, the G = H / KV query heads
// of the group attend the keys/values of positions [max(0, len - window),
// min(len, S)) of row b; scores and the accumulator are f32, each
// probability is rounded to bf16 (the cache dtype) before the P.V product,
// the output is rounded to bf16. The Pallas kernel keeps p in f32 and needs
// S to be a multiple of its block; here S is any length (1500 encoder frames
// in a cross-attention decode, an odd s_max in a float pool) and the ragged
// tail is masked per position. A row with no valid key returns zeros (JAX
// returns the mean of the masked values; neither serving path has such a
// row: a cross row sees all enc_len frames, a pool row's length is >= 1
// after its write).
//
// What bounds it on this card: bytes. Each valid position costs 4 * hd
// bytes of bf16 K/V for 4 * G * hd flops, about G flops per byte, hundreds
// of times below the compute roof: the levers are to stream the cache once,
// to keep enough bytes in flight, and to leave little work after the last
// byte lands. At a cross decode (8 rows x 8 heads x 1500 frames, 24.6 MB)
// the grid runs in one wave, so the time is one ramp of the memory system,
// the bytes, and the tail: the last chunk's math and the merge.
//
// Design. A CTA serves one (row, kv head) pair and one split of the
// positions (the wrapper splits S by shapes only, so that the grid runs in
// one wave); warp w of the CTA walks its own run of consecutive 32-position
// chunks. Each warp owns a ring of kStages chunk buffers in shared memory
// and keeps them in flight by cp.async: neighbouring lanes copy
// neighbouring 16-byte pieces of the same K and V rows (pieces swizzled by
// row so that the reads below are free of bank conflicts), and the next
// chunk lands while the current one is scored. Per chunk, lane i owns
// position i: it dots its K row (from shared memory) with the G query heads
// (in registers for a small group, else f32 in shared memory read as a
// broadcast; the dot in several partial sums), one warp max per head gives
// the chunk's running max, the lane keeps its own running sum (summed over
// the warp once, at the end), and the bf16-rounded probabilities go to a
// small per-warp buffer. For P.V each lane owns hd / 32 adjacent output dims
// and reads them from each V row as one 2-, 4- or 8-byte load, with the
// probabilities read four at a time as broadcasts: no shuffle chain. The
// four warps' states merge in shared memory in warp order. When S is split,
// the splits of a pair run as one thread-block cluster: each CTA writes its
// (accumulator, max, sum) into its slot in the first CTA's shared memory
// (distributed shared memory), one cluster barrier later that CTA merges
// the slots in split order and writes the output. No second launch, no
// workspace in device memory, no atomics, the same bits on every run. The
// cache is read in the model layout (B, S, KV, hd) by strides: the
// cross-attention sidecars and the float pool are views, never copied or
// transposed. Lengths are read on the device: no host sync.
//
// A piece of a longer cache (decode against a cache split over its
// sequence, one piece a rank): key_offset is the global position of local
// key 0, and the call attends the global range [max(0, len - window), len)
// where it meets [key_offset, key_offset + S). With a non-null lse the
// output is f32 (out_f32, normalised over the keys the call saw) and lse
// receives each (row, head)'s natural log-sum-exp of its scaled scores (the
// units of K2's), -inf with o = 0 where the piece holds no valid key: the
// pieces then merge by one lse-weighted sum. key_offset 0 and a null lse
// give the bits of a call without them.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSplits = 8;             // the portable cluster size

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid (the
// source is then not read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The cluster barrier in its two halves (every thread of every CTA of the
// cluster): arrive (relaxed: orders nothing; release: this thread's writes,
// shared memory of other CTAs included, are visible once the barrier
// completes), then wait for every thread of the cluster to have arrived.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Shared-memory plan of one CTA (bytes, in this order): the warps' rings of
// chunk buffers (K then V of 32 positions, 16-byte pieces swizzled by row;
// after the loop the same space holds the warps' accumulators), q in f32,
// the warps' probability buffers, the warps' maxima and sums, and the
// splits' states (accumulator, max, sum) that the other CTAs of the cluster
// write into the first CTA's shared memory.
template <int HD, int G>
struct Plan {
  static constexpr int kVec = HD / 8;               // 16-byte pieces per row
  static constexpr int kStages = 2;                 // chunks in flight a warp
  static constexpr int kChunkPieces = 2 * 32 * kVec;
  static constexpr int kRing = kWarps * kStages * kChunkPieces * 16;
  static constexpr int kQ = kRing;
  static constexpr int kP = kQ + G * HD * 4;
  static constexpr int kM = kP + kWarps * G * 32 * 4;
  static constexpr int kL = kM + kWarps * G * 4;
  static constexpr int kSO = kL + kWarps * G * 4;
  static constexpr int kSM = kSO + kMaxSplits * G * HD * 4;
  static constexpr int kSL = kSM + kMaxSplits * G * 4;
  static constexpr int kBytes = kSL + kMaxSplits * G * 4;
  static_assert(kWarps * G * HD * 4 <= kRing, "accumulators fit in the ring");
};

// Where piece `piece` of row `row` (0..31) of a chunk buffer lives: an XOR
// swizzle so that eight lanes reading the same piece of eight consecutive
// rows, and a cp.async of eight pieces of one row, hit distinct banks. At hd
// 80 (10 pieces a row, no power of two) the first eight pieces of a row are
// swizzled so and the last two stay in place (reading those, rows r and r +
// 4 share a bank group: two ways, on a fifth of the K reads).
template <int VEC>
__device__ __forceinline__ int swz(int row, int piece) {
  if constexpr ((VEC & (VEC - 1)) != 0) {
    return row * VEC + (piece < 8 ? piece ^ (row & 7) : piece);
  } else {
    const int x = VEC >= 8 ? (row & 7) : ((row >> 1) & (VEC - 1));
    return row * VEC + (piece ^ x);
  }
}

// Element i of (row, kv head) pair bh's G x HD output from the merged max,
// sum and accumulator: bf16, or f32 plus the head's lse (written by its
// first element) when lse is not null.
template <int HD, int G>
__device__ __forceinline__ void store(__nv_bfloat16* out, float* out_f32,
                                      float* lse, int bh, int i, bool first,
                                      float mx, float lsum, float o) {
  const float val = mx == -INFINITY ? 0.f : o / fmaxf(lsum, 1e-30f);
  const int64_t at = static_cast<int64_t>(bh) * G * HD + i;
  if (lse == nullptr) {
    out[at] = __float2bfloat16(val);
    return;
  }
  out_f32[at] = val;
  if (first)
    lse[static_cast<int64_t>(bh) * G + i / HD] =
        mx == -INFINITY || !(lsum > 0.f) ? -INFINITY : mx + logf(lsum);
}

// ptxas is told that one resident CTA an SM suffices, so it may take up to
// 255 registers a thread (two CTAs of 128 threads still fit an SM, as the
// split plan assumes): left to its own bound it held some instantiations at
// 128 registers, and the key offset and the log-sum-exp epilogue tipped
// <128, 7>, <128, 1> (with LSE a template argument, <80, 8> and <80, 4>)
// into 12-24 bytes of spill stores (sm_90a, CUDA 12.8); with it, 64 to 204
// registers and none.
template <int HD, int G>
__global__ void __launch_bounds__(kThreads, 1)
decode_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const int32_t* __restrict__ lengths,
              __nv_bfloat16* __restrict__ out, float* __restrict__ out_f32,
              float* __restrict__ lse, int KV, int S, int split_len,
              int64_t skb, int64_t sks, int64_t skh, int64_t svb, int64_t svs,
              int64_t svh, int window, int key_offset, float sm_scale) {
  using P = Plan<HD, G>;
  constexpr int kVec = P::kVec;
  constexpr int kStages = P::kStages;
  // output dims owned per lane in P.V: hd / 32, and at hd 80 four, on the
  // first kPvLanes (20) lanes, the other 12 idle there (they read piece 0
  // and store nothing)
  constexpr int kDpl = HD % 32 == 0 ? HD / 32 : 4;
  constexpr int kPvLanes = HD / kDpl;
  static_assert(HD % kDpl == 0 && kPvLanes <= 32 && 8 % kDpl == 0, "P.V lanes");
  // independent partial sums, so that a small group still has several FMA
  // chains in flight: the dot of a K row in kQp parts, P.V in kAp row sets
  constexpr int kQp = G >= 4 ? 1 : 4 / G;
  constexpr int kAp = G >= 4 ? 1 : 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + P::kQ);
  float* wm = reinterpret_cast<float*>(smem + P::kM);
  float* wl = reinterpret_cast<float*>(smem + P::kL);

  const int bh = blockIdx.x;
  const int b = bh / KV, h = bh % KV;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  uint4* ring = reinterpret_cast<uint4*>(smem) + warp * kStages * P::kChunkPieces;
  float* pbuf = reinterpret_cast<float*>(smem + P::kP) + warp * G * 32;

  // the splits of a pair are one cluster (dims 1 x nsplit), so a CTA's rank
  // in it is its split; every CTA must have started before another writes
  // its shared memory: arrive now, wait before the first remote write
  if (nsplit > 1) cluster_arrive_relaxed();

  // the global range [g_lo, len) in local positions of this piece
  const int len = lengths[b];
  const int g_lo = window > 0 ? max(0, len - window) : 0;
  const int s_lo = max(max(g_lo - key_offset, 0), split * split_len);
  const int s_hi = min(min(len - key_offset, S), (split + 1) * split_len);
  const __nv_bfloat16* kbase = k + b * skb + h * skh;
  const __nv_bfloat16* vbase = v + b * svb + h * svh;
  const int c_begin = s_lo / 32;
  const int n_chunks = s_hi > s_lo ? (s_hi + 31) / 32 - c_begin : 0;
  // warp w walks its own run of consecutive chunks
  const int per_warp = (n_chunks + kWarps - 1) / kWarps;
  const int c_mine = c_begin + warp * per_warp;
  const int n_mine = max(0, min(per_warp, n_chunks - warp * per_warp));

  // chunk j of this warp into ring slot j % kStages (one commit group per
  // call, empty past the warp's last chunk, so the group count is uniform).
  // At hd 80 the copy loop stays rolled: unrolled, its ten rows' addresses
  // stayed live across the chunk loop and ptxas spilled 4-28 bytes at G 1,
  // 2, 4 and 8 (sm_90a), rolled none
  constexpr int kIssueUnroll = HD % 32 ? 1 : kVec;
  auto issue = [&](int j) {
    if (j < n_mine) {
      const int c = c_mine + j;
      uint4* kst = ring + (j % kStages) * P::kChunkPieces;
      uint4* vst = kst + 32 * kVec;
#pragma unroll (kIssueUnroll)
      for (int it = 0; it < kVec; ++it) {
        const int u = lane + 32 * it;
        const int row = u / kVec, piece = u % kVec;
        const int s = c * 32 + row;
        const bool valid = s >= s_lo && s < s_hi;
        const int src = valid ? s : s_lo;  // an in-range row (not read if !valid)
        const int dst = swz<kVec>(row, piece);
        cp_async16(kst + dst, kbase + src * sks + 8 * piece, valid);
        cp_async16(vst + dst, vbase + src * svs + 8 * piece, valid);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kStages; ++j) issue(j);

  const __nv_bfloat16* qg = q + static_cast<int64_t>(bh) * G * HD;
  for (int i = threadIdx.x; i < G * HD; i += kThreads)
    qs[i] = __bfloat162float(qg[i]);
  __syncthreads();

  float m[G], lp[G], acc[kAp][G][kDpl];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    lp[g] = 0.f;
#pragma unroll
    for (int a = 0; a < kAp; ++a)
#pragma unroll
      for (int e = 0; e < kDpl; ++e) acc[a][g][e] = 0.f;
  }
  // a small group's q lives in registers, a larger one is read from shared
  // memory as a broadcast
  constexpr bool kQReg = G * HD <= 64;
  float4 qr4[kQReg ? G * HD / 4 : 1];
  if constexpr (kQReg) {
#pragma unroll
    for (int i = 0; i < G * HD / 4; ++i) qr4[i] = reinterpret_cast<const float4*>(qs)[i];
  }
  // the 16-byte piece holding this lane's output dims, and their offset in it
  const bool pv_live = lane < kPvLanes;
  const int my_piece = (pv_live ? lane : 0) * kDpl / 8;
  const int my_off = (pv_live ? lane : 0) * kDpl % 8;

  for (int j = 0; j < n_mine; ++j) {
    cp_async_wait<kStages - 1>();
    __syncwarp();                         // every lane's pieces have landed
    const uint4* kst = ring + (j % kStages) * P::kChunkPieces;
    const __nv_bfloat16* vst = reinterpret_cast<const __nv_bfloat16*>(kst + 32 * kVec);
    const int s = (c_mine + j) * 32 + lane;
    const bool valid = s >= s_lo && s < s_hi;

    float part[G][kQp];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int t = 0; t < kQp; ++t) part[g][t] = 0.f;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const uint4 kr = kst[swz<kVec>(lane, i)];
      const uint32_t w4[4] = {kr.x, kr.y, kr.z, kr.w};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float4 q0, q1;
        if constexpr (kQReg) {
          q0 = qr4[(g * HD + 8 * i) / 4];
          q1 = qr4[(g * HD + 8 * i) / 4 + 1];
        } else {
          q0 = reinterpret_cast<const float4*>(qs + g * HD + 8 * i)[0];
          q1 = reinterpret_cast<const float4*>(qs + g * HD + 8 * i)[1];
        }
        float dot = part[g][i % kQp];
        dot = fmaf(q0.x, bf_lo(w4[0]), dot);
        dot = fmaf(q0.y, bf_hi(w4[0]), dot);
        dot = fmaf(q0.z, bf_lo(w4[1]), dot);
        dot = fmaf(q0.w, bf_hi(w4[1]), dot);
        dot = fmaf(q1.x, bf_lo(w4[2]), dot);
        dot = fmaf(q1.y, bf_hi(w4[2]), dot);
        dot = fmaf(q1.z, bf_lo(w4[3]), dot);
        dot = fmaf(q1.w, bf_hi(w4[3]), dot);
        part[g][i % kQp] = dot;
      }
    }
    float score[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      score[g] = part[g][0];
#pragma unroll
      for (int t = 1; t < kQp; ++t) score[g] += part[g][t];
    }
    // every chunk holds at least one valid position, so each m_chunk is
    // finite unless the scores themselves are not
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float sc = valid ? score[g] * sm_scale : -INFINITY;
      const float m_chunk = warp_max(sc);
      const float m_new = fmaxf(m[g], m_chunk);
      const float corr = m[g] == -INFINITY ? 0.f : expf(m[g] - m_new);
      const float p = valid ? expf(sc - m_new) : 0.f;
      lp[g] = lp[g] * corr + p;
      m[g] = m_new;
#pragma unroll
      for (int a = 0; a < kAp; ++a)
#pragma unroll
        for (int e = 0; e < kDpl; ++e) acc[a][g][e] *= corr;
      pbuf[g * 32 + lane] = round_bf16(p);  // p in the cache dtype, as in JAX
    }
    __syncwarp();                         // pbuf written
    // fully unrolled but for the largest groups, where ptxas spilled
    // (sm_90a, CUDA 12: 16 bytes at hd 32, G 8) unless the unroll is halved
    constexpr int kPvUnroll = G >= 7 ? 4 : 8;
#pragma unroll (kPvUnroll)
    for (int i0 = 0; i0 < 32; i0 += 4) {
      float4 p4[G];
#pragma unroll
      for (int g = 0; g < G; ++g)
        p4[g] = reinterpret_cast<const float4*>(pbuf + g * 32 + i0)[0];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int row = i0 + ii;
        const __nv_bfloat16* vp = vst + 8 * swz<kVec>(row, my_piece) + my_off;
        float vf[kDpl];
        if constexpr (kDpl == 1) {
          vf[0] = __bfloat162float(*vp);
        } else if constexpr (kDpl == 2) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(vp);
          vf[0] = bf_lo(w);
          vf[1] = bf_hi(w);
        } else {
          const uint2 w = *reinterpret_cast<const uint2*>(vp);
          vf[0] = bf_lo(w.x);
          vf[1] = bf_hi(w.x);
          vf[2] = bf_lo(w.y);
          vf[3] = bf_hi(w.y);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pi = ii == 0 ? p4[g].x : ii == 1 ? p4[g].y
                         : ii == 2 ? p4[g].z : p4[g].w;
#pragma unroll
          for (int e = 0; e < kDpl; ++e)
            acc[ii % kAp][g][e] = fmaf(pi, vf[e], acc[ii % kAp][g][e]);
        }
      }
    }
    __syncwarp();                         // slot and pbuf read: free to reuse
    issue(j + kStages);
  }
  cp_async_wait<0>();

  // ---- merge the 4 warp states (the rings become the accumulators) ----
  __syncthreads();
  float* wacc = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float l = warp_sum(lp[g]);
    if (lane == 0) {
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = l;
    }
    if (pv_live) {
#pragma unroll
      for (int e = 0; e < kDpl; ++e) {
        float sum = acc[0][g][e];
#pragma unroll
        for (int a = 1; a < kAp; ++a) sum += acc[a][g][e];
        wacc[(warp * G + g) * HD + lane * kDpl + e] = sum;
      }
    }
  }
  __syncthreads();
  // split s's state lands in slot s of the first CTA of the cluster
  float* so = reinterpret_cast<float*>(smem + P::kSO);
  float* sm = reinterpret_cast<float*>(smem + P::kSM);
  float* sl = reinterpret_cast<float*>(smem + P::kSL);
  if (nsplit > 1) {
    cluster_wait();
    cg::cluster_group cluster = cg::this_cluster();
    so = cluster.map_shared_rank(so, 0);
    sm = cluster.map_shared_rank(sm, 0);
    sl = cluster.map_shared_rank(sl, 0);
  }
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD, dd = i % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float lsum = 0.f, o = 0.f;
    if (mx != -INFINITY) {                // an empty warp weighs 0
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mw = wm[w * G + g];
        const float wt = mw == -INFINITY ? 0.f : expf(mw - mx);
        lsum += wl[w * G + g] * wt;
        o += wacc[(w * G + g) * HD + dd] * wt;
      }
    }
    if (nsplit == 1) {
      store<HD, G>(out, out_f32, lse, bh, i, dd == 0, mx, lsum, o);
    } else {
      so[split * G * HD + i] = o;
      if (dd == 0) {
        sm[split * G + g] = mx;
        sl[split * G + g] = lsum;
      }
    }
  }
  if (nsplit == 1) return;

  // ---- the first CTA of the cluster merges the splits, in split order ----
  cluster_arrive();                       // this CTA's state is written
  cluster_wait();                         // and every other CTA's
  if (split != 0) return;
  so = reinterpret_cast<float*>(smem + P::kSO);
  sm = reinterpret_cast<float*>(smem + P::kSM);
  sl = reinterpret_cast<float*>(smem + P::kSL);
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD;
    float mx = -INFINITY;
    for (int r = 0; r < nsplit; ++r) mx = fmaxf(mx, sm[r * G + g]);
    float lsum = 0.f, o = 0.f;
    if (mx != -INFINITY) {                // an empty split weighs 0
      for (int r = 0; r < nsplit; ++r) {
        const float mr = sm[r * G + g];
        const float wt = mr == -INFINITY ? 0.f : expf(mr - mx);
        lsum += sl[r * G + g] * wt;
        o += so[r * G * HD + i] * wt;
      }
    }
    store<HD, G>(out, out_f32, lse, bh, i, i % HD == 0, mx, lsum, o);
  }
}

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int32_t* lengths;
  __nv_bfloat16* out;
  float* out_f32;
  float* lse;
  int B, KV, G, S, nsplit, split_len;
  int64_t skb, sks, skh, svb, svs, svh;
  int window, key_offset;
  float sm_scale;
};

template <int HD, int G>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // above 48 KB of dynamic shared memory a kernel must opt in, once per
  // device (a bit per device of this instantiation)
  static unsigned long long opted = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(opted >> dev & 1ull)) {
    err = cudaFuncSetAttribute(decode_kernel<HD, G>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Plan<HD, G>::kBytes);
    if (err != cudaSuccess) return err;
    opted |= 1ull << dev;
  }
  // the splits of one (row, kv head) pair form one cluster
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = a.nsplit;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.KV, a.nsplit);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Plan<HD, G>::kBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, decode_kernel<HD, G>, a.q, a.k, a.v,
                            a.lengths, a.out, a.out_f32, a.lse, a.KV, a.S,
                            a.split_len, a.skb, a.sks, a.skh, a.svb, a.svs,
                            a.svh, a.window, a.key_offset, a.sm_scale);
}

template <int HD>
cudaError_t launch_g(const Args& a, cudaStream_t st) {
  switch (a.G) {
    case 1: return launch<HD, 1>(a, st);
    case 2: return launch<HD, 2>(a, st);
    case 4: return launch<HD, 4>(a, st);
    case 7: return launch<HD, 7>(a, st);
    case 8: return launch<HD, 8>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, KV * G, hd) bf16 contiguous; k/v bf16 addressed as (B, S, KV, hd)
// through the element strides s*b, s*s, s*h (hd stride 1, every row 16-byte
// aligned); lengths (B,) int32 on the device; out like q. The positions are
// cut into nsplit (1 to kMaxSplits) splits of split_len (a multiple of 32),
// the splits of a pair one cluster. window <= 0 means no window. key_offset
// is the global position of local key 0. With a non-null lse ((B, KV * G)
// f32) the output goes to out_f32 ((B, KV * G, hd) f32) instead of out.
// Returns a cudaError_t (0 on success).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, void* out_f32, void* lse, int B, int KV, int G, int S, int hd,
    int nsplit, int split_len, int64_t skb, int64_t sks, int64_t skh,
    int64_t svb, int64_t svs, int64_t svh, int window, int key_offset,
    float sm_scale, void* stream) {
  if (B <= 0 || KV <= 0 || nsplit <= 0 || nsplit > kMaxSplits ||
      split_len <= 0 || split_len % 32 || (lse != nullptr && out_f32 == nullptr))
    return cudaErrorInvalidValue;
  const Args a{static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               static_cast<const int32_t*>(lengths),
               static_cast<__nv_bfloat16*>(out),
               static_cast<float*>(out_f32), static_cast<float*>(lse),
               B, KV, G, S, nsplit, split_len, skb, sks, skh, svb, svs, svh,
               window, key_offset, sm_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:  return launch_g<32>(a, st);
    case 64:  return launch_g<64>(a, st);
    case 80:  return launch_g<80>(a, st);
    case 128: return launch_g<128>(a, st);
    default:  return cudaErrorInvalidValue;
  }
}

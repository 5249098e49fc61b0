// The tensor-core forward body of K1 (`_fwd_kernel` in
// hops_tpu/ops/attention.py; flash_fwd.cu, bf16 calls) and of K5's wide
// bf16 calls (`_decode_q8_kernel`, the int8 engine's admission prefill;
// decode_attention_q8.cu), for Hopper (sm_90a).
//
// What it computes, per query head `bh` = b * h + head of q (b, h, seq_q,
// d) and its kv head `bi * (h / g) + head / g` of (b, h / g, seq_k, d)
// K/V (K1: g = 1):
//   o   = softmax(q k^T * sm_scale, masked) v   (bf16)
//   lse = logsumexp of the masked scaled scores (K1 only: fp32, natural
//         log, -inf when a row sees no key)
// Query row i sits at position i + off and sees the keys at positions
// below kv_len, at or below its own (causal) and within `window`. K1:
// off = q_offset, kv_len = seq_k, causal as asked. K5: off = valid_len[b]
// - seq_q and kv_len = min(valid_len[b], seq_k), read on the device per
// batch row; always causal. A row that sees no key writes o = 0 (and lse
// = -inf).
//
// K5's K/V are int8 with an fp32 scale per key (k_scale, v_scale of shape
// (b * hkv, seq_k)), as the JAX kernel reads them: score = (q . k_int8) *
// k_scale * sm_scale; P.V takes bf16(p * v_scale) against the int8
// values; the running sum l adds the unscaled p. A key at or past kv_len
// scores -inf by a select and gets v_scale 0 by a select, so neither its
// values nor its scales (poisoned in the checks with +-127, NaN and 1e30)
// reach a sum.
//
// What bounds it on this card: at serving prefill and training lengths
// the work is O(seq^2 * d) operations against O(seq * d) bytes (~1000
// operations per byte at K5's admission prefill), so it is bound by
// operations, and only the tensor cores (989 TFLOP/s in bf16) come near
// that bound. Per 64-row warpgroup and 128-key tile the two products take
// ~1024 tensor-core clocks at the peak rate and the softmax (8192 ex2 at
// 16 per clock per SM, the scaling, max, sum and bf16 packs) ~1100 more
// (clock64 stamps on the card); run in turn, they cap a warpgroup near
// half of peak.
//
// Design (flash-attention 3's ping-pong of two consumer warpgroups, with
// its overlap inside a warpgroup):
// - One block per (128 query rows, query head): 256 threads, two
//   warpgroups of 64 rows each. The grid runs over query heads, so no
//   block spans two heads. Causal grids start the latest row tiles (the
//   most keys) first. A block walks only the key tiles its rows see: from
//   the window's edge of its oldest row to min(its newest row's position,
//   kv_len - 1).
// - Turns: in turn k a warpgroup issues S = Q K^T of tile k and O += P V
//   of tile k - 1 back to back (two wgmma groups), waits for S alone,
//   runs tile k's softmax while its P.V runs, then waits for P.V, scales
//   O and packs tile k's P. Its turns alternate with the other
//   warpgroup's (named barriers 1 and 2, `bar.sync` / `bar.arrive` over
//   256 threads), so one warpgroup's softmax also runs while the other's
//   products hold the tensor cores. Turn 0 (no P.V) and turn n (no S) are
//   instantiations of their own: a wgmma on a branch would make ptxas
//   serialize every wgmma. No 256-thread barrier runs per tile. Each warp
//   marks a stage "empty" (an mbarrier, one arrival per warp) once its
//   P.V of the stage's tile is done.
// - bf16 K/V (K1): Q once, then 128-key K and V tiles by TMA straight
//   into the 128-byte-swizzled panels that wgmma reads, through a 3-stage
//   ring (229,376 bytes of tiles at d 128) with full mbarriers for K and
//   V apart, so S can start before V lands. Thread 0 loads Q and tiles
//   0-2; the first thread of warpgroup 1 (whose turns come second) loads
//   tile k + 2 into the stage of tile k - 1 at the end of its turn k, once
//   both warpgroups have emptied it, which by then they nearly always
//   have: the load never holds a warpgroup in lockstep.
// - int8 K/V (K5): TMA copies 64-key int8 K and V tiles (box rows
//   swizzled across their own width, so the widening reads are free of
//   bank conflicts) into a 3-stage staging ring. Each warpgroup widens
//   its half of a tile (32 keys) with the exact `prmt` widening
//   (`widen_s8x4`) into the bf16 swizzled panels of a 4-stage ring, and
//   writes the half's k_scale and v_scale (0 at or past kv_len) beside
//   them; each thread fences its stores into the async proxy, and each
//   warp arrives on the stage's "ready" mbarrier, on which both
//   warpgroups wait before their S. Tile k + 2 is widened while the
//   warpgroup waits on its turn-k products, into the stage of tile k - 2
//   once both have emptied it. The widening holds its registers for one
//   16-byte chunk, never a tile ahead. The first thread of warpgroup 1
//   refills a staging stage once both warpgroups have read it (a
//   per-stage mbarrier). 64-key tiles: at 128 keys the bf16 and int8
//   rings with Q would need 231,424 bytes plus barriers and the 1,024-byte
//   alignment slack, over the 232,448 a block may have; at 64 keys the
//   rings are 208 KB at d 128.
// - S is wgmma m64n{BN}k16 from shared memory (both K-major); the online
//   softmax runs in registers in the log2 domain (sm_scale * log2(e)
//   folded into one FFMA before ex2; lse back in natural log), the max
//   and the sum in four independent chains per row and a row's 4 lanes
//   reducing with shuffles, with `_online_softmax_update`'s -inf guards;
//   P is rounded to bf16 in registers (as JAX rounds p, or p * v_scale,
//   to v's dtype) and is the register A operand of O += P V, m64n{d}k16
//   with V the MN-major B operand. The mask is applied only on a tile
//   that crosses an edge of this warpgroup's rows (kv_len, the diagonal,
//   the window).
// - No atomics: launches are bit-reproducible.

#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace hops {
namespace fwd {

using bf16 = __nv_bfloat16;
using namespace hops::sm90;

constexpr int BM = 128;      // query rows per block: 64 per warpgroup
constexpr int THREADS = 256; // two consumer warpgroups
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Args {
  bf16* o;                 // (b * h, seq_q, D)
  float* lse;              // K1: (b * h, seq_q); K5: null
  const int* valid_len;    // K5: (b,)
  const float* k_scale;    // K5: (b * hkv, seq_k)
  const float* v_scale;
  int seq_q, seq_k;
  int h, g;                // query heads per batch row; query heads per kv head
  float sm_scale;
  int causal, q_offset, window;  // K5: causal, q_offset unused; window <= 0: none
};

// bf16 K/V: 128-key tiles, 3 stages, loaded straight into the panels.
template <int D>
struct SmemBf16 {
  static constexpr int BN = 128, STAGES = 3;
  bf16 q[BM * D];            // D / 64 swizzled panels of BM x 64
  bf16 k[STAGES][BN * D];    // D / 64 swizzled panels of BN x 64
  bf16 v[STAGES][BN * D];
  uint64_t q_full, k_full[STAGES], v_full[STAGES], empty[STAGES];
};

// int8 K/V: 64-key tiles, 3 int8 staging stages, 4 bf16 stages.
template <int D>
struct SmemQ8 {
  static constexpr int BN = 64, STAGES = 4, S8 = 3;
  bf16 q[BM * D];
  bf16 k[STAGES][BN * D];
  bf16 v[STAGES][BN * D];
  int8_t k8[S8][BN * D];     // BN rows of D bytes, each swizzled across its width
  int8_t v8[S8][BN * D];
  float ksc[STAGES][BN];     // k_scale per key, 0 at or past kv_len
  float vsc[STAGES][BN];     // v_scale per key, 0 at or past kv_len
  uint64_t q_full, full8[S8], empty8[S8], ready[STAGES], empty[STAGES];
};

template <int D, bool Q8>
using Smem = typename std::conditional<Q8, SmemQ8<D>, SmemBf16<D>>::type;

template <int D, bool Q8>
constexpr size_t smem_bytes() {
  return sizeof(Smem<D, Q8>) + 1024;  // room to align the base to 1024 bytes
}

// K1: load key tile j into ring stage s (K and V on their own barriers).
template <int D>
__device__ __forceinline__ void load_kv(SmemBf16<D>& sm, const CUtensorMap* tk,
                                        const CUtensorMap* tv, int s, int j, int bhk) {
  constexpr int BN = SmemBf16<D>::BN;
  mbar_arrive_expect_tx(&sm.k_full[s], BN * D * 2);
#pragma unroll
  for (int p = 0; p < D / 64; ++p) tma_load_3d(sm.k[s] + p * BN * 64, tk, &sm.k_full[s], p * 64, j * BN, bhk);
  mbar_arrive_expect_tx(&sm.v_full[s], BN * D * 2);
#pragma unroll
  for (int p = 0; p < D / 64; ++p) tma_load_3d(sm.v[s] + p * BN * 64, tv, &sm.v_full[s], p * 64, j * BN, bhk);
}

// K5: load int8 key tile j into staging stage s (K and V on one barrier).
template <int D>
__device__ __forceinline__ void load_kv8(SmemQ8<D>& sm, const CUtensorMap* tk,
                                         const CUtensorMap* tv, int s, int j, int bhk) {
  constexpr int BN = SmemQ8<D>::BN;
  mbar_arrive_expect_tx(&sm.full8[s], 2 * BN * D);
  tma_load_3d(sm.k8[s], tk, &sm.full8[s], 0, j * BN, bhk);
  tma_load_3d(sm.v8[s], tv, &sm.full8[s], 0, j * BN, bhk);
}

// Byte offset of 16-byte chunk c of row r in an int8 staging tile as the
// TMA wrote it (each D-byte row swizzled across its width).
template <int D>
__device__ __forceinline__ int s8_chunk(int r, int c) {
  return D == 128 ? r * 128 + 16 * (c ^ (r % 8)) : r * 64 + 16 * (c ^ ((r >> 1) % 4));
}

// K5: the scale this thread writes for its warpgroup's half of tile t
// (threads 0-31 k_scale, 32-63 v_scale of keys wg * 32 + t % 32), 0 at or
// past kv_len; loaded early so its latency hides under the S product.
template <int D>
__device__ __forceinline__ float half_scale(const Args& a, int t, int wg, int tile, int bhk,
                                           int kv_len) {
  const int kpos = tile * SmemQ8<D>::BN + wg * 32 + t % 32;
  if (t >= 64 || kpos >= kv_len) return 0.f;
  const float* src = t < 32 ? a.k_scale : a.v_scale;
  return __ldg(src + static_cast<size_t>(bhk) * a.seq_k + kpos);
}

// K5: warpgroup wg widens its half (keys wg * 32 .. + 31) of the int8
// tile in staging stage s8 (tile t of the block's walk) into bf16 stage
// s, writes the half's scale, then marks the staging stage read and the
// bf16 stage ready (one arrival per warp on each).
template <int D>
__device__ __forceinline__ void widen_half(SmemQ8<D>& sm, int s8, uint32_t parity8, int s,
                                           int wg, int t, float scale) {
  constexpr int BN = SmemQ8<D>::BN;
  constexpr int CPR = D / 16;         // 16-byte int8 chunks per key row
  constexpr int NCH = 32 * CPR / 128; // chunks of K (and of V) per thread
  mbar_wait(&sm.full8[s8], parity8);
#pragma unroll
  for (int m = 0; m < NCH; ++m) {
    // Eight neighbouring threads take eight rows of one column chunk: the
    // swizzled reads and the swizzled bf16 stores both hit 8 banks groups.
    const int i = t + 128 * m;
    const int kk = wg * 32 + i % 32;
    const int c = i / 32;
    const int at = s8_chunk<D>(kk, c);
    const uint4 kx = *reinterpret_cast<const uint4*>(sm.k8[s8] + at);
    const uint4 vx = *reinterpret_cast<const uint4*>(sm.v8[s8] + at);
    put_s8x16(sm.k[s], kk, c, BN, kx);
    put_s8x16(sm.v[s], kk, c, BN, vx);
  }
  if (t < 64) (t < 32 ? sm.ksc[s] : sm.vsc[s])[wg * 32 + t % 32] = scale;
  fence_proxy_async();
  __syncwarp();
  if (t % 32 == 0) {
    mbar_arrive(&sm.empty8[s8]);
    mbar_arrive(&sm.ready[s]);
  }
}

template <int D, bool Q8>
__global__ void __launch_bounds__(THREADS, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, const Args a) {
  using S = Smem<D, Q8>;
  constexpr int BN = S::BN;
  constexpr int STAGES = S::STAGES;
  extern __shared__ uint8_t smem_raw[];
  S& sm = *reinterpret_cast<S*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int bh = blockIdx.x;
  const int bi = bh / a.h;
  const int bhk = bi * (a.h / a.g) + (bh % a.h) / a.g;
  const int causal = Q8 ? 1 : a.causal;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BM;
  int off = a.q_offset, kv_len = a.seq_k;
  if constexpr (Q8) {
    const int vl = a.valid_len[bi];
    off = vl - a.seq_q;
    kv_len = max(min(vl, a.seq_k), 0);
  }

  // The key tiles the block's rows see: [lo, lo + n).
  const int kmax = causal ? min(q0 + BM - 1 + off, kv_len - 1) : kv_len - 1;
  const int lo = causal && a.window > 0 ? max(q0 + off - a.window + 1, 0) / BN : 0;
  const int n = kmax >= 0 ? max(kmax / BN + 1 - lo, 0) : 0;
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(bh) * a.seq_q;
  if (n == 0) {  // no row sees a key: o = 0, lse = -inf
    const int nrows = min(BM, a.seq_q - q0);
    bf16* o = a.o + (base + q0) * D;
    for (int i = tid; i < nrows * D / 8; i += THREADS)
      reinterpret_cast<uint4*>(o)[i] = make_uint4(0, 0, 0, 0);
    if (!Q8 && tid < nrows) a.lse[base + q0 + tid] = -INFINITY;
    return;
  }

  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
    if constexpr (Q8) {
      for (int s = 0; s < S::S8; ++s) {
        mbar_init(&sm.full8[s], 1);
        mbar_init(&sm.empty8[s], 8);  // one arrival per warp
      }
      for (int s = 0; s < STAGES; ++s) mbar_init(&sm.ready[s], 8);
    } else {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&sm.k_full[s], 1);
        mbar_init(&sm.v_full[s], 1);
      }
    }
    for (int s = 0; s < STAGES; ++s) mbar_init(&sm.empty[s], 8);  // one arrival per warp
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(&sm.q_full, BM * D * 2);
    for (int p = 0; p < D / 64; ++p) tma_load_3d(sm.q + p * BM * 64, &tq, &sm.q_full, p * 64, q0, bh);
    if constexpr (Q8) {
      for (int j = 0; j < S::S8 && j < n; ++j) load_kv8<D>(sm, &tk, &tv, j, lo + j, bhk);
    } else {
      for (int j = 0; j < STAGES && j < n; ++j) load_kv<D>(sm, &tk, &tv, j, lo + j, bhk);
    }
  }
  __syncwarp();

  const int wg = tid / 128;
  const int t = tid % 128;
  const int lane = tid % 32;
  const int r0 = wg * 64 + t / 32 * 16 + lane / 4;  // rows r0, r0 + 8
  const int c0 = 2 * (lane % 4);  // first column of each 8-column group
  const int wq0 = q0 + wg * 64;   // this warpgroup's first row
  const float scale_log2 = a.sm_scale * LOG2E;

  // K5: widen tile tt of the walk (this warpgroup's half), then (the
  // refilling thread) load tile tt + S8 into the staging stage it read.
  [[maybe_unused]] auto widen = [&](int tt, float scale) {
    if constexpr (Q8) {
      if (tt >= n) return;
      const int s8 = tt % S::S8;
      // Its bf16 stage held tile tt - STAGES, which both warpgroups release.
      if (tt >= STAGES) mbar_wait(&sm.empty[tt % STAGES], ((tt - STAGES) / STAGES) & 1);
      widen_half<D>(sm, s8, (tt / S::S8) & 1, tt % STAGES, wg, t, scale);
      if (tid == 128 && tt + S::S8 < n) {
        mbar_wait(&sm.empty8[s8], (tt / S::S8) & 1);
        load_kv8<D>(sm, &tk, &tv, s8, lo + tt + S::S8, bhk);
      }
      __syncwarp();
    }
  };
  if constexpr (Q8) {
    widen(0, half_scale<D>(a, t, wg, lo, bhk, kv_len));
    widen(1, half_scale<D>(a, t, wg, lo + 1, bhk, kv_len));
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
  float l[2] = {0.f, 0.f};              // this lane's share of the running sum

  // Tile kt's softmax on its raw scores x (int8: each column times its
  // key's k_scale first): -inf by a select where the key is masked, only
  // on a tile that crosses an edge of this warpgroup's rows; then the
  // online softmax in the log2 domain (the -inf guards of
  // `_online_softmax_update`), the max and the sum in four independent
  // chains per row. Leaves p in x and each row's alpha.
  auto softmax = [&](int kt, float (&x)[BN / 2], float (&alpha)[2]) {
    // Raw scores (int8: each column times its key's k_scale); -inf by a
    // select where the key is masked, only on a tile that crosses an edge
    // of this warpgroup's rows.
    const int k0 = (lo + kt) * BN;
    const int s = kt % STAGES;
    const bool edge = k0 + BN > kv_len ||
                      (causal && (k0 + BN - 1 > wq0 + off ||
                                  (a.window > 0 && wq0 + 63 + off - k0 >= a.window)));
    if constexpr (Q8) {
#pragma unroll
      for (int i = 0; i < BN / 2; i += 2) {
        const float2 ks = *reinterpret_cast<const float2*>(&sm.ksc[s][8 * (i / 4) + c0]);
        x[i] *= ks.x;
        x[i + 1] *= ks.y;
      }
    }
    if (edge) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int kpos = k0 + 8 * (i / 4) + c0 + (i & 1);
        const int qpos = q0 + r0 + 8 * ((i >> 1) & 1) + off;
        const bool vis = (kpos < kv_len) & (!causal | ((qpos >= kpos) &
                                                      ((a.window <= 0) | (qpos - kpos < a.window))));
        x[i] = vis ? x[i] : -INFINITY;
      }
    }

    // Online softmax in the log2 domain (the -inf guards of
    // `_online_softmax_update`); the max and the sum in four independent
    // chains per row.
    float m_safe[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx4[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int c = (i & 1) + 2 * ((i / 4) & 1);
        if (((i >> 1) & 1) == h) mx4[c] = fmaxf(mx4[c], x[i]);
      }
      float mx = fmaxf(fmaxf(mx4[0], mx4[1]), fmaxf(mx4[2], mx4[3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * scale_log2);
      m_safe[h] = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = ex2(m[h] - m_safe[h]);  // 0 while the row has seen no key
      m[h] = m_new;
    }
    float sum[2][4] = {};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int h = (i >> 1) & 1;
      x[i] = ex2(fmaf(x[i], scale_log2, -m_safe[h]));
      sum[h][(i & 1) + 2 * ((i / 4) & 1)] += x[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
      l[h] = l[h] * alpha[h] + ((sum[h][0] + sum[h][1]) + (sum[h][2] + sum[h][3]));
  };

  mbar_wait(&sm.q_full, 0);
  const uint64_t desc_q = desc_sw128(sm.q + wg * 64 * 64, 16);
  float sc[BN / 2];        // tile k's scores, then its p (fp32)
  uint32_t pa[BN / 16][4]; // tile k - 1's p (int8: p * v_scale) in bf16, P.V's A operand
  if (wg == 1) named_bar_arrive(1, THREADS);  // warpgroup 0 takes the first turn
  // Turn k issues S of tile k and P.V of tile k - 1 back to back, in this
  // warpgroup's turn, then runs tile k's softmax while its own P.V and the
  // other warpgroup's turn hold the tensor cores. Turn 0 has no P.V and
  // turn n no S; each is its own instantiation, so no wgmma sits on a
  // branch (which would make ptxas serialize them).
  auto turn = [&](int k, auto has_s, auto has_pv) {
    constexpr bool HS = decltype(has_s)::value, HP = decltype(has_pv)::value;
    const int s = k % STAGES;
    const int sp = (k + STAGES - 1) % STAGES;  // tile k - 1's stage
    const uint32_t ph = (k / STAGES) & 1;
    [[maybe_unused]] float next_scale = 0.f;
    if constexpr (Q8) {
      next_scale = k + 2 < n ? half_scale<D>(a, t, wg, lo + k + 2, bhk, kv_len) : 0.f;
      if constexpr (HS) mbar_wait(&sm.ready[s], ph);
    } else {
      if constexpr (HS) mbar_wait(&sm.k_full[s], ph);
      if constexpr (HP) mbar_wait(&sm.v_full[sp], ((k - 1) / STAGES) & 1);
    }
    named_bar_sync(1 + wg, THREADS);
    // S = Q K^T over tile k (raw scores, 64 rows x BN keys), then O += P V
    // over tile k - 1 (acc already scaled by its alpha), as two groups:
    // tile k's softmax runs as soon as S is done, under P.V (flash-
    // attention 3's overlap inside a warpgroup) and under the other
    // warpgroup's turn.
    wgmma_fence();
    if constexpr (HS) {
      const uint64_t desc_k = desc_sw128(sm.k[s], 16);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc, desc_q + (((kk / 4) * BM * 128 + (kk % 4) * 32) >> 4),
                 desc_k + (((kk / 4) * BN * 128 + (kk % 4) * 32) >> 4), kk > 0);
      wgmma_commit();
    }
    if constexpr (HP) {
      const uint64_t desc_v = desc_sw128(sm.v[sp], BN * 128);
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc) wgmma_rs(acc, pa[kc], desc_v + ((kc * 16 * 128) >> 4), 1);
      wgmma_commit();
    }
    if (wg == 0 || HS) named_bar_arrive(2 - wg, THREADS);  // the other's turn
    if constexpr (Q8) widen(k + 2, next_scale);  // under this turn's products
    [[maybe_unused]] float alpha[2];
    if constexpr (HS) {
      if constexpr (HP) wgmma_wait<1>(); else wgmma_wait<0>();
      fence_regs(sc);
      softmax(k, sc, alpha);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    if constexpr (HP) {
      __syncwarp();  // this warp is done with tile k - 1
      if (lane == 0) mbar_arrive(&sm.empty[sp]);
      if constexpr (!Q8) {
        // Both warpgroups done with tile k - 1: its stage takes tile k + 2.
        if (tid == 128 && k + 2 < n) {
          mbar_wait(&sm.empty[sp], ((k - 1) / STAGES) & 1);
          load_kv<D>(sm, &tk, &tv, sp, lo + k + 2, bhk);
        }
        __syncwarp();
      }
    }
    if constexpr (HS) {
      // Scale O for the next turn's P.V; P in bf16 (int8: times each key's
      // v_scale; l took the unscaled p).
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float p0 = sc[8 * kc + 2 * r], p1 = sc[8 * kc + 2 * r + 1];
          if constexpr (Q8) {
            const float2 vs = *reinterpret_cast<const float2*>(&sm.vsc[s][8 * (2 * kc + r / 2) + c0]);
            p0 *= vs.x;
            p1 *= vs.y;
          }
          pa[kc][r] = pack_bf16(p0, p1);
        }
    }
  };
  turn(0, std::true_type{}, std::false_type{});
  for (int k = 1; k < n; ++k) turn(k, std::true_type{}, std::true_type{});
  turn(n, std::false_type{}, std::true_type{});

  // Finalize: the row sums over its 4 lanes; o = acc / l, lse.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = q0 + r0 + 8 * h;
    if (row >= a.seq_q) continue;
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
    const float inv = 1.f / l_safe;
    bf16* orow = a.o + (base + row) * D;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn)
      *reinterpret_cast<uint32_t*>(orow + 8 * jn + c0) =
          pack_bf16(acc[4 * jn + 2 * h] * inv, acc[4 * jn + 2 * h + 1] * inv);
    if (!Q8 && lane % 4 == 0)
      a.lse[base + row] = m[h] == -INFINITY ? -INFINITY : (m[h] + log2f(l_safe)) * LN2;
  }
}

template <int D, bool Q8>
int launch_body(const void* q, const void* k, const void* v, const Args& a, int bh, int bhkv,
                cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = encode_rows_map(&tq, q, D, a.seq_q, bh, BM);
  if constexpr (Q8) {
    if (!err) err = encode_s8_rows_map(&tk, k, D, a.seq_k, bhkv, SmemQ8<D>::BN);
    if (!err) err = encode_s8_rows_map(&tv, v, D, a.seq_k, bhkv, SmemQ8<D>::BN);
  } else {
    if (!err) err = encode_rows_map(&tk, k, D, a.seq_k, bhkv, SmemBf16<D>::BN);
    if (!err) err = encode_rows_map(&tv, v, D, a.seq_k, bhkv, SmemBf16<D>::BN);
  }
  if (err) return err;
  const size_t smem = smem_bytes<D, Q8>();
  cudaError_t e = cudaFuncSetAttribute(fwd_kernel<D, Q8>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(bh, (a.seq_q + BM - 1) / BM);
  fwd_kernel<D, Q8><<<grid, THREADS, smem, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory (bytes) of the body at head_dim, or -1 for a
// head_dim it does not take.
inline int smem_bytes_at(int head_dim, bool q8) {
  if (head_dim == 64) return static_cast<int>(q8 ? smem_bytes<64, true>() : smem_bytes<64, false>());
  if (head_dim == 128) return static_cast<int>(q8 ? smem_bytes<128, true>() : smem_bytes<128, false>());
  return -1;
}

}  // namespace fwd
}  // namespace hops

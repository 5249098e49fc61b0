// Tensor-core body of the paged decode kernels' wide bf16 calls, in
// hops_tpu/ops/attention.py: K6, `_paged_decode_kernel` (the 256-token
// prefill chunk fused into a paged engine step, over bf16 pools), and K7,
// `_paged_decode_q8_kernel` (the same over int8 pools). A call is wide
// when rows = g*s > 16. Decode calls (rows <= 16) take the split-K body
// of decode_split.cuh; fp32 wide calls the 64-row FMA body of
// decode_rows.cuh. KV is the pools' element type (bf16, or int8 with
// fp32 scales). (K5's wide calls, on the dense int8 cache, run the
// forward body of flash_fwd_tc.cuh.)
//
// What it computes: K1's causal attention (flash_fwd.cu) with three
// differences. Query row r of (batch b, kv head h) is head h*g + r / s at
// position valid_len[b] - s + r % s, valid_len read on the device, so
// each batch row has its own offset. Key kpos comes from storage row
// (h*nblocks + pages[b, kpos / page]) * page + kpos % page
// (`split::tile_rows`, decode_rows.cuh's `key_row` rule). A key at or
// past valid_len, or behind a table entry outside [0, nblocks), is never
// read (its copies are zero-fills) and scores -inf, so the scratch block
// 0 stays unreachable.
//
// What bounds it on this card: a 256-token chunk does 4*d operations per
// visible (query, key) pair against 4*d bytes of bf16 K and V per key
// (2*d + 8 for int8), so 128 to 256 operations per byte of bf16 K and V
// (a key before the chunk is seen by all its rows, a key inside it by
// half on average), plus the chunk's own q and o: under the card's
// balance of ~295 operations per byte in bf16, so the bytes bound it
// with the operations close behind, and only the tensor cores (989
// TFLOP/s, against 67 of fp32 FMA) come near either. The 64-row FMA
// body these calls ran on before ran at fp32 FMA rate on 64 x 64 tiles
// staged in fp32.
//
// Design:
// - One block per (64 query rows, batch*kv_head): one warpgroup, 128
//   threads. At the served chunk (4 slots x 8 kv heads x 256 rows) that
//   is 128 blocks for 132 SMs, one wave; 128-row blocks would give 64.
//   The wave is uneven: a block of the slot at valid_len 1532 walks ~23
//   key tiles, one of a 256-token slot ~3. A split of the long rows' key
//   ranges, merged by a combine as the split body does, would even it
//   out at the cost of a second launch and fp32 partials; it is left for
//   later. A block walks only the key tiles its rows see: from the
//   window's edge of its oldest row to its newest row's position, below
//   valid_len. The grid starts the latest row tiles (the most keys)
//   first.
// - TMA cannot gather rows through a table, so every thread moves
//   16-byte chunks, each key row resolved through the page table as the
//   split body does, into the 128-byte-swizzled bf16 panels that
//   `desc_sw128` reads (`sw128`). Any page size works. Q (64 x d) is
//   copied once by cp.async. bf16 K/V tiles of 64 keys are copied by
//   cp.async through a 2-stage ring, tile t + 2 issued as soon as tile t
//   is done. Each thread fences its stores or completed copies into the
//   async proxy (`fence_proxy_async`) before the barrier that hands them
//   to wgmma.
// - int8 tiles: TMA cannot convert and cp.async cannot widen, so each
//   thread loads its 16-byte int8 chunks (16 values) and the scales of
//   its keys into registers (`ld.global.nc`), and after the current
//   tile's products converts them to bf16 (exact: |x| <= 127) and stores
//   them with st.shared into the other stage's panels; the loads of the
//   tile after are issued right then, so they fly while a whole tile
//   computes. The fp32 k_scale and v_scale of each key are staged beside
//   `kok`, 0 for a key without a storage row.
// - S = Q K^T is wgmma m64n64k16 from shared memory (both K-major). int8:
//   each score column is multiplied by its key's k_scale first. The
//   online softmax runs in fp32 registers in the log2 domain, each row's
//   4 lanes reducing by shuffles, with `_online_softmax_update`'s -inf
//   guards; every tile is masked per row (causal position, window, a key
//   without a storage row). P (int8: P times each key's v_scale) is
//   rounded to bf16 in registers, as the JAX kernel rounds p (p *
//   p_scale) to v's dtype, and is the register A operand of O += P V,
//   m64n{d}k16 with V the MN-major B operand. The running sum l adds the
//   unrounded, unscaled p. A row that sees no key ends with l == 0 and
//   writes 0.

#pragma once

#include <type_traits>

#include "decode_split.cuh"
#include "hopper.cuh"

namespace hops {
namespace chunk {

using bf16 = __nv_bfloat16;
using namespace hops::sm90;

constexpr int BM = 64;      // query rows per block: one warpgroup
constexpr int BN = 64;      // keys per tile
constexpr int NT = 128;     // threads per block
constexpr int STAGES = 2;   // K/V ring depth
constexpr float LOG2E = 1.4426950408889634f;

template <int D, bool Q8>
struct Smem {
  bf16 q[BM * D];          // D / 64 swizzled panels of BM x 64
  bf16 k[STAGES][BN * D];  // D / 64 swizzled panels of BN x 64
  bf16 v[STAGES][BN * D];
  int kok[STAGES][BN];     // key has a storage row
  float ksc[STAGES][Q8 ? BN : 1];  // int8: k_scale per key (0 without a storage row)
  float vsc[STAGES][Q8 ? BN : 1];  // int8: v_scale per key
};

template <int D, bool Q8>
constexpr size_t smem_bytes() {
  return sizeof(Smem<D, Q8>) + 1024;  // room to align the base to 1024 bytes
}

// Copy the block's nrows query rows (rows D elements apart) into the
// swizzled Q tile; rows past nrows are zero-filled.
template <int D>
__device__ __forceinline__ void issue_q(bf16* qs, const bf16* q, int nrows, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < BM * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = r < nrows;
    split::cp_async16(qs + sw128(r, c, BM), q + (ok ? static_cast<size_t>(r) * D + c * 8 : 0), ok);
  }
}

// bf16 K/V: start the copies of the key tile at logical position k0 into
// the swizzled ks/vs; kok[kk] says whether key kk has a storage row.
// Each thread copies one 16-byte column of every STEP-th key.
template <int D>
__device__ __forceinline__ void issue_kv(bf16* ks, bf16* vs, int* kok, const decode::Args& a,
                                         const bf16* k, const bf16* v, int bi, int hk, int k0,
                                         int kv_len, int tid) {
  constexpr int CPR = D / 8;      // 16-byte chunks per key row
  constexpr int STEP = NT / CPR;  // keys between a thread's rows
  constexpr int NR = BN / STEP;   // key rows per thread
  const int c = tid % CPR;
  const int kk0 = tid / CPR;
  long long ri[NR];
  split::tile_rows<true, NR, STEP>(ri, a, bi, hk, k0 + kk0, kv_len);
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int kk = kk0 + j * STEP;
    const bool ok = ri[j] >= 0;
    const size_t at = ok ? static_cast<size_t>(ri[j]) * D + c * 8 : 0;
    split::cp_async16(ks + sw128(kk, c, BN), k + at, ok);
    split::cp_async16(vs + sw128(kk, c, BN), v + at, ok);
    if (c == 0) kok[kk] = ok;
  }
}

// int8 K/V: one thread's share of a key tile, held in registers between
// its loads (`load`) and its conversion into the bf16 panels (`store`).
// Each thread keeps one 16-byte column (16 values) of every STEP-th key,
// and the thread of column 0 also the key's scales.
template <int D>
struct Q8Tile {
  static constexpr int CPR = D / 16;      // 16-byte int8 chunks per key row
  static constexpr int STEP = NT / CPR;   // keys between a thread's rows
  static constexpr int NR = BN / STEP;    // key rows per thread
  uint4 k[NR], v[NR];
  float ks[NR], vs[NR];  // column-0 threads: the keys' scales, 0 without a storage row
  int ok;                // bit j: key row j has a storage row

  __device__ __forceinline__ void load(const decode::Args& a, const int8_t* kp, const int8_t* vp,
                                       int bi, int hk, int k0, int kv_len, int tid) {
    const int c = tid % CPR;
    long long ri[NR];
    split::tile_rows<true, NR, STEP>(ri, a, bi, hk, k0 + tid / CPR, kv_len);
    ok = 0;
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const bool has = ri[j] >= 0;
      const size_t at = has ? static_cast<size_t>(ri[j]) * D + c * 16 : 0;
      k[j] = has ? __ldg(reinterpret_cast<const uint4*>(kp + at)) : make_uint4(0, 0, 0, 0);
      v[j] = has ? __ldg(reinterpret_cast<const uint4*>(vp + at)) : make_uint4(0, 0, 0, 0);
      ks[j] = c == 0 && has ? __ldg(a.k_scale + ri[j]) : 0.f;
      vs[j] = c == 0 && has ? __ldg(a.v_scale + ri[j]) : 0.f;
      ok |= has << j;
    }
  }

  __device__ __forceinline__ void store(bf16* kd, bf16* vd, int* kok, float* ksc, float* vsc,
                                        int tid) const {
    const int c = tid % CPR;
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int kk = tid / CPR + j * STEP;
      put_s8x16(kd, kk, c, BN, k[j]);
      put_s8x16(vd, kk, c, BN, v[j]);
      if (c == 0) {
        kok[kk] = (ok >> j) & 1;
        ksc[kk] = ks[j];
        vsc[kk] = vs[j];
      }
    }
  }
};

template <int D, typename KV>
__global__ void __launch_bounds__(NT, 1) chunk_kernel(const decode::Args a) {
  constexpr bool Q8 = std::is_same<KV, int8_t>::value;
  extern __shared__ uint8_t smem_raw[];
  Smem<D, Q8>& sm = *reinterpret_cast<Smem<D, Q8>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const KV* k = static_cast<const KV*>(a.k);
  const KV* v = static_cast<const KV*>(a.v);
  const int tid = threadIdx.x;
  const int bhk = blockIdx.y;
  const int bi = bhk / a.hkv;
  const int hk = bhk % a.hkv;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int nrows = min(BM, a.rows - row0);
  const int s = a.s;
  const int vl = a.valid_len[bi];
  const int kv_len = min(vl, a.cap);

  // The tile's rows sit at positions vl - s + (row0 + r) % s: their
  // offsets in the chunk run from off0 up, or wrap (GQA: the next head's
  // rows) and cover the whole chunk.
  const int off0 = row0 % s;
  const bool wraps = off0 + nrows > s;
  const int newest = min(vl - s + (wraps ? s - 1 : off0 + nrows - 1), kv_len - 1);
  const int oldest = vl - s + (wraps ? 0 : off0);
  const int t_lo = a.window > 0 ? max(oldest - a.window + 1, 0) / BN : 0;
  const int n = newest >= 0 ? newest / BN + 1 - t_lo : 0;

  const size_t orow0 = static_cast<size_t>(bhk) * a.rows + row0;
  bf16* o = static_cast<bf16*>(a.o) + orow0 * D;
  if (n <= 0) {  // no row sees a key: o = 0
    for (int i = tid; i < nrows * D / 8; i += NT) reinterpret_cast<uint4*>(o)[i] = make_uint4(0, 0, 0, 0);
    return;
  }

  issue_q<D>(sm.q, static_cast<const bf16*>(a.q) + orow0 * D, nrows, tid);
  [[maybe_unused]] Q8Tile<D> next;  // int8: the next tile, in registers
  if constexpr (Q8) {
    split::cp_async_commit();  // Q
    next.load(a, k, v, bi, hk, t_lo * BN, kv_len, tid);
    next.store(sm.k[0], sm.v[0], sm.kok[0], sm.ksc[0], sm.vsc[0], tid);
    if (n > 1) next.load(a, k, v, bi, hk, (t_lo + 1) * BN, kv_len, tid);
  } else {
    for (int i = 0; i < STAGES; ++i) {
      if (i < n)
        issue_kv<D>(sm.k[i], sm.v[i], sm.kok[i], a, k, v, bi, hk, (t_lo + i) * BN, kv_len, tid);
      split::cp_async_commit();  // Q rides in tile 0's group
    }
  }

  const int lane = tid % 32;
  const int r0 = tid / 32 * 16 + lane / 4;  // rows r0, r0 + 8
  const int c0 = 2 * (lane % 4);            // first column of each 8-column group
  // Row r0 + 8h sees keys [lo[h], hi[h]]; a row past nrows sees none.
  int hi[2], lo[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + r0 + 8 * h;
    hi[h] = r < a.rows ? vl - s + r % s : -1;
    lo[h] = a.window > 0 ? hi[h] - a.window + 1 : 0;
  }
  const float scale_log2 = a.sm_scale * LOG2E;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
  float l[2] = {0.f, 0.f};              // this lane's share of the running sum
  const uint64_t desc_q = desc_sw128(sm.q, 16);

  for (int it = 0; it < n; ++it) {
    const int st = it % STAGES;
    const int k0 = (t_lo + it) * BN;
    if constexpr (Q8)
      split::cp_async_wait<0>();  // this thread's copies of Q
    else
      split::cp_async_wait<STAGES - 1>();  // this thread's copies of tile it (and Q)
    fence_proxy_async();
    __syncthreads();  // ... and every other thread's copies or stores

    // S = Q K^T (raw scores), 64 rows x BN keys.
    float sc[BN / 2];
    const uint64_t desc_k = desc_sw128(sm.k[st], 16);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, desc_q + (((kk / 4) * BM * 128 + (kk % 4) * 32) >> 4),
               desc_k + (((kk / 4) * BN * 128 + (kk % 4) * 32) >> 4), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // Mask per row, scale into the log2 domain (int8: each column by its
    // key's k_scale first, as the JAX kernel).
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int col = 8 * (i / 4) + c0 + (i & 1);
      const int kpos = k0 + col;
      const int h = (i >> 1) & 1;
      const bool vis = sm.kok[st][col] && kpos <= hi[h] && kpos >= lo[h];
      float x = sc[i];
      if constexpr (Q8) x *= sm.ksc[st][col];
      sc[i] = vis ? x * scale_log2 : -INFINITY;
    }

    // Online softmax (the -inf guards of `_online_softmax_update`).
    float alpha[2], m_safe[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        if (((i >> 1) & 1) == h) mx = fmaxf(mx, sc[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      m_safe[h] = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = ex2(m[h] - m_safe[h]);  // 0 while the row has seen no key
      m[h] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      sc[i] = ex2(sc[i] - m_safe[(i >> 1) & 1]);
      sum[(i >> 1) & 1] += sc[i];
    }
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];

    // O = O * alpha + P V, with P in bf16 as the register A operand
    // (int8: P times each key's v_scale; l took the unscaled p).
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float p0 = sc[8 * kc + 2 * r], p1 = sc[8 * kc + 2 * r + 1];
        if constexpr (Q8) {
          const float2 vs2 =
              *reinterpret_cast<const float2*>(&sm.vsc[st][8 * (2 * kc + r / 2) + c0]);
          p0 *= vs2.x;
          p1 *= vs2.y;
        }
        pa[kc][r] = pack_bf16(p0, p1);
      }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    const uint64_t desc_v = desc_sw128(sm.v[st], BN * 128);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) wgmma_rs(acc, pa[kc], desc_v + ((kc * 16 * 128) >> 4), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    if constexpr (Q8) {
      // Tile it + 1 (loaded during this tile) into the other stage, whose
      // last reader (tile it - 1) every thread finished before this
      // tile's barrier; then the loads of tile it + 2.
      if (it + 1 < n) {
        const int nx = (it + 1) % STAGES;
        next.store(sm.k[nx], sm.v[nx], sm.kok[nx], sm.ksc[nx], sm.vsc[nx], tid);
        if (it + 2 < n) next.load(a, k, v, bi, hk, k0 + 2 * BN, kv_len, tid);
      }
    } else {
      __syncthreads();  // every thread is done with stage st
      if (it + STAGES < n)
        issue_kv<D>(sm.k[st], sm.v[st], sm.kok[st], a, k, v, bi, hk, k0 + STAGES * BN,
                           kv_len, tid);
      split::cp_async_commit();
    }
  }

  // Finalize: the row sums over its 4 lanes; o = acc / l.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = r0 + 8 * h;
    if (r >= nrows) continue;
    const float inv = 1.f / (l[h] == 0.f ? 1.f : l[h]);
    bf16* orow = o + static_cast<size_t>(r) * D;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn)
      *reinterpret_cast<uint32_t*>(orow + 8 * jn + c0) =
          pack_bf16(acc[4 * jn + 2 * h] * inv, acc[4 * jn + 2 * h + 1] * inv);
  }
}

template <int D, typename KV>
int launch(const decode::Args& a, int bhkv, cudaStream_t stream) {
  const size_t smem = smem_bytes<D, std::is_same<KV, int8_t>::value>();
  cudaError_t err = cudaFuncSetAttribute(chunk_kernel<D, KV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  chunk_kernel<D, KV><<<dim3((a.rows + BM - 1) / BM, bhkv), NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Check the sizes and launch the body for (cache type, head_dim);
// bf16 queries only. Returns 0 or a cudaError_t code.
template <bool Q8>
int dispatch(const decode::Args& a, int b, int head_dim, void* stream) {
  using KV = typename std::conditional<Q8, int8_t, bf16>::type;
  const long long bhkv = (long long)b * a.hkv;
  if (b < 1 || a.hkv < 1 || bhkv > 65535 || a.rows < 1 || a.s < 1 || a.rows % a.s || a.cap < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch<64, KV>(a, (int)bhkv, st);
  if (head_dim == 128) return launch<128, KV>(a, (int)bhkv, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory (bytes) of the body at head_dim, or -1 for a
// head_dim it does not take.
inline int smem_bytes_at(int head_dim, bool q8) {
  if (head_dim == 64) return static_cast<int>(q8 ? smem_bytes<64, true>() : smem_bytes<64, false>());
  if (head_dim == 128) return static_cast<int>(q8 ? smem_bytes<128, true>() : smem_bytes<128, false>());
  return -1;
}

}  // namespace chunk
}  // namespace hops

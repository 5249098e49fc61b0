// Flash-attention forward for Hopper (sm_90a): the port of K1,
// `_fwd_kernel` in hops_tpu/ops/attention.py (launched by `_fwd_call`).
//
// Computes, per (batch*head) row of q/k/v laid out (bh, seq, head_dim):
//   o   = softmax(q k^T * sm_scale, masked) v      (in the input dtype)
//   lse = logsumexp of the masked scaled scores     (fp32, natural log,
//                                                    -inf when a row
//                                                    sees no key)
// with the causal mask placing query row i at key position
// i + q_offset, and an optional sliding window (query p sees keys
// [p - window + 1, p]).
//
// What bounds it on this card: at serving prefill and training lengths
// (hundreds to thousands of tokens) the work is O(seq^2 * d) operations
// against O(seq * d) bytes, so it is bound by operations, and only the
// tensor cores (989 TFLOP/s in bf16, against 67 TFLOP/s of fp32 FMA) come
// near that bound. With the bf16 body below it runs at about a third of
// that bound: within a warpgroup the two products and the softmax take
// turns (no overlap of one tile's softmax with the next tile's S).
//
// Two bodies; the entry point picks one by `is_bf16` alone, so a bf16
// call never reaches the FMA body, and either body's launch failure is
// returned to the caller, which raises:
//
// bf16 (the served weights and the train step's compute): tensor cores.
// - One block per (128-row q tile, batch*head), 256 threads: two
//   warpgroups own 64 query rows each. Thread 0 also issues the TMA
//   loads. There is no producer warp: built under a 288- or 384-thread
//   launch bound (and with setmaxnreg), the d-128 body spilled; at 256
//   threads it fits (phase 2 of chip_smoke.py prints its registers and
//   spills). The cost: the load of tile it + 1 waits until both
//   warpgroups have released tile it - 1, so the two run in near
//   lockstep.
// - Q is loaded once; 128-key K and V tiles flow through a 2-stage ring,
//   each stage guarded by full (K, V) and empty mbarriers. Tiles are
//   128-byte swizzled (hopper.cuh); the tensor maps are 3-D (d, seq, bh),
//   so rows past a head's end read as zeros, never the next head's.
// - S = Q K^T is wgmma m64n128k16 from shared memory (both K-major); the
//   online softmax runs in registers in the log2 domain (sm_scale *
//   log2(e) folded in; lse converted back to natural log), a row's 4
//   lanes reducing with shuffles; P is rounded to bf16 in registers (as
//   JAX rounds p to v's dtype) and is the register A operand of
//   O += P V, m64n{d}k16 with V the MN-major B operand.
// - Tiles are skipped exactly as `_block_runs` decides at these tile
//   sizes; the in-tile mask (`_causal_mask`, window, the seq_k tail) is
//   applied only on tiles that cross an edge. A row that sees no key ends
//   with l == 0 and writes o = 0 and lse = -inf. Causal grids start the
//   longest q tiles first. No atomics: launches are bit-reproducible.
//
// fp32 (the checks' type: TF32 tensor cores would lose their digits):
// the first version's FMA body, for fp32 alone.
// - One thread block per (64-row q tile, batch*head); 256 threads as a
//   16 x 16 grid, each thread owning a 4-row x 4-column patch of the
//   64 x 64 score tile and 4 rows x head_dim/16 columns of the output.
// - K/V tiles of 64 keys are staged through shared memory in fp32 (the
//   K tile padded by one column so the score loop is free of bank
//   conflicts); the q tile is loaded once.
// - Tiles outside the causal band or below the sliding window are
//   skipped, exactly as `_block_runs` decides; the in-tile mask is
//   `_causal_mask`. Ragged tails of seq_q and seq_k are masked here, so
//   any length runs on the kernel (no divisibility requirement).
// - Online softmax with fp32 running max/sum/accumulators and the
//   -inf guards of `_online_softmax_update`: a fully masked row ends
//   with l == 0, finalize divides by l_safe = 1 and writes 0, never NaN.

#include "common.cuh"
#include "hopper.cuh"

#include <math.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block (16 x 16)

template <int D>
constexpr size_t flash_smem_bytes() {
  return (size_t)(BQ * D + BK * (D + 1) + BK * D + BQ * BK) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int seq_q, int seq_k,
                 float sm_scale, int causal, int q_offset, int window) {
  extern __shared__ float smem[];
  float* qs = smem;                // BQ x D
  float* ks = qs + BQ * D;         // BK x (D + 1)
  float* vs = ks + BK * (D + 1);   // BK x D
  float* ps = vs + BK * D;         // BQ x BK

  constexpr int CO = D / 16;  // output columns per thread
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const float* qb = q + (bh * seq_q + q0) * D;
  const float* kb = k + bh * seq_k * D;
  const float* vb = v + bh * seq_k * D;

  hops::load_tile<float, D>(qs, D, qb, BQ, seq_q - q0, tid, NT);

  float acc[4][CO];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;
  }

  const int nk = (seq_k + BK - 1) / BK;
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * BK;
    // _block_runs: skip tiles past the diagonal and tiles whose newest
    // key is older than the window of the tile's oldest query.
    if (causal) {
      if (!(k0 < q0 + BQ + q_offset)) continue;
      if (window > 0 && !(k0 + BK - 1 >= q0 + q_offset - (window - 1))) continue;
    }
    __syncthreads();  // readers of the previous tile are done
    hops::load_tile<float, D>(ks, D + 1, kb + (size_t)k0 * D, BK, seq_k - k0, tid, NT);
    hops::load_tile<float, D>(vs, D, vb + (size_t)k0 * D, BK, seq_k - k0, tid, NT);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * D + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      const int qpos = q0 + row + q_offset;
      const bool row_ok = q0 + row < seq_q;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool vis = row_ok && kpos < seq_k;
        if (causal) {
          vis = vis && qpos >= kpos;
          if (window > 0) vis = vis && qpos - kpos < window;
        }
        s[i][j] = vis ? s[i][j] * sm_scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // The 16 threads sharing this row are lanes of one half-warp.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = (m[i] == -INFINITY) ? 0.f : expf(m[i] - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_safe);
        ps[row * BK + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CO; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * BK + kk];
#pragma unroll
      for (int c = 0; c < CO; ++c) {
        const float vv = vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= seq_q) continue;
    const float l_safe = (l[i] == 0.f) ? 1.f : l[i];
    float* orow = o + (bh * seq_q + row) * D;
#pragma unroll
    for (int c = 0; c < CO; ++c) orow[tx + 16 * c] = acc[i][c] / l_safe;
    if (tx == 0)
      lse[bh * seq_q + row] = (m[i] == -INFINITY) ? -INFINITY : m[i] + logf(l_safe);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int seq_q, int seq_k, float sm_scale, int causal,
           int q_offset, int window, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq_q + BQ - 1) / BQ, bh);
  flash_fwd_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, seq_q, seq_k, sm_scale, causal, q_offset, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor-core body
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace hops::sm90;

constexpr int BM = 128;      // query rows per block: 64 per warpgroup
constexpr int BN = 128;      // keys per tile
constexpr int STAGES = 2;    // K/V ring depth
constexpr int THREADS = 256; // two warpgroups; thread 0 also issues the loads
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Smem {
  bf16 q[BM * D];            // D / 64 swizzled panels of BM x 64
  bf16 k[STAGES][BN * D];    // D / 64 swizzled panels of BN x 64
  bf16 v[STAGES][BN * D];
  uint64_t q_full, k_full[STAGES], v_full[STAGES], empty[STAGES];
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(Smem<D>) + 1024;  // room to align the base to 1024 bytes
}

// Load key tile j into ring stage s (K and V on their own barriers, so
// S = Q K^T can start before V lands).
template <int D>
__device__ __forceinline__ void load_kv(Smem<D>& sm, const CUtensorMap* tk, const CUtensorMap* tv,
                                        int s, int j, int bh) {
  mbar_arrive_expect_tx(&sm.k_full[s], BN * D * 2);
#pragma unroll
  for (int p = 0; p < D / 64; ++p) tma_load_3d(sm.k[s] + p * BN * 64, tk, &sm.k_full[s], p * 64, j * BN, bh);
  mbar_arrive_expect_tx(&sm.v_full[s], BN * D * 2);
#pragma unroll
  for (int p = 0; p < D / 64; ++p) tma_load_3d(sm.v[s] + p * BN * 64, tv, &sm.v_full[s], p * 64, j * BN, bh);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
           float* __restrict__ lse, int seq_q, int seq_k, float sm_scale, int causal,
           int q_offset, int window) {
  extern __shared__ uint8_t smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int bh = blockIdx.x;
  const int q0 = (causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * BM;

  // The key tiles `_block_runs` keeps form one range [lo, lo + n).
  const int nk = (seq_k + BN - 1) / BN;
  int lo = 0, hi = nk;
  if (causal) {
    hi = 0;
    for (int j = 0; j < nk; ++j) {
      const int k0 = j * BN;
      if (k0 < q0 + BM + q_offset &&
          (window <= 0 || k0 + BN - 1 >= q0 + q_offset - (window - 1))) {
        if (hi == 0) lo = j;
        hi = j + 1;
      }
    }
  }
  const int n = hi - lo;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], 8);  // one arrival per warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&sm.q_full, BM * D * 2);
    for (int p = 0; p < D / 64; ++p) tma_load_3d(sm.q + p * BM * 64, &tq, &sm.q_full, p * 64, q0, bh);
    for (int it = 0; it < STAGES && it < n; ++it) load_kv<D>(sm, &tk, &tv, it, lo + it, bh);
  }
  __syncwarp();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int r0 = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // rows r0, r0 + 8
  const int c0 = 2 * (lane % 4);  // first column of each 8-column group
  const float scale_log2 = sm_scale * LOG2E;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 domain
  float l[2] = {0.f, 0.f};              // this lane's share of the running sum

  mbar_wait(&sm.q_full, 0);
  const uint64_t desc_q = desc_sw128(sm.q + wg * 64 * 64, 16);
  for (int it = 0; it < n; ++it) {
    const int s = it % STAGES;
    const uint32_t ph = (it / STAGES) & 1;
    const int k0 = (lo + it) * BN;
    // Refill the stage tile it - 1 used with tile it + 1, once both
    // warpgroups have released it.
    if (threadIdx.x == 0 && it >= 1 && it + 1 < n) {
      const int sr = (it + 1) % STAGES;
      mbar_wait(&sm.empty[sr], ((it - 1) / STAGES) & 1);
      load_kv<D>(sm, &tk, &tv, sr, lo + it + 1, bh);
    }
    __syncwarp();

    // S = Q K^T (raw scores), 64 rows x BN keys per warpgroup.
    float sc[BN / 2];
    mbar_wait(&sm.k_full[s], ph);
    const uint64_t desc_k = desc_sw128(sm.k[s], 16);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, desc_q + (((kk / 4) * BM * 128 + (kk % 4) * 32) >> 4),
               desc_k + (((kk / 4) * BN * 128 + (kk % 4) * 32) >> 4), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // Scale into the log2 domain; mask only a tile that crosses an edge.
    const bool edge = k0 + BN > seq_k ||
                      (causal && (k0 + BN - 1 > q0 + q_offset ||
                                  (window > 0 && q0 + BM - 1 + q_offset - k0 >= window)));
    if (edge) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int kpos = k0 + 8 * (i / 4) + c0 + (i & 1);
        const int qpos = q0 + r0 + 8 * ((i >> 1) & 1) + q_offset;
        bool vis = kpos < seq_k;
        if (causal) vis = vis && qpos >= kpos && (window <= 0 || qpos - kpos < window);
        sc[i] = vis ? sc[i] * scale_log2 : -INFINITY;
      }
    } else {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) sc[i] *= scale_log2;
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

    // O = O * alpha + P V, with P in bf16 as the register A operand.
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kc][r] = pack_bf16(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    mbar_wait(&sm.v_full[s], ph);
    const uint64_t desc_v = desc_sw128(sm.v[s], BN * 128);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) wgmma_rs(acc, pa[kc], desc_v + ((kc * 16 * 128) >> 4), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

  // Finalize: the row sums over its 4 lanes; o = acc / l, lse.
  const size_t base = static_cast<size_t>(bh) * seq_q;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = q0 + r0 + 8 * h;
    if (row >= seq_q) continue;
    const float l_safe = l[h] == 0.f ? 1.f : l[h];
    const float inv = 1.f / l_safe;
    bf16* orow = o + (base + row) * D;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn)
      *reinterpret_cast<uint32_t*>(orow + 8 * jn + c0) =
          pack_bf16(acc[4 * jn + 2 * h] * inv, acc[4 * jn + 2 * h + 1] * inv);
    if (lane % 4 == 0)
      lse[base + row] = m[h] == -INFINITY ? -INFINITY : (m[h] + log2f(l_safe)) * LN2;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
           int seq_q, int seq_k, float sm_scale, int causal, int q_offset, int window,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = encode_rows_map(&tq, q, D, seq_q, bh, BM);
  if (!err) err = encode_rows_map(&tk, k, D, seq_k, bh, BN);
  if (!err) err = encode_rows_map(&tv, v, D, seq_k, bh, BN);
  if (err) return err;
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(bh, (seq_q + BM - 1) / BM);
  fwd_kernel<D><<<grid, THREADS, smem, stream>>>(tq, tk, tv, static_cast<bf16*>(o), lse, seq_q,
                                                 seq_k, sm_scale, causal, q_offset, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

// q: (bh, seq_q, head_dim); k, v: (bh, seq_k, head_dim); o like q;
// lse: (bh, seq_q) fp32. All contiguous on the current device.
// is_bf16: 1 for bfloat16, 0 for float32. window <= 0 means none.
// Returns 0 or a cudaError_t code (cudaErrorInvalidValue for a
// configuration the kernel does not take).
int hops_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                   int bh, int seq_q, int seq_k, int head_dim, int is_bf16,
                   float sm_scale, int causal, int q_offset, int window,
                   void* stream) {
  if (bh < 1 || bh > 65535 || seq_q < 1 || seq_k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (is_bf16) {
    if (head_dim == 64)
      return tc::launch<64>(q, k, v, o, l, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
    if (head_dim == 128)
      return tc::launch<128>(q, k, v, o, l, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
  } else {
    if (head_dim == 64)
      return launch<64>(q, k, v, o, l, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
    if (head_dim == 128)
      return launch<128>(q, k, v, o, l, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory (bytes) of the body that a call with this
// head_dim and dtype launches, or -1 for a configuration it does not take.
int hops_flash_fwd_smem_bytes(int head_dim, int is_bf16) {
  if (head_dim == 64) return static_cast<int>(is_bf16 ? tc::smem_bytes<64>() : flash_smem_bytes<64>());
  if (head_dim == 128) return static_cast<int>(is_bf16 ? tc::smem_bytes<128>() : flash_smem_bytes<128>());
  return -1;
}

const char* hops_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Flash-attention backward, dk and dv, for Hopper (sm_90a): the port of
// K3, `_bwd_dkv_kernel` in hops_tpu/ops/attention.py (launched by
// `_flash_bwd`).
//
// Computes, per (batch*head) row of q/k/v/do laid out (bh, seq, head_dim):
//   p  = exp(q k^T * sm_scale - lse)      (0 where masked, and where the
//                                          row's lse is -inf)
//   ds = p * (do v^T - delta) * sm_scale
//   dv = p^T do,  dk = ds^T q             (written in the input dtype)
// from the forward's fp32 lse and delta = rowsum(o * do), both
// (bh, seq_q), with the forward's causal/window/q_offset masking.
//
// What bounds it on this card: four products of O(seq_q * seq_k * d)
// (s and dp are recomputed here, then dv and dk) against O(seq * d)
// bytes: bound by operations, the heaviest of the three attention
// kernels, and only the tensor cores come near that bound. With the
// bf16 body below it runs at about a third of that bound: within a
// warpgroup the products and the P/dS arithmetic take turns, and the
// two warpgroups advance in near lockstep.
//
// Two bodies; the entry point picks one by `is_bf16` alone, so a bf16
// call never reaches the FMA body, and either body's launch failure is
// returned to the caller, which raises:
//
// bf16 (the train step's compute): tensor cores.
// - The flash-attention-2 split: one block per (128-key tile,
//   batch*head) owns its dk/dv rows and loops over 64-row q tiles, so no
//   block needs another's state and there are no atomics (launches are
//   bit-reproducible). 256 threads: two warpgroups own 64 keys each;
//   thread 0 also issues the TMA loads. K and V are loaded once; Q and
//   dO tiles, with their lse and delta, stream through a 2-stage ring
//   (full/empty mbarriers). There is no producer warp: built under a
//   288- or 384-thread launch bound (and with setmaxnreg), the d-128 body
//   spilled; at 256 threads it fits (phase 2 of chip_smoke.py prints its
//   registers and spills). The cost: the load of tile it + 1 waits until
//   both warpgroups have released tile it - 1.
// - Per q tile, in two halves of 32 queries (so that dK, dV and one
//   half's scores fit the registers): S^T = K Q^T and dP^T = V dO^T by
//   wgmma m64n32k16 from shared memory (all K-major); P^T and dS^T in
//   registers, P^T while dP^T is still in flight; then dV += P^T dO and
//   dK += dS^T Q by wgmma m64n{d}k16 with bf16 register A operands and
//   dO, Q the MN-major B operands from the same shared tiles. P^T and
//   dS^T are rounded to bf16 for those products, as flash-attention 2
//   and 3 do (JAX forms both in fp32); chip_smoke.py phase 3b holds the
//   body to the bound that rounding allows, and its phase 7b to the
//   plain bf16 path's gradient distance. Entering dS^T as a bf16 head
//   plus a remainder (one more product) cost 11% in time and moved no
//   parameter's ratio to that distance by more than 0.011. dK and dV stay
//   in fp32 registers across the q loop.
// - lse and delta come by TMA too, from flat 1-D maps over
//   (bh * seq_q): a box must start 16-byte aligned, so each tile's box
//   starts at its first row rounded down to a multiple of 4 and is 4
//   values longer. Rows of a tail tile past seq_q read the next head's
//   values (their Q and dO rows are zeros) and are masked.
// - q tiles are skipped as `_block_runs` decides at these tile sizes,
//   and a warpgroup whose 64 keys no query of the tile sees skips its
//   products; the in-tile mask (causal, window, both tails) is applied
//   only on tiles that cross an edge, and a row whose lse is -inf sees
//   no key, so its tiles always cross one. Every key row of the tile is
//   written, so a key that no query sees gets dk = dv = 0.
//
// fp32 (the checks' type: TF32 tensor cores would lose their digits):
// the first version's FMA body, for fp32 alone.
// - The same split: one thread block per (64-key tile, batch*head)
//   loops over the q tiles; dk and dv stay in fp32 registers across it
//   (4 keys x head_dim/16 columns each per thread).
// - 256 threads as a 16 x 16 grid; each owns a 4-key x 4-query patch of
//   the transposed 64 x 64 score tile. K and V are loaded once; q and do
//   tiles, with their lse and delta, are staged through shared memory
//   in fp32 (padded by one column for the score loop), and p^T and ds^T
//   go through shared memory into the two products.
// - q tiles outside the causal band or below the window are skipped as
//   `_block_runs` decides; the in-tile mask is `_causal_mask`; ragged
//   tails are masked here. Every key row of the tile is written, so a
//   key that no query sees (a window, a negative q_offset) gets
//   dk = dv = 0, never uninitialised memory.

#include "common.cuh"
#include "hopper.cuh"

#include <math.h>

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per block
constexpr int NT = 256;  // threads per block (16 x 16)

template <int D>
constexpr size_t dkv_smem_bytes() {
  return (size_t)(2 * BK * D + 2 * BQ * (D + 1) + 2 * BK * BQ + 2 * BQ) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int seq_q, int seq_k,
                     float sm_scale, int causal, int q_offset, int window) {
  extern __shared__ float smem[];
  float* ks = smem;                 // BK x D
  float* vs = ks + BK * D;          // BK x D
  float* qs = vs + BK * D;          // BQ x (D + 1)
  float* dos = qs + BQ * (D + 1);   // BQ x (D + 1)
  float* ps = dos + BQ * (D + 1);   // BK x BQ  (p^T)
  float* dss = ps + BK * BQ;        // BK x BQ  (ds^T)
  float* ls = dss + BK * BQ;        // BQ
  float* dls = ls + BQ;             // BQ

  constexpr int CO = D / 16;  // dk/dv columns per thread
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k0 = blockIdx.x * BK;
  const size_t bh = blockIdx.y;
  const float* qb = q + bh * seq_q * D;
  const float* gb = dout + bh * seq_q * D;

  hops::load_tile<float, D>(ks, D, k + (bh * seq_k + k0) * D, BK, seq_k - k0, tid, NT);
  hops::load_tile<float, D>(vs, D, v + (bh * seq_k + k0) * D, BK, seq_k - k0, tid, NT);

  float dk_acc[4][CO], dv_acc[4][CO];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CO; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int nq = (seq_q + BQ - 1) / BQ;
  for (int qi = 0; qi < nq; ++qi) {
    const int q0 = qi * BQ;
    if (causal) {  // _block_runs
      if (!(k0 < q0 + BQ + q_offset)) continue;
      if (window > 0 && !(k0 + BK - 1 >= q0 + q_offset - (window - 1))) continue;
    }
    __syncthreads();  // readers of the previous q tile are done
    hops::load_tile<float, D>(qs, D + 1, qb + (size_t)q0 * D, BQ, seq_q - q0, tid, NT);
    hops::load_tile<float, D>(dos, D + 1, gb + (size_t)q0 * D, BQ, seq_q - q0, tid, NT);
    if (tid < BQ) {
      const bool ok = q0 + tid < seq_q;
      ls[tid] = ok ? lse[bh * seq_q + q0 + tid] : -INFINITY;
      dls[tid] = ok ? delta[bh * seq_q + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];  // [key i][query j]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = ks[(ty * 4 + i) * D + d];
        vv[i] = vs[(ty * 4 + i) * D + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = qs[(tx + 16 * j) * (D + 1) + d];
        gv[j] = dos[(tx + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], gv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = ty * 4 + i;
      const int kpos = k0 + key;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const int qpos = q0 + col + q_offset;
        const float l = ls[col];
        bool vis = kpos < seq_k && q0 + col < seq_q && l != -INFINITY;
        if (causal) {
          vis = vis && qpos >= kpos;
          if (window > 0) vis = vis && qpos - kpos < window;
        }
        const float p = vis ? expf(s[i][j] * sm_scale - l) : 0.f;
        ps[key * BQ + col] = p;
        dss[key * BQ + col] = p * (dp[i][j] - dls[col]) * sm_scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[(ty * 4 + i) * BQ + qq];
        dsv[i] = dss[(ty * 4 + i) * BQ + qq];
      }
#pragma unroll
      for (int c = 0; c < CO; ++c) {
        const float gvv = dos[qq * (D + 1) + tx + 16 * c];
        const float qvv = qs[qq * (D + 1) + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][c] = fmaf(pv[i], gvv, dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dsv[i], qvv, dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= seq_k) continue;
    float* dkr = dk + (bh * seq_k + key) * D;
    float* dvr = dv + (bh * seq_k + key) * D;
#pragma unroll
    for (int c = 0; c < CO; ++c) {
      dkr[tx + 16 * c] = dk_acc[i][c];
      dvr[tx + 16 * c] = dv_acc[i][c];
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv, int bh,
           int seq_q, int seq_k, float sm_scale, int causal, int q_offset,
           int window, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq_k + BK - 1) / BK, bh);
  flash_bwd_dkv_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk), static_cast<float*>(dv),
      seq_q, seq_k, sm_scale, causal, q_offset, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor-core body
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace hops::sm90;

constexpr int BM = 64;       // query rows per tile
constexpr int BN = 128;      // keys per block: 64 per warpgroup
constexpr int STAGES = 2;    // Q/dO ring depth
constexpr int THREADS = 256; // two warpgroups; thread 0 also issues the loads
constexpr int ROWS = BM + 4;  // lse/delta values per tile: BM, from a 16-byte-aligned start
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  bf16 k[BN * D];            // D / 64 swizzled panels of BN x 64
  bf16 v[BN * D];
  bf16 q[STAGES][BM * D];    // D / 64 swizzled panels of BM x 64
  bf16 g[STAGES][BM * D];    // dO
  float lse[STAGES][96];      // ROWS values from the aligned start (128-byte slots)
  float delta[STAGES][96];
  uint64_t kv_full, full[STAGES], empty[STAGES];
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(Smem<D>) + 1024;  // room to align the base to 1024 bytes
}

struct Maps {
  CUtensorMap q, k, v, g, lse, delta;
};

// Load q tile i (Q, dO and their lse and delta) into ring stage s. The
// lse/delta maps are flat over (bh * seq_q), so their boxes start at the
// tile's first row rounded down to a multiple of 4 (the tile's values
// sit (bh * seq_q + i * BM) % 4 further on); rows of a tail tile past
// seq_q read the next head's values, and the mask drops them.
template <int D>
__device__ __forceinline__ void load_q(Smem<D>& sm, const Maps& t, int s, int i, int bh, int seq_q) {
  mbar_arrive_expect_tx(&sm.full[s], 2 * BM * D * 2 + 2 * ROWS * 4);
#pragma unroll
  for (int p = 0; p < D / 64; ++p) {
    tma_load_3d(sm.q[s] + p * BM * 64, &t.q, &sm.full[s], p * 64, i * BM, bh);
    tma_load_3d(sm.g[s] + p * BM * 64, &t.g, &sm.full[s], p * 64, i * BM, bh);
  }
  const int start = (bh * seq_q + i * BM) & ~3;
  tma_load_1d(sm.lse[s], &t.lse, &sm.full[s], start);
  tma_load_1d(sm.delta[s], &t.delta, &sm.full[s], start);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
dkv_kernel(const __grid_constant__ Maps maps, bf16* __restrict__ dk_out,
           bf16* __restrict__ dv_out, int seq_q, int seq_k, float sm_scale, int causal,
           int q_offset, int window) {
  extern __shared__ uint8_t smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BN;

  // The q tiles `_block_runs` keeps form one range [lo, lo + n).
  const int nq = (seq_q + BM - 1) / BM;
  int lo = 0, hi = nq;
  if (causal) {
    hi = 0;
    for (int i = 0; i < nq; ++i) {
      const int q0 = i * BM;
      if (k0 < q0 + BM + q_offset &&
          (window <= 0 || k0 + BN - 1 >= q0 + q_offset - (window - 1))) {
        if (hi == 0) lo = i;
        hi = i + 1;
      }
    }
  }
  const int n = hi - lo;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 8);  // one arrival per warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&sm.kv_full, 2 * BN * D * 2);
    for (int p = 0; p < D / 64; ++p) {
      tma_load_3d(sm.k + p * BN * 64, &maps.k, &sm.kv_full, p * 64, k0, bh);
      tma_load_3d(sm.v + p * BN * 64, &maps.v, &sm.kv_full, p * 64, k0, bh);
    }
    for (int it = 0; it < STAGES && it < n; ++it) load_q<D>(sm, maps, it, lo + it, bh, seq_q);
  }
  __syncwarp();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int kr0 = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // keys kr0, kr0 + 8
  const int c0 = 2 * (lane % 4);  // first query column of each 8-column group
  const int kw0 = k0 + wg * 64;   // this warpgroup's first key
  const float scale_log2 = sm_scale * LOG2E;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(&sm.kv_full, 0);
  const uint64_t desc_k = desc_sw128(sm.k + wg * 64 * 64, 16);
  const uint64_t desc_v = desc_sw128(sm.v + wg * 64 * 64, 16);
  for (int it = 0; it < n; ++it) {
    const int s = it % STAGES;
    const int q0 = (lo + it) * BM;
    // Refill the stage tile it - 1 used with tile it + 1, once both
    // warpgroups have released it.
    if (threadIdx.x == 0 && it >= 1 && it + 1 < n) {
      const int sr = (it + 1) % STAGES;
      mbar_wait(&sm.empty[sr], ((it - 1) / STAGES) & 1);
      load_q<D>(sm, maps, sr, lo + it + 1, bh, seq_q);
    }
    __syncwarp();
    mbar_wait(&sm.full[s], (it / STAGES) & 1);

    // Does any query of the tile see one of this warpgroup's 64 keys?
    bool runs = kw0 < seq_k;
    if (causal)
      runs = runs && kw0 < q0 + BM + q_offset &&
             (window <= 0 || kw0 + 63 >= q0 + q_offset - (window - 1));
    if (runs) {
      const bool edge = kw0 + 64 > seq_k || q0 + BM > seq_q ||
                        (causal && (kw0 + 63 > q0 + q_offset ||
                                    (window > 0 && q0 + BM - 1 + q_offset - kw0 >= window)));
      const uint64_t desc_q = desc_sw128(sm.q[s], 16);  // K-major: S^T, dP^T
      const uint64_t desc_g = desc_sw128(sm.g[s], 16);
      const uint64_t desc_qm = desc_sw128(sm.q[s], BM * 128);  // MN-major: dK, dV
      const uint64_t desc_gm = desc_sw128(sm.g[s], BM * 128);
      const int off = (bh * seq_q + q0) & 3;
      const float* ls = sm.lse[s] + off;
      const float* dls = sm.delta[s] + off;
      // Two halves of 32 queries, one after the other: dK, dV and the
      // scores of one half fit the registers.
#pragma unroll
      for (int hq = 0; hq < 2; ++hq) {
        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 32 queries each.
        float sc[16], dp[16];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(sc, desc_k + (((kk / 4) * BN * 128 + (kk % 4) * 32) >> 4),
                   desc_q + ((hq * 32 * 128 + (kk / 4) * BM * 128 + (kk % 4) * 32) >> 4), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(dp, desc_v + (((kk / 4) * BN * 128 + (kk % 4) * 32) >> 4),
                   desc_g + ((hq * 32 * 128 + (kk / 4) * BM * 128 + (kk % 4) * 32) >> 4), kk > 0);
        wgmma_commit();

        // P^T = exp(S^T * sm_scale - lse), while dP^T is in flight.
        wgmma_wait<1>();
        fence_regs(sc);
#pragma unroll
        for (int e = 0; e < 16; ++e)
          sc[e] = ex2(fmaf(sc[e], scale_log2, -ls[32 * hq + 8 * (e / 4) + c0 + (e & 1)] * LOG2E));
        if (edge) {
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const int kpos = k0 + kr0 + 8 * ((e >> 1) & 1);
            const int qrow = q0 + 32 * hq + 8 * (e / 4) + c0 + (e & 1);
            const int qpos = qrow + q_offset;
            bool vis = kpos < seq_k && qrow < seq_q;
            if (causal) vis = vis && qpos >= kpos && (window <= 0 || qpos - kpos < window);
            if (!vis) sc[e] = 0.f;
          }
        }

        // dS^T = P^T * (dP^T - delta) * sm_scale.
        wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int e = 0; e < 16; ++e)
          dp[e] = sc[e] * (dp[e] - dls[32 * hq + 8 * (e / 4) + c0 + (e & 1)]) * sm_scale;

        // dV += P^T dO and dK += dS^T Q, with P^T and dS^T rounded to
        // bf16 as the register A operands.
        uint32_t pa[2][4], da[2][4];
#pragma unroll
        for (int kc = 0; kc < 2; ++kc)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            pa[kc][r] = pack_bf16(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1]);
            da[kc][r] = pack_bf16(dp[8 * kc + 2 * r], dp[8 * kc + 2 * r + 1]);
          }
        wgmma_fence();
#pragma unroll
        for (int kc = 0; kc < 2; ++kc)
          wgmma_rs(dv, pa[kc], desc_gm + (((32 * hq + 16 * kc) * 128) >> 4), 1);
#pragma unroll
        for (int kc = 0; kc < 2; ++kc)
          wgmma_rs(dk, da[kc], desc_qm + (((32 * hq + 16 * kc) * 128) >> 4), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + kr0 + 8 * h;
    if (key >= seq_k) continue;
    const size_t at = (static_cast<size_t>(bh) * seq_k + key) * D;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn) {
      *reinterpret_cast<uint32_t*>(dk_out + at + 8 * jn + c0) =
          pack_bf16(dk[4 * jn + 2 * h], dk[4 * jn + 2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dv_out + at + 8 * jn + c0) =
          pack_bf16(dv[4 * jn + 2 * h], dv[4 * jn + 2 * h + 1]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dk, void* dv, int bh, int seq_q, int seq_k,
           float sm_scale, int causal, int q_offset, int window, cudaStream_t stream) {
  Maps maps;
  const long long rows = static_cast<long long>(bh) * seq_q;
  int err = encode_rows_map(&maps.q, q, D, seq_q, bh, BM);
  if (!err) err = encode_rows_map(&maps.g, dout, D, seq_q, bh, BM);
  if (!err) err = encode_rows_map(&maps.k, k, D, seq_k, bh, BN);
  if (!err) err = encode_rows_map(&maps.v, v, D, seq_k, bh, BN);
  if (!err) err = encode_vector_map(&maps.lse, lse, rows, ROWS);
  if (!err) err = encode_vector_map(&maps.delta, delta, rows, ROWS);
  if (err) return err;
  if (rows + BM > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(bh, (seq_k + BN - 1) / BN);
  dkv_kernel<D><<<grid, THREADS, smem, stream>>>(maps, static_cast<bf16*>(dk),
                                                 static_cast<bf16*>(dv), seq_q, seq_k, sm_scale,
                                                 causal, q_offset, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

// q, do: (bh, seq_q, head_dim); k, v, dk, dv: (bh, seq_k, head_dim);
// lse, delta: (bh, seq_q) fp32. All contiguous on the current device.
// is_bf16: 1 for bfloat16, 0 for float32. window <= 0 means none.
// Returns 0 or a cudaError_t code (cudaErrorInvalidValue for a
// configuration the kernel does not take).
int hops_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int bh,
                       int seq_q, int seq_k, int head_dim, int is_bf16, float sm_scale,
                       int causal, int q_offset, int window, void* stream) {
  if (bh < 1 || bh > 65535 || seq_q < 1 || seq_k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (is_bf16) {
    if (head_dim == 64)
      return tc::launch<64>(q, k, v, dout, l, dl, dk, dv, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
    if (head_dim == 128)
      return tc::launch<128>(q, k, v, dout, l, dl, dk, dv, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
  } else {
    if (head_dim == 64)
      return launch<64>(q, k, v, dout, l, dl, dk, dv, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
    if (head_dim == 128)
      return launch<128>(q, k, v, dout, l, dl, dk, dv, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory (bytes) of the body that a call with this
// head_dim and dtype launches, or -1 for a configuration it does not take.
int hops_flash_bwd_dkv_smem_bytes(int head_dim, int is_bf16) {
  if (head_dim == 64) return static_cast<int>(is_bf16 ? tc::smem_bytes<64>() : dkv_smem_bytes<64>());
  if (head_dim == 128) return static_cast<int>(is_bf16 ? tc::smem_bytes<128>() : dkv_smem_bytes<128>());
  return -1;
}

const char* hops_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

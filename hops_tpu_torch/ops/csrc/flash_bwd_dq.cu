// Flash-attention backward, dq, for Hopper (sm_90a): the port of K2,
// `_bwd_dq_kernel` in hops_tpu/ops/attention.py (launched by `_flash_bwd`).
//
// Computes, per (batch*head) row of q/k/v/do laid out (bh, seq, head_dim):
//   p  = exp(q k^T * sm_scale - lse)      (0 where masked, and where the
//                                          row's lse is -inf)
//   ds = p * (do v^T - delta) * sm_scale
//   dq = ds k                             (written in the input dtype)
// from the forward's fp32 lse and delta = rowsum(o * do), both
// (bh, seq_q). Masking is the forward's: query row i at key position
// i + q_offset, optional sliding window.
//
// What bounds it on this card: three products of O(seq_q * seq_k * d)
// each (s, dp, dq) against O(seq * d) bytes, so at training lengths it
// is bound by operations, and only the tensor cores come near that
// bound.
//
// Two bodies; the entry point picks one by `is_bf16` alone, so a bf16
// call never reaches the FMA body, and either body's launch failure is
// returned to the caller, which raises:
//
// bf16 (the train step's compute): tensor cores, on the design of K1's
// forward body (flash_fwd.cu) mirrored for the backward.
// - The flash-attention-2 dq split: one block per (128-query tile,
//   batch*head) owns its dq rows and loops over 64-key tiles, so no
//   block needs another's state and there are no atomics (launches are
//   bit-reproducible). 256 threads: two warpgroups own 64 query rows
//   each; thread 0 also issues the TMA loads (no producer warp: K1's and
//   K3's bodies spilled at d128 under a 288- or 384-thread launch bound). Q
//   and dO are loaded once; K and V stream through a 2-stage ring
//   (full/empty mbarriers). Each row's lse and delta are read once into
//   registers.
// - Per key tile: S = Q K^T and dP = dO V^T by wgmma m64n64k16 from
//   shared memory (all K-major), dP issued before P is computed;
//   P = exp2(S * sm_scale * log2e - lse * log2e) and
//   dS = P * (dP - delta) * sm_scale in registers; then dQ += dS K by
//   wgmma m64n{d}k16 with dS rounded to bf16 as the register A operand
//   (the layout of K1's P V) and K the MN-major B operand from the same
//   shared tile. Rounding dS is what flash-attention 2 and 3 do (JAX
//   keeps it fp32); chip_smoke.py phase 3b holds the body to the bound
//   that rounding allows. dQ stays in fp32 registers across the loop.
// - Key tiles are visited as `_block_runs` keeps them at these tile
//   sizes (one range [lo, hi) per query tile); the in-tile mask (causal,
//   window, the key tail) is applied only on tiles that cross an edge. A
//   row whose lse is -inf (it sees no key) enters with lse * log2e =
//   +inf, so its p is 0 on every tile and it writes dq = 0; query rows
//   past seq_q are TMA zeros with p = 0 and are not written.
//
// fp32 (the checks' type: TF32 tensor cores would lose their digits):
// the first version's FMA body, for fp32 alone.
// - The same split at 64-row q tiles; dq stays in fp32 registers
//   across the key loop (4 rows x head_dim/16 columns per thread).
// - 256 threads as a 16 x 16 grid, each owning a 4 x 4 patch of the
//   64 x 64 score tile. q and do are loaded once; K and V tiles are
//   staged through shared memory, padded by one column so the score
//   loop is free of bank conflicts. ds goes through shared memory into
//   the dq product.
// - Tiles outside the causal band or below the window are skipped as
//   `_block_runs` decides; the in-tile mask is `_causal_mask`. Ragged
//   seq_q/seq_k tails are masked here. A row that sees no key has
//   lse == -inf, gets p = 0 and writes dq = 0.

#include "common.cuh"
#include "hopper.cuh"

#include <math.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block (16 x 16)

template <int D>
constexpr size_t dq_smem_bytes() {
  return (size_t)(2 * BQ * D + 2 * BK * (D + 1) + BQ * BK) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int seq_q, int seq_k, float sm_scale,
                    int causal, int q_offset, int window) {
  extern __shared__ float smem[];
  float* qs = smem;                 // BQ x D
  float* dos = qs + BQ * D;         // BQ x D
  float* ks = dos + BQ * D;         // BK x (D + 1)
  float* vs = ks + BK * (D + 1);    // BK x (D + 1)
  float* dss = vs + BK * (D + 1);   // BQ x BK

  constexpr int CO = D / 16;  // dq columns per thread
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const float* kb = k + bh * seq_k * D;
  const float* vb = v + bh * seq_k * D;

  hops::load_tile<float, D>(qs, D, q + (bh * seq_q + q0) * D, BQ, seq_q - q0, tid, NT);
  hops::load_tile<float, D>(dos, D, dout + (bh * seq_q + q0) * D, BQ, seq_q - q0, tid, NT);

  float lse_r[4], delta_r[4];
  float acc[4][CO];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const bool ok = row < seq_q;
    lse_r[i] = ok ? lse[bh * seq_q + row] : -INFINITY;
    delta_r[i] = ok ? delta[bh * seq_q + row] : 0.f;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;
  }

  const int nk = (seq_k + BK - 1) / BK;
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * BK;
    if (causal) {  // _block_runs
      if (!(k0 < q0 + BQ + q_offset)) continue;
      if (window > 0 && !(k0 + BK - 1 >= q0 + q_offset - (window - 1))) continue;
    }
    __syncthreads();  // readers of the previous tile are done
    hops::load_tile<float, D>(ks, D + 1, kb + (size_t)k0 * D, BK, seq_k - k0, tid, NT);
    hops::load_tile<float, D>(vs, D + 1, vb + (size_t)k0 * D, BK, seq_k - k0, tid, NT);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty * 4 + i) * D + d];
        gv[i] = dos[(ty * 4 + i) * D + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * (D + 1) + d];
        vv[j] = vs[(tx + 16 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      const int qpos = q0 + row + q_offset;
      const bool row_ok = q0 + row < seq_q && lse_r[i] != -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool vis = row_ok && kpos < seq_k;
        if (causal) {
          vis = vis && qpos >= kpos;
          if (window > 0) vis = vis && qpos - kpos < window;
        }
        const float p = vis ? expf(s[i][j] * sm_scale - lse_r[i]) : 0.f;
        dss[row * BK + tx + 16 * j] = p * (dp[i][j] - delta_r[i]) * sm_scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty * 4 + i) * BK + kk];
#pragma unroll
      for (int c = 0; c < CO; ++c) {
        const float kv = ks[kk * (D + 1) + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= seq_q) continue;
    float* out = dq + (bh * seq_q + row) * D;
#pragma unroll
    for (int c = 0; c < CO; ++c) out[tx + 16 * c] = acc[i][c];
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int bh, int seq_q,
           int seq_k, float sm_scale, int causal, int q_offset, int window,
           cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq_q + BQ - 1) / BQ, bh);
  flash_bwd_dq_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), seq_q, seq_k,
      sm_scale, causal, q_offset, window);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor-core body
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using namespace hops::sm90;

constexpr int BM = 128;      // query rows per block: 64 per warpgroup
constexpr int BN = 64;       // keys per tile
constexpr int STAGES = 2;    // K/V ring depth
constexpr int THREADS = 256; // two warpgroups; thread 0 also issues the loads
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  bf16 q[BM * D];            // D / 64 swizzled panels of BM x 64
  bf16 g[BM * D];            // dO
  bf16 k[STAGES][BN * D];    // D / 64 swizzled panels of BN x 64
  bf16 v[STAGES][BN * D];
  uint64_t qg_full, kv_full[STAGES], empty[STAGES];
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(Smem<D>) + 1024;  // room to align the base to 1024 bytes
}

struct Maps {
  CUtensorMap q, g, k, v;
};

// Load key tile j (K and V) into ring stage s.
template <int D>
__device__ __forceinline__ void load_kv(Smem<D>& sm, const Maps& t, int s, int j, int bh) {
  mbar_arrive_expect_tx(&sm.kv_full[s], 2 * BN * D * 2);
#pragma unroll
  for (int p = 0; p < D / 64; ++p) {
    tma_load_3d(sm.k[s] + p * BN * 64, &t.k, &sm.kv_full[s], p * 64, j * BN, bh);
    tma_load_3d(sm.v[s] + p * BN * 64, &t.v, &sm.kv_full[s], p * 64, j * BN, bh);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const __grid_constant__ Maps maps, const float* __restrict__ lse,
          const float* __restrict__ delta, bf16* __restrict__ dq_out, int seq_q, int seq_k,
          float sm_scale, int causal, int q_offset, int window) {
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
    mbar_init(&sm.qg_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.kv_full[s], 1);
      mbar_init(&sm.empty[s], 8);  // one arrival per warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&sm.qg_full, 2 * BM * D * 2);
    for (int p = 0; p < D / 64; ++p) {
      tma_load_3d(sm.q + p * BM * 64, &maps.q, &sm.qg_full, p * 64, q0, bh);
      tma_load_3d(sm.g + p * BM * 64, &maps.g, &sm.qg_full, p * 64, q0, bh);
    }
    for (int it = 0; it < STAGES && it < n; ++it) load_kv<D>(sm, maps, it, lo + it, bh);
  }
  __syncwarp();

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int r0 = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // rows r0, r0 + 8
  const int c0 = 2 * (lane % 4);  // first key column of each 8-column group
  const float scale_log2 = sm_scale * LOG2E;

  // Each row's lse (log2 domain) and delta, read once. A row that sees
  // no key (lse -inf) takes +inf, so exp2(s - lse) is 0 on every tile.
  float lse2[2], dl[2];
  const size_t base = static_cast<size_t>(bh) * seq_q;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    const float l = row < seq_q ? lse[base + row] : -INFINITY;
    lse2[h] = l == -INFINITY ? INFINITY : l * LOG2E;
    dl[h] = row < seq_q ? delta[base + row] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(&sm.qg_full, 0);
  const uint64_t desc_q = desc_sw128(sm.q + wg * 64 * 64, 16);
  const uint64_t desc_g = desc_sw128(sm.g + wg * 64 * 64, 16);
  for (int it = 0; it < n; ++it) {
    const int s = it % STAGES;
    const int k0 = (lo + it) * BN;
    // Refill the stage tile it - 1 used with tile it + 1, once both
    // warpgroups have released it.
    if (threadIdx.x == 0 && it >= 1 && it + 1 < n) {
      const int sr = (it + 1) % STAGES;
      mbar_wait(&sm.empty[sr], ((it - 1) / STAGES) & 1);
      load_kv<D>(sm, maps, sr, lo + it + 1, bh);
    }
    __syncwarp();
    mbar_wait(&sm.kv_full[s], (it / STAGES) & 1);

    // S = Q K^T and dP = dO V^T: 64 rows x 64 keys each per warpgroup.
    const uint64_t desc_k = desc_sw128(sm.k[s], 16);
    const uint64_t desc_v = desc_sw128(sm.v[s], 16);
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(sc, desc_q + (((kk / 4) * BM * 128 + (kk % 4) * 32) >> 4),
               desc_k + (((kk / 4) * BN * 128 + (kk % 4) * 32) >> 4), kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss(dp, desc_g + (((kk / 4) * BM * 128 + (kk % 4) * 32) >> 4),
               desc_v + (((kk / 4) * BN * 128 + (kk % 4) * 32) >> 4), kk > 0);
    wgmma_commit();

    // P = exp(S * sm_scale - lse), while dP is in flight; mask only a
    // tile that crosses an edge.
    wgmma_wait<1>();
    fence_regs(sc);
#pragma unroll
    for (int e = 0; e < 32; ++e) sc[e] = ex2(fmaf(sc[e], scale_log2, -lse2[(e >> 1) & 1]));
    const bool edge = k0 + BN > seq_k ||
                      (causal && (k0 + BN - 1 > q0 + q_offset ||
                                  (window > 0 && q0 + BM - 1 + q_offset - k0 >= window)));
    if (edge) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int kpos = k0 + 8 * (e / 4) + c0 + (e & 1);
        const int qpos = q0 + r0 + 8 * ((e >> 1) & 1) + q_offset;
        bool vis = kpos < seq_k;
        if (causal) vis = vis && qpos >= kpos && (window <= 0 || qpos - kpos < window);
        if (!vis) sc[e] = 0.f;
      }
    }

    // dS = P * (dP - delta) * sm_scale, rounded to bf16 as the A operand.
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t da[BN / 16][4];
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 8 * kc + 2 * r;
        const float h = dl[(e >> 1) & 1];
        da[kc][r] = pack_bf16(sc[e] * (dp[e] - h) * sm_scale, sc[e + 1] * (dp[e + 1] - h) * sm_scale);
      }

    // dQ += dS K, K the MN-major B operand from the same shared tile.
    const uint64_t desc_km = desc_sw128(sm.k[s], BN * 128);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) wgmma_rs(acc, da[kc], desc_km + ((kc * 16 * 128) >> 4), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    if (row >= seq_q) continue;
    bf16* out = dq_out + (base + row) * D;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn)
      *reinterpret_cast<uint32_t*>(out + 8 * jn + c0) =
          pack_bf16(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, void* dq, int bh, int seq_q, int seq_k, float sm_scale,
           int causal, int q_offset, int window, cudaStream_t stream) {
  Maps maps;
  int err = encode_rows_map(&maps.q, q, D, seq_q, bh, BM);
  if (!err) err = encode_rows_map(&maps.g, dout, D, seq_q, bh, BM);
  if (!err) err = encode_rows_map(&maps.k, k, D, seq_k, bh, BN);
  if (!err) err = encode_rows_map(&maps.v, v, D, seq_k, bh, BN);
  if (err) return err;
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(bh, (seq_q + BM - 1) / BM);
  dq_kernel<D><<<grid, THREADS, smem, stream>>>(maps, lse, delta, static_cast<bf16*>(dq), seq_q,
                                                seq_k, sm_scale, causal, q_offset, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

// q, do, dq: (bh, seq_q, head_dim); k, v: (bh, seq_k, head_dim);
// lse, delta: (bh, seq_q) fp32. All contiguous on the current device.
// is_bf16: 1 for bfloat16, 0 for float32. window <= 0 means none.
// Returns 0 or a cudaError_t code (cudaErrorInvalidValue for a
// configuration the kernel does not take).
int hops_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int bh, int seq_q,
                      int seq_k, int head_dim, int is_bf16, float sm_scale, int causal,
                      int q_offset, int window, void* stream) {
  if (bh < 1 || bh > 65535 || seq_q < 1 || seq_k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (is_bf16) {
    if (head_dim == 64)
      return tc::launch<64>(q, k, v, dout, l, dl, dq, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
    if (head_dim == 128)
      return tc::launch<128>(q, k, v, dout, l, dl, dq, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
  } else {
    if (head_dim == 64)
      return launch<64>(q, k, v, dout, l, dl, dq, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
    if (head_dim == 128)
      return launch<128>(q, k, v, dout, l, dl, dq, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory (bytes) of the body that a call with this
// head_dim and dtype launches, or -1 for a configuration it does not take.
int hops_flash_bwd_dq_smem_bytes(int head_dim, int is_bf16) {
  if (head_dim == 64) return static_cast<int>(is_bf16 ? tc::smem_bytes<64>() : dq_smem_bytes<64>());
  if (head_dim == 128) return static_cast<int>(is_bf16 ? tc::smem_bytes<128>() : dq_smem_bytes<128>());
  return -1;
}

const char* hops_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

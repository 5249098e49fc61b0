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
// is bound by operations. Like K1, this first version computes in fp32
// FMA loops from shared memory, not on the tensor cores; the products
// move onto wgmma tiles in a later step.
//
// Design:
// - The flash-attention-2 split: one thread block per (64-row q tile,
//   batch*head) owns its dq rows and loops over the key tiles, so no
//   block needs another's state and there are no atomics. The TPU's
//   sequential k grid axis becomes this loop; dq stays in fp32
//   registers across it (4 rows x head_dim/16 columns per thread).
// - 256 threads as a 16 x 16 grid, each owning a 4 x 4 patch of the
//   64 x 64 score tile. q and do are loaded once; K and V tiles are
//   staged through shared memory in fp32, padded by one column so the
//   score loop is free of bank conflicts. ds goes through shared memory
//   into the dq product.
// - Tiles outside the causal band or below the window are skipped as
//   `_block_runs` decides; the in-tile mask is `_causal_mask`. Ragged
//   seq_q/seq_k tails are masked here. A row that sees no key has
//   lse == -inf, gets p = 0 and writes dq = 0.

#include "common.cuh"

#include <math.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block (16 x 16)

template <int D>
constexpr size_t dq_smem_bytes() {
  return (size_t)(2 * BQ * D + 2 * BK * (D + 1) + BQ * BK) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int seq_q, int seq_k, float sm_scale,
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
  const T* kb = k + bh * seq_k * D;
  const T* vb = v + bh * seq_k * D;

  hops::load_tile<T, D>(qs, D, q + (bh * seq_q + q0) * D, BQ, seq_q - q0, tid, NT);
  hops::load_tile<T, D>(dos, D, dout + (bh * seq_q + q0) * D, BQ, seq_q - q0, tid, NT);

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
    hops::load_tile<T, D>(ks, D + 1, kb + (size_t)k0 * D, BK, seq_k - k0, tid, NT);
    hops::load_tile<T, D>(vs, D + 1, vb + (size_t)k0 * D, BK, seq_k - k0, tid, NT);
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
    T* out = dq + (bh * seq_q + row) * D;
#pragma unroll
    for (int c = 0; c < CO; ++c) out[tx + 16 * c] = hops::from_f<T>(acc[i][c]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int bh, int seq_q,
           int seq_k, float sm_scale, int causal, int q_offset, int window,
           cudaStream_t stream) {
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq_q + BQ - 1) / BQ, bh);
  flash_bwd_dq_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), seq_q, seq_k,
      sm_scale, causal, q_offset, window);
  return (int)cudaGetLastError();
}

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
      return launch<__nv_bfloat16, 64>(q, k, v, dout, l, dl, dq, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
    if (head_dim == 128)
      return launch<__nv_bfloat16, 128>(q, k, v, dout, l, dl, dq, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
  } else {
    if (head_dim == 64)
      return launch<float, 64>(q, k, v, dout, l, dl, dq, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
    if (head_dim == 128)
      return launch<float, 128>(q, k, v, dout, l, dl, dq, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* hops_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

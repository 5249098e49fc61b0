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
// bytes: bound by operations, and the heaviest of the three attention
// kernels. Like K1 and K2 it computes in fp32 FMA loops from shared
// memory, not on the tensor cores; wgmma tiles are a later step.
//
// Design:
// - The flash-attention-2 split: one thread block per (64-key tile,
//   batch*head) owns its dk/dv rows and loops over the q tiles, so no
//   block needs another's state and there are no atomics. The TPU's
//   sequential q grid axis becomes this loop; dk and dv stay in fp32
//   registers across it (4 keys x head_dim/16 columns each per thread).
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

#include <math.h>

namespace {

constexpr int BQ = 64;   // query rows per tile
constexpr int BK = 64;   // keys per block
constexpr int NT = 256;  // threads per block (16 x 16)

template <int D>
constexpr size_t dkv_smem_bytes() {
  return (size_t)(2 * BK * D + 2 * BQ * (D + 1) + 2 * BK * BQ + 2 * BQ) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int seq_q, int seq_k,
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
  const T* qb = q + bh * seq_q * D;
  const T* gb = dout + bh * seq_q * D;

  hops::load_tile<T, D>(ks, D, k + (bh * seq_k + k0) * D, BK, seq_k - k0, tid, NT);
  hops::load_tile<T, D>(vs, D, v + (bh * seq_k + k0) * D, BK, seq_k - k0, tid, NT);

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
    hops::load_tile<T, D>(qs, D + 1, qb + (size_t)q0 * D, BQ, seq_q - q0, tid, NT);
    hops::load_tile<T, D>(dos, D + 1, gb + (size_t)q0 * D, BQ, seq_q - q0, tid, NT);
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
    T* dkr = dk + (bh * seq_k + key) * D;
    T* dvr = dv + (bh * seq_k + key) * D;
#pragma unroll
    for (int c = 0; c < CO; ++c) {
      dkr[tx + 16 * c] = hops::from_f<T>(dk_acc[i][c]);
      dvr[tx + 16 * c] = hops::from_f<T>(dv_acc[i][c]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv, int bh,
           int seq_q, int seq_k, float sm_scale, int causal, int q_offset,
           int window, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq_k + BK - 1) / BK, bh);
  flash_bwd_dkv_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      seq_q, seq_k, sm_scale, causal, q_offset, window);
  return (int)cudaGetLastError();
}

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
      return launch<__nv_bfloat16, 64>(q, k, v, dout, l, dl, dk, dv, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
    if (head_dim == 128)
      return launch<__nv_bfloat16, 128>(q, k, v, dout, l, dl, dk, dv, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
  } else {
    if (head_dim == 64)
      return launch<float, 64>(q, k, v, dout, l, dl, dk, dv, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
    if (head_dim == 128)
      return launch<float, 128>(q, k, v, dout, l, dl, dk, dv, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* hops_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

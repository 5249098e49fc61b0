// Flash-attention forward for Hopper (sm_90a): the port of K1,
// `_fwd_kernel` in hops_tpu/ops/attention.py (launched by `_fwd_call`).
//
// Computes, per (batch*head) row of q/k/v laid out (bh, seq, head_dim):
//   o   = softmax(q k^T * sm_scale, masked) v      (in the input dtype)
//   lse = logsumexp of the masked scaled scores     (fp32, -inf when a
//                                                    row sees no key)
// with the causal mask placing query row i at key position
// i + q_offset, and an optional sliding window (query p sees keys
// [p - window + 1, p]).
//
// What bounds it on this card: at serving prefill lengths (hundreds to
// thousands of tokens) the work is O(seq^2 * d) operations against
// O(seq * d) bytes, so it is bound by operations. This first version
// computes in fp32 FMA loops from shared memory, not on the tensor
// cores: it is the simple, right kernel; moving the two products onto
// wgmma tiles is the later performance step.
//
// Design:
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

#include <math.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 256;  // threads per block (16 x 16)

template <int D>
constexpr size_t flash_smem_bytes() {
  return (size_t)(BQ * D + BK * (D + 1) + BK * D + BQ * BK) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
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
  const T* qb = q + (bh * seq_q + q0) * D;
  const T* kb = k + bh * seq_k * D;
  const T* vb = v + bh * seq_k * D;

  hops::load_tile<T, D>(qs, D, qb, BQ, seq_q - q0, tid, NT);

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
    hops::load_tile<T, D>(ks, D + 1, kb + (size_t)k0 * D, BK, seq_k - k0, tid, NT);
    hops::load_tile<T, D>(vs, D, vb + (size_t)k0 * D, BK, seq_k - k0, tid, NT);
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
    T* orow = o + (bh * seq_q + row) * D;
#pragma unroll
    for (int c = 0; c < CO; ++c) orow[tx + 16 * c] = hops::from_f<T>(acc[i][c] / l_safe);
    if (tx == 0)
      lse[bh * seq_q + row] = (m[i] == -INFINITY) ? -INFINITY : m[i] + logf(l_safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bh, int seq_q, int seq_k, float sm_scale, int causal,
           int q_offset, int window, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq_q + BQ - 1) / BQ, bh);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, seq_q, seq_k, sm_scale, causal, q_offset, window);
  return (int)cudaGetLastError();
}

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
      return launch<__nv_bfloat16, 64>(q, k, v, o, l, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
    if (head_dim == 128)
      return launch<__nv_bfloat16, 128>(q, k, v, o, l, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
  } else {
    if (head_dim == 64)
      return launch<float, 64>(q, k, v, o, l, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
    if (head_dim == 128)
      return launch<float, 128>(q, k, v, o, l, bh, seq_q, seq_k, sm_scale, causal, q_offset, window, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* hops_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

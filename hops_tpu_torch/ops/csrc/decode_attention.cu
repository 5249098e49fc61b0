// Decode attention against a dense KV cache, for Hopper (sm_90a): the
// port of K4, `_decode_kernel` in hops_tpu/ops/attention.py (launched
// by `decode_attention`).
//
// Query rows: the s newest tokens of each batch row, already written
// into the cache, so chunk position i sits at absolute position
// valid_len - s + i. The g = heads / kv_heads query heads that share a
// kv head fold into g*s rows (the layout (b, hkv, g, s, d) is the
// query's own (b, h, s, d) memory), so each block reads its kv head's
// cache once for all of them.
//
// What bounds it on this card: a decode step does ~4*d operations per
// cached key and query row against 4*d bytes of K/V (bf16), far below
// the card's ~295 operations per byte, so it is bound by the bytes it
// reads. The design therefore reads only the key tiles that can hold a
// visible key (`_decode_block_range`): HBM traffic is proportional to
// valid_len, not to the cache's capacity. This first version runs one
// block per (batch*kv_head, 64-row tile) and walks its key range alone;
// splitting the key range across blocks (flash-decoding) to fill all
// SMs at small batch is the later performance step.
//
// valid_len is a device int32 vector with one entry per batch row; the
// kernel reads it itself, so the host never waits on it. A row with
// valid_len == 0 visits no tile and writes zeros. The mask is
// `_decode_mask`: key k is visible to query row r when
// k <= valid_len - s + r % s (and, with a window, within window of it).
// Keys past valid_len are never visible, whatever the cache holds.

#include "common.cuh"

#include <math.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // threads per block

template <int D>
constexpr size_t decode_smem_bytes() {
  return (size_t)(BQ * D + BK * (D + 1) + BK * D + BQ * BK + 3 * BQ) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ valid_len,
              T* __restrict__ o, int hkv, int rows, int s, int cap,
              float sm_scale, int window) {
  extern __shared__ float smem[];
  float* qs = smem;                // BQ x D
  float* ks = qs + BQ * D;         // BK x (D + 1)
  float* vs = ks + BK * (D + 1);   // BK x D
  float* ps = vs + BK * D;         // BQ x BK: scores, then probabilities
  float* alpha_s = ps + BQ * BK;   // BQ: this tile's rescale per row
  float* m_s = alpha_s + BQ;       // BQ: running max per row
  float* l_s = m_s + BQ;           // BQ: running sum per row

  constexpr int RG = NT / D;       // row groups of the output (1 or 2)
  constexpr int RPT = BQ / RG;     // output rows per thread
  constexpr int SG = NT / BK;      // row groups of the score tile (2)
  const int tid = threadIdx.x;
  const size_t bhk = blockIdx.y;
  const int row0 = blockIdx.x * BQ;
  const int nrows = min(BQ, rows - row0);
  const int vl = valid_len[bhk / hkv];
  const T* kb = k + bhk * cap * D;
  const T* vb = v + bhk * cap * D;

  hops::load_tile<T, D>(qs, D, q + (bhk * rows + row0) * D, BQ, nrows, tid, NT);
  for (int r = tid; r < BQ; r += NT) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  const int c = tid % D;
  const int rg = tid / D;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  // _decode_block_range: validity caps the top at ceil(vl / BK) - 1, a
  // window lifts the bottom to the tile holding vl - s - window + 1.
  int last = (vl + BK - 1) / BK - 1;
  last = min(last, (cap + BK - 1) / BK - 1);
  const int first = window > 0 ? max(vl - s - window + 1, 0) / BK : 0;

  for (int kj = first; kj <= last; ++kj) {
    const int k0 = kj * BK;
    __syncthreads();  // readers of the previous tile (and of m/l init) are done
    hops::load_tile<T, D>(ks, D + 1, kb + (size_t)k0 * D, BK, cap - k0, tid, NT);
    hops::load_tile<T, D>(vs, D, vb + (size_t)k0 * D, BK, cap - k0, tid, NT);
    __syncthreads();

    {  // scores: thread -> one key, every SG-th row
      const int kk = tid % BK;
      const int kpos = k0 + kk;
      for (int r = tid / BK; r < nrows; r += SG) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qs[r * D + d], ks[kk * (D + 1) + d], dot);
        const int qpos = vl - s + (row0 + r) % s;
        bool vis = kpos < cap && kpos <= qpos;
        if (window > 0) vis = vis && qpos - kpos < window;
        ps[r * BK + kk] = vis ? dot * sm_scale : -INFINITY;
      }
    }
    __syncthreads();

    {  // online softmax: one warp per row
      const int warp = tid / 32;
      const int lane = tid % 32;
      for (int r = warp; r < nrows; r += NT / 32) {
        const float x0 = ps[r * BK + lane];
        const float x1 = ps[r * BK + lane + 32];
        float mx = fmaxf(x0, x1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mx);
        const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
        const float p0 = expf(x0 - m_safe);
        const float p1 = expf(x1 - m_safe);
        ps[r * BK + lane] = p0;
        ps[r * BK + lane + 32] = p1;
        float sum = p0 + p1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) {
          const float alpha = (m_old == -INFINITY) ? 0.f : expf(m_old - m_safe);
          alpha_s[r] = alpha;
          l_s[r] = l_s[r] * alpha + sum;
          m_s[r] = m_new;
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPT; ++i) {  // acc = acc * alpha + p @ v
      const int r = rg + RG * i;
      if (r < nrows) {
        float a = acc[i] * alpha_s[r];
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) a = fmaf(ps[r * BK + kk], vs[kk * D + c], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + RG * i;
    if (r < nrows) {
      const float l = l_s[r];
      const float l_safe = (l == 0.f) ? 1.f : l;
      o[(bhk * rows + row0 + r) * D + c] = hops::from_f<T>(acc[i] / l_safe);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* valid_len,
           void* o, int bhkv, int hkv, int rows, int s, int cap,
           float sm_scale, int window, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((rows + BQ - 1) / BQ, bhkv);
  decode_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      valid_len, static_cast<T*>(o), hkv, rows, s, cap, sm_scale, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (b*hkv, rows, head_dim) with rows = g*s (the query's (b, h, s, d)
// memory); k, v: (b*hkv, cap, head_dim); valid_len: (b,) int32;
// o like q. All contiguous on the current device. is_bf16: 1 for
// bfloat16, 0 for float32. window <= 0 means none. Returns 0 or a
// cudaError_t code.
int hops_decode_attention(const void* q, const void* k, const void* v,
                          const void* valid_len, void* o, int b, int hkv,
                          int rows, int s, int cap, int head_dim, int is_bf16,
                          float sm_scale, int window, void* stream) {
  const int bhkv = b * hkv;
  if (b < 1 || hkv < 1 || bhkv > 65535 || rows < 1 || s < 1 || rows % s || cap < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* vl = static_cast<const int*>(valid_len);
  if (is_bf16) {
    if (head_dim == 64)
      return launch<__nv_bfloat16, 64>(q, k, v, vl, o, bhkv, hkv, rows, s, cap, sm_scale, window, st);
    if (head_dim == 128)
      return launch<__nv_bfloat16, 128>(q, k, v, vl, o, bhkv, hkv, rows, s, cap, sm_scale, window, st);
  } else {
    if (head_dim == 64)
      return launch<float, 64>(q, k, v, vl, o, bhkv, hkv, rows, s, cap, sm_scale, window, st);
    if (head_dim == 128)
      return launch<float, 128>(q, k, v, vl, o, bhkv, hkv, rows, s, cap, sm_scale, window, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* hops_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

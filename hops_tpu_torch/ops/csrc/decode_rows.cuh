// Decode attention that reads each key through a row index, for Hopper
// (sm_90a): the 64-row FMA body of the four decode kernels, for the
// calls no faster body takes: fp32 queries wider than split::MAX_ROWS
// rows (the checks' type, and fp32 engines' prefill chunks and appends):
//   K4 decode_attention.cu         (`_decode_kernel`, dense fp32 cache),
//   K5 decode_attention_q8.cu      (`_decode_q8_kernel`, dense int8 cache),
//   K6 paged_decode_attention.cu   (`_paged_decode_kernel`, fp32 pools),
//   K7 paged_decode_attention_q8.cu (`_paged_decode_q8_kernel`, int8 pools).
// Decode steps (rows <= 16) of all four take the split-K body of
// decode_split.cuh; wide bf16 calls of K4 and K5 take K1's tensor-core
// forward body (flash_fwd_tc.cuh), those of K6 and K7 the tensor-core
// chunk body of decode_chunk.cuh. So this body serves fp32 wide calls alone and is
// instantiated for fp32 queries only. The kernels are in
// hops_tpu/ops/attention.py. This body: one block per (batch*kv_head, 64-row
// query tile), the g query heads of a kv head folded into g*s rows,
// valid_len read on the device, only the key tiles of
// `_decode_block_range` visited (reads are O(valid_len), not
// O(capacity)), an fp32 online softmax with `_online_softmax_update`'s
// -inf guards, and a valid_len == 0 row writing zeros.
//
// The four differ in how key position kpos of a tile is found: its row
// index `ri` in the K/V storage, or -1 (`key_row`):
//   dense:  ri = (b*hkv + h) * cap + kpos, computed as the tile loads;
//   paged:  ri = ((h * nblocks + pages[b, kpos / page]) * page + kpos % page,
//           resolved before the tile loads by 64 threads, one key each,
// so any page size works: a tile may span several pages, or a page
// several tiles. The mask arithmetic stays logical (kpos). A key at or
// past valid_len, or behind a page-table entry outside [0, nblocks),
// gets ri = -1 and is never read: its row is zero-filled in shared
// memory and its score is -inf, selected, never multiplied by a 0 mask,
// so stale values or NaN past valid_len (pools are reused across
// requests; block 0 is the engine's scratch block) cannot reach the
// output, and a corrupt entry hides its keys instead of adding score-0
// keys to the softmax.
//
// int8 (K5, K7): the fp32 scales share the row index of their values
// (the scale pool is (hkv, nblocks, page), the dense scales (b*hkv,
// cap)), so a value and its scale always come from the same physical
// block. Tiles convert to fp32 in shared memory; each score column is
// multiplied by its k_scale, then by sm_scale, then masked; v_scale
// multiplies p in the p.v product only, so the running sum l adds the
// unscaled p, as `_online_softmax_update`'s p_scale does. No dequantized
// tile is written to global memory.
//
// What bounds it on this card: a decode step does ~4*d operations per
// visible key and query row against 4*d bytes of bf16 K/V per key (2*d
// int8 plus 8 bytes of scales), far below the card's ~295 operations per
// byte: bound by the bytes it reads, which are O(valid_len). This body
// is simple (fp32 FMAs from shared memory, one block walking its key
// range alone), and fills only b*hkv SMs at one row tile. It stays for
// the fp32 calls above; every decode step moved to the split-K body
// (flash-decoding), which fills all SMs at small batch, and every bf16
// wide call to a tensor-core body.

#pragma once

#include "common.cuh"

#include <limits.h>
#include <math.h>

namespace hops {
namespace decode {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NT = 128;  // threads per block

struct Args {
  const void* q;          // (b*hkv, rows, D), T
  const void* k;          // dense (b*hkv, cap, D); paged (hkv, nblocks, page, D)
  const void* v;
  const float* k_scale;   // int8 only: dense (b*hkv, cap); paged (hkv, nblocks, page)
  const float* v_scale;
  const int* valid_len;   // (b,)
  const int* pages;       // paged only: (b, max_blocks)
  void* o;                // like q
  int hkv, rows, s;
  int cap;                // dense: capacity; paged: max_blocks * page
  int page, max_blocks, nblocks;
  float sm_scale;
  int window;             // <= 0: none
};

// The paged entry points' shared argument checks (K6, K7); fills `a`'s
// paged fields. Returns false when the sizes are out of range.
inline bool paged_args(Args& a, const void* q, const void* k, const void* v,
                       const void* valid_len, const void* pages, void* o, int hkv, int rows,
                       int s, int page, int max_blocks, int nblocks, float sm_scale,
                       int window) {
  const long long cap = (long long)page * max_blocks;
  if (page < 1 || max_blocks < 1 || nblocks < 1 || cap > INT_MAX) return false;
  a.q = q;
  a.k = k;
  a.v = v;
  a.valid_len = static_cast<const int*>(valid_len);
  a.pages = static_cast<const int*>(pages);
  a.o = o;
  a.hkv = hkv;
  a.rows = rows;
  a.s = s;
  a.cap = (int)cap;
  a.page = page;
  a.max_blocks = max_blocks;
  a.nblocks = nblocks;
  a.sm_scale = sm_scale;
  a.window = window;
  return true;
}

template <int D>
constexpr size_t smem_bytes() {
  return BK * sizeof(long long) +
         (size_t)(BQ * D + BK * (D + 1) + BK * D + BQ * BK + 3 * BQ + 2 * BK) * sizeof(float);
}

// Paged: the table entry of logical page pg of row bi, read only for a
// key below kv_len (`in_range`); -1 otherwise.
__device__ __forceinline__ int page_entry(const Args& a, int bi, int pg, bool in_range) {
  return in_range ? a.pages[(size_t)bi * a.max_blocks + pg] : -1;
}

// Paged: the storage row of offset off in table entry blk, or -1 for an
// entry outside [0, nblocks). Apart from `page_entry`, so a thread can
// read several entries before it tests the first.
__device__ __forceinline__ long long block_row(const Args& a, int hk, int blk, int off) {
  return blk >= 0 && blk < a.nblocks ? ((long long)hk * a.nblocks + blk) * a.page + off : -1;
}

// Storage row of key position kpos, or -1 when it must not be read.
template <bool PAGED>
__device__ __forceinline__ long long key_row(const Args& a, int bi, int hk, int kpos,
                                             int kv_len) {
  if (!PAGED) return kpos < kv_len ? ((long long)bi * a.hkv + hk) * a.cap + kpos : -1;
  return block_row(a, hk, page_entry(a, bi, kpos / a.page, kpos < kv_len), kpos % a.page);
}

// Copy BK rows of D elements into fp32 shared memory with row stride
// `dst_stride`: paged, row r from storage row `rowidx[r]`; dense, from
// row `row0 + r` while r < `valid_rows`. Rows not read are zero-filled.
// 16-byte loads, neighbouring threads on neighbouring addresses.
template <typename KV, int D, bool PAGED>
__device__ __forceinline__ void load_rows(float* dst, int dst_stride,
                                          const KV* __restrict__ base,
                                          const long long* rowidx, long long row0,
                                          int valid_rows, int tid) {
  constexpr int VEC = 16 / sizeof(KV);
  constexpr int VPR = D / VEC;
  for (int i = tid; i < BK * VPR; i += NT) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    float* d = dst + r * dst_stride + c;
    const long long ri = PAGED ? rowidx[r] : (r < valid_rows ? row0 + r : -1);
    if (ri >= 0) {
      const uint4 raw = *reinterpret_cast<const uint4*>(base + ri * D + c);
      const KV* e = reinterpret_cast<const KV*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) d[j] = to_f(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) d[j] = 0.f;
    }
  }
}

// Launch bounds (NT, 1): at d 128 the shared memory already limits an SM
// to one block, and under (NT) alone ptxas held the int8 paged d-64
// instantiations to 64 registers with a 4-byte spill.
template <typename T, typename KV, int D, bool PAGED>
__global__ void __launch_bounds__(NT, 1) decode_rows_kernel(const Args a) {
  constexpr bool Q8 = sizeof(KV) == 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* kidx = reinterpret_cast<long long*>(smem_raw);  // BK: storage row per key
  float* qs = reinterpret_cast<float*>(kidx + BK);           // BQ x D
  float* ks = qs + BQ * D;                                   // BK x (D + 1)
  float* vs = ks + BK * (D + 1);                             // BK x D
  float* ps = vs + BK * D;       // BQ x BK: scores, then probabilities
  float* alpha_s = ps + BQ * BK; // BQ: this tile's rescale per row
  float* m_s = alpha_s + BQ;     // BQ: running max per row
  float* l_s = m_s + BQ;         // BQ: running sum per row
  float* ksc = l_s + BQ;         // BK: k scale per key (int8)
  float* vsc = ksc + BK;         // BK: v scale per key (int8)

  constexpr int RG = NT / D;     // row groups of the output (1 or 2)
  constexpr int RPT = BQ / RG;   // output rows per thread
  constexpr int SG = NT / BK;    // row groups of the score tile (2)
  const T* q = static_cast<const T*>(a.q);
  const KV* k = static_cast<const KV*>(a.k);
  const KV* v = static_cast<const KV*>(a.v);
  T* o = static_cast<T*>(a.o);
  const int tid = threadIdx.x;
  const int bhk = blockIdx.y;
  const int bi = bhk / a.hkv;
  const int hk = bhk % a.hkv;
  const int row0 = blockIdx.x * BQ;
  const int nrows = min(BQ, a.rows - row0);
  const int s = a.s;
  const int vl = a.valid_len[bi];
  const int kv_len = min(vl, a.cap);  // keys that may be read

  load_tile<T, D>(qs, D, q + ((size_t)bhk * a.rows + row0) * D, BQ, nrows, tid, NT);
  for (int r = tid; r < BQ; r += NT) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  const int c = tid % D;
  const int rg = tid / D;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  // _decode_block_range over logical positions.
  const int last = (kv_len + BK - 1) / BK - 1;
  const int first = a.window > 0 ? max(vl - s - a.window + 1, 0) / BK : 0;

  for (int kj = first; kj <= last; ++kj) {
    const int k0 = kj * BK;
    __syncthreads();  // readers of the previous tile (and of m/l init) are done
    if ((PAGED || Q8) && tid < BK) {
      const long long ri = key_row<PAGED>(a, bi, hk, k0 + tid, kv_len);
      if (PAGED) kidx[tid] = ri;
      if (Q8) {
        ksc[tid] = ri >= 0 ? a.k_scale[ri] : 0.f;
        vsc[tid] = ri >= 0 ? a.v_scale[ri] : 0.f;
      }
    }
    if (PAGED) __syncthreads();  // the rows below are read through kidx
    const long long row0_kv = (long long)bhk * a.cap + k0;  // dense only
    load_rows<KV, D, PAGED>(ks, D + 1, k, kidx, row0_kv, kv_len - k0, tid);
    load_rows<KV, D, PAGED>(vs, D, v, kidx, row0_kv, kv_len - k0, tid);
    __syncthreads();

    {  // scores: thread -> one key, every SG-th row
      const int kk = tid % BK;
      const int kpos = k0 + kk;
      const float col = Q8 ? ksc[kk] : 1.f;
      for (int r = tid / BK; r < nrows; r += SG) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qs[r * D + d], ks[kk * (D + 1) + d], dot);
        if (Q8) dot *= col;
        const int qpos = vl - s + (row0 + r) % s;
        // kidx < 0 below kv_len only for an out-of-range page entry.
        bool vis = kpos < kv_len && kpos <= qpos && (!PAGED || kidx[kk] >= 0);
        if (a.window > 0) vis = vis && qpos - kpos < a.window;
        ps[r * BK + kk] = vis ? dot * a.sm_scale : -INFINITY;
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
        // int8: p.v uses p * v_scale; the denominator sums the unscaled p.
        ps[r * BK + lane] = Q8 ? p0 * vsc[lane] : p0;
        ps[r * BK + lane + 32] = Q8 ? p1 * vsc[lane + 32] : p1;
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
        float acc_r = acc[i] * alpha_s[r];
#pragma unroll 8
        for (int kk = 0; kk < BK; ++kk) acc_r = fmaf(ps[r * BK + kk], vs[kk * D + c], acc_r);
        acc[i] = acc_r;
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
      o[((size_t)bhk * a.rows + row0 + r) * D + c] = from_f<T>(acc[i] / l_safe);
    }
  }
}

template <typename T, typename KV, int D, bool PAGED>
int launch(const Args& a, int bhkv, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      decode_rows_kernel<T, KV, D, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.rows + BQ - 1) / BQ, bhkv);
  decode_rows_kernel<T, KV, D, PAGED><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The cache element type of a kernel over T queries: T, or int8.
template <typename T, bool Q8>
struct kv_of {
  using type = T;
};
template <typename T>
struct kv_of<T, true> {
  using type = int8_t;
};

// The C entry points' common tail for the wide fp32 calls: check the
// sizes, pick the instantiation for head_dim, launch. Returns 0 or a
// cudaError_t code.
template <bool Q8, bool PAGED>
int dispatch(const Args& a, int b, int head_dim, void* stream) {
  const long long bhkv = (long long)b * a.hkv;
  if (b < 1 || a.hkv < 1 || bhkv > 65535 || a.rows < 1 || a.s < 1 || a.rows % a.s ||
      a.cap < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using KV = typename kv_of<float, Q8>::type;
  if (head_dim == 64) return launch<float, KV, 64, PAGED>(a, (int)bhkv, st);
  if (head_dim == 128) return launch<float, KV, 128, PAGED>(a, (int)bhkv, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace decode
}  // namespace hops

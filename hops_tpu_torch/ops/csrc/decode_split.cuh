// Split-K (flash-decoding) body of K4, `_decode_kernel`, K5,
// `_decode_q8_kernel`, K6, `_paged_decode_kernel`, and K7,
// `_paged_decode_q8_kernel`, in hops_tpu/ops/attention.py, for the
// decode step: a call whose g query heads per kv head times s query
// tokens give rows = g*s <= 16 (every decode step), bf16 or fp32
// queries. The PAGED template parameter picks the layout: K6's and K7's
// pools through a page table, or K4's and K5's dense (b*hkv, cap, d)
// cache; KV, the cache's element type: the query's (K4, K6) or int8
// (K5, K7). Wider calls take other bodies: bf16 ones the tensor-core
// body of decode_chunk.cuh, fp32 ones the 64-row body of
// decode_rows.cuh.
//
// Why: the 64-row body runs one block per (64-row tile, batch*kv_head),
// so a decode step of 4 slots and 8 kv heads fills 32 of the 132 SMs,
// each walking its whole key range alone, through a 64-row tile that
// holds one live row. Decode is bound by the bytes of K and V it reads
// (4*d bytes per key against ~4*d operations per key and row), so the
// card needs many blocks in flight, each streaming its keys.
//
// Design:
// - The grid is (n_splits, batch*kv_head). Split i covers keys
//   [i*L, (i+1)*L) of the row's logical positions, L a multiple of the
//   64-key tile; the host chooses n_splits and L from the capacity
//   (dense: cap; paged: max_blocks * page), never from valid_len, which
//   stays on the device (ops/attention.py `decode_splits`). A block
//   visits the tiles of its split that `_decode_block_range` keeps
//   (valid_len and the window), so reads stay O(valid_len); a block whose
//   range is empty writes the sentinel m = -inf, l = 0, acc = 0 and exits
//   (a split at or past valid_len, which the combine never reads, writes
//   nothing).
// - Every key's storage row comes from decode_rows.cuh's `key_row` rule
//   (`tile_rows` below): dense, row (b*hkv + h) * cap + kpos; paged,
//   `page_entry`, then `block_row`. A key at or past valid_len, or behind
//   a table entry outside [0, nblocks), is never read (its 16-byte copies
//   are zero-fills) and scores -inf, so the scratch block 0 stays
//   unreachable.
// - K and V tiles go from the cache to shared memory in their own dtype
//   by 16-byte cp.async (int8: 16 elements a copy, so the staging is
//   half of bf16's), double-buffered: the copies of a split's first
//   two tiles, and the page-table reads that place them, are issued
//   together at the start, and those of tile t + 2 as soon as tile t is
//   done. A split of two tiles (the served shape) waits for its loads
//   once. Nothing is widened in shared memory; values become fp32 in
//   registers.
// - Scores: each warp takes 16 keys of the tile; d/4 lanes share a key
//   (4 elements each), every lane holds its 4 elements of each query row
//   in registers, and the dot products close by xor shuffles. An fp32
//   online softmax with `_online_softmax_update`'s -inf guards (one warp
//   per row) follows, then p.v into per-thread fp32 accumulators (one
//   head_dim column per thread; at d 64 the two thread halves take
//   alternate keys and add up at the end).
// - With n_splits == 1 the block writes o itself. Otherwise it writes
//   its fp32 partials m, l (n_splits, b*hkv, rows) and acc (n_splits,
//   b*hkv, rows, d) to the caller's workspace, and `combine_kernel`
//   merges them per (row, head): M = max m_i, o = sum e^(m_i - M) acc_i /
//   sum e^(m_i - M) l_i over the splits below the row's valid_len; a row
//   with M = -inf or a zero sum writes exactly 0 (l_safe, as every
//   kernel's finalize). The combine is a programmatic dependent launch:
//   its blocks start while the split grid runs and wait for it to finish
//   (griddepcontrol), so its launch does not follow the split grid's
//   drain.
// - int8 (K5, K7), as the JAX kernels and decode_rows.cuh do it: the
//   fp32 scales of a tile's keys are copied beside `kok` (4-byte
//   cp.async, zero-filled for a key without a storage row) from the same
//   storage row as the values; int8 values become fp32 exactly; each
//   score is multiplied by its key's k_scale before sm_scale and the
//   mask; p.v uses p * v_scale while l sums the unscaled p
//   (`_online_softmax_update`'s p_scale). The arithmetic is fp32 and only
//   the output is rounded. The combine is the same kernel.

#pragma once

#include "decode_rows.cuh"

namespace hops {
namespace split {

constexpr int MAX_ROWS = 16;  // widest call (rows = g * s) the split body takes
constexpr int BK = 64;        // keys per tile
constexpr int NT = 128;       // threads per block: 4 warps
constexpr int STAGES = 2;     // K/V double buffer
constexpr int EPL = 4;        // elements of a key row per lane in the score pass

// The fp32 partials of a call with n_splits > 1, in the caller's
// workspace: m and l (n_splits, b*hkv, rows), acc (n_splits, b*hkv,
// rows, D).
struct Part {
  float* m;
  float* l;
  float* acc;
  int n_splits;
  int split_keys;  // L: a multiple of BK
};

// Dynamic shared memory of the body for kv_bytes-byte cache elements,
// head dim d and rows bucket r; int8 adds two fp32 scales per staged key.
constexpr size_t smem_bytes(int kv_bytes, int d, int r) {
  return 2 * STAGES * BK * (size_t)d * kv_bytes +
         ((kv_bytes == 1 ? 2 * STAGES * BK : 0) + r * BK + 3 * r) * sizeof(float) +
         STAGES * BK * sizeof(int);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  // src-size 0 reads nothing and fills the 16 bytes with zeros.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// A 4-byte copy (an fp32 scale); src-size 0 fills it with zero.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Storage rows ri[j] of the keys kpos0 + j * STEP (j < NR), or -1 for a
// key that must not be read (`key_row`'s rule). Dense: rows of the
// (b*hkv, cap) cache. Paged: a thread reads all its table entries before
// it tests any, so the reads overlap, and steps its keys' page and
// offset instead of dividing each position by the page size.
template <bool PAGED, int NR, int STEP>
__device__ __forceinline__ void tile_rows(long long (&ri)[NR], const decode::Args& a, int bi,
                                          int hk, int kpos0, int kv_len) {
  if (!PAGED) {
#pragma unroll
    for (int j = 0; j < NR; ++j) ri[j] = decode::key_row<false>(a, bi, hk, kpos0 + j * STEP, kv_len);
    return;
  }
  int pg = kpos0 / a.page, off = kpos0 % a.page;
  int blk[NR], offs[NR];
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    blk[j] = decode::page_entry(a, bi, pg, kpos0 + j * STEP < kv_len);
    offs[j] = off;
    for (off += STEP; off >= a.page; off -= a.page) ++pg;
  }
#pragma unroll
  for (int j = 0; j < NR; ++j) ri[j] = decode::block_row(a, hk, blk[j], offs[j]);
}

// Start the copies of the key tile at logical position k0 into ks/vs
// (BK x D each); kok[r] says whether key r has a storage row, and for
// int8 ksc[r]/vsc[r] take its scales (0 without a storage row). Each
// thread copies one 16-byte column of every (NT / chunks-per-row)-th
// key and resolves those keys' rows itself (`tile_rows`), so no barrier
// separates the page-table reads from the copies.
template <typename KV, int D, bool PAGED>
__device__ __forceinline__ void issue_tile(KV* ks, KV* vs, float* ksc, float* vsc, int* kok,
                                           const decode::Args& a, const KV* k, const KV* v,
                                           int bi, int hk, int k0, int kv_len, int tid) {
  constexpr int VEC = 16 / sizeof(KV);
  constexpr int CPR = D / VEC;       // 16-byte chunks per key row
  constexpr int NR = BK * CPR / NT;  // key rows per thread
  constexpr int STEP = NT / CPR;     // keys between a thread's rows
  static_assert(NT % CPR == 0, "a thread keeps one column of chunks");
  const int c = (tid % CPR) * VEC;
  long long ri[NR];
  tile_rows<PAGED, NR, STEP>(ri, a, bi, hk, k0 + tid / CPR, kv_len);
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int r = tid / CPR + j * STEP;
    const bool ok = ri[j] >= 0;
    const size_t at = ok ? static_cast<size_t>(ri[j]) * D + c : 0;
    cp_async16(ks + r * D + c, k + at, ok);
    cp_async16(vs + r * D + c, v + at, ok);
    if (c == 0) {
      kok[r] = ok;
      if constexpr (sizeof(KV) == 1) {
        cp_async4(ksc + r, a.k_scale + (ok ? ri[j] : 0), ok);
        cp_async4(vsc + r, a.v_scale + (ok ? ri[j] : 0), ok);
      }
    }
  }
}

// EPL consecutive elements of a shared-memory row, as fp32.
__device__ __forceinline__ void load_epl(float (&x)[EPL], const float* p) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x, x[1] = u.y, x[2] = u.z, x[3] = u.w;
}
__device__ __forceinline__ void load_epl(float (&x)[EPL], const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  x[0] = a.x, x[1] = a.y, x[2] = b.x, x[3] = b.y;
}
__device__ __forceinline__ void load_epl(float (&x)[EPL], const int8_t* p) {
  const char4 u = *reinterpret_cast<const char4*>(p);
  x[0] = u.x, x[1] = u.y, x[2] = u.z, x[3] = u.w;
}

// Sum each of N values over the G lanes that share a key group (N <= G,
// both powers of 2) by halving: each xor step sends half of the values
// still held and keeps the other half. After it, lane l holds in v[0]
// the whole sum of value (l % G) / (G / N), as do the G / N lanes next
// to it: N - 1 + log2(G / N) shuffles instead of N * log2(G).
template <int N, int G>
__device__ __forceinline__ void reduce_scatter(float (&v)[N], int lane) {
#pragma unroll
  for (int h = N / 2, off = G / 2; h >= 1; h /= 2, off /= 2) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = upper ? v[i] : v[i + h];
      const float keep = upper ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
#pragma unroll
  for (int off = G / N / 2; off >= 1; off /= 2) v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
}

// T: the query's type; KV: the cache's (T, or int8 with fp32 scales).
// R: the call's rows rounded up to 1, 4 or 16 (registers per query row).
// Launch bounds (NT, 1): under (NT) alone ptxas caps the bf16 d-64
// rows-16 instantiation at 128 registers, and it spills.
template <typename T, typename KV, int D, int R, bool PAGED>
__global__ void __launch_bounds__(NT, 1) split_kernel(const decode::Args a, const Part part) {
  constexpr bool Q8 = sizeof(KV) == 1;
  constexpr int G = D / EPL;   // lanes per key in the score pass (16 or 32)
  constexpr int KPW = 32 / G;  // keys a warp scores at once (2 or 1)
  constexpr int CG = NT / D;   // key groups of p.v (2 at d 64, 1 at d 128)
  static_assert(CG == 1 || D <= BK, "the d-64 reduction reuses the score tile");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  KV* ks = reinterpret_cast<KV*>(smem_raw);                     // STAGES x BK x D
  KV* vs = ks + STAGES * BK * D;                                 // STAGES x BK x D
  float* ksc = reinterpret_cast<float*>(vs + STAGES * BK * D);   // int8: STAGES x BK
  float* vsc = ksc + (Q8 ? STAGES * BK : 0);                     // int8: STAGES x BK
  float* ps = vsc + (Q8 ? STAGES * BK : 0);                      // R x BK: scores, then p
  float* alpha_s = ps + R * BK;                                  // R: this tile's rescale
  float* m_s = alpha_s + R;                                    // R: running max
  float* l_s = m_s + R;                                        // R: running sum
  int* kok = reinterpret_cast<int*>(l_s + R);                  // STAGES x BK

  const KV* k = static_cast<const KV*>(a.k);
  const KV* v = static_cast<const KV*>(a.v);
  const int tid = threadIdx.x;
  const int sp = blockIdx.x;
  const int bhk = blockIdx.y;
  const int bhkv = gridDim.y;
  const int bi = bhk / a.hkv;
  const int hk = bhk % a.hkv;
  const int rows = a.rows;
  const int vl = a.valid_len[bi];
  const int kv_len = min(vl, a.cap);

  // This split's tiles, intersected with _decode_block_range.
  const int first = a.window > 0 ? max(vl - a.s - a.window + 1, 0) / BK : 0;
  const int t_lo = max(sp * (part.split_keys / BK), first);
  const int t_hi = min((sp + 1) * (part.split_keys / BK), (kv_len + BK - 1) / BK);

  const int c = tid % D;
  const int kg = tid / D;
  const size_t out_row0 = (static_cast<size_t>(sp) * bhkv + bhk) * rows;
  // The combine grid may start now; it waits for this grid to finish
  // before it reads a partial.
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  if (t_lo >= t_hi) {  // nothing to see: the sentinel (or, unsplit, o = 0)
    // A split at or past valid_len is never read by the combine.
    if (part.n_splits > 1 && sp * part.split_keys >= kv_len) return;
    for (int i = tid; i < rows * D; i += NT) {
      if (part.n_splits == 1)
        static_cast<T*>(a.o)[static_cast<size_t>(bhk) * rows * D + i] = from_f<T>(0.f);
      else
        part.acc[out_row0 * D + i] = 0.f;
    }
    if (part.n_splits > 1 && tid < rows) {
      part.m[out_row0 + tid] = -INFINITY;
      part.l[out_row0 + tid] = 0.f;
    }
    return;
  }

  // Both stages in flight from the start: the copies of tile t + 2 are
  // issued once tile t is done (one copy group per tile, maybe empty).
  for (int i = 0; i < STAGES; ++i) {
    if (t_lo + i < t_hi)
      issue_tile<KV, D, PAGED>(ks + i * BK * D, vs + i * BK * D, ksc + i * BK, vsc + i * BK,
                               kok + i * BK, a, k, v, bi, hk, (t_lo + i) * BK, kv_len, tid);
    cp_async_commit();
  }

  // This lane's EPL elements of every query row, in fp32 registers.
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int seg = (lane % G) * EPL;
  float qr[R][EPL];
  {
    const T* q = static_cast<const T*>(a.q) + static_cast<size_t>(bhk) * rows * D;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rows) {
        load_epl(qr[r], q + r * D + seg);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) qr[r][e] = 0.f;
      }
    }
  }
  for (int r = tid; r < R; r += NT) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  // Row r sees keys [lo_r, hi_r]: its position, and the window below it;
  // a padding row (r >= rows) sees none.
  int hi_r[R], lo_r[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    hi_r[r] = r < rows ? vl - a.s + r % a.s : -1;
    lo_r[r] = a.window > 0 ? hi_r[r] - a.window + 1 : 0;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) % STAGES;
    const int k0 = t * BK;
    const KV* kt = ks + st * BK * D;
    const KV* vt = vs + st * BK * D;
    const float* kst = ksc + st * BK;
    const float* vst = vsc + st * BK;
    const int* okt = kok + st * BK;
    cp_async_wait<STAGES - 1>();
    __syncthreads();  // tile t landed for every thread

    // Scores: warp w takes keys 16w .. 16w + 15, KPW at a time, JU steps
    // at once (all of them for calls of up to 4 rows): the partial dot
    // products, then one `reduce_scatter` per row that leaves every
    // step's whole dot product with G / JU of the lanes, then the masked
    // stores. The stores come last so that no branch splits the chains of
    // shuffles, which would run them one after another.
    constexpr int STEPS = 16 / KPW;
    constexpr int JU = R <= 4 ? STEPS : 2;
    for (int j0 = 0; j0 < STEPS; j0 += JU) {
      float dot[R][JU];
#pragma unroll
      for (int ju = 0; ju < JU; ++ju) {
        float kv[EPL];
        load_epl(kv, kt + (warp * 16 + (j0 + ju) * KPW + lane / G) * D + seg);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float x = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) x = fmaf(qr[r][e], kv[e], x);
          dot[r][ju] = x;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) reduce_scatter<JU, G>(dot[r], lane);
      const int kk = warp * 16 + (j0 + (lane % G) / (G / JU)) * KPW + lane / G;
      const int kpos = okt[kk] ? k0 + kk : INT_MAX;  // no storage row: seen by none
      if (lane % (G / JU) == 0) {
        // int8: the key's k_scale first, then sm_scale, as the JAX kernel.
        const float col = Q8 ? kst[kk] : 1.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float x = Q8 ? dot[r][0] * col : dot[r][0];
          ps[r * BK + kk] = kpos <= hi_r[r] && kpos >= lo_r[r] ? x * a.sm_scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // Online softmax: one warp per row.
    for (int r = warp; r < R; r += NT / 32) {
      const float x0 = ps[r * BK + lane];
      const float x1 = ps[r * BK + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      const float p0 = expf(x0 - m_safe);
      const float p1 = expf(x1 - m_safe);
      // int8: p.v takes p * v_scale; l sums the unscaled p.
      ps[r * BK + lane] = Q8 ? p0 * vst[lane] : p0;
      ps[r * BK + lane + 32] = Q8 ? p1 * vst[lane + 32] : p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = m_old == -INFINITY ? 0.f : expf(m_old - m_safe);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p.v, column c, keys kg, kg + CG, ...
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] *= alpha_s[r];
#pragma unroll 8
    for (int j = 0; j < BK / CG; ++j) {
      const int kk = kg + j * CG;
      const float vv = to_f(vt[kk * D + c]);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(ps[r * BK + kk], vv, acc[r]);
    }
    __syncthreads();  // every reader of stage st and of ps is done
    if (t + STAGES < t_hi)
      issue_tile<KV, D, PAGED>(ks + st * BK * D, vs + st * BK * D, ksc + st * BK,
                               vsc + st * BK, kok + st * BK, a, k, v, bi, hk, k0 + STAGES * BK,
                               kv_len, tid);
    cp_async_commit();
  }

  if (CG > 1) {  // the second half's keys join the first's
    if (kg == 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) ps[r * D + c] = acc[r];
    }
    __syncthreads();
    if (kg == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] += ps[r * D + c];
    }
  }
  if (kg == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rows) break;
      if (part.n_splits == 1) {
        const float l = l_s[r];
        static_cast<T*>(a.o)[(static_cast<size_t>(bhk) * rows + r) * D + c] =
            from_f<T>(acc[r] / (l == 0.f ? 1.f : l));
      } else {
        part.acc[(out_row0 + r) * D + c] = acc[r];
        if (c == 0) {
          part.m[out_row0 + r] = m_s[r];
          part.l[out_row0 + r] = l_s[r];
        }
      }
    }
  }
}

// Merge the splits' partials into o: one block per batch*kv_head.
template <typename T, int D>
__global__ void __launch_bounds__(NT) combine_kernel(const decode::Args a, const Part part) {
  const int bhk = blockIdx.x;
  const int bhkv = gridDim.x;
  const int rows = a.rows;
  const int kv_len = min(a.valid_len[bhk / a.hkv], a.cap);
  // Splits at or past valid_len hold sentinels and are not read.
  const int used = min(part.n_splits, (kv_len + part.split_keys - 1) / part.split_keys);
  T* o = static_cast<T*>(a.o) + static_cast<size_t>(bhk) * rows * D;
  // Launched as a programmatic dependent of the split grid: wait until it
  // has finished and its partials are visible.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int i = threadIdx.x; i < rows * D; i += NT) {
    const int r = i / D;
    float mx = -INFINITY;
#pragma unroll 8
    for (int sp = 0; sp < used; ++sp)
      mx = fmaxf(mx, part.m[(static_cast<size_t>(sp) * bhkv + bhk) * rows + r]);
    // No branch on a loaded value, so the splits' loads overlap: a split
    // that saw no key (m = -inf) holds l = 0 and acc = 0 and weighs 0.
    const float base = mx == -INFINITY ? 0.f : mx;
    float num = 0.f, den = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < used; ++sp) {
      const size_t at = (static_cast<size_t>(sp) * bhkv + bhk) * rows + r;
      const float m = part.m[at];
      const float w = m == -INFINITY ? 0.f : expf(m - base);
      num = fmaf(w, part.acc[at * D + i % D], num);
      den = fmaf(w, part.l[at], den);
    }
    o[i] = from_f<T>(num / (den == 0.f ? 1.f : den));
  }
}

template <typename T, typename KV, int D, int R, bool PAGED>
int launch(const decode::Args& a, const Part& part, int bhkv, cudaStream_t stream) {
  const size_t smem = smem_bytes(sizeof(KV), D, R);
  cudaError_t err = cudaFuncSetAttribute(
      split_kernel<T, KV, D, R, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  split_kernel<T, KV, D, R, PAGED><<<dim3(part.n_splits, bhkv), NT, smem, stream>>>(a, part);
  err = cudaGetLastError();
  if (err != cudaSuccess || part.n_splits == 1) return (int)err;
  // A programmatic dependent launch: the combine's blocks are placed while
  // the split grid runs, instead of after it drains.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bhkv);
  cfg.blockDim = dim3(NT);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, combine_kernel<T, D>, a, part);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, typename KV, int D, bool PAGED>
int launch_rows(const decode::Args& a, const Part& part, int bhkv, cudaStream_t stream) {
  if (a.rows <= 1) return launch<T, KV, D, 1, PAGED>(a, part, bhkv, stream);
  if (a.rows <= 4) return launch<T, KV, D, 4, PAGED>(a, part, bhkv, stream);
  return launch<T, KV, D, MAX_ROWS, PAGED>(a, part, bhkv, stream);
}

// Check the split arguments and launch the split body (and, for
// n_splits > 1, the combine) for (layout, cache type, query dtype,
// head_dim). `workspace` holds n_splits * b*hkv * rows * (head_dim + 2)
// floats when n_splits > 1. Returns 0 or a cudaError_t code.
template <bool PAGED, bool Q8 = false>
int dispatch(const decode::Args& a, int b, int head_dim, int is_bf16, float* workspace,
                    int n_splits, int split_keys, void* stream) {
  const long long bhkv = (long long)b * a.hkv;
  if (b < 1 || a.hkv < 1 || bhkv > 65535 || a.rows < 1 || a.rows > MAX_ROWS || a.s < 1 ||
      a.rows % a.s || a.cap < 1 || n_splits < 1 || split_keys < BK || split_keys % BK ||
      (long long)n_splits * split_keys < a.cap || (n_splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  const long long parts = (long long)n_splits * bhkv * a.rows;
  Part part{nullptr, nullptr, nullptr, n_splits, split_keys};
  if (n_splits > 1) {
    part.m = workspace;
    part.l = workspace + parts;
    part.acc = workspace + 2 * parts;
  }
  const int nb = (int)bhkv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using KV = typename decode::kv_of<__nv_bfloat16, Q8>::type;
    if (head_dim == 64) return launch_rows<__nv_bfloat16, KV, 64, PAGED>(a, part, nb, st);
    if (head_dim == 128) return launch_rows<__nv_bfloat16, KV, 128, PAGED>(a, part, nb, st);
  } else {
    using KV = typename decode::kv_of<float, Q8>::type;
    if (head_dim == 64) return launch_rows<float, KV, 64, PAGED>(a, part, nb, st);
    if (head_dim == 128) return launch_rows<float, KV, 128, PAGED>(a, part, nb, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace split
}  // namespace hops

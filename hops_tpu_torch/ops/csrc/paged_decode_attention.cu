// Decode attention against a paged KV cache, for Hopper (sm_90a): the
// ports of K6, `_paged_decode_kernel`, and K7, `_paged_decode_q8_kernel`,
// in hops_tpu/ops/attention.py (both launched by
// `paged_decode_attention`).
//
// K6 has three bodies, chosen by the call's shape and dtype: a call of
// rows = g*s <= 16 (every decode step) runs the split-K body of
// decode_split.cuh and, when it has more than one split, its combine
// kernel (bf16 and fp32); a wider bf16 call (the 256-token prefill chunk
// fused into a paged step) runs the tensor-core body of
// decode_chunk.cuh; a wider fp32 call runs the 64-row FMA body of
// decode_rows.cuh. K7 runs the 64-row body at every width. Decode calls
// are bound by the bytes of K and V they read, prefill chunks by those
// bytes with their operations close behind; the bodies, their int8
// arithmetic and what they do about their bounds are in the headers.
//
// The pools are (hkv, nblocks, page, d), shared by every batch row, and
// a (b, max_blocks) int32 page table maps logical block j of row b to
// pool block pages[b, j]. On the TPU the translation lived in the
// BlockSpec index maps and a grid step was one page, so pages had to be
// a multiple of 8 (else the JAX package routed to its gathered
// reference). Here each block resolves the storage row of every key of
// its 64-key tile through the table itself, so a tile may span several
// pages (page 16, page 24) or part of one (page 128): every page size
// runs on the kernel. Reads stay O(valid_len) and touch only the pool
// blocks the table names; for K7 the scale pools (hkv, nblocks, page)
// are read at the same storage row as the values.

#include "decode_chunk.cuh"

namespace {

// Shared argument checks of the entry points; fills `a`'s paged fields.
// Returns false when the sizes are out of range.
bool paged_args(hops::decode::Args& a, const void* q, const void* k, const void* v,
                const void* valid_len, const void* pages, void* o, int hkv, int rows,
                int s, int page, int max_blocks, int nblocks, float sm_scale, int window) {
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

}  // namespace

extern "C" {

// q: (b*hkv, rows, head_dim) with rows = g*s, bf16 or fp32 (is_bf16);
// k, v: (hkv, nblocks, page, head_dim) pools of q's dtype; valid_len:
// (b,) int32; pages: (b, max_blocks) int32; o like q. All contiguous on
// the current device. window <= 0 means none. rows <= 16 takes the
// split body with n_splits splits of split_keys keys (a multiple of 64,
// n_splits * split_keys >= max_blocks * page) and, for n_splits > 1, an
// fp32 workspace of n_splits * b*hkv * rows * (head_dim + 2) values;
// wider calls take the tensor-core body (bf16) or the 64-row body (fp32)
// and need n_splits == 1. Returns 0 or a cudaError_t code.
int hops_paged_decode_attention(const void* q, const void* k, const void* v,
                                const void* valid_len, const void* pages, void* o,
                                void* workspace, int b, int hkv, int rows, int s, int page,
                                int max_blocks, int nblocks, int head_dim, int is_bf16,
                                float sm_scale, int window, int n_splits, int split_keys,
                                void* stream) {
  hops::decode::Args a{};
  if (!paged_args(a, q, k, v, valid_len, pages, o, hkv, rows, s, page, max_blocks, nblocks,
                  sm_scale, window))
    return (int)cudaErrorInvalidValue;
  if (rows <= hops::split::MAX_ROWS)
    return hops::split::dispatch</*PAGED=*/true>(a, b, head_dim, is_bf16,
                                                 static_cast<float*>(workspace), n_splits,
                                                 split_keys, stream);
  if (n_splits != 1) return (int)cudaErrorInvalidValue;
  if (is_bf16) return hops::chunk::dispatch(a, b, head_dim, stream);
  return hops::decode::dispatch</*Q8=*/false, /*PAGED=*/true>(a, b, head_dim, is_bf16, stream);
}

// Dynamic shared memory (bytes) of the tensor-core body at head_dim, or
// -1 for a head_dim it does not take.
int hops_paged_decode_attention_chunk_smem_bytes(int head_dim) {
  if (head_dim == 64) return static_cast<int>(hops::chunk::smem_bytes<64>());
  if (head_dim == 128) return static_cast<int>(hops::chunk::smem_bytes<128>());
  return -1;
}

// As above over int8 pools, with fp32 scale pools k_scale, v_scale of
// shape (hkv, nblocks, page).
int hops_paged_decode_attention_q8(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   const void* valid_len, const void* pages, void* o, int b,
                                   int hkv, int rows, int s, int page, int max_blocks,
                                   int nblocks, int head_dim, int is_bf16, float sm_scale,
                                   int window, void* stream) {
  hops::decode::Args a{};
  if (!paged_args(a, q, k, v, valid_len, pages, o, hkv, rows, s, page, max_blocks, nblocks,
                  sm_scale, window))
    return (int)cudaErrorInvalidValue;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  return hops::decode::dispatch</*Q8=*/true, /*PAGED=*/true>(a, b, head_dim, is_bf16, stream);
}

const char* hops_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

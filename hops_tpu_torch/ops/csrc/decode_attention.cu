// Decode attention against a dense KV cache, for Hopper (sm_90a): the
// port of K4, `_decode_kernel` in hops_tpu/ops/attention.py (launched
// by `decode_attention`). Key kpos of batch row b and kv head h is cache
// row (b*hkv + h) * cap + kpos.
//
// Three bodies, chosen by the call's shape and dtype:
// - a call of rows = g*s <= 16 (every decode step, a speculative verify
//   of few rows) runs the split-K body of decode_split.cuh on the dense
//   layout and, when it has more than one split, its combine kernel;
//   it is bound by the bytes of K and V it reads (4*d bytes per visible
//   key against ~4*d operations per key and row) and puts n_splits *
//   b*hkv blocks in flight, each streaming its share of the keys;
// - a wider bf16 call (a multi-token append to a warm cache: a prefix
//   hit's suffix; the main path's prefill on a fresh cache runs K1
//   instead) runs K1's tensor-core forward body (flash_fwd_tc.cuh) over
//   the bf16 cache: one block per 128 rows of a query head, each reading
//   kv head h / g, at the per-row offset valid_len - s;
// - a wider fp32 call runs the 64-row FMA body of decode_rows.cuh.
//
// Query rows: the s newest tokens of each batch row, already written
// into the cache, so chunk position i sits at absolute position
// valid_len - s + i. The g = heads / kv_heads query heads that share a
// kv head fold into g*s rows (the layout (b, hkv, g, s, d) is the
// query's own (b, h, s, d) memory): the split and 64-row bodies read a
// kv head's cache once for all of them, the forward body once per query
// head; all read only up to valid_len. Keys past valid_len are never
// visible, whatever the cache holds; a row with valid_len == 0 visits no
// tile and writes zeros.

#include "decode_split.cuh"
#include "flash_fwd_tc.cuh"

extern "C" {

// q: (b*hkv, rows, head_dim) with rows = g*s (the query's (b, h, s, d)
// memory); k, v: (b*hkv, cap, head_dim); valid_len: (b,) int32;
// o like q. All contiguous on the current device. is_bf16: 1 for
// bfloat16, 0 for float32. window <= 0 means none. rows <= 16 takes the
// split body with n_splits splits of split_keys keys (a multiple of 64,
// n_splits * split_keys >= cap) and, for n_splits > 1, an fp32 workspace
// of n_splits * b*hkv * rows * (head_dim + 2) values; wider calls take
// the tensor-core forward body (bf16) or the 64-row body (fp32) and
// need n_splits == 1. Returns 0 or a cudaError_t code.
int hops_decode_attention(const void* q, const void* k, const void* v,
                          const void* valid_len, void* o, void* workspace, int b, int hkv,
                          int rows, int s, int cap, int head_dim, int is_bf16,
                          float sm_scale, int window, int n_splits, int split_keys,
                          void* stream) {
  hops::decode::Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.valid_len = static_cast<const int*>(valid_len);
  a.o = o;
  a.hkv = hkv;
  a.rows = rows;
  a.s = s;
  a.cap = cap;
  a.sm_scale = sm_scale;
  a.window = window;
  if (rows <= hops::split::MAX_ROWS)
    return hops::split::dispatch</*PAGED=*/false>(a, b, head_dim, is_bf16,
                                                  static_cast<float*>(workspace), n_splits,
                                                  split_keys, stream);
  if (n_splits != 1) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    if (rows % s) return (int)cudaErrorInvalidValue;
    return hops::fwd::launch_decode</*Q8=*/false>(
        q, k, v, nullptr, nullptr, a.valid_len, o, b, hkv * (rows / s), hkv, s, cap, head_dim,
        sm_scale, window, static_cast<cudaStream_t>(stream));
  }
  return hops::decode::dispatch</*Q8=*/false, /*PAGED=*/false>(a, b, head_dim, stream);
}

// Dynamic shared memory (bytes) of the tensor-core forward body over
// bf16 K/V (the wide bf16 calls) at head_dim, or -1 for a head_dim it
// does not take.
int hops_decode_attention_chunk_smem_bytes(int head_dim) {
  return hops::fwd::smem_bytes_at(head_dim, false);
}

// Dynamic shared memory (bytes) of the split-K body of every decode
// kernel for a cache of kv_bytes-byte elements (4 fp32, 2 bf16, 1 int8),
// head_dim and rows bucket (1, 4 or 16), or -1 for a shape it does not
// take.
int hops_split_smem_bytes(int kv_bytes, int head_dim, int rows) {
  if ((kv_bytes != 1 && kv_bytes != 2 && kv_bytes != 4) || (head_dim != 64 && head_dim != 128) ||
      (rows != 1 && rows != 4 && rows != hops::split::MAX_ROWS))
    return -1;
  return static_cast<int>(hops::split::smem_bytes(kv_bytes, head_dim, rows));
}

const char* hops_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

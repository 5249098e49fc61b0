// Decode attention against a dense KV cache, for Hopper (sm_90a): the
// port of K4, `_decode_kernel` in hops_tpu/ops/attention.py (launched
// by `decode_attention`). Key kpos of batch row b and kv head h is cache
// row (b*hkv + h) * cap + kpos.
//
// Two bodies, chosen by the call's shape: a call of rows = g*s <= 16
// (every decode step) runs the split-K body of decode_split.cuh on the
// dense layout and, when it has more than one split, its combine kernel;
// a wider call (a multi-token append to a warm cache; the main path's
// prefill on a fresh cache runs K1 instead) runs the 64-row body of
// decode_rows.cuh. Both are bound by the bytes of K and V they read
// (4*d bytes per visible key against ~4*d operations per key and row):
// the split body puts n_splits * b*hkv blocks in flight where the 64-row
// body had b*hkv, each streaming its share of the keys; both headers say
// how.
//
// Query rows: the s newest tokens of each batch row, already written
// into the cache, so chunk position i sits at absolute position
// valid_len - s + i. The g = heads / kv_heads query heads that share a
// kv head fold into g*s rows (the layout (b, hkv, g, s, d) is the
// query's own (b, h, s, d) memory), so each block reads its kv head's
// cache once for all of them, and only up to valid_len. Keys past
// valid_len are never visible, whatever the cache holds; a row with
// valid_len == 0 visits no tile and writes zeros.

#include "decode_split.cuh"

extern "C" {

// q: (b*hkv, rows, head_dim) with rows = g*s (the query's (b, h, s, d)
// memory); k, v: (b*hkv, cap, head_dim); valid_len: (b,) int32;
// o like q. All contiguous on the current device. is_bf16: 1 for
// bfloat16, 0 for float32. window <= 0 means none. rows <= 16 takes the
// split body with n_splits splits of split_keys keys (a multiple of 64,
// n_splits * split_keys >= cap) and, for n_splits > 1, an fp32 workspace
// of n_splits * b*hkv * rows * (head_dim + 2) values; wider calls take
// the 64-row body and need n_splits == 1. Returns 0 or a cudaError_t
// code.
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
  return hops::decode::dispatch</*Q8=*/false, /*PAGED=*/false>(a, b, head_dim, is_bf16, stream);
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

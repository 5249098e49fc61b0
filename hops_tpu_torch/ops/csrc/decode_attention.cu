// Decode attention against a dense KV cache, for Hopper (sm_90a): the
// port of K4, `_decode_kernel` in hops_tpu/ops/attention.py (launched
// by `decode_attention`). The kernel body and what bounds it are in
// decode_rows.cuh, shared with the int8 and paged decode kernels; here
// key kpos of batch row b and kv head h is cache row (b*hkv + h) * cap
// + kpos, and bf16/fp32 rows convert to fp32 in shared memory.
//
// Query rows: the s newest tokens of each batch row, already written
// into the cache, so chunk position i sits at absolute position
// valid_len - s + i. The g = heads / kv_heads query heads that share a
// kv head fold into g*s rows (the layout (b, hkv, g, s, d) is the
// query's own (b, h, s, d) memory), so each block reads its kv head's
// cache once for all of them, and only up to valid_len. Keys past
// valid_len are never visible, whatever the cache holds; a row with
// valid_len == 0 visits no tile and writes zeros.

#include "decode_rows.cuh"

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
  return hops::decode::dispatch</*Q8=*/false, /*PAGED=*/false>(a, b, head_dim, is_bf16, stream);
}

const char* hops_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

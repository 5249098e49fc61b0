// Decode attention against a dense int8 KV cache, for Hopper (sm_90a):
// the port of K5, `_decode_q8_kernel` in hops_tpu/ops/attention.py
// (launched by `decode_attention` with k_scale/v_scale, through
// `decode_attention_q8`). The kernel body, its int8 arithmetic and what
// bounds it are in decode_rows.cuh; here key kpos of batch row b and kv
// head h is cache row (b*hkv + h) * cap + kpos, and its fp32 scales sit
// at the same index of the (b*hkv, cap) scale tables.
//
// Per visible key and kv head it reads 2*d bytes of int8 K/V plus 8
// bytes of scales (264 B at d 128), against K4's 4*d bytes of bf16.

#include "decode_rows.cuh"

extern "C" {

// q: (b*hkv, rows, head_dim) with rows = g*s (the query's (b, h, s, d)
// memory), bf16 or fp32 (is_bf16); k, v: (b*hkv, cap, head_dim) int8;
// k_scale, v_scale: (b*hkv, cap) fp32; valid_len: (b,) int32; o like q.
// All contiguous on the current device. window <= 0 means none.
// Returns 0 or a cudaError_t code.
int hops_decode_attention_q8(const void* q, const void* k, const void* v,
                             const void* k_scale, const void* v_scale,
                             const void* valid_len, void* o, int b, int hkv, int rows,
                             int s, int cap, int head_dim, int is_bf16, float sm_scale,
                             int window, void* stream) {
  hops::decode::Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.valid_len = static_cast<const int*>(valid_len);
  a.o = o;
  a.hkv = hkv;
  a.rows = rows;
  a.s = s;
  a.cap = cap;
  a.sm_scale = sm_scale;
  a.window = window;
  return hops::decode::dispatch</*Q8=*/true, /*PAGED=*/false>(a, b, head_dim, is_bf16, stream);
}

const char* hops_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Decode attention against a dense int8 KV cache, for Hopper (sm_90a):
// the port of K5, `_decode_q8_kernel` in hops_tpu/ops/attention.py
// (launched by `decode_attention` with k_scale/v_scale, through
// `decode_attention_q8`). Key kpos of batch row b and kv head h is cache
// row (b*hkv + h) * cap + kpos, and its fp32 scales sit at the same index
// of the (b*hkv, cap) scale tables.
//
// Three bodies, chosen by the call's shape and dtype, each instantiated
// for int8 K/V (the int8 arithmetic is in their headers):
// - a call of rows = g*s <= 16 (every decode step of the int8 engine)
//   runs the split-K body of decode_split.cuh and, with more than one
//   split, its combine kernel (bf16 and fp32 queries);
// - a wider bf16 call (the admission prefill, which reads its freshly
//   quantized chunk back: full causal attention over its own keys) runs
//   K1's tensor-core forward body (flash_fwd_tc.cuh) over int8 K/V: TMA
//   copies the int8 tiles into a staging ring, the two warpgroups widen
//   them to bf16 in shared memory, and the grid runs over query heads,
//   each reading kv head h / g;
// - a wider fp32 call runs the 64-row FMA body of decode_rows.cuh.
//
// Per visible key and kv head it reads 2*d bytes of int8 K/V plus 8
// bytes of scales (264 B at d 128), against K4's 4*d bytes of bf16.

#include "decode_split.cuh"
#include "flash_fwd_tc.cuh"

namespace {

// The wide bf16 calls, on the forward body over int8 K/V: q (b, h, s,
// D) bf16 with h = hkv * g; k, v (b * hkv, cap, D) int8; k_scale, v_scale
// (b * hkv, cap) fp32; valid_len (b,) int32; o like q. Causal at offset
// valid_len - s. Returns 0 or a cudaError_t code.
int launch_q8(const void* q, const void* k, const void* v, const float* k_scale,
              const float* v_scale, const int* valid_len, void* o, int b, int h, int hkv, int s,
              int cap, int head_dim, float sm_scale, int window, cudaStream_t stream) {
  const long long bh = static_cast<long long>(b) * h;
  if (b < 1 || hkv < 1 || h % hkv || s < 1 || cap < 1 || bh > 2147483647LL ||
      (s + hops::fwd::BM - 1) / hops::fwd::BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  hops::fwd::Args a{};
  a.o = static_cast<__nv_bfloat16*>(o);
  a.valid_len = valid_len;
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  a.seq_q = s;
  a.seq_k = cap;
  a.h = h;
  a.g = h / hkv;
  a.sm_scale = sm_scale;
  a.causal = 1;
  a.window = window;
  const int nq = static_cast<int>(bh);
  if (head_dim == 64) return hops::fwd::launch_body<64, true>(q, k, v, a, nq, b * hkv, stream);
  if (head_dim == 128) return hops::fwd::launch_body<128, true>(q, k, v, a, nq, b * hkv, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q: (b*hkv, rows, head_dim) with rows = g*s (the query's (b, h, s, d)
// memory), bf16 or fp32 (is_bf16); k, v: (b*hkv, cap, head_dim) int8;
// k_scale, v_scale: (b*hkv, cap) fp32; valid_len: (b,) int32; o like q.
// All contiguous on the current device. window <= 0 means none. rows <=
// 16 takes the split body with n_splits splits of split_keys keys (a
// multiple of 64, n_splits * split_keys >= cap) and, for n_splits > 1, an
// fp32 workspace of n_splits * b*hkv * rows * (head_dim + 2) values;
// wider calls take the tensor-core forward body (bf16) or the 64-row
// body (fp32) and need n_splits == 1. Returns 0 or a cudaError_t code.
int hops_decode_attention_q8(const void* q, const void* k, const void* v,
                             const void* k_scale, const void* v_scale,
                             const void* valid_len, void* o, void* workspace, int b, int hkv,
                             int rows, int s, int cap, int head_dim, int is_bf16,
                             float sm_scale, int window, int n_splits, int split_keys,
                             void* stream) {
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
  if (rows <= hops::split::MAX_ROWS)
    return hops::split::dispatch</*PAGED=*/false, /*Q8=*/true>(
        a, b, head_dim, is_bf16, static_cast<float*>(workspace), n_splits, split_keys, stream);
  if (n_splits != 1) return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    if (rows % s) return (int)cudaErrorInvalidValue;
    return launch_q8(q, k, v, a.k_scale, a.v_scale, a.valid_len, o, b, hkv * (rows / s), hkv, s,
                     cap, head_dim, sm_scale, window, static_cast<cudaStream_t>(stream));
  }
  return hops::decode::dispatch</*Q8=*/true, /*PAGED=*/false>(a, b, head_dim, is_bf16, stream);
}

// Dynamic shared memory (bytes) of the tensor-core forward body over
// int8 K/V (the wide bf16 calls) at head_dim, or -1 for a head_dim it
// does not take.
int hops_decode_attention_q8_chunk_smem_bytes(int head_dim) {
  return hops::fwd::smem_bytes_at(head_dim, true);
}

const char* hops_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Decode attention against a paged int8 KV cache, for Hopper (sm_90a):
// the port of K7, `_paged_decode_q8_kernel` in hops_tpu/ops/attention.py
// (launched by `paged_decode_attention` with k_scale/v_scale): K6
// (paged_decode_attention.cu, whose header says how the page table is
// read) over int8 pools, with fp32 scale pools (hkv, nblocks, page) read
// at the same storage row as their values, through the same table entry.
//
// Three bodies, chosen by the call's shape and dtype, each instantiated
// for int8 K/V (the int8 arithmetic is in their headers):
// - a call of rows = g*s <= 16 (every decode step of the paged int8
//   engine) runs the split-K body of decode_split.cuh and, with more than
//   one split, its combine kernel (bf16 and fp32 queries);
// - a wider bf16 call (the 256-token prefill chunk fused into a paged
//   step) runs the tensor-core body of decode_chunk.cuh;
// - a wider fp32 call runs the 64-row FMA body of decode_rows.cuh.
//
// Per visible key and kv head it reads 2*d bytes of int8 K/V plus 8
// bytes of scales (264 B at d 128), against K6's 4*d bytes of bf16.

#include "decode_chunk.cuh"

extern "C" {

// q: (b*hkv, rows, head_dim) with rows = g*s, bf16 or fp32 (is_bf16);
// k, v: (hkv, nblocks, page, head_dim) int8 pools; k_scale, v_scale:
// (hkv, nblocks, page) fp32 scale pools; valid_len: (b,) int32; pages:
// (b, max_blocks) int32; o like q. All contiguous on the current device.
// window <= 0 means none. rows <= 16 takes the split body with n_splits
// splits of split_keys keys (a multiple of 64, n_splits * split_keys >=
// max_blocks * page) and, for n_splits > 1, an fp32 workspace of
// n_splits * b*hkv * rows * (head_dim + 2) values; wider calls take the
// tensor-core body (bf16) or the 64-row body (fp32) and need n_splits ==
// 1. Returns 0 or a cudaError_t code.
int hops_paged_decode_attention_q8(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale,
                                   const void* valid_len, const void* pages, void* o,
                                   void* workspace, int b, int hkv, int rows, int s, int page,
                                   int max_blocks, int nblocks, int head_dim, int is_bf16,
                                   float sm_scale, int window, int n_splits, int split_keys,
                                   void* stream) {
  hops::decode::Args a{};
  if (!hops::decode::paged_args(a, q, k, v, valid_len, pages, o, hkv, rows, s, page,
                                max_blocks, nblocks, sm_scale, window))
    return (int)cudaErrorInvalidValue;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  if (rows <= hops::split::MAX_ROWS)
    return hops::split::dispatch</*PAGED=*/true, /*Q8=*/true>(
        a, b, head_dim, is_bf16, static_cast<float*>(workspace), n_splits, split_keys, stream);
  if (n_splits != 1) return (int)cudaErrorInvalidValue;
  if (is_bf16) return hops::chunk::dispatch</*Q8=*/true>(a, b, head_dim, stream);
  return hops::decode::dispatch</*Q8=*/true, /*PAGED=*/true>(a, b, head_dim, is_bf16, stream);
}

// Dynamic shared memory (bytes) of the int8 tensor-core body at
// head_dim, or -1 for a head_dim it does not take.
int hops_paged_decode_attention_q8_chunk_smem_bytes(int head_dim) {
  return hops::chunk::smem_bytes_at(head_dim, true);
}

const char* hops_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

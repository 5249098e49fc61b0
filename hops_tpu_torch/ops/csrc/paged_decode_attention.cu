// Decode attention against a paged KV cache, for Hopper (sm_90a): the
// port of K6, `_paged_decode_kernel` in hops_tpu/ops/attention.py
// (launched by `paged_decode_attention`); its int8 twin K7 is
// paged_decode_attention_q8.cu.
//
// Three bodies, chosen by the call's shape and dtype: a call of rows =
// g*s <= 16 (every decode step) runs the split-K body of
// decode_split.cuh and, when it has more than one split, its combine
// kernel (bf16 and fp32); a wider bf16 call (the 256-token prefill chunk
// fused into a paged step) runs the tensor-core body of
// decode_chunk.cuh; a wider fp32 call runs the 64-row FMA body of
// decode_rows.cuh. Decode calls are bound by the bytes of K and V they
// read, prefill chunks by those bytes with their operations close
// behind; the bodies and what they do about their bounds are in the
// headers.
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
// blocks the table names.

#include "decode_chunk.cuh"


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
  if (!hops::decode::paged_args(a, q, k, v, valid_len, pages, o, hkv, rows, s, page,
                                max_blocks, nblocks, sm_scale, window))
    return (int)cudaErrorInvalidValue;
  if (rows <= hops::split::MAX_ROWS)
    return hops::split::dispatch</*PAGED=*/true>(a, b, head_dim, is_bf16,
                                                 static_cast<float*>(workspace), n_splits,
                                                 split_keys, stream);
  if (n_splits != 1) return (int)cudaErrorInvalidValue;
  if (is_bf16) return hops::chunk::dispatch</*Q8=*/false>(a, b, head_dim, stream);
  return hops::decode::dispatch</*Q8=*/false, /*PAGED=*/true>(a, b, head_dim, stream);
}

// Dynamic shared memory (bytes) of the tensor-core body at head_dim, or
// -1 for a head_dim it does not take.
int hops_paged_decode_attention_chunk_smem_bytes(int head_dim) {
  return hops::chunk::smem_bytes_at(head_dim, false);
}

const char* hops_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

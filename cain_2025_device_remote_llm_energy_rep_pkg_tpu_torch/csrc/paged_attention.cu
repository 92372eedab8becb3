// Hopper (sm_90a) paged-attention kernels of the PyTorch port, with a plain
// C interface for ctypes (ops/_kernels.py builds each csrc/*.cu with nvcc at
// first use; ops/cuda_paged_attention.py holds the wrappers and their launch
// counts).
//
// Both entry points replace a Pallas kernel of
// cain_2025_device_remote_llm_energy_rep_pkg_tpu/ops/pallas_paged_attention.py:
//
// 4. paged_parts (bf16/f32 pool) — pallas_paged_decode_attention_parts
//    (_paged_decode_parts_kernel, body _accumulate_page).
// 5. paged_parts (int8 pool) — pallas_paged_decode_attention_parts_int8
//    (_paged_decode_parts_int8_kernel, body _accumulate_page_int8). The K
//    scale multiplies the score of its position and the V scale folds into
//    p; no dequantized page exists.
//
// Contract: one query per row, q [B,Hq,D], attends the first lengths[b]
// cached tokens of its row, token n at (page_table[b, n / page], n % page)
// of a per-layer pool [P,Hkv,page,D] (int8: codes plus scales [P,Hkv,page]
// f32). Table entries are clipped to [0, P-1]; entries past a row's need
// are never read. The outputs are the UNNORMALISED parts acc [B,Hkv,G,D]
// f32 = Σ e^{s-m}·v, m [B,Hkv,G] f32 = max s, l [B,Hkv,G] f32 = Σ e^{s-m},
// which the transformer merges with its side cache of generated tokens. A
// row with lengths[b] == 0 gives exactly (0, -inf, 0).
//
// Design. The TPU grid is (B, Hkv, Jmax) with the page axis sequential;
// CUDA blocks run in no order and carry nothing between them. At the batch
// path's widths (qwen2:1.5b, Hkv 2, 16–32 rows) the (row, kv head) pairs
// alone would leave most of the 132 SMs idle, so each row's positions are
// split flash-decoding style: the split body of the contiguous decode
// kernel (decode_partial_kernel, decode_common.cuh) runs with a PagedRows
// address policy that looks the page up in the table, and writes per-split
// partials; parts_merge_kernel combines the splits into one (acc, m, l)
// without normalising. Splits past a row's length read nothing, so pages
// past the frontier are never touched. D ∈ {64, 96, 128, 256} natively (no
// padding to 128 lanes), scales [P,Hkv,page] with no trailing lane.
//
// Bound on an H100 SXM: bytes. Every cached K/V row of every row must be
// read once (int8: D codes plus a 4-byte scale per position), against
// 4·Hq·D flops per cached token; bound = bytes / 3.35 TB/s. This first
// version reads with plain loads (no TMA, no cp.async) and runs the dots
// on the CUDA cores.

#include "decode_common.cuh"

namespace {

using namespace port_attn;

// grid (B·Hkv, G), block D threads: acc[bh, g, d], m[bh, g], l[bh, g].
__global__ void parts_merge_kernel(const float* __restrict__ part_acc,
                                   const float* __restrict__ part_ml, float* __restrict__ acc,
                                   float* __restrict__ m_out, float* __restrict__ l_out,
                                   int group, int d_head, int n_split) {
  const int bh = blockIdx.x;
  const int g = blockIdx.y;
  const int d = threadIdx.x;
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) {
    const size_t p = (static_cast<size_t>(bh) * n_split + s) * group + g;
    mx = fmaxf(mx, part_ml[2 * p]);
  }
  float lsum = 0.f, a = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const size_t p = (static_cast<size_t>(bh) * n_split + s) * group + g;
    const float ms = part_ml[2 * p];
    if (ms != -INFINITY) {  // an empty split: skipped, never exp(-inf - -inf)
      const float c = expf(ms - mx);
      lsum += part_ml[2 * p + 1] * c;
      a += part_acc[p * d_head + d] * c;
    }
  }
  const size_t o = static_cast<size_t>(bh) * group + g;
  acc[o * d_head + d] = a;
  if (d == 0) {
    m_out[o] = mx;
    l_out[o] = lsum;
  }
}

template <typename T, typename KV, int D, bool kQuant>
cudaError_t launch_parts(const void* q, const void* k, const void* v, const float* k_scale,
                         const float* v_scale, const int* table, const int* lengths,
                         float* part_acc, float* part_ml, float* acc, float* m, float* l,
                         int batch, int hq, int hkv, int n_pool, int page, int jmax,
                         int n_split, int split_len, cudaStream_t stream) {
  const int group = hq / hkv;
  const PagedRows rows{table, jmax, page, hkv, n_pool};
  decode_partial_kernel<T, KV, D, kQuant, PagedRows>
      <<<dim3(n_split, batch * hkv), kDecWarps * 32, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
          k_scale, v_scale, lengths, part_acc, part_ml, rows, hkv, group, split_len,
          softmax_scale(D));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  parts_merge_kernel<<<dim3(batch * hkv, group), D, 0, stream>>>(part_acc, part_ml, acc, m, l,
                                                                group, D, n_split);
  return cudaGetLastError();
}

template <typename T, typename KV, bool kQuant>
cudaError_t dispatch_parts(int d_head, const void* q, const void* k, const void* v,
                           const float* k_scale, const float* v_scale, const int* table,
                           const int* lengths, float* part_acc, float* part_ml, float* acc,
                           float* m, float* l, int batch, int hq, int hkv, int n_pool,
                           int page, int jmax, int n_split, int split_len,
                           cudaStream_t stream) {
#define PAGED_PARTS_CASE(DH)                                                               \
  case DH:                                                                                 \
    return launch_parts<T, KV, DH, kQuant>(q, k, v, k_scale, v_scale, table, lengths,      \
                                           part_acc, part_ml, acc, m, l, batch, hq, hkv,   \
                                           n_pool, page, jmax, n_split, split_len, stream);
  switch (d_head) {
    PAGED_PARTS_CASE(64)
    PAGED_PARTS_CASE(96)
    PAGED_PARTS_CASE(128)
    PAGED_PARTS_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef PAGED_PARTS_CASE
}

}  // namespace

extern "C" {

const char* paged_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int paged_group_max() { return kGroupMax; }

// k_scale/v_scale null: the pools hold `dtype` elements; else int8 codes.
int paged_parts(int dtype, const void* q, const void* k, const void* v, const float* k_scale,
                const float* v_scale, const int* table, const int* lengths, float* part_acc,
                float* part_ml, float* acc, float* m, float* l, int batch, int hq, int hkv,
                int n_pool, int page, int jmax, int d_head, int n_split, int split_len,
                void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kGroupMax || n_pool <= 0 || page <= 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = k_scale != nullptr;
  if (dtype == kDtypeBF16) {
    if (quant)
      return dispatch_parts<__nv_bfloat16, int8_t, true>(
          d_head, q, k, v, k_scale, v_scale, table, lengths, part_acc, part_ml, acc, m, l,
          batch, hq, hkv, n_pool, page, jmax, n_split, split_len, s);
    return dispatch_parts<__nv_bfloat16, __nv_bfloat16, false>(
        d_head, q, k, v, nullptr, nullptr, table, lengths, part_acc, part_ml, acc, m, l, batch,
        hq, hkv, n_pool, page, jmax, n_split, split_len, s);
  }
  if (dtype == kDtypeF32) {
    if (quant)
      return dispatch_parts<float, int8_t, true>(d_head, q, k, v, k_scale, v_scale, table,
                                                 lengths, part_acc, part_ml, acc, m, l, batch,
                                                 hq, hkv, n_pool, page, jmax, n_split,
                                                 split_len, s);
    return dispatch_parts<float, float, false>(d_head, q, k, v, nullptr, nullptr, table,
                                               lengths, part_acc, part_ml, acc, m, l, batch,
                                               hq, hkv, n_pool, page, jmax, n_split, split_len,
                                               s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"

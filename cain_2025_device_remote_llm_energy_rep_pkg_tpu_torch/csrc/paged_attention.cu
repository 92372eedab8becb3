// Hopper (sm_90a) paged-attention kernels of the PyTorch port, with a plain
// C interface for ctypes (ops/_kernels.py builds each csrc/*.cu with nvcc at
// first use; ops/cuda_paged_attention.py holds the wrappers and their launch
// counts).
//
// The entry points replace the Pallas kernels of
// cain_2025_device_remote_llm_energy_rep_pkg_tpu/ops/pallas_paged_attention.py:
//
// 4. paged_parts (bf16/f32 pool) — pallas_paged_decode_attention_parts
//    (_paged_decode_parts_kernel, body _accumulate_page).
// 5. paged_parts (int8 pool) — pallas_paged_decode_attention_parts_int8
//    (_paged_decode_parts_int8_kernel, body _accumulate_page_int8). The K
//    scale multiplies the score of its position and the V scale folds into
//    p; no dequantized page exists.
// 6. paged_decode (bf16/f32 pool) — pallas_paged_decode_attention
//    (_paged_decode_kernel, _last_valid_page): the write-through decode.
// 7. paged_mq_parts (bf16/f32 pool) — pallas_paged_decode_attention_mq_parts
//    (_paged_decode_mq_parts_kernel via _mq_parts_call, _mq_limit).
// 8. paged_mq_parts (int8 pool) — pallas_paged_decode_attention_mq_parts_int8
//    (_paged_decode_mq_parts_int8_kernel), the scales folded as in 5.
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
// split flash-decoding style: the split body decode_partial_kernel
// (decode_common.cuh) runs with a PagedRows
// address policy that looks the page up in the table, and writes per-split
// partials; parts_merge_kernel combines the splits into one (acc, m, l)
// without normalising. Splits past a row's length read nothing, so pages
// past the frontier are never touched. D ∈ {64, 96, 128, 256} natively (no
// padding to 128 lanes), scales [P,Hkv,page] with no trailing lane.
//
// Normalised contract (6): the same reads, but the output is attention
// itself, out [B,Hq,D] in q's dtype = acc / l, as the contiguous decode
// kernel (B2) gives it. The JAX kernel pads D to 128 lanes (a Mosaic
// need); here D is native. A row with lengths[b] == 0 gives 0/0 = NaN,
// as the JAX kernel and the plain version do; the write-through decode
// never makes one (lengths = offset + 1). The step's own K/V must be in
// the pool before the launch (lengths counts it): the transformer writes
// it on the same stream just before. Design: B2's one-launch body,
// decode_tile_kernel (decode_common.cuh), with the PagedRows address
// policy: the wrapper sizes the grid from B·Hkv and Jmax·page, each block
// sizes its row's splits from lengths[b], a tile of kDcTile positions
// within one page (page % kDcTile == 0) costs one table lookup and
// arrives as contiguous 16-byte cp.async rows (any other page size looks
// up each position), and the last split of a (row, kv head) merges
// through an atomic ticket and normalises: one launch a call. Bound:
// bytes, as B4, plus the output.
//
// Multi-query contract (7, 8): Q <= kMqQueryMax query positions per row,
// q [B,Q,Hq,D] with offsets [B] (the absolute position of query 0); query
// j sees cached tokens kpos < min(lengths[b], offsets[b] + j + 1), and the
// parts come out per query position, acc [B,Q,Hkv,G,D], m and l [B,Q,Hkv,G].
// The TPU kernel folds the Q positions into the group dim and streams each
// row's pages once for all of them. Here Q·G score rows (30 for qwen2 at
// k = 4, 72 at most) do not fit the decode body's register-held group of
// kGroupMax, so mq_partial_kernel keeps queries and accumulators in
// dynamic shared memory (over 48 KB from about 24 rows at D 256, set with
// cudaFuncSetAttribute) and stages K/V 16 positions at a time; each
// staged tile serves every score row, so each split's pages are still
// read once. The split rule and parts_merge_kernel are B4's: the merge
// writes score row r = j·G + g to query position j. Splits past the last
// query's limit (the frontier) read nothing. At Q = 1 the wrapper calls
// paged_parts with lengths cut to min(lengths, offsets + 1): one code, so
// Q = 1 equals B4 bit for bit.
//
// Bound on an H100 SXM: bytes. Every cached K/V row of every row must be
// read once (int8: D codes plus a 4-byte scale per position), against
// 4·Hq·D flops per cached token and query position; bound = bytes / 3.35
// TB/s. This first version reads with plain loads (no TMA, no cp.async)
// and runs the dots on the CUDA cores.

#include "decode_common.cuh"

namespace {

using namespace port_attn;

// grid (B·Hkv, R), block D threads, R = Q·G score rows per (row, kv
// head): score row r is query position r / G, head r % G of the group.
// acc[b, r/G, h, r%G, d], m and l likewise ([B, Q, Hkv, G]); at Q = 1 this
// is acc[bh, g, d].
__global__ void parts_merge_kernel(const float* __restrict__ part_acc,
                                   const float* __restrict__ part_ml, float* __restrict__ acc,
                                   float* __restrict__ m_out, float* __restrict__ l_out,
                                   int group, int q_len, int hkv, int d_head, int n_split) {
  const int bh = blockIdx.x;
  const int r = blockIdx.y;
  const int rows = gridDim.y;
  const int d = threadIdx.x;
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) {
    const size_t p = (static_cast<size_t>(bh) * n_split + s) * rows + r;
    mx = fmaxf(mx, part_ml[2 * p]);
  }
  float lsum = 0.f, a = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const size_t p = (static_cast<size_t>(bh) * n_split + s) * rows + r;
    const float ms = part_ml[2 * p];
    if (ms != -INFINITY) {  // an empty split: skipped, never exp(-inf - -inf)
      const float c = expf(ms - mx);
      lsum += part_ml[2 * p + 1] * c;
      a += part_acc[p * d_head + d] * c;
    }
  }
  const int b = bh / hkv;
  const int h = bh % hkv;
  const size_t o =
      ((static_cast<size_t>(b) * q_len + r / group) * hkv + h) * group + r % group;
  acc[o * d_head + d] = a;
  if (d == 0) {
    m_out[o] = mx;
    l_out[o] = lsum;
  }
}

// The splits merge into the unnormalised (acc, m, l).
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
                                                                group, 1, hkv, D, n_split);
  return cudaGetLastError();
}

template <typename T, typename KV, bool kQuant>
cudaError_t dispatch_parts(int d_head, const void* q, const void* k, const void* v,
                           const float* k_scale, const float* v_scale, const int* table,
                           const int* lengths, float* part_acc, float* part_ml, float* acc,
                           float* m, float* l, int batch, int hq, int hkv,
                           int n_pool, int page, int jmax, int n_split, int split_len,
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

// ---- multi-query parts (B7/B8): the speculative verify block --------------
constexpr int kMqWarps = 8;
constexpr int kMqTile = 16;     // positions staged in shared memory per pass
constexpr int kMqQueryMax = 9;  // query positions per row: k + 1 for k <= 8

// Dynamic shared memory of mq_partial_kernel, in 4-byte words: queries
// [R][D+1] and accumulators [R][D] (f32), the staged K tile [kMqTile][D+1]
// and V tile [kMqTile][D], the tile's scores/probabilities [R][kMqTile],
// per-row m, l, alpha and limit [R] each, and the tile's K/V scales.
// The +1 pads keep column reads of the K tile and of two query rows on
// distinct banks.
inline size_t mq_smem_bytes(int rows, int d) {
  const size_t words = static_cast<size_t>(rows) * (d + 1) + static_cast<size_t>(rows) * d +
                       static_cast<size_t>(kMqTile) * (d + 1) + static_cast<size_t>(kMqTile) * d +
                       static_cast<size_t>(rows) * kMqTile + 4 * static_cast<size_t>(rows) +
                       2 * kMqTile;
  return words * 4;
}

// grid (n_split, B·Hkv), block kMqWarps·32 threads. Block (split, bh)
// streams positions [split·split_len, min((split+1)·split_len, frontier))
// of row b, kv head h ONCE for all R = Q·G score rows: a tile of kMqTile
// positions is staged in shared memory, every (score row, position) pair
// is scored against it (one thread per pair, serial dot over D), each
// score row's online softmax is updated by one warp, and every thread
// then updates its share of the [R, D] accumulators. Score row r is query
// position j = r / G, head h·G + r % G, and sees positions
// t < min(len, offset + j + 1). Partials go to part_acc [B·Hkv, n_split,
// R, D] and part_ml [B·Hkv, n_split, R, 2] for parts_merge_kernel.
template <typename T, typename KV, int D, bool kQuant>
__global__ void __launch_bounds__(kMqWarps * 32)
    mq_partial_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                      const KV* __restrict__ v, const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale, const int* __restrict__ lengths,
                      const int* __restrict__ offsets, float* __restrict__ part_acc,
                      float* __restrict__ part_ml, PagedRows addr, int hkv, int group,
                      int q_len, int split_len, float scale) {
  extern __shared__ float smem[];
  constexpr int QS = D + 1;  // padded row strides
  constexpr int KS = D + 1;
  const int rows = q_len * group;
  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / hkv;
  const int h = bh % hkv;
  const int len = max(0, min(lengths[b], addr.capacity()));
  const int off = offsets[b];
  // the last query position's limit: no score row sees past it
  const int frontier = max(0, min(len, off + q_len));
  const int t_begin = split * split_len;
  const int t_end = min(t_begin + split_len, frontier);
  if (t_begin >= t_end) {
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const size_t p = (static_cast<size_t>(bh) * n_split + split) * rows + r;
      part_ml[2 * p] = -INFINITY;
      part_ml[2 * p + 1] = 0.f;
    }
    return;
  }

  float* qs = smem;
  float* acc = qs + rows * QS;
  float* kt = acc + rows * D;
  float* vt = kt + kMqTile * KS;
  float* ps = vt + kMqTile * D;
  float* ms = ps + rows * kMqTile;
  float* ls = ms + rows;
  float* alpha = ls + rows;
  int* lim = reinterpret_cast<int*>(alpha + rows);
  float* ksc = reinterpret_cast<float*>(lim + rows);
  float* vsc = ksc + kMqTile;

  const int hq = hkv * group;
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D;
    const int d = i % D;
    const int j = r / group;
    const size_t qi = ((static_cast<size_t>(b) * q_len + j) * hq + h * group + r % group) * D + d;
    qs[r * QS + d] = to_f(q[qi]);
    acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    ms[r] = -INFINITY;
    ls[r] = 0.f;
    lim[r] = max(0, min(len, off + r / group + 1));
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int t0 = t_begin; t0 < t_end; t0 += kMqTile) {
    const int n_t = min(kMqTile, t_end - t0);
    // 1. stage the tile (positions past the split read nothing: zeros)
    for (int i = threadIdx.x; i < kMqTile * D; i += blockDim.x) {
      const int tt = i / D;
      const int d = i % D;
      float kx = 0.f, vx = 0.f;
      if (tt < n_t) {
        const size_t rr = addr.row(bh, b, h, t0 + tt);
        kx = to_f(k[rr * D + d]);
        vx = to_f(v[rr * D + d]);
      }
      kt[tt * KS + d] = kx;
      vt[tt * D + d] = vx;
    }
    if (threadIdx.x < kMqTile) {
      const int tt = threadIdx.x;
      float a = 1.f, c = 1.f;
      if (kQuant && tt < n_t) {
        const size_t rr = addr.row(bh, b, h, t0 + tt);
        a = k_scale[rr];
        c = v_scale[rr];
      }
      ksc[tt] = a;
      vsc[tt] = c;
    }
    __syncthreads();
    // 2. scores: a half-warp holds one score row against the tile's
    //    positions, one position per lane
    {
      const int tt = lane % kMqTile;
      for (int r = warp * (32 / kMqTile) + lane / kMqTile; r < rows;
           r += kMqWarps * (32 / kMqTile)) {
        const float* qr = qs + r * QS;
        const float* kr = kt + tt * KS;
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) s += qr[d] * kr[d];
        s *= scale;
        if (kQuant) s *= ksc[tt];
        ps[r * kMqTile + tt] = (tt < n_t && t0 + tt < lim[r]) ? s : -INFINITY;
      }
    }
    __syncthreads();
    // 3. online softmax: one warp per score row
    for (int r = warp; r < rows; r += kMqWarps) {
      const float s = lane < kMqTile ? ps[r * kMqTile + lane] : -INFINITY;
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      float a = 1.f, p = 0.f;
      if (m_new != -INFINITY) {  // else nothing visible yet: acc stays 0
        a = expf(m_old - m_new);  // 0 on the first visible key
        p = expf(s - m_new);      // exp(-inf) = 0 on masked positions
      }
      const float psum = warp_sum(p);
      if (lane < kMqTile) ps[r * kMqTile + lane] = p * vsc[lane];  // V scale folds into p
      if (lane == 0) {
        ms[r] = m_new;
        ls[r] = ls[r] * a + psum;
        alpha[r] = a;
      }
    }
    __syncthreads();
    // 4. accumulators
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D;
      const int d = i % D;
      const float* pr = ps + r * kMqTile;
      float x = acc[i] * alpha[r];
#pragma unroll
      for (int tt = 0; tt < kMqTile; ++tt) x += pr[tt] * vt[tt * D + d];
      acc[i] = x;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D;
    const size_t p = (static_cast<size_t>(bh) * n_split + split) * rows + r;
    part_acc[p * D + i % D] = acc[i];
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const size_t p = (static_cast<size_t>(bh) * n_split + split) * rows + r;
    part_ml[2 * p] = ms[r];
    part_ml[2 * p + 1] = ls[r];
  }
}

template <typename T, typename KV, int D, bool kQuant>
cudaError_t launch_mq_parts(const void* q, const void* k, const void* v, const float* k_scale,
                            const float* v_scale, const int* table, const int* lengths,
                            const int* offsets, float* part_acc, float* part_ml, float* acc,
                            float* m, float* l, int batch, int q_len, int hq, int hkv,
                            int n_pool, int page, int jmax, int n_split, int split_len,
                            cudaStream_t stream) {
  const int group = hq / hkv;
  const int rows = q_len * group;
  const size_t smem = mq_smem_bytes(rows, D);
  auto kernel = mq_partial_kernel<T, KV, D, kQuant>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const PagedRows addr{table, jmax, page, hkv, n_pool};
  kernel<<<dim3(n_split, batch * hkv), kMqWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v), k_scale,
      v_scale, lengths, offsets, part_acc, part_ml, addr, hkv, group, q_len, split_len,
      softmax_scale(D));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  parts_merge_kernel<<<dim3(batch * hkv, rows), D, 0, stream>>>(part_acc, part_ml, acc, m, l,
                                                               group, q_len, hkv, D, n_split);
  return cudaGetLastError();
}

template <typename T, typename KV, bool kQuant>
cudaError_t dispatch_mq_parts(int d_head, const void* q, const void* k, const void* v,
                              const float* k_scale, const float* v_scale, const int* table,
                              const int* lengths, const int* offsets, float* part_acc,
                              float* part_ml, float* acc, float* m, float* l, int batch,
                              int q_len, int hq, int hkv, int n_pool, int page, int jmax,
                              int n_split, int split_len, cudaStream_t stream) {
#define PAGED_MQ_CASE(DH)                                                                  \
  case DH:                                                                                 \
    return launch_mq_parts<T, KV, DH, kQuant>(q, k, v, k_scale, v_scale, table, lengths,   \
                                              offsets, part_acc, part_ml, acc, m, l, batch, \
                                              q_len, hq, hkv, n_pool, page, jmax, n_split,  \
                                              split_len, stream);
  switch (d_head) {
    PAGED_MQ_CASE(64)
    PAGED_MQ_CASE(96)
    PAGED_MQ_CASE(128)
    PAGED_MQ_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef PAGED_MQ_CASE
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
        d_head, q, k, v, nullptr, nullptr, table, lengths, part_acc, part_ml, acc, m, l,
        batch, hq, hkv, n_pool, page, jmax, n_split, split_len, s);
  }
  if (dtype == kDtypeF32) {
    if (quant)
      return dispatch_parts<float, int8_t, true>(d_head, q, k, v, k_scale, v_scale, table,
                                                 lengths, part_acc, part_ml, acc, m, l, batch,
                                                 hq, hkv, n_pool, page, jmax, n_split,
                                                 split_len, s);
    return dispatch_parts<float, float, false>(d_head, q, k, v, nullptr, nullptr, table,
                                               lengths, part_acc, part_ml, acc, m, l, batch, hq,
                                               hkv, n_pool, page, jmax, n_split, split_len, s);
  }
  return cudaErrorInvalidValue;
}

// B6: normalised attention out [B,Hq,D] of `dtype` over a bf16/f32 pool (the
// JAX package has no int8 twin of this kernel). n_grid blocks per (row, kv
// head), 1..128 (the wrapper's decode_grid over Jmax·page); part_acc
// [B·Hkv, n_grid, G, D] and part_ml [B·Hkv, n_grid, G, 2] the split
// scratch; tickets [B·Hkv] zero.
int paged_decode(int dtype, const void* q, const void* k, const void* v, const int* table,
                 const int* lengths, float* part_acc, float* part_ml, int* tickets, void* out,
                 int batch, int hq, int hkv, int n_pool, int page, int jmax, int d_head,
                 int n_grid, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kGroupMax || n_pool <= 0 || page <= 0 ||
      jmax <= 0 || out == nullptr)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PagedRows rows{table, jmax, page, hkv, n_pool};
  if (dtype == kDtypeBF16)
    return dispatch_decode_tile<__nv_bfloat16, __nv_bfloat16, false>(
        d_head, q, k, v, nullptr, nullptr, lengths, part_acc, part_ml, tickets, out, batch, hq,
        hkv, rows, n_grid, s);
  if (dtype == kDtypeF32)
    return dispatch_decode_tile<float, float, false>(d_head, q, k, v, nullptr, nullptr, lengths,
                                                     part_acc, part_ml, tickets, out, batch, hq,
                                                     hkv, rows, n_grid, s);
  return cudaErrorInvalidValue;
}

int paged_mq_query_max() { return kMqQueryMax; }

// Q >= 2 query positions per row (Q = 1 is paged_parts with lengths cut to
// the causal limit). k_scale/v_scale null: the pools hold `dtype`
// elements; else int8 codes.
int paged_mq_parts(int dtype, const void* q, const void* k, const void* v, const float* k_scale,
                   const float* v_scale, const int* table, const int* lengths,
                   const int* offsets, float* part_acc, float* part_ml, float* acc, float* m,
                   float* l, int batch, int q_len, int hq, int hkv, int n_pool, int page,
                   int jmax, int d_head, int n_split, int split_len, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kGroupMax || q_len < 1 || q_len > kMqQueryMax ||
      n_pool <= 0 || page <= 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = k_scale != nullptr;
  if (dtype == kDtypeBF16) {
    if (quant)
      return dispatch_mq_parts<__nv_bfloat16, int8_t, true>(
          d_head, q, k, v, k_scale, v_scale, table, lengths, offsets, part_acc, part_ml, acc, m,
          l, batch, q_len, hq, hkv, n_pool, page, jmax, n_split, split_len, s);
    return dispatch_mq_parts<__nv_bfloat16, __nv_bfloat16, false>(
        d_head, q, k, v, nullptr, nullptr, table, lengths, offsets, part_acc, part_ml, acc, m,
        l, batch, q_len, hq, hkv, n_pool, page, jmax, n_split, split_len, s);
  }
  if (dtype == kDtypeF32) {
    if (quant)
      return dispatch_mq_parts<float, int8_t, true>(
          d_head, q, k, v, k_scale, v_scale, table, lengths, offsets, part_acc, part_ml, acc, m,
          l, batch, q_len, hq, hkv, n_pool, page, jmax, n_split, split_len, s);
    return dispatch_mq_parts<float, float, false>(
        d_head, q, k, v, nullptr, nullptr, table, lengths, offsets, part_acc, part_ml, acc, m,
        l, batch, q_len, hq, hkv, n_pool, page, jmax, n_split, split_len, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"

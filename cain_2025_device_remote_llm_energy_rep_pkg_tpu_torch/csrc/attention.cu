// Hopper (sm_90a) attention kernels of the PyTorch port, with a plain C
// interface for ctypes (ops/_kernels.py builds this file with nvcc at first
// use; ops/cuda_attention.py holds the wrappers and their launch counts).
//
// Layouts are the JAX package's: q [B,S,Hq,D] (prefill) or [B,Hq,D]
// (decode); caches [B,Hkv,T,D], each head's T rows contiguous; int8 cache
// scales [B,Hkv,T] f32; lengths [B] int32. Element types: float32 or
// bfloat16 for q/k/v/out, int8 codes for the quantized cache. Every load is
// widened to f32 and all score, softmax and accumulator math is f32; the
// output is cast to the input type once, at the end. Head dims 64, 96, 128
// and 256 are supported natively (no padding to 128 lanes); the softmax
// scale is 1/sqrt(D).
//
// The kernels launch on the caller's stream, allocate nothing (the wrapper
// passes the outputs and the split-T scratch) and each entry point returns
// the cudaError_t of its launches.
//
// 1. attn_prefill — replaces pallas_prefill_attention (_prefill_kernel,
//    cain_2025_device_remote_llm_energy_rep_pkg_tpu/ops/pallas_attention.py).
//    S queries at cache positions offset..offset+S-1 attend the cache with
//    the mask kpos <= qpos. One block per (b, kv head, query tile); the tile's
//    block_q positions times the G query heads of the group form up to 64
//    query rows that share every K/V tile loaded into shared memory. The
//    block loops over 32-key tiles only up to its causal frontier
//    offset + q_start + block_q - 1 (the TPU grid's sequential k axis becomes
//    this loop) with an online softmax, so no [S,T] score matrix exists.
//    Bound on an H100 SXM: the larger of bytes (q, out and the attended K/V
//    prefix, each once) / 3.35 TB/s and 4·Hq·D flops per attended
//    (query, key) pair / 989 TFLOP/s. At qwen2:1.5b widths a short prompt
//    (S = 64) is bytes-bound and a full 2048-token chunk operations-bound.
//    This first version runs its products on the CUDA cores in f32 from
//    shared memory, not on the tensor cores, so it sits far above either
//    bound; wgmma/TMA tiles are the work of a later change.
//
// 2. attn_decode (bf16/f32 cache) — replaces pallas_decode_attention
//    (_decode_kernel, same file). One query per row against the cache,
//    masked by t < lengths[b].
// 3. attn_decode (int8 cache) — replaces pallas_decode_attention_int8
//    (_decode_kernel_int8, same file). The K scale multiplies the score of
//    its position and the V scale folds into p; no dequantized cache exists.
//
//    Decode is bound by bytes: the valid K/V prefix (int8: codes plus one
//    f32 scale per position) must stream from HBM once per step (bound =
//    bytes / 3.35 TB/s). One (b, kv head) pair gives
//    only B·Hkv blocks (2 for qwen2:1.5b at B=1, on 132 SMs), so the kernel
//    splits T as flash-decoding does: block (split, b·Hkv) streams its slice
//    of positions — the G query heads of the group share each K/V row — and
//    writes unnormalised (acc, m, l) partials; a second small kernel merges
//    the splits. Splits wholly past lengths[b] read nothing. The split body
//    (decode_partial_kernel) lives in decode_common.cuh, shared with the
//    paged kernels of paged_attention.cu.

#include "decode_common.cuh"

namespace {

using namespace port_attn;

// ---------------------------------------------------------------------------
// Decode: split-T partials, then a merge that normalises (decode_partial_kernel
// and decode_merge_kernel, decode_common.cuh).

template <typename T, typename KV, int D, bool kQuant>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const float* k_scale,
                          const float* v_scale, const int* lengths, float* part_acc,
                          float* part_ml, void* out, int batch, int hq, int hkv, int t_cap,
                          int n_split, int split_len, float scale, cudaStream_t stream) {
  const int group = hq / hkv;
  dim3 grid(n_split, batch * hkv);
  decode_partial_kernel<T, KV, D, kQuant, ContiguousRows>
      <<<grid, kDecWarps * 32, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
          k_scale, v_scale, lengths, part_acc, part_ml, ContiguousRows{t_cap}, hkv, group,
          split_len, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T><<<dim3(batch * hkv, group), D, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), group, D, n_split);
  return cudaGetLastError();
}

template <typename T, typename KV, bool kQuant>
cudaError_t dispatch_decode(int d_head, const void* q, const void* k, const void* v,
                            const float* k_scale, const float* v_scale, const int* lengths,
                            float* part_acc, float* part_ml, void* out, int batch, int hq,
                            int hkv, int t_cap, int n_split, int split_len, float scale,
                            cudaStream_t stream) {
#define ATTN_DECODE_CASE(DH)                                                              \
  case DH:                                                                                \
    return launch_decode<T, KV, DH, kQuant>(q, k, v, k_scale, v_scale, lengths, part_acc, \
                                            part_ml, out, batch, hq, hkv, t_cap, n_split, \
                                            split_len, scale, stream);
  switch (d_head) {
    ATTN_DECODE_CASE(64)
    ATTN_DECODE_CASE(96)
    ATTN_DECODE_CASE(128)
    ATTN_DECODE_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef ATTN_DECODE_CASE
}

// ---------------------------------------------------------------------------
// Prefill.

constexpr int kPfRows = 64;     // query rows (positions × group heads) per block
constexpr int kPfKeys = 32;     // keys per shared-memory tile
constexpr int kPfThreads = 256; // 16 × 16; thread (ty, tx) owns rows ty + 16i

template <int D>
constexpr size_t prefill_smem_bytes() {
  return sizeof(float) * (kPfRows * (D + 1)      // Q rows
                          + kPfKeys * (D + 1)    // K tile (padded: no bank conflicts)
                          + kPfKeys * D          // V tile
                          + kPfRows * (kPfKeys + 1)  // scores, then probabilities
                          + 3 * kPfRows);        // alpha, m, l per row
}

template <typename T, int D>
__global__ void __launch_bounds__(kPfThreads)
    prefill_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   T* __restrict__ out, int seq, int hkv, int group, int t_cap, int offset,
                   int block_q, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kPfRows * (D + 1);
  float* vs = ks + kPfKeys * (D + 1);
  float* ps = vs + kPfKeys * D;
  float* row_alpha = ps + kPfRows * (kPfKeys + 1);
  float* row_m = row_alpha + kPfRows;
  float* row_l = row_m + kPfRows;
  constexpr int DJ = D / 16;  // output columns per thread

  const int bh = blockIdx.y;
  const int b = bh / hkv;
  const int h = bh % hkv;
  const int hq = hkv * group;
  const int q_start = blockIdx.x * block_q;
  const int n_pos = min(block_q, seq - q_start);
  const int n_rows = n_pos * group;  // row r: position q_start + r / G, head h·G + r % G
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int idx = tid; idx < kPfRows * D; idx += kPfThreads) {
    const int r = idx / D;
    const int d = idx % D;
    float val = 0.f;
    if (r < n_rows) {
      const int s = q_start + r / group;
      const int head = h * group + r % group;
      val = to_f(q[((static_cast<size_t>(b) * seq + s) * hq + head) * D + d]);
    }
    qs[r * (D + 1) + d] = val;
  }
  if (tid < kPfRows) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // Causal frontier: the last cache position any row of this block attends.
  const int last_pos = offset + q_start + n_pos - 1;
  const int n_tiles = min((t_cap + kPfKeys - 1) / kPfKeys, last_pos / kPfKeys + 1);
  const T* kh = k + static_cast<size_t>(bh) * t_cap * D;
  const T* vh = v + static_cast<size_t>(bh) * t_cap * D;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kPfKeys;
    __syncthreads();  // the previous tile's readers are done with ks/vs/ps
    for (int idx = tid; idx < kPfKeys * D; idx += kPfThreads) {
      const int c = idx / D;
      const int d = idx % D;
      const int kpos = k0 + c;
      float kv = 0.f, vv = 0.f;
      if (kpos < t_cap) {
        kv = to_f(kh[static_cast<size_t>(kpos) * D + d]);
        vv = to_f(vh[static_cast<size_t>(kpos) * D + d]);
      }
      ks[c * (D + 1) + d] = kv;
      vs[c * D + d] = vv;
    }
    __syncthreads();

    float sc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) sc[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = offset + q_start + r / group;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        const bool ok = r < n_rows && kpos <= qpos && kpos < t_cap;
        ps[r * (kPfKeys + 1) + c] = ok ? sc[i][j] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // Online softmax: one warp per row, one lane per key of the tile.
    for (int r = warp; r < kPfRows; r += kPfThreads / 32) {
      const float s = ps[r * (kPfKeys + 1) + lane];
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const bool empty = m_new == -INFINITY;  // no key of this row seen yet
      const float p = empty ? 0.f : expf(s - m_new);
      const float alpha = empty ? 1.f : expf(m_old - m_new);
      const float psum = warp_sum(p);
      ps[r * (kPfKeys + 1) + lane] = p;
      if (lane == 0) {
        row_alpha[r] = alpha;
        row_m[r] = m_new;
        row_l[r] = row_l[r] * alpha + psum;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= a;
    }
    for (int c = 0; c < kPfKeys; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (kPfKeys + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }

  // Every valid row attends at least its own position, so l > 0.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r < n_rows) {
      const int s = q_start + r / group;
      const int head = h * group + r % group;
      const float lsum = row_l[r];
      T* o = out + ((static_cast<size_t>(b) * seq + s) * hq + head) * D;
#pragma unroll
      for (int j = 0; j < DJ; ++j) o[tx + 16 * j] = from_f<T>(acc[i][j] / lsum);
    }
  }
}

template <typename T, int D>
cudaError_t launch_prefill(const void* q, const void* k, const void* v, void* out, int batch,
                           int seq, int hq, int hkv, int t_cap, int offset, float scale,
                           cudaStream_t stream) {
  const int group = hq / hkv;
  const int block_q = kPfRows / group;
  constexpr size_t smem = prefill_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(prefill_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((seq + block_q - 1) / block_q, batch * hkv);
  prefill_kernel<T, D><<<grid, kPfThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), seq, hkv, group, t_cap, offset, block_q, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_prefill(int d_head, const void* q, const void* k, const void* v,
                             void* out, int batch, int seq, int hq, int hkv, int t_cap,
                             int offset, float scale, cudaStream_t stream) {
  switch (d_head) {
    case 64:
      return launch_prefill<T, 64>(q, k, v, out, batch, seq, hq, hkv, t_cap, offset, scale, stream);
    case 96:
      return launch_prefill<T, 96>(q, k, v, out, batch, seq, hq, hkv, t_cap, offset, scale, stream);
    case 128:
      return launch_prefill<T, 128>(q, k, v, out, batch, seq, hq, hkv, t_cap, offset, scale, stream);
    case 256:
      return launch_prefill<T, 256>(q, k, v, out, batch, seq, hq, hkv, t_cap, offset, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Rows per block of the prefill kernel (query positions × group heads).
int attn_prefill_rows() { return kPfRows; }

int attn_decode_group_max() { return kGroupMax; }

int attn_prefill(int dtype, const void* q, const void* k, const void* v, void* out, int batch,
                 int seq, int hq, int hkv, int t_cap, int d_head, int offset, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kPfRows) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = softmax_scale(d_head);
  if (dtype == kDtypeBF16)
    return dispatch_prefill<__nv_bfloat16>(d_head, q, k, v, out, batch, seq, hq, hkv, t_cap,
                                           offset, scale, s);
  if (dtype == kDtypeF32)
    return dispatch_prefill<float>(d_head, q, k, v, out, batch, seq, hq, hkv, t_cap, offset,
                                   scale, s);
  return cudaErrorInvalidValue;
}

// k_scale/v_scale null: k/v hold `dtype` elements; else int8 codes.
int attn_decode(int dtype, const void* q, const void* k, const void* v, const float* k_scale,
                const float* v_scale, const int* lengths, float* part_acc, float* part_ml,
                void* out, int batch, int hq, int hkv, int t_cap, int d_head, int n_split,
                int split_len, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kGroupMax) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = softmax_scale(d_head);
  const bool quant = k_scale != nullptr;
  if (dtype == kDtypeBF16) {
    if (quant)
      return dispatch_decode<__nv_bfloat16, int8_t, true>(
          d_head, q, k, v, k_scale, v_scale, lengths, part_acc, part_ml, out, batch, hq, hkv,
          t_cap, n_split, split_len, scale, s);
    return dispatch_decode<__nv_bfloat16, __nv_bfloat16, false>(
        d_head, q, k, v, nullptr, nullptr, lengths, part_acc, part_ml, out, batch, hq, hkv,
        t_cap, n_split, split_len, scale, s);
  }
  if (dtype == kDtypeF32) {
    if (quant)
      return dispatch_decode<float, int8_t, true>(d_head, q, k, v, k_scale, v_scale, lengths,
                                                  part_acc, part_ml, out, batch, hq, hkv,
                                                  t_cap, n_split, split_len, scale, s);
    return dispatch_decode<float, float, false>(d_head, q, k, v, nullptr, nullptr, lengths,
                                                part_acc, part_ml, out, batch, hq, hkv, t_cap,
                                                n_split, split_len, scale, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"

// Shared pieces of the port's decode kernels: the element types, the
// warp reductions and the group cap of attention.cu (contiguous caches)
// and paged_attention.cu (page pools read through a table), and the paged
// kernels' split body.
//
// decode_partial_kernel is the split body of flash decoding: block
// (split, b·Hkv + h) streams cache positions [split·split_len,
// min((split+1)·split_len, lengths[b])) of row b, head h, and writes the
// split's unnormalised partials (acc, m, l). Where position t of a row
// lives is the `Rows` policy's business: PagedRows for [P,Hkv,page,D]
// pools read through a [B,Jmax] page table. decode_merge_kernel combines
// the splits into the normalised output (B6); the paged parts kernels
// keep their own merge, which does not normalise.
//
// Every load is widened to f32; scores, softmax and accumulators are f32.
// A split with no position to read writes (m -inf, l 0) and returns at
// once; every merge skips such partials (and their acc), so
// exp(-inf - -inf) is never formed.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace port_attn {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <>
__device__ __forceinline__ float to_f<int8_t>(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

inline float softmax_scale(int d_head) {
  return static_cast<float>(1.0 / sqrt(static_cast<double>(d_head)));
}

constexpr int kDecWarps = 4;
constexpr int kGroupMax = 8;  // query heads per kv head held in registers

// Row index (into [..., positions, D] element rows and [..., positions]
// scales) of position t of batch row b, kv head h; bh = b·Hkv + h.
struct PagedRows {
  const int* table;  // [B, Jmax]
  int jmax;
  int page;
  int hkv;
  int n_pool;  // P: table entries are clipped to [0, P-1]
  __device__ __forceinline__ int capacity() const { return jmax * page; }
  __device__ __forceinline__ size_t row(int /*bh*/, int b, int h, int t) const {
    int p = table[static_cast<size_t>(b) * jmax + t / page];
    p = min(max(p, 0), n_pool - 1);
    return (static_cast<size_t>(p) * hkv + h) * page + t % page;
  }
};

// part_acc [B·Hkv, n_split, G, D], part_ml [B·Hkv, n_split, G, 2] (m, l).
// With kQuant, k/v hold int8 codes and k_scale/v_scale one f32 scale per
// row: the K scale multiplies the score of its position and the V scale
// folds into p, so no dequantized cache exists.
template <typename T, typename KV, int D, bool kQuant, typename Rows>
__global__ void __launch_bounds__(kDecWarps * 32)
    decode_partial_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                          const KV* __restrict__ v, const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          const int* __restrict__ lengths, float* __restrict__ part_acc,
                          float* __restrict__ part_ml, Rows rows, int hkv, int group,
                          int split_len, float scale) {
  constexpr int V = D / 32;  // elements of a row per lane
  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / hkv;
  const int h = bh % hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = max(0, min(lengths[b], rows.capacity()));
  const int t_begin = split * split_len;
  const int t_end = min(t_begin + split_len, len);
  if (t_begin >= t_end) {
    // Nothing to read (past the row's length): m = -inf and l = 0 only;
    // the merges skip such a partial's acc, so it is not written.
    for (int g = threadIdx.x; g < group; g += blockDim.x) {
      const size_t p = (static_cast<size_t>(bh) * n_split + split) * group + g;
      part_ml[2 * p] = -INFINITY;
      part_ml[2 * p + 1] = 0.f;
    }
    return;
  }

  // q[b, h·G + g, :] for the group's heads: rows bh·G .. bh·G + G - 1.
  const T* qg = q + static_cast<size_t>(bh) * group * D;
  float qr[kGroupMax][V];
  float m[kGroupMax], l[kGroupMax], acc[kGroupMax][V];
#pragma unroll
  for (int g = 0; g < kGroupMax; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      qr[g][i] = g < group ? to_f(qg[g * D + lane * V + i]) : 0.f;
      acc[g][i] = 0.f;
    }
  }

  for (int t = t_begin + warp; t < t_end; t += kDecWarps) {
    const size_t r = rows.row(bh, b, h, t);
    const KV* kr = k + r * D + lane * V;
    const KV* vr = v + r * D + lane * V;
    float kv[V], vv[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      kv[i] = to_f(kr[i]);
      vv[i] = to_f(vr[i]);
    }
    const float ks = kQuant ? k_scale[r] : 1.f;
    const float vs = kQuant ? v_scale[r] : 1.f;
#pragma unroll
    for (int g = 0; g < kGroupMax; ++g) {
      if (g < group) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < V; ++i) s += qr[g][i] * kv[i];
        s = warp_sum(s) * scale;
        if (kQuant) s *= ks;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);  // 0 on the first key
        const float p = expf(s - m_new);
        l[g] = l[g] * alpha + p;
        m[g] = m_new;
        const float pv = p * vs;  // the int8 V scale folds into p
#pragma unroll
        for (int i = 0; i < V; ++i) acc[g][i] = acc[g][i] * alpha + pv * vv[i];
      }
    }
  }

  // Merge the block's warps, then write this split's partials.
  __shared__ float sm_m[kDecWarps][kGroupMax];
  __shared__ float sm_l[kDecWarps][kGroupMax];
  __shared__ float sm_acc[kDecWarps][kGroupMax][D];
#pragma unroll
  for (int g = 0; g < kGroupMax; ++g) {
    if (g < group) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < V; ++i) sm_acc[warp][g][lane * V + i] = acc[g][i];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < group * D; idx += blockDim.x) {
    const int g = idx / D;
    const int d = idx % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, a = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) {
        if (sm_m[w][g] != -INFINITY) {
          const float c = expf(sm_m[w][g] - mx);
          lsum += sm_l[w][g] * c;
          a += sm_acc[w][g][d] * c;
        }
      }
    }
    const size_t p = (static_cast<size_t>(bh) * n_split + split) * group + g;
    part_acc[p * D + d] = a;
    if (d == 0) {
      part_ml[2 * p] = mx;
      part_ml[2 * p + 1] = lsum;
    }
  }
}

// grid (B·Hkv, G), block D threads: out[b, h·G + g, d] = acc / l over the
// splits of part_acc/part_ml. A row with no position gives 0/0 (NaN), as
// the plain versions and the JAX kernels do; no decode path makes one.
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ part_acc,
                                    const float* __restrict__ part_ml, T* __restrict__ out,
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
    if (ms != -INFINITY) {
      const float c = expf(ms - mx);
      lsum += part_ml[2 * p + 1] * c;
      a += part_acc[p * d_head + d] * c;
    }
  }
  out[(static_cast<size_t>(bh) * group + g) * d_head + d] = from_f<T>(a / lsum);
}

}  // namespace port_attn

// Hopper (sm_90a) int4 weight matmul kernels of the PyTorch port, with a
// plain C interface for ctypes (ops/_kernels.py builds each csrc/*.cu with
// nvcc at first use; ops/cuda_quant.py holds the wrappers and their launch
// counts).
//
// int4_matmul replaces two Pallas kernels of
// cain_2025_device_remote_llm_energy_rep_pkg_tpu/ops/pallas_quant.py, and
// w4a8_matmul the one of scripts/w4a8_probe.py (11, at the end of the file):
//
// 9.  layout 0 (halves) — int4_matmul (_int4_matmul_kernel). packed
//     [K = IN/2, OUT] int8: packed row i holds weight row i in its low
//     nibble and weight row K + i in its high nibble.
// 10. layout 1 (int32 lanes) — int4_matmul_i32 (_int4_matmul_kernel_i32).
//     packed [K = IN/8, OUT] int32: nibble p of lane k is weight row 8k + p.
//
// Contract (both): out[M, OUT] = (bf16(x)[M, IN] @ w[IN, OUT]) * scale[OUT],
// cast once to x's dtype (bf16 or f32), 1 <= M <= 8. x is rounded to bf16
// before the product even when it is f32; the 4-bit weights are exact;
// products are summed in f32; the per-output-channel scale is applied once,
// after the k-sum. Any even IN (any IN divisible by 8 for layout 1) and any
// OUT: no 128-lane padding of K, no 8-row padding of x, no tile gates.
//
// Bound on an H100 SXM: bytes. At M <= 8 a packed byte carries two weights
// and meets at most 16 multiply-adds, far below the card's operations per
// byte; the weights must cross device memory once, packed, so bound =
// (packed bytes + scales + x + out) / 3.35 TB/s.
//
// Design. The TPU kernel keeps the whole of x resident in VMEM and walks the
// k-blocks of a column tile in order, carrying the sum in scratch. Here a
// block owns 128 output columns (a warp's 32 threads × 4 adjacent columns)
// and one split of the packed rows; its 8 warps take interleaved rows of
// the split. Each thread reads its 4 columns of a packed row as one 32-bit
// word (halves) or one 16-byte vector (int32 lanes), so a warp's loads
// coalesce into 128 (512) contiguous bytes; it unpacks the nibbles in
// registers and accumulates M × 4 f32 sums. Only the split's slice of x is
// staged in shared memory (rounded to bf16, kept as f32): at llama3.1:8b's
// w_down the whole of x would not fit a block's 227 KB. The 8 warps' sums
// are added in a fixed order through shared memory into f32 partials, one
// per split, and int4_merge_kernel adds the splits in order, scales and
// casts. No float atomics, so every run gives the same bits. Splits are
// chosen by the wrapper so that the thin projections (qwen2's wk/wv, OUT
// 256) still spread over the 132 SMs.

#include "decode_common.cuh"

namespace {

using port_attn::from_f;
using port_attn::kDtypeBF16;
using port_attn::kDtypeF32;
using port_attn::to_f;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 4;              // adjacent output columns per thread
constexpr int kTileCols = 32 * kCols;  // output columns per block
constexpr int kMaxRows = 8;            // rows of x
// Packed rows per split, at most (ops/cuda_quant.py keeps the same limits):
// 512 weight rows in either layout, so the staged x slice is at most
// 8 × 512 f32 = 16 KB.
constexpr int kMaxSplitRowsHalves = 256;
constexpr int kMaxSplitRowsI32 = 64;
constexpr int kLayoutHalves = 0;
constexpr int kLayoutI32 = 1;

// Sign-extended nibble at bit `shift` of a 32-bit word.
__device__ __forceinline__ float nibble(uint32_t w, int shift) {
  return static_cast<float>(static_cast<int32_t>(w << (28 - shift)) >> 28);
}

// x rounded to bf16, as an f32.
template <typename T>
__device__ __forceinline__ float x_bf16(T v) {
  return __bfloat162float(__float2bfloat16(to_f<T>(v)));
}

// Grid (ceil(OUT / 128), n_split), kThreads threads. Dynamic shared memory:
// max(kW · n · M, kWarps · M · 128) floats (the x slice, then the warps'
// sums).
template <typename T, int M, bool kI32, bool kVec>
__global__ void __launch_bounds__(kThreads)
    int4_partial_kernel(const T* __restrict__ x, const void* __restrict__ packed,
                        float* __restrict__ partial, int in_dim, int k_rows,
                        int out_dim, int split_rows) {
  constexpr int kW = kI32 ? 8 : 2;  // weight rows per packed row
  extern __shared__ __align__(16) float smem[];
  const int split = blockIdx.y;
  const int r0 = split * split_rows;
  const int n = min(split_rows, k_rows - r0);  // packed rows of this block (> 0)

  // Stage the split's x rows: xs[j * M + m], j the block-local weight row.
  // Halves: j < n is weight row r0 + j, j >= n is row k_rows + r0 + j - n.
  // Int32 lanes: j is weight row 8·r0 + j.
  const int staged = kW * n;
  for (int idx = threadIdx.x; idx < staged * M; idx += kThreads) {
    const int m = idx / staged;
    const int j = idx - m * staged;
    int col;
    if constexpr (kI32) {
      col = kW * r0 + j;
    } else {
      col = j < n ? r0 + j : k_rows + r0 + (j - n);
    }
    smem[j * M + m] = x_bf16(x[static_cast<size_t>(m) * in_dim + col]);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col0 = blockIdx.x * kTileCols + lane * kCols;
  float acc[M][kCols];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0.f;

  if (col0 < out_dim) {
    if constexpr (!kI32) {
      const uint8_t* p = static_cast<const uint8_t*>(packed);
#pragma unroll 4
      for (int lr = warp; lr < n; lr += kWarps) {
        const size_t row = static_cast<size_t>(r0 + lr) * out_dim + col0;
        uint32_t w = 0;
        if constexpr (kVec) {
          w = __ldg(reinterpret_cast<const uint32_t*>(p + row));
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            if (col0 + c < out_dim) w |= static_cast<uint32_t>(__ldg(p + row + c)) << (8 * c);
        }
        const float* xl = smem + lr * M;        // weight row r0 + lr
        const float* xh = smem + (n + lr) * M;  // weight row K + r0 + lr
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float lo = nibble(w, 8 * c);
          const float hi = nibble(w, 8 * c + 4);
#pragma unroll
          for (int m = 0; m < M; ++m) {
            acc[m][c] = fmaf(xl[m], lo, acc[m][c]);
            acc[m][c] = fmaf(xh[m], hi, acc[m][c]);
          }
        }
      }
    } else {
      const uint32_t* p = static_cast<const uint32_t*>(packed);
#pragma unroll 2
      for (int lr = warp; lr < n; lr += kWarps) {
        const size_t row = static_cast<size_t>(r0 + lr) * out_dim + col0;
        uint32_t w[kCols];
        if constexpr (kVec) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(p + row));
          w[0] = v.x;
          w[1] = v.y;
          w[2] = v.z;
          w[3] = v.w;
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c) w[c] = col0 + c < out_dim ? __ldg(p + row + c) : 0u;
        }
        const float* xr = smem + lr * kW * M;  // weight rows 8(r0 + lr) + p
#pragma unroll
        for (int q = 0; q < 8; ++q) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const float wv = nibble(w[c], 4 * q);
#pragma unroll
            for (int m = 0; m < M; ++m) acc[m][c] = fmaf(xr[q * M + m], wv, acc[m][c]);
          }
        }
      }
    }
  }

  // Add the warps' sums in a fixed order.
  __syncthreads();  // the x slice is no longer read
  float4* red = reinterpret_cast<float4*>(smem);  // [kWarps][M][32 lanes] of 4 columns
#pragma unroll
  for (int m = 0; m < M; ++m)
    red[(warp * M + m) * 32 + lane] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  const float* redf = smem;
  for (int o = threadIdx.x; o < M * kTileCols; o += kThreads) {
    const int m = o / kTileCols;
    const int cl = o - m * kTileCols;
    const int col = blockIdx.x * kTileCols + cl;
    if (col >= out_dim) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += redf[(w * M + m) * kTileCols + cl];
    partial[(static_cast<size_t>(split) * M + m) * out_dim + col] = s;
  }
}

// One thread per output: the splits' partials added in order, scaled, cast.
template <typename T>
__global__ void int4_merge_kernel(const float* __restrict__ partial,
                                  const float* __restrict__ scale, T* __restrict__ out,
                                  int m_rows, int out_dim, int n_split) {
  const size_t total = static_cast<size_t>(m_rows) * out_dim;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float s = 0.f;
  for (int sp = 0; sp < n_split; ++sp) s += partial[sp * total + idx];
  out[idx] = from_f<T>(s * scale[idx % out_dim]);
}

template <typename T, int M, bool kI32, bool kVec>
cudaError_t launch(const void* x, const void* packed, const float* scale, float* partial,
                   void* out, int in_dim, int k_rows, int out_dim, int n_split,
                   int split_rows, cudaStream_t stream) {
  constexpr int kW = kI32 ? 8 : 2;
  const int staged = kW * split_rows * M;
  const int reduce = kWarps * M * kTileCols;
  const size_t smem = static_cast<size_t>(staged > reduce ? staged : reduce) * sizeof(float);
  const dim3 grid((out_dim + kTileCols - 1) / kTileCols, n_split);
  int4_partial_kernel<T, M, kI32, kVec><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), packed, partial, in_dim, k_rows, out_dim, split_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(M) * out_dim;
  int4_merge_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      partial, scale, static_cast<T*>(out), M, out_dim, n_split);
  return cudaGetLastError();
}

template <typename T, bool kI32, bool kVec>
cudaError_t dispatch_rows(int m, const void* x, const void* packed, const float* scale,
                          float* partial, void* out, int in_dim, int k_rows, int out_dim,
                          int n_split, int split_rows, cudaStream_t stream) {
#define INT4_ROWS_CASE(MM)                                                              \
  case MM:                                                                              \
    return launch<T, MM, kI32, kVec>(x, packed, scale, partial, out, in_dim, k_rows,    \
                                     out_dim, n_split, split_rows, stream);
  switch (m) {
    INT4_ROWS_CASE(1)
    INT4_ROWS_CASE(2)
    INT4_ROWS_CASE(3)
    INT4_ROWS_CASE(4)
    INT4_ROWS_CASE(5)
    INT4_ROWS_CASE(6)
    INT4_ROWS_CASE(7)
    INT4_ROWS_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef INT4_ROWS_CASE
}

template <typename T>
cudaError_t dispatch_layout(int layout, bool vec, int m, const void* x, const void* packed,
                            const float* scale, float* partial, void* out, int in_dim,
                            int k_rows, int out_dim, int n_split, int split_rows,
                            cudaStream_t stream) {
  if (layout == kLayoutHalves)
    return vec ? dispatch_rows<T, false, true>(m, x, packed, scale, partial, out, in_dim,
                                               k_rows, out_dim, n_split, split_rows, stream)
               : dispatch_rows<T, false, false>(m, x, packed, scale, partial, out, in_dim,
                                                k_rows, out_dim, n_split, split_rows, stream);
  return vec ? dispatch_rows<T, true, true>(m, x, packed, scale, partial, out, in_dim, k_rows,
                                            out_dim, n_split, split_rows, stream)
             : dispatch_rows<T, true, false>(m, x, packed, scale, partial, out, in_dim, k_rows,
                                             out_dim, n_split, split_rows, stream);
}

// ---- 11. w4a8_matmul ---------------------------------------------------------
// Replaces w4a8_matmul (_w4a8_kernel) of scripts/w4a8_probe.py. Contract:
// out[M, OUT] f32 = float(acc) * scale[OUT] * sx[M], in that order, where
// acc[m, o] = Σ_i xq[m, i]·lo(packed[i, o]) + xq[m, K + i]·hi(packed[i, o])
// in int32 over the K = IN/2 packed rows: xq [M, IN] int8 activation codes
// (the wrapper quantizes x per row with plain torch ops before the launch,
// as the probe does outside its kernel), the halves layout of B9, sx [M]
// f32. The sum is exact, so the result equals the plain version bit for bit.
//
// Bound on an H100 SXM: bytes, as for B9 (the packed weights cross device
// memory once; at M 8 a packed byte meets 16 multiply-adds).
//
// Design. B9's grid: a block owns 128 output columns (4 per thread, one
// 32-bit load per packed row) and one split of the packed rows, staged
// activation codes in shared memory; its 8 warps take groups of 4 packed
// rows. A thread's 4 words (4 rows × 4 columns) are transposed with
// __byte_perm into one word per column holding that column's 4 packed
// bytes. (w << 4) & 0xF0F0F0F0 leaves in each byte its low nibble times 16
// as a signed int8, w & 0xF0F0F0F0 its high nibble times 16: no shifts per
// nibble, and one __dp4a against 4 activation codes adds four products.
// The sums carry the factor 16 exactly (|16·acc| <= 16·IN·8·127 < 2^31 for
// IN <= 131072) and the merge divides it out. Warp sums, then split
// partials, are int32 and exact, so the order of every addition is free.
constexpr int kW4a8MaxSplitRows = 512;  // packed rows per split, a multiple of 4
constexpr int kW4a8MaxIn = 131072;

// Grid (ceil(OUT / 128), n_split), kThreads threads; partial [n_split, M, OUT]
// int32 holds 16·acc of each split.
template <int M, bool kVec>
__global__ void __launch_bounds__(kThreads)
    w4a8_partial_kernel(const int8_t* __restrict__ xq, const uint8_t* __restrict__ packed,
                        int* __restrict__ partial, int in_dim, int k_rows, int out_dim,
                        int split_rows) {
  __shared__ int xs[2][M][kW4a8MaxSplitRows / 4];  // codes of x, 4 to a word: low, high half
  __shared__ int red[kWarps][M][kTileCols];
  const int split = blockIdx.y;
  const int r0 = split * split_rows;
  const int groups = min(split_rows, k_rows - r0) / 4;
  for (int idx = threadIdx.x; idx < 2 * M * groups; idx += kThreads) {
    const int half = idx / (M * groups);
    const int m = (idx / groups) % M;
    const int g = idx % groups;
    const int col = (half ? k_rows : 0) + r0 + 4 * g;
    xs[half][m][g] = *reinterpret_cast<const int*>(xq + static_cast<size_t>(m) * in_dim + col);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col0 = blockIdx.x * kTileCols + lane * kCols;
  int acc[M][kCols];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[m][c] = 0;

  if (col0 < out_dim) {
    for (int g = warp; g < groups; g += kWarps) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint8_t* row = packed + static_cast<size_t>(r0 + 4 * g + i) * out_dim + col0;
        if constexpr (kVec) {
          w[i] = __ldg(reinterpret_cast<const uint32_t*>(row));
        } else {
          w[i] = 0;
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            if (col0 + c < out_dim) w[i] |= static_cast<uint32_t>(__ldg(row + c)) << (8 * c);
        }
      }
      // col[c] = byte c of w[0..3]: column col0 + c at packed rows 4g .. 4g + 3
      const uint32_t t01 = __byte_perm(w[0], w[1], 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
      const uint32_t t23 = __byte_perm(w[2], w[3], 0x5140);
      const uint32_t u01 = __byte_perm(w[0], w[1], 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
      const uint32_t u23 = __byte_perm(w[2], w[3], 0x7362);
      const uint32_t col[kCols] = {__byte_perm(t01, t23, 0x5410), __byte_perm(t01, t23, 0x7632),
                                   __byte_perm(u01, u23, 0x5410), __byte_perm(u01, u23, 0x7632)};
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int lo16 = static_cast<int>((col[c] << 4) & 0xF0F0F0F0u);
        const int hi16 = static_cast<int>(col[c] & 0xF0F0F0F0u);
#pragma unroll
        for (int m = 0; m < M; ++m) {
          acc[m][c] = __dp4a(lo16, xs[0][m][g], acc[m][c]);
          acc[m][c] = __dp4a(hi16, xs[1][m][g], acc[m][c]);
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < kCols; ++c) red[warp][m][lane * kCols + c] = acc[m][c];
  __syncthreads();
  for (int o = threadIdx.x; o < M * kTileCols; o += kThreads) {
    const int m = o / kTileCols;
    const int cl = o - m * kTileCols;
    const int col_out = blockIdx.x * kTileCols + cl;
    if (col_out >= out_dim) continue;
    int s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][m][cl];
    partial[(static_cast<size_t>(split) * M + m) * out_dim + col_out] = s;
  }
}

// One thread per output: the splits' int32 partials added, the factor 16
// divided out (exactly), then the two scales in the plain version's order.
__global__ void w4a8_merge_kernel(const int* __restrict__ partial,
                                  const float* __restrict__ scale, const float* __restrict__ sx,
                                  float* __restrict__ out, int m_rows, int out_dim,
                                  int n_split) {
  const size_t total = static_cast<size_t>(m_rows) * out_dim;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int s = 0;
  for (int sp = 0; sp < n_split; ++sp) s += partial[sp * total + idx];
  const float acc = static_cast<float>(s / 16);
  out[idx] = __fmul_rn(__fmul_rn(acc, scale[idx % out_dim]), sx[idx / out_dim]);
}

template <int M, bool kVec>
cudaError_t launch_w4a8(const void* xq, const void* packed, const float* scale, const float* sx,
                        int* partial, float* out, int in_dim, int k_rows, int out_dim,
                        int n_split, int split_rows, cudaStream_t stream) {
  const dim3 grid((out_dim + kTileCols - 1) / kTileCols, n_split);
  w4a8_partial_kernel<M, kVec><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const uint8_t*>(packed), partial, in_dim,
      k_rows, out_dim, split_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(M) * out_dim;
  w4a8_merge_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      partial, scale, sx, out, M, out_dim, n_split);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t dispatch_w4a8(int m, const void* xq, const void* packed, const float* scale,
                          const float* sx, int* partial, float* out, int in_dim, int k_rows,
                          int out_dim, int n_split, int split_rows, cudaStream_t stream) {
#define W4A8_ROWS_CASE(MM)                                                                 \
  case MM:                                                                                 \
    return launch_w4a8<MM, kVec>(xq, packed, scale, sx, partial, out, in_dim, k_rows,      \
                                 out_dim, n_split, split_rows, stream);
  switch (m) {
    W4A8_ROWS_CASE(1)
    W4A8_ROWS_CASE(2)
    W4A8_ROWS_CASE(3)
    W4A8_ROWS_CASE(4)
    W4A8_ROWS_CASE(5)
    W4A8_ROWS_CASE(6)
    W4A8_ROWS_CASE(7)
    W4A8_ROWS_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef W4A8_ROWS_CASE
}

}  // namespace

extern "C" {

const char* int4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// layout 0: packed [in_dim/2, out_dim] int8; layout 1: [in_dim/8, out_dim]
// int32. partial: [n_split, m, out_dim] f32 scratch. Splits of split_rows
// packed rows; every split holds at least one row.
int int4_matmul(int dtype, int layout, const void* x, const void* packed, const float* scale,
                float* partial, void* out, int m, int in_dim, int k_rows, int out_dim,
                int n_split, int split_rows, void* stream) {
  const int per_row = layout == kLayoutI32 ? 8 : 2;
  if ((layout != kLayoutHalves && layout != kLayoutI32) || m < 1 || m > kMaxRows ||
      k_rows < 1 || out_dim < 1 || in_dim != per_row * k_rows || split_rows < 1 ||
      split_rows > (layout == kLayoutI32 ? kMaxSplitRowsI32 : kMaxSplitRowsHalves) || n_split < 1 ||
      static_cast<long long>(n_split - 1) * split_rows >= k_rows ||
      static_cast<long long>(n_split) * split_rows < k_rows ||
      partial == nullptr)
    return cudaErrorInvalidValue;
  // Vector loads need every thread's 4 columns aligned: 4 bytes (halves) or
  // 16 bytes (int32 lanes) at every row start.
  const size_t align = layout == kLayoutI32 ? 16 : 4;
  const bool vec = out_dim % kCols == 0 && reinterpret_cast<uintptr_t>(packed) % align == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeBF16)
    return dispatch_layout<__nv_bfloat16>(layout, vec, m, x, packed, scale, partial, out,
                                          in_dim, k_rows, out_dim, n_split, split_rows, s);
  if (dtype == kDtypeF32)
    return dispatch_layout<float>(layout, vec, m, x, packed, scale, partial, out, in_dim,
                                  k_rows, out_dim, n_split, split_rows, s);
  return cudaErrorInvalidValue;
}

int w4a8_max_split_rows() { return kW4a8MaxSplitRows; }

// xq [m, in_dim] int8 (4-byte aligned rows), packed [in_dim/2, out_dim] int8
// halves layout, scale [out_dim] f32, sx [m] f32; partial [n_split, m,
// out_dim] int32 scratch; out [m, out_dim] f32. Splits of split_rows packed
// rows, a multiple of 4 (so is in_dim / 2); every split holds at least one row.
int w4a8_matmul(const void* xq, const void* packed, const float* scale, const float* sx,
                int* partial, float* out, int m, int in_dim, int k_rows, int out_dim,
                int n_split, int split_rows, void* stream) {
  if (m < 1 || m > kMaxRows || k_rows < 4 || k_rows % 4 != 0 || in_dim != 2 * k_rows ||
      in_dim > kW4a8MaxIn || out_dim < 1 || split_rows < 4 || split_rows % 4 != 0 ||
      split_rows > kW4a8MaxSplitRows || n_split < 1 ||
      static_cast<long long>(n_split - 1) * split_rows >= k_rows ||
      static_cast<long long>(n_split) * split_rows < k_rows ||
      reinterpret_cast<uintptr_t>(xq) % 4 != 0 || partial == nullptr)
    return cudaErrorInvalidValue;
  const bool vec = out_dim % kCols == 0 && reinterpret_cast<uintptr_t>(packed) % 4 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? dispatch_w4a8<true>(m, xq, packed, scale, sx, partial, out, in_dim, k_rows,
                                   out_dim, n_split, split_rows, s)
             : dispatch_w4a8<false>(m, xq, packed, scale, sx, partial, out, in_dim, k_rows,
                                    out_dim, n_split, split_rows, s);
}

}  // extern "C"

// Hopper (sm_90a) int4 weight matmul kernels of the PyTorch port, with a
// plain C interface for ctypes (ops/_kernels.py builds each csrc/*.cu with
// nvcc at first use; ops/cuda_quant.py holds the wrappers and their launch
// counts).
//
// int4_matmul and int4_matmul_i32 replace two Pallas kernels of
// cain_2025_device_remote_llm_energy_rep_pkg_tpu/ops/pallas_quant.py, and
// w4a8_matmul the one of scripts/w4a8_probe.py (11, at the end of the file):
//
// 9.  int4_matmul (halves) — int4_matmul (_int4_matmul_kernel). packed
//     [K = IN/2, OUT] int8: packed row i holds weight row i in its low
//     nibble and weight row K + i in its high nibble.
// 10. int4_matmul_i32 (int32 lanes) — int4_matmul_i32
//     (_int4_matmul_kernel_i32). packed [K = IN/8, OUT] int32: nibble p of
//     lane k is weight row 8k + p.
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
// Design of 9 (int4_mma_kernel): the tensor cores, one launch. The product
// runs as mma.sync.m16n8k16 (bf16 in, f32 accumulate) with the weight as
// the A operand (16 output columns × 16 k) and x as the B operand (16 k ×
// 8 rows; rows past M are zeros). The k order inside an mma is free, so
// the k pair (2j, 2j+1) of a fragment register is weight rows (i, K + i)
// of one packed row i: one packed byte becomes one bf16x2, its nibbles
// ORed (biased by 8) into the mantissa of 128.0 and 136 subtracted, exact
// for -8..7 and without an int→float conversion. A lane's 16-byte load of
// packed row i, columns c..c+15, feeds eight mmas: output column c + 2u
// (A row g) and c + 2u + 1 (A row g + 8) of mma u. So the weights go from
// device memory straight to registers (16 bytes a lane, past L1), in a
// ring of four k-steps per warp (4 KB; 32 KB a block) that is refilled as
// each step is multiplied. A block of 8 warps owns 128 output columns and
// one split of the packed rows, and stages its slice of x in shared
// memory, in the same k order, while its first weights are in flight. The
// warps' sums are added in a fixed order through shared memory. Where the
// column tiles leave SMs of the card idle, the packed rows are split over
// blocks, up to one block per SM of its 132 and at least 128 rows a split
// (ops/cuda_quant.py::_mma_split); each split writes f32 partials, and the
// last block of a column tile to arrive (an atomic ticket, reset by that
// block) adds the partials in split order, scales and casts. No float
// atomics, so every run gives the same bits.
//
// Design of 10 (int4_i32_mma_kernel): B9's design, one launch on the
// tensor cores, with the int32-lane layout's own map of lanes to
// fragments. Byte j of a lane holds weight rows 8k + 2j and 8k + 2j + 1,
// k-consecutive, so one byte is again one register's k pair and goes
// through the same conversion. A lane's 16-byte load is 4 columns of one
// packed row (B9's is 16 columns of one row); the four lanes of a quad
// take four consecutive packed rows of the same columns, x is staged in
// its natural k order to match, and one k-step (4 packed rows, 32 k) of a
// lane is 4 loads feeding 16 mmas, the same bytes per mma as B9. One
// load instruction of a warp covers 128 contiguous bytes of each of its 4
// packed rows. The split rule is B9's in weight rows (256 to 2,048 a split:
// ops/cuda_quant.py::_mma_split), the merge B9's ticket.

#include "decode_common.cuh"

namespace {

using port_attn::ceil_div;
using port_attn::from_f;
using port_attn::kDtypeBF16;
using port_attn::kDtypeF32;
using port_attn::last_to_arrive;
using port_attn::mma_bf16;
using port_attn::pack_bf16;
using port_attn::to_f;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxRows = 8;            // rows of x

// ---- 9. int4_matmul (halves): tensor cores, one launch ---------------------
constexpr int kMmaCols = 128;          // output columns per block: 8 lane groups × 16
constexpr int kMmaValues = 8 * kMmaCols;  // f32 sums per block: 128 columns × 8 rows
constexpr int kMmaStepRows = 8;        // packed rows per k-step: one mma's 16 k
constexpr int kMmaUnroll = 4;          // k-steps a warp has in flight
constexpr int kMmaMaxSplitRows = 1024;  // x slice: 8 rows × 1028 words = 32.9 KB
constexpr unsigned kBf16x2Of136 = 0x43084308u;

// 32-bit words of a staged x row: at least the split's rows and 4 mod 32,
// so the lanes' B-fragment reads (row g, word 8s + t) hit 32 distinct banks.
__host__ __device__ constexpr int mma_x_stride(int split_rows) {
  return (split_rows + 27) / 32 * 32 + 4;
}

inline size_t mma_smem_bytes(int split_rows) {
  const size_t xs = sizeof(uint32_t) * kMaxRows * mma_x_stride(split_rows);
  const size_t red = sizeof(float) * kWarps * 32 * 32;  // the warps' sums
  return xs > red ? xs : red;
}

// bf16x2 {low nibble, high nibble} of byte C of w, w4 = w >> 4: each
// nibble, biased by 8 (^8), lands in the mantissa of 128.0 (bf16 0x4300,
// whose ulp is 1), and 136 is subtracted; exact for codes -8..7, and a
// zero byte gives 0.
template <int C>
__device__ __forceinline__ unsigned nibbles_bf16x2(uint32_t w, uint32_t w4) {
  constexpr unsigned kSel = C | (C << 4) | ((C + 4) << 8) | ((C + 4) << 12);
  const unsigned magic = kBf16x2Of136;
  const unsigned biased = (__byte_perm(w, w4, kSel) & 0x000F000Fu) ^ magic;
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                                   *reinterpret_cast<const __nv_bfloat162*>(&magic));
  return *reinterpret_cast<const unsigned*>(&v);
}

// 16 packed bytes from p (columns c..c+15 of a packed row); zeros where
// !ok, and past `avail` columns without kVec (byte loads). The weights are
// read once: the vector load skips L1 and asks L2 for the 256-byte block.
template <bool kVec>
__device__ __forceinline__ uint4 load_packed16(const uint8_t* p, bool ok, int avail) {
  if constexpr (kVec) {
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if (ok)
      asm volatile("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
                   : "l"(p));
    return r;
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (ok) {
#pragma unroll
      for (int c = 0; c < 16; ++c)
        if (c < avail) w[c / 4] |= static_cast<uint32_t>(__ldg(p + c)) << (8 * (c % 4));
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// 8 consecutive elements of x, 16-byte aligned, widened to f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// One k-step of a warp: packed rows j = t (lo) and j = t + 4 (hi) of the
// step, 16 columns each, against x's B fragment at xr = xs[g][8s + t].
// mma u (acc[u]) holds output columns 16g + 2u (A row g) and 16g + 2u + 1
// (A row g + 8): bytes 2e and 2e + 1 of word q, u = 2q + e.
__device__ __forceinline__ void mma_step(float (&acc)[8][4], const uint32_t* xr,
                                         const uint4 (&w)[2]) {
  const unsigned b0 = xr[0];
  const unsigned b1 = xr[4];
  const uint32_t lo[4] = {w[0].x, w[0].y, w[0].z, w[0].w};
  const uint32_t hi[4] = {w[1].x, w[1].y, w[1].z, w[1].w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t l4 = lo[q] >> 4;
    const uint32_t h4 = hi[q] >> 4;
    const unsigned a0[4] = {nibbles_bf16x2<0>(lo[q], l4), nibbles_bf16x2<1>(lo[q], l4),
                            nibbles_bf16x2<0>(hi[q], h4), nibbles_bf16x2<1>(hi[q], h4)};
    mma_bf16(acc[2 * q], a0, b0, b1);
    const unsigned a1[4] = {nibbles_bf16x2<2>(lo[q], l4), nibbles_bf16x2<3>(lo[q], l4),
                            nibbles_bf16x2<2>(hi[q], h4), nibbles_bf16x2<3>(hi[q], h4)};
    mma_bf16(acc[2 * q + 1], a1, b0, b1);
  }
}

// Grid (ceil(OUT / 128), n_split), kThreads threads; dynamic shared
// memory mma_smem_bytes(split_rows). Warp w takes the k-steps w, w +
// kWarps, ... of its split; lane (g = lane / 4, t = lane % 4) loads columns
// 16g..16g+15 of the block's 128. With n_split > 1, partial [n_split,
// tiles, kMmaValues] f32 and tickets [tiles] (zero). kVec: OUT % 16 == 0,
// K % 8 == 0, and packed and x 16-byte aligned.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    int4_mma_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                    const float* __restrict__ scale, float* __restrict__ partial,
                    int* __restrict__ tickets, T* __restrict__ out, int m_rows, int in_dim,
                    int k_rows, int out_dim, int split_rows) {
  extern __shared__ __align__(16) uint32_t mm_smem[];
  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int r0 = split * split_rows;
  const int n_rows = min(split_rows, k_rows - r0);  // > 0
  const int n_steps = ceil_div(n_rows, kMmaStepRows);
  const int stride = mma_x_stride(split_rows);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int col = tile * kMmaCols + 16 * g;
  const int avail = out_dim - col;  // this lane group's columns inside OUT

  // Step s: block-local packed rows 8s + t (w[0]) and 8s + t + 4 (w[1]);
  // nothing is read past the split.
  auto load_step = [&](int s, uint4(&w)[2]) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = kMmaStepRows * s + t + 4 * half;
      w[half] = load_packed16<kVec>(packed + static_cast<size_t>(r0 + r) * out_dim + col,
                                    r < n_rows && avail > 0, avail);
    }
  };
  // A ring of kMmaUnroll steps in flight: step warp + i·kWarps lives in
  // slot i % kMmaUnroll, and each slot is refilled as soon as its step is
  // multiplied.
  uint4 w[kMmaUnroll][2];
#pragma unroll
  for (int u = 0; u < kMmaUnroll; ++u) load_step(warp + u * kWarps, w[u]);

  // x while the first weights are in flight: word r of row m packs
  // bf16(x[m, r0 + r]) (low half) and bf16(x[m, K + r0 + r]) (high half);
  // rows m >= M and words past the split's rows are 0.
  uint32_t* xs = mm_smem;
  const int padded = n_steps * kMmaStepRows;
  if constexpr (kVec) {  // padded == n_rows: 8 words a unit
    const int per_row = padded / 8;
    for (int i = tid; i < kMaxRows * per_row; i += kThreads) {
      const int m = i / per_row;
      const int r = (i - m * per_row) * 8;
      float lo[8] = {}, hi[8] = {};
      if (m < m_rows) {
        load8(x + static_cast<size_t>(m) * in_dim + r0 + r, lo);
        load8(x + static_cast<size_t>(m) * in_dim + k_rows + r0 + r, hi);
      }
      uint4* dst = reinterpret_cast<uint4*>(xs + m * stride + r);
      dst[0] = make_uint4(pack_bf16(lo[0], hi[0]), pack_bf16(lo[1], hi[1]),
                          pack_bf16(lo[2], hi[2]), pack_bf16(lo[3], hi[3]));
      dst[1] = make_uint4(pack_bf16(lo[4], hi[4]), pack_bf16(lo[5], hi[5]),
                          pack_bf16(lo[6], hi[6]), pack_bf16(lo[7], hi[7]));
    }
  } else {
    for (int i = tid; i < kMaxRows * padded; i += kThreads) {
      const int m = i / padded;
      const int r = i - m * padded;
      float lo = 0.f, hi = 0.f;
      if (m < m_rows && r < n_rows) {
        lo = to_f(x[static_cast<size_t>(m) * in_dim + r0 + r]);
        hi = to_f(x[static_cast<size_t>(m) * in_dim + k_rows + r0 + r]);
      }
      xs[m * stride + r] = pack_bf16(lo, hi);
    }
  }
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[u][c] = 0.f;
  const uint32_t* xr = xs + g * stride + t;
  for (int s0 = warp; s0 < n_steps; s0 += kWarps * kMmaUnroll) {
#pragma unroll
    for (int u = 0; u < kMmaUnroll; ++u) {
      const int s = s0 + u * kWarps;
      if (s < n_steps) mma_step(acc, xr + kMmaStepRows * s, w[u]);
      load_step(s + kMmaUnroll * kWarps, w[u]);
    }
  }

  // The warps' sums, added in a fixed order. Value v of the block's
  // kMmaValues is (mma·4 + c = v / 32, lane v % 32); thread tid holds v =
  // tid + kThreads·i, and merges the splits' partials of the same v in
  // split order.
  __syncthreads();  // the x slice is no longer read
  float* red = reinterpret_cast<float*>(mm_smem);  // [warp][mma·4 + c][lane]
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[(warp * 32 + 4 * u + c) * 32 + lane] = acc[u][c];
  __syncthreads();
  // Value (mma u, c, lane (g, t)): column 16g + 2u + c / 2 of the tile, x
  // row 2t + c % 2. Values outside out (rows past M, columns past OUT) are
  // neither stored nor merged.
  constexpr int kPer = kMmaValues / kThreads;
  float sum[kPer];
  int m_of[kPer], col_of[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int v = tid + kThreads * i;
    const int l = v & 31;
    const int uc = v >> 5;
    m_of[i] = 2 * (l & 3) + (uc & 1);
    col_of[i] = tile * kMmaCols + 16 * (l >> 2) + 2 * (uc >> 2) + ((uc >> 1) & 1);
    sum[i] = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) sum[i] += red[wp * kMmaValues + v];
  }
  auto kept = [&](int i) { return m_of[i] < m_rows && col_of[i] < out_dim; };
  if (n_split > 1) {
    const size_t n_tiles = gridDim.x;
    float* part = partial + (static_cast<size_t>(split) * n_tiles + tile) * kMmaValues + tid;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (kept(i)) part[kThreads * i] = sum[i];
    if (!last_to_arrive(tickets + tile, n_split)) return;
#pragma unroll
    for (int i = 0; i < kPer; ++i) sum[i] = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const float* p = partial + (static_cast<size_t>(sp) * n_tiles + tile) * kMmaValues + tid;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (kept(i)) sum[i] += __ldcg(p + kThreads * i);
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (kept(i))
      out[static_cast<size_t>(m_of[i]) * out_dim + col_of[i]] = from_f<T>(sum[i] * scale[col_of[i]]);
}

template <typename T>
cudaError_t launch_mma(const void* x, const void* packed, const float* scale, float* partial,
                       int* tickets, void* out, int m, int in_dim, int k_rows, int out_dim,
                       int n_split, int split_rows, cudaStream_t stream) {
  const bool vec = out_dim % 16 == 0 && k_rows % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(packed) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid(ceil_div(out_dim, kMmaCols), n_split);
  const size_t smem = mma_smem_bytes(split_rows);
  const T* xt = static_cast<const T*>(x);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  T* o = static_cast<T*>(out);
  if (vec)
    int4_mma_kernel<T, true><<<grid, kThreads, smem, stream>>>(
        xt, pk, scale, partial, tickets, o, m, in_dim, k_rows, out_dim, split_rows);
  else
    int4_mma_kernel<T, false><<<grid, kThreads, smem, stream>>>(
        xt, pk, scale, partial, tickets, o, m, in_dim, k_rows, out_dim, split_rows);
  return cudaGetLastError();
}

// ---- 10. int4_matmul_i32 (int32 lanes): tensor cores, one launch ----------
// B9's parts with another lane-to-fragment map. Byte j of the int32 lane
// (k, c) holds weight rows 8k + 2j (low nibble) and 8k + 2j + 1 (high):
// one byte is one k pair of a fragment register, so nibbles_bf16x2 turns
// it into the register as it does for B9. A lane's 16-byte load is one
// packed row × 4 columns; the four lanes of a quad (same g) take four
// consecutive packed rows of the same columns, so one k-step is 4 packed
// rows = 32 k = two mmas per column pair.
constexpr int kI32StepRows = 4;          // packed rows per k-step: the quad's lanes
constexpr int kI32Loads = 4;             // 16-byte loads per lane per k-step
constexpr int kI32Unroll = 2;            // k-steps a warp has in flight (4 KB, as B9's ring)
constexpr int kI32MaxSplitRows = 256;    // 2,048 weight rows: the x slice is B9's 32.9 KB

// 32-bit words of a staged x row (bf16 pairs in natural k order, 4 per
// packed row): at least the split's and 16 mod 32, so a quad's 16-byte
// reads (row g, words 4j..4j+3 for t = j) fall in distinct banks.
__host__ __device__ constexpr int i32_x_stride(int split_rows) {
  return (4 * split_rows + 31) / 32 * 32 + 16;
}

inline size_t i32_smem_bytes(int split_rows) {
  const size_t xs = sizeof(uint32_t) * kMaxRows * i32_x_stride(split_rows);
  const size_t red = sizeof(float) * kWarps * 32 * 32;  // the warps' sums
  return xs > red ? xs : red;
}

// One k-step of a warp: packed row 4s + t, loads i = 0..3 of columns
// 32i + 4g .. 32i + 4g + 3 (words x, y, z, w), against x's B fragments xv
// = words 4(4s + t) .. +3 of staged row g. mma u = 2i + p holds columns
// 32i + 4g + 2p (A row g) and 32i + 4g + 2p + 1 (A row g + 8); its k pair
// slot t is byte 2e of those words, slot t + 4 byte 2e + 1, against x
// words 2e (b0) and 2e + 1 (b1) of xv.
__device__ __forceinline__ void i32_mma_step(float (&acc)[8][4], uint4 xv,
                                             const uint4 (&w)[kI32Loads]) {
#pragma unroll
  for (int i = 0; i < kI32Loads; ++i) {
    const uint32_t words[4] = {w[i].x, w[i].y, w[i].z, w[i].w};
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const uint32_t lo = words[2 * p], hi = words[2 * p + 1];
      const uint32_t lo4 = lo >> 4, hi4 = hi >> 4;
      const unsigned a0[4] = {nibbles_bf16x2<0>(lo, lo4), nibbles_bf16x2<0>(hi, hi4),
                              nibbles_bf16x2<1>(lo, lo4), nibbles_bf16x2<1>(hi, hi4)};
      mma_bf16(acc[2 * i + p], a0, xv.x, xv.y);
      const unsigned a1[4] = {nibbles_bf16x2<2>(lo, lo4), nibbles_bf16x2<2>(hi, hi4),
                              nibbles_bf16x2<3>(lo, lo4), nibbles_bf16x2<3>(hi, hi4)};
      mma_bf16(acc[2 * i + p], a1, xv.z, xv.w);
    }
  }
}

// Grid (ceil(OUT / 128), n_split), kThreads threads; dynamic shared memory
// i32_smem_bytes(split_rows). As int4_mma_kernel: warp w takes the k-steps
// w, w + kWarps, ... of its split, a ring of kI32Unroll steps in flight,
// the warps' sums added in a fixed order, the splits merged by the last
// block of a column tile (partial [n_split, tiles, kMmaValues] f32 and
// tickets [tiles], zero, where n_split > 1). kVec: OUT % 4 == 0 and packed
// and x 16-byte aligned.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    int4_i32_mma_kernel(const T* __restrict__ x, const uint32_t* __restrict__ packed,
                        const float* __restrict__ scale, float* __restrict__ partial,
                        int* __restrict__ tickets, T* __restrict__ out, int m_rows, int in_dim,
                        int k_rows, int out_dim, int split_rows) {
  extern __shared__ __align__(16) uint32_t mm_smem[];
  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int r0 = split * split_rows;
  const int n_rows = min(split_rows, k_rows - r0);  // > 0
  const int n_steps = ceil_div(n_rows, kI32StepRows);
  const int stride = i32_x_stride(split_rows);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int col = tile * kMmaCols + 4 * g;  // load i adds 32i

  // Step s: block-local packed row 4s + t; nothing is read past the split.
  auto load_step = [&](int s, uint4(&w)[kI32Loads]) {
    const int r = kI32StepRows * s + t;
#pragma unroll
    for (int i = 0; i < kI32Loads; ++i) {
      const int c = col + 32 * i;
      const int avail = out_dim - c;
      w[i] = load_packed16<kVec>(
          reinterpret_cast<const uint8_t*>(packed + static_cast<size_t>(r0 + r) * out_dim + c),
          r < n_rows && avail > 0, 4 * avail);
    }
  };
  uint4 w[kI32Unroll][kI32Loads];
#pragma unroll
  for (int u = 0; u < kI32Unroll; ++u) load_step(warp + u * kWarps, w[u]);

  // x while the first weights are in flight: word i of row m packs
  // bf16(x[m, 8·r0 + 2i]) (low half) and bf16(x[m, 8·r0 + 2i + 1]); rows
  // m >= M and packed rows past the split are 0.
  uint32_t* xs = mm_smem;
  const int padded = n_steps * kI32StepRows;  // packed rows staged, 8 elements each
  const T* xb = x + static_cast<size_t>(8) * r0;
  for (int i = tid; i < kMaxRows * padded; i += kThreads) {
    const int m = i / padded;
    const int r = i - m * padded;
    float f[8] = {};
    if (m < m_rows && r < n_rows) {
      const T* src = xb + static_cast<size_t>(m) * in_dim + 8 * r;
      if constexpr (kVec) {
        load8(src, f);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) f[e] = to_f(src[e]);
      }
    }
    *reinterpret_cast<uint4*>(xs + m * stride + 4 * r) =
        make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                   pack_bf16(f[6], f[7]));
  }
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[u][c] = 0.f;
  const uint32_t* xr = xs + g * stride + 4 * t;
  for (int s0 = warp; s0 < n_steps; s0 += kWarps * kI32Unroll) {
#pragma unroll
    for (int u = 0; u < kI32Unroll; ++u) {
      const int s = s0 + u * kWarps;
      if (s < n_steps)
        i32_mma_step(acc, *reinterpret_cast<const uint4*>(xr + 4 * kI32StepRows * s), w[u]);
      load_step(s + kI32Unroll * kWarps, w[u]);
    }
  }

  // The warps' sums and the split merge, as int4_mma_kernel's (its text is
  // kept apart so that B9's SASS stays as it was). Value (mma u, c, lane
  // (g, t)): column 32(u / 2) + 4g + 2(u % 2) + c / 2 of the tile, x row
  // 2t + c % 2.
  __syncthreads();  // the x slice is no longer read
  float* red = reinterpret_cast<float*>(mm_smem);  // [warp][mma·4 + c][lane]
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[(warp * 32 + 4 * u + c) * 32 + lane] = acc[u][c];
  __syncthreads();
  constexpr int kPer = kMmaValues / kThreads;
  float sum[kPer];
  int m_of[kPer], col_of[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int v = tid + kThreads * i;
    const int l = v & 31;
    const int uc = v >> 5;
    const int u = uc >> 2;
    m_of[i] = 2 * (l & 3) + (uc & 1);
    col_of[i] = tile * kMmaCols + 32 * (u >> 1) + 4 * (l >> 2) + 2 * (u & 1) + ((uc >> 1) & 1);
    sum[i] = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) sum[i] += red[wp * kMmaValues + v];
  }
  auto kept = [&](int i) { return m_of[i] < m_rows && col_of[i] < out_dim; };
  if (n_split > 1) {
    const size_t n_tiles = gridDim.x;
    float* part = partial + (static_cast<size_t>(split) * n_tiles + tile) * kMmaValues + tid;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (kept(i)) part[kThreads * i] = sum[i];
    if (!last_to_arrive(tickets + tile, n_split)) return;
#pragma unroll
    for (int i = 0; i < kPer; ++i) sum[i] = 0.f;
    for (int sp = 0; sp < n_split; ++sp) {
      const float* p = partial + (static_cast<size_t>(sp) * n_tiles + tile) * kMmaValues + tid;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (kept(i)) sum[i] += __ldcg(p + kThreads * i);
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (kept(i))
      out[static_cast<size_t>(m_of[i]) * out_dim + col_of[i]] = from_f<T>(sum[i] * scale[col_of[i]]);
}

template <typename T>
cudaError_t launch_i32_mma(const void* x, const void* packed, const float* scale, float* partial,
                           int* tickets, void* out, int m, int in_dim, int k_rows, int out_dim,
                           int n_split, int split_rows, cudaStream_t stream) {
  const bool vec = out_dim % 4 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid(ceil_div(out_dim, kMmaCols), n_split);
  const size_t smem = i32_smem_bytes(split_rows);
  const T* xt = static_cast<const T*>(x);
  const uint32_t* pk = static_cast<const uint32_t*>(packed);
  T* o = static_cast<T*>(out);
  if (vec)
    int4_i32_mma_kernel<T, true><<<grid, kThreads, smem, stream>>>(
        xt, pk, scale, partial, tickets, o, m, in_dim, k_rows, out_dim, split_rows);
  else
    int4_i32_mma_kernel<T, false><<<grid, kThreads, smem, stream>>>(
        xt, pk, scale, partial, tickets, o, m, in_dim, k_rows, out_dim, split_rows);
  return cudaGetLastError();
}

// ---- 11. w4a8_matmul: int8 tensor cores, one launch ------------------------
// Replaces w4a8_matmul (the pl.pallas_call at scripts/w4a8_probe.py:103,
// kernel _w4a8_kernel). Contract: out[M, OUT] f32 = float(acc) · scale[OUT]
// · sx[M], multiplied in that order, where sx[m] = max|x[m, :]| / 127,
// xq = clip(round(x / sx), -127, 127) as int8 (the probe quantizes x ahead
// of its kernel; this kernel does it itself), and acc[m, o] = Σ_i
// xq[m, i]·lo(packed[i, o]) + xq[m, K + i]·hi(packed[i, o]) in int32 over
// the K = IN/2 packed rows of B9's halves layout. x is bf16 or f32, 1 <= M
// <= 8, K a multiple of 16. The codes follow
// ops/quant.py::quantize_activations_rowwise operation for operation (the
// max taken in x's type, then widened; both divisions IEEE, never by a
// reciprocal; ties to even; the 0/0 of a zero row gives code 0) and the
// sums are exact, so the result equals the plain version bit for bit.
//
// Bound on an H100 SXM: bytes, as B9's (the packed weights cross device
// memory once; at M 8 a packed byte meets 16 multiply-adds).
//
// Design: one launch, B9's grid and epilogue on the int8 tensor cores.
// - The quantization with no wait between blocks. Every code needs its
//   row's max, and blocks cannot wait on each other (a launch does not
//   promise they are resident together), so every block reads all M rows
//   of x (from L2 after the first block: 24 KB bf16 at the probe's shape)
//   while its first weights are in flight. Warp m reduces row m's max, then
//   writes the codes of its split's k slice of row m straight into shared
//   memory: no xq or sx passes through device memory. Splits follow B9's
//   rule (ops/cuda_quant.py::_w4a8_split): shorter ones repeat the read
//   and add partials, longer ones leave SMs idle.
// - The product: mma.sync.m16n8k32 (s8 × s8, s32 accumulate) with the
//   weight as A (16 output columns × 32 k) and the codes as B (32 k × 8
//   rows; rows past M are zero codes). The k order inside an mma is free.
//   Lane (g, t) loads packed rows 16s + 4t + j (j = 0..3), columns
//   16g..16g+15, 16 bytes each, from device memory straight into registers
//   (a ring of two k-steps, 4 KB a warp as B9's); __byte_perm turns the
//   four rows' words into one word per column holding its four packed
//   bytes, whose low nibbles ×16, (w << 4) & 0xF0F0F0F0, are A's k 4t + j
//   and high nibbles ×16, w & 0xF0F0F0F0, its k 16 + 4t + j, as s8: no
//   shift per nibble. The codes are staged in the same order: word 4s + t
//   of code row m holds the low half's codes of packed rows 16s + 4t ..
//   16s + 4t + 3 (x[m, r0 + 16s + 4t + j]), and of code row 8 + m the high
//   half's (x[m, K + ...]), so each B register is one 32-bit read. mma u
//   of a lane holds output columns 16g + 2u (A row g) and 16g + 2u + 1 (A
//   row g + 8), as B9's does.
// - The sums carry the factor 16 exactly (|16·acc| <= 16·IN·8·127 < 2^31
//   for IN <= 131072, kW4a8MaxIn); the epilogue divides it out. The warps'
//   sums, then the splits' int32 partials (added by the last block of a
//   column tile to arrive, through B9's ticket), are exact integers, so the
//   order of every add is free and no float atomics are needed; then
//   scale and sx are applied with __fmul_rn in the plain version's order.
//   The epilogue's index map is B9's; its text is B11's own, so that B9's
//   SASS stays as it was.
constexpr int kW4a8StepRows = 16;         // packed rows per k-step: one mma's 32 k
constexpr int kW4a8Unroll = 2;            // k-steps a warp has in flight (4 KB, as B9's ring)
constexpr int kW4a8MaxSplitRows = 1024;   // staged codes: 16 rows × 260 words = 16.6 KB
constexpr int kW4a8MaxIn = 131072;

// 32-bit words of a staged code row (four codes a word): at least the
// split's rows / 4 and 4 mod 32, so the lanes' B reads (row g, word 4s + t)
// hit 32 distinct banks.
__host__ __device__ constexpr int w4a8_x_stride(int split_rows) {
  return (split_rows / 4 + 27) / 32 * 32 + 4;
}

inline size_t w4a8_smem_bytes(int split_rows) {
  const size_t xs = sizeof(uint32_t) * 2 * kMaxRows * w4a8_x_stride(split_rows);
  const size_t red = sizeof(int) * kWarps * 32 * 32;  // the warps' sums
  return xs > red ? xs : red;
}

// 8 consecutive elements of x widened to f32: one 16-byte load (kVec) or
// eight element loads.
template <bool kVec, typename T>
__device__ __forceinline__ void load_x8(const T* p, float (&f)[8]) {
  if constexpr (kVec) {
    load8(p, f);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = to_f(p[e]);
  }
}

// The larger of a and b, a NaN kept, as torch.amax keeps it.
__device__ __forceinline__ float max_nan(float a, float b) { return (a > b || a != a) ? a : b; }

// Four codes of a row of scale sx, packed in k order: v / sx by IEEE
// division, rounded to the nearest integer (ties to even), clamped to
// ±127; a NaN quotient (0/0 in a zero row) gives 0, as torch's cast does.
__device__ __forceinline__ uint32_t pack_codes4(const float* v, float sx) {
  uint32_t word = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float q = __fdiv_rn(v[i], sx);
    const int code = q != q ? 0 : min(max(__float2int_rn(q), -127), 127);
    word |= (static_cast<uint32_t>(code) & 0xFFu) << (8 * i);
  }
  return word;
}

// c[16×8] += a[16×32] · b[32×8], s8 in, s32 accumulate.
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k-step of a warp: w[j] holds packed row 16s + 4t + j at columns
// 16g..16g+15 (word q: columns 4q..4q+3), against the code words b0 (low
// half) and b1 (high half) of x row g. mma u = 2q + e takes columns 4q +
// 2e (A row g) and 4q + 2e + 1 (A row g + 8) of the lane's 16.
__device__ __forceinline__ void w4a8_mma_step(int (&acc)[8][4], unsigned b0, unsigned b1,
                                              const uint4 (&w)[4]) {
  const uint32_t rows[4][4] = {{w[0].x, w[0].y, w[0].z, w[0].w},
                               {w[1].x, w[1].y, w[1].z, w[1].w},
                               {w[2].x, w[2].y, w[2].z, w[2].w},
                               {w[3].x, w[3].y, w[3].z, w[3].w}};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // byte j of col[c] is packed row j's byte of column 4q + c
    const uint32_t t01 = __byte_perm(rows[0][q], rows[1][q], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
    const uint32_t t23 = __byte_perm(rows[2][q], rows[3][q], 0x5140);
    const uint32_t u01 = __byte_perm(rows[0][q], rows[1][q], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
    const uint32_t u23 = __byte_perm(rows[2][q], rows[3][q], 0x7362);
    const uint32_t col[4] = {__byte_perm(t01, t23, 0x5410), __byte_perm(t01, t23, 0x7632),
                             __byte_perm(u01, u23, 0x5410), __byte_perm(u01, u23, 0x7632)};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t lo = col[2 * e], hi = col[2 * e + 1];  // A rows g, g + 8
      const unsigned a[4] = {(lo << 4) & 0xF0F0F0F0u, (hi << 4) & 0xF0F0F0F0u,
                             lo & 0xF0F0F0F0u, hi & 0xF0F0F0F0u};
      mma_s8(acc[2 * q + e], a, b0, b1);
    }
  }
}

// Grid (ceil(OUT / 128), n_split), kThreads threads; dynamic shared memory
// w4a8_smem_bytes(split_rows). Warp w takes the k-steps w, w + kWarps, ...
// of its split; lane (g = lane / 4, t = lane % 4) loads columns
// 16g..16g+15 of the block's 128. With n_split > 1, partial [n_split,
// tiles, kMmaValues] int32 and tickets [tiles] (zero). kVec: OUT % 16 == 0,
// and packed and x 16-byte aligned.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    w4a8_mma_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                    const float* __restrict__ scale, int* __restrict__ partial,
                    int* __restrict__ tickets, float* __restrict__ out, int m_rows, int in_dim,
                    int k_rows, int out_dim, int split_rows) {
  extern __shared__ __align__(16) uint32_t w4_smem[];
  __shared__ float sx_of[kMaxRows];
  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int r0 = split * split_rows;
  const int n_rows = min(split_rows, k_rows - r0);  // > 0, whole k-steps
  const int n_steps = n_rows / kW4a8StepRows;
  const int stride = w4a8_x_stride(split_rows);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int col = tile * kMmaCols + 16 * g;
  const int avail = out_dim - col;  // this lane group's columns inside OUT

  // Step s: block-local packed rows 16s + 4t + j; nothing past the split.
  auto load_step = [&](int s, uint4(&w)[4]) {
    const bool ok = s < n_steps && avail > 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = kW4a8StepRows * s + 4 * t + j;
      w[j] = load_packed16<kVec>(packed + static_cast<size_t>(r0 + r) * out_dim + col, ok, avail);
    }
  };
  // A ring of kW4a8Unroll steps in flight: step warp + i·kWarps lives in
  // slot i % kW4a8Unroll, refilled as soon as its step is multiplied.
  uint4 w[kW4a8Unroll][4];
#pragma unroll
  for (int u = 0; u < kW4a8Unroll; ++u) load_step(warp + u * kWarps, w[u]);

  // The codes while the first weights are in flight: warp m takes x row m,
  // its max over all IN columns, then its split's k slice, 8 codes (two
  // words) a unit: the low half x[m, r0 + r] into code row m, the high
  // half x[m, K + r0 + r] into code row 8 + m. Rows m >= M are 0.
  uint32_t* xs = w4_smem;
  {
    const int m = warp;
    const int units = n_rows / 8;  // per half
    uint32_t* lo_row = xs + m * stride;
    uint32_t* hi_row = xs + (kMaxRows + m) * stride;
    if (m < m_rows) {
      const T* xm = x + static_cast<size_t>(m) * in_dim;
      float amax = 0.f;
#pragma unroll 4
      for (int i = 8 * lane; i < in_dim; i += 8 * 32) {
        float f[8];
        load_x8<kVec>(xm + i, f);
#pragma unroll
        for (int e = 0; e < 8; ++e) amax = max_nan(amax, fabsf(f[e]));
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = max_nan(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float sx = __fdiv_rn(amax, 127.f);
      if (lane == 0) sx_of[m] = sx;
      for (int i = lane; i < 2 * units; i += 32) {
        const int half = i >= units;
        const int r = 8 * (i - half * units);
        float f[8];
        load_x8<kVec>(xm + (half ? k_rows : 0) + r0 + r, f);
        *reinterpret_cast<uint2*>((half ? hi_row : lo_row) + r / 4) =
            make_uint2(pack_codes4(f, sx), pack_codes4(f + 4, sx));
      }
    } else {
      for (int i = lane; i < 2 * units; i += 32) {
        const int half = i >= units;
        const int r = 8 * (i - half * units);
        *reinterpret_cast<uint2*>((half ? hi_row : lo_row) + r / 4) = make_uint2(0u, 0u);
      }
    }
  }
  __syncthreads();

  int acc[8][4];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[u][c] = 0;
  const uint32_t* x_lo = xs + g * stride + t;
  const uint32_t* x_hi = xs + (kMaxRows + g) * stride + t;
  for (int s0 = warp; s0 < n_steps; s0 += kWarps * kW4a8Unroll) {
#pragma unroll
    for (int u = 0; u < kW4a8Unroll; ++u) {
      const int s = s0 + u * kWarps;
      if (s < n_steps) w4a8_mma_step(acc, x_lo[4 * s], x_hi[4 * s], w[u]);
      load_step(s + kW4a8Unroll * kWarps, w[u]);
    }
  }

  // The warps' sums, then the splits' (int32, exact: any order). Value v
  // of the block's kMmaValues is (mma·4 + c = v / 32, lane v % 32): column
  // 16g + 2u + c / 2 of the tile, x row 2t + c % 2, as B9's.
  __syncthreads();  // the codes are no longer read
  int* red = reinterpret_cast<int*>(w4_smem);  // [warp][mma·4 + c][lane]
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[(warp * 32 + 4 * u + c) * 32 + lane] = acc[u][c];
  __syncthreads();
  constexpr int kPer = kMmaValues / kThreads;
  int sum[kPer];
  int m_of[kPer], col_of[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int v = tid + kThreads * i;
    const int l = v & 31;
    const int uc = v >> 5;
    m_of[i] = 2 * (l & 3) + (uc & 1);
    col_of[i] = tile * kMmaCols + 16 * (l >> 2) + 2 * (uc >> 2) + ((uc >> 1) & 1);
    sum[i] = 0;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) sum[i] += red[wp * kMmaValues + v];
  }
  auto kept = [&](int i) { return m_of[i] < m_rows && col_of[i] < out_dim; };
  if (n_split > 1) {
    const size_t n_tiles = gridDim.x;
    int* part = partial + (static_cast<size_t>(split) * n_tiles + tile) * kMmaValues + tid;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (kept(i)) part[kThreads * i] = sum[i];
    if (!last_to_arrive(tickets + tile, n_split)) return;
#pragma unroll
    for (int i = 0; i < kPer; ++i) sum[i] = 0;
    for (int sp = 0; sp < n_split; ++sp) {
      const int* p = partial + (static_cast<size_t>(sp) * n_tiles + tile) * kMmaValues + tid;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (kept(i)) sum[i] += __ldcg(p + kThreads * i);
    }
  }
  // 16·acc / 16 is exact; then (acc · scale) · sx, each product rounded once.
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (kept(i))
      out[static_cast<size_t>(m_of[i]) * out_dim + col_of[i]] =
          __fmul_rn(__fmul_rn(static_cast<float>(sum[i] >> 4), scale[col_of[i]]), sx_of[m_of[i]]);
}

template <typename T>
cudaError_t launch_w4a8(const void* x, const void* packed, const float* scale, int* partial,
                        int* tickets, float* out, int m, int in_dim, int k_rows, int out_dim,
                        int n_split, int split_rows, cudaStream_t stream) {
  const bool vec = out_dim % 16 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid(ceil_div(out_dim, kMmaCols), n_split);
  const size_t smem = w4a8_smem_bytes(split_rows);
  const T* xt = static_cast<const T*>(x);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  if (vec)
    w4a8_mma_kernel<T, true><<<grid, kThreads, smem, stream>>>(
        xt, pk, scale, partial, tickets, out, m, in_dim, k_rows, out_dim, split_rows);
  else
    w4a8_mma_kernel<T, false><<<grid, kThreads, smem, stream>>>(
        xt, pk, scale, partial, tickets, out, m, in_dim, k_rows, out_dim, split_rows);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* int4_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// B9. packed [in_dim/2, out_dim] int8 (halves). Splits of split_rows packed
// rows, a multiple of 8 up to 1024 (kMmaMaxSplitRows); every split holds
// at least one row. With n_split > 1: partial [n_split, ceil(out_dim/128),
// 256, 4] f32 scratch and tickets [ceil(out_dim/128)] int32, zero.
int int4_matmul(int dtype, const void* x, const void* packed, const float* scale,
                float* partial, int* tickets, void* out, int m, int in_dim, int k_rows,
                int out_dim, int n_split, int split_rows, void* stream) {
  if (m < 1 || m > kMaxRows || k_rows < 1 || out_dim < 1 || in_dim != 2 * k_rows ||
      split_rows < kMmaStepRows || split_rows % kMmaStepRows != 0 ||
      split_rows > kMmaMaxSplitRows || n_split < 1 ||
      static_cast<long long>(n_split - 1) * split_rows >= k_rows ||
      static_cast<long long>(n_split) * split_rows < k_rows ||
      (n_split > 1 && (partial == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeBF16)
    return launch_mma<__nv_bfloat16>(x, packed, scale, partial, tickets, out, m, in_dim, k_rows,
                                     out_dim, n_split, split_rows, s);
  if (dtype == kDtypeF32)
    return launch_mma<float>(x, packed, scale, partial, tickets, out, m, in_dim, k_rows, out_dim,
                             n_split, split_rows, s);
  return cudaErrorInvalidValue;
}

// B10. packed [in_dim/8, out_dim] int32. Splits of split_rows packed rows,
// a multiple of 4 up to 256 (kI32MaxSplitRows); every split holds at least
// one row. With n_split > 1: partial [n_split, ceil(out_dim/128), 256, 4]
// f32 scratch and tickets [ceil(out_dim/128)] int32, zero.
int int4_matmul_i32(int dtype, const void* x, const void* packed, const float* scale,
                    float* partial, int* tickets, void* out, int m, int in_dim, int k_rows,
                    int out_dim, int n_split, int split_rows, void* stream) {
  if (m < 1 || m > kMaxRows || k_rows < 1 || out_dim < 1 || in_dim != 8 * k_rows ||
      split_rows < kI32StepRows || split_rows % kI32StepRows != 0 ||
      split_rows > kI32MaxSplitRows || n_split < 1 ||
      static_cast<long long>(n_split - 1) * split_rows >= k_rows ||
      static_cast<long long>(n_split) * split_rows < k_rows ||
      (n_split > 1 && (partial == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeBF16)
    return launch_i32_mma<__nv_bfloat16>(x, packed, scale, partial, tickets, out, m, in_dim,
                                         k_rows, out_dim, n_split, split_rows, s);
  if (dtype == kDtypeF32)
    return launch_i32_mma<float>(x, packed, scale, partial, tickets, out, m, in_dim, k_rows,
                                 out_dim, n_split, split_rows, s);
  return cudaErrorInvalidValue;
}

// B11. x [m, in_dim] bf16 or f32, packed [in_dim/2, out_dim] int8 (halves),
// scale [out_dim] f32, out [m, out_dim] f32; in_dim / 2 a multiple of 16
// and in_dim <= 131072 (kW4a8MaxIn). Splits of split_rows packed rows, a
// multiple of 16 up to 1,024 (kW4a8MaxSplitRows); every split holds at
// least one row. With n_split > 1: partial [n_split, ceil(out_dim/128),
// 256, 4] int32 scratch and tickets [ceil(out_dim/128)] int32, zero.
int w4a8_matmul(int dtype, const void* x, const void* packed, const float* scale, int* partial,
                int* tickets, float* out, int m, int in_dim, int k_rows, int out_dim,
                int n_split, int split_rows, void* stream) {
  if (m < 1 || m > kMaxRows || k_rows < kW4a8StepRows || k_rows % kW4a8StepRows != 0 ||
      in_dim != 2 * k_rows || in_dim > kW4a8MaxIn || out_dim < 1 ||
      split_rows < kW4a8StepRows || split_rows % kW4a8StepRows != 0 ||
      split_rows > kW4a8MaxSplitRows || n_split < 1 ||
      static_cast<long long>(n_split - 1) * split_rows >= k_rows ||
      static_cast<long long>(n_split) * split_rows < k_rows ||
      (n_split > 1 && (partial == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kDtypeBF16)
    return launch_w4a8<__nv_bfloat16>(x, packed, scale, partial, tickets, out, m, in_dim, k_rows,
                                      out_dim, n_split, split_rows, s);
  if (dtype == kDtypeF32)
    return launch_w4a8<float>(x, packed, scale, partial, tickets, out, m, in_dim, k_rows, out_dim,
                              n_split, split_rows, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"

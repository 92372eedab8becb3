// Hopper (sm_90a) attention kernels of the PyTorch port, with a plain C
// interface for ctypes (ops/_kernels.py builds this file with nvcc at first
// use; ops/cuda_attention.py holds the wrappers and their launch counts).
//
// Layouts are the JAX package's: q [B,S,Hq,D] (prefill) or [B,Hq,D]
// (decode); caches [B,Hkv,T,D], each head's T rows contiguous; int8 cache
// scales [B,Hkv,T] f32; lengths [B] int32. Element types: float32 or
// bfloat16 for q/k/v/out, int8 codes for the quantized cache. Scores,
// softmax and accumulators are f32; the output is cast to the input type
// once, at the end. Head dims 16, 32, 64, 96, 128 and 256 are supported
// natively (no padding to 128 lanes); the softmax scale is 1/sqrt(D). G = Hq / Hkv
// query heads share a kv head; the wrappers cut a larger G into
// sub-groups, so a kernel's cap on G never reaches a caller.
//
// The kernels launch on the caller's stream and allocate nothing: the
// wrapper passes the outputs, the split scratch and (decode) an int32
// ticket buffer that is zero between launches (the last block of a group
// resets its ticket). Each entry point returns the cudaError_t of its
// launches.
//
// 1. attn_prefill — replaces pallas_prefill_attention (_prefill_kernel,
//    cain_2025_device_remote_llm_energy_rep_pkg_tpu/ops/pallas_attention.py).
//    S queries at cache positions offset..offset+S-1 attend the cache with
//    the mask kpos <= qpos. Bound on an H100 SXM: the larger of bytes (q,
//    out and the attended K/V prefix, each once) / 3.35 TB/s and 4·Hq·D
//    flops per attended (query, key) pair / 989 TFLOP/s; a 2048-token
//    chunk at qwen2:1.5b widths is operations-bound, a 64-token prompt
//    bytes-bound.
//    bf16 (the main path): prefill_mma_kernel, on the tensor cores through
//    mma.sync.m16n8k16 (bf16 in, f32 accumulate). One block of 4 warps
//    holds 64 query rows (block_q = 64 / G positions × the G heads of one
//    kv head), 16 rows a warp. K/V tiles of kN keys (64; 32 at D 256)
//    arrive by 16-byte cp.async into a 2-stage ring of padded bf16 rows
//    (a 16-byte pad per row keeps ldmatrix free of bank conflicts). S = QKᵀ
//    runs from ldmatrix fragments of Q and K; the online softmax runs on
//    the S fragment in registers (row max and sum over the quad by
//    shuffles, exp2 with the scale folded in); P is repacked to bf16 in
//    registers as the A operand of P·V, whose B operand comes from V by
//    ldmatrix.trans. Only tiles that cross the block's first row's
//    frontier are masked; tiles past its last row's frontier are never
//    loaded. Where the (q-tile, b, kv head) blocks number fewer than the
//    card's 132 SMs (a short prompt, a chunk tail), the key range is
//    split over gridDim.z blocks as flash decoding splits it; each writes
//    unnormalised partials, and prefill_merge_kernel (a second launch, one
//    block per row of every tile) merges them. This is the mma.sync design;
//    the wgmma/TMA design (warpgroup products, TMA-fed 128-byte-swizzled
//    tiles) is a later change.
//    f32 (parity checks only): prefill_kernel keeps the CUDA-core body of
//    the first port — products in f32 from shared memory. TF32 tensor
//    cores would break its 1e-4 check.
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
//    bytes / 3.35 TB/s); at the study's lengths it is far below a
//    launch's latency, so the design cuts latency. decode_tile_kernel
//    (decode_common.cuh, with the ContiguousRows policy; B6 runs the same
//    body through the page table): the grid is (splits, B·Hkv), sized by
//    the wrapper from B·Hkv and T alone; each block
//    reads lengths[b] and sizes the row's splits from it (at least
//    kDcMinSplit positions each), so blocks past the row exit at once and
//    a short row still spreads over several SMs. A split streams tiles of
//    kDcTile positions by 16-byte cp.async, double-buffered; a tile's
//    scores [G, tile] are computed at once (lane = position, warp = two
//    heads of the group) and each head's online softmax is updated once a
//    tile, by the warp that scored it. P·V: warp w takes positions
//    w, w+4, ..., lane the D/32 columns (at D 16 a half-warp a position,
//    lane % 16 its column, the halves summed by a shuffle). The last split of a (b, kv head)
//    to finish (an atomic ticket) merges the partials and writes the
//    normalised output: one launch per call.

#include "decode_common.cuh"

namespace {

using namespace port_attn;

// ---------------------------------------------------------------------------
// Prefill, bf16: tensor cores (mma.sync), cp.async ring, split keys.

constexpr int kPfMmaWarps = 4;
constexpr int kPfMmaThreads = kPfMmaWarps * 32;
constexpr int kPfMmaRows = 16 * kPfMmaWarps;  // query rows per block
constexpr int kPfSms = 132;                   // SMs of an H100 SXM
constexpr int kPfMinTilesPerSplit = 2;
constexpr int kPfMaxSplits = 64;

template <int D>
struct PfMma {
  static constexpr int kN = D <= 128 ? 64 : 32;  // keys per tile
  static constexpr int kStride = D + 8;          // bf16 elements per smem row
  static constexpr int kBytes =
      static_cast<int>(sizeof(__nv_bfloat16)) * kStride * (kPfMmaRows + 4 * kN);
};

// grid (q-tiles, B·Hkv, n_split). Row r of block (x, bh) is position
// x·block_q + r / G, head h·G + r % G. With n_split > 1, block z attends
// its share of the block's key tiles and writes partials part_o
// [B·Hkv·q-tiles, n_split, 64, D] f32 and part_ml [..., n_split, 64, 2]
// (m in log2 units, l), which prefill_merge_kernel combines into out.
template <int D>
__global__ void __launch_bounds__(kPfMmaThreads)
    prefill_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ part_o, float* __restrict__ part_ml, int seq, int hkv,
                       int group, int t_cap, int offset, int block_q, float scale_log2) {
  using P = PfMma<D>;
  constexpr int kN = P::kN;
  constexpr int S = P::kStride;
  constexpr int C = D / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char pf_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(pf_smem);
  __nv_bfloat16* ks = qs + kPfMmaRows * S;  // [2][kN][S]
  __nv_bfloat16* vs = ks + 2 * kN * S;      // [2][kN][S]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / hkv;
  const int h = bh % hkv;
  const int hq = hkv * group;
  const int q_start = blockIdx.x * block_q;
  const int n_pos = min(block_q, seq - q_start);
  const int n_rows = n_pos * group;
  const int n_split = gridDim.z;
  const int split = blockIdx.z;
  const int first_pos = offset + q_start;        // the block's first row's frontier
  const int last_pos = first_pos + n_pos - 1;    // and its last row's
  const int n_tiles = min(ceil_div(t_cap, kN), last_pos / kN + 1);
  const int per = ceil_div(n_tiles, n_split);
  const int tile_begin = min(split * per, n_tiles);
  const int tile_end = min(tile_begin + per, n_tiles);
  const __nv_bfloat16* kh = k + static_cast<size_t>(bh) * t_cap * D;
  const __nv_bfloat16* vh = v + static_cast<size_t>(bh) * t_cap * D;

  for (int i = tid; i < kPfMmaRows * C; i += kPfMmaThreads) {
    const int r = i / C;
    const int c = i % C;
    const bool ok = r < n_rows;
    const __nv_bfloat16* src = q;
    if (ok) {
      const int s = q_start + r / group;
      const int head = h * group + r % group;
      src = q + ((static_cast<size_t>(b) * seq + s) * hq + head) * D + c * 8;
    }
    cp_async16(qs + r * S + c * 8, src, ok);
  }
  auto load_kv = [&](int tile, int stage) {
    __nv_bfloat16* kd = ks + stage * kN * S;
    __nv_bfloat16* vd = vs + stage * kN * S;
    for (int i = tid; i < kN * C; i += kPfMmaThreads) {
      const int r = i / C;
      const int c = i % C;
      const int kpos = tile * kN + r;
      const bool ok = kpos < t_cap;
      const size_t src = ok ? static_cast<size_t>(kpos) * D + c * 8 : 0;
      cp_async16(kd + r * S + c * 8, kh + src, ok);
      cp_async16(vd + r * S + c * 8, vh + src, ok);
    }
  };
  if (tile_begin < tile_end) load_kv(tile_begin, 0);
  cp_async_commit();

  // This thread's rows: r0 = warp·16 + lane/4 and r1 = r0 + 8.
  const int r0 = warp * 16 + lane / 4;
  const int qpos0 = first_pos + r0 / group;
  const int qpos1 = first_pos + (r0 + 8) / group;
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's columns

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int stage = (tile - tile_begin) & 1;
    if (tile + 1 < tile_end) load_kv(tile + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* kt = ks + stage * kN * S;
    const __nv_bfloat16* vt = vs + stage * kN * S;

    // S = Q Kᵀ over the tile: 16 rows × kN keys per warp.
    float sc[kN / 8][4];
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, qs + (warp * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * S + kk * 16 +
                         (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < kN / 16; ++j) {
        unsigned bk[4];
        ldmatrix_x4(bk, kt + (j * 16 + (lane / 16) * 8 + lane % 8) * S + kk * 16 +
                            ((lane / 8) % 2) * 8);
        mma_bf16(sc[2 * j], a, bk[0], bk[1]);
        mma_bf16(sc[2 * j + 1], a, bk[2], bk[3]);
      }
    }

    // Online softmax on the fragment (log2 units; the scale folded in).
    const int k0 = tile * kN;
    const bool mask = k0 + kN - 1 > first_pos;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + j * 8 + 2 * (lane % 4) + e;
        float x0 = sc[j][e] * scale_log2;
        float x1 = sc[j][2 + e] * scale_log2;
        if (mask) {
          if (key > qpos0) x0 = -INFINITY;
          if (key > qpos1) x1 = -INFINITY;
        }
        sc[j][e] = x0;
        sc[j][2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    // A row that has seen no key yet (a split before its frontier) keeps
    // m = -inf; exp2 against 0 then gives p = 0 and alpha = 0, never NaN.
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    const float al0 = exp2f(m0 - base0);
    const float al1 = exp2f(m1 - base1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[j][e] = exp2f(sc[j][e] - base0);
        sc[j][2 + e] = exp2f(sc[j][2 + e] - base1);
        ps0 += sc[j][e];
        ps1 += sc[j][2 + e];
      }
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= al0;
      o[j][1] *= al0;
      o[j][2] *= al1;
      o[j][3] *= al1;
    }

    // O += P V: P from the S fragment as bf16 A operands, V by ldmatrix.trans.
#pragma unroll
    for (int j = 0; j < kN / 16; ++j) {
      const unsigned a[4] = {pack_bf16(sc[2 * j][0], sc[2 * j][1]),
                             pack_bf16(sc[2 * j][2], sc[2 * j][3]),
                             pack_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                             pack_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3])};
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, vt + (j * 16 + ((lane / 8) % 2) * 8 + lane % 8) * S + c * 16 +
                                  (lane / 16) * 8);
        mma_bf16(o[2 * c], a, bv[0], bv[1]);
        mma_bf16(o[2 * c + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }

  const int col = 2 * (lane % 4);
  if (n_split == 1) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      if (r < n_rows) {
        const float inv = 1.f / (half ? l1 : l0);  // l > 0: a row sees its own position
        const int s = q_start + r / group;
        const int head = h * group + r % group;
        __nv_bfloat16* orow = out + ((static_cast<size_t>(b) * seq + s) * hq + head) * D;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + col) =
              __floats2bfloat162_rn(o[j][2 * half] * inv, o[j][2 * half + 1] * inv);
      }
    }
    return;
  }

  const size_t tile_id = static_cast<size_t>(bh) * gridDim.x + blockIdx.x;
  const size_t row0 = tile_id * n_split;  // partial (tile_id, s) starts at row0 + s
  float* po = part_o + (row0 + split) * kPfMmaRows * D;
  float* pm = part_ml + (row0 + split) * kPfMmaRows * 2;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(po + r * D + j * 8 + col) =
          make_float2(o[j][2 * half], o[j][2 * half + 1]);
    if (lane % 4 == 0) {
      pm[2 * r] = half ? m1 : m0;
      pm[2 * r + 1] = half ? l1 : l0;
    }
  }
}

// grid (B·Hkv·q-tiles, 64 rows), block D / 4 threads: out for row r of the
// tile = Σ_s e^{m_s - m}·o_s / Σ_s e^{m_s - m}·l_s over the n_split
// partials of prefill_mma_kernel; each thread 4 columns, the splits'
// loads independent. Flash decoding's second pass: every row of every
// tile is merged at once, over the whole card.
template <int D>
__global__ void __launch_bounds__(D / 4)
    prefill_merge_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                         __nv_bfloat16* __restrict__ out, int n_split, int q_tiles, int seq,
                         int hkv, int group, int block_q) {
  const int tile_id = blockIdx.x;
  const int r = blockIdx.y;
  const int bh = tile_id / q_tiles;
  const int q_start = (tile_id % q_tiles) * block_q;
  if (r >= min(block_q, seq - q_start) * group) return;  // a padding row
  const size_t row0 = static_cast<size_t>(tile_id) * n_split;
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, part_ml[((row0 + s) * kPfMmaRows + r) * 2]);
  const int d = 4 * threadIdx.x;
  float lsum = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) {
    const size_t p = (row0 + s) * kPfMmaRows + r;
    const float ms = part_ml[2 * p];
    const float c = ms == -INFINITY ? 0.f : exp2f(ms - mx);
    lsum += c * part_ml[2 * p + 1];
    const float4 x = *reinterpret_cast<const float4*>(part_o + p * D + d);
    a.x += c * x.x;
    a.y += c * x.y;
    a.z += c * x.z;
    a.w += c * x.w;
  }
  const float inv = 1.f / lsum;
  const int b = bh / hkv;
  const int h = bh % hkv;
  const int pos = q_start + r / group;
  const int head = h * group + r % group;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
      out + ((static_cast<size_t>(b) * seq + pos) * hkv * group + head) * D + d);
  o[0] = __floats2bfloat162_rn(a.x * inv, a.y * inv);
  o[1] = __floats2bfloat162_rn(a.z * inv, a.w * inv);
}

// Key splits of a bf16 prefill launch: 1 where the (q-tile, b, kv head)
// blocks already fill the card; else enough to reach about one block per
// SM, each split keeping at least kPfMinTilesPerSplit key tiles.
int prefill_splits(int batch, int seq, int hq, int hkv, int d_head, int offset) {
  if (hkv <= 0 || hq % hkv != 0 || seq <= 0) return 1;
  const int block_q = kPfMmaRows / (hq / hkv);
  if (block_q < 1) return 1;
  const int blocks = ceil_div(seq, block_q) * batch * hkv;
  if (blocks >= kPfSms) return 1;
  const int kn = d_head <= 128 ? 64 : 32;
  const int tiles = ceil_div(offset + seq, kn);  // the last q-tile's frontier
  const int n = min(ceil_div(kPfSms, blocks), tiles / kPfMinTilesPerSplit);
  return max(1, min(n, kPfMaxSplits));
}

template <int D>
cudaError_t launch_prefill_mma(const void* q, const void* k, const void* v, void* out,
                               float* part_o, float* part_ml, int batch, int seq, int hq, int hkv,
                               int t_cap, int offset, int n_split, cudaStream_t stream) {
  const int group = hq / hkv;
  const int block_q = kPfMmaRows / group;
  const int q_tiles = ceil_div(seq, block_q);
  constexpr int smem = PfMma<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(prefill_mma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const float scale_log2 = softmax_scale(D) * 1.4426950408889634f;
  prefill_mma_kernel<D><<<dim3(q_tiles, batch * hkv, n_split), kPfMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), part_o, part_ml,
      seq, hkv, group, t_cap, offset, block_q, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  prefill_merge_kernel<D><<<dim3(batch * hkv * q_tiles, kPfMmaRows), D / 4, 0, stream>>>(
      part_o, part_ml, static_cast<__nv_bfloat16*>(out), n_split, q_tiles, seq, hkv, group,
      block_q);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Prefill, f32: the CUDA-core body (parity checks only).

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

cudaError_t dispatch_prefill(int dtype, int d_head, const void* q, const void* k, const void* v,
                             void* out, float* part_o, float* part_ml, int batch, int seq, int hq,
                             int hkv, int t_cap, int offset, int n_split, cudaStream_t stream) {
  const float scale = softmax_scale(d_head);
#define ATTN_PREFILL_CASE(DH)                                                              \
  case DH:                                                                                 \
    if (dtype == kDtypeBF16)                                                               \
      return launch_prefill_mma<DH>(q, k, v, out, part_o, part_ml, batch, seq, hq, hkv,    \
                                    t_cap, offset, n_split, stream);                       \
    return launch_prefill<float, DH>(q, k, v, out, batch, seq, hq, hkv, t_cap, offset,     \
                                     scale, stream);
  switch (d_head) {
    ATTN_PREFILL_CASE(16)
    ATTN_PREFILL_CASE(32)
    ATTN_PREFILL_CASE(64)
    ATTN_PREFILL_CASE(96)
    ATTN_PREFILL_CASE(128)
    ATTN_PREFILL_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef ATTN_PREFILL_CASE
}

}  // namespace

extern "C" {

const char* attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Query rows per prefill block (positions × group heads): G above this is
// cut into sub-groups by the wrapper.
int attn_prefill_rows() { return kPfMmaRows; }

int attn_decode_group_max() { return kGroupMax; }

int attn_prefill_splits(int dtype, int batch, int seq, int hq, int hkv, int d_head, int offset) {
  return dtype == kDtypeBF16 ? prefill_splits(batch, seq, hq, hkv, d_head, offset) : 1;
}

// part_o [B·Hkv·q-tiles, n_split, rows, D] f32 and part_ml [..., rows, 2]:
// the split scratch where attn_prefill_splits() > 1 (null otherwise).
int attn_prefill(int dtype, const void* q, const void* k, const void* v, void* out,
                 float* part_o, float* part_ml, int batch, int seq, int hq, int hkv, int t_cap,
                 int d_head, int offset, int n_split, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kPfMmaRows || n_split < 1 ||
      n_split > kPfMaxSplits || (dtype != kDtypeBF16 && dtype != kDtypeF32) ||
      (n_split > 1 && (dtype != kDtypeBF16 || part_o == nullptr || part_ml == nullptr)))
    return cudaErrorInvalidValue;
  return dispatch_prefill(dtype, d_head, q, k, v, out, part_o, part_ml, batch, seq, hq, hkv,
                          t_cap, offset, n_split, static_cast<cudaStream_t>(stream));
}

// k_scale/v_scale null: k/v hold `dtype` elements; else int8 codes.
// n_grid blocks per (row, kv head), 1..128 (the wrapper's decode_grid);
// part_acc [B·Hkv, n_grid, G, D], part_ml [B·Hkv, n_grid, G, 2], tickets
// [B·Hkv] zero.
int attn_decode(int dtype, const void* q, const void* k, const void* v, const float* k_scale,
                const float* v_scale, const int* lengths, float* part_acc, float* part_ml,
                int* tickets, void* out, int batch, int hq, int hkv, int t_cap, int d_head,
                int n_grid, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kGroupMax) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ContiguousRows rows{t_cap};
  const bool quant = k_scale != nullptr;
  if (dtype == kDtypeBF16) {
    if (quant)
      return dispatch_decode_tile<__nv_bfloat16, int8_t, true>(
          d_head, q, k, v, k_scale, v_scale, lengths, part_acc, part_ml, tickets, out, batch,
          hq, hkv, rows, n_grid, s);
    return dispatch_decode_tile<__nv_bfloat16, __nv_bfloat16, false>(
        d_head, q, k, v, nullptr, nullptr, lengths, part_acc, part_ml, tickets, out, batch, hq,
        hkv, rows, n_grid, s);
  }
  if (dtype == kDtypeF32) {
    if (quant)
      return dispatch_decode_tile<float, int8_t, true>(d_head, q, k, v, k_scale, v_scale,
                                                       lengths, part_acc, part_ml, tickets, out,
                                                       batch, hq, hkv, rows, n_grid, s);
    return dispatch_decode_tile<float, float, false>(d_head, q, k, v, nullptr, nullptr, lengths,
                                                     part_acc, part_ml, tickets, out, batch, hq,
                                                     hkv, rows, n_grid, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"

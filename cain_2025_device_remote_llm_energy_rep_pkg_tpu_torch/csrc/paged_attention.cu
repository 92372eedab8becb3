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
// split flash-decoding style, in one launch: B2's body, decode_tile_kernel
// (decode_common.cuh), with the PagedRows address policy and the PartsOut
// output policy. The wrapper sizes the grid from B·Hkv and Jmax·page
// alone (decode_grid); each block sizes its row's splits from lengths[b]
// on the device (at least kDcMinSplit positions, whole tiles), so blocks
// past a row's splits exit at once and pages past the frontier are never
// touched; a tile of kDcTile positions within one page (page % kDcTile ==
// 0) costs one table lookup and arrives as contiguous 16-byte cp.async
// rows (any other page size looks up each position); and the last split
// of a (row, kv head) to finish merges the splits through an atomic
// ticket into (acc, m, l) without normalising. A row with no position
// runs one block that reads no tile and writes (0, -inf, 0). The int8
// scales are read through the same row index as the codes. D ∈ {16, 32, 64,
// 96, 128, 256} natively (no padding to 128 lanes), scales [P,Hkv,page] with
// no trailing lane.
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
// through an atomic ticket and normalises: one launch a call. B4/B5 run
// the same body and differ only in what the last split writes. Bound:
// bytes, as B4, plus the output.
//
// Multi-query contract (7, 8): Q query positions per row, q [B,Q,Hq,D]
// with offsets [B] (the absolute position of query 0); query j sees
// cached tokens kpos < min(lengths[b], offsets[b] + j + 1), and the parts
// come out per query position, acc [B,Q,Hkv,G,D], m and l [B,Q,Hkv,G]. A
// query that sees no token gives exactly (0, -inf, 0). The TPU kernel
// folds the Q positions into the group dim and streams each row's pages
// once for all of them. Here a verify block has R = Q·G score rows per
// (row, kv head) (30 for qwen2 at k = 4, 78 at k = 12): a product of
// [R, D] by [D, positions] and of [R, positions] by [positions, D], which
// is B1's shape. So with a bf16 q (bf16 or int8 pool) mq_mma_kernel runs
// B1's tensor-core body (attention.cu's prefill_mma_kernel: 64 score rows
// a block, GQA folded into the rows, ldmatrix fragments, a cp.async ring,
// the online softmax in log2 units) through the page table, with a
// per-row limit in place of B1's causal mask, and one launch: the grid is
// (q-tiles · n_grid, B·Hkv), a q-tile being 64 / G query positions, so Q
// 13 at G 6 is two q-tiles of one launch; each block sizes its q-tile's
// splits from the q-tile's frontier on the device (n_grid from the
// wrapper's mq_grid over B·Hkv·q-tiles and Jmax·page), and the last split
// to arrive merges through an atomic ticket, in split order, into the
// unnormalised parts (m in natural units). An int8 pool's codes arrive by
// cp.async and are widened to bf16 in shared memory (exact), the scales
// folded as in 5. At Q = 1 the wrapper calls paged_parts with lengths cut
// to min(lengths, offsets + 1): one code, so Q = 1 equals B4 bit for bit.
// With an f32 q, mq_partial_kernel keeps the first port's CUDA-core body
// (f32 products; the tensor cores' bf16 would break its 1e-4 check), Q <=
// kMqQueryMax, with host-sized splits (at most one page each) merged by a
// second launch, parts_merge_kernel.
//
// Contiguous rows (7, 8 over a [B,Hkv,T,D] cache: contig_mq_parts,
// contig_mq_mma_parts): the contiguous session's verify. The JAX package
// writes each row's k+1 candidates into its carry cache at offset[b] + j
// and attends them with XLA under a per-row causal mask
// (cain_2025_device_remote_llm_energy_rep_pkg_tpu/models/transformer.py,
// the carry-cache branch and its per_seq mask); no pallas_call serves it.
// Here the same two bodies run over the contiguous rows: both kernels are
// templates on the address policy (PagedRows, or decode_common.cuh's
// ContiguousRows, as decode_tile_kernel serves B2 and B4), whose
// tile_in_run says whether a tile's rows are one run (always, for
// contiguous rows: one 16-byte cp.async row after another, no lookup).
// Every key of a row is in its cache, so the caller passes lengths =
// offsets + Q and query j's limit is offsets[b] + j + 1; the wrapper
// normalises acc / l. Bound: bytes, each row's K/V read once up to its
// last query's limit.
//
// Bound on an H100 SXM: bytes. Every cached K/V row of every row must be
// read once up to its (last query's) limit (int8: D codes plus a 4-byte
// scale per position), against 4·Hq·D flops per visible (query, token)
// pair; bound = bytes / 3.35 TB/s. At the decode and verify widths the
// bytes are too few to cover a launch: the designs cut latency (one
// launch, 16-byte cp.async rows, one page lookup a tile; the verify's
// products on the tensor cores).

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

// ---- multi-query parts (B7/B8) with an f32 q: CUDA cores -------------------
constexpr int kMqWarps = 8;
constexpr int kMqTile = 16;     // positions staged in shared memory per pass
constexpr int kMqQueryMax = 9;  // query positions per row of an f32 q: k + 1 for k <= 8

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
template <typename T, typename KV, int D, bool kQuant, typename Rows>
__global__ void __launch_bounds__(kMqWarps * 32)
    mq_partial_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                      const KV* __restrict__ v, const float* __restrict__ k_scale,
                      const float* __restrict__ v_scale, const int* __restrict__ lengths,
                      const int* __restrict__ offsets, float* __restrict__ part_acc,
                      float* __restrict__ part_ml, Rows addr, int hkv, int group,
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

template <typename T, typename KV, int D, bool kQuant, typename Rows>
cudaError_t launch_mq_parts(const void* q, const void* k, const void* v, const float* k_scale,
                            const float* v_scale, const Rows& addr, const int* lengths,
                            const int* offsets, float* part_acc, float* part_ml, float* acc,
                            float* m, float* l, int batch, int q_len, int hq, int hkv,
                            int n_split, int split_len, cudaStream_t stream) {
  const int group = hq / hkv;
  const int rows = q_len * group;
  const size_t smem = mq_smem_bytes(rows, D);
  auto kernel = mq_partial_kernel<T, KV, D, kQuant, Rows>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
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

template <typename T, typename KV, bool kQuant, typename Rows>
cudaError_t dispatch_mq_parts(int d_head, const void* q, const void* k, const void* v,
                              const float* k_scale, const float* v_scale, const Rows& addr,
                              const int* lengths, const int* offsets, float* part_acc,
                              float* part_ml, float* acc, float* m, float* l, int batch,
                              int q_len, int hq, int hkv, int n_split, int split_len,
                              cudaStream_t stream) {
#define PAGED_MQ_CASE(DH)                                                                   \
  case DH:                                                                                  \
    return launch_mq_parts<T, KV, DH, kQuant, Rows>(q, k, v, k_scale, v_scale, addr, lengths, \
                                                    offsets, part_acc, part_ml, acc, m, l,     \
                                                    batch, q_len, hq, hkv, n_split, split_len, \
                                                    stream);
  switch (d_head) {
    PAGED_MQ_CASE(16)
    PAGED_MQ_CASE(32)
    PAGED_MQ_CASE(64)
    PAGED_MQ_CASE(96)
    PAGED_MQ_CASE(128)
    PAGED_MQ_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef PAGED_MQ_CASE
}

// ---- multi-query parts on the tensor cores (B7/B8 with a bf16 q) ----------
constexpr int kMqMmaWarps = 4;
constexpr int kMqMmaThreads = kMqMmaWarps * 32;
constexpr int kMqMmaRows = 16 * kMqMmaWarps;  // score rows per block: B1's 64
constexpr int kMqMmaQueryMax = 64;            // query positions per row: 64 at G 1
constexpr int kMqMinSplit = 64;               // positions per split, at least
constexpr int kMqMaxSplits = 32;              // splits per (q-tile, row, kv head), at most
constexpr float kLn2 = 0.69314718055994531f;

// Dynamic shared memory of mq_mma_kernel: q rows [64][S] and the bf16 K and
// V tiles [stages][kN][S] each, every row padded by 16 bytes as B1's (two
// cp.async stages; one where int8 codes are widened into them); with an
// int8 pool, the codes' cp.async ring [2][K, V][kN][D] and the scales
// [2][K, V][kN] f32. After the loop the merge reuses the front of it.
template <typename KV, int D>
struct MqMma {
  static constexpr bool kQuant = sizeof(KV) == 1;
  static constexpr int kN = D <= 128 ? 64 : 32;  // positions per tile
  static constexpr int kStride = D + 8;          // bf16 elements per smem row
  static constexpr int kBf16Stages = kQuant ? 1 : 2;
  static constexpr int kQBytes = 2 * kMqMmaRows * kStride;
  static constexpr int kTileBytes = 2 * kN * kStride;  // one bf16 K or V tile
  static constexpr int kCodeBytes = kQuant ? 2 * 2 * kN * D : 0;
  static constexpr int kScaleBytes = kQuant ? 4 * 2 * 2 * kN : 0;
  static constexpr int kLoop = kQBytes + 2 * kBf16Stages * kTileBytes + kCodeBytes + kScaleBytes;
  // After the loop the merge's (m, l) reuse the front of the dynamic
  // shared memory, the int8 codes' ring included (at D 32 it reaches it;
  // at D 16 it outgrows the loop's bytes, which are raised to it).
  static constexpr int kMerge = 4 * (2 * kMqMaxSplits * kMqMmaRows + 2 * kMqMmaRows);
  static constexpr int kBytes = kLoop > kMerge ? kLoop : kMerge;
  static_assert(kBytes >= kMerge, "the merge's (m, l) of every split must fit");
  static_assert(kMqMaxSplits * kMqMmaRows % kMqMmaThreads == 0, "the merge stages (m, l) evenly");
};

// grid (q_tiles · n_grid, B·Hkv), kMqMmaThreads threads, MqMma<KV, D>::kBytes
// of dynamic shared memory. Block (x·n_grid + split, bh) is q-tile x of
// row b, kv head h: its row r is query position j = x·block_q + r / G,
// head h·G + r % G, which sees positions kpos < min(len, offset + j + 1).
// The block sizes the q-tile's splits from its frontier (its last query's
// limit) as decode_tile_kernel sizes a row's, and streams its split in
// tiles of kN positions through a cp.async ring, looked up in the table
// once a tile where a tile lies in one page, else once a position. The
// body is B1's: S = QKᵀ and O += PV by mma.sync from ldmatrix fragments,
// the online softmax on the S fragment in log2 units; every score is
// masked by its row's limit. With an int8 pool the codes are widened to
// bf16 in shared memory (exact), the K scale multiplies the score of its
// position and the V scale folds into p after l takes it. One split
// writes the unnormalised parts (m in natural units) itself; several
// write partials part_acc [B·Hkv, n_grid, Q·G, D] and part_ml [...,
// Q·G, 2], and the last of them to arrive (tickets [B·Hkv·q_tiles])
// merges them in split order.
template <typename KV, int D, typename Rows>
__global__ void __launch_bounds__(kMqMmaThreads)
    mq_mma_kernel(const __nv_bfloat16* __restrict__ q, const KV* __restrict__ k,
                  const KV* __restrict__ v, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, const int* __restrict__ lengths,
                  const int* __restrict__ offsets, float* __restrict__ part_acc,
                  float* __restrict__ part_ml, int* __restrict__ tickets,
                  float* __restrict__ acc_out, float* __restrict__ m_out,
                  float* __restrict__ l_out, Rows addr, int hkv, int group, int q_len,
                  int block_q, int n_grid, float scale_log2) {
  using L = MqMma<KV, D>;
  constexpr bool kQuant = L::kQuant;
  constexpr int kN = L::kN;
  constexpr int S = L::kStride;
  constexpr int C = D / 8;    // 16-byte chunks of a bf16 row
  constexpr int C8 = D / 16;  // 16-byte chunks of an int8 row
  extern __shared__ __align__(16) unsigned char mq_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(mq_smem);
  __nv_bfloat16* ks = qs + kMqMmaRows * S;  // [stages][kN][S]
  __nv_bfloat16* vs = ks + L::kBf16Stages * kN * S;
  int8_t* codes = reinterpret_cast<int8_t*>(vs + L::kBf16Stages * kN * S);  // [2][K, V][kN][D]
  float* scales = reinterpret_cast<float*>(codes + L::kCodeBytes);          // [2][K, V][kN]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / hkv;
  const int h = bh % hkv;
  const int x = blockIdx.x / n_grid;
  const int split = blockIdx.x % n_grid;
  const int hq = hkv * group;
  const int rows_all = q_len * group;  // score rows of (b, h) over every q-tile
  const int j0 = x * block_q;
  const int n_pos = min(block_q, q_len - j0);
  const int n_rows = n_pos * group;
  const int row_base = j0 * group;  // the q-tile's first score row
  const int len = max(0, min(lengths[b], addr.capacity()));
  const int off = offsets[b];
  const int frontier = max(0, min(len, off + j0 + n_pos));
  int n_used = max(1, min(n_grid, ceil_div(frontier, kMqMinSplit)));
  const int split_len = ceil_div(ceil_div(max(frontier, 1), n_used), kN) * kN;
  n_used = max(1, ceil_div(frontier, split_len));
  const size_t part0 = static_cast<size_t>(bh) * n_grid;  // split s, row r: (part0 + s)·rows_all + row_base + r
  if (split >= n_used) return;  // past the frontier: no read, no ticket
  const int t_begin = split * split_len;
  const int t_end = min(t_begin + split_len, frontier);
  const int n_tiles = ceil_div(t_end - t_begin, kN);  // 0 where no query sees a position
  const bool whole = addr.tile_in_run(kN);            // a tile lies in one run of rows

  for (int i = tid; i < kMqMmaRows * C; i += kMqMmaThreads) {
    const int r = i / C;
    const int c = i % C;
    const bool ok = r < n_rows;
    const __nv_bfloat16* src = q;
    if (ok)
      src = q + ((static_cast<size_t>(b) * q_len + j0 + r / group) * hq + h * group + r % group) * D +
            c * 8;
    cp_async16(qs + r * S + c * 8, src, ok);
  }
  // Tile `it` of the split into ring stage `stage`; positions past t_end
  // read nothing and stage zeros.
  auto load_kv = [&](int it, int stage) {
    const int t0 = t_begin + it * kN;
    const size_t row0 = addr.row(bh, b, h, t0);
    if constexpr (kQuant) {
      int8_t* kd = codes + stage * 2 * kN * D;
      int8_t* vd = kd + kN * D;
      for (int i = tid; i < kN * C8; i += kMqMmaThreads) {
        const int p = i / C8;
        const int c = i % C8;
        const int t = t0 + p;
        const bool ok = t < t_end;
        const size_t r = !ok ? row0 : whole ? row0 + p : addr.row(bh, b, h, t);
        cp_async16(kd + p * D + c * 16, k + r * D + c * 16, ok);
        cp_async16(vd + p * D + c * 16, v + r * D + c * 16, ok);
      }
      if (tid < kN) {
        const int t = t0 + tid;
        const bool ok = t < t_end;
        const size_t r = !ok ? row0 : whole ? row0 + tid : addr.row(bh, b, h, t);
        scales[stage * 2 * kN + tid] = ok ? k_scale[r] : 0.f;
        scales[(stage * 2 + 1) * kN + tid] = ok ? v_scale[r] : 0.f;
      }
    } else {
      __nv_bfloat16* kd = ks + stage * kN * S;
      __nv_bfloat16* vd = vs + stage * kN * S;
      for (int i = tid; i < kN * C; i += kMqMmaThreads) {
        const int p = i / C;
        const int c = i % C;
        const int t = t0 + p;
        const bool ok = t < t_end;
        const size_t r = !ok ? row0 : whole ? row0 + p : addr.row(bh, b, h, t);
        cp_async16(kd + p * S + c * 8, k + r * D + c * 8, ok);
        cp_async16(vd + p * S + c * 8, v + r * D + c * 8, ok);
      }
    }
  };
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  // This thread's rows r0 = warp·16 + lane/4 and r0 + 8, and their limits
  // (0 for padding rows past the q-tile's: they stay (0, -inf, 0)).
  const int r0 = warp * 16 + lane / 4;
  const int lim0 = r0 < n_rows ? max(0, min(len, off + j0 + r0 / group + 1)) : 0;
  const int lim1 = r0 + 8 < n_rows ? max(0, min(len, off + j0 + (r0 + 8) / group + 1)) : 0;
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's columns

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_kv(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (kQuant) {  // the stage's codes widened to bf16 (exact for -127..127)
      const int8_t* kc = codes + stage * 2 * kN * D;
      for (int i = tid; i < 2 * kN * C8; i += kMqMmaThreads) {
        const int which = i / (kN * C8);  // 0: K, 1: V
        const int p = (i / C8) % kN;
        const int c = i % C8;
        const uint4 raw = *reinterpret_cast<const uint4*>(kc + (which * kN + p) * D + c * 16);
        const int8_t* cb = reinterpret_cast<const int8_t*>(&raw);
        unsigned wd[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          wd[e] = pack_bf16(static_cast<float>(cb[2 * e]), static_cast<float>(cb[2 * e + 1]));
        uint4* dst = reinterpret_cast<uint4*>((which ? vs : ks) + p * S + c * 16);
        dst[0] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
        dst[1] = make_uint4(wd[4], wd[5], wd[6], wd[7]);
      }
      __syncthreads();
    }
    const __nv_bfloat16* kt = ks + (kQuant ? 0 : stage) * kN * S;
    const __nv_bfloat16* vt = vs + (kQuant ? 0 : stage) * kN * S;
    const float* ksc = scales + stage * 2 * kN;
    const float* vsc = ksc + kN;

    // S = Q Kᵀ over the tile: 16 rows × kN positions per warp.
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
    const int k0 = t_begin + it * kN;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kl = j * 8 + 2 * (lane % 4) + e;
        float x0 = sc[j][e] * scale_log2;
        float x1 = sc[j][2 + e] * scale_log2;
        if constexpr (kQuant) {
          x0 *= ksc[kl];
          x1 *= ksc[kl];
        }
        if (k0 + kl >= lim0) x0 = -INFINITY;
        if (k0 + kl >= lim1) x1 = -INFINITY;
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
    // A row that has seen no position yet keeps m = -inf; exp2 against 0
    // then gives p = 0 and alpha = 0, never exp2(-inf - -inf).
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
        const int kl = j * 8 + 2 * (lane % 4) + e;
        const float p0 = exp2f(sc[j][e] - base0);
        const float p1 = exp2f(sc[j][2 + e] - base1);
        ps0 += p0;
        ps1 += p1;
        sc[j][e] = kQuant ? p0 * vsc[kl] : p0;  // the int8 V scale folds into p
        sc[j][2 + e] = kQuant ? p1 * vsc[kl] : p1;
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

  // One split writes the parts; several write partials (m in natural
  // units either way: a -inf stays -inf).
  const bool direct = n_used == 1;
  const int col = 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= n_rows) continue;
    const size_t mi = direct ? ((static_cast<size_t>(b) * q_len + j0 + r / group) * hkv + h) * group +
                                   r % group
                             : (part0 + split) * rows_all + row_base + r;
    float* dst = (direct ? acc_out : part_acc) + mi * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + j * 8 + col) = make_float2(o[j][2 * half], o[j][2 * half + 1]);
    if (lane % 4 == 0) {
      const float m_nat = (half ? m1 : m0) * kLn2;
      const float l_sum = half ? l1 : l0;
      if (direct) {
        m_out[mi] = m_nat;
        l_out[mi] = l_sum;
      } else {
        part_ml[2 * mi] = m_nat;
        part_ml[2 * mi + 1] = l_sum;
      }
    }
  }
  if (direct) return;
  if (!last_to_arrive(tickets + static_cast<size_t>(bh) * (gridDim.x / n_grid) + x, n_used)) return;

  // The last split merges, spread over the block, with its loads issued
  // together: every split's (m, l) of the q-tile's rows staged at once,
  // each row's weights e^{m_s - m} replacing its m's in place; then each
  // thread sums kMergeItems float4 columns of the rows, kMergeSplits
  // splits a pass in split order, so 32 loads of its are in flight (the
  // q-tile's partials of a split are contiguous rows).
  constexpr int kMlPer = kMqMaxSplits * kMqMmaRows / kMqMmaThreads;
  float2* ml = reinterpret_cast<float2*>(mq_smem);  // [n_used][64] (m, l)
  float* m_fin = reinterpret_cast<float*>(ml + kMqMaxSplits * kMqMmaRows);
  float* l_fin = m_fin + kMqMmaRows;
  {
    const int n_ml = n_used * n_rows;
    float2 v[kMlPer];
#pragma unroll
    for (int k = 0; k < kMlPer; ++k) {
      const int i = tid + k * kMqMmaThreads;
      if (i < n_ml)
        v[k] = __ldcg(reinterpret_cast<const float2*>(part_ml) +
                      (part0 + i / n_rows) * rows_all + row_base + i % n_rows);
    }
#pragma unroll
    for (int k = 0; k < kMlPer; ++k) {
      const int i = tid + k * kMqMmaThreads;
      if (i < n_ml) ml[(i / n_rows) * kMqMmaRows + i % n_rows] = v[k];
    }
  }
  __syncthreads();
  if (tid < n_rows) {
    float mx = -INFINITY;
    for (int s = 0; s < n_used; ++s) mx = fmaxf(mx, ml[s * kMqMmaRows + tid].x);
    float lsum = 0.f;
    for (int s = 0; s < n_used; ++s) {
      float2& e = ml[s * kMqMmaRows + tid];
      const float c = e.x == -INFINITY ? 0.f : expf(e.x - mx);  // never exp(-inf - -inf)
      e.x = c;
      lsum += c * e.y;
    }
    m_fin[tid] = mx;
    l_fin[tid] = lsum;
  }
  __syncthreads();
  constexpr int kQ = D / 4;  // float4 columns of a row
  constexpr int kMergeItems = 8;
  constexpr int kMergeSplits = 4;
  const int n_out = n_rows * kQ;
  const float4* pa = reinterpret_cast<const float4*>(part_acc);
  const size_t split_stride = static_cast<size_t>(rows_all) * kQ;
  for (int i0 = tid; i0 < n_out; i0 += kMergeItems * kMqMmaThreads) {
    float4 a[kMergeItems];
#pragma unroll
    for (int u = 0; u < kMergeItems; ++u) a[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < n_used; s0 += kMergeSplits) {
      const float4* p0 = pa + ((part0 + s0) * rows_all + row_base) * kQ;
      float4 x[kMergeSplits][kMergeItems];
#pragma unroll
      for (int q = 0; q < kMergeSplits; ++q)
#pragma unroll
        for (int u = 0; u < kMergeItems; ++u) {
          const int i = i0 + u * kMqMmaThreads;
          x[q][u] = i < n_out && s0 + q < n_used ? __ldcg(p0 + q * split_stride + i)
                                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
      for (int q = 0; q < kMergeSplits; ++q) {
        if (s0 + q >= n_used) break;
#pragma unroll
        for (int u = 0; u < kMergeItems; ++u) {
          const int i = i0 + u * kMqMmaThreads;
          if (i >= n_out) continue;
          const float c = ml[(s0 + q) * kMqMmaRows + i / kQ].x;
          a[u].x += c * x[q][u].x;
          a[u].y += c * x[q][u].y;
          a[u].z += c * x[q][u].z;
          a[u].w += c * x[q][u].w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kMergeItems; ++u) {
      const int i = i0 + u * kMqMmaThreads;
      if (i >= n_out) continue;
      const int r = i / kQ;
      const int d = 4 * (i % kQ);
      const size_t mi =
          ((static_cast<size_t>(b) * q_len + j0 + r / group) * hkv + h) * group + r % group;
      *reinterpret_cast<float4*>(acc_out + mi * D + d) = a[u];
      if (d == 0) {
        m_out[mi] = m_fin[r];
        l_out[mi] = l_fin[r];
      }
    }
  }
}

template <typename KV, int D, typename Rows>
cudaError_t launch_mq_mma(const void* q, const void* k, const void* v, const float* k_scale,
                          const float* v_scale, const Rows& addr, const int* lengths,
                          const int* offsets, float* part_acc, float* part_ml, int* tickets,
                          float* acc, float* m, float* l, int batch, int q_len, int hq, int hkv,
                          int n_grid, cudaStream_t stream) {
  constexpr int smem = MqMma<KV, D>::kBytes;
  const int group = hq / hkv;
  const int block_q = kMqMmaRows / group;
  const int q_tiles = ceil_div(q_len, block_q);
  auto kernel = mq_mma_kernel<KV, D, Rows>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(q_tiles * n_grid, batch * hkv), kMqMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v),
      k_scale, v_scale, lengths, offsets, part_acc, part_ml, tickets, acc, m, l, addr, hkv, group,
      q_len, block_q, n_grid, softmax_scale(D) * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename KV, typename Rows>
cudaError_t dispatch_mq_mma(int d_head, const void* q, const void* k, const void* v,
                            const float* k_scale, const float* v_scale, const Rows& addr,
                            const int* lengths, const int* offsets, float* part_acc,
                            float* part_ml, int* tickets, float* acc, float* m, float* l,
                            int batch, int q_len, int hq, int hkv, int n_grid,
                            cudaStream_t stream) {
#define PAGED_MQ_MMA_CASE(DH)                                                                 \
  case DH:                                                                                    \
    return launch_mq_mma<KV, DH, Rows>(q, k, v, k_scale, v_scale, addr, lengths, offsets,      \
                                       part_acc, part_ml, tickets, acc, m, l, batch, q_len, hq, \
                                       hkv, n_grid, stream);
  switch (d_head) {
    PAGED_MQ_MMA_CASE(16)
    PAGED_MQ_MMA_CASE(32)
    PAGED_MQ_MMA_CASE(64)
    PAGED_MQ_MMA_CASE(96)
    PAGED_MQ_MMA_CASE(128)
    PAGED_MQ_MMA_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef PAGED_MQ_MMA_CASE
}

// The f32-q multi-query parts (mq_partial_kernel + parts_merge_kernel) under
// either address policy; k_scale null: the caches hold f32, else int8 codes.
template <typename Rows>
int mq_parts_f32(int dtype, const void* q, const void* k, const void* v, const float* k_scale,
                 const float* v_scale, const Rows& addr, const int* lengths, const int* offsets,
                 float* part_acc, float* part_ml, float* acc, float* m, float* l, int batch,
                 int q_len, int hq, int hkv, int d_head, int n_split, int split_len,
                 cudaStream_t s) {
  if (dtype != kDtypeF32) return cudaErrorInvalidValue;
  if (k_scale != nullptr)
    return dispatch_mq_parts<float, int8_t, true>(d_head, q, k, v, k_scale, v_scale, addr,
                                                  lengths, offsets, part_acc, part_ml, acc, m, l,
                                                  batch, q_len, hq, hkv, n_split, split_len, s);
  return dispatch_mq_parts<float, float, false>(d_head, q, k, v, nullptr, nullptr, addr, lengths,
                                                offsets, part_acc, part_ml, acc, m, l, batch,
                                                q_len, hq, hkv, n_split, split_len, s);
}

}  // namespace

extern "C" {

const char* paged_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int paged_group_max() { return kGroupMax; }

// B4/B5: the unnormalised parts acc [B,Hkv,G,D], m and l [B,Hkv,G] (f32)
// over a pool of `dtype` elements (k_scale/v_scale null) or of int8 codes
// with f32 scales [P,Hkv,page]. n_grid blocks per (row, kv head),
// 1..kDcMaxSplits (the wrapper's decode_grid over Jmax·page); part_acc
// [B·Hkv, n_grid, G, D] and part_ml [B·Hkv, n_grid, G, 2] the split
// scratch; tickets [B·Hkv] zero.
int paged_parts(int dtype, const void* q, const void* k, const void* v, const float* k_scale,
                const float* v_scale, const int* table, const int* lengths, float* part_acc,
                float* part_ml, int* tickets, float* acc, float* m, float* l, int batch, int hq,
                int hkv, int n_pool, int page, int jmax, int d_head, int n_grid, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kGroupMax || n_pool <= 0 || page <= 0 ||
      jmax <= 0 || n_grid < 1 || n_grid > kDcMaxSplits)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PagedRows rows{table, jmax, page, hkv, n_pool};
  const bool quant = k_scale != nullptr;
  if (dtype == kDtypeBF16) {
    if (quant)
      return dispatch_decode_tile<__nv_bfloat16, int8_t, true, PagedRows, PartsOut>(
          d_head, q, k, v, k_scale, v_scale, lengths, part_acc, part_ml, tickets, acc, batch, hq,
          hkv, rows, n_grid, s, m, l);
    return dispatch_decode_tile<__nv_bfloat16, __nv_bfloat16, false, PagedRows, PartsOut>(
        d_head, q, k, v, nullptr, nullptr, lengths, part_acc, part_ml, tickets, acc, batch, hq,
        hkv, rows, n_grid, s, m, l);
  }
  if (dtype == kDtypeF32) {
    if (quant)
      return dispatch_decode_tile<float, int8_t, true, PagedRows, PartsOut>(
          d_head, q, k, v, k_scale, v_scale, lengths, part_acc, part_ml, tickets, acc, batch, hq,
          hkv, rows, n_grid, s, m, l);
    return dispatch_decode_tile<float, float, false, PagedRows, PartsOut>(
        d_head, q, k, v, nullptr, nullptr, lengths, part_acc, part_ml, tickets, acc, batch, hq,
        hkv, rows, n_grid, s, m, l);
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

// Query positions per row that one multi-query launch of q in `dtype`
// holds: the tensor-core kernel's (bf16) or the CUDA-core kernel's (f32).
int paged_mq_query_max(int dtype) { return dtype == kDtypeBF16 ? kMqMmaQueryMax : kMqQueryMax; }

// B7/B8 with an f32 q (the CUDA-core kernel): Q >= 2 query positions per
// row (Q = 1 is paged_parts with lengths cut to the causal limit).
// k_scale/v_scale null: the pools hold f32; else int8 codes.
int paged_mq_parts(int dtype, const void* q, const void* k, const void* v, const float* k_scale,
                   const float* v_scale, const int* table, const int* lengths,
                   const int* offsets, float* part_acc, float* part_ml, float* acc, float* m,
                   float* l, int batch, int q_len, int hq, int hkv, int n_pool, int page,
                   int jmax, int d_head, int n_split, int split_len, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kGroupMax || q_len < 1 || q_len > kMqQueryMax ||
      n_pool <= 0 || page <= 0)
    return cudaErrorInvalidValue;
  const PagedRows addr{table, jmax, page, hkv, n_pool};
  return mq_parts_f32(dtype, q, k, v, k_scale, v_scale, addr, lengths, offsets, part_acc,
                      part_ml, acc, m, l, batch, q_len, hq, hkv, d_head, n_split, split_len,
                      static_cast<cudaStream_t>(stream));
}

// B7/B8 with a bf16 q (the tensor-core kernel): 2 <= Q <= kMqMmaQueryMax,
// over a bf16 pool (k_scale/v_scale null) or int8 codes with f32 scales.
// n_grid splits per (q-tile, row, kv head), 1..kMqMaxSplits (the wrapper's
// mq_grid); part_acc [B·Hkv, n_grid, Q·G, D] and part_ml [B·Hkv, n_grid,
// Q·G, 2] the split scratch; tickets [B·Hkv·q-tiles] zero.
int paged_mq_mma_parts(const void* q, const void* k, const void* v, const float* k_scale,
                       const float* v_scale, const int* table, const int* lengths,
                       const int* offsets, float* part_acc, float* part_ml, int* tickets,
                       float* acc, float* m, float* l, int batch, int q_len, int hq, int hkv,
                       int n_pool, int page, int jmax, int d_head, int n_grid, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kGroupMax || q_len < 2 ||
      q_len > kMqMmaQueryMax || n_pool <= 0 || page <= 0 || jmax <= 0 || n_grid < 1 ||
      n_grid > kMqMaxSplits || tickets == nullptr)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const PagedRows addr{table, jmax, page, hkv, n_pool};
  if (k_scale != nullptr)
    return dispatch_mq_mma<int8_t>(d_head, q, k, v, k_scale, v_scale, addr, lengths, offsets,
                                   part_acc, part_ml, tickets, acc, m, l, batch, q_len, hq, hkv,
                                   n_grid, s);
  return dispatch_mq_mma<__nv_bfloat16>(d_head, q, k, v, nullptr, nullptr, addr, lengths,
                                        offsets, part_acc, part_ml, tickets, acc, m, l, batch,
                                        q_len, hq, hkv, n_grid, s);
}

// B7/B8's bodies over contiguous rows (the contiguous session's verify):
// caches [B,Hkv,T,D] of bf16/f32 elements, or int8 codes with f32 scales
// [B,Hkv,T] (k_scale/v_scale non-null). Query j of row b sees positions
// kpos < min(lengths[b], offsets[b] + j + 1); the caller passes lengths =
// offsets + Q (every candidate is in the cache). Outputs and scratch as
// paged_mq_parts (f32 q: n_split host-sized splits of split_len positions,
// merged by parts_merge_kernel) and paged_mq_mma_parts (bf16 q: n_grid
// splits per (q-tile, row, kv head), 1..kMqMaxSplits, tickets
// [B·Hkv·q-tiles] zero). Q >= 1.
int contig_mq_parts(int dtype, const void* q, const void* k, const void* v,
                    const float* k_scale, const float* v_scale, const int* lengths,
                    const int* offsets, float* part_acc, float* part_ml, float* acc, float* m,
                    float* l, int batch, int q_len, int hq, int hkv, int t_cap, int d_head,
                    int n_split, int split_len, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kGroupMax || q_len < 1 || q_len > kMqQueryMax ||
      t_cap <= 0)
    return cudaErrorInvalidValue;
  return mq_parts_f32(dtype, q, k, v, k_scale, v_scale, ContiguousRows{t_cap}, lengths, offsets,
                      part_acc, part_ml, acc, m, l, batch, q_len, hq, hkv, d_head, n_split,
                      split_len, static_cast<cudaStream_t>(stream));
}

int contig_mq_mma_parts(const void* q, const void* k, const void* v, const float* k_scale,
                        const float* v_scale, const int* lengths, const int* offsets,
                        float* part_acc, float* part_ml, int* tickets, float* acc, float* m,
                        float* l, int batch, int q_len, int hq, int hkv, int t_cap, int d_head,
                        int n_grid, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kGroupMax || q_len < 1 ||
      q_len > kMqMmaQueryMax || t_cap <= 0 || n_grid < 1 || n_grid > kMqMaxSplits ||
      tickets == nullptr)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ContiguousRows addr{t_cap};
  if (k_scale != nullptr)
    return dispatch_mq_mma<int8_t>(d_head, q, k, v, k_scale, v_scale, addr, lengths, offsets,
                                   part_acc, part_ml, tickets, acc, m, l, batch, q_len, hq, hkv,
                                   n_grid, s);
  return dispatch_mq_mma<__nv_bfloat16>(d_head, q, k, v, nullptr, nullptr, addr, lengths,
                                        offsets, part_acc, part_ml, tickets, acc, m, l, batch,
                                        q_len, hq, hkv, n_grid, s);
}

}  // extern "C"

// Shared pieces of the port's kernels: the element types, the warp
// reductions, asynchronous copies, the bf16 tensor-core product, ldmatrix
// fragments and the arrival ticket of attention.cu (contiguous caches),
// paged_attention.cu (page pools read through a table) and int4_matmul.cu;
// the address and output policies of the one-query decode body; and that
// body itself.
//
// decode_tile_kernel is the one-launch decode of B2/B3 (ContiguousRows:
// [B,Hkv,T,D] caches) and of B4/B5/B6 (PagedRows: [P,Hkv,page,D] pools
// read through a [B,Jmax] page table): splits sized on the device from
// lengths[b], tiles of kDcTile positions by 16-byte cp.async,
// double-buffered, a tile's scores computed at once, and the last split of
// a (row, kv head) to finish merging the splits through an atomic ticket.
// Its output policy says what it writes: NormalisedOut the attention
// itself, acc / l in q's type (B2, B3, B6); PartsOut the unnormalised
// parts (acc, m, l) in f32 (B4, B5), which the transformer merges with its
// side cache. Under ContiguousRows and NormalisedOut its addresses and
// arithmetic are those of the contiguous kernel it came from, so B2/B3
// keep their bits.
//
// Every load is widened to f32; scores, softmax and accumulators are f32.
// A block past its row's splits reads nothing and exits; a row with no
// position runs one block that reads no tile, so its parts are exactly
// (0, -inf, 0) and exp(-inf - -inf) is never formed.

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

constexpr int kGroupMax = 8;  // query heads per kv head held in registers

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ---- asynchronous copies and tensor-core fragments -------------------------

// 16 bytes global → shared; with !pred nothing is read and the bytes are 0.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n)
               : "memory");
}
// 4 bytes global → shared (a scale); with !pred nothing is read and it is 0.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c[16×8] += a[16×16] · b[16×8], bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8×8 b16 matrices from shared memory into mma fragments (B1, B7/B8).
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* smem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&x);
}

// The last of `n` blocks to call this on `ticket` gets true, after every
// block's global writes made before the call are visible to it; it resets
// the ticket for the next launch.
__device__ __forceinline__ bool last_to_arrive(int* ticket, int n) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1) == n - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The one-launch decode body's block, tile and split limits.
constexpr int kDcWarps = 4;
constexpr int kDcThreads = kDcWarps * 32;
constexpr int kDcTile = 32;          // positions per staged tile (one per lane)
constexpr int kDcMinSplit = 64;      // positions per split, at least
constexpr int kDcMaxSplits = 128;    // splits per (row, kv head), at most

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
  // A tile of kDcTile positions from a multiple of kDcTile stays in one page.
  __device__ __forceinline__ bool tile_contiguous() const { return page % kDcTile == 0; }
  // A tile of n positions from a multiple of n lies in one run of
  // consecutive rows (one page): its rows are row(t0) + 0..n-1.
  __device__ __forceinline__ bool tile_in_run(int n) const { return page % n == 0; }
};

// [B,Hkv,T,D] caches (scales [B,Hkv,T]): the T rows of (b, h) are
// contiguous from row bh·T.
struct ContiguousRows {
  int t_cap;  // T
  __device__ __forceinline__ int capacity() const { return t_cap; }
  __device__ __forceinline__ size_t row(int bh, int /*b*/, int /*h*/, int t) const {
    return static_cast<size_t>(bh) * t_cap + t;
  }
  __device__ __forceinline__ bool tile_contiguous() const { return true; }
  __device__ __forceinline__ bool tile_in_run(int /*n*/) const { return true; }
};

// Output policies of decode_tile_kernel: the element type of its `out`
// and whether it writes parts. NormalisedOut: out [B,Hq,D] in T = acc / l.
// PartsOut: out = acc [B,Hkv,G,D] f32 = Σ e^{s-m}·v, with m [B,Hkv,G] f32
// = max s (natural units) and l [B,Hkv,G] f32 = Σ e^{s-m} beside it.
template <typename T>
struct NormalisedOut {
  using Elem = T;
  static constexpr bool kParts = false;
};
struct PartsOut {
  using Elem = float;
  static constexpr bool kParts = true;
};

// ---------------------------------------------------------------------------
// The one-launch decode body (B2-B6): splits sized from each row's
// length, tiles by cp.async, the last split merging through a ticket.


// A 16-byte chunk of a K row widened to f32.
template <typename KV>
struct Widen;
template <>
struct Widen<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void run(const uint4& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};
template <>
struct Widen<int8_t> {
  static constexpr int E = 16;
  __device__ static void run(const uint4& r, float* f) {
    const int8_t* c = reinterpret_cast<const int8_t*>(&r);
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(c[i]);
  }
};
template <>
struct Widen<float> {
  static constexpr int E = 4;
  __device__ static void run(const uint4& r, float* f) {
    const float* x = reinterpret_cast<const float*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = x[i];
  }
};

// Dynamic shared memory of decode_tile_kernel: a 2-stage ring of K rows
// (padded by 16 bytes: lanes read different rows) and V rows, which after
// the loop holds the warps' accumulators [warps][kGroupMax][D] and then
// the merge's (m, l) per split and head; then q [kGroupMax][D] f32, p [kDcTile][kGroupMax]
// (V scale folded in), per-head alpha, m and l, and the staged scales.
template <typename KV, int D>
struct DcSmem {
  static constexpr int kRow = D * static_cast<int>(sizeof(KV));
  static constexpr int kKStride = kRow + 16;
  static constexpr int kStage = kDcTile * (kKStride + kRow);
  static constexpr int kRing = 2 * kStage;
  static constexpr int kRed = static_cast<int>(sizeof(float)) * kDcWarps * kGroupMax * D;
  // the merge's (m, l) per split and head: larger than the ring only for
  // int8 at D 32 and bf16 or int8 at D 16 (at every other width the ring
  // holds it, as before)
  static constexpr int kMerge = static_cast<int>(sizeof(float)) * 2 * kGroupMax * kDcMaxSplits;
  static constexpr int kRingRed = kRing > kRed ? kRing : kRed;
  static constexpr int kUnion = kRingRed > kMerge ? kRingRed : kMerge;
  static constexpr int kBytes =
      kUnion + static_cast<int>(sizeof(float)) *
                   (kGroupMax * D + kDcTile * kGroupMax + 3 * kGroupMax + 4 * kDcTile);
  static_assert(kUnion >= kMerge, "the merge's (m, l) must fit the ring");
};

// grid (n_grid, B·Hkv), block kDcThreads. part_acc [B·Hkv, n_grid, G, D]
// and part_ml [B·Hkv, n_grid, G, 2] hold the splits' partials; tickets
// [B·Hkv]. What the block that finishes a (row, kv head) writes is the
// `Out` policy's business: with NormalisedOut, out [B, Hq, D] =
// softmax(q·Kᵀ·scale)·V over t < lengths[b], a row with no position giving
// 0/0 (NaN) as the plain version does; with PartsOut, out = acc, m_out = m
// and l_out = l (unused otherwise), a row with no position giving exactly
// (0, -inf, 0). Where position t of a row lives is the `Rows` policy's
// business (ContiguousRows for B2/B3, PagedRows for B4-B6). A tile never
// starts off a multiple of kDcTile, so where rows.tile_contiguous() holds
// its positions are consecutive rows from the tile's first: one lookup a
// tile, made a tile ahead of the copies that use it. Otherwise (a page
// that is not a multiple of kDcTile) each position is looked up, a
// thread's lookups issued together before its copies.
template <typename T, typename KV, int D, bool kQuant, typename Rows, typename Out>
__global__ void __launch_bounds__(kDcThreads)
    decode_tile_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                       const KV* __restrict__ v, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, const int* __restrict__ lengths,
                       float* __restrict__ part_acc, float* __restrict__ part_ml,
                       int* __restrict__ tickets, typename Out::Elem* __restrict__ out, int hkv,
                       int group, Rows rows, float scale, float* __restrict__ m_out,
                       float* __restrict__ l_out) {
  using L = DcSmem<KV, D>;
  // P·V columns per lane: D / 32, or at D 16 one column of one of the
  // warp's two positions (a half-warp a position)
  constexpr int V = D >= 32 ? D / 32 : 1;
  constexpr int E = Widen<KV>::E;             // K elements per 16-byte chunk
  constexpr int C = L::kRow / 16;             // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char dc_smem[];
  unsigned char* ring = dc_smem;
  float* red = reinterpret_cast<float*>(dc_smem);
  float* qs = reinterpret_cast<float*>(dc_smem + L::kUnion);
  float* pt = qs + kGroupMax * D;
  float* alpha_s = pt + kDcTile * kGroupMax;
  float* m_fin = alpha_s + kGroupMax;
  float* l_fin = m_fin + kGroupMax;
  float* scales = l_fin + kGroupMax;  // [stage][K, V][kDcTile]

  const int n_grid = gridDim.x;
  const int split = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / hkv;
  const int h = bh % hkv;
  const int len = max(0, min(lengths[b], rows.capacity()));
  int n_used = max(1, min(n_grid, ceil_div(len, kDcMinSplit)));
  const int split_len = ceil_div(ceil_div(max(len, 1), n_used), kDcTile) * kDcTile;
  n_used = max(1, ceil_div(len, split_len));
  if (split >= n_used) return;  // past the row: no read, no ticket
  const int t_begin = split * split_len;
  const int t_end = min(t_begin + split_len, len);
  const int n_tiles = ceil_div(t_end - t_begin, kDcTile);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v);
  const bool whole_tiles = rows.tile_contiguous();

  // Tile t0 into ring stage `stage`; row0 is the row of position t0, looked
  // up a tile ahead by the caller. Where a tile lies in one page its rows
  // follow row0; otherwise each position is looked up, a thread's lookups
  // all issued before its copies. The int8 scales arrive by cp.async too.
  constexpr int kPer = ceil_div(kDcTile * C, kDcThreads);  // chunks per thread
  auto load = [&](int t0, int stage, size_t row0) {
    unsigned char* kd = ring + stage * L::kStage;
    unsigned char* vd = kd + kDcTile * L::kKStride;
    size_t r[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kDcThreads;
      const int t = t0 + i / C;
      r[j] = whole_tiles ? row0 + i / C
                         : i < kDcTile * C && t < t_end ? rows.row(bh, b, h, t) : row0;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kDcThreads;
      if (i < kDcTile * C) {
        const int p = i / C;
        const int c = i % C;
        const bool ok = t0 + p < t_end;
        const size_t src = (ok ? r[j] : row0) * L::kRow + c * 16;
        cp_async16(kd + p * L::kKStride + c * 16, kb + src, ok);
        cp_async16(vd + p * L::kRow + c * 16, vb + src, ok);
      }
    }
    if (kQuant && tid < kDcTile) {
      const int t = t0 + tid;
      const bool ok = t < t_end;
      const size_t rs = !ok ? row0 : whole_tiles ? row0 + tid : rows.row(bh, b, h, t);
      cp_async4(scales + (stage * 2) * kDcTile + tid, k_scale + rs, ok);
      cp_async4(scales + (stage * 2 + 1) * kDcTile + tid, v_scale + rs, ok);
    }
  };

  float m_run[2] = {-INFINITY, -INFINITY};  // heads warp and warp + 4
  float l_run[2] = {0.f, 0.f};
  float acc[kGroupMax][V];
#pragma unroll
  for (int g = 0; g < kGroupMax; ++g)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[g][i] = 0.f;

  load(t_begin, 0, rows.row(bh, b, h, t_begin));
  cp_async_commit();
  // the next tile's first row, in flight with the first tile
  size_t row_next = 1 < n_tiles ? rows.row(bh, b, h, t_begin + kDcTile) : 0;
  // q while the first tile is in flight (the first barrier orders it)
  const T* qg = q + static_cast<size_t>(bh) * group * D;
#pragma unroll 4
  for (int i = tid; i < group * D; i += kDcThreads) qs[i] = to_f(qg[i]);
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const int t0 = t_begin + it * kDcTile;
    if (it + 1 < n_tiles) {
      const size_t row1 = row_next;
      if (it + 2 < n_tiles) row_next = rows.row(bh, b, h, t0 + 2 * kDcTile);
      load(t0 + kDcTile, stage ^ 1, row1);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned char* kd = ring + stage * L::kStage;
    const unsigned char* vd = kd + kDcTile * L::kKStride;
    const int n_valid = min(kDcTile, t_end - t0);

    // Scores of the tile: lane = position, this warp's two heads.
    float s[2] = {0.f, 0.f};
    const unsigned char* krow = kd + lane * L::kKStride;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const uint4 raw = *reinterpret_cast<const uint4*>(krow + c * 16);
      float kf[E];
      Widen<KV>::run(raw, kf);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int g = warp + kDcWarps * hh;
        if (g < group) {
          const float* qr = qs + g * D + c * E;
#pragma unroll
          for (int e = 0; e < E; ++e) s[hh] += qr[e] * kf[e];
        }
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int g = warp + kDcWarps * hh;
      if (g < group) {  // warp-uniform
        float x = s[hh] * scale;
        if (kQuant) x *= scales[(stage * 2) * kDcTile + lane];
        if (lane >= n_valid) x = -INFINITY;
        const float m_new = fmaxf(m_run[hh], warp_max(x));  // finite: position 0 is valid
        const float alpha = expf(m_run[hh] - m_new);        // 0 on the first tile
        const float p = expf(x - m_new);
        l_run[hh] = l_run[hh] * alpha + warp_sum(p);
        m_run[hh] = m_new;
        const float pv = kQuant ? p * scales[(stage * 2 + 1) * kDcTile + lane] : p;
        pt[lane * kGroupMax + g] = pv;  // the int8 V scale folds into p
        if (lane == 0) alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // P·V: warp w takes positions w, w + 4, ...; lane the D/32 columns.
#pragma unroll
    for (int g = 0; g < kGroupMax; ++g) {
      if (g < group) {
        const float a = alpha_s[g];
#pragma unroll
        for (int i = 0; i < V; ++i) acc[g][i] *= a;
      }
    }
    if constexpr (D >= 32) {
      for (int p = warp; p < n_valid; p += kDcWarps) {
        const KV* vrow = reinterpret_cast<const KV*>(vd + p * L::kRow) + lane * V;
        float vv[V];
#pragma unroll
        for (int i = 0; i < V; ++i) vv[i] = to_f(vrow[i]);
        const float4 p0 = *reinterpret_cast<const float4*>(pt + p * kGroupMax);
        const float4 p1 = *reinterpret_cast<const float4*>(pt + p * kGroupMax + 4);
        const float pp[kGroupMax] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int g = 0; g < kGroupMax; ++g) {
          if (g < group) {
#pragma unroll
            for (int i = 0; i < V; ++i) acc[g][i] += pp[g] * vv[i];
          }
        }
      }
    } else {
      // D 16: half-warp lane / 16 of warp w takes positions
      // w + 4·(2·i + lane / 16), lane % 16 its column.
      for (int p = warp + kDcWarps * (lane / D); p < n_valid; p += 2 * kDcWarps) {
        const float vv = to_f(reinterpret_cast<const KV*>(vd + p * L::kRow)[lane % D]);
        const float4 p0 = *reinterpret_cast<const float4*>(pt + p * kGroupMax);
        const float4 p1 = *reinterpret_cast<const float4*>(pt + p * kGroupMax + 4);
        const float pp[kGroupMax] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int g = 0; g < kGroupMax; ++g) {
          if (g < group) acc[g][0] += pp[g] * vv;
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // The warps share m and l per head; their accumulators simply add.
  if constexpr (D >= 32) {
#pragma unroll
    for (int g = 0; g < kGroupMax; ++g) {
      if (g < group) {
#pragma unroll
        for (int i = 0; i < V; ++i) red[(warp * kGroupMax + g) * D + lane * V + i] = acc[g][i];
      }
    }
  } else {
    // D 16: the upper half-warp's sums join the lower's (group is uniform)
#pragma unroll
    for (int g = 0; g < kGroupMax; ++g) {
      if (g < group) {
        const float a = acc[g][0] + __shfl_down_sync(0xffffffffu, acc[g][0], D);
        if (lane < D) red[(warp * kGroupMax + g) * D + lane] = a;
      }
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int g = warp + kDcWarps * hh;
    if (g < group && lane == 0) {
      m_fin[g] = m_run[hh];
      l_fin[g] = l_run[hh];
    }
  }
  __syncthreads();
  typename Out::Elem* og = out + static_cast<size_t>(bh) * group * D;
  if (n_used == 1) {
    for (int i = tid; i < group * D; i += kDcThreads) {
      const int g = i / D;
      const int d = i % D;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kDcWarps; ++w) a += red[(w * kGroupMax + g) * D + d];
      if constexpr (Out::kParts)
        og[i] = a;
      else
        og[i] = from_f<T>(a / l_fin[g]);
    }
    if constexpr (Out::kParts) {
      if (tid < group) {  // an empty row: m_run -inf, l_run 0, acc 0, as read
        m_out[static_cast<size_t>(bh) * group + tid] = m_fin[tid];
        l_out[static_cast<size_t>(bh) * group + tid] = l_fin[tid];
      }
    }
    return;
  }
  const size_t base = (static_cast<size_t>(bh) * n_grid + split) * group;
  for (int i = tid; i < group * D; i += kDcThreads) {
    const int g = i / D;
    const int d = i % D;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kDcWarps; ++w) a += red[(w * kGroupMax + g) * D + d];
    part_acc[base * D + i] = a;
  }
  if (tid < group) {
    part_ml[2 * (base + tid)] = m_fin[tid];
    part_ml[2 * (base + tid) + 1] = l_fin[tid];
  }
  if (!last_to_arrive(tickets + bh, n_used)) return;

  // The last split merges. Every split's (m, l) is staged in the ring by
  // all threads at once (no chain of dependent loads), then each head's
  // weights e^{m_s - m} replace the m's in place; each thread then sums
  // 4 columns of one head over the splits, several loads in flight. Parts
  // keep m = max m_s and l = Σ e^{m_s - m}·l_s, and acc undivided (every
  // used split read a position, so m is finite).
  float* ml = red;  // [n_used][group][2]
  const size_t row0 = static_cast<size_t>(bh) * n_grid;
  for (int i = tid; i < 2 * n_used * group; i += kDcThreads) ml[i] = __ldcg(part_ml + 2 * row0 * group + i);
  __syncthreads();
  if (tid < group) {
    float mx = -INFINITY;
    for (int s = 0; s < n_used; ++s) mx = fmaxf(mx, ml[2 * (s * group + tid)]);
    float lsum = 0.f;
    for (int s = 0; s < n_used; ++s) {
      const float ms = ml[2 * (s * group + tid)];
      const float c = ms == -INFINITY ? 0.f : expf(ms - mx);
      ml[2 * (s * group + tid)] = c;
      lsum += c * ml[2 * (s * group + tid) + 1];
    }
    l_fin[tid] = lsum;
    if constexpr (Out::kParts) {
      m_out[static_cast<size_t>(bh) * group + tid] = mx;
      l_out[static_cast<size_t>(bh) * group + tid] = lsum;
    }
  }
  __syncthreads();
  for (int i = tid; i < group * (D / 4); i += kDcThreads) {
    const int g = i / (D / 4);
    const int d = 4 * (i % (D / 4));
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < n_used; ++s) {
      const float c = ml[2 * (s * group + g)];
      const float4 x = __ldcg(reinterpret_cast<const float4*>(part_acc + ((row0 + s) * group + g) * D + d));
      a.x += c * x.x;
      a.y += c * x.y;
      a.z += c * x.z;
      a.w += c * x.w;
    }
    if constexpr (Out::kParts) {
      *reinterpret_cast<float4*>(og + g * D + d) = a;
    } else {
      const float inv = 1.f / l_fin[g];
      og[g * D + d] = from_f<T>(a.x * inv);
      og[g * D + d + 1] = from_f<T>(a.y * inv);
      og[g * D + d + 2] = from_f<T>(a.z * inv);
      og[g * D + d + 3] = from_f<T>(a.w * inv);
    }
  }
}

template <typename T, typename KV, int D, bool kQuant, typename Rows, typename Out>
cudaError_t launch_decode_tile(const void* q, const void* k, const void* v, const float* k_scale,
                               const float* v_scale, const int* lengths, float* part_acc,
                               float* part_ml, int* tickets, void* out, int batch, int hq,
                               int hkv, Rows rows, int n_grid, cudaStream_t stream,
                               float* m_out, float* l_out) {
  constexpr int smem = DcSmem<KV, D>::kBytes;
  auto kernel = decode_tile_kernel<T, KV, D, kQuant, Rows, Out>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(n_grid, batch * hkv), kDcThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v), k_scale,
      v_scale, lengths, part_acc, part_ml, tickets, static_cast<typename Out::Elem*>(out), hkv,
      hq / hkv, rows, softmax_scale(D), m_out, l_out);
  return cudaGetLastError();
}

// n_grid blocks per (row, kv head), 1..kDcMaxSplits (the wrappers' decode_grid).
// Out = PartsOut also takes m_out and l_out [B·Hkv·G] f32 beside out (acc).
template <typename T, typename KV, bool kQuant, typename Rows, typename Out = NormalisedOut<T>>
cudaError_t dispatch_decode_tile(int d_head, const void* q, const void* k, const void* v,
                                 const float* k_scale, const float* v_scale, const int* lengths,
                                 float* part_acc, float* part_ml, int* tickets, void* out,
                                 int batch, int hq, int hkv, Rows rows, int n_grid,
                                 cudaStream_t stream, float* m_out = nullptr,
                                 float* l_out = nullptr) {
  if (n_grid < 1 || n_grid > kDcMaxSplits || tickets == nullptr || out == nullptr ||
      (Out::kParts && (m_out == nullptr || l_out == nullptr)))
    return cudaErrorInvalidValue;
#define DECODE_TILE_CASE(DH)                                                                  \
  case DH:                                                                                    \
    return launch_decode_tile<T, KV, DH, kQuant, Rows, Out>(q, k, v, k_scale, v_scale, lengths, \
                                                            part_acc, part_ml, tickets, out,    \
                                                            batch, hq, hkv, rows, n_grid,       \
                                                            stream, m_out, l_out);
  switch (d_head) {
    DECODE_TILE_CASE(16)
    DECODE_TILE_CASE(32)
    DECODE_TILE_CASE(64)
    DECODE_TILE_CASE(96)
    DECODE_TILE_CASE(128)
    DECODE_TILE_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef DECODE_TILE_CASE
}

}  // namespace port_attn

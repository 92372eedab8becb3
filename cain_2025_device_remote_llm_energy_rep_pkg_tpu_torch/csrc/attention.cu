// Hopper (sm_90a) attention kernels of the PyTorch port, with a plain C
// interface for ctypes (ops/_kernels.py builds this file with nvcc at first
// use; ops/cuda_attention.py holds the wrappers and their launch counts).
//
// Layouts are the JAX package's: q [B,S,Hq,D] (prefill) or [B,Hq,D]
// (decode); caches [B,Hkv,T,D], each head's T rows contiguous; int8 cache
// scales [B,Hkv,T] f32; lengths [B] int32. Element types: float32 or
// bfloat16 for q/k/v/out, int8 codes for the quantized cache. Scores,
// softmax and accumulators are f32; the output is cast to the input type
// once, at the end. Head dims 64, 96, 128 and 256 are supported natively
// (no padding to 128 lanes); the softmax scale is 1/sqrt(D). G = Hq / Hkv
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
//    launch's latency, so the design cuts latency. decode_tile_kernel:
//    the grid is (splits, B·Hkv), sized from B·Hkv and T alone; each block
//    reads lengths[b] and sizes the row's splits from it (at least
//    kDcMinSplit positions each), so blocks past the row exit at once and
//    a short row still spreads over several SMs. A split streams tiles of
//    kDcTile positions by 16-byte cp.async, double-buffered; a tile's
//    scores [G, tile] are computed at once (lane = position, warp = two
//    heads of the group) and each head's online softmax is updated once a
//    tile, by the warp that scored it. P·V: warp w takes positions
//    w, w+4, ..., lane the D/32 columns. The last split of a (b, kv head)
//    to finish (an atomic ticket) merges the partials and writes the
//    normalised output: one launch per call. The split body of the paged
//    kernels (decode_partial_kernel, decode_common.cuh) is not used here.

#include "decode_common.cuh"

namespace {

using namespace port_attn;

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ---- asynchronous copies and tensor-core fragments -------------------------

// 16 bytes global → shared; with !pred nothing is read and the bytes are 0.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// c[16×8] += a[16×16] · b[16×8], bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// ---------------------------------------------------------------------------
// Decode (B2, B3): one launch, splits sized from each row's length.

constexpr int kDcWarps = 4;
constexpr int kDcThreads = kDcWarps * 32;
constexpr int kDcTile = 32;          // positions per staged tile (one per lane)
constexpr int kDcMinSplit = 64;      // positions per split, at least
constexpr int kDcMaxSplits = 128;    // splits per (row, kv head), at most
constexpr int kDcTargetBlocks = 264; // about two blocks per SM of the card

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
  static constexpr int kUnion = kRing > kRed ? kRing : kRed;
  static constexpr int kBytes =
      kUnion + static_cast<int>(sizeof(float)) *
                   (kGroupMax * D + kDcTile * kGroupMax + 3 * kGroupMax + 4 * kDcTile);
  static_assert(kUnion >= static_cast<int>(sizeof(float)) * 2 * kGroupMax * kDcMaxSplits,
                "the merge's (m, l) must fit the ring");
};

// grid (n_grid, B·Hkv), block kDcThreads. part_acc [B·Hkv, n_grid, G, D]
// and part_ml [B·Hkv, n_grid, G, 2] hold the splits' partials; tickets
// [B·Hkv]. out [B, Hq, D] = softmax(q·Kᵀ·scale)·V over t < lengths[b]; a
// row with no position gives 0/0 (NaN), as the plain version does.
template <typename T, typename KV, int D, bool kQuant>
__global__ void __launch_bounds__(kDcThreads)
    decode_tile_kernel(const T* __restrict__ q, const KV* __restrict__ k,
                       const KV* __restrict__ v, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, const int* __restrict__ lengths,
                       float* __restrict__ part_acc, float* __restrict__ part_ml,
                       int* __restrict__ tickets, T* __restrict__ out, int hkv, int group,
                       int t_cap, float scale) {
  using L = DcSmem<KV, D>;
  constexpr int V = D / 32;                   // P·V columns per lane
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
  const int len = max(0, min(lengths[b], t_cap));
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
  const unsigned char* kh =
      reinterpret_cast<const unsigned char*>(k + static_cast<size_t>(bh) * t_cap * D);
  const unsigned char* vh =
      reinterpret_cast<const unsigned char*>(v + static_cast<size_t>(bh) * t_cap * D);

  auto load = [&](int t0, int stage) {
    unsigned char* kd = ring + stage * L::kStage;
    unsigned char* vd = kd + kDcTile * L::kKStride;
    for (int i = tid; i < kDcTile * C; i += kDcThreads) {
      const int p = i / C;
      const int c = i % C;
      const int t = t0 + p;
      const bool ok = t < t_end;
      const size_t src = static_cast<size_t>(ok ? t : t_begin) * L::kRow + c * 16;
      cp_async16(kd + p * L::kKStride + c * 16, kh + src, ok);
      cp_async16(vd + p * L::kRow + c * 16, vh + src, ok);
    }
    if (kQuant && tid < kDcTile) {
      const int t = t0 + tid;
      const size_t r = static_cast<size_t>(bh) * t_cap + t;
      scales[(stage * 2) * kDcTile + tid] = t < t_end ? k_scale[r] : 0.f;
      scales[(stage * 2 + 1) * kDcTile + tid] = t < t_end ? v_scale[r] : 0.f;
    }
  };

  float m_run[2] = {-INFINITY, -INFINITY};  // heads warp and warp + 4
  float l_run[2] = {0.f, 0.f};
  float acc[kGroupMax][V];
#pragma unroll
  for (int g = 0; g < kGroupMax; ++g)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[g][i] = 0.f;

  load(t_begin, 0);
  cp_async_commit();
  // q while the first tile is in flight (the first barrier orders it)
  const T* qg = q + static_cast<size_t>(bh) * group * D;
#pragma unroll 4
  for (int i = tid; i < group * D; i += kDcThreads) qs[i] = to_f(qg[i]);
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    const int t0 = t_begin + it * kDcTile;
    if (it + 1 < n_tiles) load(t0 + kDcTile, stage ^ 1);
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
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // The warps share m and l per head; their accumulators simply add.
#pragma unroll
  for (int g = 0; g < kGroupMax; ++g) {
    if (g < group) {
#pragma unroll
      for (int i = 0; i < V; ++i) red[(warp * kGroupMax + g) * D + lane * V + i] = acc[g][i];
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
  T* og = out + static_cast<size_t>(bh) * group * D;
  if (n_used == 1) {
    for (int i = tid; i < group * D; i += kDcThreads) {
      const int g = i / D;
      const int d = i % D;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kDcWarps; ++w) a += red[(w * kGroupMax + g) * D + d];
      og[i] = from_f<T>(a / l_fin[g]);
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
  // 4 columns of one head over the splits, several loads in flight.
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
    const float inv = 1.f / l_fin[g];
    og[g * D + d] = from_f<T>(a.x * inv);
    og[g * D + d + 1] = from_f<T>(a.y * inv);
    og[g * D + d + 2] = from_f<T>(a.z * inv);
    og[g * D + d + 3] = from_f<T>(a.w * inv);
  }
}

// Splits per (row, kv head) the decode grid holds: enough that B·Hkv·n
// blocks cover the card about twice, none starting past the capacity.
int decode_grid(int batch, int hkv, int t_cap) {
  const int pairs = max(1, batch * hkv);
  const int n = min(kDcMaxSplits, ceil_div(kDcTargetBlocks, pairs));
  return max(1, min(n, ceil_div(max(t_cap, 1), kDcMinSplit)));
}

template <typename T, typename KV, int D, bool kQuant>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const float* k_scale,
                          const float* v_scale, const int* lengths, float* part_acc,
                          float* part_ml, int* tickets, void* out, int batch, int hq, int hkv,
                          int t_cap, int n_grid, float scale, cudaStream_t stream) {
  constexpr int smem = DcSmem<KV, D>::kBytes;
  auto kernel = decode_tile_kernel<T, KV, D, kQuant>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(n_grid, batch * hkv), kDcThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k), static_cast<const KV*>(v), k_scale,
      v_scale, lengths, part_acc, part_ml, tickets, static_cast<T*>(out), hkv, hq / hkv, t_cap,
      scale);
  return cudaGetLastError();
}

template <typename T, typename KV, bool kQuant>
cudaError_t dispatch_decode(int d_head, const void* q, const void* k, const void* v,
                            const float* k_scale, const float* v_scale, const int* lengths,
                            float* part_acc, float* part_ml, int* tickets, void* out, int batch,
                            int hq, int hkv, int t_cap, int n_grid, float scale,
                            cudaStream_t stream) {
#define ATTN_DECODE_CASE(DH)                                                                \
  case DH:                                                                                  \
    return launch_decode<T, KV, DH, kQuant>(q, k, v, k_scale, v_scale, lengths, part_acc,   \
                                            part_ml, tickets, out, batch, hq, hkv, t_cap,   \
                                            n_grid, scale, stream);
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

int attn_decode_grid(int batch, int hkv, int t_cap) { return decode_grid(batch, hkv, t_cap); }

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
// n_grid = attn_decode_grid(batch, hkv, t_cap); part_acc [B·Hkv, n_grid,
// G, D], part_ml [B·Hkv, n_grid, G, 2], tickets [B·Hkv] zero.
int attn_decode(int dtype, const void* q, const void* k, const void* v, const float* k_scale,
                const float* v_scale, const int* lengths, float* part_acc, float* part_ml,
                int* tickets, void* out, int batch, int hq, int hkv, int t_cap, int d_head,
                int n_grid, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > kGroupMax || n_grid < 1 ||
      n_grid > kDcMaxSplits)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float scale = softmax_scale(d_head);
  const bool quant = k_scale != nullptr;
  if (dtype == kDtypeBF16) {
    if (quant)
      return dispatch_decode<__nv_bfloat16, int8_t, true>(
          d_head, q, k, v, k_scale, v_scale, lengths, part_acc, part_ml, tickets, out, batch,
          hq, hkv, t_cap, n_grid, scale, s);
    return dispatch_decode<__nv_bfloat16, __nv_bfloat16, false>(
        d_head, q, k, v, nullptr, nullptr, lengths, part_acc, part_ml, tickets, out, batch, hq,
        hkv, t_cap, n_grid, scale, s);
  }
  if (dtype == kDtypeF32) {
    if (quant)
      return dispatch_decode<float, int8_t, true>(d_head, q, k, v, k_scale, v_scale, lengths,
                                                  part_acc, part_ml, tickets, out, batch, hq,
                                                  hkv, t_cap, n_grid, scale, s);
    return dispatch_decode<float, float, false>(d_head, q, k, v, nullptr, nullptr, lengths,
                                                part_acc, part_ml, tickets, out, batch, hq, hkv,
                                                t_cap, n_grid, scale, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"

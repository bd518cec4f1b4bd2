// The shared refine's product: every particle's field against every shift of
// every endpoint splat,
//   raw[m, n] = (sum_k A[m, k] * B[n, k]) / *denom
// for bf16 A [M, K] (the fields, kernel 6's output) and B [N, K] (the shift
// stack, kernel 7's), float32 raw [M, N], zeros where the gate is 0.
//
// Replaces no Pallas kernel: the JAX package leaves this product to XLA
// (slam2d_tpu/pf/shared_refine.py:shared_scores, a dot of the bf16 operands
// with preferred_element_type float32). A bf16 x bf16 product is exact in
// float32, so only the order of the float32 sums is left open, and a
// particle filter turns a last bit into another draw: the kernel keeps the
// order of the float32 library product it replaces (both operands widened,
// cuBLAS's SIMT GEMM with TF32 off), whose bits the benchmark's reference
// reproduces. That product deals K's tiles of TILE_K columns round robin to
// S slices (tile t to slice t % S), sums each slice's products one column
// after another, tile after tile, into a float32 that starts at 0, and adds
// the S partial sums in slice order. S, the caller's, follows the
// library's choice of output tiles (ops/refine_product.py:_slices; probed
// on the H100: 22 slices at FastSLAM-100's shapes, 44 at 250 rows, 11 at
// 1000, and that order reproduced its bits on every output). The kernel
// sums in that order and gets the same bits.
//
// What bounds it: B's bytes. The stack is ~0.5% nonzero (each shift of a
// splat of ~180 beams), so the kernel skips zero columns: adding a zero
// product to a sum that starts at +0 changes no bit (the sum is never -0).
// A non-finite field value at a zero of the stack is the one input where
// the library's sum (NaN) and the kernel's differ; the fields are finite.
//
// Three launches:
// 1. mask: for each band of BN rows of B and each tile, the 8-bit mask of
//    the tile's columns where a row of the band is nonzero. A block reads
//    512 columns (1 KB) of each of the band's rows: the one pass over all
//    of B's bytes.
// 2. product: a block a (band, BM rows of A, slice). The slice's tiles whose
//    mask is nonzero, in column order, each A tile (BM x 8) and B tile
//    (BN x 8) copied to shared memory (cp.async, STAGES - 1 tiles in
//    flight); then for each nonzero column in order every output adds
//    A[m, c] * B[n, c] to its float32 sum (a warp whose BN / 8 rows are all
//    zero there skips the column). The partial sums to ws [S, M, N].
// 3. reduce: each output's S partials added in slice order, divided by
//    *denom with IEEE division (__fdiv_rn, as `raw / denom`).
//
// A gate (the particle filter's device-gated refine): when the device byte
// *gate is 0 the first two launches return at once and the third writes
// zeros; a null gate is always on. Where K is not a multiple of 8 or an
// operand's base is not 16-byte aligned, the copies go value by value.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int TILE_K = 8;             // columns a tile: 16 bytes of a row
constexpr int BN = 64;                // rows of B a band
constexpr int BM = 64;                // rows of A a block
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RN = BN / WARPS;        // a warp's rows of B: 8 warp .. + 7
constexpr int RM = BM / 32;           // a lane's rows of A: lane + 32 q
constexpr int STAGE = (BM + BN) * TILE_K;  // bf16 values a stage
constexpr int STAGES = 16;            // tiles in flight + 1
constexpr int SMEM = STAGES * STAGE * 2;
static_assert(BM * (BN + 1) * 4 <= SMEM, "the sums fit the stages");
constexpr int REDUCE_THREADS = 256;

__device__ __forceinline__ float bf16_value(uint16_t h) {
  return __uint_as_float((uint32_t)h << 16);
}

// value c of the eight in a 16-byte tile row
__device__ __forceinline__ uint16_t bf16_at(const uint4& v, int c) {
  const uint32_t w = c < 2 ? v.x : c < 4 ? v.y : c < 6 ? v.z : v.w;
  return (uint16_t)(c & 1 ? w >> 16 : w & 0xffffu);
}

// bit j: value j of the eight is nonzero (-0 counts as zero)
__device__ __forceinline__ uint32_t nonzero8(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t m = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    m |= (uint32_t)((w[q] & 0x7fffu) != 0) << (2 * q) |
         (uint32_t)((w[q] & 0x7fff0000u) != 0) << (2 * q + 1);
  return m;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// ---- 1. the masks ----------------------------------------------------------

// Block (band, g): tiles 64 g .. 64 g + 63 of the band's rows; warp w
// reads the band's rows 8 w .. 8 w + 7, lane l their tiles 64 g + l and
// 64 g + 32 + l (all sixteen loads in flight at once); the warps' masks
// are ORed in shared memory and written, masks[band, tile]
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
refine_product_mask_kernel(const uint16_t* __restrict__ B,
                           uint8_t* __restrict__ masks, int N, int K,
                           int tiles, const unsigned char* __restrict__ gate) {
  if (gate != nullptr && *gate == 0) return;  // uniform: the whole grid
  __shared__ uint32_t part[WARPS][64];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int groups = (tiles + 63) / 64;
  const int band = blockIdx.x / groups, g = blockIdx.x % groups;
  const int r0 = band * BN + warp * RN, r1 = min(r0 + RN, N);
  const int t0 = 64 * g + lane, t1 = t0 + 32;
  uint32_t bits[2] = {0u, 0u};
  if (VEC) {  // K % 8 == 0: every tile lies inside the row
    const bool in0 = t0 < tiles, in1 = t1 < tiles;
    const uint16_t* p = B + (size_t)r0 * K + TILE_K * t0;
    uint4 v[2][RN];
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      const bool row = r0 + r < r1;
      v[0][r] = row && in0
                    ? __ldg(reinterpret_cast<const uint4*>(p + (size_t)r * K))
                    : make_uint4(0u, 0u, 0u, 0u);
      v[1][r] = row && in1 ? __ldg(reinterpret_cast<const uint4*>(
                                 p + (size_t)r * K + 32 * TILE_K))
                           : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      bits[0] |= nonzero8(v[0][r]);
      bits[1] |= nonzero8(v[1][r]);
    }
  } else {
    for (int r = r0; r < r1; ++r)
      for (int h = 0; h < 2; ++h) {
        const int k = TILE_K * (h ? t1 : t0);
        for (int j = 0; j < TILE_K && k + j < K; ++j)
          bits[h] |= (uint32_t)((B[(size_t)r * K + k + j] & 0x7fffu) != 0)
                     << j;
      }
  }
  part[warp][lane] = bits[0];
  part[warp][lane + 32] = bits[1];
  __syncthreads();
  if (threadIdx.x < 64) {
    uint32_t m = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m |= part[w][threadIdx.x];
    const int t = 64 * g + threadIdx.x;
    if (t < tiles) masks[(size_t)band * tiles + t] = (uint8_t)m;
  }
}

// ---- 2. the slices' partial sums --------------------------------------------

// Tile t of A's rows m0 .. m0 + BM - 1 and B's rows n0 .. n0 + BN - 1 into
// a stage; nothing past M, N or K (those values are never read)
template <bool VEC>
__device__ __forceinline__ void load_tile(uint16_t* stage,
                                          const uint16_t* __restrict__ A,
                                          const uint16_t* __restrict__ B,
                                          int M, int N, int K, int m0, int n0,
                                          int t) {
  const int k0 = t * TILE_K;
  const int r = threadIdx.x;  // rows of A, then rows of B
  if (VEC) {  // K % 8 == 0 and 16-byte bases: one copy a row
    if (r < BM) {
      if (m0 + r < M)
        cp_async16(smem_addr(stage + r * TILE_K),
                   A + (size_t)(m0 + r) * K + k0);
    } else if (r < BM + BN) {
      if (n0 + r - BM < N)
        cp_async16(smem_addr(stage + r * TILE_K),
                   B + (size_t)(n0 + r - BM) * K + k0);
    }
  } else if (r < BM + BN) {
    const bool in = r < BM ? m0 + r < M : n0 + r - BM < N;
    if (in) {
      const uint16_t* src = r < BM ? A + (size_t)(m0 + r) * K
                                   : B + (size_t)(n0 + r - BM) * K;
      for (int c = 0; c < TILE_K && k0 + c < K; ++c)
        stage[r * TILE_K + c] = src[k0 + c];
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
refine_product_kernel(const uint16_t* __restrict__ A,
                      const uint16_t* __restrict__ B,
                      const uint8_t* __restrict__ masks,
                      float* __restrict__ ws, int M, int N, int K, int S,
                      int tiles, const unsigned char* __restrict__ gate) {
  static_assert(BM + BN <= THREADS, "one thread a tile row");
  if (gate != nullptr && *gate == 0) return;  // uniform: the whole grid
  extern __shared__ __align__(16) uint16_t stages[];
  __shared__ int list_tile[THREADS];
  __shared__ uint8_t list_mask[THREADS];
  __shared__ int warp_count[WARPS];
  const int band = blockIdx.x, m0 = blockIdx.y * BM, n0 = band * BN;
  const int slice = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const uint8_t* band_masks = masks + (size_t)band * tiles;

  // rows of B past N read as zeros, so that their warps skip every column
  for (int id = threadIdx.x; id < STAGES * BN * TILE_K; id += THREADS) {
    const int st = id / (BN * TILE_K), r = id % (BN * TILE_K) / TILE_K;
    if (n0 + r >= N) stages[st * STAGE + BM * TILE_K + id % (BN * TILE_K)] = 0;
  }

  float acc[RM][RN];
#pragma unroll
  for (int q = 0; q < RM; ++q)
#pragma unroll
    for (int r = 0; r < RN; ++r) acc[q][r] = 0.0f;

  // the slice's tiles: slice, slice + S, ...
  const int count = (tiles - slice + S - 1) / S;
  for (int first = 0; first < count; first += THREADS) {
    // the batch's tiles with a nonzero column, in order
    const int j = first + threadIdx.x;
    const int t = slice + j * S;
    const uint32_t m = j < count ? band_masks[t] : 0u;
    const unsigned ballot = __ballot_sync(0xffffffffu, m != 0);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      before += w < warp ? warp_count[w] : 0;
      total += warp_count[w];
    }
    if (m != 0) {
      const int pos = before + __popc(ballot & ((1u << lane) - 1u));
      list_tile[pos] = t;
      list_mask[pos] = (uint8_t)m;
    }
    __syncthreads();

    // STAGES - 1 tiles in flight; a group committed every iteration, empty
    // or not, so that the wait counts hold at the tail
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < total)
        load_tile<VEC>(stages + i * STAGE, A, B, M, N, K, m0, n0,
                       list_tile[i]);
      cp_async_commit();
    }
    for (int i = 0; i < total; ++i) {
      cp_async_wait<STAGES - 2>();  // tile i's copies have landed
      __syncthreads();              // and every warp is done with tile i - 1
      const int next = i + STAGES - 1;
      if (next < total)
        load_tile<VEC>(stages + (next % STAGES) * STAGE, A, B, M, N, K, m0,
                       n0, list_tile[next]);
      cp_async_commit();
      const uint16_t* st = stages + (i % STAGES) * STAGE;
      const uint32_t cols = list_mask[i];
      uint4 a[RM], b[RN];
#pragma unroll
      for (int q = 0; q < RM; ++q)
        a[q] = *reinterpret_cast<const uint4*>(st + (lane + 32 * q) * TILE_K);
#pragma unroll
      for (int r = 0; r < RN; ++r)  // one address a warp
        b[r] = *reinterpret_cast<const uint4*>(
            st + (BM + warp * RN + r) * TILE_K);
#pragma unroll
      for (int c = 0; c < TILE_K; ++c) {
        if (!(cols >> c & 1u)) continue;  // block-uniform
        float bv[RN];
        uint32_t any = 0;
#pragma unroll
        for (int r = 0; r < RN; ++r) {
          const uint16_t h = bf16_at(b[r], c);
          any |= h & 0x7fffu;
          bv[r] = bf16_value(h);
        }
        if (any == 0) continue;  // warp-uniform
#pragma unroll
        for (int q = 0; q < RM; ++q) {
          const float av = bf16_value(bf16_at(a[q], c));
#pragma unroll
          for (int r = 0; r < RN; ++r)
            acc[q][r] = __fmaf_rn(av, bv[r], acc[q][r]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the stages and the list are free for the next batch
  }

  // the partial sums to ws[slice] by rows, through shared memory (the
  // stages are free: every batch ends in a wait and a barrier)
  float* sums = reinterpret_cast<float*>(stages);  // [BM][BN + 1]
#pragma unroll
  for (int q = 0; q < RM; ++q)
#pragma unroll
    for (int r = 0; r < RN; ++r)
      sums[(lane + 32 * q) * (BN + 1) + warp * RN + r] = acc[q][r];
  __syncthreads();
  float* part = ws + (size_t)slice * M * N;
  for (int id = threadIdx.x; id < BM * BN; id += THREADS) {
    const int row = id / BN, col = id % BN;
    if (m0 + row < M && n0 + col < N)
      part[(size_t)(m0 + row) * N + n0 + col] = sums[row * (BN + 1) + col];
  }
}

// ---- 3. the slices' sum ------------------------------------------------------

// raw[i] = (ws[0, i] + ws[1, i] + ... + ws[S-1, i]) / *denom, in that order;
// zeros on a gate of 0
__global__ void __launch_bounds__(REDUCE_THREADS)
refine_product_reduce_kernel(const float* __restrict__ ws,
                             float* __restrict__ out, long long MN, int S,
                             const float* __restrict__ denom,
                             const unsigned char* __restrict__ gate) {
  const long long i = (long long)blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (i >= MN) return;
  if (gate != nullptr && *gate == 0) {
    out[i] = 0.0f;
    return;
  }
  // the loads of a batch in flight together, the adds in slice order
  constexpr int BATCH = 8;
  float acc = ws[i];
  int s = 1;
  for (; s + BATCH <= S; s += BATCH) {
    float v[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) v[j] = ws[(long long)(s + j) * MN + i];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) acc = F_ADD(acc, v[j]);
  }
  for (; s < S; ++s) acc = F_ADD(acc, ws[(long long)s * MN + i]);
  out[i] = F_DIV(acc, *denom);
}

}  // namespace

// A [M, K] and B [N, K] bf16, out [M, N] float32, denom one float32, ws
// [S, M, N] float32 and masks [ceil(N / BN), ceil(K / TILE_K)] bytes of
// workspace, all on the current device
extern "C" int slam2d_refine_product(const void* A, const void* B, void* ws,
                                     void* masks, void* out,
                                     const void* denom, int M, int N, int K,
                                     int S, const unsigned char* gate,
                                     void* stream) {
  const int tiles = (K + TILE_K - 1) / TILE_K;
  if (M < 1 || N < 1 || K < 1 || S < 1 || S > tiles ||
      (M + BM - 1) / BM > 65535 || S > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int bands = (N + BN - 1) / BN;
  const bool vec = K % 8 == 0 && (uintptr_t)A % 16 == 0 &&
                   (uintptr_t)B % 16 == 0;

  // the product's shared memory, allowed once a device
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(refine_product_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(refine_product_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = true;
  }

  const unsigned mask_blocks = (unsigned)bands * ((tiles + 63) / 64);
  const dim3 grid(bands, (M + BM - 1) / BM, S);
  if (vec) {
    refine_product_mask_kernel<true><<<mask_blocks, THREADS, 0, s>>>(
        (const uint16_t*)B, (uint8_t*)masks, N, K, tiles, gate);
    refine_product_kernel<true><<<grid, THREADS, SMEM, s>>>(
        (const uint16_t*)A, (const uint16_t*)B, (const uint8_t*)masks,
        (float*)ws, M, N, K, S, tiles, gate);
  } else {
    refine_product_mask_kernel<false><<<mask_blocks, THREADS, 0, s>>>(
        (const uint16_t*)B, (uint8_t*)masks, N, K, tiles, gate);
    refine_product_kernel<false><<<grid, THREADS, SMEM, s>>>(
        (const uint16_t*)A, (const uint16_t*)B, (const uint8_t*)masks,
        (float*)ws, M, N, K, S, tiles, gate);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long MN = (long long)M * N;
  refine_product_reduce_kernel<<<(unsigned)((MN + REDUCE_THREADS - 1) /
                                            REDUCE_THREADS),
                                 REDUCE_THREADS, 0, s>>>(
      (const float*)ws, (float*)out, MN, S, (const float*)denom, gate);
  return (int)cudaGetLastError();
}

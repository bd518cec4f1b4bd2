// Per-particle window of the map and its likelihood field, in one pass.
//
// Replaces slam2d_tpu/ops/pallas_field.py:_field_kernel (fused_window_field,
// called by pf/shared_refine.py). For each particle p and its UNCLAMPED
// window origin (a, b), over the win x win window:
//   g     = maps[p, a + r, b + c], or 0 (unknown) off the map
//   occ   = clip(g * inv_sat, 0, 1)
//   blur  = clip(blur_cols(blur_rows(occ)), 0, 1)      zero padding
//   S     = blur - free_penalty * [g < free_logit] * (1 - blur)
// written in the scorer's dtype (float32 or bf16, rounded to nearest even).
// free_logit = logit(free_threshold): the TPU kernel tests the log-odds
// against it instead of the sigmoid against the threshold, and so does this.
// The sums run from tap 0 upward, rows (axis 0) first, every product and sum
// rounded (no FMA), as the JAX package's blur does, so the field rounds as
// the plain version does.
//
// What bounds it on the H100: instruction issue, not memory. At
// FastSLAM-1000's shapes (1000 windows of 288^2 from bf16 512^2 maps, bf16
// out) it must move 0.33 GB (~0.1 ms at 3.35 TB/s), but a cell costs 34
// float32 operations that may not fuse into FMAs plus its loads, clips and
// casts, ~55 instructions in all, and the integer and compare instructions
// among them issue at half rate. Dropping the stores or the loads changes
// its time by 1% (PERF.md), so the design's aim is to spend no instruction
// on anything but the blur:
// - a persistent grid; a block walks over (particle, band, column tile)
//   items of TH x TW outputs, wide tiles whose blur halo costs 1.3x the
//   reads (from L2 mostly) instead of the 1.56x of a 32 x 32 tile;
// - TMA cuts the window: the maps are one 3-D tensor map [P, Hm, Wm], and a
//   box at the signed coordinates (b + tc - hw, a + tr - hw, p) lands in
//   shared memory with the cells off the map filled with zero, which is the
//   kernel's "off-map cells read 0", with no address arithmetic or bounds
//   test in any thread. A box must start at a multiple of 16 bytes along
//   the row (any other column is an illegal instruction), so the box is
//   ALIGN cells wider than the tile, starts at the aligned column below
//   it, and the threads read the tile `shift` cells in. A producer thread
//   in a warp of its own runs ahead through the block's items and keeps a
//   ring of STAGES tiles full (a "full" and an "empty" mbarrier a slot), so
//   no computing warp ever waits on the origins or issues a copy. A map
//   whose base or row pitch is not 16-byte aligned cannot have a tensor
//   map: there the block's threads load the tile themselves, row by row
//   ("coop");
// - both blurs in registers (blur_run): a thread computes a run of
//   neighbouring outputs along the blurred axis (ROW_RUN rows, RUN columns)
//   from one sliding window of values, the tap count a template argument
//   and the loops unrolled, so a value is loaded once per run and, the
//   taps being symmetric, multiplied by 5 taps instead of 9: the product
//   k[q] * x serves two outputs. The sums keep their order;
// - the rows pass reads the raw tile, turns it into evidence on the fly
//   (mul.sat; cells outside the window masked, in the bands at its edge
//   only) and writes the row-blurred tile with the free test [g <
//   free_logit] in each value's sign bit: the values are sums of
//   non-negative products, the columns pass reads |x| at no cost and takes
//   the centre value's sign for the penalty;
// - the columns pass reads 16-byte vectors of that tile and writes 16-byte
//   vectors of the field ("packed"; "scalar" where the field's rows are not
//   16-byte aligned, and at ragged edges);
// - one barrier of the computing threads per tile: the row-blurred tile is
//   double-buffered.
// Anything but FAST_TAPS symmetric non-negative taps takes the "generic"
// variant: one block per 32 x 32 tile, runtime tap loops.
// A gate (the particle filter's device-gated refine): when the device byte
// *gate is 0 every block of either variant returns at once, before its
// barriers, and `out` is not written; a null gate is always on.

#include <cuda.h>   // CUtensorMap and its enums; the encoder is fetched at run time

#include <algorithm>
#include <mutex>

#include "common.cuh"

namespace {

constexpr int FAST_TAPS = 9;   // the configs' blur: halo of 4 cells
constexpr int TH = 32;         // output rows of a tile
constexpr int TW = 144;        // output columns of a tile
constexpr int RUN = 8;         // neighbouring outputs of a thread, columns pass
constexpr int ROW_RUN = 16;    // and rows pass: a cell's evidence is computed
                               // (ROW_RUN + taps - 1) / ROW_RUN times
constexpr int THREADS = 320;
constexpr int STAGES = 3;
constexpr int ALIGN = 8;       // cells a box's first column is a multiple of

template <int NT>
struct Geometry {
  static constexpr int HW = NT / 2;
  static constexpr int ROWS_IN = TH + 2 * HW;   // rows of the input tile
  // columns of the input tile and of the row-blurred tile: 16 bytes of bf16
  static constexpr int PITCH = (TW + 2 * HW + 7) / 8 * 8;
  static constexpr int TILE_PITCH = PITCH + ALIGN;   // columns of a box
  static constexpr int ROW_TASKS = PITCH * (TH / ROW_RUN);
  static constexpr int COL_TASKS = TH * (TW / RUN);
  static_assert(TW % RUN == 0 && TH % ROW_RUN == 0 && ROW_RUN % RUN == 0 &&
                    RUN == 8,
                "tile shape");
  static_assert((RUN + NT - 1) % 4 == 0, "the columns pass loads float4s");
};

template <typename TIn, int NT>
__host__ __device__ constexpr size_t tile_bytes() {
  return (sizeof(TIn) * Geometry<NT>::ROWS_IN * Geometry<NT>::TILE_PITCH + 127) /
         128 * 128;
}

template <typename TIn, int NT>
__host__ __device__ constexpr size_t smem_bytes() {
  return STAGES * tile_bytes<TIn, NT>() +
         2 * sizeof(float) * TH * Geometry<NT>::PITCH;
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// RUN outputs as 16-byte stores
__device__ __forceinline__ void store_run(__nv_bfloat16* dst, const float* S) {
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(pack_bf16(S[0], S[1]), pack_bf16(S[2], S[3]),
                 pack_bf16(S[4], S[5]), pack_bf16(S[6], S[7]));
}

__device__ __forceinline__ void store_run(float* dst, const float* S) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(S[0], S[1], S[2], S[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(S[4], S[5], S[6], S[7]);
}

// N neighbouring outputs of a 1-D blur with NT symmetric taps over
// |x[0 .. N + NT - 1)|: out[m] = sum_q k[q] * |x[m + q]|, the products summed
// from q = 0 up, each product and sum rounded. With k[q] == k[NT - 1 - q]
// the product k[q] * x[j] serves the outputs j - q and j - (NT - 1 - q), so
// an input costs NT / 2 + 1 multiplications, not NT.
template <int NT, int N>
__device__ __forceinline__ void blur_run(const float* x, const Taps& taps,
                                         float* out) {
#pragma unroll
  for (int j = 0; j < N + NT - 1; ++j) {
    float pr[NT / 2 + 1];
#pragma unroll
    for (int q = 0; q <= NT / 2; ++q) pr[q] = F_MUL(taps.k[q], fabsf(x[j]));
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const int m = j - q;
      if (m >= 0 && m < N) {
        const float term = pr[q <= NT / 2 ? q : NT - 1 - q];
        out[m] = q == 0 ? term : F_ADD(out[m], term);
      }
    }
  }
}

// The rows pass of one tile: tile [ROWS_IN, TILE_PITCH] raw log-odds, the
// tile's first column at `tile` (the box's shift added by the caller) -> rbuf
// [TH, PITCH] row-blurred evidence, the sign bit set where the cell is known
// free. A thread blurs ROW_RUN rows of one column. MASK: some tile rows lie
// outside the window and count as zero evidence.
template <typename TIn, int NT, bool MASK>
__device__ __forceinline__ void rows_pass(const TIn* tile, float* rbuf, int tr,
                                          int tc, int win, const Taps& taps,
                                          float inv_sat, float free_logit) {
  using G = Geometry<NT>;
  for (int t = threadIdx.x; t < G::ROW_TASKS; t += THREADS) {
    const int j = t % G::PITCH;
    const int r0 = (t / G::PITCH) * ROW_RUN;
    const int wc = tc - G::HW + j;
    float v[ROW_RUN];
    if (wc >= 0 && wc < win) {
      float e[ROW_RUN + NT - 1];
      unsigned is_free[ROW_RUN];   // the sign bit: the cell is known free
#pragma unroll
      for (int i = 0; i < ROW_RUN + NT - 1; ++i) {
        const float g = load_f32(tile + (r0 + i) * G::TILE_PITCH + j);
        // clip(g * inv_sat, 0, 1) in one instruction (mul.sat)
        float ev = __saturatef(F_MUL(g, inv_sat));
        if (MASK) {
          const int wr = tr - G::HW + r0 + i;
          if (wr < 0 || wr >= win) ev = 0.0f;
        }
        e[i] = ev;
        // g < free_logit, as the sign of the rounded difference (the
        // launch makes a zero free_logit -0, so that -0 - 0 cannot say so)
        if (i >= G::HW && i < G::HW + ROW_RUN)
          is_free[i - G::HW] = __float_as_uint(F_SUB(g, free_logit));
      }
      blur_run<NT, ROW_RUN>(e, taps, v);
#pragma unroll
      for (int m = 0; m < ROW_RUN; ++m)
        v[m] = __uint_as_float(__float_as_uint(v[m]) | (is_free[m] & 0x80000000u));
    } else {
#pragma unroll
      for (int m = 0; m < ROW_RUN; ++m) v[m] = 0.0f;
    }
#pragma unroll
    for (int m = 0; m < ROW_RUN; ++m) rbuf[(r0 + m) * G::PITCH + j] = v[m];
  }
}

// One warp more than the THREADS that compute: with TMA its first lane is
// the producer, which runs ahead of the others through the block's items
// and keeps the ring of tiles full.
constexpr int BLOCK = THREADS + 32;

// __syncthreads() of the THREADS computing threads alone
__device__ __forceinline__ void sync_computing() {
  asm volatile("bar.sync 1, %0;" ::"n"(THREADS) : "memory");
}

template <typename TIn, typename TOut, int NT>
__global__ void __launch_bounds__(BLOCK)
window_field_kernel(const __grid_constant__ CUtensorMap tmap,
                    const TIn* __restrict__ maps,
                    const int* __restrict__ origins, TOut* __restrict__ out,
                    const unsigned char* __restrict__ gate,
                    int P, int Hm, int Wm, int win, int n_bands, int n_ctiles,
                    Taps taps, float inv_sat, float free_logit,
                    float free_penalty, int use_tma, int packed) {
  if (gate != nullptr && *gate == 0) return;  // uniform: the whole grid
  using G = Geometry<NT>;
  extern __shared__ __align__(128) unsigned char smem[];
  // full[s]: the tile in ring slot s has landed; empty[s]: every computing
  // thread has read it for the last time
  __shared__ __align__(8) unsigned long long full[STAGES], empty[STAGES];
  __shared__ int shift[STAGES];   // cells from a box's first column to its tile's
  constexpr size_t TILE_BYTES = tile_bytes<TIn, NT>();
  float* rows = reinterpret_cast<float*>(smem + STAGES * TILE_BYTES);
  const int tid = threadIdx.x;
  const int per_particle = n_bands * n_ctiles;
  const long long n_items = (long long)P * per_particle;
  const long long step = gridDim.x;

  if (use_tma && tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), THREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= THREADS) {
    // the producer: the k-th item's box into ring slot k % STAGES, once the
    // slot's last tile has been read
    if (!use_tma || tid != THREADS) return;
    int k = 0;
    for (long long item = blockIdx.x; item < n_items; item += step, ++k) {
      const int stage = k % STAGES;
      const int p = (int)(item / per_particle);
      const int rem = (int)(item % per_particle);
      const long long row = (long long)origins[2 * p] + (rem / n_ctiles) * TH - G::HW;
      const long long col = (long long)origins[2 * p + 1] + (rem % n_ctiles) * TW - G::HW;
      const long long box_col = col & ~(long long)(ALIGN - 1);   // floor
      if (k >= STAGES) mbar_wait(smem_addr(&empty[stage]), (k / STAGES - 1) & 1);
      shift[stage] = (int)(col - box_col);
      const uint32_t bar = smem_addr(&full[stage]);
      mbar_expect_tx(bar, (uint32_t)(sizeof(TIn) * G::ROWS_IN * G::TILE_PITCH));
      // a box wholly off the map is all zeros wherever it lies: clamp the
      // coordinates (to multiples of ALIGN) so that a far origin cannot
      // overflow them
      const long long past = (Wm + ALIGN - 1) / ALIGN * ALIGN;
      tma_load_3d(smem_addr(smem + stage * TILE_BYTES), &tmap, bar,
                  (int)min(max(box_col, (long long)-G::TILE_PITCH), past),
                  (int)min(max(row, (long long)-G::ROWS_IN), (long long)Hm), p);
    }
    return;
  }

  int k = 0;
  for (long long item = blockIdx.x; item < n_items; item += step, ++k) {
    const int p = (int)(item / per_particle);
    const int rem = (int)(item % per_particle);
    const int tr = (rem / n_ctiles) * TH;
    const int tc = (rem % n_ctiles) * TW;
    const int stage = k % STAGES;
    TIn* tile = reinterpret_cast<TIn*>(smem + stage * TILE_BYTES);
    int tile_shift = 0;

    if (use_tma) {
      mbar_wait(smem_addr(&full[stage]), (k / STAGES) & 1);
      tile_shift = shift[stage];   // written before the barrier was armed
    } else {
      const long long a = origins[2 * p];
      const long long b = origins[2 * p + 1];
      const TIn* map = maps + (size_t)p * Hm * Wm;
      for (int i = tid / 32; i < G::ROWS_IN; i += THREADS / 32) {
        const long long mr = a + tr - G::HW + i;
        const bool row_ok = mr >= 0 && mr < Hm;
        for (int j = tid % 32; j < G::PITCH; j += 32) {
          const long long mc = b + tc - G::HW + j;
          TIn g = TIn();
          if (row_ok && mc >= 0 && mc < Wm) g = map[mr * Wm + mc];
          tile[i * G::TILE_PITCH + j] = g;
        }
      }
      sync_computing();
    }

    // the row-blurred tile is double-buffered: a thread that writes buffer
    // k & 1 has passed the barrier of item k - 1, so every thread has left
    // the columns pass of item k - 2, the buffer's last reader
    float* rbuf = rows + (k & 1) * TH * G::PITCH;
    if (tr < G::HW || tr + TH + G::HW > win)
      rows_pass<TIn, NT, true>(tile + tile_shift, rbuf, tr, tc, win, taps,
                               inv_sat, free_logit);
    else
      rows_pass<TIn, NT, false>(tile + tile_shift, rbuf, tr, tc, win, taps,
                                inv_sat, free_logit);
    if (use_tma)
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                       smem_addr(&empty[stage]))
                   : "memory");
    sync_computing();

    // the columns pass: RUN outputs of one row from RUN + NT - 1 values
    for (int t = tid; t < G::COL_TASKS; t += THREADS) {
      const int c0 = (t % (TW / RUN)) * RUN;
      const int r = t / (TW / RUN);
      const int wr = tr + r;
      const int wc0 = tc + c0;
      if (wr >= win || wc0 >= win) continue;
      float x[RUN + NT - 1];
      const float4* src = reinterpret_cast<const float4*>(rbuf + r * G::PITCH + c0);
#pragma unroll
      for (int q = 0; q < (RUN + NT - 1) / 4; ++q) {
        const float4 f = src[q];
        x[4 * q] = f.x;
        x[4 * q + 1] = f.y;
        x[4 * q + 2] = f.z;
        x[4 * q + 3] = f.w;
      }
      float S[RUN];
      blur_run<NT, RUN>(x, taps, S);
#pragma unroll
      for (int m = 0; m < RUN; ++m) {
        // field_value() with free_penalty * [free] as a select
        const float blur = clampf(S[m], 0.0f, 1.0f);
        const float pen = (int)__float_as_uint(x[m + G::HW]) < 0 ? free_penalty : 0.0f;
        S[m] = F_SUB(blur, F_MUL(pen, F_SUB(1.0f, blur)));
      }
      TOut* dst = out + ((size_t)p * win + wr) * win + wc0;
      if (packed && wc0 + RUN <= win) {
        store_run(dst, S);
      } else {
#pragma unroll
        for (int m = 0; m < RUN; ++m)
          if (wc0 + m < win) store_f32(dst + m, S[m]);
      }
    }
  }
}

// ---- the tensor map of the maps -----------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, through the runtime, so that nothing links libcuda
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return (EncodeTiled)p;
  }();
  return fn;
}

struct MapKey {
  const void* maps;
  int P, Hm, Wm, bf16, box_cols, box_rows;
  bool operator==(const MapKey& o) const {
    return maps == o.maps && P == o.P && Hm == o.Hm && Wm == o.Wm &&
           bf16 == o.bf16 && box_cols == o.box_cols && box_rows == o.box_rows;
  }
};

// The [P, Hm, Wm] tensor map of `maps` with a [1, box_rows, box_cols] box,
// cells outside the tensor filled with zero. Encoded once per key and kept
// in a small ring, so a launch makes no call into libcuda.
int tensor_map(const MapKey& key, CUtensorMap* map) {
  constexpr int SLOTS = 16;
  static MapKey keys[SLOTS];
  static CUtensorMap maps[SLOTS];
  static int used = 0, next = 0;
  static std::mutex lock;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i)
    if (keys[i] == key) {
      *map = maps[i];
      return 0;
    }
  EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t es = key.bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {(cuuint64_t)key.Wm, (cuuint64_t)key.Hm,
                              (cuuint64_t)key.P};
  const cuuint64_t strides[2] = {key.Wm * es, (cuuint64_t)key.Hm * key.Wm * es};
  const cuuint32_t box[3] = {(cuuint32_t)key.box_cols, (cuuint32_t)key.box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = encode(
      map, key.bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(key.maps), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return 10000 + (int)res;   // libcuda's CUresult
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % SLOTS;
  used = std::min(used + 1, SLOTS);
  return 0;
}

// ---- the generic variant: any odd tap count ------------------------------

constexpr int GEN_TILE = 32;
constexpr int GEN_THREADS = 256;

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(GEN_THREADS)
window_field_generic_kernel(const TIn* __restrict__ maps,
                            const int* __restrict__ origins,
                            TOut* __restrict__ out,
                            const unsigned char* __restrict__ gate, int Hm,
                            int Wm, int win, Taps taps, float inv_sat,
                            float free_logit, float free_penalty) {
  if (gate != nullptr && *gate == 0) return;  // uniform: the whole grid
  extern __shared__ float gsmem[];
  const int hw = taps.n / 2;
  const int ext = GEN_TILE + 2 * hw;
  float* occ = gsmem;                          // [ext, ext] evidence + halo
  float* rows = occ + ext * ext;               // [GEN_TILE, ext] row-blurred
  float* gcen = rows + GEN_TILE * ext;         // [GEN_TILE, GEN_TILE] log-odds
  const int p = blockIdx.z;
  const int a = origins[2 * p];
  const int b = origins[2 * p + 1];
  const int tr = blockIdx.y * GEN_TILE;
  const int tc = blockIdx.x * GEN_TILE;
  const TIn* map = maps + (size_t)p * Hm * Wm;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < ext * ext; idx += GEN_THREADS) {
    const int i = idx / ext;
    const int j = idx % ext;
    const int wr = tr - hw + i;
    const int wc = tc - hw + j;
    float g = 0.0f;
    if (wr >= 0 && wr < win && wc >= 0 && wc < win) {
      const long long mr = (long long)a + wr;
      const long long mc = (long long)b + wc;
      if (mr >= 0 && mr < Hm && mc >= 0 && mc < Wm)
        g = load_f32(map + mr * Wm + mc);
    }
    occ[idx] = evidence(g, inv_sat);
    if (i >= hw && i < hw + GEN_TILE && j >= hw && j < hw + GEN_TILE)
      gcen[(i - hw) * GEN_TILE + (j - hw)] = g;
  }
  __syncthreads();

  for (int idx = tid; idx < GEN_TILE * ext; idx += GEN_THREADS) {
    const int r = idx / ext;
    const int j = idx % ext;
    rows[idx] = blur_dot(occ + r * ext + j, ext, taps);
  }
  __syncthreads();

  for (int idx = tid; idx < GEN_TILE * GEN_TILE; idx += GEN_THREADS) {
    const int r = idx / GEN_TILE;
    const int c = idx % GEN_TILE;
    if (tr + r >= win || tc + c >= win) continue;
    const float blur = blur_dot(rows + r * ext + c, 1, taps);
    const float S = field_value(blur, gcen[idx] < free_logit, free_penalty);
    store_f32(out + ((size_t)p * win + (tr + r)) * win + (tc + c), S);
  }
}

// ---- dispatch -------------------------------------------------------------

// The variants, from the operands alone: 0 tma+packed, 1 tma+scalar,
// 2 coop+packed, 3 coop+scalar, 4 generic
int variant_of(const void* maps, const void* out, int in_bytes, int out_bytes,
               int Wm, int win, const Taps& taps) {
  // the tiled kernel shares the products of symmetric taps and keeps the
  // free flag in the sign bit of a row-blurred value, which no tap may flip
  if (taps.n != FAST_TAPS) return 4;
  for (int q = 0; q < taps.n; ++q)
    if (!(taps.k[q] >= 0.0f) || taps.k[q] != taps.k[taps.n - 1 - q]) return 4;
  const bool tma = (uintptr_t)maps % 16 == 0 && ((long long)Wm * in_bytes) % 16 == 0;
  const bool packed = (uintptr_t)out % 16 == 0 && ((long long)win * out_bytes) % 16 == 0;
  return (tma ? 0 : 2) + (packed ? 0 : 1);
}

int last_variant = -1;

struct Args {
  const void* maps;
  const int* origins;
  void* out;
  const unsigned char* gate;
  int P, Hm, Wm, win;
  Taps taps;
  float inv_sat, free_logit, free_penalty;
  cudaStream_t stream;
};

template <typename TIn, typename TOut>
int launch_generic(const Args& a) {
  const int ext = GEN_TILE + 2 * (a.taps.n / 2);
  const size_t smem =
      sizeof(float) * ((size_t)ext * ext + GEN_TILE * ext + GEN_TILE * GEN_TILE);
  auto kernel = window_field_generic_kernel<TIn, TOut>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = (a.win + GEN_TILE - 1) / GEN_TILE;
  kernel<<<dim3(tiles, tiles, a.P), GEN_THREADS, smem, a.stream>>>(
      (const TIn*)a.maps, a.origins, (TOut*)a.out, a.gate, a.Hm, a.Wm, a.win,
      a.taps, a.inv_sat, a.free_logit, a.free_penalty);
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut>
int launch(const Args& a, int variant) {
  if (variant == 4) return launch_generic<TIn, TOut>(a);
  using G = Geometry<FAST_TAPS>;
  auto kernel = window_field_kernel<TIn, TOut, FAST_TAPS>;
  constexpr size_t smem = smem_bytes<TIn, FAST_TAPS>();
  // the most blocks of this kernel that the device holds at once
  static int resident[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK,
                                                        smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    resident[dev] = sms * per_sm;
  }
  const bool use_tma = variant < 2;
  CUtensorMap tmap{};
  if (use_tma) {
    const MapKey key{a.maps, a.P, a.Hm, a.Wm, sizeof(TIn) == 2, G::TILE_PITCH, G::ROWS_IN};
    const int res = tensor_map(key, &tmap);
    if (res != 0) return res;
  }
  // the rows pass takes [g < free_logit] from the sign of g - free_logit:
  // right for every g but -0 against +0, which -0 against -0 avoids
  const float free_logit = a.free_logit == 0.0f ? -0.0f : a.free_logit;
  const int n_bands = (a.win + TH - 1) / TH;
  const int n_ctiles = (a.win + TW - 1) / TW;
  const long long n_items = (long long)a.P * n_bands * n_ctiles;
  const int blocks = (int)std::min<long long>(resident[dev], n_items);
  kernel<<<blocks, BLOCK, smem, a.stream>>>(
      tmap, (const TIn*)a.maps, a.origins, (TOut*)a.out, a.gate, a.P, a.Hm,
      a.Wm, a.win,
      n_bands, n_ctiles, a.taps, a.inv_sat, free_logit, a.free_penalty,
      (int)use_tma, (int)(variant % 2 == 0));
  return (int)cudaGetLastError();
}

}  // namespace

// The variant that the last launch of slam2d_window_field ran (-1: none yet)
extern "C" int slam2d_window_field_last_variant() { return last_variant; }

extern "C" int slam2d_window_field(const void* maps, int in_bf16,
                                   const int* origins, void* out, int out_bf16,
                                   int P, int Hm, int Wm, int win,
                                   const float* taps_host, int n_taps,
                                   float inv_sat, float free_logit,
                                   float free_penalty,
                                   const unsigned char* gate, void* stream) {
  Args a{maps, origins, out, gate, P, Hm, Wm, win, {}, inv_sat, free_logit,
         free_penalty, (cudaStream_t)stream};
  if (!load_taps(&a.taps, taps_host, n_taps) || P < 1 || P > 65535 || win < 1 ||
      Hm < 1 || Wm < 1)
    return (int)cudaErrorInvalidValue;
  const int variant = variant_of(maps, out, in_bf16 ? 2 : 4, out_bf16 ? 2 : 4,
                                 Wm, win, a.taps);
  last_variant = variant;
  if (in_bf16 && out_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(a, variant);
  if (in_bf16) return launch<__nv_bfloat16, float>(a, variant);
  if (out_bf16) return launch<float, __nv_bfloat16>(a, variant);
  return launch<float, float>(a, variant);
}

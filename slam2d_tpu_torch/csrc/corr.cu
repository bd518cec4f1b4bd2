// Lag correlation of endpoint-splat images with a padded search space, for
// every particle and theta in one launch:
//   out[p, t, dr*C + dc] = sum_{h,w} f32(E[p, t, h, w]) * Sp[p, h+dr, w+dc]
// E is bf16 or float32 [P, T, H, W], Sp float32 [P, H+R, W+C] (the search
// space zero-padded on its high sides), out float32 [P, T, R*C].
//
// Replaces slam2d_tpu/ops/pallas_corr.py:_corr_kernel (corr_scores_pallas,
// called by ops/mxu_score.py:score_offsets_cmx), which the JAX package
// vmaps over the particles of its per-particle refine; the particle axis is
// written out here as a grid axis. The TPU kernel sums each lag as one
// jnp.sum over [H, W]; this kernel sums in another fixed order, so the two
// agree to float32 summation-order rounding (a few ulp of the sum of |terms|).
//
// What bounds it on the H100: E is read once (at FastSLAM-16's refine,
// 16 x 9 x 288^2 bf16, 24 MB, ~7 us at 3.35 TB/s) and Sp stays in L1/L2;
// the multiply-adds (R*C per nonzero E cell) are few next to that, since a
// splat image holds at most four cells per beam (under 1% of its cells).
// So the kernel has to stream E at the memory's rate and handle the few
// nonzero cells on the side. Design:
// - A cluster of BLOCKS blocks takes one (p, t) image, each block a
//   contiguous run of its 16-byte units (8 bf16 or 4 float32 cells). A warp
//   takes 32 units a step, a unit a lane, and each lane keeps the loads of
//   its next DEPTH steps in flight.
// - A warp asks whether any lane's unit holds a nonzero cell; a step of
//   all-zero units costs nothing more. Else each lane appends its unit's
//   nonzero cells (value, Sp offset) to the warp's list in shared memory at
//   its place in a prefix count (ballots of the counts' bits), so the list
//   holds the warp's nonzero cells in (step, unit, column) order.
// - Once the list holds BATCH cells (or at the warp's last step), the warp
//   takes them together: lane k adds e * Sp[h+dr, w+dc] for lags k, k+32,
//   ..., so a lane holds ceil(R*C/32) accumulators, and the Sp loads of
//   BATCH cells are in flight before their adds.
// - A lane's accumulators are its warp's sums; the block adds its warps'
//   in warp order, and the cluster's rank 0 adds the blocks' in rank order,
//   reading their shared memory. One launch, no atomics: the same inputs
//   give the same bits on every call.
// - An image whose units are not all 16-byte aligned (a misaligned base, or
//   H*W cells that are not a whole number of units) takes the scalar form:
//   the same loop with one cell a unit.
// A zero E adds exactly zero, so skipping it changes nothing. On the card
// (scripts/tune_kernel.sh corr) the stream alone, E all zero, takes about
// half the time; the nonzero cells the rest. Lists shared by the block's
// warps (barriers every step or after the stream), a cell a lane with
// R*C accumulators, 1, 4 or 8 blocks an image, and 512 threads were slower.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS = 2;  // blocks (a cluster) an image
constexpr int DEPTH = 4;   // steps whose unit loads are in flight a thread
constexpr int BATCH = 8;   // listed cells whose Sp loads are in flight together

// A unit of E: 16 bytes in the vector form, one cell (in .x) in the scalar
template <typename TE, bool kVec>
__device__ __forceinline__ uint4 load_unit(const TE* img, long long u) {
  if (kVec) return __ldg(reinterpret_cast<const uint4*>(img) + u);
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (sizeof(TE) == 2)
    v.x = __ldg(reinterpret_cast<const unsigned short*>(img) + u);
  else
    v.x = __ldg(reinterpret_cast<const unsigned*>(img) + u);
  return v;
}

// the unit's cells that are neither +0 nor -0, bit j for cell j
template <typename TE>
__device__ __forceinline__ unsigned unit_mask(const uint4& v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  unsigned m = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (sizeof(TE) == 4) {
      m |= (w[k] & 0x7fffffffu ? 1u : 0u) << k;
    } else {
      m |= (w[k] & 0x7fffu ? 1u : 0u) << (2 * k);
      m |= (w[k] & 0x7fff0000u ? 1u : 0u) << (2 * k + 1);
    }
  }
  return m;
}

// cell j of a unit, widened to float32 exactly
template <typename TE>
__device__ __forceinline__ float unit_cell(const uint4& v, int j) {
  constexpr int PER_WORD = 4 / sizeof(TE);
  const int k = j / PER_WORD;
  const unsigned w = k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  if (PER_WORD == 1) return __uint_as_float(w);
  return __uint_as_float((j % 2 ? w >> 16 : w & 0xffffu) << 16);
}

template <int R, typename TE, bool kVec>
__global__ void __launch_bounds__(THREADS)
    corr_kernel(const TE* __restrict__ E, const float* __restrict__ Sp,
                float* __restrict__ out, int T, int H, int W) {
  constexpr int RC = R * R;
  constexpr int SLOTS = (RC + 31) / 32;  // lags a lane
  constexpr int N = kVec ? 16 / (int)sizeof(TE) : 1;  // cells a unit
  constexpr int COUNT_BITS = N == 8 ? 4 : N == 4 ? 3 : 1;  // for 0..N
  // a step's cells at most, after fewer than BATCH left from the steps before
  constexpr int LIST = BATCH + 32 * N;
  __shared__ float list_e[WARPS][LIST];  // each warp's listed values
  __shared__ int list_o[WARPS][LIST];    // and Sp offsets h * (W+C) + w
  __shared__ float warp_sum[WARPS][RC];
  __shared__ float block_sum[RC];
  const int rank = blockIdx.x, t = blockIdx.y, p = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long HW = (long long)H * W;
  const TE* img = E + ((long long)p * T + t) * HW;
  const int WC = W + R;
  const float* sp = Sp + (long long)p * (H + R) * WC;

  // this block's run of the image's units
  const long long n_units = HW / N;
  const long long per = (n_units + BLOCKS - 1) / BLOCKS;
  const long long u_lo = rank * per;
  const long long u_hi = min(n_units, u_lo + per);

  int off[SLOTS];
  float acc[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int k = lane + 32 * s;
    off[s] = k < RC ? (k / R) * WC + k % R : 0;
    acc[s] = 0.0f;
  }

  // a warp takes 32 units a step, a unit a lane; each lane keeps the units
  // of its next DEPTH steps in flight
  const long long step = THREADS;
  const long long first = u_lo + warp * 32;
  uint4 v[DEPTH];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) {
    const long long u = first + d * step + lane;
    v[d] = u < u_hi ? load_unit<TE, kVec>(img, u) : make_uint4(0u, 0u, 0u, 0u);
  }
  int n = 0;  // cells in the warp's list
  for (long long g0 = first; g0 < u_hi; g0 += DEPTH * step) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const long long u0 = g0 + d * step;  // the step's first unit
      if (u0 >= u_hi) break;
      unsigned mask = unit_mask<TE>(v[d]);
      const uint4 cur = v[d];
      {
        const long long u = u0 + DEPTH * step + lane;
        v[d] = u < u_hi ? load_unit<TE, kVec>(img, u) : make_uint4(0u, 0u, 0u, 0u);
      }
      // the step's nonzero cells, appended to the warp's list in (lane,
      // column) order: each lane writes its unit's at its place in the
      // warp's prefix count (the counts' bits summed over ballots)
      if (__any_sync(0xffffffffu, mask != 0u)) {
        const int mine = __popc(mask);
        int before = 0, total = 0;
#pragma unroll
        for (int b = 0; b < COUNT_BITS; ++b) {
          const unsigned set = __ballot_sync(0xffffffffu, mine >> b & 1);
          before += __popc(set & ((1u << lane) - 1u)) << b;
          total += __popc(set) << b;
        }
        if (mask) {
          int at = n + before;
          const unsigned c0 = (unsigned)((u0 + lane) * N);
          const int h0 = (int)(c0 / (unsigned)W);
          const int col0 = (int)(c0 - (unsigned)h0 * (unsigned)W);
          while (mask) {
            const int j = __ffs(mask) - 1;
            mask &= mask - 1u;
            int h = h0, col = col0 + j;
            while (col >= W) {
              col -= W;
              ++h;
            }
            list_e[warp][at] = unit_cell<TE>(cur, j);
            list_o[warp][at] = h * WC + col;
            ++at;
          }
        }
        n += total;
      }
      // lane k adds e * Sp[h+dr, w+dc] of lag k (k + 32, ...) for the
      // listed cells in order, BATCH cells' loads in flight before their
      // adds; fewer than BATCH wait for a later step, but for the last
      const int done = u0 + step < u_hi ? n / BATCH * BATCH : n;
      if (done == 0) continue;
      __syncwarp();
      for (int b0 = 0; b0 < done; b0 += BATCH) {
        float e[BATCH];
        float sv[SLOTS][BATCH];
#pragma unroll
        for (int k = 0; k < BATCH; ++k) {
          const bool in = b0 + k < done;
          e[k] = in ? list_e[warp][b0 + k] : 0.0f;
          const int o = in ? list_o[warp][b0 + k] : 0;
#pragma unroll
          for (int q = 0; q < SLOTS; ++q)
            sv[q][k] = in && lane + 32 * q < RC ? __ldg(sp + o + off[q]) : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < BATCH; ++k)
#pragma unroll
          for (int q = 0; q < SLOTS; ++q)
            if (b0 + k < done && lane + 32 * q < RC)
              acc[q] = F_ADD(acc[q], F_MUL(e[k], sv[q][k]));
      }
      // the cells left move to the front of the list
      n -= done;
      float e_left = 0.0f;
      int o_left = 0;
      if (lane < n) {
        e_left = list_e[warp][done + lane];
        o_left = list_o[warp][done + lane];
      }
      __syncwarp();
      if (lane < n) {
        list_e[warp][lane] = e_left;
        list_o[warp][lane] = o_left;
      }
      __syncwarp();
    }
  }

  // the warps' sums, added in warp order; then the blocks' in rank order by
  // the cluster's rank 0, reading the others' shared memory (the second
  // sync keeps them alive meanwhile)
#pragma unroll
  for (int q = 0; q < SLOTS; ++q)
    if (lane + 32 * q < RC) warp_sum[warp][lane + 32 * q] = acc[q];
  __syncthreads();
  for (int k = threadIdx.x; k < RC; k += THREADS) {
    float total = 0.0f;
    for (int wi = 0; wi < WARPS; ++wi) total = F_ADD(total, warp_sum[wi][k]);
    block_sum[k] = total;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (rank == 0) {
    float* const mine = block_sum;
    for (int k = threadIdx.x; k < RC; k += THREADS) {
      float total = 0.0f;
      for (int b = 0; b < BLOCKS; ++b)
        total = F_ADD(total, cluster.map_shared_rank(mine, b)[k]);
      out[((long long)p * T + t) * RC + k] = total;
    }
  }
  cluster.sync();
}

template <int R, typename TE, bool kVec>
int launch(const void* E, const float* Sp, float* out, int P, int T, int H,
           int W, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(BLOCKS, T, P);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = BLOCKS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, corr_kernel<R, TE, kVec>, (const TE*)E, Sp, out, T, H, W);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <typename TE, bool kVec>
int dispatch(int R, const void* E, const float* Sp, float* out, int P, int T,
             int H, int W, cudaStream_t s) {
  switch (R) {
    case 1: return launch<1, TE, kVec>(E, Sp, out, P, T, H, W, s);
    case 3: return launch<3, TE, kVec>(E, Sp, out, P, T, H, W, s);
    case 5: return launch<5, TE, kVec>(E, Sp, out, P, T, H, W, s);
    case 7: return launch<7, TE, kVec>(E, Sp, out, P, T, H, W, s);
    case 9: return launch<9, TE, kVec>(E, Sp, out, P, T, H, W, s);
    case 11: return launch<11, TE, kVec>(E, Sp, out, P, T, H, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TE>
int dispatch_form(int R, const void* E, const float* Sp, float* out, int P,
                  int T, int H, int W, cudaStream_t s) {
  // the vector form needs every image's units 16-byte aligned
  const bool vec = (uintptr_t)E % 16 == 0 &&
                   (unsigned long long)H * W * sizeof(TE) % 16 == 0;
  return vec ? dispatch<TE, true>(R, E, Sp, out, P, T, H, W, s)
             : dispatch<TE, false>(R, E, Sp, out, P, T, H, W, s);
}

}  // namespace

extern "C" int slam2d_corr_scores(const void* E, int e_bf16, const float* Sp,
                                  float* out, int P, int T, int H, int W,
                                  int R, int C, void* stream) {
  // a cell's index in its image and its Sp offset are 32-bit ints
  if (P < 1 || P > 65535 || T < 1 || T > 65535 || H < 1 || W < 1 || R != C ||
      (long long)(H + R) * (W + C) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return e_bf16 ? dispatch_form<__nv_bfloat16>(R, E, Sp, out, P, T, H, W, s)
                : dispatch_form<float>(R, E, Sp, out, P, T, H, W, s);
}

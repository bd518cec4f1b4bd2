// Correlative match scores over a window of (theta, drow, dcol) candidates.
//
// Replaces slam2d_tpu/ops/pallas_score.py:_score_kernel (and, on the TPU's
// frontend path, the one-hot matmul scorer ops/mxu_score.py
// score_offsets_mxu_int8). The contract is score_offsets(impl="gather")
// (match/correlative.py): for every theta t and offset (dr, dc) in
// [-R/2, R/2] x [-C/2, C/2],
//   out[t, r, c] = sum_b w_b * S[row_b + dr, col_b + dc] / max(#valid, 1)
// with each tap masked on its own when it falls outside S. The bilinear
// (fine) pass splits every beam into four taps at floor(pos) with weights
// (1-fr)(1-fc), (1-fr)fc, fr(1-fc), fr*fc; the rounded (coarse) pass uses
// one tap at rint(pos) (round half to even, as jnp.round and torch.round).
// Invalid beams weigh 0 (their positions arrive zeroed, so a NaN range never
// reaches the weights).
//
// What bounds it on the H100: the work is tiny (frontend fine pass 5x9x9
// outputs x 180 beams x 4 taps, 0.3 M reads of S) and S stays in L2, so the
// kernel is bound by latency: a thread that walks all 180 beams in series
// waits on some 180 chains of L2 reads, and one block per theta keeps only
// a few SMs busy. Design: each thread sums the taps of one (r, c) output
// over a contiguous slice of the beams, UNROLL beams at a time with their
// loads issued ahead of the sums (a tap outside S reads a clamped cell and
// weighs 0, so every load is unconditional), and the slices' partial sums
// are added in slice order. Where one block of R*C x slices threads a
// theta leaves at most ONE_BLOCK_TAPS taps a thread (the coarse pass: 36
// slices of 5 beams), that block is the whole theta; else a cluster of up
// to GROUPS blocks shares the theta's beams (the fine pass: 8 blocks of 12
// slices of 2 beams), and the cluster's first block adds the blocks' sums
// in rank order from their shared memory (a cluster launch costs ~1.4 us
// more, so the coarse pass does without). The sums are the same bits from
// call to call (no atomics), in another order than the plain version's.
// With a gate (slam2d_score_offsets_gated, the frontend's step), every block
// returns at once when the device byte *gate is 0, leaving `out` as it
// was; the caller's select discards it.
// The beam rows, columns and weights of a block's beams are staged in
// shared memory once. The TPU kernel's patch bookkeeping (8-row aligned
// reads, beams dropped whole when their patch leaves the window) is a
// Mosaic artifact and is not carried over: taps are masked one by one, as
// in the gather semantics.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_THREADS = 1024;  // a block: R*C x slices threads at most
constexpr int ONE_BLOCK_TAPS = 16; // taps a thread in one block a theta at
                                   // most; more, and a cluster shares them
constexpr int THREAD_BEAMS = 2;    // beams a thread's slice in a cluster
constexpr int UNROLL = 4;          // beams whose loads are in flight together
constexpr int GROUPS = 8;          // blocks (a cluster) a theta at most

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

template <bool kCluster>
__global__ void score_kernel(const float* __restrict__ S,
                             const float* __restrict__ pos_row,
                             const float* __restrict__ pos_col,
                             const unsigned char* __restrict__ valid,
                             float* __restrict__ out,
                             const unsigned char* __restrict__ gate, int H,
                             int W, int B, int R, int C, int bilinear,
                             int per_group, int slices, int per_slice) {
  if (gate != nullptr && *gate == 0) return;  // uniform: the whole cluster
  extern __shared__ float smem[];
  int* brow = reinterpret_cast<int*>(smem);
  int* bcol = brow + per_group;
  float* wr = reinterpret_cast<float*>(bcol + per_group);  // row weight, tap 0
  float* wc = wr + per_group;                               // col weight, tap 0
  float* vw = wc + per_group;                               // 1: a valid beam
  float* part = vw + per_group;                             // [slices][R * C]
  float* group_sum = part + slices * R * C;                 // [R * C]
  const int g = blockIdx.x;  // the block's rank in its theta's cluster
  const int t = blockIdx.y;
  const int RC = R * C;
  const int g0 = g * per_group;
  const int nb = max(0, min(B, g0 + per_group) - g0);

  int n_valid = 0;
  for (int b0 = 0; b0 < B; b0 += blockDim.x) {
    const int b = b0 + threadIdx.x;
    const bool v = b < B && valid[b] != 0;
    if (b >= g0 && b < g0 + nb) {
      const int i = b - g0;
      const float pr = pos_row[(size_t)t * B + b];
      const float pc = pos_col[(size_t)t * B + b];
      vw[i] = v ? 1.0f : 0.0f;
      if (bilinear) {
        const float r0 = floorf(pr);
        const float c0 = floorf(pc);
        brow[i] = (int)clampf(r0, -1e9f, 1e9f);
        bcol[i] = (int)clampf(c0, -1e9f, 1e9f);
        wr[i] = F_SUB(pr, r0);  // fr
        wc[i] = F_SUB(pc, c0);  // fc
      } else {
        brow[i] = (int)clampf(rintf(pr), -1e9f, 1e9f);
        bcol[i] = (int)clampf(rintf(pc), -1e9f, 1e9f);
      }
    }
    n_valid += __syncthreads_count(v);  // also the barrier after the tables
  }

  const int s = threadIdx.x / RC;
  const int rc = threadIdx.x - s * RC;
  if (s < slices) {
    const int dr = rc / C - R / 2;
    const int dc = rc % C - C / 2;
    const int b_lo = s * per_slice;
    const int b_hi = min(nb, b_lo + per_slice);
    float acc = 0.0f;
#pragma unroll (UNROLL)
    for (int b = b_lo; b < b_hi; ++b) {
      const float v = vw[b];
      const int r = brow[b] + dr;
      const int c = bcol[b] + dc;
      if (!bilinear) {
        const bool in = r >= 0 && r < H && c >= 0 && c < W;
        const float x =
            S[(long long)clampi(r, 0, H - 1) * W + clampi(c, 0, W - 1)];
        acc = F_ADD(acc, F_MUL(x, in ? v : 0.0f));
        continue;
      }
      const float fr = wr[b];
      const float fc = wc[b];
      const float w0r = (r >= 0 && r < H) ? F_MUL(v, F_SUB(1.0f, fr)) : 0.0f;
      const float w1r = (r + 1 >= 0 && r + 1 < H) ? F_MUL(v, fr) : 0.0f;
      const float w0c = (c >= 0 && c < W) ? F_SUB(1.0f, fc) : 0.0f;
      const float w1c = (c + 1 >= 0 && c + 1 < W) ? fc : 0.0f;
      const long long i0 = (long long)clampi(r, 0, H - 1) * W;
      const long long i1 = (long long)clampi(r + 1, 0, H - 1) * W;
      const int c0 = clampi(c, 0, W - 1);
      const int c1 = clampi(c + 1, 0, W - 1);
      const float x00 = S[i0 + c0], x01 = S[i0 + c1];
      const float x10 = S[i1 + c0], x11 = S[i1 + c1];
      acc = F_ADD(acc, F_MUL(x00, F_MUL(w0r, w0c)));
      acc = F_ADD(acc, F_MUL(x01, F_MUL(w0r, w1c)));
      acc = F_ADD(acc, F_MUL(x10, F_MUL(w1r, w0c)));
      acc = F_ADD(acc, F_MUL(x11, F_MUL(w1r, w1c)));
    }
    part[s * RC + rc] = acc;
  }
  __syncthreads();
  if (threadIdx.x < RC) {
    float total = 0.0f;
    for (int k = 0; k < slices; ++k)
      total = F_ADD(total, part[k * RC + threadIdx.x]);
    if (kCluster)
      group_sum[threadIdx.x] = total;
    else
      out[(size_t)t * RC + threadIdx.x] =
          F_DIV(total, fmaxf((float)n_valid, 1.0f));
  }
  if (!kCluster) return;
  // the cluster's rank 0 adds the groups' sums in rank order, reading the
  // other blocks' shared memory; the second sync keeps them alive meanwhile
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (g == 0 && threadIdx.x < RC) {
    float total = 0.0f;
    for (int k = 0; k < (int)gridDim.x; ++k)
      total = F_ADD(total, cluster.map_shared_rank(group_sum, k)[threadIdx.x]);
    out[(size_t)t * RC + threadIdx.x] =
        F_DIV(total, fmaxf((float)n_valid, 1.0f));
  }
  cluster.sync();
}

__global__ void empty_kernel() {}

int launch(const float* S, const float* pos_row, const float* pos_col,
           const unsigned char* valid, float* out, const unsigned char* gate,
           int H, int W, int T, int B, int R, int C, int bilinear,
           void* stream) {
  const int RC = R * C;
  if (RC < 1 || RC > MAX_THREADS || B < 1 || T > 65535)
    return (int)cudaErrorInvalidValue;
  // one block a theta while its threads carry at most ONE_BLOCK_TAPS taps;
  // else the beams in `groups` blocks of a cluster, each group's in slices
  // of THREAD_BEAMS, as many as MAX_THREADS threads and GROUPS blocks allow
  const int max_slices = MAX_THREADS / RC;
  const int taps = bilinear ? 4 : 1;
  const int reach = max_slices * THREAD_BEAMS;  // beams a block
  int groups = (B + reach - 1) / reach < GROUPS ? (B + reach - 1) / reach
                                                : GROUPS;
  if ((B + max_slices - 1) / max_slices * taps <= ONE_BLOCK_TAPS) groups = 1;
  const int per_group = (B + groups - 1) / groups;
  const int want = (per_group + THREAD_BEAMS - 1) / THREAD_BEAMS;
  const int n = want < max_slices ? want : max_slices;
  const int per_slice = (per_group + n - 1) / n;
  const int slices = (per_group + per_slice - 1) / per_slice;
  const int threads = ((slices * RC + 31) / 32) * 32;
  const size_t smem =
      (5 * (size_t)per_group + (size_t)(slices + 1) * RC) * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (groups == 1) {
    score_kernel<false><<<dim3(1, T), threads, smem, st>>>(
        S, pos_row, pos_col, valid, out, gate, H, W, B, R, C, bilinear,
        per_group, slices, per_slice);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups, T);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = groups;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, score_kernel<true>, S, pos_row, pos_col, valid, out, gate, H, W,
      B, R, C, bilinear, per_group, slices, per_slice);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

extern "C" int slam2d_score_offsets(const float* S, const float* pos_row,
                                    const float* pos_col,
                                    const unsigned char* valid, float* out,
                                    int H, int W, int T, int B, int R, int C,
                                    int bilinear, void* stream) {
  return launch(S, pos_row, pos_col, valid, out, nullptr, H, W, T, B, R, C,
                bilinear, stream);
}

// As slam2d_score_offsets, when the device byte *gate is not 0
extern "C" int slam2d_score_offsets_gated(
    const float* S, const float* pos_row, const float* pos_col,
    const unsigned char* valid, float* out, const unsigned char* gate, int H,
    int W, int T, int B, int R, int C, int bilinear, void* stream) {
  return launch(S, pos_row, pos_col, valid, out, gate, H, W, T, B, R, C,
                bilinear, stream);
}

// One launch of an empty kernel: the floor under every launch of the port
// (what chip_smoke.py reports as launch_floor_ms).
extern "C" int slam2d_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

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
// 16 x 9 x 288^2 bf16, 24 MB, ~7 us at 3.35 TB/s) and Sp stays in L1/L2; the
// multiply-adds (R*C per nonzero E cell) are few next to that, since a splat
// image holds four cells per beam. Design: grid (row chunks, T, P). A block
// takes ROWS rows of one (p, t) image; each thread walks its cells and, for a
// nonzero E value, adds e * Sp[h+dr, w+dc] into R*C float32 accumulators in
// registers (R and C are template arguments). A zero E adds exactly zero, so
// skipping it changes nothing. The block reduces its accumulators (warp
// shuffles, then across warps) into one partial per lag; a second kernel
// adds the chunks' partials in chunk order. No atomics: the result is
// deterministic.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 16;  // image rows per block

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <int R, int C, typename TE>
__global__ void corr_partial_kernel(const TE* __restrict__ E,
                                    const float* __restrict__ Sp,
                                    float* __restrict__ partial, int T, int H,
                                    int W, int n_chunks) {
  constexpr int RC = R * C;
  __shared__ float red[THREADS / 32][RC];
  const int chunk = blockIdx.x, t = blockIdx.y, p = blockIdx.z;
  const int h0 = chunk * ROWS;
  const int h1 = min(H, h0 + ROWS);
  const TE* e_img = E + ((size_t)p * T + t) * H * W;
  const int WC = W + C;
  const float* sp = Sp + (size_t)p * (H + R) * WC;

  float acc[RC];
#pragma unroll
  for (int k = 0; k < RC; ++k) acc[k] = 0.0f;

  const int n = (h1 - h0) * W;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int h = h0 + i / W;
    const int w = i % W;
    const float e = widen(e_img[(size_t)h * W + w]);
    if (e == 0.0f) continue;
    const float* s = sp + (size_t)h * WC + w;
#pragma unroll
    for (int dr = 0; dr < R; ++dr) {
#pragma unroll
      for (int dc = 0; dc < C; ++dc) {
        acc[dr * C + dc] =
            F_ADD(acc[dr * C + dc], F_MUL(e, __ldg(s + dr * WC + dc)));
      }
    }
  }

  // block reduction: warp shuffles, then the warps' sums in warp order
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < RC; ++k) {
    float v = acc[k];
    for (int off = 16; off > 0; off /= 2)
      v = F_ADD(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < RC; k += THREADS) {
    float v = 0.0f;
    for (int wi = 0; wi < THREADS / 32; ++wi) v = F_ADD(v, red[wi][k]);
    partial[(((size_t)p * T + t) * n_chunks + chunk) * RC + k] = v;
  }
}

__global__ void corr_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ out, int PT, int RC,
                                   int n_chunks) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)PT * RC) return;
  const long long pt = i / RC;
  const int k = (int)(i % RC);
  float v = 0.0f;
  for (int c = 0; c < n_chunks; ++c)
    v = F_ADD(v, partial[(pt * n_chunks + c) * RC + k]);
  out[i] = v;
}

template <int R, typename TE>
int launch_partial(const void* E, const float* Sp, float* partial, int P,
                   int T, int H, int W, int n_chunks, cudaStream_t s) {
  const dim3 blocks(n_chunks, T, P);
  corr_partial_kernel<R, R, TE>
      <<<blocks, THREADS, 0, s>>>((const TE*)E, Sp, partial, T, H, W,
                                  n_chunks);
  return (int)cudaGetLastError();
}

template <typename TE>
int dispatch(int R, const void* E, const float* Sp, float* partial, int P,
             int T, int H, int W, int n_chunks, cudaStream_t s) {
  switch (R) {
    case 1: return launch_partial<1, TE>(E, Sp, partial, P, T, H, W, n_chunks, s);
    case 3: return launch_partial<3, TE>(E, Sp, partial, P, T, H, W, n_chunks, s);
    case 5: return launch_partial<5, TE>(E, Sp, partial, P, T, H, W, n_chunks, s);
    case 7: return launch_partial<7, TE>(E, Sp, partial, P, T, H, W, n_chunks, s);
    case 9: return launch_partial<9, TE>(E, Sp, partial, P, T, H, W, n_chunks, s);
    case 11: return launch_partial<11, TE>(E, Sp, partial, P, T, H, W, n_chunks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// partial: float32 scratch of corr_chunks(H) * P * T * R * C elements
extern "C" int slam2d_corr_chunks(int H) { return (H + ROWS - 1) / ROWS; }

extern "C" int slam2d_corr_scores(const void* E, int e_bf16, const float* Sp,
                                  float* partial, float* out, int P, int T,
                                  int H, int W, int R, int C, void* stream) {
  if (P < 1 || P > 65535 || T < 1 || T > 65535 || H < 1 || W < 1 || R != C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_chunks = slam2d_corr_chunks(H);
  const int err = e_bf16 ? dispatch<__nv_bfloat16>(R, E, Sp, partial, P, T, H,
                                                   W, n_chunks, s)
                         : dispatch<float>(R, E, Sp, partial, P, T, H, W,
                                           n_chunks, s);
  if (err != 0) return err;
  const long long n = (long long)P * T * R * C;
  corr_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      partial, out, P * T, R * C, n_chunks);
  return (int)cudaGetLastError();
}

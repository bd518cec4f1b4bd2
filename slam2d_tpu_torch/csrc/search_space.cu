// Search-space build: evidence clip, separable Gaussian blur, free penalty.
//
// Replaces slam2d_tpu/ops/pallas_blur.py:_blur_kernel, fused with the rest of
// match/correlative.py:build_search_space:
//   occ   = clip(l * inv_occ_sat, 0, 1)   (XLA's form of l / occ_sat)
//   blur  = clip(blur_cols(blur_rows(occ)), 0, 1)      zero padding
//   out   = blur - free_penalty * [sigmoid(l) < free_threshold] * (1 - blur)
// The taps are peak-normalized; each axis accumulates from tap 0 upward, rows
// (axis 0) first, as _separable_blur does, so the sums round as in the JAX
// package.
//
// What bounds it on the H100: each output cell costs 2 x 13 multiply-adds
// against one read of l, one write of the scratch plane and one of S (12 bytes
// a cell plus a 4-byte reread of l: 4.3 MB at the frontend's 520^2 window,
// 17 MB at the 1024^2 initial build), so it is bound by memory bandwidth and
// by launch latency at the window size. Design: two passes. Pass 1 blurs the
// clipped evidence along rows into a scratch plane the wrapper allocates;
// pass 2 blurs along columns and applies the clip and the free penalty in
// its epilogue. Neighbouring threads take neighbouring columns, so every
// tap's read is coalesced and the 13-fold reuse is served by L1/L2. The taps
// travel by value in the launch's parameters. The evidence clip and the
// field epilogue are shared with window_field.cu (common.cuh).

#include "common.cuh"

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

__global__ void blur_rows_kernel(const float* __restrict__ l,
                                 float* __restrict__ tmp, int H, int W,
                                 Taps taps, float inv_occ_sat) {
  const int col = blockIdx.x * BX + threadIdx.x;
  const int row = blockIdx.y * BY + threadIdx.y;
  if (row >= H || col >= W) return;
  const int hw = taps.n / 2;
  float acc = 0.0f;
  for (int k = 0; k < taps.n; ++k) {
    const int r = row + k - hw;
    if (r < 0 || r >= H) continue;  // zero padding adds exactly 0
    const float occ = evidence(l[(size_t)r * W + col], inv_occ_sat);
    acc = F_ADD(acc, F_MUL(taps.k[k], occ));
  }
  tmp[(size_t)row * W + col] = acc;
}

__global__ void blur_cols_field_kernel(const float* __restrict__ l,
                                       const float* __restrict__ tmp,
                                       float* __restrict__ out, int H, int W,
                                       Taps taps, float free_threshold,
                                       float free_penalty) {
  const int col = blockIdx.x * BX + threadIdx.x;
  const int row = blockIdx.y * BY + threadIdx.y;
  if (row >= H || col >= W) return;
  const int hw = taps.n / 2;
  const float* line = tmp + (size_t)row * W;
  float acc = 0.0f;
  for (int k = 0; k < taps.n; ++k) {
    const int c = col + k - hw;
    if (c < 0 || c >= W) continue;
    acc = F_ADD(acc, F_MUL(taps.k[k], line[c]));
  }
  const float lv = l[(size_t)row * W + col];
  const float p = 1.0f / (1.0f + expf(-lv));
  out[(size_t)row * W + col] =
      field_value(acc, p < free_threshold, free_penalty);
}

}  // namespace

extern "C" int slam2d_search_space(const float* logodds, float* scratch,
                                   float* out, int H, int W,
                                   const float* taps_host, int n_taps,
                                   float inv_occ_sat, float free_threshold,
                                   float free_penalty, void* stream) {
  Taps taps{};
  if (!load_taps(&taps, taps_host, n_taps)) return (int)cudaErrorInvalidValue;
  const dim3 block(BX, BY);
  const dim3 blocks((W + BX - 1) / BX, (H + BY - 1) / BY);
  cudaStream_t s = (cudaStream_t)stream;
  blur_rows_kernel<<<blocks, block, 0, s>>>(logodds, scratch, H, W, taps,
                                            inv_occ_sat);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  blur_cols_field_kernel<<<blocks, block, 0, s>>>(
      logodds, scratch, out, H, W, taps, free_threshold, free_penalty);
  return (int)cudaGetLastError();
}

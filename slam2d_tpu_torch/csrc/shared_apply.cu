// Shared-anchor map update apply: every particle's slot image added into its
// map at its anchor cell, then its exact endpoint marks, in place, in one
// launch.
//
// Replaces slam2d_tpu/ops/pallas_apply.py:_apply_kernel (shared_apply_update
// with fused endpoints, snapped placement), called by
// pf/shared_update.py:shared_update. For particle p, with image row 0 at map
// row ar = anchor_r[p] - win/2 and column ac = anchor_c[p] - win/2:
//   1. every cell of images[slot[p]] that lands on the map becomes
//      y = clip(f32(x) + img, +-l_clamp), stored in the map dtype; image
//      cells off the map are dropped, map cells outside the image are left;
//   2. every cell that is the endpoint cell (ep_r, ep_c) of a beam with a
//      weight w != 0 gains s = (sum over those beams, in beam order, of
//      bf16(w)) in float32, cast to the map dtype, added in the map dtype
//      (one rounding), then clipped to the map dtype's l_clamp.
// These are the TPU kernel's numerics (pallas_apply.py:161-185: a bf16
// one-hot product with a float32 result, cast, added and clipped in the map
// dtype). A beam with w = 0 adds zero there, so it is skipped here. The TPU
// kernel's 8/128-aligned superset window, its DMA double buffering and its
// shape gates are TPU mechanics: this kernel takes every map and window
// size.
//
// What bounds it on the H100: the window is read and written once per
// particle and the image read once per particle (at FastSLAM-1000's 1000
// bf16 maps, 256^2 windows and float32 images, 786 MB, ~235 us at
// 3.35 TB/s); a few adds per cell, so it is bound by bytes. Design: one
// block per particle. The dense pass strides the block's threads over the
// image extent intersected with the map, row-major, so a warp reads and
// writes consecutive cells. After __syncthreads() the endpoint pass runs one
// thread per beam: the thread of the first beam on a cell sums that cell's
// weights in beam order and writes the cell once, so no atomics are needed.

#include "common.cuh"

namespace {

constexpr int THREADS = 512;

__device__ __forceinline__ float round_as(float v, float*) { return v; }
__device__ __forceinline__ float round_as(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T, typename I>
__global__ void shared_apply_kernel(T* __restrict__ maps,
                                    const I* __restrict__ images,
                                    const int* __restrict__ anchors,
                                    const int* __restrict__ slots,
                                    const int* __restrict__ ep_r,
                                    const int* __restrict__ ep_c,
                                    const float* __restrict__ ep_w, int H,
                                    int W, int win, int G, int B,
                                    float l_clamp) {
  extern __shared__ int smem[];
  const int p = blockIdx.x;
  T* map = maps + (size_t)p * H * W;
  const int ar = anchors[2 * p] - win / 2;
  const int ac = anchors[2 * p + 1] - win / 2;
  const int slot = min(max(slots[p], 0), G - 1);
  const I* img = images + (size_t)slot * win * win;

  // dense pass: image rows i in [i0, i1), columns j in [j0, j1) on the map
  const int i0 = max(0, -ar), i1 = min(win, H - ar);
  const int j0 = max(0, -ac), j1 = min(win, W - ac);
  const int nj = j1 - j0;
  if (i1 > i0 && nj > 0) {
    const int n = (i1 - i0) * nj;
    for (int k = threadIdx.x; k < n; k += THREADS) {
      const int i = i0 + k / nj;
      const int j = j0 + k % nj;
      T* cell = map + (size_t)(ar + i) * W + (ac + j);
      const float v = F_ADD(load_f32(cell), load_f32(img + (size_t)i * win + j));
      store_f32(cell, clampf(v, -l_clamp, l_clamp));
    }
  }
  if (B == 0) return;

  int* sr = smem;
  int* sc = smem + B;
  float* sw = (float*)(smem + 2 * B);
  for (int b = threadIdx.x; b < B; b += THREADS) {
    sr[b] = ep_r[(size_t)p * B + b];
    sc[b] = ep_c[(size_t)p * B + b];
    sw[b] = ep_w[(size_t)p * B + b];
  }
  __syncthreads();  // the dense pass's stores and the beam table

  const float lc = round_as(l_clamp, (T*)nullptr);
  for (int b = threadIdx.x; b < B; b += THREADS) {
    if (sw[b] == 0.0f) continue;
    const int r = sr[b], c = sc[b];
    bool first = true;
    for (int e = 0; e < b && first; ++e)
      first = !(sw[e] != 0.0f && sr[e] == r && sc[e] == c);
    if (!first || r < 0 || r >= H || c < 0 || c >= W) continue;
    float s = 0.0f;
    for (int e = b; e < B; ++e) {
      if (sw[e] != 0.0f && sr[e] == r && sc[e] == c)
        s = F_ADD(s, __bfloat162float(__float2bfloat16_rn(sw[e])));
    }
    T* cell = map + (size_t)r * W + c;
    const float t = round_as(F_ADD(load_f32(cell), round_as(s, (T*)nullptr)),
                             (T*)nullptr);
    store_f32(cell, clampf(t, -lc, lc));
  }
}

template <typename T, typename I>
int launch(void* maps, const void* images, const int* anchors,
           const int* slots, const int* ep_r, const int* ep_c,
           const float* ep_w, int P, int H, int W, int win, int G, int B,
           float l_clamp, cudaStream_t s) {
  const size_t smem = 3 * (size_t)B * sizeof(int);
  shared_apply_kernel<T, I><<<P, THREADS, smem, s>>>(
      (T*)maps, (const I*)images, anchors, slots, ep_r, ep_c, ep_w, H, W, win,
      G, B, l_clamp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int slam2d_shared_apply(void* maps, int map_bf16,
                                   const void* images, int img_bf16,
                                   const int* anchors, const int* slots,
                                   const int* ep_r, const int* ep_c,
                                   const float* ep_w, int P, int H, int W,
                                   int win, int G, int B, float l_clamp,
                                   void* stream) {
  if (P < 1 || H < 1 || W < 1 || win < 1 || G < 1 || B < 0 || B > 4096)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (map_bf16 && img_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        maps, images, anchors, slots, ep_r, ep_c, ep_w, P, H, W, win, G, B,
        l_clamp, s);
  if (map_bf16)
    return launch<__nv_bfloat16, float>(maps, images, anchors, slots, ep_r,
                                        ep_c, ep_w, P, H, W, win, G, B,
                                        l_clamp, s);
  if (img_bf16)
    return launch<float, __nv_bfloat16>(maps, images, anchors, slots, ep_r,
                                        ep_c, ep_w, P, H, W, win, G, B,
                                        l_clamp, s);
  return launch<float, float>(maps, images, anchors, slots, ep_r, ep_c, ep_w,
                              P, H, W, win, G, B, l_clamp, s);
}

// Exact-ray log-odds update of one map window.
//
// Replaces slam2d_tpu/ops/pallas_update.py:_update_kernel, variant "ray"
// (pallas_dense_update(..., variant="ray"), the frontend's
// update_impl="pallas_ray"): the sampled-ray semantics in closed form. Per
// cell, with (cx, cy) its center relative to the sensor:
//   free = sum over beams b of w_b * (length of beam b's chord through the
//          cell square, truncated to [0, r_free_b] along the beam), where
//          t = cx*dx + cy*dy, ct = |cx*dy - cy*dx|,
//          L = max(min(cmax_b, (half_b - ct) * invab_b), 0),
//          chord = max(min(t + L/2, r_free_b) - max(t - L/2, 0), 0);
//   occ  = the number of hitting beams whose floor-exact endpoint cell
//          (erow_b, ecol_b) is this cell;
//   out  = clip(g + (l_free*free + l_occ*occ) * enable, +-l_clamp).
// The per-beam tables (direction, w, cmax, half, invab, r_free, endpoint
// cell; 9 rows of Bpad floats, Bpad a multiple of 8, the pad beams all
// zero weight with endpoints at -1e9) are built by the wrapper in PyTorch,
// as the TPU kernel's wrapper builds them (pallas_update.py:321-370), and
// shared with the plain version.
//
// The sums follow the TPU kernel's grouping: chunks of 8 beams, each chunk
// summed from its first beam upward, each chunk's sum then added to the
// running total. The TPU kernel skips the chunks outside a tile's bearing
// window, whose terms are exactly 0; this kernel adds every chunk, which
// adds those zeros. Every float operation is written with the _rn
// intrinsics, so the kernel and its plain version agree bit for bit.
//
// What bounds it on the H100: at the frontend's 520^2 window the map is
// read and written once (2.2 MB, ~0.6 us at 3.35 TB/s) while every cell
// evaluates ~16 float operations for each of the 184 table beams: it is
// bound by instructions. Design: one thread per cell; the block stages the
// tables in shared memory, where every thread of a warp reads the same
// entry (a broadcast).

#include "common.cuh"

namespace {

constexpr int BX = 32;
constexpr int BY = 8;
constexpr int UNROLL = 8;  // the TPU kernel's beam chunk (_UNROLL)

struct Params {
  float ox, oy, res, l_free, l_occ, l_clamp, enable;
};

__global__ void update_ray_kernel(const float* __restrict__ grid,
                                  float* __restrict__ out,
                                  const float* __restrict__ pose,
                                  const float* __restrict__ rays, int H,
                                  int W, int Bpad, Params p) {
  extern __shared__ float tab[];  // [9, Bpad]
  for (int i = threadIdx.y * BX + threadIdx.x; i < 9 * Bpad; i += BX * BY)
    tab[i] = rays[i];
  __syncthreads();
  const float* dxs = tab;
  const float* dys = tab + Bpad;
  const float* ws = tab + 2 * Bpad;
  const float* cms = tab + 3 * Bpad;
  const float* hfs = tab + 4 * Bpad;
  const float* ias = tab + 5 * Bpad;
  const float* rfs = tab + 6 * Bpad;
  const float* ers = tab + 7 * Bpad;
  const float* ecs = tab + 8 * Bpad;

  const int col = blockIdx.x * BX + threadIdx.x;
  const int row = blockIdx.y * BY + threadIdx.y;
  if (row >= H || col >= W) return;
  const float fr = (float)row;
  const float fc = (float)col;
  const float cx = F_SUB(F_ADD(p.ox, F_MUL(F_ADD(fc, 0.5f), p.res)), pose[0]);
  const float cy = F_SUB(F_ADD(p.oy, F_MUL(F_ADD(fr, 0.5f), p.res)), pose[1]);

  float free_sum = 0.0f, occ_sum = 0.0f;
  for (int b0 = 0; b0 < Bpad; b0 += UNROLL) {
    float fa = 0.0f, oa = 0.0f;
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int b = b0 + k;
      const float t = F_ADD(F_MUL(cx, dxs[b]), F_MUL(cy, dys[b]));
      const float ct = fabsf(F_SUB(F_MUL(cx, dys[b]), F_MUL(cy, dxs[b])));
      const float L =
          fmaxf(fminf(cms[b], F_MUL(F_SUB(hfs[b], ct), ias[b])), 0.0f);
      const float Lh = F_MUL(0.5f, L);
      const float chord = fmaxf(
          F_SUB(fminf(F_ADD(t, Lh), rfs[b]), fmaxf(F_SUB(t, Lh), 0.0f)), 0.0f);
      const float f = F_MUL(ws[b], chord);
      const float o = (ers[b] == fr && ecs[b] == fc) ? 1.0f : 0.0f;
      // chunk sums start from the chunk's first beam (f0 + f1 + ...)
      fa = k == 0 ? f : F_ADD(fa, f);
      oa = k == 0 ? o : F_ADD(oa, o);
    }
    free_sum = F_ADD(free_sum, fa);
    occ_sum = F_ADD(occ_sum, oa);
  }

  const float upd = F_MUL(
      F_ADD(F_MUL(p.l_free, free_sum), F_MUL(p.l_occ, occ_sum)), p.enable);
  const size_t i = (size_t)row * W + col;
  out[i] = clampf(F_ADD(grid[i], upd), -p.l_clamp, p.l_clamp);
}

}  // namespace

extern "C" int slam2d_update_ray(const float* grid, float* out,
                                 const float* pose, const float* rays, int H,
                                 int W, int Bpad, float ox, float oy,
                                 float res, float l_free, float l_occ,
                                 float l_clamp, float enable, void* stream) {
  if (H < 1 || W < 1 || Bpad < UNROLL || Bpad % UNROLL != 0)
    return (int)cudaErrorInvalidValue;
  const Params p{ox, oy, res, l_free, l_occ, l_clamp, enable};
  const dim3 block(BX, BY);
  const dim3 blocks((W + BX - 1) / BX, (H + BY - 1) / BY);
  const size_t smem = 9 * (size_t)Bpad * sizeof(float);
  update_ray_kernel<<<blocks, block, smem, (cudaStream_t)stream>>>(
      grid, out, pose, rays, H, W, Bpad, p);
  return (int)cudaGetLastError();
}

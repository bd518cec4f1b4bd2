// Hybrid inverse-sensor-model log-odds update of one map window.
//
// Replaces slam2d_tpu/ops/pallas_update.py:_update_kernel, variant "hybrid"
// (its contract is pallas_dense_update(..., variant="hybrid")):
//   free  = some beam b has |phi - b*step| <= step/2 and d < rmin3[b] - res
//   count = number of hitting beams whose floor-exact endpoint cell is this
//   out   = clip(g + (l_free*free + l_occ*count) * enable, +-l_clamp)
// rmin3[b] is the min valid range of beam b and its two neighbours (ends
// replicated); phi is the cell's bearing relative to angle_min, wrapped to
// [-pi, pi) and compared against the unwrapped b*step.
//
// What bounds it on the H100: at the frontend's 520^2 window the map is read
// and written once (2.2 MB, under a microsecond of HBM time), so the kernel
// is bound by instructions per cell: an atan2f, a sqrt, and a scan of the
// endpoint table. Design: one thread per cell. Each block rebuilds the
// per-beam tables (rmin3, endpoint row and column) in shared memory, which
// costs B sincos per block and saves a launch. The free test checks only
// floor(phi/step) and the beam after it: any other beam is a whole step
// away, so this equals the TPU kernel's loop over all beams. The endpoint
// count scans the table in shared memory (every thread of a warp reads the
// same entry, a broadcast). The TPU kernel's angular beam clip and range
// early-out only skip work and never change the result, so they are not
// carried over, nor is its padding of the beam table to a multiple of 8.
// The arithmetic follows the TPU kernel's float32 operations one by one
// (common.cuh); atan2f, cosf and sinf may differ from the JAX functions in
// the last bit, which moves a boundary cell by one l_free or l_occ.

#include "common.cuh"

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

struct Params {
  float ox, oy, res, step, angle_min, min_range, max_range;
  float l_free, l_occ, l_clamp, enable;
};

__global__ void update_hybrid_kernel(const float* __restrict__ grid,
                                     float* __restrict__ out,
                                     const float* __restrict__ pose,
                                     const float* __restrict__ ranges,
                                     const float* __restrict__ angles, int H,
                                     int W, int B, Params p) {
  extern __shared__ float smem[];
  float* rmin3 = smem;
  float* erow = smem + B;
  float* ecol = smem + 2 * B;
  const float px = pose[0], py = pose[1], pth = pose[2];
  const float inv_res = F_DIV(1.0f, p.res);  // x / res compiles as x * (1/res)

  for (int b = threadIdx.y * BX + threadIdx.x; b < B; b += BX * BY) {
    float m = INFINITY;
    bool valid_b = false;
    for (int j = -1; j <= 1; ++j) {
      const float rk = ranges[min(max(b + j, 0), B - 1)];
      const bool vk = rk > p.min_range && isfinite(rk);
      if (vk) m = fminf(m, clampf(rk, 0.0f, p.max_range));
      if (j == 0) valid_b = vk;
    }
    rmin3[b] = valid_b ? m : -1.0f;
    const float rb = ranges[b];
    const bool hit = valid_b && rb < p.max_range;
    const float r = clampf(rb, 0.0f, p.max_range);
    const float a = F_ADD(angles[b], pth);
    const float ey = F_SUB(F_ADD(py, F_MUL(sinf(a), r)), p.oy);
    const float ex = F_SUB(F_ADD(px, F_MUL(cosf(a), r)), p.ox);
    erow[b] = hit ? floorf(F_MUL(ey, inv_res)) : -1e9f;
    ecol[b] = hit ? floorf(F_MUL(ex, inv_res)) : -1e9f;
  }
  __syncthreads();

  const int col = blockIdx.x * BX + threadIdx.x;
  const int row = blockIdx.y * BY + threadIdx.y;
  if (row >= H || col >= W) return;
  const float fr = (float)row;
  const float fc = (float)col;
  const float cx = F_SUB(F_ADD(p.ox, F_MUL(F_ADD(fc, 0.5f), p.res)), px);
  const float cy = F_SUB(F_ADD(p.oy, F_MUL(F_ADD(fr, 0.5f), p.res)), py);
  const float d = __fsqrt_rn(F_ADD(F_MUL(cx, cx), F_MUL(cy, cy)));
  float phi = F_SUB(F_SUB(atan2f(cy, cx), pth), p.angle_min);
  phi = F_SUB(mod_pos(F_ADD(phi, PI_F), TWO_PI_F), PI_F);

  const float half_slot = 0.5f * p.step;
  const float k0 = floorf(F_DIV(phi, p.step));
  bool free_cell = false;
  for (int j = 0; j < 2; ++j) {
    const float k = F_ADD(k0, (float)j);
    if (k >= 0.0f && k <= (float)(B - 1)) {
      const int b = (int)k;
      const float ab = F_MUL((float)b, p.step);
      free_cell |= fabsf(F_SUB(phi, ab)) <= half_slot &&
                   d < F_SUB(rmin3[b], p.res);
    }
  }
  int count = 0;
  for (int b = 0; b < B; ++b) count += (erow[b] == fr) & (ecol[b] == fc);

  const float upd =
      F_MUL(F_ADD(F_MUL(p.l_free, free_cell ? 1.0f : 0.0f),
                  F_MUL(p.l_occ, (float)count)),
            p.enable);
  const size_t i = (size_t)row * W + col;
  out[i] = clampf(F_ADD(grid[i], upd), -p.l_clamp, p.l_clamp);
}

}  // namespace

extern "C" int slam2d_update_hybrid(const float* grid, float* out,
                                    const float* pose, const float* ranges,
                                    const float* angles, int H, int W, int B,
                                    float ox, float oy, float res, float step,
                                    float angle_min, float min_range,
                                    float max_range, float l_free, float l_occ,
                                    float l_clamp, float enable,
                                    void* stream) {
  const Params p{ox,     oy,    res,   step,    angle_min, min_range,
                 max_range, l_free, l_occ, l_clamp, enable};
  const dim3 block(BX, BY);
  const dim3 blocks((W + BX - 1) / BX, (H + BY - 1) / BY);
  const size_t smem = 3 * (size_t)B * sizeof(float);
  update_hybrid_kernel<<<blocks, block, smem, (cudaStream_t)stream>>>(
      grid, out, pose, ranges, angles, H, W, B, p);
  return (int)cudaGetLastError();
}

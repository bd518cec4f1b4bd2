// Inverse-sensor-model log-odds update of every particle's map window, in
// place, in one launch.
//
// Replaces slam2d_tpu/ops/pallas_update.py:_update_kernel, variant "ism"
// (pallas_dense_update(..., variant="ism")), as the particle filter runs it:
// vmapped over the particles, each on the update window around its pose
// (pf/fastslam.py:_windowed_update: extract, update, write back). Per cell:
//   free = some beam b has |phi - b*step| <= step/2 and d < rmin3[b] - res
//   occ  = some hitting beam b has |phi - b*step| <= 0.75*res / max(d, 1e-6)
//          and |d - r_b| <= 0.75*res
//   out  = clip(g + (l_free*free + l_occ*occ) * enable, +-l_clamp)
// rmin3[b] is the min valid range of beam b and its two neighbours (ends
// replicated); phi is the cell's bearing relative to angle_min, wrapped to
// [-pi, pi) and compared against the unwrapped b*step.
//
// Each particle's window origin is computed here from its pose, as
// grid/window.py:window_origin does: the pose's cell, minus half the
// window, clamped into the map; its float origin is ox + f32(c0) * res, as
// grid/occupancy.py:integrate_scan derives it from an integer origin. So the
// extract / update / write-back of the JAX package becomes one in-place pass
// with no host read. With a window as large as the map the origin is 0.
//
// What bounds it on the H100: at FastSLAM-100's shapes (100 windows of 256^2
// of bf16 maps) the map traffic is 26 MB, 8 us at 3.35 TB/s, while every
// cell costs an atan2f, a sqrt and a short beam loop: it is bound by
// instructions. Design: one thread per cell, one block row of the grid per
// particle (blockIdx.z). Each block rebuilds the beam tables (hit range,
// rmin3) in shared memory, which saves a launch. The free test checks only
// floor(phi/step) and the beam after it: any other beam is a whole step
// away. The occupied test cannot do that: its angular tolerance 0.75*res/d
// spans many beams near the sensor, so each cell loops over exactly the
// beams whose bearing window can reach it (one or two far out). The TPU
// kernel's angular beam clip and range early-out only skip work and never
// change the result, so they are not carried over. The arithmetic follows
// the TPU kernel's float32 operations one by one (common.cuh); atan2f
// replaces its polynomial atan2 (|err| ~2e-8), which moves a cell on a beam
// slot's edge by one l_free or l_occ. Accumulation and the clamp run in
// float32; a bf16 map is rounded to nearest even once, at the store.

#include "common.cuh"

namespace {

constexpr int BX = 32;
constexpr int BY = 8;

struct Params {
  int H, W, Hr, Wr, B;
  float gox, goy, res, inv_res, step, half_step, angle_min, min_range,
      max_range, occ_tol, l_free, l_occ, l_clamp, enable;
};

template <typename T>
__global__ void update_ism_kernel(T* __restrict__ maps,
                                  const float* __restrict__ poses,
                                  const float* __restrict__ ranges, Params p) {
  extern __shared__ float smem[];
  float* r_hit = smem;
  float* rmin3 = smem + p.B;
  const int part = blockIdx.z;
  const float px = poses[3 * part], py = poses[3 * part + 1],
              pth = poses[3 * part + 2];

  for (int b = threadIdx.y * BX + threadIdx.x; b < p.B; b += BX * BY) {
    float m = INFINITY;
    bool valid_b = false;
    for (int j = -1; j <= 1; ++j) {
      const float rk = ranges[min(max(b + j, 0), p.B - 1)];
      const bool vk = rk > p.min_range && isfinite(rk);
      if (vk) m = fminf(m, clampf(rk, 0.0f, p.max_range));
      if (j == 0) valid_b = vk;
    }
    rmin3[b] = valid_b ? m : -1.0f;
    const float rb = ranges[b];
    r_hit[b] = valid_b && rb < p.max_range ? clampf(rb, 0.0f, p.max_range)
                                           : -1.0f;
  }
  __syncthreads();

  const int col = blockIdx.x * BX + threadIdx.x;
  const int row = blockIdx.y * BY + threadIdx.y;
  if (row >= p.Hr || col >= p.Wr) return;

  // window origin: world_to_cell of the pose (x / res as x * (1/res), as
  // XLA compiles it), minus half the window, clamped into the map
  const int cr = (int)floorf(F_MUL(F_SUB(py, p.goy), p.inv_res));
  const int cc = (int)floorf(F_MUL(F_SUB(px, p.gox), p.inv_res));
  const int r0 = min(max(cr - p.Hr / 2, 0), p.H - p.Hr);
  const int c0 = min(max(cc - p.Wr / 2, 0), p.W - p.Wr);
  const float ox = F_ADD(p.gox, F_MUL((float)c0, p.res));
  const float oy = F_ADD(p.goy, F_MUL((float)r0, p.res));

  const float cx =
      F_SUB(F_ADD(ox, F_MUL(F_ADD((float)col, 0.5f), p.res)), px);
  const float cy =
      F_SUB(F_ADD(oy, F_MUL(F_ADD((float)row, 0.5f), p.res)), py);
  const float d = __fsqrt_rn(F_ADD(F_MUL(cx, cx), F_MUL(cy, cy)));
  float phi = F_SUB(F_SUB(atan2f(cy, cx), pth), p.angle_min);
  phi = F_SUB(mod_pos(F_ADD(phi, PI_F), TWO_PI_F), PI_F);

  bool free_cell = false;
  const float k0 = floorf(F_DIV(phi, p.step));
  for (int j = 0; j < 2; ++j) {
    const float k = F_ADD(k0, (float)j);
    if (k >= 0.0f && k <= (float)(p.B - 1)) {
      const int b = (int)k;
      free_cell |= fabsf(F_SUB(phi, F_MUL((float)b, p.step))) <= p.half_step &&
                   d < F_SUB(rmin3[b], p.res);
    }
  }

  // every beam whose bearing window [b*step - tol, b*step + tol] can hold
  // phi lies in [lo, hi]; one beam of slack on each side covers rounding
  bool occ = false;
  const float tol = F_DIV(p.occ_tol, fmaxf(d, 1e-6f));
  const float lo_f = floorf(F_DIV(F_SUB(phi, tol), p.step)) - 1.0f;
  const float hi_f = floorf(F_DIV(F_ADD(phi, tol), p.step)) + 1.0f;
  const int lo = (int)fmaxf(lo_f, 0.0f);
  const int hi = (int)fminf(hi_f, (float)(p.B - 1));
  for (int b = lo; b <= hi && !occ; ++b) {
    occ = fabsf(F_SUB(phi, F_MUL((float)b, p.step))) <= tol &&
          fabsf(F_SUB(d, r_hit[b])) <= p.occ_tol;
  }

  const float upd =
      F_MUL(F_ADD(F_MUL(p.l_free, free_cell ? 1.0f : 0.0f),
                  F_MUL(p.l_occ, occ ? 1.0f : 0.0f)),
            p.enable);
  T* cell = maps + ((size_t)part * p.H + (r0 + row)) * p.W + (c0 + col);
  store_f32(cell, clampf(F_ADD(load_f32(cell), upd), -p.l_clamp, p.l_clamp));
}

}  // namespace

extern "C" int slam2d_update_ism(void* maps, int is_bf16, const float* poses,
                                 const float* ranges, int P, int H, int W,
                                 int Hr, int Wr, int B, float gox, float goy,
                                 float res, float inv_res, float step,
                                 float half_step, float angle_min,
                                 float min_range, float max_range,
                                 float occ_tol, float l_free, float l_occ,
                                 float l_clamp, float enable, void* stream) {
  if (Hr > H || Wr > W || Hr < 1 || Wr < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const Params p{H,        W,         Hr,        Wr,     B,       gox,
                 goy,      res,       inv_res,   step,   half_step,
                 angle_min, min_range, max_range, occ_tol, l_free,
                 l_occ,    l_clamp,   enable};
  const dim3 block(BX, BY);
  const dim3 blocks((Wr + BX - 1) / BX, (Hr + BY - 1) / BY, P);
  const size_t smem = 2 * (size_t)B * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    update_ism_kernel<__nv_bfloat16><<<blocks, block, smem, s>>>(
        (__nv_bfloat16*)maps, poses, ranges, p);
  } else {
    update_ism_kernel<float><<<blocks, block, smem, s>>>((float*)maps, poses,
                                                         ranges, p);
  }
  return (int)cudaGetLastError();
}

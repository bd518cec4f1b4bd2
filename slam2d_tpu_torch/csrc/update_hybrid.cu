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
// is bound by instructions per cell (an atan2f, a sqrt, a float modulo), by
// each block's prologue (the beam tables, with a sinf and a cosf a beam)
// and by the launch itself. Design, as update_ism.cu's:
// - A block updates a TH x TW tile (64 x 8 cells), 2 cells a thread. It
//   issues the loads of its cells first, then builds the beam tables once
//   for the tile. (Tiles of 32 x 8 to 256 x 8 cells, 1 to 8 a thread, came
//   within 20% of each other: the scatter and the range skip below, not
//   the tile, took the time from 0.017 to under 0.006 ms.)
// - The endpoint count is scattered, not gathered: each hitting beam whose
//   floor-exact endpoint cell lies in the tile adds 1 to an integer count
//   tile in shared memory (integer atomics: exact and order-free). The
//   endpoint comes from the same float32 operations as a per-cell compare
//   against every beam's endpoint, so the counts are the same integers.
// - The free test stays per cell: it checks only floor(phi/step) and the
//   beam after it (any other beam is a whole step away), and a cell at
//   d >= max_b rmin3[b] - res cannot be free (invalid beams carry rmin3 =
//   -1), so it skips the bearing.
// - Every window cell is still read, clipped and written.
// The TPU kernel's angular beam clip and range early-out only skip work and
// never change the result, so they are not carried over, nor is its padding
// of the beam table to a multiple of 8. The arithmetic follows the TPU
// kernel's float32 operations one by one (common.cuh); atan2f, cosf and
// sinf may differ from the JAX functions in the last bit, which moves a
// boundary cell by one l_free or l_occ.

#include "common.cuh"

namespace {

constexpr int BX = 32;   // threads of a block along a row
constexpr int BY = 8;    // and across the rows
constexpr int TW = 64;   // a block's tile: TW columns
constexpr int TH = 8;    // by TH rows
constexpr int THREADS = BX * BY;
constexpr int CX = TW / BX;  // cells a thread along the row
constexpr int CY = TH / BY;  // and across the rows
static_assert(TW % BX == 0 && TH % BY == 0, "tile");

struct Params {
  float ox, oy, res, step, angle_min, min_range, max_range;
  float l_free, l_occ, l_clamp, enable;
};

__global__ void __launch_bounds__(THREADS)
    update_hybrid_kernel(const float* __restrict__ grid,
                         float* __restrict__ out,
                         const float* __restrict__ pose,
                         const float* __restrict__ ranges,
                         const float* __restrict__ angles, int H, int W,
                         int B, Params p) {
  extern __shared__ float smem[];
  float* rng = smem;        // [B] the scan
  float* rmin3 = smem + B;  // [B]
  __shared__ int count_s[TH * TW];
  __shared__ unsigned rmax_bits;
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int tr0 = blockIdx.y * TH, tc0 = blockIdx.x * TW;
  const int tr1 = min(tr0 + TH, H), tc1 = min(tc0 + TW, W);

  for (int i = tid; i < TH * TW; i += THREADS) count_s[i] = 0;
  for (int b = tid; b < B; b += THREADS) rng[b] = ranges[b];
  if (tid == 0) rmax_bits = 0u;
  const float px = pose[0], py = pose[1], pth = pose[2];
  const float inv_res = F_DIV(1.0f, p.res);  // x / res compiles as x * (1/res)
  // the tile's cells, in flight while the beams are sorted out
  float g[CY][CX];
#pragma unroll
  for (int y = 0; y < CY; ++y)
#pragma unroll
    for (int x = 0; x < CX; ++x) {
      const int row = tr0 + threadIdx.y + y * BY;
      const int col = tc0 + threadIdx.x + x * BX;
      g[y][x] = row < tr1 && col < tc1 ? grid[(size_t)row * W + col] : 0.0f;
    }
  __syncthreads();

  // beam tables, the largest rmin3, and the endpoints that land in the tile
  unsigned rmax = 0u;  // bits of a non-negative float order as the float
  for (int b = tid; b < B; b += THREADS) {
    float m = INFINITY;
    bool valid_b = false;
    for (int j = -1; j <= 1; ++j) {
      const float rk = rng[min(max(b + j, 0), B - 1)];
      const bool vk = rk > p.min_range && isfinite(rk);
      if (vk) m = fminf(m, clampf(rk, 0.0f, p.max_range));
      if (j == 0) valid_b = vk;
    }
    const float rm = valid_b ? m : -1.0f;
    rmin3[b] = rm;
    if (rm > 0.0f) rmax = max(rmax, __float_as_uint(rm));
    const float rb = rng[b];
    if (!(valid_b && rb < p.max_range)) continue;  // no hit
    const float r = clampf(rb, 0.0f, p.max_range);
    const float a = F_ADD(angles[b], pth);
    const float ey = F_SUB(F_ADD(py, F_MUL(sinf(a), r)), p.oy);
    const float ex = F_SUB(F_ADD(px, F_MUL(cosf(a), r)), p.ox);
    // integral floats: inside the tile exactly when equal to one of its
    // cells' (float)row and (float)col
    const float er = floorf(F_MUL(ey, inv_res));
    const float ec = floorf(F_MUL(ex, inv_res));
    if (er >= (float)tr0 && er < (float)tr1 && ec >= (float)tc0 &&
        ec < (float)tc1)
      atomicAdd(&count_s[((int)er - tr0) * TW + ((int)ec - tc0)], 1);
  }
  rmax = __reduce_max_sync(0xffffffffu, rmax);
  if ((tid & 31) == 0) atomicMax(&rmax_bits, rmax);
  __syncthreads();

  // every cell of the tile: free test, count, update, clip, write
  const float d_free = F_SUB(__uint_as_float(rmax_bits), p.res);
  const float half_slot = 0.5f * p.step;
#pragma unroll
  for (int y = 0; y < CY; ++y)
#pragma unroll
    for (int x = 0; x < CX; ++x) {
      const int row = tr0 + threadIdx.y + y * BY;
      const int col = tc0 + threadIdx.x + x * BX;
      if (row >= tr1 || col >= tc1) continue;
      const float cx =
          F_SUB(F_ADD(p.ox, F_MUL(F_ADD((float)col, 0.5f), p.res)), px);
      const float cy =
          F_SUB(F_ADD(p.oy, F_MUL(F_ADD((float)row, 0.5f), p.res)), py);
      const float d = __fsqrt_rn(F_ADD(F_MUL(cx, cx), F_MUL(cy, cy)));
      bool free_cell = false;
      if (d < d_free) {
        float phi = F_SUB(F_SUB(atan2f(cy, cx), pth), p.angle_min);
        phi = F_SUB(mod_pos(F_ADD(phi, PI_F), TWO_PI_F), PI_F);
        const float k0 = floorf(F_DIV(phi, p.step));
        for (int j = 0; j < 2; ++j) {
          const float k = F_ADD(k0, (float)j);
          if (k >= 0.0f && k <= (float)(B - 1)) {
            const int b = (int)k;
            const float ab = F_MUL((float)b, p.step);
            free_cell |= fabsf(F_SUB(phi, ab)) <= half_slot &&
                         d < F_SUB(rmin3[b], p.res);
          }
        }
      }
      const int count = count_s[(row - tr0) * TW + (col - tc0)];
      const float upd =
          F_MUL(F_ADD(F_MUL(p.l_free, free_cell ? 1.0f : 0.0f),
                      F_MUL(p.l_occ, (float)count)),
                p.enable);
      out[(size_t)row * W + col] =
          clampf(F_ADD(g[y][x], upd), -p.l_clamp, p.l_clamp);
    }
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
  const dim3 blocks((W + TW - 1) / TW, (H + TH - 1) / TH);
  const size_t smem = 2 * (size_t)B * sizeof(float);
  update_hybrid_kernel<<<blocks, block, smem, (cudaStream_t)stream>>>(
      grid, out, pose, ranges, angles, H, W, B, p);
  return (int)cudaGetLastError();
}

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
// of bf16 maps) the map traffic is 26 MB, 8 us at 3.35 TB/s, while a cell
// near the sensor costs an atan2f, a sqrt, a float modulo and IEEE
// divisions, and each block pays a prologue (the beam tables) behind
// barriers: it is bound by instruction issue and latency. Design: a block
// updates a TH x TW tile (128 x 16) of one particle's window (blockIdx.z),
// 8 cells a thread; it issues the loads of its cells first, then builds
// the beam tables (hit range, rmin3) from the scan staged in shared memory,
// once for the tile (in tiles of 32 x 8 cells, one a thread, that prologue
// alone took as long as a per-cell loop over the beams).
// - The occupied channel is scattered from the beams. By the triangle
//   inequality (a chord is no longer than its arc), a cell that beam b
//   marks has its center within |d - r_b| + d * tol <= 2 * occ_tol of b's
//   endpoint, whatever phi's wrap; so only the cells of a BOX x BOX box
//   around the endpoint (2 * occ_tol plus one cell of slack on each side)
//   can be marked by b. The beams whose box meets the tile are listed, and
//   the threads share their (beam, cell) pairs, each evaluating the
//   occupied predicate with the same float32 operations as the plain
//   version, into a mask of the tile in shared memory. The box is the
//   plain function ops/update.py:ism_occ_boxes. With l_occ == 0 (the
//   shared update's carve images) the channel is skipped: 0 * occ is 0
//   either way.
// - The free channel stays per cell: it checks only floor(phi/step) and
//   the beam after it (any other beam is a whole step away), and a cell at
//   d >= max_b rmin3[b] - res cannot be free, so it skips the bearing.
// - Every window cell is still read, clipped and written.
// The output is the same bits as a per-cell loop over every beam. The
// arithmetic follows the TPU kernel's float32 operations one by one
// (common.cuh); atan2f replaces its polynomial atan2 (|err| ~2e-8), which
// moves a cell on a beam slot's edge by one l_free or l_occ. Accumulation
// and the clamp run in float32; a bf16 map is rounded to nearest even once,
// at the store.
// A gate (the particle filter's device-gated step): when the device byte
// *gate is 0, every block returns before it touches memory, so the maps
// keep their bits; a null gate is always on.
//
// The frontend step's form (slam2d_update_ism_window, one map): the
// window's top-left cell (r0, c0) is read from device memory instead of
// computed from the pose, in the map when origin_in_map, else on the
// lattice alone (the map is then the window itself, the tiled frontend's
// window gathered from its tile pool), which places its float origin.

#include "common.cuh"

namespace {

constexpr int BX = 32;   // threads of a block along a row
constexpr int BY = 8;    // and across the rows
constexpr int TW = 128;  // a block's tile: TW columns
constexpr int TH = 16;   // by TH rows of one window
constexpr int BOX = 6;   // side of a beam's candidate box, cells
constexpr int THREADS = BX * BY;
constexpr int CX = TW / BX;  // cells a thread along the row
constexpr int CY = TH / BY;  // and across the rows
static_assert(TW % BX == 0 && TH % BY == 0 && (TW * TH) % 4 == 0, "tile");
static_assert(TW + BOX < 1024 && TH + BOX < 1024, "a box's packed corner");

struct Params {
  int H, W, Hr, Wr, B, occ_on;
  float gox, goy, res, inv_res, step, half_step, angle_min, min_range,
      max_range, occ_tol, l_free, l_occ, l_clamp, enable, box_half;
};

// A cell's center relative to the sensor and its range: the float32
// operations of the TPU kernel, shared by the occupied and free channels
__device__ __forceinline__ float cell_range(const Params& p, float ox,
                                            float oy, float px, float py,
                                            int row, int col, float* cx,
                                            float* cy) {
  *cx = F_SUB(F_ADD(ox, F_MUL(F_ADD((float)col, 0.5f), p.res)), px);
  *cy = F_SUB(F_ADD(oy, F_MUL(F_ADD((float)row, 0.5f), p.res)), py);
  return __fsqrt_rn(F_ADD(F_MUL(*cx, *cx), F_MUL(*cy, *cy)));
}

// its bearing relative to angle_min, wrapped to [-pi, pi)
__device__ __forceinline__ float cell_bearing(const Params& p, float cx,
                                              float cy, float pth) {
  const float phi = F_SUB(F_SUB(atan2f(cy, cx), pth), p.angle_min);
  return F_SUB(mod_pos(F_ADD(phi, PI_F), TWO_PI_F), PI_F);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    update_ism_kernel(T* __restrict__ maps, const float* __restrict__ poses,
                      const float* __restrict__ ranges,
                      const unsigned char* __restrict__ gate, Params p,
                      const int* __restrict__ origin, int origin_in_map) {
  if (gate != nullptr && *gate == 0) return;  // uniform: the whole grid
  extern __shared__ float smem[];
  float* rng = smem;                                    // [B] the scan
  float* r_hit = smem + p.B;                            // [B]
  float* rmin3 = smem + 2 * p.B;                        // [B]
  // [B] the listed beams: b, and their box's top-left cell relative to the
  // tile's, plus BOX, in bits 12-21 (row) and 22-31 (column)
  unsigned* cand = reinterpret_cast<unsigned*>(smem + 3 * p.B);
  __shared__ unsigned char occ_s[TH * TW];
  __shared__ int n_cand;
  __shared__ unsigned rmax_bits;
  const int tid = threadIdx.y * BX + threadIdx.x;
  const int part = blockIdx.z;
  const int tr0 = blockIdx.y * TH, tc0 = blockIdx.x * TW;
  const int tr1 = min(tr0 + TH, p.Hr), tc1 = min(tc0 + TW, p.Wr);

  for (int i = tid; i < TH * TW / 4; i += THREADS)
    reinterpret_cast<unsigned*>(occ_s)[i] = 0u;
  for (int b = tid; b < p.B; b += THREADS) rng[b] = ranges[b];
  if (tid == 0) {
    n_cand = 0;
    rmax_bits = 0u;
  }
  const float px = poses[3 * part], py = poses[3 * part + 1],
              pth = poses[3 * part + 2];
  // window origin: world_to_cell of the pose (x / res as x * (1/res), as
  // XLA compiles it), minus half the window, clamped into the map
  int r0, c0;
  if (origin != nullptr) {
    r0 = origin[0], c0 = origin[1];
  } else {
    const int cr = (int)floorf(F_MUL(F_SUB(py, p.goy), p.inv_res));
    const int cc = (int)floorf(F_MUL(F_SUB(px, p.gox), p.inv_res));
    r0 = min(max(cr - p.Hr / 2, 0), p.H - p.Hr);
    c0 = min(max(cc - p.Wr / 2, 0), p.W - p.Wr);
  }
  const float ox = F_ADD(p.gox, F_MUL((float)c0, p.res));
  const float oy = F_ADD(p.goy, F_MUL((float)r0, p.res));
  // the tile's map cells, in flight while the beams are sorted out
  T* base = maps + (size_t)part * p.H * p.W;
  if (origin == nullptr || origin_in_map) base += (size_t)r0 * p.W + c0;
  float g[CY][CX];
#pragma unroll
  for (int y = 0; y < CY; ++y)
#pragma unroll
    for (int x = 0; x < CX; ++x) {
      const int row = tr0 + threadIdx.y + y * BY;
      const int col = tc0 + threadIdx.x + x * BX;
      g[y][x] = row < tr1 && col < tc1 ? load_f32(base + (size_t)row * p.W + col)
                                       : 0.0f;
    }
  __syncthreads();

  // beam tables, the largest rmin3, and the beams whose box meets the tile
  unsigned rmax = 0u;  // bits of a non-negative float order as the float
  for (int b = tid; b < p.B; b += THREADS) {
    float m = INFINITY;
    bool valid_b = false;
    for (int j = -1; j <= 1; ++j) {
      const float rk = rng[min(max(b + j, 0), p.B - 1)];
      const bool vk = rk > p.min_range && isfinite(rk);
      if (vk) m = fminf(m, clampf(rk, 0.0f, p.max_range));
      if (j == 0) valid_b = vk;
    }
    const float rm = valid_b ? m : -1.0f;
    rmin3[b] = rm;
    if (rm > 0.0f) rmax = max(rmax, __float_as_uint(rm));
    const float rb = rng[b];
    const float rh = valid_b && rb < p.max_range ? clampf(rb, 0.0f, p.max_range)
                                                 : -1.0f;
    r_hit[b] = rh;
    // |d - rh| <= occ_tol needs rh >= -occ_tol, as d >= 0
    if (!p.occ_on || F_SUB(0.0f, rh) > p.occ_tol) continue;
    // the endpoint in window cells (cell col's center at col); any rounding
    // here is far inside the box's cell of slack
    float a = pth + p.angle_min + (float)b * p.step;
    a -= TWO_PI_F * rintf(a * (1.0f / TWO_PI_F));
    float sn, cs;
    __sincosf(a, &sn, &cs);
    const float ex = (px + rh * cs - ox) * p.inv_res - 0.5f;
    const float ey = (py + rh * sn - oy) * p.inv_res - 0.5f;
    const int lc = (int)ceilf(clampf(ex - p.box_half, -1e6f, 1e6f));
    const int lr = (int)ceilf(clampf(ey - p.box_half, -1e6f, 1e6f));
    if (lc < tc1 && lc + BOX > tc0 && lr < tr1 && lr + BOX > tr0)
      cand[atomicAdd(&n_cand, 1)] = (unsigned)b |
                                    (unsigned)(lr - tr0 + BOX) << 12 |
                                    (unsigned)(lc - tc0 + BOX) << 22;
  }
  rmax = __reduce_max_sync(0xffffffffu, rmax);
  if ((tid & 31) == 0) atomicMax(&rmax_bits, rmax);
  __syncthreads();

  // the occupied predicate on every (listed beam, box cell in the tile)
  const int n_pairs = n_cand * BOX * BOX;
  for (int i = tid; i < n_pairs; i += THREADS) {
    const int k = i / (BOX * BOX);
    const int j = i - k * (BOX * BOX);
    const unsigned e = cand[k];
    const int row = tr0 + (int)(e >> 12 & 1023u) - BOX + j / BOX;
    const int col = tc0 + (int)(e >> 22) - BOX + j % BOX;
    if (row < tr0 || row >= tr1 || col < tc0 || col >= tc1) continue;
    const int b = (int)(e & 4095u);
    float cx, cy;
    const float d = cell_range(p, ox, oy, px, py, row, col, &cx, &cy);
    const float phi = cell_bearing(p, cx, cy, pth);
    const float tol = F_DIV(p.occ_tol, fmaxf(d, 1e-6f));
    if (fabsf(F_SUB(phi, F_MUL((float)b, p.step))) <= tol &&
        fabsf(F_SUB(d, r_hit[b])) <= p.occ_tol)
      occ_s[(row - tr0) * TW + (col - tc0)] = 1;
  }
  __syncthreads();

  // every cell of the tile: free test, read, update, clip, write
  const float d_free = F_SUB(__uint_as_float(rmax_bits), p.res);
#pragma unroll
  for (int y = 0; y < CY; ++y)
#pragma unroll
    for (int x = 0; x < CX; ++x) {
      const int row = tr0 + threadIdx.y + y * BY;
      const int col = tc0 + threadIdx.x + x * BX;
      if (row >= tr1 || col >= tc1) continue;
      float cx, cy;
      const float d = cell_range(p, ox, oy, px, py, row, col, &cx, &cy);
      bool free_cell = false;
      if (d < d_free) {
        const float phi = cell_bearing(p, cx, cy, pth);
        const float k0 = floorf(F_DIV(phi, p.step));
        for (int j = 0; j < 2; ++j) {
          const float k = F_ADD(k0, (float)j);
          if (k >= 0.0f && k <= (float)(p.B - 1)) {
            const int b = (int)k;
            free_cell |=
                fabsf(F_SUB(phi, F_MUL((float)b, p.step))) <= p.half_step &&
                d < F_SUB(rmin3[b], p.res);
          }
        }
      }
      const bool occ = occ_s[(row - tr0) * TW + (col - tc0)] != 0;
      const float upd =
          F_MUL(F_ADD(F_MUL(p.l_free, free_cell ? 1.0f : 0.0f),
                      F_MUL(p.l_occ, occ ? 1.0f : 0.0f)),
                p.enable);
      store_f32(base + (size_t)row * p.W + col,
                clampf(F_ADD(g[y][x], upd), -p.l_clamp, p.l_clamp));
    }
}

int launch(void* maps, int is_bf16, const float* poses, const float* ranges,
           int P, int H, int W, int Hr, int Wr, int B, float gox, float goy,
           float res, float inv_res, float step, float half_step,
           float angle_min, float min_range, float max_range, float occ_tol,
           float l_free, float l_occ, float l_clamp, float enable,
           const int* origin, int origin_in_map, const unsigned char* gate,
           void* stream) {
  // the box holds 2 * occ_tol plus a cell on each side: fewer than BOX
  // cells' span while occ_tol < res (it is 0.75 res)
  const float box_half = 2.0f * occ_tol * inv_res + 1.0f;
  if (Hr > H || Wr > W || Hr < 1 || Wr < 1 || B < 1 ||
      !(2.0f * box_half < (float)BOX))
    return (int)cudaErrorInvalidValue;
  const Params p{H,        W,         Hr,        Wr,      B,
                 l_occ != 0.0f,
                 gox,      goy,       res,       inv_res, step,
                 half_step, angle_min, min_range, max_range, occ_tol,
                 l_free,   l_occ,     l_clamp,   enable,  box_half};
  const dim3 block(BX, BY);
  const dim3 blocks((Wr + TW - 1) / TW, (Hr + TH - 1) / TH, P);
  const size_t smem = 4 * (size_t)B * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    update_ism_kernel<__nv_bfloat16><<<blocks, block, smem, s>>>(
        (__nv_bfloat16*)maps, poses, ranges, gate, p, origin, origin_in_map);
  } else {
    update_ism_kernel<float><<<blocks, block, smem, s>>>(
        (float*)maps, poses, ranges, gate, p, origin, origin_in_map);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int slam2d_update_ism(void* maps, int is_bf16, const float* poses,
                                 const float* ranges, int P, int H, int W,
                                 int Hr, int Wr, int B, float gox, float goy,
                                 float res, float inv_res, float step,
                                 float half_step, float angle_min,
                                 float min_range, float max_range,
                                 float occ_tol, float l_free, float l_occ,
                                 float l_clamp, float enable,
                                 const unsigned char* gate, void* stream) {
  return launch(maps, is_bf16, poses, ranges, P, H, W, Hr, Wr, B, gox, goy,
                res, inv_res, step, half_step, angle_min, min_range,
                max_range, occ_tol, l_free, l_occ, l_clamp, enable, nullptr,
                1, gate, stream);
}

// One float32 map's h x w window at origin[0..1] (device int32), in place,
// when the device byte *gate (null: always) is not 0; with origin_in_map 0
// the map is the window (h = H, w = W) and origin its cell on the lattice
// of (gox, goy), which places its float origin.
extern "C" int slam2d_update_ism_window(
    float* map, const int* origin, int origin_in_map, const float* pose,
    const float* ranges, int H, int W, int h, int w, int B, float gox,
    float goy, float res, float inv_res, float step, float half_step,
    float angle_min, float min_range, float max_range, float occ_tol,
    float l_free, float l_occ, float l_clamp, float enable,
    const unsigned char* gate, void* stream) {
  if (origin == nullptr || (!origin_in_map && (h != H || w != W)))
    return (int)cudaErrorInvalidValue;
  return launch(map, 0, pose, ranges, 1, H, W, h, w, B, gox, goy, res,
                inv_res, step, half_step, angle_min, min_range, max_range,
                occ_tol, l_free, l_occ, l_clamp, enable, origin,
                origin_in_map, gate, stream);
}

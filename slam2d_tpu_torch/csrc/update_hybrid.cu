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
// is bound by instructions per cell (an arctangent, a sqrt, a float modulo), by
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
// - In place on a window of a larger map (slam2d_update_hybrid_window, the
//   frontend's step): the window's top-left cell (r0, c0) and a gate are
//   read from device memory, so the host never reads them. A gate of 0
//   returns every block before it touches memory. The float origin is
//   ox + (float)c0 * res, two roundings as grid/occupancy.py:
//   window_origin_xy makes it, so a cell's arithmetic is that of the
//   extracted window's. Writing in place is safe: a cell's new value is
//   clip(g + upd) of its own old value alone. With origin_in_map 0 the
//   array is itself the window (the tiled frontend's window gathered from
//   its tile pool): (r0, c0) is then the window's cell on the lattice of
//   (ox, oy), which places its float origin alone.
// - Every particle's window at once (slam2d_update_hybrid_particles, the
//   particle filter's update_impl="pallas_hybrid"): blockIdx.z is the
//   particle; its pose and its map are that particle's, and its window's
//   top-left cell is computed from its pose as update_ism.cu computes it
//   (the pose's cell minus half the window, clamped into the map), so the
//   cells get the bits of the single-map window form at that origin.
//   Float32 or bfloat16 maps: the arithmetic is float32, a bfloat16 cell
//   rounded once on the store. Its gate (the particle filter's
//   device-gated step) is read from device memory as the window form's.
// The TPU kernel's angular beam clip and range early-out only skip work and
// never change the result, so they are not carried over, nor is its padding
// of the beam table to a multiple of 8. The arithmetic follows the TPU
// kernel's float32 operations one by one (common.cuh). The cell centre is
// one FMA and the bearing the TPU kernel's own polynomial arctangent
// (atan2_ref), as XLA compiles them on the CPU, so a cell's bearing has the
// bits of the plain version on either device: with atan2f the card's
// bearing rounded otherwise than the CPU's, and one cell on a beam slot's
// edge parted the two runs of full SLAM's seed-4 log. cosf and sinf may
// differ from XLA's in the last bit, which moves an endpoint on a cell edge
// by one l_occ.

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

// grid and out may be one array (in place); `pitch` is their row length,
// (H, W) the updated window's size; `origin` (the window's top-left cell in
// the array, or with origin_in_map 0 on the lattice alone) and `gate` may
// be null: no offset, no gate. With map_rows > 0
// blockIdx.z picks a particle: its pose (pose + 3 z), its map of map_rows x
// pitch cells, and its window's origin computed from its pose (`origin` is
// then unused).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    update_hybrid_kernel(const T* grid, T* out, int pitch,
                         const int* __restrict__ origin,
                         int origin_in_map,
                         const unsigned char* __restrict__ gate,
                         const float* __restrict__ pose,
                         const float* __restrict__ ranges,
                         const float* __restrict__ angles, int H, int W,
                         int B, Params p, int map_rows) {
  if (gate != nullptr && *gate == 0) return;
  const float inv_res = F_DIV(1.0f, p.res);  // x / res compiles as x * (1/res)
  int r0 = 0, c0 = 0;
  if (map_rows > 0) {
    const size_t part = blockIdx.z;
    pose += 3 * part;
    grid += part * map_rows * pitch;
    out += part * map_rows * pitch;
    // world_to_cell of the pose, minus half the window, clamped
    const int cr = (int)floorf(F_MUL(F_SUB(pose[1], p.oy), inv_res));
    const int cc = (int)floorf(F_MUL(F_SUB(pose[0], p.ox), inv_res));
    r0 = min(max(cr - H / 2, 0), map_rows - H);
    c0 = min(max(cc - W / 2, 0), pitch - W);
  } else if (origin != nullptr) {
    r0 = origin[0], c0 = origin[1];
  }
  if (map_rows > 0 || origin != nullptr) {
    p.ox = F_ADD(p.ox, F_MUL((float)c0, p.res));
    p.oy = F_ADD(p.oy, F_MUL((float)r0, p.res));
    if (map_rows > 0 || origin_in_map) {
      const size_t base = (size_t)r0 * pitch + c0;
      grid += base;
      out += base;
    }
  }
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
  // the tile's cells, in flight while the beams are sorted out
  float g[CY][CX];
#pragma unroll
  for (int y = 0; y < CY; ++y)
#pragma unroll
    for (int x = 0; x < CX; ++x) {
      const int row = tr0 + threadIdx.y + y * BY;
      const int col = tc0 + threadIdx.x + x * BX;
      g[y][x] = row < tr1 && col < tc1
                    ? load_f32(grid + (size_t)row * pitch + col)
                    : 0.0f;
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
      const float cx = F_SUB(fmaf(F_ADD((float)col, 0.5f), p.res, p.ox), px);
      const float cy = F_SUB(fmaf(F_ADD((float)row, 0.5f), p.res, p.oy), py);
      const float d = __fsqrt_rn(F_ADD(F_MUL(cx, cx), F_MUL(cy, cy)));
      bool free_cell = false;
      if (d < d_free) {
        float phi = F_SUB(F_SUB(atan2_ref(cy, cx), pth), p.angle_min);
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
      store_f32(out + (size_t)row * pitch + col,
                clampf(F_ADD(g[y][x], upd), -p.l_clamp, p.l_clamp));
    }
}

template <typename T>
int launch(const T* grid, T* out, int pitch, const int* origin,
           int origin_in_map, const unsigned char* gate, const float* pose,
           const float* ranges,
           const float* angles, int H, int W, int B, const Params& p,
           void* stream, int particles = 1, int map_rows = 0) {
  const dim3 block(BX, BY);
  const dim3 blocks((W + TW - 1) / TW, (H + TH - 1) / TH, particles);
  const size_t smem = 2 * (size_t)B * sizeof(float);
  update_hybrid_kernel<T><<<blocks, block, smem, (cudaStream_t)stream>>>(
      grid, out, pitch, origin, origin_in_map, gate, pose, ranges, angles, H,
      W, B, p, map_rows);
  return (int)cudaGetLastError();
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
  return launch(grid, out, W, nullptr, 1, nullptr, pose, ranges, angles, H, W,
                B, p, stream);
}

// In place on the h x w window of the H x W map `map` whose top-left cell
// is origin[0..1] (device int32; null: the map's own cell (0, 0)), when the
// device byte *gate (null: always) is not 0; (ox, oy) is the map's origin.
// With origin_in_map 0 the map is the window (h = H, w = W) and origin is
// its cell on the lattice of (ox, oy), which places its float origin.
extern "C" int slam2d_update_hybrid_window(
    float* map, const int* origin, int origin_in_map,
    const unsigned char* gate,
    const float* pose, const float* ranges, const float* angles, int H, int W,
    int h, int w, int B, float ox, float oy, float res, float step,
    float angle_min, float min_range, float max_range, float l_free,
    float l_occ, float l_clamp, float enable, void* stream) {
  if (h < 1 || w < 1 || h > H || w > W ||
      (!origin_in_map && (h != H || w != W)))
    return (int)cudaErrorInvalidValue;
  const Params p{ox,     oy,    res,   step,    angle_min, min_range,
                 max_range, l_free, l_occ, l_clamp, enable};
  return launch(map, map, W, origin, origin_in_map, gate, pose, ranges,
                angles, h, w, B, p, stream);
}

// Every particle's window at once, in place: `maps` holds P maps of H x W
// (float32, or bfloat16 when is_bf16), `poses` P poses; particle z's h x w
// window is placed around poses[z] (its cell minus half the window,
// clamped into the map), when the device byte *gate (null: always) is not
// 0; (ox, oy) is the maps' origin.
extern "C" int slam2d_update_hybrid_particles(
    void* maps, int is_bf16, const float* poses, const float* ranges,
    const float* angles, int P, int H, int W, int h, int w, int B, float ox,
    float oy, float res, float step, float angle_min, float min_range,
    float max_range, float l_free, float l_occ, float l_clamp, float enable,
    const unsigned char* gate, void* stream) {
  if (h < 1 || w < 1 || h > H || w > W || P < 1 || P > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{ox,     oy,    res,   step,    angle_min, min_range,
                 max_range, l_free, l_occ, l_clamp, enable};
  if (is_bf16) {
    auto* m = (__nv_bfloat16*)maps;
    return launch(m, m, W, nullptr, 1, gate, poses, ranges, angles, h, w, B,
                  p, stream, P, H);
  }
  auto* m = (float*)maps;
  return launch(m, m, W, nullptr, 1, gate, poses, ranges, angles, h, w, B, p,
                stream, P, H);
}

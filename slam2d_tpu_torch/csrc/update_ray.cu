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
// cell; 9 rows of Bpad floats, Bpad a multiple of 8, the pad beams all zero
// weight with endpoints at -1e9) are those of the TPU kernel's wrapper
// (pallas_update.py:321-370). Every block builds them into shared memory
// from the pose, the ranges and the beam angles, with the float32
// operations of the plain version's ray_tables (ops/update.py) in the same
// order, so that one call is one device kernel.
//
// The sums follow the TPU kernel's grouping: chunks of 8 beams, each chunk
// summed from its first beam upward, each chunk's sum then added to the
// running total. As the TPU kernel does (pallas_update.py:141-174), a block
// adds only the chunks that can touch its tile: the tile's bearing interval
// seen from the sensor, widened by max(half a beam step, 0.75 res / d_min)
// + a quarter step, in chunks [c_lo, c_hi) (ray_chunk_bounds in
// ops/update.py is the same computation); none for a tile farther than the
// scan's largest valid range + 0.75 res; all for a tile within 2 res of the
// sensor (the TPU kernel's fallback is a tile holding the sensor; 2 res
// keeps the widening above the chord's reach, asin(res / (sqrt(2) d))).
// Every term of a skipped chunk is exactly zero, and adding zeros leaves a
// float sum as it was, so the clip changes no bit. Every float operation is
// written with the _rn intrinsics, so the kernel and its plain version agree
// bit for bit.
//
// Every particle's window at once (slam2d_update_ray_particles, the
// particle filter's update_impl="pallas_ray"): blockIdx.z is the particle;
// its pose and its map are that particle's, and its window's top-left cell
// is computed from its pose as update_ism.cu computes it (the pose's cell
// minus half the window, clamped into the map), the window's float origin
// ox + (float)c0 * res in two roundings, as grid/occupancy.py:
// window_origin_xy makes it. Float32 or bfloat16 maps: the arithmetic is
// float32, a bfloat16 cell rounded once on the store.
//
// In place on a window of one map (slam2d_update_ray_window, the frontend
// step's update_impl="pallas_ray"): the window's top-left cell (r0, c0)
// and a gate are read from device memory, as update_hybrid.cu's window
// form reads them: a gate of 0 returns every block before it touches
// memory; the float origin is ox + (float)c0 * res in two roundings. With
// origin_in_map 0 the array is itself the window (the tiled frontend's
// window gathered from its tile pool) and (r0, c0) places the float origin
// alone.
//
// What bounds it on the H100: at the frontend's 520^2 window the map is
// read and written once (2.2 MB, ~0.6 us at 3.35 TB/s) while each cell of a
// tile evaluates ~16 float operations for each beam of its chunks: it is
// bound by instructions, and below ~5 us by the launch itself. Design: one
// thread per cell, a block per TX x TY tile; the block stages the tables in
// shared memory, where every thread of a warp reads the same entry (a
// broadcast), and one thread finds the tile's chunks.

#include "common.cuh"

namespace {

constexpr int TX = 16;
constexpr int TY = 8;
constexpr int THREADS = TX * TY;
constexpr int UNROLL = 8;  // the TPU kernel's beam chunk (_UNROLL)

struct Params {
  float ox, oy, res, min_range, max_range, inv_samples, half_res, inv_res;
  float angle_min, step, l_free, l_occ, l_clamp, enable;
};

// a cell center's offset from the sensor along one axis
__device__ __forceinline__ float center(float o, float i, float res,
                                        float s) {
  return F_SUB(F_ADD(o, F_MUL(F_ADD(i, 0.5f), res)), s);
}

// [c_lo, c_hi) of the chunks that can touch the cell centers [x0, x1] x
// [y0, y1] (offsets from the sensor), as ray_chunk_bounds computes them
__device__ void chunk_bounds(float x0, float x1, float y0, float y1,
                             float theta, float rmax, int n_chunks,
                             int n_beams, const Params& p, int* lo, int* hi) {
  const float ex = x0 > 0.0f ? x0 : (x1 < 0.0f ? -x1 : 0.0f);
  const float ey = y0 > 0.0f ? y0 : (y1 < 0.0f ? -y1 : 0.0f);
  const float d_min = sqrtf(ex * ex + ey * ey);
  if (d_min > rmax + 0.75f * p.res) {  // beyond every beam: no chunk
    *lo = *hi = 0;
    return;
  }
  *lo = 0, *hi = n_chunks;
  if (d_min < 2.0f * p.res) return;  // at the sensor: every chunk
  // the tile subtends less than pi: its bearings relative to its center's
  const float mid = atan2f(0.5f * (y0 + y1), 0.5f * (x0 + x1));
  const float xs[2] = {x0, x1}, ys[2] = {y0, y1};
  float dlo = 0.0f, dhi = 0.0f;
  for (int i = 0; i < 4; ++i) {
    float d = atan2f(ys[i >> 1], xs[i & 1]) - mid;
    d = d > PI_F ? d - TWO_PI_F : (d < -PI_F ? d + TWO_PI_F : d);
    dlo = fminf(dlo, d), dhi = fmaxf(dhi, d);
  }
  if (dhi - dlo > PI_F) return;
  const float thr = fmaxf(0.5f * p.step, 0.75f * p.res / d_min) + 0.25f * p.step;
  // the interval relative to the first beam, its center in [0, 2 pi)
  float u = mid - theta - p.angle_min;
  u -= TWO_PI_F * floorf(u / TWO_PI_F);
  const float span = UNROLL * p.step;
  const float last = (n_beams - 1) * p.step;
  int found = 0;
  for (int k = -1; k <= 1; ++k) {  // the interval and its 2 pi turns
    const float a = u + dlo - thr + k * TWO_PI_F;
    const float b = u + dhi + thr + k * TWO_PI_F;
    if (b < 0.0f || a > last) continue;
    const int c_lo = max((int)floorf(a / span), 0);
    const int c_hi = min((int)floorf(b / span) + 1, n_chunks);
    if (c_hi <= c_lo) continue;
    *lo = c_lo, *hi = c_hi;
    ++found;
  }
  if (found == 0) *lo = *hi = 0;       // no beam looks this way
  else if (found > 1) *lo = 0, *hi = n_chunks;
}

// (H, W) is the updated window's size and `pitch` the maps' row length;
// grid and out may be one array (in place). With map_rows > 0 blockIdx.z
// picks a particle: its pose (pose + 3 z), its map of map_rows x pitch
// cells, and its window placed around its pose. Else a non-null `origin`
// is the window's top-left cell, in the array when origin_in_map, else on
// the lattice alone.
template <typename T>
__global__ void __launch_bounds__(THREADS)
update_ray_kernel(const T* grid, T* out, int pitch,
                  const float* __restrict__ pose,
                  const float* __restrict__ ranges,
                  const float* __restrict__ angles,
                  const unsigned char* __restrict__ gate, int H, int W, int B,
                  int Bpad, Params p, int map_rows,
                  const int* __restrict__ origin, int origin_in_map) {
  if (gate != nullptr && *gate == 0) return;  // uniform: the whole grid
  if (map_rows > 0) {
    const size_t part = blockIdx.z;
    pose += 3 * part;
    grid += part * map_rows * pitch;
    out += part * map_rows * pitch;
    // world_to_cell of the pose, minus half the window, clamped
    const int cr = (int)floorf(F_MUL(F_SUB(pose[1], p.oy), p.inv_res));
    const int cc = (int)floorf(F_MUL(F_SUB(pose[0], p.ox), p.inv_res));
    const int r0 = min(max(cr - H / 2, 0), map_rows - H);
    const int c0 = min(max(cc - W / 2, 0), pitch - W);
    p.ox = F_ADD(p.ox, F_MUL((float)c0, p.res));
    p.oy = F_ADD(p.oy, F_MUL((float)r0, p.res));
    const size_t base = (size_t)r0 * pitch + c0;
    grid += base;
    out += base;
  } else if (origin != nullptr) {
    const int r0 = origin[0], c0 = origin[1];
    p.ox = F_ADD(p.ox, F_MUL((float)c0, p.res));
    p.oy = F_ADD(p.oy, F_MUL((float)r0, p.res));
    if (origin_in_map) {
      const size_t base = (size_t)r0 * pitch + c0;
      grid += base;
      out += base;
    }
  }
  extern __shared__ float tab[];  // [9, Bpad]
  __shared__ float warp_rmax[THREADS / 32];
  __shared__ int chunks[2];
  float* dxs = tab;
  float* dys = tab + Bpad;
  float* ws = tab + 2 * Bpad;
  float* cms = tab + 3 * Bpad;
  float* hfs = tab + 4 * Bpad;
  float* ias = tab + 5 * Bpad;
  float* rfs = tab + 6 * Bpad;
  float* ers = tab + 7 * Bpad;
  float* ecs = tab + 8 * Bpad;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const float px = pose[0], py = pose[1], theta = pose[2];
  const float res = p.res;

  // the beam tables (ray_tables), and the largest valid range
  float rmax = -1.0f;
  for (int b = tid; b < Bpad; b += THREADS) {
    if (b >= B) {
      dxs[b] = dys[b] = ws[b] = cms[b] = hfs[b] = ias[b] = rfs[b] = 0.0f;
      ers[b] = ecs[b] = (float)-1e9;
      continue;
    }
    const float rg = ranges[b];
    const float r = clampf(rg, 0.0f, p.max_range);
    const bool valid = rg > p.min_range && isfinite(rg);
    const bool hit = valid && rg < p.max_range;
    const float a = F_ADD(angles[b], theta);
    const float dx = cosf(a), dy = sinf(a);
    const float rf = F_MUL(fmaxf(F_SUB(r, res), 0.0f), valid ? 1.0f : 0.0f);
    const float spacing = F_MUL(rf, p.inv_samples);
    const float adx = fabsf(dx), ady = fabsf(dy);
    const float amax = fmaxf(adx, ady), amin = fminf(adx, ady);
    const float ec = floorf(F_MUL(F_SUB(F_ADD(px, F_MUL(dx, r)), p.ox), p.inv_res));
    const float er = floorf(F_MUL(F_SUB(F_ADD(py, F_MUL(dy, r)), p.oy), p.inv_res));
    dxs[b] = dx;
    dys[b] = dy;
    ws[b] = F_DIV(valid ? 1.0f : 0.0f, fmaxf(spacing, res));
    cms[b] = F_DIV(res, fmaxf(amax, (float)1e-6));
    hfs[b] = F_MUL(p.half_res, F_ADD(adx, ady));
    ias[b] = F_DIV(1.0f, fmaxf(F_MUL(amax, amin), (float)1e-9));
    rfs[b] = rf;
    ers[b] = hit ? er : (float)-1e9;
    ecs[b] = hit ? ec : (float)-1e9;
    if (valid) rmax = fmaxf(rmax, r);
  }
  for (int o = 16; o > 0; o >>= 1)
    rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
  if ((tid & 31) == 0) warp_rmax[tid >> 5] = rmax;
  __syncthreads();  // the tables and the warps' largest ranges

  const int x0 = blockIdx.x * TX, y0 = blockIdx.y * TY;
  if (tid == 0) {
    for (int k = 0; k < THREADS / 32; ++k) rmax = fmaxf(rmax, warp_rmax[k]);
    const int x1 = min(x0 + TX, W) - 1, y1 = min(y0 + TY, H) - 1;
    chunk_bounds(center(p.ox, (float)x0, res, px),
                 center(p.ox, (float)x1, res, px),
                 center(p.oy, (float)y0, res, py),
                 center(p.oy, (float)y1, res, py), theta, rmax, Bpad / UNROLL,
                 B, p, &chunks[0], &chunks[1]);
  }
  __syncthreads();
  const int c_lo = chunks[0], c_hi = chunks[1];

  const int col = x0 + threadIdx.x;
  const int row = y0 + threadIdx.y;
  if (row >= H || col >= W) return;
  const float fr = (float)row;
  const float fc = (float)col;
  const float cx = center(p.ox, fc, res, px);
  const float cy = center(p.oy, fr, res, py);

  float free_sum = 0.0f, occ_sum = 0.0f;
  for (int b0 = c_lo * UNROLL; b0 < c_hi * UNROLL; b0 += UNROLL) {
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
  const size_t i = (size_t)row * pitch + col;
  store_f32(out + i, clampf(F_ADD(load_f32(grid + i), upd), -p.l_clamp,
                            p.l_clamp));
}

template <typename T>
int launch(const T* grid, T* out, int pitch, const float* pose,
           const float* ranges, const float* angles, int H, int W, int B,
           const Params& p, void* stream, int particles = 1,
           int map_rows = 0, const unsigned char* gate = nullptr,
           const int* origin = nullptr, int origin_in_map = 1) {
  if (H < 1 || W < 1 || B < 1 || B > 1360 || particles < 1 ||
      particles > 65535)
    return (int)cudaErrorInvalidValue;
  const int Bpad = (B + UNROLL - 1) / UNROLL * UNROLL;
  const dim3 block(TX, TY);
  const dim3 blocks((W + TX - 1) / TX, (H + TY - 1) / TY, particles);
  const size_t smem = 9 * (size_t)Bpad * sizeof(float);
  update_ray_kernel<T><<<blocks, block, smem, (cudaStream_t)stream>>>(
      grid, out, pitch, pose, ranges, angles, gate, H, W, B, Bpad, p,
      map_rows, origin, origin_in_map);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int slam2d_update_ray(const float* grid, float* out,
                                 const float* pose, const float* ranges,
                                 const float* angles, int H, int W, int B,
                                 float ox, float oy, float res,
                                 float min_range, float max_range,
                                 float inv_samples, float half_res,
                                 float inv_res, float angle_min, float step,
                                 float l_free, float l_occ, float l_clamp,
                                 float enable, void* stream) {
  const Params p{ox,      oy,        res,  min_range, max_range,
                 inv_samples, half_res, inv_res, angle_min, step,
                 l_free,  l_occ,     l_clamp, enable};
  return launch(grid, out, W, pose, ranges, angles, H, W, B, p, stream);
}

// In place on the h x w window of the H x W map `map` whose top-left cell
// is origin[0..1] (device int32; null: the map's own cell (0, 0)), when the
// device byte *gate (null: always) is not 0; (ox, oy) is the map's origin.
// With origin_in_map 0 the map is the window (h = H, w = W) and origin is
// its cell on the lattice of (ox, oy), which places its float origin.
extern "C" int slam2d_update_ray_window(
    float* map, const int* origin, int origin_in_map,
    const unsigned char* gate, const float* pose, const float* ranges,
    const float* angles, int H, int W, int h, int w, int B, float ox,
    float oy, float res, float min_range, float max_range, float inv_samples,
    float half_res, float inv_res, float angle_min, float step, float l_free,
    float l_occ, float l_clamp, float enable, void* stream) {
  if (h < 1 || w < 1 || h > H || w > W ||
      (!origin_in_map && (h != H || w != W)))
    return (int)cudaErrorInvalidValue;
  const Params p{ox,      oy,        res,  min_range, max_range,
                 inv_samples, half_res, inv_res, angle_min, step,
                 l_free,  l_occ,     l_clamp, enable};
  return launch(map, map, W, pose, ranges, angles, h, w, B, p, stream, 1, 0,
                gate, origin, origin_in_map);
}

// Every particle's window at once, in place: `maps` holds P maps of H x W
// (float32, or bfloat16 when is_bf16), `poses` P poses; particle z's h x w
// window is placed around poses[z] (its cell minus half the window,
// clamped into the map), when the device byte *gate (null: always) is not
// 0 (the particle filter's device-gated step: every block returns at once
// on 0, so the maps keep their bits); (ox, oy) is the maps' origin.
extern "C" int slam2d_update_ray_particles(
    void* maps, int is_bf16, const float* poses, const float* ranges,
    const float* angles, int P, int H, int W, int h, int w, int B, float ox,
    float oy, float res, float min_range, float max_range,
    float inv_samples, float half_res, float inv_res, float angle_min,
    float step, float l_free, float l_occ, float l_clamp, float enable,
    const unsigned char* gate, void* stream) {
  if (h > H || w > W) return (int)cudaErrorInvalidValue;
  const Params p{ox,      oy,        res,  min_range, max_range,
                 inv_samples, half_res, inv_res, angle_min, step,
                 l_free,  l_occ,     l_clamp, enable};
  if (is_bf16) {
    auto* m = (__nv_bfloat16*)maps;
    return launch(m, m, W, poses, ranges, angles, h, w, B, p, stream, P, H,
                  gate);
  }
  auto* m = (float*)maps;
  return launch(m, m, W, poses, ranges, angles, h, w, B, p, stream, P, H,
                gate);
}

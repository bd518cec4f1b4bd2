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
// written with the _rn intrinsics or fmaf, so the kernel and its plain
// version agree bit for bit; the FMAs are those XLA contracts on the CPU
// (the cell centre, t and ct, the chunk sums), which gives the TPU kernel's
// bits in interpret mode. The tile clip's atan2f decides no cell's value.
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
//
// Every particle's window at once (slam2d_update_ray_particles, the
// particle filter's update_impl="pallas_ray"), in place: particle z's pose
// and map are its own, its window's top-left cell is computed from its
// pose as update_ism.cu computes it (the pose's cell minus half the window,
// clamped into the map) and the window's float origin is ox + (float)c0 *
// res in two roundings, as grid/occupancy.py:window_origin_xy makes it.
// Float32 or bfloat16 maps: the arithmetic is float32, a bfloat16 cell
// rounded once on the store. What bounds it: at FastSLAM-16's [16, 496^2]
// float32 windows every window is read and written once (31.5 MB, 9.4 us at
// 3.35 TB/s), but a cell takes ~16 operations for each beam it sums, so the
// beams a cell sums set its time. The single-window kernel's design cost
// three times over here: 30,752 blocks of 128 cells each built the
// particle's nine tables again (a sinf, a cosf and three divisions a beam);
// each summed whole chunks of 8 beams (8-16 beams a cell, where 1-3 cross a
// cell a few metres out); its thread 0 found the chunks alone; a thread
// moved one cell; and a gate of 0 still launched every block. Design:
// - A persistent grid: (blocks a particle, P), the card's resident blocks
//   in all. A block builds its particle's tables in shared memory once (the
//   operations of the single-window kernel's prologue), then each warp
//   takes PATCH x PATCH patches of the window in turn (common.cuh:
//   PatchCells), a thread 4 float32 or 8 bfloat16 cells of a row in one
//   16-byte vector load and store, the next patch's loads issued before
//   the current patch is summed (the first patch's before the tables are
//   built). A gate of 0 returns one small grid.
// - Each thread finds the beams of its cells itself, by strips of STRIP
//   cells (strip_beams: the strip's bearing interval, from one atan2f,
//   widened by the reach of a chord or an endpoint; ray_strip_beams in
//   ops/update.py is the same computation), and within that range skips
//   each beam whose reach r_free + 2 res stops short of the strip: a few
//   beams a strip a few metres out, where the single-window kernel's tile
//   took 8-16. It sums those beams in order with the chunk chain kept
//   exact: a skipped term is exactly zero and fma(w, 0, s) == s, so a
//   chunk's first kept beam k starts its sum as w_k c_k rounded once, a
//   later one adds fma(w_k, c_k, sum), beams 0 and 1 both kept start it
//   fma(w0, c0, w1 c1) as the single-window kernel does, and a chunk with
//   no kept beam adds nothing. The endpoint marks are small integers,
//   exact in any order. Near the sensor every beam that can touch a cell
//   is summed (the single-window kernel's full sum, not the TPU kernel's
//   clip, which drops some chords there).
// - The strips within NEAR cells of the sensor's take up to every beam:
//   summed by one thread, they set the slowest warp's time (0.18 ms at [16,
//   496^2] against 0.05 with their ranges cut to 24 beams). So a warp sums
//   each of them cooperatively: lane 8 v + j takes cell v and chunk c + j
//   of the strip's range, the whole chunk's chain as the single-window
//   kernel sums it, and the chunk sums of a cell are added in order
//   through shuffles. The particle's warps share these strips out before
//   their patches, and the patch loop leaves their vectors alone.
// What bounds it now (H100, scripts/tune_kernel.sh update_ray): 0.049 ms
// at [16, 496^2] float32, 19% of the bound, against 0.100 before; with
// every strip's beams cut to none it takes 0.012 (the memory, the tables,
// the launch). The rest is instructions: a strip's range holds about
// twice the beams that cross one of its cells (the strip's own length),
// and a warp runs as long as its longest lane's range. Skipping the beams
// whose line misses a strip's cells gained 3% at two shapes and lost 3% at
// the third; it is not kept.

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

// a cell center's offset from the sensor along one axis, o + (i + 0.5) res
// one FMA as XLA contracts it
__device__ __forceinline__ float center(float o, float i, float res,
                                        float s) {
  return F_SUB(fmaf(F_ADD(i, 0.5f), res, o), s);
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

// The beam tables (ray_tables) into tab [9, Bpad], beam b by thread b mod
// `threads`, with (p.ox, p.oy) the window's origin; returns the largest
// valid range among this thread's beams (-1: none)
__device__ __forceinline__ float build_tables(float* tab, int B, int Bpad,
                                              const float* ranges,
                                              const float* angles, float px,
                                              float py, float theta,
                                              const Params& p, int tid,
                                              int threads) {
  float* dxs = tab;
  float* dys = tab + Bpad;
  float* ws = tab + 2 * Bpad;
  float* cms = tab + 3 * Bpad;
  float* hfs = tab + 4 * Bpad;
  float* ias = tab + 5 * Bpad;
  float* rfs = tab + 6 * Bpad;
  float* ers = tab + 7 * Bpad;
  float* ecs = tab + 8 * Bpad;
  const float res = p.res;
  float rmax = -1.0f;
  for (int b = tid; b < Bpad; b += threads) {
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
  return rmax;
}

// The chord of a beam through the cell at (cx, cy) from the sensor, with
// cy*dy and cy*dx given (a row's cells share them)
__device__ __forceinline__ float chord_of(float cx, float cydy, float cydx,
                                          float dx, float dy, float cm,
                                          float hf, float ia, float rf) {
  // t = cx*dx + cy*dy and cx*dy - cy*dx, each one FMA over the second
  // product, as XLA contracts them
  const float t = fmaf(cx, dx, cydy);
  const float ct = fabsf(fmaf(cx, dy, -cydx));
  const float L = fmaxf(fminf(cm, F_MUL(F_SUB(hf, ct), ia)), 0.0f);
  const float Lh = F_MUL(0.5f, L);
  return fmaxf(F_SUB(fminf(F_ADD(t, Lh), rf), fmaxf(F_SUB(t, Lh), 0.0f)),
               0.0f);
}

// (H, W) is the updated window's size and `pitch` the map's row length;
// grid and out may be one array (in place). A non-null `origin` is the
// window's top-left cell, in the array when origin_in_map, else on the
// lattice alone.
template <typename T>
__global__ void __launch_bounds__(THREADS)
update_ray_kernel(const T* grid, T* out, int pitch,
                  const float* __restrict__ pose,
                  const float* __restrict__ ranges,
                  const float* __restrict__ angles,
                  const unsigned char* __restrict__ gate, int H, int W, int B,
                  int Bpad, Params p, const int* __restrict__ origin,
                  int origin_in_map) {
  if (gate != nullptr && *gate == 0) return;  // uniform: the whole grid
  if (origin != nullptr) {
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
  const float* dxs = tab;
  const float* dys = tab + Bpad;
  const float* ws = tab + 2 * Bpad;
  const float* cms = tab + 3 * Bpad;
  const float* hfs = tab + 4 * Bpad;
  const float* ias = tab + 5 * Bpad;
  const float* rfs = tab + 6 * Bpad;
  const float* ers = tab + 7 * Bpad;
  const float* ecs = tab + 8 * Bpad;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const float px = pose[0], py = pose[1], theta = pose[2];
  const float res = p.res;

  // the beam tables (ray_tables), and the largest valid range
  float rmax = build_tables(tab, B, Bpad, ranges, angles, px, py, theta, p,
                            tid, THREADS);
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
    float fa = 0.0f, oa = 0.0f, w0 = 0.0f, chord0 = 0.0f;
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int b = b0 + k;
      const float chord = chord_of(cx, F_MUL(cy, dys[b]), F_MUL(cy, dxs[b]),
                                   dxs[b], dys[b], cms[b], hfs[b], ias[b],
                                   rfs[b]);
      // chunk sums start from the chunk's first beam, w0 c0 + w1 c1 + ...,
      // XLA's contraction: fma(w0, c0, w1 c1), then fma(wk, ck, sum)
      if (k == 0) {
        w0 = ws[b], chord0 = chord;
      } else {
        fa = k == 1 ? fmaf(w0, chord0, F_MUL(ws[b], chord))
                    : fmaf(ws[b], chord, fa);
      }
      const float o = (ers[b] == fr && ecs[b] == fc) ? 1.0f : 0.0f;
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
           const Params& p, void* stream, const unsigned char* gate = nullptr,
           const int* origin = nullptr, int origin_in_map = 1) {
  if (H < 1 || W < 1 || B < 1 || B > 1360) return (int)cudaErrorInvalidValue;
  const int Bpad = (B + UNROLL - 1) / UNROLL * UNROLL;
  const dim3 block(TX, TY);
  const dim3 blocks((W + TX - 1) / TX, (H + TY - 1) / TY);
  const size_t smem = 9 * (size_t)Bpad * sizeof(float);
  update_ray_kernel<T><<<blocks, block, smem, (cudaStream_t)stream>>>(
      grid, out, pitch, pose, ranges, angles, gate, H, W, B, Bpad, p, origin,
      origin_in_map);
  return (int)cudaGetLastError();
}

// ---- every particle's window at once -------------------------------------

constexpr int STRIP = 4;  // cells a thread sums together: a beam range each
constexpr int NEAR = 12;  // the near square's half side, cells (header)
static_assert(STRIP * 8 == 32, "a lane a (cell, chunk) of a near strip");

// floor(a / b) for b > 0
__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((b - 1 - a) / b);
}

// [*lo, *hi) holds every beam that can add a chord to, or mark, a cell of
// the strip of STRIP cells whose centres lie at x0 .. x1 (x1 - x0 =
// (STRIP - 1) res), y from the sensor, cells at least d_min away: the
// strip's bearings lie within asin(hl / d_min) of its middle's (hl its
// half length, d_min > hl), and a beam that touches a cell at distance d
// lies within asin(0.75 res / d) of the cell's bearing (its chord needs
// |ct| < half <= res / sqrt 2; its endpoint cell's centre lies within res /
// sqrt 2 of the endpoint); asin(x) <= 1.0473 x for x <= 0.5, plus a quarter
// step for the rounding of atan2f. ray_strip_beams in ops/update.py is
// the same computation.
__device__ __forceinline__ void strip_beams(float x0, float x1, float y,
                                            float d_min, float theta,
                                            int B, const Params& p, int* lo,
                                            int* hi) {
  *lo = 0, *hi = B;
  const float hl = 0.5f * (x1 - x0);
  const float a1 = hl / d_min, a2 = 0.75f * p.res / d_min;
  if (a1 >= 1.0f || a2 >= 1.0f) return;  // at the sensor: every beam
  const float alpha = (a1 <= 0.5f ? 1.0473f * a1 : asinf(a1)) +
                      (a2 <= 0.5f ? 1.0473f * a2 : asinf(a2)) +
                      0.25f * p.step;
  if (alpha >= PI_F) return;
  float u = atan2f(y, 0.5f * (x0 + x1)) - theta - p.angle_min;
  u -= TWO_PI_F * floorf(u / TWO_PI_F);  // in [0, 2 pi)
  const float last = (B - 1) * p.step;
  int b_lo = B, b_hi = 0;
  for (int k = -1; k <= 1; ++k) {  // the interval and its 2 pi turns
    const float a = u - alpha + k * TWO_PI_F, b = u + alpha + k * TWO_PI_F;
    if (b < 0.0f || a > last) continue;
    b_lo = min(b_lo, max((int)floorf(a / p.step), 0));
    b_hi = max(b_hi, min((int)floorf(b / p.step) + 1, B));
  }
  *lo = b_lo, *hi = max(b_hi, b_lo);
}

// Sum particle `part`'s window, a warp a patch and a thread its strips (the
// header's design): `maps` holds the particles' maps of map_rows x pitch
// cells, (H, W) is the window's size; `vec`: the maps allow 16-byte vector
// access.
template <typename T>
__global__ void __launch_bounds__(PT, 4)  // 64 registers: 32 warps an SM
update_ray_particles_kernel(T* maps, int pitch, int map_rows,
                            const float* __restrict__ poses,
                            const float* __restrict__ ranges,
                            const float* __restrict__ angles,
                            const unsigned char* __restrict__ gate, int H,
                            int W, int B, int Bpad, Params p, int vec) {
  using C = PatchCells<T>;
  constexpr int V = C::V, TPR = C::TPR, RPP = C::RPP, RY = C::RY;
  static_assert(V % STRIP == 0, "strips");
  if (gate != nullptr && *gate == 0) return;  // uniform: the whole grid
  const int part = blockIdx.y;
  const float px = poses[3 * part], py = poses[3 * part + 1];
  const float theta = poses[3 * part + 2];
  // world_to_cell of the pose, minus half the window, clamped
  const int cr = (int)floorf(F_MUL(F_SUB(py, p.oy), p.inv_res));
  const int cc = (int)floorf(F_MUL(F_SUB(px, p.ox), p.inv_res));
  const int r0 = min(max(cr - H / 2, 0), map_rows - H);
  const int c0 = min(max(cc - W / 2, 0), pitch - W);
  p.ox = F_ADD(p.ox, F_MUL((float)c0, p.res));
  p.oy = F_ADD(p.oy, F_MUL((float)r0, p.res));
  T* win = maps + ((size_t)part * map_rows + r0) * pitch + c0;
  // the patches start at the vector that holds the window's first column
  const int base_col = c0 / V * V - c0;
  const int n_pc = (W - base_col + PATCH - 1) / PATCH;
  const int n_patches = (H + PATCH - 1) / PATCH * n_pc;
  const int lane = threadIdx.x & 31;
  const int tx = lane % TPR, ty = lane / TPR;
  // the particle's warps in the order warp-major, so that a block's warps
  // take patches strided over the window (its work then averages out)
  const int stride = gridDim.x * PWARPS;
  const int first = (threadIdx.x >> 5) * gridDim.x + blockIdx.x;
  int patch = first;

  // The near square: the window's rows within NEAR of the sensor's and its
  // map vectors within NEAR columns, whole. Its strips take up to every
  // beam, so a warp sums each of them cooperatively, a lane a (cell,
  // chunk), and the particle's warps share them out; the patch loop skips
  // their vectors.
  const int sr = cr - r0, sc = cc - c0;  // the sensor's cell in the window
  const int nr_lo = max(sr - NEAR, 0), nr_hi = min(sr + NEAR, H - 1);
  const int nv_lo = max(floor_div(c0 + sc - NEAR, V), c0 / V);
  const int nv_hi = min(floor_div(c0 + sc + NEAR, V), (c0 + W - 1) / V);
  const int n_vec = max(nv_hi - nv_lo + 1, 0);
  auto near = [&](int row, int col) {
    const int vec_i = (c0 + col) / V;
    return row >= nr_lo && row <= nr_hi && vec_i >= nv_lo && vec_i <= nv_hi;
  };

  // this thread's cells of a patch: rows row0 + ry RPP + ty, columns
  // col0 + tx V + v
  auto cells = [&](int patch, int* row0, int* col0) {
    const int pr = patch / n_pc;
    *row0 = pr * PATCH + ty;
    *col0 = base_col + (patch - pr * n_pc) * PATCH + tx * V;
  };
  auto load = [&](int patch, float (&g)[RY][V]) {
    int row, col;
    cells(patch, &row, &col);
#pragma unroll
    for (int ry = 0; ry < RY; ++ry, row += RPP)
      load_cells(win + (ptrdiff_t)row * pitch + col,
                 row < H && !near(row, col), col, W, vec, g[ry]);
  };
  float g[RY][V];
  if (patch < n_patches) load(patch, g);  // in flight while the tables build

  extern __shared__ float tab[];  // [9, Bpad]
  __shared__ float warp_rmax[PWARPS];
  float rmax = build_tables(tab, B, Bpad, ranges, angles, px, py, theta, p,
                            threadIdx.x, PT);
  for (int o = 16; o > 0; o >>= 1)
    rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
  if (lane == 0) warp_rmax[threadIdx.x >> 5] = rmax;
  __syncthreads();  // the tables and the warps' largest ranges
  for (int k = 0; k < PWARPS; ++k) rmax = fmaxf(rmax, warp_rmax[k]);
  const float* dxs = tab;
  const float* dys = tab + Bpad;
  const float* ws = tab + 2 * Bpad;
  const float* cms = tab + 3 * Bpad;
  const float* hfs = tab + 4 * Bpad;
  const float* ias = tab + 5 * Bpad;
  const float* rfs = tab + 6 * Bpad;
  const float* ers = tab + 7 * Bpad;
  const float* ecs = tab + 8 * Bpad;
  const float res = p.res, two_res = 2.0f * p.res;

  // the near square's strips, a warp each
  const int n_near = max(nr_hi - nr_lo + 1, 0) * n_vec * (V / STRIP);
  for (int i = first; i < n_near; i += stride) {
    const int per_row = n_vec * (V / STRIP);
    const int row = nr_lo + i / per_row, k = i % per_row;
    const int col = (nv_lo + k / (V / STRIP)) * V - c0 + k % (V / STRIP) * STRIP;
    const float fr = (float)row;
    const float cy = center(p.oy, fr, res, py);
    const float x0 = center(p.ox, (float)col, res, px);
    const float x1 = center(p.ox, (float)(col + STRIP - 1), res, px);
    const float ex = x0 > 0.0f ? x0 : (x1 < 0.0f ? -x1 : 0.0f);
    const float d_min = sqrtf(ex * ex + cy * cy);
    int b_lo = 0, b_hi = 0;
    if (d_min <= rmax + two_res)
      strip_beams(x0, x1, cy, d_min, theta, B, p, &b_lo, &b_hi);
    // lane 8 v + j: cell v of the strip, chunk c + j of each round of 8
    const int v = lane >> 3, j = lane & 7;
    const float fc = (float)(col + v);
    const float cx = center(p.ox, fc, res, px);
    float free_sum = 0.0f, occ_sum = 0.0f;
    for (int c = b_lo / UNROLL; c * UNROLL < b_hi; c += 8) {
      float fa = 0.0f, oa = 0.0f;
      if ((c + j) * UNROLL < b_hi) {  // the chunk's whole chain
        float w0 = 0.0f, chord0 = 0.0f;
#pragma unroll
        for (int kk = 0; kk < UNROLL; ++kk) {
          const int b = (c + j) * UNROLL + kk;
          const float chord = chord_of(cx, F_MUL(cy, dys[b]), F_MUL(cy, dxs[b]),
                                       dxs[b], dys[b], cms[b], hfs[b], ias[b],
                                       rfs[b]);
          if (kk == 0)
            w0 = ws[b], chord0 = chord;
          else
            fa = kk == 1 ? fmaf(w0, chord0, F_MUL(ws[b], chord))
                         : fmaf(ws[b], chord, fa);
          oa = F_ADD(oa, (ers[b] == fr && ecs[b] == fc) ? 1.0f : 0.0f);
        }
      }
      // cell v's chunk sums, in order
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const float st = __shfl_sync(0xffffffffu, fa, (v << 3) + t);
        const float ot = __shfl_sync(0xffffffffu, oa, (v << 3) + t);
        if ((c + t) * UNROLL < b_hi) {
          free_sum = F_ADD(free_sum, st);
          occ_sum = F_ADD(occ_sum, ot);
        }
      }
    }
    if (j == 0 && row < H && col + v >= 0 && col + v < W) {
      T* cell = win + (ptrdiff_t)row * pitch + col + v;
      const float upd = F_MUL(
          F_ADD(F_MUL(p.l_free, free_sum), F_MUL(p.l_occ, occ_sum)), p.enable);
      store_f32(cell, clampf(F_ADD(load_f32(cell), upd), -p.l_clamp,
                             p.l_clamp));
    }
  }

  for (; patch < n_patches; patch += stride) {
    float gn[RY][V];
    if (patch + stride < n_patches) load(patch + stride, gn);
    int row, col;
    cells(patch, &row, &col);
#pragma unroll
    for (int ry = 0; ry < RY; ++ry) {
      const int r = row + ry * RPP;
      const bool mine = r < H && !near(r, col);  // the near pass has the rest
      const float fr = (float)r;
      const float cy = center(p.oy, fr, res, py);
#pragma unroll
      for (int s = 0; s < V; s += STRIP) {
        float cx[STRIP], fsum[STRIP], fa[STRIP], occ[STRIP];
#pragma unroll
        for (int v = 0; v < STRIP; ++v) {
          cx[v] = center(p.ox, (float)(col + s + v), res, px);
          fsum[v] = fa[v] = occ[v] = 0.0f;
        }
        // the strip's nearest point to the sensor, and its beams
        const float x0 = cx[0], x1 = cx[STRIP - 1];
        const float ex = x0 > 0.0f ? x0 : (x1 < 0.0f ? -x1 : 0.0f);
        const float d_min = sqrtf(ex * ex + cy * cy);
        int b_lo = 0, b_hi = 0;
        if (mine && d_min <= rmax + two_res)
          strip_beams(x0, x1, cy, d_min, theta, B, p, &b_lo, &b_hi);
        int chunk = -1;
        bool pend = false;  // the open chunk holds beam 0 alone: fa its chord
        float w0 = 0.0f;
        for (int b = b_lo; b < b_hi; ++b) {
          const float rf = rfs[b];
          // a beam reaches no cell beyond r_free + 2 res, chord or endpoint
          // (an invalid one has r_free 0 and no endpoint)
          if (d_min > rf + two_res) continue;
          const int k = b % UNROLL;
          if (b / UNROLL != chunk) {  // close the open chunk, open this one
#pragma unroll
            for (int v = 0; v < STRIP; ++v) {
              if (chunk >= 0)
                fsum[v] = F_ADD(fsum[v], pend ? F_MUL(w0, fa[v]) : fa[v]);
              fa[v] = 0.0f;
            }
            chunk = b / UNROLL, pend = false;
          }
          const float dx = dxs[b], dy = dys[b], w = ws[b];
          const float cm = cms[b], hf = hfs[b], ia = ias[b];
          const float cydy = F_MUL(cy, dy), cydx = F_MUL(cy, dx);
          const bool on_row = ers[b] == fr;
          const float ec = ecs[b];
#pragma unroll
          for (int v = 0; v < STRIP; ++v) {
            const float c = chord_of(cx[v], cydy, cydx, dx, dy, cm, hf, ia, rf);
            // the chunk's chain without its skipped (zero) terms
            if (k == 0)
              fa[v] = c;
            else if (k == 1)
              fa[v] = pend ? fmaf(w0, fa[v], F_MUL(w, c)) : F_MUL(w, c);
            else
              fa[v] = fmaf(w, c, pend ? F_MUL(w0, fa[v]) : fa[v]);
            if (on_row && ec == (float)(col + s + v))
              occ[v] = F_ADD(occ[v], 1.0f);
          }
          pend = k == 0;
          if (pend) w0 = w;
        }
#pragma unroll
        for (int v = 0; v < STRIP; ++v) {
          if (chunk >= 0)
            fsum[v] = F_ADD(fsum[v], pend ? F_MUL(w0, fa[v]) : fa[v]);
          const float upd = F_MUL(
              F_ADD(F_MUL(p.l_free, fsum[v]), F_MUL(p.l_occ, occ[v])),
              p.enable);
          g[ry][s + v] =
              clampf(F_ADD(g[ry][s + v], upd), -p.l_clamp, p.l_clamp);
        }
      }
      store_cells(win + (ptrdiff_t)r * pitch + col, mine, col, W, vec, g[ry]);
    }
#pragma unroll
    for (int ry = 0; ry < RY; ++ry)
#pragma unroll
      for (int v = 0; v < V; ++v) g[ry][v] = gn[ry][v];
  }
}

template <typename T>
int launch_particles(T* maps, const float* poses, const float* ranges,
                     const float* angles, int P, int map_rows, int pitch,
                     int h, int w, int B, const Params& p,
                     const unsigned char* gate, void* stream) {
  if (h < 1 || w < 1 || h > map_rows || w > pitch || B < 1 || B > 1360 ||
      P < 1 || P > 65535)
    return (int)cudaErrorInvalidValue;
  const int Bpad = (B + UNROLL - 1) / UNROLL * UNROLL;
  const size_t smem = 9 * (size_t)Bpad * sizeof(float);
  const int vec = (uintptr_t)maps % 16 == 0 && pitch * sizeof(T) % 16 == 0;
  const dim3 blocks = particle_grid(
      resident_blocks(update_ray_particles_kernel<T>, PT,
                      9 * 1360 * sizeof(float)),
      P, h, w,
      PatchCells<T>::V);
  update_ray_particles_kernel<T><<<blocks, PT, smem, (cudaStream_t)stream>>>(
      maps, pitch, map_rows, poses, ranges, angles, gate, h, w, B, Bpad, p,
      vec);
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
  return launch(map, map, W, pose, ranges, angles, h, w, B, p, stream, gate,
                origin, origin_in_map);
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
  const Params p{ox,      oy,        res,  min_range, max_range,
                 inv_samples, half_res, inv_res, angle_min, step,
                 l_free,  l_occ,     l_clamp, enable};
  if (is_bf16)
    return launch_particles((__nv_bfloat16*)maps, poses, ranges, angles, P, H,
                            W, h, w, B, p, gate, stream);
  return launch_particles((float*)maps, poses, ranges, angles, P, H, W, h, w,
                          B, p, gate, stream);
}

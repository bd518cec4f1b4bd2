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
//
// Every particle's window at once (slam2d_update_hybrid_particles, the
// particle filter's update_impl="pallas_hybrid"), in place: particle z's
// pose and map are its own, and its window's top-left cell is computed from
// its pose as update_ism.cu computes it (the pose's cell minus half the
// window, clamped into the map), so the cells get the bits of the
// single-map window form at that origin. Float32 or bfloat16 maps: the
// arithmetic is float32, a bfloat16 cell rounded once on the store. Its
// gate (the particle filter's device-gated step) is read from device memory
// as the window form's. What bounds it: at FastSLAM-16's [16, 496^2]
// float32 windows every window is read and written once (31.5 MB, 9.4 us at
// 3.35 TB/s), and the cells nearer than the scan's reach take the free
// test (~100 operations: a square root, the polynomial arctangent, a float
// modulo and two divisions), ~10 us of the card's float32 issue rate: the
// two are of a size, so the kernel has to keep loads in flight while it
// computes. The single-window kernel's design (a 64 x 8 tile a block,
// 7,936 blocks at that shape) spent its time elsewhere: every block built
// the particle's tables again (rmin3, a sinf and a cosf for each hit's
// endpoint, two barriers) before it updated 2 cells a thread in 4-byte
// accesses; a quarter of the last column tile's lanes idled at 496; and a
// gate of 0 still launched every block. Design:
// - A persistent grid: (blocks a particle, P), the card's resident blocks
//   in all. A block builds its particle's tables once: the scan, rmin3 and
//   the largest of it, and each hitting beam's endpoint cell in the window
//   (packed row << 16 | col, or none) from the single-window kernel's
//   operations. Then each warp takes PATCH x PATCH patches of the window
//   in turn (common.cuh: PatchCells), a thread 8 cells in 16-byte vector
//   loads and stores, the next patch's loads issued before the current
//   patch is updated (the first patch's before the tables are built). A
//   gate of 0 returns one small grid.
// - The endpoint count is gathered, not scattered: a patch that holds an
//   endpoint (a bit a patch, set while the tables build) has its warp's
//   lanes compare 32 endpoints a step with the patch's rows and columns
//   (integer compares), and each endpoint in the patch adds 1 to the
//   count of the cell it equals. The counts are the same integers.
// - The free test is the single-window kernel's, cell by cell (free_cell),
//   with the same bits from fewer instructions: the float modulo takes
//   fmod_small (exact below three turns) and a beam's angle comes from its
//   integral float index. A cell in the cone of bearings no beam's slot
//   reaches (BlindCone, 1e-3 rad inside its edges: the half of the plane
//   behind a 180-degree scanner) cannot be free, so it skips the test as
//   a cell beyond d_free does. (A warp pays for a cell slot wherever one
//   of its lanes tests, so the skip saves most where P is large; listing
//   the cells that need the test and testing them 32 at a time was slower
//   still, 0.037 against 0.027 ms at [16, 496^2].)
// What bounds it now (H100, scripts/tune_kernel.sh update_hybrid): 0.027 ms
// at [16, 496^2] float32, 34% of the bound, against 0.038 before. Without
// the free test it takes 0.016: the memory (the bound, 0.0094), the launch
// and the tables (0.004 with no patch: a block's first reads of the scan
// and its sinf and cosf), the endpoint scan. The free test (a square root,
// the polynomial arctangent, a float modulo and two divisions, ~200 issue
// slots a cell slot of a warp) takes the rest; at P = 16 a warp holds
// 1-4 patches, so little of it overlaps the loads.

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

// rmin3[b] of the scan in rng[0..B) (the min valid clipped range of beam b
// and its two neighbours, ends replicated; -1 for an invalid beam), and
// whether beam b is valid
__device__ __forceinline__ float rmin3_of(const float* rng, int b, int B,
                                         const Params& p, bool* valid) {
  float m = INFINITY;
  bool valid_b = false;
  for (int j = -1; j <= 1; ++j) {
    const float rk = rng[min(max(b + j, 0), B - 1)];
    const bool vk = rk > p.min_range && isfinite(rk);
    if (vk) m = fminf(m, clampf(rk, 0.0f, p.max_range));
    if (j == 0) valid_b = vk;
  }
  *valid = valid_b;
  return valid_b ? m : -1.0f;
}

// The floor-exact endpoint cell (er, ec) of hitting beam b in the window
// whose float origin is (p.ox, p.oy); integral floats
__device__ __forceinline__ void endpoint_of(float rb, float angle, float px,
                                            float py, float pth,
                                            float inv_res, const Params& p,
                                            float* er, float* ec) {
  const float r = clampf(rb, 0.0f, p.max_range);
  const float a = F_ADD(angle, pth);
  const float ey = F_SUB(F_ADD(py, F_MUL(sinf(a), r)), p.oy);
  const float ex = F_SUB(F_ADD(px, F_MUL(cosf(a), r)), p.ox);
  *er = floorf(F_MUL(ey, inv_res));
  *ec = floorf(F_MUL(ex, inv_res));
}

// fmodf(x, y) for y > 0, for |x| < 3 y without its general loop: there
// x - n y (n = 0, 1, 2, the truncated quotient) is exact (Sterbenz), so it
// is fmodf's result, sign of zero and all
__device__ __forceinline__ float fmod_small(float x, float y) {
  const float ax = fabsf(x);
  if (ax < y) return x;
  if (ax < F_ADD(y, y)) return copysignf(F_SUB(ax, y), x);
  if (ax < F_MUL(3.0f, y)) return copysignf(F_SUB(ax, F_ADD(y, y)), x);
  return fmodf(x, y);
}

// The free test of the cell whose centre lies at (cx, cy) from the sensor:
// some beam b has the cell's bearing within half a step of its own and the
// cell nearer than rmin3[b] - res. It checks only floor(phi/step) and the
// beam after it (any other beam is a whole step away); a cell at d >=
// d_free = max_b rmin3[b] - res cannot be free, so it skips the bearing.
// FAST (the particle form): the float modulo through fmod_small and a
// beam's angle from the integral float k itself ((float)(int)k == k):
// the same bits with fewer instructions.
template <bool FAST>
__device__ __forceinline__ bool free_cell(float cx, float cy, float pth,
                                          float d_free, const float* rmin3,
                                          int B, const Params& p) {
  const float d = __fsqrt_rn(F_ADD(F_MUL(cx, cx), F_MUL(cy, cy)));
  bool is_free = false;
  if (d < d_free) {
    float phi = F_SUB(F_SUB(atan2_ref(cy, cx), pth), p.angle_min);
    float m;
    if (FAST) {
      m = fmod_small(F_ADD(phi, PI_F), TWO_PI_F);
      m = (m != 0.0f && m < 0.0f) ? F_ADD(m, TWO_PI_F) : m;  // mod_pos
    } else {
      m = mod_pos(F_ADD(phi, PI_F), TWO_PI_F);
    }
    phi = F_SUB(m, PI_F);
    const float k0 = floorf(F_DIV(phi, p.step));
    const float half_slot = 0.5f * p.step;
    for (int j = 0; j < 2; ++j) {
      const float k = F_ADD(k0, (float)j);
      if (k >= 0.0f && k <= (float)(B - 1)) {
        const int b = (int)k;
        const float ab = F_MUL(FAST ? k : (float)b, p.step);
        is_free |= fabsf(F_SUB(phi, ab)) <= half_slot &&
                   d < F_SUB(rmin3[b], p.res);
      }
    }
  }
  return is_free;
}

// The cone of bearings that no beam's slot reaches, widened by `margin`
// radians on each side (every cell there fails the free test: its bearing
// lies more than half a step from every beam's, far beyond the rounding of
// atan2_ref and of the pose's angle): from S counterclockwise through
// `width`, with the unit vectors of its two edges. `on` is false where the
// beams' slots cover the whole turn.
struct BlindCone {
  bool on, convex;
  float sx, sy, ex, ey;
  __device__ BlindCone(float pth, int B, const Params& p) {
    const float margin = 1e-3f;
    const float cover = F_ADD(F_MUL((float)(B - 1), p.step),
                              F_ADD(p.step, 2.0f * margin));
    const float width = F_SUB(TWO_PI_F, cover);
    const float s = F_ADD(F_ADD(pth, p.angle_min),
                          F_SUB(cover, F_ADD(0.5f * p.step, margin)));
    on = width > 0.0f;
    convex = width <= PI_F;
    sx = cosf(s), sy = sinf(s);
    ex = cosf(s + width), ey = sinf(s + width);
  }
  // the cell at (cx, cy) from the sensor lies in the cone
  __device__ __forceinline__ bool holds(float cx, float cy) const {
    const bool after_s = sx * cy - sy * cx > 0.0f;
    const bool before_e = cx * ey - cy * ex > 0.0f;
    return on && (convex ? after_s && before_e : after_s || before_e);
  }
};

__device__ __forceinline__ float hybrid_update(float g, bool is_free,
                                               int count, const Params& p) {
  const float upd = F_MUL(F_ADD(F_MUL(p.l_free, is_free ? 1.0f : 0.0f),
                                F_MUL(p.l_occ, (float)count)),
                          p.enable);
  return clampf(F_ADD(g, upd), -p.l_clamp, p.l_clamp);
}

// grid and out may be one array (in place); `pitch` is their row length,
// (H, W) the updated window's size; `origin` (the window's top-left cell in
// the array, or with origin_in_map 0 on the lattice alone) and `gate` may
// be null: no offset, no gate.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    update_hybrid_kernel(const T* grid, T* out, int pitch,
                         const int* __restrict__ origin,
                         int origin_in_map,
                         const unsigned char* __restrict__ gate,
                         const float* __restrict__ pose,
                         const float* __restrict__ ranges,
                         const float* __restrict__ angles, int H, int W,
                         int B, Params p) {
  if (gate != nullptr && *gate == 0) return;
  const float inv_res = F_DIV(1.0f, p.res);  // x / res compiles as x * (1/res)
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
    bool valid_b;
    const float rm = rmin3_of(rng, b, B, p, &valid_b);
    rmin3[b] = rm;
    if (rm > 0.0f) rmax = max(rmax, __float_as_uint(rm));
    const float rb = rng[b];
    if (!(valid_b && rb < p.max_range)) continue;  // no hit
    float er, ec;
    endpoint_of(rb, angles[b], px, py, pth, inv_res, p, &er, &ec);
    // integral floats: inside the tile exactly when equal to one of its
    // cells' (float)row and (float)col
    if (er >= (float)tr0 && er < (float)tr1 && ec >= (float)tc0 &&
        ec < (float)tc1)
      atomicAdd(&count_s[((int)er - tr0) * TW + ((int)ec - tc0)], 1);
  }
  rmax = __reduce_max_sync(0xffffffffu, rmax);
  if ((tid & 31) == 0) atomicMax(&rmax_bits, rmax);
  __syncthreads();

  // every cell of the tile: free test, count, update, clip, write
  const float d_free = F_SUB(__uint_as_float(rmax_bits), p.res);
#pragma unroll
  for (int y = 0; y < CY; ++y)
#pragma unroll
    for (int x = 0; x < CX; ++x) {
      const int row = tr0 + threadIdx.y + y * BY;
      const int col = tc0 + threadIdx.x + x * BX;
      if (row >= tr1 || col >= tc1) continue;
      const float cx = F_SUB(fmaf(F_ADD((float)col, 0.5f), p.res, p.ox), px);
      const float cy = F_SUB(fmaf(F_ADD((float)row, 0.5f), p.res, p.oy), py);
      const bool is_free = free_cell<false>(cx, cy, pth, d_free, rmin3, B, p);
      const int count = count_s[(row - tr0) * TW + (col - tc0)];
      store_f32(out + (size_t)row * pitch + col,
                hybrid_update(g[y][x], is_free, count, p));
    }
}

template <typename T>
int launch(const T* grid, T* out, int pitch, const int* origin,
           int origin_in_map, const unsigned char* gate, const float* pose,
           const float* ranges,
           const float* angles, int H, int W, int B, const Params& p,
           void* stream) {
  const dim3 block(BX, BY);
  const dim3 blocks((W + TW - 1) / TW, (H + TH - 1) / TH);
  const size_t smem = 2 * (size_t)B * sizeof(float);
  update_hybrid_kernel<T><<<blocks, block, smem, (cudaStream_t)stream>>>(
      grid, out, pitch, origin, origin_in_map, gate, pose, ranges, angles, H,
      W, B, p);
  return (int)cudaGetLastError();
}

// ---- every particle's window at once -------------------------------------

constexpr unsigned NO_END = 0xffffffffu;  // a beam without an endpoint cell
constexpr int MARK_WORDS = 1024;  // the patch bits' shared memory, words

// Update particle `part`'s window, one warp a patch (the header's design):
// `maps` holds the particles' maps of map_rows x pitch cells, (H, W) is the
// window's size; `vec`: the maps allow 16-byte vector access.
template <typename T>
__global__ void __launch_bounds__(PT)
    update_hybrid_particles_kernel(T* maps, int pitch, int map_rows,
                                   const float* __restrict__ poses,
                                   const float* __restrict__ ranges,
                                   const float* __restrict__ angles,
                                   const unsigned char* __restrict__ gate,
                                   int H, int W, int B, Params p, int vec,
                                   int mark_words) {
  using C = PatchCells<T>;
  constexpr int V = C::V, TPR = C::TPR, RPP = C::RPP, RY = C::RY;
  if (gate != nullptr && *gate == 0) return;  // uniform: the whole grid
  const float inv_res = F_DIV(1.0f, p.res);  // x / res compiles as x * (1/res)
  const int part = blockIdx.y;
  const float px = poses[3 * part], py = poses[3 * part + 1];
  const float pth = poses[3 * part + 2];
  // world_to_cell of the pose, minus half the window, clamped
  const int cr = (int)floorf(F_MUL(F_SUB(py, p.oy), inv_res));
  const int cc = (int)floorf(F_MUL(F_SUB(px, p.ox), inv_res));
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
      load_cells(win + (ptrdiff_t)row * pitch + col, row < H, col, W, vec,
                 g[ry]);
  };
  float g[RY][V];
  if (patch < n_patches) load(patch, g);  // in flight while the tables build

  extern __shared__ float smem[];
  float* rng = smem;                               // [B] the scan
  float* rmin3 = smem + B;                         // [B]
  unsigned* ends = (unsigned*)(smem + 2 * B);      // [B] endpoint cells
  // a bit a patch: an endpoint lies in it (mark_words 0: no such bits, every
  // patch looks)
  unsigned* marked = ends + B;
  __shared__ unsigned rmax_bits;
  for (int b = threadIdx.x; b < B; b += PT) rng[b] = ranges[b];
  for (int i = threadIdx.x; i < mark_words; i += PT) marked[i] = 0u;
  if (threadIdx.x == 0) rmax_bits = 0u;
  __syncthreads();
  const BlindCone blind(pth, B, p);
  unsigned rmax = 0u;  // bits of a non-negative float order as the float
  for (int b = threadIdx.x; b < B; b += PT) {
    bool valid_b;
    const float rm = rmin3_of(rng, b, B, p, &valid_b);
    rmin3[b] = rm;
    if (rm > 0.0f) rmax = max(rmax, __float_as_uint(rm));
    const float rb = rng[b];
    unsigned end = NO_END;
    if (valid_b && rb < p.max_range) {  // a hit
      float er, ec;
      endpoint_of(rb, angles[b], px, py, pth, inv_res, p, &er, &ec);
      if (er >= 0.0f && er < (float)H && ec >= 0.0f && ec < (float)W) {
        end = (unsigned)er << 16 | (unsigned)ec;
        const int at = (int)er / PATCH * n_pc + ((int)ec - base_col) / PATCH;
        if (mark_words) atomicOr(&marked[at >> 5], 1u << (at & 31));
      }
    }
    ends[b] = end;
  }
  rmax = __reduce_max_sync(0xffffffffu, rmax);
  if ((threadIdx.x & 31) == 0) atomicMax(&rmax_bits, rmax);
  __syncthreads();
  const float d_free = F_SUB(__uint_as_float(rmax_bits), p.res);

  for (; patch < n_patches; patch += stride) {
    float gn[RY][V];
    if (patch + stride < n_patches) load(patch + stride, gn);
    int row, col;
    cells(patch, &row, &col);
    const int prow = row - ty, pcol = col - tx * V;
    // the endpoint counts of this thread's cells, from the endpoints in
    // the patch (32 beams a step, a lane a beam)
    int count[RY][V];
#pragma unroll
    for (int ry = 0; ry < RY; ++ry)
#pragma unroll
      for (int v = 0; v < V; ++v) count[ry][v] = 0;
    const bool any_end =
        mark_words == 0 || (marked[patch >> 5] >> (patch & 31) & 1u);
    for (int b32 = 0; any_end && b32 < B; b32 += 32) {
      const unsigned e = b32 + lane < B ? ends[b32 + lane] : NO_END;
      unsigned in = __ballot_sync(
          0xffffffffu, e != NO_END && (unsigned)((int)(e >> 16) - prow) < PATCH &&
                           (unsigned)((int)(e & 0xffffu) - pcol) < PATCH);
      while (in) {
        const unsigned end = ends[b32 + __ffs(in) - 1];
        in &= in - 1;
        const int er = (int)(end >> 16), ec = (int)(end & 0xffffu);
#pragma unroll
        for (int ry = 0; ry < RY; ++ry)
          if (er == row + ry * RPP) {
#pragma unroll
            for (int v = 0; v < V; ++v) count[ry][v] += ec == col + v;
          }
      }
    }
#pragma unroll
    for (int ry = 0; ry < RY; ++ry) {
      const int r = row + ry * RPP;
      const float cy = F_SUB(fmaf(F_ADD((float)r, 0.5f), p.res, p.oy), py);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float cx =
            F_SUB(fmaf(F_ADD((float)(col + v), 0.5f), p.res, p.ox), px);
        const bool is_free =
            !blind.holds(cx, cy) &&
            free_cell<true>(cx, cy, pth, d_free, rmin3, B, p);
        g[ry][v] = hybrid_update(g[ry][v], is_free, count[ry][v], p);
      }
      store_cells(win + (ptrdiff_t)r * pitch + col, r < H, col, W, vec, g[ry]);
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
  if (h < 1 || w < 1 || h > map_rows || w > pitch || h > 65535 ||
      w > 65535 || B < 1 || B > 2048 || P < 1 || P > 65535)
    return (int)cudaErrorInvalidValue;
  constexpr int V = PatchCells<T>::V;
  // a bit for each patch a window can hold, up to MARK_WORDS words
  const int patches = (h + PATCH - 1) / PATCH * ((w + V - 1) / PATCH + 1);
  const int words = (patches + 31) / 32 <= MARK_WORDS ? (patches + 31) / 32 : 0;
  const size_t smem = (3 * (size_t)B + words) * sizeof(float);
  const int vec = (uintptr_t)maps % 16 == 0 && pitch * sizeof(T) % 16 == 0;
  const dim3 blocks = particle_grid(
      resident_blocks(update_hybrid_particles_kernel<T>, PT,
                      (3 * 2048 + MARK_WORDS) * sizeof(float)),
      P, h, w, V);
  update_hybrid_particles_kernel<T>
      <<<blocks, PT, smem, (cudaStream_t)stream>>>(
          maps, pitch, map_rows, poses, ranges, angles, gate, h, w, B, p, vec,
          words);
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
  const Params p{ox,     oy,    res,   step,    angle_min, min_range,
                 max_range, l_free, l_occ, l_clamp, enable};
  if (is_bf16)
    return launch_particles((__nv_bfloat16*)maps, poses, ranges, angles, P, H,
                            W, h, w, B, p, gate, stream);
  return launch_particles((float*)maps, poses, ranges, angles, P, H, W, h, w,
                          B, p, gate, stream);
}

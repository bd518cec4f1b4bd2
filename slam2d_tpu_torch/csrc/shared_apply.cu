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
// What bounds it on the H100: bytes. Each particle's window cells on the map
// are read and written once and the images and endpoint operands read once
// (chip_smoke.py's count: at FastSLAM-1000's 1000 bf16 512^2 maps, 256^2
// windows and 16 float32 256^2 images, ~263 MB, 0.0785 ms at 3.35 TB/s);
// an add and a clip a cell. The maps (524 MB) do not fit the 50 MB L2, so
// the window traffic is HBM traffic, and a copy reaches the HBM rate only
// with ~20 KB in flight on every SM.
//
// Design: one block per (particle, band of BAND rows of the window clamped
// into the map): 8000 blocks at FastSLAM-1000 instead of 1000. Each row's
// on-map span splits into a ragged head up to the map row's next 16-byte
// boundary, a body of 16-byte vectors (8 bf16 or 4 float32 cells, no
// per-cell division) and a ragged tail. A warp walks the body of its rows a
// lane a vector, with STAGES vectors a lane in flight as cp.async copies
// into a ring in shared memory (in flight without registers); it reads the
// image cells of a vector, at any alignment, as the 16-byte words that hold
// them (from L2: the images are 4 MB), then loads all its rows' head and
// tail cells before it stores them. A band also owns the live endpoint
// marks whose row lies in it (marks above or below the window go to its
// first or last band), so every mark of a cell is in the block that stored
// that cell's dense value: the marks are fetched before the dense pass, and
// after __syncthreads() the block compacts them into shared memory in beam
// order (a ballot and a prefix over the warps) and applies the first-beam
// rule to that short list, with __match_any_sync on one warp when it holds
// at most 32 marks; no atomics, no second launch.
//
// The kernel is bound by latency more than by bandwidth: a block's anchors,
// loads and marks pass are a chain, so what pays is blocks in flight.
// Measured on the H100 (scripts/tune_kernel.sh shared_apply, PERF.md): 40
// registers (6 blocks of 256 threads an SM) beat 48 and 56-64; one body
// row a warp at a time from registers beat 2 and 4 (more registers, fewer
// blocks), and the cp.async ring beat that by 2%; bands of 32 rows beat 16
// and 64; the image as words beat cell loads, and words shared between
// lanes by shuffles lost 5%; adding the marks inside the dense pass (their
// sums found before it) lost 2%.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int BAND = 32;     // rows of the clamped window a block owns
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 6;  // blocks an SM: at most 40 registers
constexpr int STAGES = 4;      // body vectors a lane has in flight

__device__ __forceinline__ float round_as(float v, float*) { return v; }
__device__ __forceinline__ float round_as(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 16 bytes of map cells: widened to float32, and the clipped sums stored
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  using Word = float4;
  static __device__ __forceinline__ void widen(const Word& w, float* f) {
    f[0] = w.x, f[1] = w.y, f[2] = w.z, f[3] = w.w;
  }
  static __device__ __forceinline__ Word narrow(const float* f) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  using Word = uint4;
  static __device__ __forceinline__ void widen(const Word& w, float* f) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(u[k] << 16);
      f[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ Word narrow(const float* f) {
    uint32_t u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
      u[k] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
};

// a 16-byte copy global -> shared that lands in the background (on = false:
// zeros, nothing read); a group of them committed; waiting until at most
// N groups are in flight
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool on) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(on ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// the cells [c_lo, c_hi) of one map row: ragged head, 16-byte body, tail
struct RowSplit {
  int head, nv, tail;
};

template <typename T>
__device__ __forceinline__ RowSplit split_row(const T* row, int c_lo,
                                              int c_hi) {
  constexpr int N = Vec<T>::N;
  const int n = c_hi - c_lo;
  const uintptr_t a = reinterpret_cast<uintptr_t>(row + c_lo);
  const int head = min((int)(((16 - (a & 15)) & 15) / sizeof(T)), n);
  const int nv = (n - head) / N;
  return RowSplit{head, nv, n - head - nv * N};
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// N consecutive image cells from `src` (any alignment) as float32: the
// 16-byte words that hold them, loaded whole, and the cells picked out by
// their offset in the first word
template <typename I, int N>
__device__ __forceinline__ void load_image_run(const I* src, float* x) {
  constexpr int K = 16 / sizeof(I);           // cells a word
  constexpr int NW = (N + 2 * K - 2) / K;     // words at the worst offset
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const int s = (int)(a & 15) / (int)sizeof(I);
  const uint4* w = reinterpret_cast<const uint4*>(a - (a & 15));
  const int nw = (s + N + K - 1) / K;         // words this run touches
  uint4 wd[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i)
    wd[i] = i < nw ? __ldg(w + i) : make_uint4(0u, 0u, 0u, 0u);
  const I* e = reinterpret_cast<const I*>(wd);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float v = to_f32(e[k]);
#pragma unroll
    for (int t = 1; t < K; ++t)
      if (s == t) v = to_f32(e[k + t]);
    x[k] = v;
  }
}

template <typename T, typename I>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
shared_apply_kernel(T* __restrict__ maps, const I* __restrict__ images,
                    const int* __restrict__ anchors,
                    const int* __restrict__ slots,
                    const int* __restrict__ ep_r,
                    const int* __restrict__ ep_c,
                    const float* __restrict__ ep_w, int H, int W, int win,
                    int G, int B, int bands, float l_clamp) {
  extern __shared__ int smem[];  // the band's live marks: [3, B]
  __shared__ int warp_live[WARPS];
  __shared__ uint4 stage[WARPS][STAGES * 32];  // the warps' body rings
  using V = Vec<T>;
  constexpr int N = V::N;
  const int p = blockIdx.x / bands;
  const int band = blockIdx.x - p * bands;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T* map = maps + (size_t)p * H * W;
  const int ar = anchors[2 * p] - win / 2;
  const int ac = anchors[2 * p + 1] - win / 2;
  const int slot = min(max(slots[p], 0), G - 1);
  const I* img = images + (size_t)slot * win * win;

  // the first THREADS marks, fetched now to arrive during the dense pass
  const int* er = ep_r + (size_t)p * B;
  const int* ec = ep_c + (size_t)p * B;
  const float* ew = ep_w + (size_t)p * B;
  int nr = 0, nc = 0;
  float nw = 0.0f;
  if (threadIdx.x < B)
    nr = er[threadIdx.x], nc = ec[threadIdx.x], nw = ew[threadIdx.x];

  // the window clamped into the map: rows [s0, s0 + span); the band's rows
  const int s0 = min(max(ar, 0), max(H - win, 0));
  const int span = min(win, H);
  const int b0 = s0 + band * BAND;
  const int b1 = min(b0 + BAND, s0 + span);

  // dense pass: the image rows on the map in this band, columns [c0, c1)
  const int r0 = max(b0, ar), r1 = min(b1, ar + win);
  const int c0 = max(ac, 0), c1 = min(ac + win, W);
  if (c1 > c0) {
    // the body: items (row k of the warp's rows r0 + warp + k * WARPS, chunk
    // j of 32 vectors), each lane's vector copied by cp.async into the
    // warp's ring of STAGES slots, STAGES items in flight
    const int n = c1 - c0;
    const int K = r1 > r0 + warp ? (r1 - r0 - warp + WARPS - 1) / WARPS : 0;
    const int J = (n / N + 31) / 32;   // chunks of the longest body
    const int items = K * J;
    uint4* ring = stage[warp];
    auto body_at = [&](int i, int* r, int* c) {  // -> the lane's vector?
      *r = r0 + warp + (i / J) * WARPS;
      const RowSplit sp = split_row(map + (size_t)*r * W, c0, c1);
      const int v = (i % J) * 32 + lane;
      *c = c0 + sp.head + v * N;
      return v < sp.nv;
    };
    auto issue = [&](int i) {
      int r = r0, c = c0;
      const bool on = i < items && body_at(i, &r, &c);
      cp_async16(&ring[(i % STAGES) * 32 + lane],
                 on ? (const void*)(map + (size_t)r * W + c) : (const void*)map,
                 on);
      cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < STAGES; ++i) issue(i);
    for (int i = 0; i < items; ++i) {
      cp_async_wait<STAGES - 1>();
      int r, c;
      if (body_at(i, &r, &c)) {
        float x[N], f[N];
        load_image_run<I, N>(img + (size_t)(r - ar) * win + (c - ac), x);
        V::widen(*reinterpret_cast<const typename V::Word*>(
                     &ring[(i % STAGES) * 32 + lane]), f);
#pragma unroll
        for (int e = 0; e < N; ++e)
          f[e] = clampf(F_ADD(f[e], x[e]), -l_clamp, l_clamp);
        *reinterpret_cast<typename V::Word*>(map + (size_t)r * W + c) =
            V::narrow(f);
      }
      issue(i + STAGES);
    }
    cp_async_wait<0>();
    // the ragged heads and tails of the warp's rows: a lane a cell (head
    // cells on lanes 0.., tail cells on lanes N..), all loaded, then stored
    constexpr int KMAX = (BAND + WARPS - 1) / WARPS;
    float y[KMAX];
    int ce[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int r = r0 + warp + k * WARPS;
      ce[k] = -1;
      if (k >= K) continue;
      const RowSplit sp = split_row(map + (size_t)r * W, c0, c1);
      const int ct = c0 + sp.head + sp.nv * N;
      ce[k] = lane < sp.head ? c0 + lane
              : (lane >= N && lane - N < sp.tail ? ct + lane - N : -1);
      if (ce[k] >= 0)
        y[k] = F_ADD(load_f32(map + (size_t)r * W + ce[k]),
                     load_f32(img + (size_t)(r - ar) * win + (ce[k] - ac)));
    }
#pragma unroll
    for (int k = 0; k < KMAX; ++k)
      if (ce[k] >= 0)
        store_f32(map + (size_t)(r0 + warp + k * WARPS) * W + ce[k],
                  clampf(y[k], -l_clamp, l_clamp));
  }
  if (B == 0) return;

  // the band's live marks, compacted in beam order: a mark on row r belongs
  // to band (r - s0) / BAND, clamped into [0, bands)
  int* sr = smem;
  int* sc = smem + B;
  float* sw = (float*)(smem + 2 * B);
  int n_live = 0;
  for (int base = 0; base < B; base += THREADS) {
    const int r = nr, c = nc;
    const float w = nw;   // 0 past the last beam
    const int next = base + THREADS + threadIdx.x;
    nw = 0.0f;
    if (next < B) nr = er[next], nc = ec[next], nw = ew[next];
    const int owner = r < s0 ? 0 : min((r - s0) / BAND, bands - 1);
    const bool mine =
        w != 0.0f && owner == band && r >= 0 && r < H && c >= 0 && c < W;
    const unsigned ball = __ballot_sync(0xffffffffu, mine);
    if (lane == 0) warp_live[warp] = __popc(ball);
    __syncthreads();  // also: the dense stores before any mark's read
    int at = n_live;
    for (int k = 0; k < warp; ++k) at += warp_live[k];
    if (mine) {
      at += __popc(ball & ((1u << lane) - 1u));
      sr[at] = r, sc[at] = c, sw[at] = w;
    }
    for (int k = 0; k < WARPS; ++k) n_live += warp_live[k];
    __syncthreads();  // warp_live is read before the next chunk writes it
  }

  // each marked cell once, from its first beam: the float32 sum of its
  // beams' bf16 weights in beam order, added in the map dtype. Up to 32
  // marks (the usual case): one warp, a lane a mark, the marks of a cell
  // found by __match_any_sync; more: every thread scans the list.
  const float lc = round_as(l_clamp, (T*)nullptr);
  auto apply_mark = [&](int r, int c, float s) {
    T* cell = map + (size_t)r * W + c;
    const float t = round_as(F_ADD(load_f32(cell), round_as(s, (T*)nullptr)),
                             (T*)nullptr);
    store_f32(cell, clampf(t, -lc, lc));
  };
  auto bf16w = [&](int e) {
    return __bfloat162float(__float2bfloat16_rn(sw[e]));
  };
  if (n_live <= 32) {
    if (warp != 0) return;
    const bool ok = lane < n_live;
    const int r = ok ? sr[lane] : 0, c = ok ? sc[lane] : 0;
    const unsigned same = __match_any_sync(
        0xffffffffu, ok ? (long long)r * W + c : -1LL - lane);
    if (!ok || (same & ((1u << lane) - 1u)) != 0) return;
    float s = 0.0f;
    for (unsigned m = same; m != 0; m &= m - 1) s = F_ADD(s, bf16w(__ffs(m) - 1));
    apply_mark(r, c, s);
    return;
  }
  for (int i = threadIdx.x; i < n_live; i += THREADS) {
    const int r = sr[i], c = sc[i];
    bool first = true;
    for (int e = 0; e < i && first; ++e) first = !(sr[e] == r && sc[e] == c);
    if (!first) continue;
    float s = 0.0f;
    for (int e = i; e < n_live; ++e)
      if (sr[e] == r && sc[e] == c) s = F_ADD(s, bf16w(e));
    apply_mark(r, c, s);
  }
}

template <typename T, typename I>
int launch(void* maps, const void* images, const int* anchors,
           const int* slots, const int* ep_r, const int* ep_c,
           const float* ep_w, int P, int H, int W, int win, int G, int B,
           float l_clamp, cudaStream_t s) {
  const int bands = (min(win, H) + BAND - 1) / BAND;
  if ((long long)P * bands > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = 3 * (size_t)B * sizeof(int);
  // past 48 KB with the static rings and warp counts: opt in
  const size_t fixed = sizeof(uint4) * WARPS * STAGES * 32 + 4 * WARPS;
  if (smem + fixed > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        shared_apply_kernel<T, I>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  shared_apply_kernel<T, I><<<P * bands, THREADS, smem, s>>>(
      (T*)maps, (const I*)images, anchors, slots, ep_r, ep_c, ep_w, H, W, win,
      G, B, bands, l_clamp);
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

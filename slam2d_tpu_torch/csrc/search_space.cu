// Search-space build: evidence clip, separable Gaussian blur, free penalty.
//
// Replaces slam2d_tpu/ops/pallas_blur.py:_blur_kernel, fused with the rest of
// match/correlative.py:build_search_space:
//   occ   = clip(l * inv_occ_sat, 0, 1)   (XLA's form of l / occ_sat)
//   blur  = clip(blur_cols(blur_rows(occ)), 0, 1)      zero padding
//   out   = blur - free_penalty * [sigmoid(l) < free_threshold] * (1 - blur)
// The taps are peak-normalized; each axis accumulates from tap 0 upward, rows
// (axis 0) first, as _separable_blur does, so the sums round as in the JAX
// package.
//
// What bounds it on the H100: each output cell costs 2 x n_taps products and
// sums that may not fuse into FMAs against one read of l and one write of S
// (8 bytes a cell: 2.2 MB at the frontend's 520^2 window, 8.4 MB at the
// 1024^2 initial build), so the bytes bound it at 0.65 us and 2.5 us, and at
// the window size the launch itself (~0.9 us) lies above that bound.
// Design: one launch a call; a block owns a TY x TX tile of outputs:
// - it copies the tile and a halo of hw = n_taps / 2 cells on every side
//   from l once, row segments by warps (coalesced), every copy in flight at
//   once (cp.async, no register between global and shared memory: loads
//   issued one after another cost a round trip each, most of the kernel's
//   time in its first form); cells off the map are filled with 0, whose
//   evidence is 0: the JAX package's zero padding of occ. The rows pass
//   turns a value into evidence as it loads it, one instruction (mul.sat),
//   about (CPT + n - 1) / CPT times a cell: a pass of its own that
//   converted each cell once cost a quarter of the kernel's time;
// - the frontend's tap count at 0.05 m cells, 13, is a template argument:
//   the loops unroll and the taps are operands read from the parameters
//   (15% quicker than runtime loops at 520^2); any other odd count up to
//   63 runs the same code with runtime loops (taps from shared memory);
// - the rows pass blurs along axis 0 into a second shared buffer of
//   TY x (TX + 2 hw) cells: a thread takes CPT neighbouring rows of one
//   column and slides one window of loads down them, so a value is read once
//   for CPT outputs. A compiled tap count leaves out the terms of taps
//   outside [0, n); a runtime count reads them as zeros: an output's sum
//   meets them only before its tap 0 or after its last tap, where adding
//   +0 = 0 * occ leaves it unchanged, so no test is needed;
// - the columns pass blurs along axis 1 from that buffer (the same CPT rows
//   of one column a thread, each tap loaded once for them) and applies the
//   clip and the free penalty in registers, the free test
//   [sigmoid(l) < free_threshold] on the centre value from shared memory.
// Adding tap x 0.0 to a non-negative sum leaves it unchanged, so the
// zero-filled halo gives the bits of the two-pass kernel it replaces, which
// skipped the taps off the map. Both buffers have an odd row pitch. The
// shared memory is dynamic, sized from n_taps (47,752 bytes at 63 taps);
// above 48 KB the launch raises the kernel's limit first. 64 x 16 tiles (297
// blocks at 520^2, one wave) with 4 rows a thread were the quickest at 520^2
// of tiles from 32 x 32 to 128 x 16 and 1, 2, 4 or 8 rows a thread
// (scripts/tune_kernel.sh search_space; PERF.md).

#include "common.cuh"

namespace {

constexpr int TX = 64;       // output columns of a tile
constexpr int TY = 16;       // output rows of a tile
constexpr int CPT = 4;       // neighbouring rows (one column) a thread computes
constexpr int THREADS = 256;
static_assert(TY % CPT == 0, "a thread's rows lie in one tile");

// One float from global to shared memory without a register (cp.async), or
// a zero where `in` is false (the copy reads no byte then)
__device__ __forceinline__ void copy_or_zero(float* dst, const float* src,
                                             bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// Row pitch of both shared buffers: the tile's columns and the halo, odd
__host__ __device__ constexpr int pitch_of(int hw) { return (TX + 2 * hw) | 1; }

__host__ __device__ constexpr size_t smem_bytes(int hw) {
  return sizeof(float) * (size_t)pitch_of(hw) * ((TY + 2 * hw) + TY);
}

// Tap k of the blur: from the launch's parameters where the count NT is
// known when compiling, else from the copy in shared memory, zero-padded
// by CPT - 1 taps on each side
template <int NT>
__device__ __forceinline__ float tap_of(const Taps& taps, const float* padded,
                                        int k) {
  if constexpr (NT > 0)
    return taps.k[k];
  else
    return padded[k + CPT - 1];
}

// NT > 0: the tap count, known when compiling (the loops unroll, and the
// taps are operands read from the parameters); NT = 0: any odd count, taps.n
template <int NT>
__global__ void __launch_bounds__(THREADS)
search_space_kernel(const float* __restrict__ l, float* __restrict__ out,
                    int H, int W, const __grid_constant__ Taps taps,
                    float inv_occ_sat, float free_threshold,
                    float free_penalty) {
  extern __shared__ float smem[];
  // the taps with CPT - 1 zeros on each side: tap(k) = padded[k + CPT - 1]
  __shared__ float padded[NT > 0 ? 1 : MAX_TAPS + 2 * (CPT - 1)];
  const int n = NT > 0 ? NT : taps.n;
  const int hw = n / 2;
  const int P = pitch_of(hw);
  const int ext_y = TY + 2 * hw;
  const int ext_x = TX + 2 * hw;
  float* lt = smem;               // [ext_y, P] the log-odds tile and halo
  float* rows = smem + ext_y * P;  // [TY, P] row-blurred evidence
  const int r0 = blockIdx.y * TY;
  const int c0 = blockIdx.x * TX;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  // whether tap k takes part: decided when compiling where NT > 0; with
  // NT = 0 every k does, the zero taps adding +0 = 0 * occ
  auto used = [](int k) { return NT == 0 || (k >= 0 && k < NT); };

  if (NT == 0)
    for (int k = tid; k < n + 2 * (CPT - 1); k += THREADS) {
      const int t = k - (CPT - 1);
      padded[k] = (t >= 0 && t < n) ? taps.k[t] : 0.0f;
    }
  // every copy of the tile in flight at once
  for (int i = tid / 32; i < ext_y; i += THREADS / 32) {
    const int r = r0 - hw + i;
    const bool row_in = r >= 0 && r < H;
    for (int j = lane; j < ext_x; j += 32) {
      const int c = c0 - hw + j;
      const bool in = row_in && c >= 0 && c < W;
      copy_or_zero(lt + i * P + j, in ? l + (size_t)r * W + c : l, in);
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // rows pass: out[m] = sum_k tap(k) * occ(lt[rb + m + k]), k from 0 up; the
  // load at q serves outputs m = q - k for the CPT taps q - CPT + 1 .. q
  constexpr int GROUPS = TY / CPT;
  for (int t = tid; t < ext_x * GROUPS; t += THREADS) {
    const int j = t % ext_x;
    const int rb = (t / ext_x) * CPT;
    const float* src = lt + rb * P + j;
    float acc[CPT];
#pragma unroll
    for (int m = 0; m < CPT; ++m) acc[m] = 0.0f;
#pragma unroll
    for (int q = 0; q < n + CPT - 1; ++q) {
      // clip(l * inv_occ_sat, 0, 1) as one instruction (mul.sat)
      const float v = __saturatef(F_MUL(src[q * P], inv_occ_sat));
#pragma unroll
      for (int m = 0; m < CPT; ++m)
        if (used(q - m))
          acc[m] = F_ADD(acc[m], F_MUL(tap_of<NT>(taps, padded, q - m), v));
    }
#pragma unroll
    for (int m = 0; m < CPT; ++m) rows[(rb + m) * P + j] = acc[m];
  }
  __syncthreads();

  // columns pass and epilogue: CPT rows of one column a thread
  for (int t = tid; t < TX * GROUPS; t += THREADS) {
    const int c = t % TX;
    const int rb = (t / TX) * CPT;
    if (c0 + c >= W || r0 + rb >= H) continue;
    const float* src = rows + rb * P + c;
    float acc[CPT];
#pragma unroll
    for (int m = 0; m < CPT; ++m) acc[m] = 0.0f;
#pragma unroll
    for (int k = 0; k < n; ++k) {
      const float tk = tap_of<NT>(taps, padded, k);
#pragma unroll
      for (int m = 0; m < CPT; ++m)
        acc[m] = F_ADD(acc[m], F_MUL(tk, src[m * P + k]));
    }
#pragma unroll
    for (int m = 0; m < CPT; ++m) {
      const int r = r0 + rb + m;
      if (r >= H) break;
      const float lv = lt[(rb + m + hw) * P + c + hw];
      const float p = 1.0f / (1.0f + expf(-lv));
      out[(size_t)r * W + c0 + c] =
          field_value(acc[m], p < free_threshold, free_penalty);
    }
  }
}

template <int NT>
int launch(const float* l, float* out, int H, int W, const Taps& taps,
           float inv_occ_sat, float free_threshold, float free_penalty,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(taps.n / 2);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        search_space_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 blocks((W + TX - 1) / TX, (H + TY - 1) / TY);
  search_space_kernel<NT><<<blocks, THREADS, smem, stream>>>(
      l, out, H, W, taps, inv_occ_sat, free_threshold, free_penalty);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int slam2d_search_space(const float* logodds, float* out, int H,
                                   int W, const float* taps_host, int n_taps,
                                   float inv_occ_sat, float free_threshold,
                                   float free_penalty, void* stream) {
  Taps taps{};
  if (!load_taps(&taps, taps_host, n_taps) || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  // the frontend's blur at 0.05 m cells (bench.py's config)
  if (n_taps == 13)
    return launch<13>(logodds, out, H, W, taps, inv_occ_sat, free_threshold,
                      free_penalty, s);
  return launch<0>(logodds, out, H, W, taps, inv_occ_sat, free_threshold,
                   free_penalty, s);
}

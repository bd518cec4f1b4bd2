// Per-particle window of the map and its likelihood field, in one pass.
//
// Replaces slam2d_tpu/ops/pallas_field.py:_field_kernel (fused_window_field,
// called by pf/shared_refine.py). For each particle p and its UNCLAMPED
// window origin (a, b), over the win x win window:
//   g     = maps[p, a + r, b + c], or 0 (unknown) off the map
//   occ   = clip(g * inv_sat, 0, 1)
//   blur  = clip(blur_cols(blur_rows(occ)), 0, 1)      zero padding
//   S     = blur - free_penalty * [g < free_logit] * (1 - blur)
// written in the scorer's dtype (float32 or bf16, rounded to nearest even).
// free_logit = logit(free_threshold): the TPU kernel tests the log-odds
// against it instead of the sigmoid against the threshold, and so does this.
// The sums run from tap 0 upward, rows (axis 0) first, as the JAX package's
// blur does, so the field rounds as the plain version does.
//
// What bounds it on the H100: memory. At FastSLAM-100's shapes (100 windows
// of 288^2 from bf16 512^2 maps, bf16 out) the kernel reads 17 MB (26 MB with
// its tiles' halos) and writes 17 MB, ~13 us at 3.35 TB/s, against 18
// multiply-adds a cell. Design: one block per 32 x 32 output tile and
// particle. The block loads the tile and its blur halo once from the map
// (off-window and off-map cells as 0) into shared memory, blurs the rows,
// then the columns, and writes the tile: one read of the map and one write
// of the field, as the TPU kernel does with its VMEM frame. The port needs
// none of that kernel's 8/128 alignment rules, so every map and window size
// takes this kernel. The evidence clip, the taps and the field epilogue are
// shared with search_space.cu (common.cuh).

#include "common.cuh"

namespace {

constexpr int TILE = 32;
constexpr int BX = 32;
constexpr int BY = 8;
constexpr int THREADS = BX * BY;

template <typename TIn, typename TOut>
__global__ void window_field_kernel(const TIn* __restrict__ maps,
                                    const int* __restrict__ origins,
                                    TOut* __restrict__ out, int Hm, int Wm,
                                    int win, Taps taps, float inv_sat,
                                    float free_logit, float free_penalty) {
  extern __shared__ float smem[];
  const int hw = taps.n / 2;
  const int ext = TILE + 2 * hw;
  float* occ = smem;                        // [ext, ext] evidence + halo
  float* rows = occ + ext * ext;            // [TILE, ext] row-blurred
  float* gcen = rows + TILE * ext;          // [TILE, TILE] log-odds
  const int p = blockIdx.z;
  const int a = origins[2 * p];
  const int b = origins[2 * p + 1];
  const int tr = blockIdx.y * TILE;
  const int tc = blockIdx.x * TILE;
  const TIn* map = maps + (size_t)p * Hm * Wm;
  const int tid = threadIdx.y * BX + threadIdx.x;

  for (int idx = tid; idx < ext * ext; idx += THREADS) {
    const int i = idx / ext;
    const int j = idx % ext;
    const int wr = tr - hw + i;
    const int wc = tc - hw + j;
    float g = 0.0f;
    if (wr >= 0 && wr < win && wc >= 0 && wc < win) {
      const long long mr = (long long)a + wr;
      const long long mc = (long long)b + wc;
      if (mr >= 0 && mr < Hm && mc >= 0 && mc < Wm)
        g = load_f32(map + mr * Wm + mc);
    }
    occ[idx] = evidence(g, inv_sat);
    if (i >= hw && i < hw + TILE && j >= hw && j < hw + TILE)
      gcen[(i - hw) * TILE + (j - hw)] = g;
  }
  __syncthreads();

  for (int idx = tid; idx < TILE * ext; idx += THREADS) {
    const int r = idx / ext;
    const int j = idx % ext;
    rows[idx] = blur_dot(occ + r * ext + j, ext, taps);
  }
  __syncthreads();

  for (int idx = tid; idx < TILE * TILE; idx += THREADS) {
    const int r = idx / TILE;
    const int c = idx % TILE;
    if (tr + r >= win || tc + c >= win) continue;
    const float blur = blur_dot(rows + r * ext + c, 1, taps);
    const float S = field_value(blur, gcen[idx] < free_logit, free_penalty);
    store_f32(out + ((size_t)p * win + (tr + r)) * win + (tc + c), S);
  }
}

template <typename TIn, typename TOut>
int launch(const void* maps, const int* origins, void* out, int P, int Hm,
           int Wm, int win, const Taps& taps, float inv_sat, float free_logit,
           float free_penalty, cudaStream_t s) {
  const int ext = TILE + 2 * (taps.n / 2);
  const size_t smem = sizeof(float) * ((size_t)ext * ext + TILE * ext + TILE * TILE);
  auto kernel = window_field_kernel<TIn, TOut>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 blocks((win + TILE - 1) / TILE, (win + TILE - 1) / TILE, P);
  kernel<<<blocks, dim3(BX, BY), smem, s>>>(
      (const TIn*)maps, origins, (TOut*)out, Hm, Wm, win, taps, inv_sat,
      free_logit, free_penalty);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int slam2d_window_field(const void* maps, int in_bf16,
                                   const int* origins, void* out, int out_bf16,
                                   int P, int Hm, int Wm, int win,
                                   const float* taps_host, int n_taps,
                                   float inv_sat, float free_logit,
                                   float free_penalty, void* stream) {
  Taps taps{};
  if (!load_taps(&taps, taps_host, n_taps) || P < 1 || P > 65535 || win < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16 && out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(maps, origins, out, P, Hm, Wm,
                                                win, taps, inv_sat, free_logit,
                                                free_penalty, s);
  if (in_bf16)
    return launch<__nv_bfloat16, float>(maps, origins, out, P, Hm, Wm, win,
                                        taps, inv_sat, free_logit,
                                        free_penalty, s);
  if (out_bf16)
    return launch<float, __nv_bfloat16>(maps, origins, out, P, Hm, Wm, win,
                                        taps, inv_sat, free_logit,
                                        free_penalty, s);
  return launch<float, float>(maps, origins, out, P, Hm, Wm, win, taps,
                              inv_sat, free_logit, free_penalty, s);
}

// Shared helpers of the slam2d_tpu_torch kernels.
//
// The kernels are held bit for bit against plain PyTorch and JAX code, which
// round after every float32 operation. nvcc would contract a*b + c into one
// fused multiply-add with a single rounding, so the arithmetic that decides
// a cell or a score is written with the _rn intrinsics, which it never
// contracts; where XLA itself contracts one on the CPU, the kernel says
// fmaf.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define F_ADD __fadd_rn
#define F_SUB __fsub_rn
#define F_MUL __fmul_rn
#define F_DIV __fdiv_rn

// float32(pi) and float32(2 pi), as jnp.pi and torch round them
#define PI_F 3.14159265358979323846f
#define TWO_PI_F 6.28318530717958647692f

// Python-style float modulo with a positive divisor (jnp.mod, torch.remainder)
__device__ __forceinline__ float mod_pos(float x, float y) {
  float m = fmodf(x, y);
  return (m != 0.0f && m < 0.0f) ? F_ADD(m, y) : m;
}

// slam2d_tpu/ops/pallas_update.py:_atan2, the reference update kernel's
// polynomial arctangent, as XLA compiles it on the CPU: each Horner step is
// one fused multiply-add (fmaf, one rounding). The same bits as
// core/numerics.py:atan2_ref; the coefficients are its float32 values.
__device__ __forceinline__ float atan2_ref(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float q = F_DIV(fminf(ax, ay), fmaxf(fmaxf(ax, ay), 0x1.79ca1p-67f));
  const float q2 = F_MUL(q, q);
  float p = -0x1.09afcep-8f;
  p = fmaf(q2, p, 0x1.662ca4p-6f);
  p = fmaf(q2, p, -0x1.ca0388p-5f);
  p = fmaf(q2, p, 0x1.8aefbep-4f);
  p = fmaf(q2, p, -0x1.1cd8c6p-3f);
  p = fmaf(q2, p, 0x1.98814cp-3f);
  p = fmaf(q2, p, -0x1.554c38p-2f);
  p = fmaf(q2, p, 0x1.ffffeap-1f);
  float a = F_MUL(q, p);
  if (ay > ax) a = F_SUB(0x1.921fb6p+0f, a);  // float32(pi / 2)
  if (x < 0.0f) a = F_SUB(PI_F, a);
  return y < 0.0f ? -a : a;
}

// jnp.clip / torch.clamp of a non-NaN value
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// Map storage: float32 or bfloat16 (the particle filter's maps). Loads widen
// to float32 exactly; stores round to nearest even once, as astype does.
__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// ---- the particle forms of kernel 1 (update_ray.cu, update_hybrid.cu) -----
//
// A warp updates a PATCH x PATCH patch of a particle's window: each thread
// V cells along a row (one 16-byte vector: 4 float32 or 8 bfloat16), TPR
// threads along a patch row, RPP rows a pass, RY passes. The patches lie on
// the lattice of the map's vectors, so a window whose first column is not
// a multiple of V begins inside its first column of patches.
constexpr int PATCH = 16;
constexpr int PT = 256;  // threads of a particle block
constexpr int PWARPS = PT / 32;

template <typename T>
struct PatchCells {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int TPR = PATCH / V;
  static constexpr int RPP = 32 / TPR;
  static constexpr int RY = PATCH / RPP;
  static_assert(PATCH % V == 0 && 32 % TPR == 0 && PATCH % RPP == 0, "patch");
};

// One vector's V cells, widened to float32 (exactly) and rounded back once
__device__ __forceinline__ void vec_load(const float* p, float* c) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  c[0] = r.x, c[1] = r.y, c[2] = r.z, c[3] = r.w;
}
__device__ __forceinline__ void vec_load(const __nv_bfloat16* p, float* c) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int v = 0; v < 8; ++v)
    c[v] = __uint_as_float(v & 1 ? w[v >> 1] & 0xffff0000u : w[v >> 1] << 16);
}
__device__ __forceinline__ void vec_store(float* p, const float* c) {
  *reinterpret_cast<float4*>(p) = make_float4(c[0], c[1], c[2], c[3]);
}
__device__ __forceinline__ void vec_store(__nv_bfloat16* p, const float* c) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(c[2 * i])) |
           (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(c[2 * i + 1]))
               << 16;
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The V cells at `p`, window columns col .. col + V - 1 of a row of a
// window `w` wide (`in_rows`: the row lies in the window): one vector load
// when `vec` (p is then 16-byte aligned), else the window's cells one by
// one; cells outside the window read as 0 (they are never stored)
template <typename T>
__device__ __forceinline__ void load_cells(const T* p, bool in_rows, int col,
                                           int w, bool vec, float* c) {
  constexpr int V = PatchCells<T>::V;
  if (in_rows && vec && col < w && col + V > 0) {
    vec_load(p, c);
    return;
  }
#pragma unroll
  for (int v = 0; v < V; ++v)
    c[v] = in_rows && col + v >= 0 && col + v < w ? load_f32(p + v) : 0.0f;
}

// Store the cells of the window among them: one vector store where all V
// lie in it and `vec`, else one by one
template <typename T>
__device__ __forceinline__ void store_cells(T* p, bool in_rows, int col,
                                            int w, bool vec, const float* c) {
  constexpr int V = PatchCells<T>::V;
  if (!in_rows) return;
  if (vec && col >= 0 && col + V <= w) {
    vec_store(p, c);
    return;
  }
#pragma unroll
  for (int v = 0; v < V; ++v)
    if (col + v >= 0 && col + v < w) store_f32(p + v, c[v]);
}

// Blocks of `kernel` that the card holds at once with `smem` bytes of
// shared memory a block, its largest: the SMs times the blocks an SM
// holds (the particle forms' persistent grid), found once a device
template <typename K>
inline int resident_blocks(K kernel, int threads, size_t smem) {
  static int found[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (found[dev] == 0) {
    int sms = 1, per_sm = 1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  smem);
    found[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return found[dev];
}

// The particle forms' grid: (blocks a particle, P), at least the card's
// resident blocks in all, and no more blocks a particle than its largest
// window's patches need (a warp takes one patch at a time)
inline dim3 particle_grid(int resident, int P, int h, int w, int V) {
  const int patches = (h + PATCH - 1) / PATCH * ((w + V - 1) / PATCH + 1);
  const int fill = (resident + P - 1) / P;
  const int most = (patches + PWARPS - 1) / PWARPS;
  return dim3(fill < 1 ? 1 : (fill < most ? fill : most), P);
}

// ---- the likelihood field of the matchers (build_search_space) ----------
//
// The blur taps travel by value in a launch's parameters.
constexpr int MAX_TAPS = 63;

struct Taps {
  float k[MAX_TAPS];
  int n;
};

__host__ inline bool load_taps(Taps* taps, const float* host, int n) {
  if (n < 1 || n > MAX_TAPS || n % 2 == 0) return false;
  for (int i = 0; i < n; ++i) taps->k[i] = host[i];
  taps->n = n;
  return true;
}

// Clipped occupancy evidence of a log-odds value: clip(l * (1/sat), 0, 1)
__device__ __forceinline__ float evidence(float l, float inv_sat) {
  return clampf(F_MUL(l, inv_sat), 0.0f, 1.0f);
}

// One output of a 1-D blur: sum_k taps[k] * x[k * stride], from tap 0 up, as
// the JAX package's _separable_blur adds its shifted terms
__device__ __forceinline__ float blur_dot(const float* x, int stride,
                                          const Taps& taps) {
  float acc = 0.0f;
  for (int k = 0; k < taps.n; ++k) acc = F_ADD(acc, F_MUL(taps.k[k], x[k * stride]));
  return acc;
}

// Field value from the clipped blur and the known-free test:
// blur - free_penalty * free * (1 - blur)
__device__ __forceinline__ float field_value(float blur_raw, bool is_free,
                                             float free_penalty) {
  const float blur = clampf(blur_raw, 0.0f, 1.0f);
  return F_SUB(blur, F_MUL(F_MUL(free_penalty, is_free ? 1.0f : 0.0f),
                           F_SUB(1.0f, blur)));
}

// ---- Hopper's asynchronous copies (gather_rows.cu, window_field.cu) -------
//
// A bulk or tensor copy into shared memory reports the bytes it has landed
// to an mbarrier there; one thread arms the barrier with the byte count
// (expect_tx) and issues the copy, the readers wait on the barrier's phase.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(arrivals)
               : "memory");
}

// after the inits, before any copy may signal the barriers
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier has completed the phase of this parity (0 for its
// first use, 1 for the second, ...)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

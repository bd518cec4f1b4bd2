// Block-Thomas factor of a symmetric block-tridiagonal matrix of 3x3 blocks.
//
// Replaces slam2d_tpu/graph/sparse.py:_tridiag_factor (a lax.scan, not a
// Pallas kernel: the JAX package leaves it to XLA): for T = tridiag(O^T, D, O)
// with K diagonal blocks D[k] and chain off-diagonals O[k] = block (k, k+1),
//   C[k]    = D[k] - O[k-1]^T C[k-1]^-1 O[k-1]      (O[-1] = 0)
//   Cinv[k] = C[k]^-1
// in float32, the inverse by cofactors: with the rows a0, a1, a2 of C,
// C^-1 = [a1 x a2 | a2 x a0 | a0 x a1] / (a0 . (a1 x a2)) (the cross products
// as columns). Every product, sum and the division are rounded one at a
// time (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: no contraction), in the
// order of the plain version, graph/sparse.py:tridiag_factor_plain, so the
// two agree but for the order of a three-term sum. The JAX package inverts
// with an LU factor (jnp.linalg.inv); the blocks are SPD and well conditioned
// (the gauge is clamped by projection), so the two differ by a few ulps a
// block (tests/test_torch_sparse_graph.py states the tolerance).
//
// What bounds it on the H100: the recurrence is sequential in k. Its bytes
// (D and O read, Cinv written: 108 bytes a block, 1.8 MB at K = 16384) take
// 0.5 us at 3.35 TB/s and its ~170 operations a block less, but each step
// waits for the last: a chain of ~20 dependent float32 operations and a
// division a block, ~100 cycles, so ~1 ms at K = 16384.
// Design: one block of 256 threads. The block copies a chunk of CHUNK blocks
// of D and O into shared memory (coalesced, all threads), then one thread
// walks the chunk with C^-1 of the last step in registers, the next step's
// loads from shared memory independent of the chain, and writes each Cinv
// back into the chunk's D slot; then all threads copy the chunk out. The copy
// of a chunk takes ~2% of its walk. Replacing the K-step PyTorch loop (about
// ten launches a step) is the point; a parallel form (a prefix product of
// 6x6 transfer matrices) is numerically unstable and is not attempted.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 512;  // 3x3 blocks of D and of O a chunk: 36,864 bytes

struct M3 {
  float m[9];
};

__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  // ((a0 b0 + a1 b1) + a2 b2), each product and sum rounded
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

// C = A B for row-major 3x3
__device__ __forceinline__ M3 mm(const M3& a, const M3& b) {
  M3 c;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c.m[3 * i + j] = dot3(a.m[3 * i], b.m[j], a.m[3 * i + 1], b.m[3 + j],
                            a.m[3 * i + 2], b.m[6 + j]);
  return c;
}

// C = A^T B
__device__ __forceinline__ M3 mtm(const M3& a, const M3& b) {
  M3 c;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c.m[3 * i + j] = dot3(a.m[i], b.m[j], a.m[3 + i], b.m[3 + j],
                            a.m[6 + i], b.m[6 + j]);
  return c;
}

__device__ __forceinline__ float cross_term(float p, float q, float r,
                                            float s) {
  return __fsub_rn(__fmul_rn(p, q), __fmul_rn(r, s));
}

__device__ __forceinline__ M3 inv_cofactor(const M3& c) {
  const float* a = c.m;
  // x = a1 x a2, y = a2 x a0, z = a0 x a1 (the columns of the adjugate)
  float x0 = cross_term(a[4], a[8], a[5], a[7]);
  float x1 = cross_term(a[5], a[6], a[3], a[8]);
  float x2 = cross_term(a[3], a[7], a[4], a[6]);
  float y0 = cross_term(a[7], a[2], a[8], a[1]);
  float y1 = cross_term(a[8], a[0], a[6], a[2]);
  float y2 = cross_term(a[6], a[1], a[7], a[0]);
  float z0 = cross_term(a[1], a[5], a[2], a[4]);
  float z1 = cross_term(a[2], a[3], a[0], a[5]);
  float z2 = cross_term(a[0], a[4], a[1], a[3]);
  float det = dot3(a[0], x0, a[1], x1, a[2], x2);
  M3 r;
  r.m[0] = __fdiv_rn(x0, det);
  r.m[1] = __fdiv_rn(y0, det);
  r.m[2] = __fdiv_rn(z0, det);
  r.m[3] = __fdiv_rn(x1, det);
  r.m[4] = __fdiv_rn(y1, det);
  r.m[5] = __fdiv_rn(z1, det);
  r.m[6] = __fdiv_rn(x2, det);
  r.m[7] = __fdiv_rn(y2, det);
  r.m[8] = __fdiv_rn(z2, det);
  return r;
}

__global__ void __launch_bounds__(THREADS)
    tridiag_factor_kernel(const float* __restrict__ D,
                          const float* __restrict__ O,
                          float* __restrict__ Cinv, int K) {
  __shared__ float sD[CHUNK * 9];
  __shared__ float sO[CHUNK * 9];
  M3 cinv_prev;   // C[k-1]^-1, live in thread 0 across chunks
  M3 o_prev;      // O[k-1]
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    cinv_prev.m[i] = 0.0f;
    o_prev.m[i] = 0.0f;
  }
  for (int k0 = 0; k0 < K; k0 += CHUNK) {
    const int n = min(CHUNK, K - k0);
    for (int i = threadIdx.x; i < n * 9; i += THREADS) {
      sD[i] = D[k0 * 9 + i];
      sO[i] = O[k0 * 9 + i];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int k = 0; k < n; ++k) {
        M3 d;
#pragma unroll
        for (int i = 0; i < 9; ++i) d.m[i] = sD[k * 9 + i];
        // C = D - O^T (C_prev^-1 O)
        M3 t = mtm(o_prev, mm(cinv_prev, o_prev));
        M3 c;
#pragma unroll
        for (int i = 0; i < 9; ++i) c.m[i] = __fsub_rn(d.m[i], t.m[i]);
        cinv_prev = inv_cofactor(c);
#pragma unroll
        for (int i = 0; i < 9; ++i) {
          sD[k * 9 + i] = cinv_prev.m[i];
          o_prev.m[i] = sO[k * 9 + i];
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n * 9; i += THREADS)
      Cinv[k0 * 9 + i] = sD[i];
    __syncthreads();
  }
}

}  // namespace

extern "C" int slam2d_tridiag_factor(const float* D, const float* O,
                                     float* Cinv, int K, void* stream) {
  if (K > 0)
    tridiag_factor_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(D, O,
                                                                   Cinv, K);
  return (int)cudaGetLastError();
}

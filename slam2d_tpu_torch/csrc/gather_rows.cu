// Ancestor-row gather of the particle filter's resampling step:
//   out[p, :] = x[ancestors[p], :]      over [P, N] rows of any dtype
//
// Replaces slam2d_tpu/ops/pallas_gather.py:_copy_kernel (gather_rows_pallas,
// called by pf/fastslam.py:_resample_copy). Out of place, as there: a row
// can be both a source and a destination, and blocks run in no order, so an
// in-place gather would read rows already overwritten. The copy moves bits,
// so it is exact for every dtype. Ancestors are clamped into [0, P), as
// systematic_ancestors already clips them, so a bad index can never read
// outside x.
//
// What bounds it on the H100: memory, and nothing else. Every distinct
// ancestor row has to be read once and all P rows written once (FastSLAM's
// bf16 512^2 maps: 0.5 MB a row; what a repeated ancestor is read again
// comes from L2, since systematic resampling's sorted ancestors make the
// rows that share a source neighbours in the grid). A copy reaches that
// bound only with many bytes in flight on every SM.
//
// Design: one grid row per particle and a few long-lived blocks per row;
// each thread keeps UNROLL independent loads in flight before its stores,
// of the widest word that the row length and both pointers are aligned to
// ("vector16", "vector4", "vector1": chosen from the operands' alignment
// alone). On the H100 the 16-byte variant moves 2.96 TB/s at FastSLAM-1000's
// shape, what cudaMemcpy reaches device to device there, and 3% more than
// the best of the bulk-copy rings tried in its place (cp.async.bulk through
// shared memory with mbarriers, one issuing thread a block, over chunk
// sizes, depths and grids, with and without one load feeding a run of equal
// ancestors: scripts/tune_gather_rows.cu, PERF.md).

#include <cstdint>

#include "common.cuh"

namespace {

__device__ __forceinline__ int clamp_row(int a, int P) {
  return min(max(a, 0), P - 1);
}

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int MAX_BLOCKS_PER_ROW = 64;

template <typename V>
__global__ void __launch_bounds__(THREADS)
gather_rows_vector_kernel(const V* __restrict__ x, V* __restrict__ out,
                          const int* __restrict__ ancestors, int P,
                          long long n) {
  const int p = blockIdx.y;
  const V* src = x + (size_t)clamp_row(ancestors[p], P) * n;
  V* dst = out + (size_t)p * n;
  const long long span = (long long)THREADS * UNROLL;
  for (long long base = (long long)blockIdx.x * span; base < n;
       base += (long long)gridDim.x * span) {
    V v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + u * THREADS + threadIdx.x;
      if (i < n) v[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + u * THREADS + threadIdx.x;
      if (i < n) dst[i] = v[u];
    }
  }
}

template <typename V>
int launch_vector(const void* x, void* out, const int* anc, int P,
                  long long row_bytes, cudaStream_t s) {
  const long long n = row_bytes / (long long)sizeof(V);
  const long long span = (long long)THREADS * UNROLL;
  long long bx = (n + span - 1) / span;
  if (bx > MAX_BLOCKS_PER_ROW) bx = MAX_BLOCKS_PER_ROW;
  const dim3 blocks((unsigned)bx, P);
  gather_rows_vector_kernel<V><<<blocks, THREADS, 0, s>>>(
      (const V*)x, (V*)out, anc, P, n);
  return (int)cudaGetLastError();
}

int last_variant = -1;

}  // namespace

// The variant that the last launch of slam2d_gather_rows ran (-1: none yet):
// 0 words of 16 bytes, 1 of 4 bytes, 2 single bytes
extern "C" int slam2d_gather_rows_last_variant() { return last_variant; }

extern "C" int slam2d_gather_rows(const void* x, void* out,
                                  const int* ancestors, int P,
                                  long long row_bytes, void* stream) {
  if (P < 1 || P > 65535 || row_bytes < 0) return (int)cudaErrorInvalidValue;
  if (row_bytes == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  // the widest word that the row length and both pointers are aligned to
  const uintptr_t align = (uintptr_t)x | (uintptr_t)out | (uintptr_t)row_bytes;
  if (align % 16 == 0) {
    last_variant = 0;
    return launch_vector<uint4>(x, out, ancestors, P, row_bytes, s);
  }
  if (align % 4 == 0) {
    last_variant = 1;
    return launch_vector<uint32_t>(x, out, ancestors, P, row_bytes, s);
  }
  last_variant = 2;
  return launch_vector<uint8_t>(x, out, ancestors, P, row_bytes, s);
}

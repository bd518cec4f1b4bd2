// Ancestor-row gather of the particle filter's resampling step:
//   out[p, :] = x[ancestors[p], :]      over [P, N] rows of any dtype
//
// Replaces slam2d_tpu/ops/pallas_gather.py:_copy_kernel (gather_rows_pallas,
// called by pf/fastslam.py:_resample_copy). Out of place, as there: a row
// can be both a source and a destination, and blocks run in no order, so an
// in-place gather would read rows already overwritten.
//
// What bounds it on the H100: it is a copy, P * N bytes read and written (at
// FastSLAM-100's 100 bf16 maps of 512^2, 52 MB each way, ~31 us at
// 3.35 TB/s). Design: a 2-D grid, one grid row per particle (blockIdx.y),
// whose blocks stride over the row with 16-byte loads and stores when the
// row and both pointers allow it (4- or 1-byte words otherwise). Each block
// reads its ancestor once. The copy moves bits, so it is exact for every
// dtype. Ancestors are clamped into [0, P), as systematic_ancestors already
// clips them, so a bad index can never read outside x.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS_PER_ROW = 256;

template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ x,
                                   V* __restrict__ out,
                                   const int* __restrict__ ancestors, int P,
                                   long long n) {
  const int p = blockIdx.y;
  const int a = min(max(ancestors[p], 0), P - 1);
  const V* src = x + (size_t)a * n;
  V* dst = out + (size_t)p * n;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * THREADS) {
    dst[i] = src[i];
  }
}

template <typename V>
int launch(const void* x, void* out, const int* anc, int P,
           long long row_bytes, cudaStream_t s) {
  const long long n = row_bytes / (long long)sizeof(V);
  long long bx = (n + THREADS - 1) / THREADS;
  if (bx > MAX_BLOCKS_PER_ROW) bx = MAX_BLOCKS_PER_ROW;
  if (bx < 1) bx = 1;
  const dim3 blocks((unsigned)bx, P);
  gather_rows_kernel<V><<<blocks, THREADS, 0, s>>>((const V*)x, (V*)out, anc,
                                                   P, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int slam2d_gather_rows(const void* x, void* out,
                                  const int* ancestors, int P,
                                  long long row_bytes, void* stream) {
  if (P < 1 || P > 65535 || row_bytes < 0) return (int)cudaErrorInvalidValue;
  if (row_bytes == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t align = (uintptr_t)x | (uintptr_t)out;
  if (row_bytes % 16 == 0 && align % 16 == 0)
    return launch<uint4>(x, out, ancestors, P, row_bytes, s);
  if (row_bytes % 4 == 0 && align % 4 == 0)
    return launch<uint32_t>(x, out, ancestors, P, row_bytes, s);
  return launch<uint8_t>(x, out, ancestors, P, row_bytes, s);
}

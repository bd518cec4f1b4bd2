// Endpoint-splat shift stack of the shared-anchor particle refine:
//   stack[g, dr*C + dc, h, w] = E[g, h - dr, w - dc]   (0 off the low edge)
// for E [G, win, win] of any dtype, out [G, R*C, win, win] in E's dtype.
//
// Replaces slam2d_tpu/ops/pallas_stack.py:_stack_kernel (shift_stack_pallas,
// called by pf/shared_refine.py:endpoint_shift_stack). The stack is the
// right-hand operand of the one product that scores every particle.
//
// What bounds it on the H100: the write. At FastSLAM-100's shapes (G = 15,
// R = C = 5, win = 288, bf16) the stack is 62 MB against a 2.5 MB E that
// stays in L2, ~19 us of HBM writes at 3.35 TB/s. Design: one thread per 16
// bytes of output (8 bf16 or 4 float32 values of one row), a flat grid over
// the whole stack; each thread reads its V source values (L1/L2 hits: every
// E row is read R*C times) and writes one 16-byte vector, so a warp stores
// 512 contiguous bytes. Rows whose length is not a multiple of V take the
// one-value-per-thread form. Values are moved as bits, so the stack is
// bit-exact with the plain version in every dtype.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T x[V];
};

template <typename T, int V>
__global__ void shift_stack_kernel(const T* __restrict__ E,
                                   T* __restrict__ out, int R, int C, int win,
                                   long long n_vec) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_vec) return;
  const int per_row = win / V;
  const int w0 = (int)(i % per_row) * V;
  long long rest = i / per_row;
  const int h = (int)(rest % win);
  rest /= win;
  const int l = (int)(rest % (R * C));
  const long long g = rest / (R * C);
  const int dr = l / C;
  const int dc = l % C;
  Vec<T, V> v;
#pragma unroll
  for (int k = 0; k < V; ++k) v.x[k] = T(0);
  if (h >= dr) {
    const T* src = E + (g * win + (h - dr)) * (long long)win;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int w = w0 + k;
      if (w >= dc) v.x[k] = src[w - dc];
    }
  }
  reinterpret_cast<Vec<T, V>*>(out)[i] = v;
}

template <typename T>
int launch(const void* E, void* out, int G, int R, int C, int win,
           cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = win % V == 0;
  const long long n =
      (long long)G * R * C * win * win / (vec ? V : 1);
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  if (vec) {
    shift_stack_kernel<T, V><<<blocks, THREADS, 0, s>>>(
        (const T*)E, (T*)out, R, C, win, n);
  } else {
    shift_stack_kernel<T, 1><<<blocks, THREADS, 0, s>>>(
        (const T*)E, (T*)out, R, C, win, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int slam2d_shift_stack(const void* E, void* out, int elem_bytes,
                                  int G, int R, int C, int win, void* stream) {
  if (G < 1 || R < 1 || C < 1 || win < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem_bytes) {
    case 1: return launch<uint8_t>(E, out, G, R, C, win, s);
    case 2: return launch<uint16_t>(E, out, G, R, C, win, s);
    case 4: return launch<uint32_t>(E, out, G, R, C, win, s);
    case 8: return launch<uint64_t>(E, out, G, R, C, win, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

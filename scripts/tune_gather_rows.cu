// Stand-alone timing of designs for the port's row gather (kernel 4,
// csrc/gather_rows.cu) on one GPU, without PyTorch: the register path at
// several unrolls and grids, the bulk-copy ring (cp.async.bulk through shared
// memory) at several chunk sizes, depths and grids, with and without one load
// feeding every row of a run of equal ancestors, the kernel before the
// redesign (one 16-byte word a thread, 128 blocks a row), and cudaMemcpy
// device to device of all rows as the card's practical copy rate. Rows of
// 524288 bytes (a bf16 512^2 map), 1000 and 100 of them, sorted random
// ancestors. From the repository root, on a machine with nvcc:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o /tmp/tune_gather scripts/tune_gather_rows.cu && /tmp/tune_gather
//
// Each line: the least of 5 runs of 20 launches between two CUDA events, and
// whether the first and last 32 bytes of every row came out right.
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "../slam2d_tpu_torch/csrc/common.cuh"  // the mbarrier helpers

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ int clamp_row(int a, int P) { return min(max(a, 0), P - 1); }

// MODE 0: run merging (as the repo's kernel); MODE 1: no merging, one load one store per item
template <int CHUNK, int STAGES, int MODE, int AHEAD>
__global__ void __launch_bounds__(32) ring(const unsigned char* __restrict__ x, unsigned char* __restrict__ out,
                                           const int* __restrict__ anc, int P, long long row_bytes, int chunks) {
  extern __shared__ __align__(128) unsigned char buf[];
  __shared__ __align__(8) unsigned long long full[STAGES];
  if (threadIdx.x != 0) return;
  for (int s = 0; s < STAGES; ++s) mbar_init(smem_addr(&full[s]), 1);
  mbar_init_fence();
  const int n_items = P * chunks;
  const int step = gridDim.x;
  constexpr int RUN = 8;
  auto leads = [&](int p) { return MODE == 1 || p % RUN == 0 || clamp_row(anc[p], P) != clamp_row(anc[p - 1], P); };
  auto next = [&](int i) { while (i < n_items && !leads(i / chunks)) i += step; return i; };
  int li = next(blockIdx.x), si = li, loaded = 0, stored = 0;
  auto load = [&]() {
    const int p = li / chunks; const long long off = (long long)(li % chunks) * CHUNK;
    const uint32_t bytes = (uint32_t)min((long long)CHUNK, row_bytes - off);
    const int s = loaded % STAGES; const uint32_t bar = smem_addr(&full[s]);
    mbar_expect_tx(bar, bytes);
    bulk_load(smem_addr(buf + (size_t)s * CHUNK), x + (size_t)clamp_row(anc[p], P) * row_bytes + off, bytes, bar);
    ++loaded; li = next(li + step);
  };
  while (loaded < AHEAD && li < n_items) load();
  while (si < n_items) {
    const int s = stored % STAGES;
    mbar_wait(smem_addr(&full[s]), (stored / STAGES) & 1);
    const int p = si / chunks; const long long off = (long long)(si % chunks) * CHUNK;
    const uint32_t bytes = (uint32_t)min((long long)CHUNK, row_bytes - off);
    const uint32_t src = smem_addr(buf + (size_t)s * CHUNK);
    int q = p;
    do { bulk_store(out + (size_t)q * row_bytes + off, src, bytes); ++q; } while (MODE == 0 && q < P && !leads(q));
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    ++stored; si = next(si + step);
    if (li < n_items) {
      // stage of item `loaded` was used by item loaded - STAGES; groups committed so far: stored.
      // allow (stored - 1 - (loaded - STAGES)) newer groups pending = STAGES - 1 - AHEAD ... constant
      if (STAGES - AHEAD == 1) asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      else if (STAGES - AHEAD == 2) asm volatile("cp.async.bulk.wait_group.read 2;" ::: "memory");
      else if (STAGES - AHEAD == 3) asm volatile("cp.async.bulk.wait_group.read 3;" ::: "memory");
      else asm volatile("cp.async.bulk.wait_group.read 4;" ::: "memory");
      load();
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <int UNROLL, int THREADS>
__global__ void __launch_bounds__(THREADS) vec(const uint4* __restrict__ x, uint4* __restrict__ out, const int* __restrict__ anc, int P, long long n) {
  const int p = blockIdx.y;
  const uint4* src = x + (size_t)clamp_row(anc[p], P) * n;
  uint4* dst = out + (size_t)p * n;
  const long long span = (long long)THREADS * UNROLL;
  for (long long base = (long long)blockIdx.x * span; base < n; base += (long long)gridDim.x * span) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) { const long long i = base + u * THREADS + threadIdx.x; if (i < n) v[u] = src[i]; }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) { const long long i = base + u * THREADS + threadIdx.x; if (i < n) dst[i] = v[u]; }
  }
}

// the parent kernel: one load and store per thread-iteration
__global__ void parent(const uint4* __restrict__ x, uint4* __restrict__ out, const int* __restrict__ anc, int P, long long n) {
  const int p = blockIdx.y;
  const uint4* src = x + (size_t)clamp_row(anc[p], P) * n;
  uint4* dst = out + (size_t)p * n;
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < n; i += (long long)gridDim.x * 256) dst[i] = src[i];
}

static unsigned char *X, *O; static int* A; static int P; static long long RB = 524288;
template <typename F> float timeit(F f, int n = 20) {
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  f(); f(); cudaDeviceSynchronize();
  float best = 1e9;
  for (int r = 0; r < 5; ++r) { cudaEventRecord(a); for (int i = 0; i < n; ++i) f(); cudaEventRecord(b); cudaEventSynchronize(b); float ms; cudaEventElapsedTime(&ms, a, b); best = std::min(best, ms / n); }
  cudaError_t e = cudaGetLastError(); if (e != cudaSuccess) printf("ERR %s\n", cudaGetErrorString(e));
  return best;
}
bool check(const std::vector<int>& anc) {
  bool ok = true;
  for (int p = 0; p < P; ++p) {
    unsigned char a[64], b[64];
    cudaMemcpy(a, O + (size_t)p * RB, 32, cudaMemcpyDeviceToHost); cudaMemcpy(a + 32, O + (size_t)p * RB + RB - 32, 32, cudaMemcpyDeviceToHost);
    cudaMemcpy(b, X + (size_t)anc[p] * RB, 32, cudaMemcpyDeviceToHost); cudaMemcpy(b + 32, X + (size_t)anc[p] * RB + RB - 32, 32, cudaMemcpyDeviceToHost);
    for (int i = 0; i < 64; ++i) ok = ok && a[i] == b[i];
  }
  return ok;
}
template <int CHUNK, int STAGES, int MODE, int AHEAD> void run_ring(int bps, const std::vector<int>& anc) {
  auto k = ring<CHUNK, STAGES, MODE, AHEAD>;
  size_t smem = (size_t)CHUNK * STAGES;
  if (smem * bps > 220 * 1024) return;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int chunks = (int)((RB + CHUNK - 1) / CHUNK);
  int blocks = std::min(132 * bps, P * chunks);
  cudaMemset(O, 0, (size_t)P * RB);
  float ms = timeit([&] { k<<<blocks, 32, smem>>>(X, O, A, P, RB, chunks); });
  printf("P=%d ring chunk=%dK stages=%d ahead=%d mode=%d bps=%d: %.4f ms %s\n", P, CHUNK / 1024, STAGES, AHEAD, MODE, bps, ms, check(anc) ? "ok" : "WRONG");
}
template <int U, int T> void run_vec(int maxb, const std::vector<int>& anc) {
  long long n = RB / 16; long long span = (long long)T * U; int bx = (int)std::min<long long>((n + span - 1) / span, maxb);
  cudaMemset(O, 0, (size_t)P * RB);
  float ms = timeit([&] { vec<U, T><<<dim3(bx, P), T>>>((const uint4*)X, (uint4*)O, A, P, n); });
  printf("P=%d vec unroll=%d threads=%d bx=%d: %.4f ms %s\n", P, U, T, bx, ms, check(anc) ? "ok" : "WRONG");
}
int main() {
  for (int P_ : {1000, 100}) {
    P = P_;
    cudaMalloc(&X, (size_t)P * RB); cudaMalloc(&O, (size_t)P * RB); cudaMalloc(&A, P * 4);
    std::vector<int> anc(P); srand(1); for (auto& a : anc) a = rand() % P; std::sort(anc.begin(), anc.end());
    int distinct = 1; for (int i = 1; i < P; ++i) distinct += anc[i] != anc[i - 1];
    cudaMemcpy(A, anc.data(), P * 4, cudaMemcpyHostToDevice);
    std::vector<unsigned> h((size_t)P * RB / 4); for (size_t i = 0; i < h.size(); ++i) h[i] = (unsigned)(i * 2654435761u);
    cudaMemcpy(X, h.data(), (size_t)P * RB, cudaMemcpyHostToDevice);
    printf("P=%d distinct=%d bound %.4f ms\n", P, distinct, (double)(distinct + P) * RB / 3.35e12 * 1e3);
    { long long n = RB / 16; cudaMemset(O, 0, (size_t)P * RB);
      float ms = timeit([&] { parent<<<dim3(128, P), 256>>>((const uint4*)X, (uint4*)O, A, P, n); });
      printf("P=%d parent: %.4f ms %s\n", P, ms, check(anc) ? "ok" : "WRONG"); }
    { float ms = timeit([&] { cudaMemcpyAsync(O, X, (size_t)P * RB, cudaMemcpyDeviceToDevice); }); printf("P=%d cudaMemcpy D2D (all rows, no gather): %.4f ms\n", P, ms); }
    run_vec<4, 256>(64, anc); run_vec<4, 256>(32, anc); run_vec<8, 256>(16, anc); run_vec<2, 256>(64, anc); run_vec<4, 512>(16, anc); run_vec<8, 128>(32, anc);
    for (int bps : {1, 2, 3, 4, 6}) {
      run_ring<16384, 4, 0, 3>(bps, anc); run_ring<16384, 4, 1, 3>(bps, anc); run_ring<16384, 4, 0, 2>(bps, anc);
      run_ring<32768, 4, 0, 3>(bps, anc); run_ring<32768, 3, 0, 2>(bps, anc); run_ring<32768, 4, 0, 2>(bps, anc);
      run_ring<8192, 4, 0, 3>(bps, anc); run_ring<8192, 8, 0, 4>(bps, anc); run_ring<8192, 6, 0, 3>(bps, anc);
      run_ring<65536, 3, 0, 2>(bps, anc); run_ring<65536, 2, 0, 1>(bps, anc);
      run_ring<16384, 6, 0, 3>(bps, anc); run_ring<16384, 8, 0, 4>(bps, anc);
    }
    cudaFree(X); cudaFree(O); cudaFree(A);
  }
  return 0;
}

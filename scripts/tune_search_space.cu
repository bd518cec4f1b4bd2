// Stand-alone timing of the port's search-space build (kernel 3), without
// PyTorch: for work on csrc/search_space.cu. Built and driven by
// scripts/tune_kernel.sh (KERNEL = search_space), which passes the kernel
// source to time (the repository's, a copy edited by a sed expression, or
// any other file with the same C entry point, e.g. an older version) as
// VARIANT_FILE. Both forms of the entry point are taken: with the scratch
// plane of the two-pass kernel (an argument after the log-odds) and without.
//
// bench.py's matcher (13 taps: sigma 2 cells, halfwidth 6; occ_sat 2,
// free_threshold 0.45, free_penalty 0.6) on a seeded log-odds map with
// walls: free space (l in [-3, -0.1]), unknown cells (0), walls (l in
// [1, 6]) along every 37th row and 53rd column, noise spots from -6 to 6,
// and cells one float32 ulp either side of logit(0.45), so that the free
// test takes both sides and every clip bites. Timed at the frontend's 520^2
// update window (a window cut from the 1024^2 map) and at the whole 1024^2
// map. For each it prints the least of 5 runs of 100 launches between two
// CUDA events and a checksum of S from one launch: two variants that compute
// the same field print the same checksum. Last, the same timing of an empty
// kernel: the floor under any launch. With a second argument N it then
// times N more launches at 1024^2 in one run (to sample the clocks).
#include VARIANT_FILE

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <type_traits>
#include <vector>

__global__ void empty_tune_kernel() {}

static uint32_t lcg = 1357u;
static float uniform(float lo, float hi) {
  lcg = lcg * 1664525u + 1013904223u;
  return lo + (hi - lo) * (float)(lcg >> 8) * (1.0f / 16777216.0f);
}

// The entry point with or without the two-pass kernel's scratch plane
template <typename F>
int call_entry(F fn, const float* l, float* scratch, float* out, int H, int W,
               const float* taps, int n) {
  const float inv_sat = 0.5f, thr = 0.45f, pen = 0.6f;
  if constexpr (std::is_invocable_v<F, const float*, float*, float*, int, int,
                                    const float*, int, float, float, float,
                                    void*>)
    return fn(l, scratch, out, H, W, taps, n, inv_sat, thr, pen, nullptr);
  else
    return fn(l, out, H, W, taps, n, inv_sat, thr, pen, nullptr);
}

int main(int argc, char** argv) {
  const char* name = argc > 1 ? argv[1] : "?";
  const int M = 1024, WIN = 520, HWID = 6;
  float taps[2 * HWID + 1];
  for (int i = 0; i <= 2 * HWID; ++i) {
    const float x = (float)(i - HWID) / 2.0f;
    taps[i] = expf(-0.5f * x * x);   // the peak, tap HWID, is exactly 1
  }
  const float logit = logf(0.45f / 0.55f);
  std::vector<float> map((size_t)M * M);
  for (int r = 0; r < M; ++r)
    for (int c = 0; c < M; ++c) {
      float v = uniform(-3.0f, -0.1f);
      if ((r / 64 + c / 96) % 5 == 0) v = 0.0f;   // unknown patches
      if (r % 37 < 2 || c % 53 == 0) v = uniform(1.0f, 6.0f);
      const float u = uniform(0.0f, 1.0f);
      if (u < 0.01f) v = uniform(-6.0f, 6.0f);
      else if (u < 0.015f) v = nextafterf(logit, 1.0f);
      else if (u < 0.02f) v = nextafterf(logit, -1.0f);
      map[(size_t)r * M + c] = v;
    }
  // the update window: rows and columns 250 .. 769 of the map, contiguous
  std::vector<float> win((size_t)WIN * WIN);
  for (int r = 0; r < WIN; ++r)
    for (int c = 0; c < WIN; ++c)
      win[(size_t)r * WIN + c] = map[(size_t)(250 + r) * M + 250 + c];

  float *d_l, *d_scratch, *d_out;
  cudaMalloc(&d_l, 4 * map.size());
  cudaMalloc(&d_scratch, 4 * map.size());
  cudaMalloc(&d_out, 4 * map.size());
  cudaEvent_t ea, eb;
  cudaEventCreate(&ea);
  cudaEventCreate(&eb);
  auto best_of = [&](auto&& fn) {
    float best = 1e9f, ms;
    for (int r = 0; r < 5; ++r) {
      cudaEventRecord(ea);
      for (int i = 0; i < 100; ++i) fn();
      cudaEventRecord(eb);
      cudaEventSynchronize(eb);
      cudaEventElapsedTime(&ms, ea, eb);
      best = fminf(best, ms / 100);
    }
    return best;
  };
  struct Case {
    const char* name;
    const std::vector<float>* l;
    int n;
  };
  const Case cases[2] = {{"window", &win, WIN}, {"map", &map, M}};
  for (const Case& cs : cases) {
    const int N = cs.n;
    cudaMemcpy(d_l, cs.l->data(), 4 * cs.l->size(), cudaMemcpyHostToDevice);
    cudaMemset(d_out, 0, 4 * map.size());
    auto call = [&] {
      return call_entry(slam2d_search_space, d_l, d_scratch, d_out, N, N, taps,
                        2 * HWID + 1);
    };
    const int err = call();
    const cudaError_t run = cudaDeviceSynchronize();
    if (err || run) {
      printf("%s: error %d, %s\n", name, err, cudaGetErrorString(run));
      return 1;
    }
    std::vector<uint32_t> out((size_t)N * N);
    cudaMemcpy(out.data(), d_out, 4 * out.size(), cudaMemcpyDeviceToHost);
    unsigned long long h = 0;
    size_t n_free = 0;
    for (size_t i = 0; i < out.size(); ++i) {
      h += (unsigned long long)out[i] * (i % 1021 + 1);
      n_free += (int32_t)out[i] < 0;
    }
    printf("%-24s %-6s [%d^2]: %.4f ms  checksum %llx  (%zu cells below 0)\n",
           name, cs.name, N, best_of(call), h, n_free);
    if (argc > 2 && N == M) {
      const int more = atoi(argv[2]);
      cudaEventRecord(ea);
      for (int i = 0; i < more; ++i) call();
      cudaEventRecord(eb);
      cudaEventSynchronize(eb);
      float ms;
      cudaEventElapsedTime(&ms, ea, eb);
      printf("%-24s map: %.4f ms a launch over %d launches\n", name,
             ms / more, more);
    }
  }
  printf("%-24s empty kernel: %.4f ms\n", name,
         best_of([] { empty_tune_kernel<<<1, 32>>>(); }));
  return 0;
}

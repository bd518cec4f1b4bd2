// Stand-alone timing of the port's ISM map update (kernel 1 "ism"),
// without PyTorch: for work on csrc/update_ism.cu. Built and driven by
// scripts/tune_kernel.sh (KERNEL = update_ism), which passes the kernel
// source to time (the repository's, a copy edited by a sed expression, or
// any other file with the same C entry point, e.g. an older version) as
// VARIANT_FILE.
//
// Two shapes of its paths, 180 beams over 180 degrees at 12 m, the scan of
// a 9 x 6 m room seen from off its middle (every 17th beam invalid, every
// 23rd without a hit, every 41st just above min_range):
// - "pf100": FastSLAM-100's update, 100 windows of 256^2 of bfloat16 512^2
//   maps at 0.1 m drawn from [-6, 6], poses all over the map (windows
//   clamped at every edge), in place;
// - "carve16": FastSLAM-1000's carve images, 16 float32 256^2 windows as
//   large as their image, l_occ = 0, the sensor at the center cell with 16
//   headings.
// For each it prints the least of 5 runs of 100 launches between two CUDA
// events and a checksum of the maps after one launch from the initial
// state: two variants that compute the same update print the same
// checksum. With a second argument N it then times N more launches of
// "pf100" in one run (to sample the clocks beside it).
#include VARIANT_FILE

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

__global__ void checksum(const unsigned short* o, size_t n,
                         unsigned long long* out) {
  unsigned long long acc = 0;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    acc += (unsigned long long)o[i] * (i % 1021 + 1);
  atomicAdd(out, acc);
}

static uint32_t lcg = 12345u;
static float uniform(float lo, float hi) {
  lcg = lcg * 1664525u + 1013904223u;
  return lo + (hi - lo) * (float)(lcg >> 8) * (1.0f / 16777216.0f);
}

static uint16_t to_bf16(float x) {  // round to nearest even
  uint32_t u;
  memcpy(&u, &x, 4);
  return (uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

struct Case {
  const char* name;
  int P, H, W, win, bf16;
  float gox, l_occ;
  std::vector<float> poses;
  std::vector<uint16_t> init;  // the initial maps, as 16-bit halves
};

int main(int argc, char** argv) {
  const char* name = argc > 1 ? argv[1] : "?";
  const int B = 180;
  const double res = 0.1, max_range = 12.0, min_range = 0.1;
  const double a_min = -M_PI / 2, step = M_PI / (B - 1);
  // the scan of the room [5, 14] x [1, 7] from (9.1, 4.3) heading 2.2 rad
  std::vector<float> ranges(B);
  for (int b = 0; b < B; ++b) {
    const double a = (float)(a_min + step * b) + 2.2;
    const double c = cos(a), s = sin(a);
    double t = 1e9;
    if (c > 0) t = fmin(t, (14.0 - 9.1) / c);
    if (c < 0) t = fmin(t, (5.0 - 9.1) / c);
    if (s > 0) t = fmin(t, (7.0 - 4.3) / s);
    if (s < 0) t = fmin(t, (1.0 - 4.3) / s);
    ranges[b] = (float)fmin(t, max_range);
    if (b % 17 == 5) ranges[b] = INFINITY;
    if (b % 23 == 9) ranges[b] = (float)max_range;
    if (b % 41 == 13) ranges[b] = (float)(min_range + 0.03);
  }

  Case cases[2];
  Case& pf = cases[0];
  pf = Case{"pf100", 100, 512, 512, 256, 1, -15.6f, 0.85f, {}, {}};
  for (int p = 0; p < pf.P; ++p) {
    pf.poses.push_back(pf.gox + uniform(0.0f, 51.2f));
    pf.poses.push_back(pf.gox + uniform(0.0f, 51.2f));
    pf.poses.push_back(uniform(-3.14159f, 3.14159f));
  }
  pf.init.resize((size_t)pf.P * pf.H * pf.W);
  for (auto& v : pf.init) v = to_bf16(uniform(-6.0f, 6.0f));
  Case& cv = cases[1];
  cv = Case{"carve16", 16, 256, 256, 256, 0, -12.85f, 0.0f, {}, {}};
  for (int g = 0; g < cv.P; ++g) {
    cv.poses.push_back(0.0f);
    cv.poses.push_back(0.0f);
    cv.poses.push_back(-0.3f + 0.04f * g);
  }
  cv.init.assign((size_t)cv.P * cv.H * cv.W * 2, 0);  // float32 zeros

  float *d_poses, *d_ranges;
  void* d_maps;
  unsigned long long* sum;
  cudaMalloc(&d_poses, 4 * 3 * 100);
  cudaMalloc(&d_ranges, 4 * B);
  cudaMalloc(&d_maps, pf.init.size() * 2);
  cudaMalloc(&sum, 8);
  cudaMemcpy(d_ranges, ranges.data(), 4 * B, cudaMemcpyHostToDevice);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (Case& k : cases) {
    cudaMemcpy(d_poses, k.poses.data(), 4 * k.poses.size(),
               cudaMemcpyHostToDevice);
    cudaMemcpy(d_maps, k.init.data(), k.init.size() * 2,
               cudaMemcpyHostToDevice);
    auto call = [&] {
      return slam2d_update_ism(
          d_maps, k.bf16, d_poses, d_ranges, k.P, k.H, k.W, k.win, k.win, B,
          k.gox, k.gox, (float)res, (float)(1.0 / res), (float)step,
          (float)(0.5 * (float)step), (float)a_min, (float)min_range,
          (float)max_range, (float)(0.75 * res), -0.4f, k.l_occ, 10.0f, 1.0f,
          nullptr, nullptr);
    };
    const int err = call();
    const cudaError_t run = cudaDeviceSynchronize();
    if (err || run) {
      printf("%s: error %d, %s\n", name, err, cudaGetErrorString(run));
      return 1;
    }
    cudaMemset(sum, 0, 8);
    checksum<<<256, 256>>>((const unsigned short*)d_maps, k.init.size(), sum);
    unsigned long long h;
    cudaMemcpy(&h, sum, 8, cudaMemcpyDeviceToHost);
    float best = 1e9f, ms;
    for (int r = 0; r < 5; ++r) {
      cudaEventRecord(a);
      for (int i = 0; i < 100; ++i) call();
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      cudaEventElapsedTime(&ms, a, b);
      best = fminf(best, ms / 100);
    }
    printf("%-24s %-8s: %.4f ms  checksum %llx\n", name, k.name, best, h);
  }
  if (argc > 2) {
    Case& k = cases[0];
    cudaMemcpy(d_poses, k.poses.data(), 4 * k.poses.size(),
               cudaMemcpyHostToDevice);
    const int more = atoi(argv[2]);
    cudaEventRecord(a);
    for (int i = 0; i < more; ++i)
      slam2d_update_ism(d_maps, 1, d_poses, d_ranges, k.P, k.H, k.W, k.win,
                        k.win, B, k.gox, k.gox, (float)res, (float)(1.0 / res),
                        (float)step, (float)(0.5 * (float)step), (float)a_min,
                        (float)min_range, (float)max_range,
                        (float)(0.75 * res), -0.4f, 0.85f, 10.0f, 1.0f,
                        nullptr, nullptr);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms;
    cudaEventElapsedTime(&ms, a, b);
    printf("%-24s pf100: %.4f ms a launch over %d launches\n", name,
           ms / more, more);
  }
  return 0;
}

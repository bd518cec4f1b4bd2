// Stand-alone timing of the port's hybrid map update (kernel 1 "hybrid"),
// without PyTorch: for work on csrc/update_hybrid.cu. Built and driven by
// scripts/tune_kernel.sh (KERNEL = update_hybrid), which passes the kernel
// source to time (the repository's, a copy edited by a sed expression, or
// any other file with the same C entry point, e.g. an older version) as
// VARIANT_FILE.
//
// The frontend's update (bench.py's config): a 520^2 float32 window at
// 0.05 m drawn from [-6, 6], 180 beams over 180 degrees at 12 m, the sensor
// near the window's middle. Two scans: "room", a 9 x 6 m room seen from off
// its middle (every 17th beam invalid, every 23rd without a hit, every 41st
// just above min_range, beams 60-64 at 0.3 m: one endpoint cell hit by
// several beams), and "wide", the same from a 24 x 23 m room (ranges up to
// 12 m: the free test's range skip saves little). For each it prints the
// least of 5 runs of 100 launches between two CUDA events and a checksum of
// the window written by one launch: two variants that compute the same
// update print the same checksum. Then the particle form
// (slam2d_update_hybrid_particles) at its three shapes with its gate-0 time
// (scripts/tune_particles.cuh). Last, the same timing of an empty kernel:
// the floor under any launch. With a second argument N it then times N more
// launches of "wide" in one run (to sample the clocks beside it).
#include VARIANT_FILE

#include "tune_particles.cuh"

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

__global__ void empty_tune_kernel() {}

static uint32_t lcg = 2468u;
static float uniform(float lo, float hi) {
  lcg = lcg * 1664525u + 1013904223u;
  return lo + (hi - lo) * (float)(lcg >> 8) * (1.0f / 16777216.0f);
}

int main(int argc, char** argv) {
  const char* name = argc > 1 ? argv[1] : "?";
  const int B = 180, N = 520;
  const double res = 0.05, max_range = 12.0, min_range = 0.1;
  const double a_min = -M_PI / 2, step = M_PI / (B - 1);
  const float pose[3] = {9.1f, 4.3f, 2.2f};
  // the window's origin: the pose's cell minus half the window
  const float ox = (float)(0.05 * floor(9.1 / 0.05) - 13.0);
  const float oy = (float)(0.05 * floor(4.3 / 0.05) - 13.0);
  std::vector<float> angles(B);
  for (int b = 0; b < B; ++b) angles[b] = (float)(a_min + step * b);
  struct Scan {
    const char* name;
    double x0, x1, y0, y1;  // the room
  };
  const Scan scans[2] = {{"room", 5.0, 14.0, 1.0, 7.0},
                         {"wide", -2.8, 21.2, -7.6, 15.4}};
  std::vector<float> grid((size_t)N * N);
  for (auto& v : grid) v = uniform(-6.0f, 6.0f);

  float *d_grid, *d_out, *d_pose, *d_ranges, *d_angles;
  cudaMalloc(&d_grid, 4 * grid.size());
  cudaMalloc(&d_out, 4 * grid.size());
  cudaMalloc(&d_pose, 12);
  cudaMalloc(&d_ranges, 4 * B);
  cudaMalloc(&d_angles, 4 * B);
  cudaMemcpy(d_grid, grid.data(), 4 * grid.size(), cudaMemcpyHostToDevice);
  cudaMemcpy(d_pose, pose, 12, cudaMemcpyHostToDevice);
  cudaMemcpy(d_angles, angles.data(), 4 * B, cudaMemcpyHostToDevice);
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
  auto call = [&] {
    return slam2d_update_hybrid(
        d_grid, d_out, d_pose, d_ranges, d_angles, N, N, B, ox, oy,
        (float)res, (float)step, (float)a_min, (float)min_range,
        (float)max_range, -0.4f, 0.85f, 10.0f, 1.0f, nullptr);
  };
  for (const Scan& sc : scans) {
    std::vector<float> ranges(B);
    for (int b = 0; b < B; ++b) {
      const double a = (double)angles[b] + pose[2];
      const double c = cos(a), s = sin(a);
      double t = 1e9;
      if (c > 0) t = fmin(t, (sc.x1 - pose[0]) / c);
      if (c < 0) t = fmin(t, (sc.x0 - pose[0]) / c);
      if (s > 0) t = fmin(t, (sc.y1 - pose[1]) / s);
      if (s < 0) t = fmin(t, (sc.y0 - pose[1]) / s);
      ranges[b] = (float)fmin(t, max_range);
      if (b % 17 == 5) ranges[b] = INFINITY;
      if (b % 23 == 9) ranges[b] = (float)max_range;
      if (b % 41 == 13) ranges[b] = (float)(min_range + 0.03);
      if (b >= 60 && b < 65) ranges[b] = 0.3f;
    }
    cudaMemcpy(d_ranges, ranges.data(), 4 * B, cudaMemcpyHostToDevice);
    cudaMemset(d_out, 0, 4 * grid.size());
    const int err = call();
    const cudaError_t run = cudaDeviceSynchronize();
    if (err || run) {
      printf("%s: error %d, %s\n", name, err, cudaGetErrorString(run));
      return 1;
    }
    std::vector<uint32_t> out(grid.size());
    cudaMemcpy(out.data(), d_out, 4 * out.size(), cudaMemcpyDeviceToHost);
    unsigned long long h = 0;
    for (size_t i = 0; i < out.size(); ++i)
      h += (unsigned long long)out[i] * (i % 1021 + 1);
    printf("%-24s %-5s [%d^2]: %.4f ms  checksum %llx\n", name, sc.name, N,
           best_of(call), h);
  }
  time_particle_forms(name, [](void* maps, int bf16, const float* poses,
                               const float* ranges, const float* angles,
                               const ParticleShape& s,
                               const unsigned char* gate, void* stream) {
    return slam2d_update_hybrid_particles(
        maps, bf16, poses, ranges, angles, s.P, s.H, s.W, s.win, s.win, 180,
        0.0f, 0.0f, (float)s.res, (float)(M_PI / 179), (float)(-M_PI / 2),
        0.1f, 12.0f, -0.4f, 0.85f, 10.0f, 1.0f, gate, stream);
  });
  printf("%-24s empty kernel: %.4f ms\n", name,
         best_of([] { empty_tune_kernel<<<1, 32>>>(); }));
  if (argc > 2) {
    const int more = atoi(argv[2]);
    cudaEventRecord(ea);
    for (int i = 0; i < more; ++i) call();
    cudaEventRecord(eb);
    cudaEventSynchronize(eb);
    float ms;
    cudaEventElapsedTime(&ms, ea, eb);
    printf("%-24s wide: %.4f ms a launch over %d launches\n", name,
           ms / more, more);
  }
  return 0;
}

// Stand-alone timing of the port's exact-ray update (kernel 1 "ray"),
// without PyTorch: for work on csrc/update_ray.cu. Built and driven by
// scripts/tune_kernel.sh (KERNEL = update_ray), which passes the kernel
// source to time (the repository's, a copy edited by a sed expression, or
// any other file with the same C entry point) as VARIANT_FILE.
//
// At the ray frontend's shape (a 520^2 float32 window at 0.05 m, 180 beams
// over 180 degrees at 12 m; the scan of a 9 x 6 m room seen from off its
// middle, every 17th beam invalid, every 23rd without a hit) it prints the
// least of 5 runs of 200 launches between two CUDA events and a checksum of
// the window: two variants that compute the same window print the same
// checksum. Then the particle form (slam2d_update_ray_particles) at its
// three shapes with its gate-0 time (scripts/tune_particles.cuh), and an
// empty kernel's time: the floor under any launch. With a second argument
// N it then times N more launches of the 520^2 window in one run (to
// sample the clocks beside it).
#include VARIANT_FILE

#include "tune_particles.cuh"

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <vector>

__global__ void empty_tune_kernel() {}

__global__ void checksum(const unsigned* o, size_t n, unsigned long long* out) {
  unsigned long long acc = 0;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    acc += (unsigned long long)o[i] * (i % 1021 + 1);
  atomicAdd(out, acc);
}

int main(int argc, char** argv) {
  const char* name = argc > 1 ? argv[1] : "?";
  const int H = 520, W = 520, B = 180;
  const double res = 0.05, max_range = 12.0, a_min = -M_PI / 2;
  const double step = M_PI / (B - 1);
  // the sensor at (9.1, 4.3) heading 2.2 rad in the room [5, 14] x [1, 7]
  const float pose[3] = {9.1f, 4.3f, 2.2f};
  std::vector<float> ranges(B), angles(B), grid((size_t)H * W);
  for (int b = 0; b < B; ++b) {
    angles[b] = (float)(a_min + step * b);
    const double a = angles[b] + (double)pose[2];
    const double c = cos(a), s = sin(a);
    double t = 1e9;
    if (c > 0) t = fmin(t, (14.0 - pose[0]) / c);
    if (c < 0) t = fmin(t, (5.0 - pose[0]) / c);
    if (s > 0) t = fmin(t, (7.0 - pose[1]) / s);
    if (s < 0) t = fmin(t, (1.0 - pose[1]) / s);
    ranges[b] = (float)fmin(t, max_range);
    if (b % 17 == 5) ranges[b] = INFINITY;
    if (b % 23 == 9) ranges[b] = (float)max_range;
  }
  srand(5);
  for (auto& v : grid) v = (float)(rand() % 12001 - 6000) / 1000.0f;
  // the window's top-left cell 260 cells left of and below the sensor's
  const float ox = (float)(floor(pose[0] / res) * res - 260 * res);
  const float oy = (float)(floor(pose[1] / res) * res - 260 * res);
  float *d_grid, *d_out, *d_pose, *d_ranges, *d_angles;
  unsigned long long* sum;
  cudaMalloc(&d_grid, grid.size() * 4);
  cudaMalloc(&d_out, grid.size() * 4);
  cudaMalloc(&d_pose, 12);
  cudaMalloc(&d_ranges, 4 * B);
  cudaMalloc(&d_angles, 4 * B);
  cudaMalloc(&sum, 8);
  cudaMemcpy(d_grid, grid.data(), grid.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(d_pose, pose, 12, cudaMemcpyHostToDevice);
  cudaMemcpy(d_ranges, ranges.data(), 4 * B, cudaMemcpyHostToDevice);
  cudaMemcpy(d_angles, angles.data(), 4 * B, cudaMemcpyHostToDevice);
  auto call = [&] {
    return slam2d_update_ray(
        d_grid, d_out, d_pose, d_ranges, d_angles, H, W, B, ox, oy,
        (float)res, 0.1f, (float)max_range, 1.0f / 128.0f, (float)(0.5 * res),
        (float)(1.0 / res), (float)a_min, (float)step, -0.4f, 0.85f, 10.0f,
        1.0f, nullptr);
  };
  const int err = call();
  const cudaError_t run = cudaDeviceSynchronize();
  if (err || run) {
    printf("%s: error %d, %s\n", name, err, cudaGetErrorString(run));
    return 1;
  }
  cudaMemset(sum, 0, 8);
  checksum<<<256, 256>>>((const unsigned*)d_out, grid.size(), sum);
  unsigned long long h;
  cudaMemcpy(&h, sum, 8, cudaMemcpyDeviceToHost);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  float best = 1e9f, ms;
  for (int r = 0; r < 5; ++r) {
    cudaEventRecord(a);
    for (int i = 0; i < 200; ++i) call();
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    cudaEventElapsedTime(&ms, a, b);
    best = fminf(best, ms / 200);
  }
  printf("%-24s 520^2: %.4f ms  checksum %llx\n", name, best, h);
  time_particle_forms(name, [](void* maps, int bf16, const float* poses,
                               const float* ranges, const float* angles,
                               const ParticleShape& s,
                               const unsigned char* gate, void* stream) {
    return slam2d_update_ray_particles(
        maps, bf16, poses, ranges, angles, s.P, s.H, s.W, s.win, s.win, 180,
        0.0f, 0.0f, (float)s.res, 0.1f, 12.0f, 1.0f / 128.0f,
        (float)(0.5 * s.res), (float)(1.0 / s.res), (float)(-M_PI / 2),
        (float)(M_PI / 179), -0.4f, 0.85f, 10.0f, 1.0f, gate, stream);
  });
  best = 1e9f;
  for (int r = 0; r < 5; ++r) {
    cudaEventRecord(a);
    for (int i = 0; i < 200; ++i) empty_tune_kernel<<<1, 32>>>();
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    cudaEventElapsedTime(&ms, a, b);
    best = fminf(best, ms / 200);
  }
  printf("%-24s empty kernel: %.4f ms\n", name, best);
  if (argc > 2) {
    const int more = atoi(argv[2]);
    cudaEventRecord(a);
    for (int i = 0; i < more; ++i) call();
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    cudaEventElapsedTime(&ms, a, b);
    printf("%-24s 520^2: %.4f ms a launch over %d launches\n", name,
           ms / more, more);
  }
  return 0;
}

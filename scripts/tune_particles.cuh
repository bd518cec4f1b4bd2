// The particle forms of kernel 1 (slam2d_update_ray_particles,
// slam2d_update_hybrid_particles) timed at their main paths' shapes, for
// scripts/tune_update_ray.cu and scripts/tune_update_hybrid.cu:
//   [16, 496^2] float32 windows of 1024^2 maps at 0.05 m (the CLI's
//   FastSLAM-16), [100, 256^2] and [16, 256^2] bfloat16 windows of 512^2
//   maps at 0.1 m (bench_pf's FastSLAM-100 and -16).
// The maps are drawn from [-6, 6]; the particles lie within 0.3 m and 0.05
// rad of a pose in a 24 x 23 m room (ranges up to 12 m, every 17th beam
// invalid, every 23rd without a hit), particle 1 at the map's corner (its
// window clamped). For each shape it prints the least of 5 runs of 50
// launches between two CUDA events, the same with a device gate of 0, each
// as launched from the host and as one CUDA graph of the 50 launches (the
// device's time: host launches of a short kernel measure the host), and a
// checksum of the maps after one launch on the drawn maps: two variants
// that compute the same update print the same checksum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <vector>

struct ParticleShape {
  const char* label;
  int P, H, W, win;
  double res;
  bool bf16;
};

static const ParticleShape kParticleShapes[3] = {
    {"[16,496^2] f32", 16, 1024, 1024, 496, 0.05, false},
    {"[100,256^2] bf16", 100, 512, 512, 256, 0.1, true},
    {"[16,256^2] bf16", 16, 512, 512, 256, 0.1, true},
};

static uint32_t particle_lcg = 97531u;
static float particle_uniform(float lo, float hi) {
  particle_lcg = particle_lcg * 1664525u + 1013904223u;
  return lo + (hi - lo) * (float)(particle_lcg >> 8) * (1.0f / 16777216.0f);
}

// `call(maps, is_bf16, poses, ranges, angles, shape, gate, stream)`
// launches the particle form and returns its error code
template <typename F>
void time_particle_forms(const char* name, F call) {
  const int B = 180;
  const double a_min = -M_PI / 2, step = M_PI / (B - 1), max_range = 12.0;
  std::vector<float> angles(B);
  for (int b = 0; b < B; ++b) angles[b] = (float)(a_min + step * b);
  float *d_poses, *d_ranges, *d_angles;
  unsigned char* d_gate;
  cudaMalloc(&d_poses, 12 * 100);
  cudaMalloc(&d_ranges, 4 * B);
  cudaMalloc(&d_angles, 4 * B);
  cudaMalloc(&d_gate, 2);
  const unsigned char gates[2] = {1, 0};
  cudaMemcpy(d_gate, gates, 2, cudaMemcpyHostToDevice);
  cudaMemcpy(d_angles, angles.data(), 4 * B, cudaMemcpyHostToDevice);
  cudaEvent_t ea, eb;
  cudaEventCreate(&ea);
  cudaEventCreate(&eb);
  cudaStream_t st;
  cudaStreamCreateWithFlags(&st, cudaStreamNonBlocking);
  for (const ParticleShape& s : kParticleShapes) {
    particle_lcg = 97531u;
    const size_t n = (size_t)s.P * s.H * s.W;
    const size_t bytes = n * (s.bf16 ? 2 : 4);
    std::vector<uint16_t> h16(s.bf16 ? n : 0);
    std::vector<float> h32(s.bf16 ? 0 : n);
    for (size_t i = 0; i < n; ++i) {
      const float v = particle_uniform(-6.0f, 6.0f);
      if (s.bf16)
        h16[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
      else
        h32[i] = v;
    }
    // the robot near the map's middle, in the room [x - 11.9, x + 12.1] x
    // [y - 11.9, y + 11.1]
    const float cx = (float)(0.5 * s.W * s.res + 1.1);
    const float cy = (float)(0.5 * s.H * s.res - 0.7), cth = 2.2f;
    std::vector<float> poses(3 * s.P), ranges(B);
    for (int p = 0; p < s.P; ++p) {
      poses[3 * p] = cx + particle_uniform(-0.3f, 0.3f);
      poses[3 * p + 1] = cy + particle_uniform(-0.3f, 0.3f);
      poses[3 * p + 2] = cth + particle_uniform(-0.05f, 0.05f);
    }
    poses[3] = poses[4] = 1.0f;
    for (int b = 0; b < B; ++b) {
      const double a = (double)angles[b] + cth;
      const double c = cos(a), sn = sin(a);
      double t = 1e9;
      if (c > 0) t = fmin(t, 12.1 / c);
      if (c < 0) t = fmin(t, -11.9 / c);
      if (sn > 0) t = fmin(t, 11.1 / sn);
      if (sn < 0) t = fmin(t, -11.9 / sn);
      ranges[b] = (float)fmin(t, max_range);
      if (b % 17 == 5) ranges[b] = INFINITY;
      if (b % 23 == 9) ranges[b] = (float)max_range;
    }
    void* d_maps;
    cudaMalloc(&d_maps, bytes);
    cudaMemcpy(d_maps, s.bf16 ? (void*)h16.data() : (void*)h32.data(), bytes,
               cudaMemcpyHostToDevice);
    cudaMemcpy(d_poses, poses.data(), 12 * s.P, cudaMemcpyHostToDevice);
    cudaMemcpy(d_ranges, ranges.data(), 4 * B, cudaMemcpyHostToDevice);
    auto launch = [&](const unsigned char* gate) {
      return call(d_maps, (int)s.bf16, d_poses, d_ranges, d_angles, s, gate,
                  (void*)st);
    };
    const int err = launch(d_gate);
    const cudaError_t run = cudaDeviceSynchronize();
    if (err || run) {
      printf("%s %s: error %d, %s\n", name, s.label, err,
             cudaGetErrorString(run));
      return;
    }
    std::vector<uint32_t> out(bytes / 4);
    cudaMemcpy(out.data(), d_maps, bytes, cudaMemcpyDeviceToHost);
    unsigned long long h = 0;
    for (size_t i = 0; i < out.size(); ++i)
      h += (unsigned long long)out[i] * (i % 1021 + 1);
    float ms[2], graph_ms[2];
    for (int g = 0; g < 2; ++g) {
      cudaGraph_t graph;
      cudaGraphExec_t exec;
      cudaStreamBeginCapture(st, cudaStreamCaptureModeGlobal);
      for (int i = 0; i < 50; ++i) launch(d_gate + g);
      cudaStreamEndCapture(st, &graph);
      cudaGraphInstantiate(&exec, graph, 0);
      cudaGraphLaunch(exec, st);
      for (int by_graph = 0; by_graph < 2; ++by_graph) {
        float best = 1e9f, t;
        for (int r = 0; r < 5; ++r) {
          cudaEventRecord(ea, st);
          if (by_graph)
            cudaGraphLaunch(exec, st);
          else
            for (int i = 0; i < 50; ++i) launch(d_gate + g);
          cudaEventRecord(eb, st);
          cudaEventSynchronize(eb);
          cudaEventElapsedTime(&t, ea, eb);
          best = fminf(best, t / 50);
        }
        (by_graph ? graph_ms : ms)[g] = best;
      }
      cudaGraphExecDestroy(exec);
      cudaGraphDestroy(graph);
    }
    const cudaError_t last = cudaDeviceSynchronize();
    printf("%-24s %-18s: %.5f ms (graph %.5f)  gate 0: %.5f ms (graph "
           "%.5f)  checksum %llx%s\n",
           name, s.label, ms[0], graph_ms[0], ms[1], graph_ms[1], h,
           last ? cudaGetErrorString(last) : "");
    cudaFree(d_maps);
  }
  cudaFree(d_poses);
  cudaFree(d_ranges);
  cudaFree(d_angles);
  cudaFree(d_gate);
  cudaStreamDestroy(st);
}

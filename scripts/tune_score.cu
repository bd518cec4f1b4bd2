// Stand-alone timing of the port's correlative scorer (kernel 2), without
// PyTorch: for work on csrc/score.cu. Built and driven by
// scripts/tune_kernel.sh (KERNEL = score), which passes the kernel source
// to time (the repository's, a copy edited by a sed expression, or any
// other file with the same C entry point, e.g. an older version) as
// VARIANT_FILE.
//
// The frontend's two passes (bench.py's matcher): "coarse", [13, 5, 5]
// rounded taps on a 136^2 window, and "fine", [5, 9, 9] bilinear taps on a
// 544^2 window, 180 beams (every 17th invalid, its position zeroed), the
// endpoints of a 9 x 6 m room's scan seen from the window's middle. For each
// it prints the least of 5 runs of 200 launches between two CUDA events,
// the largest |error| against a float64 sum on the host, a checksum of the
// scores and whether a second launch gave the same bits. Last, the same
// timing of an empty kernel: the floor under any launch. With a second
// argument N it then times N more launches of the fine pass in one run (to
// sample the clocks beside it).
#include VARIANT_FILE

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

__global__ void empty_tune_kernel() {}

static uint32_t lcg = 777u;
static float uniform(float lo, float hi) {
  lcg = lcg * 1664525u + 1013904223u;
  return lo + (hi - lo) * (float)(lcg >> 8) * (1.0f / 16777216.0f);
}

struct Pass {
  const char* name;
  int size, T, n, bilinear;
  double cell;
};

// out[t, r, c] in float64 (the gather semantics, each tap masked alone)
static std::vector<double> reference(const Pass& q, const std::vector<float>& S,
                                     const std::vector<float>& pr,
                                     const std::vector<float>& pc,
                                     const std::vector<unsigned char>& valid,
                                     int B) {
  const int H = q.size, W = q.size, R = q.n / 2;
  std::vector<double> out((size_t)q.T * q.n * q.n, 0.0);
  int nv = 0;
  for (int b = 0; b < B; ++b) nv += valid[b];
  auto at = [&](int r, int c) {
    return r >= 0 && r < H && c >= 0 && c < W ? (double)S[(size_t)r * W + c]
                                               : 0.0;
  };
  for (int t = 0; t < q.T; ++t)
    for (int i = 0; i < q.n; ++i)
      for (int j = 0; j < q.n; ++j) {
        double acc = 0.0;
        for (int b = 0; b < B; ++b) {
          if (!valid[b]) continue;
          const float y = pr[(size_t)t * B + b], x = pc[(size_t)t * B + b];
          if (!q.bilinear) {
            acc += at((int)rintf(y) + i - R, (int)rintf(x) + j - R);
            continue;
          }
          const int r0 = (int)floorf(y), c0 = (int)floorf(x);
          const double fr = y - floorf(y), fc = x - floorf(x);
          const int r = r0 + i - R, c = c0 + j - R;
          acc += at(r, c) * (1 - fr) * (1 - fc) + at(r, c + 1) * (1 - fr) * fc +
                 at(r + 1, c) * fr * (1 - fc) + at(r + 1, c + 1) * fr * fc;
        }
        out[((size_t)t * q.n + i) * q.n + j] = acc / (nv > 0 ? nv : 1);
      }
  return out;
}

int main(int argc, char** argv) {
  const char* name = argc > 1 ? argv[1] : "?";
  const int B = 180;
  const Pass passes[2] = {{"coarse", 136, 13, 5, 0, 0.2},
                          {"fine", 544, 5, 9, 1, 0.05}};
  const double a_min = -M_PI / 2, step = M_PI / (B - 1);
  // the scan of the room [5, 14] x [1, 7] from (9.1, 4.3) heading 2.2 rad,
  // the window's middle 13.6 m from its origin
  std::vector<double> rng(B);
  std::vector<unsigned char> valid(B);
  for (int b = 0; b < B; ++b) {
    const double a = a_min + step * b + 2.2;
    const double c = cos(a), s = sin(a);
    double t = 1e9;
    if (c > 0) t = fmin(t, (14.0 - 9.1) / c);
    if (c < 0) t = fmin(t, (5.0 - 9.1) / c);
    if (s > 0) t = fmin(t, (7.0 - 4.3) / s);
    if (s < 0) t = fmin(t, (1.0 - 4.3) / s);
    rng[b] = fmin(t, 12.0);
    valid[b] = b % 17 != 5;
  }
  unsigned char* d_valid;
  float *d_S, *d_pr, *d_pc, *d_out;
  cudaMalloc(&d_valid, B);
  cudaMalloc(&d_S, 4 * 544 * 544);
  cudaMalloc(&d_pr, 4 * 13 * B);
  cudaMalloc(&d_pc, 4 * 13 * B);
  cudaMalloc(&d_out, 4 * 13 * 81);
  cudaMemcpy(d_valid, valid.data(), B, cudaMemcpyHostToDevice);
  cudaEvent_t ea, eb;
  cudaEventCreate(&ea);
  cudaEventCreate(&eb);
  auto best_of = [&](auto&& fn) {
    float best = 1e9f, ms;
    for (int r = 0; r < 5; ++r) {
      cudaEventRecord(ea);
      for (int i = 0; i < 200; ++i) fn();
      cudaEventRecord(eb);
      cudaEventSynchronize(eb);
      cudaEventElapsedTime(&ms, ea, eb);
      best = fminf(best, ms / 200);
    }
    return best;
  };
  for (const Pass& q : passes) {
    std::vector<float> S((size_t)q.size * q.size), pr(q.T * B), pc(q.T * B);
    for (auto& v : S) v = uniform(0.0f, 1.0f);
    for (int t = 0; t < q.T; ++t)
      for (int b = 0; b < B; ++b) {
        const double th = 2.2 + (t - q.T / 2) * 0.025;
        const double a = a_min + step * b + th;
        const double ex = 13.6 + 0.013 + rng[b] * cos(a);
        const double ey = 13.6 - 0.021 + rng[b] * sin(a);
        pc[t * B + b] = valid[b] ? (float)(ex / q.cell - 0.5) : 0.0f;
        pr[t * B + b] = valid[b] ? (float)(ey / q.cell - 0.5) : 0.0f;
      }
    cudaMemcpy(d_S, S.data(), 4 * S.size(), cudaMemcpyHostToDevice);
    cudaMemcpy(d_pr, pr.data(), 4 * pr.size(), cudaMemcpyHostToDevice);
    cudaMemcpy(d_pc, pc.data(), 4 * pc.size(), cudaMemcpyHostToDevice);
    auto call = [&] {
      return slam2d_score_offsets(d_S, d_pr, d_pc, d_valid, d_out, q.size,
                                  q.size, q.T, B, q.n, q.n, q.bilinear,
                                  nullptr);
    };
    const size_t n_out = (size_t)q.T * q.n * q.n;
    std::vector<float> out(n_out), again(n_out);
    const int err = call();
    cudaError_t run = cudaDeviceSynchronize();
    cudaMemcpy(out.data(), d_out, 4 * n_out, cudaMemcpyDeviceToHost);
    call();
    run = run ? run : cudaDeviceSynchronize();
    cudaMemcpy(again.data(), d_out, 4 * n_out, cudaMemcpyDeviceToHost);
    if (err || run) {
      printf("%s: error %d, %s\n", name, err, cudaGetErrorString(run));
      return 1;
    }
    const std::vector<double> ref = reference(q, S, pr, pc, valid, B);
    double max_err = 0.0;
    unsigned long long h = 0;
    for (size_t i = 0; i < n_out; ++i) {
      max_err = fmax(max_err, fabs(out[i] - ref[i]));
      uint32_t u;
      memcpy(&u, &out[i], 4);
      h += (unsigned long long)u * (i % 1021 + 1);
    }
    const bool same = memcmp(out.data(), again.data(), 4 * n_out) == 0;
    printf("%-24s %-6s [%d, %d, %d]: %.4f ms  max |err| %.3g  checksum %llx"
           "  same bits twice %s\n",
           name, q.name, q.T, q.n, q.n, best_of(call), max_err, h,
           same ? "yes" : "NO");
  }
  printf("%-24s empty kernel: %.4f ms\n", name,
         best_of([] { empty_tune_kernel<<<1, 32>>>(); }));
  if (argc > 2) {
    const int more = atoi(argv[2]);
    cudaEventRecord(ea);
    for (int i = 0; i < more; ++i)
      slam2d_score_offsets(d_S, d_pr, d_pc, d_valid, d_out, 544, 544, 5, B, 9,
                           9, 1, nullptr);
    cudaEventRecord(eb);
    cudaEventSynchronize(eb);
    float ms;
    cudaEventElapsedTime(&ms, ea, eb);
    printf("%-24s fine: %.4f ms a launch over %d launches\n", name, ms / more,
           more);
  }
  return 0;
}

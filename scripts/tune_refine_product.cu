// Stand-alone timing of the shared refine's product (csrc/refine_product.cu),
// without PyTorch: for work on that kernel. Built and driven by
// scripts/tune_kernel.sh (KERNEL = refine_product), which passes the kernel
// source to time (the repository's, a copy edited by a sed expression, or any
// other file with the same C entry points) as VARIANT_FILE.
//
// FastSLAM-100's and FastSLAM-1000's shapes: A [P, 288^2] bf16 fields drawn
// from [-1, 1], P = 100 and 1000, and B [375, 288^2] bf16, the shift stack
// of a scan as the refine builds it: 15 headings 0.03 rad apart, each the
// bilinear splat of 180 beams over 180 degrees ending on the walls of a
// 20 m box room around the window's centre (0.1 m cells), shifted by every
// (dr, dc) in 0..4 with zeros off the low edges; denom 180. For each P it
// prints the slices, the least of 5 runs of 100 calls between two CUDA
// events (the three launches of a call) with a gate of 1 and of 0, that
// time against the bytes bound (the operands read once and the output
// written once at 3.35 TB/s), the largest |error| of the first 8 rows
// against a float64 sum on the host in float32 epsilons of the output's sum
// of |products| / denom, a checksum, and whether a second call gave the
// same bits. With a second argument N it then times N more calls at P = 100
// in one run (to sample the clocks beside it).
#include VARIANT_FILE

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

static uint32_t lcg = 4242u;
static float uniform(float lo, float hi) {
  lcg = lcg * 1664525u + 1013904223u;
  return lo + (hi - lo) * (float)(lcg >> 8) * (1.0f / 16777216.0f);
}

static uint16_t to_bf16(float x) {  // round to nearest even
  uint32_t u;
  memcpy(&u, &x, 4);
  return (uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

static double from_bf16(uint16_t h) {
  const uint32_t u = (uint32_t)h << 16;
  float x;
  memcpy(&x, &u, 4);
  return x;
}

#define CHECK(x)                                                         \
  do {                                                                   \
    const int e_ = (int)(x);                                             \
    if (e_ != 0) {                                                       \
      fprintf(stderr, "%s: error %d (%s)\n", #x, e_,                     \
              cudaGetErrorString((cudaError_t)e_));                      \
      exit(1);                                                           \
    }                                                                    \
  } while (0)

// the slices of ops/refine_product.py:_slices (the library's split on the
// H100) for an [M, N] output of depth K
static int slices(int M, int N, int K) {
  int sms = 0;
  CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0));
  const bool small = M <= 128 && N <= 384;
  const int blocks = small ? sms : 2 * sms;
  const int tiles = (N + 127) / 128 * (small ? (M + 63) / 64 : (M + 127) / 128);
  return std::max(1, std::min((K + 7) / 8, blocks / tiles));
}

int main(int argc, char** argv) {
  const char* name = argc > 1 ? argv[1] : "?";
  const int N = 375, W = 288, K = W * W, ROWS = 8;
  const float denom = 180.0f;
  std::vector<uint16_t> hb((size_t)N * K, 0);
  for (int g = 0; g < 15; ++g) {
    std::vector<float> E((size_t)K, 0.0f);
    const float theta = 0.03f * (g - 7);
    for (int b = 0; b < 180; ++b) {
      const float a = theta - 1.5707963f + b * (3.14159265f / 179.0f);
      const float c = cosf(a), s = sinf(a);
      // the nearer wall of the box |x|, |y| <= 10 m along the beam
      const float tx = fabsf(c) > 1e-6f ? 10.0f / fabsf(c) : 1e9f;
      const float ty = fabsf(s) > 1e-6f ? 10.0f / fabsf(s) : 1e9f;
      const float r = fminf(fminf(tx, ty), 14.0f);
      const float col = r * c / 0.1f + W / 2 - 2, row = r * s / 0.1f + W / 2 - 2;
      const int r0 = (int)floorf(row), c0 = (int)floorf(col);
      if (r0 < 0 || r0 > W - 6 || c0 < 0 || c0 > W - 6) continue;
      const float fr = row - r0, fc = col - c0;
      E[(size_t)r0 * W + c0] += (1 - fr) * (1 - fc);
      E[(size_t)r0 * W + c0 + 1] += (1 - fr) * fc;
      E[(size_t)(r0 + 1) * W + c0] += fr * (1 - fc);
      E[(size_t)(r0 + 1) * W + c0 + 1] += fr * fc;
    }
    for (int dr = 0; dr < 5; ++dr)
      for (int dc = 0; dc < 5; ++dc) {
        uint16_t* row = &hb[(size_t)(g * 25 + dr * 5 + dc) * K];
        for (int y = dr; y < W; ++y)
          for (int x = dc; x < W; ++x)
            row[(size_t)y * W + x] = to_bf16(E[(size_t)(y - dr) * W + x - dc]);
      }
  }
  {  // the stack's sparsity: nonzeros a row, 8-column tiles a 64-row band
    long long nz = 0, busy = 0, all = 0;
    for (int b0 = 0; b0 < N; b0 += 64)
      for (int t = 0; t < K / 8; ++t, ++all) {
        bool any = false;
        for (int r = b0; r < std::min(N, b0 + 64); ++r)
          for (int c = 0; c < 8; ++c) {
            const bool on = (hb[(size_t)r * K + 8 * t + c] & 0x7fff) != 0;
            nz += on;
            any |= on;
          }
        busy += any;
      }
    printf("%s: stack nonzeros a row %.1f, 8-column tiles nonzero in a "
           "64-row band %.4f\n", name, (double)nz / N, (double)busy / all);
  }
  uint16_t *dA, *dB;
  float *d_out, *d_denom;
  void *d_ws, *d_masks;
  unsigned char *d_on, *d_off;
  CHECK(cudaMalloc(&dB, hb.size() * 2));
  CHECK(cudaMemcpy(dB, hb.data(), hb.size() * 2, cudaMemcpyHostToDevice));
  CHECK(cudaMalloc(&d_denom, 4));
  CHECK(cudaMemcpy(d_denom, &denom, 4, cudaMemcpyHostToDevice));
  CHECK(cudaMalloc(&d_on, 1));
  CHECK(cudaMalloc(&d_off, 1));
  CHECK(cudaMemset(d_on, 1, 1));
  CHECK(cudaMemset(d_off, 0, 1));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int P : {100, 1000}) {
    std::vector<uint16_t> ha((size_t)P * K);
    for (auto& v : ha) v = to_bf16(uniform(-1.0f, 1.0f));
    const int S = slices(P, N, K);
    CHECK(cudaMalloc(&dA, ha.size() * 2));
    CHECK(cudaMemcpy(dA, ha.data(), ha.size() * 2, cudaMemcpyHostToDevice));
    CHECK(cudaMalloc(&d_ws, (size_t)S * P * N * 4));
    CHECK(cudaMalloc(&d_masks, (size_t)(N + 63) / 64 * ((K + 7) / 8)));
    CHECK(cudaMalloc(&d_out, (size_t)P * N * 4));
    auto call = [&](const unsigned char* gate) {
      CHECK(slam2d_refine_product(dA, dB, d_ws, d_masks, d_out, d_denom, P, N,
                                  K, S, gate, nullptr));
    };
    float best[2] = {1e30f, 1e30f};
    for (int g = 0; g < 2; ++g) {
      for (int w = 0; w < 3; ++w) call(g ? d_off : d_on);
      for (int run = 0; run < 5; ++run) {
        cudaEventRecord(e0);
        for (int i = 0; i < 100; ++i) call(g ? d_off : d_on);
        cudaEventRecord(e1);
        CHECK(cudaEventSynchronize(e1));
        float ms = 0.0f;
        cudaEventElapsedTime(&ms, e0, e1);
        best[g] = fminf(best[g], ms / 100);
      }
    }
    call(d_on);
    std::vector<float> out((size_t)P * N), again((size_t)P * N);
    CHECK(cudaMemcpy(out.data(), d_out, out.size() * 4, cudaMemcpyDeviceToHost));
    call(d_on);
    CHECK(cudaMemcpy(again.data(), d_out, again.size() * 4,
                     cudaMemcpyDeviceToHost));
    const bool same = memcmp(out.data(), again.data(), out.size() * 4) == 0;
    double worst = 0.0, checksum = 0.0;
    for (float v : out) checksum += v;
    for (int p = 0; p < ROWS; ++p)
      for (int n = 0; n < N; ++n) {
        double sum = 0.0, mag = 0.0;
        const uint16_t* a = &ha[(size_t)p * K];
        const uint16_t* b = &hb[(size_t)n * K];
        for (int k = 0; k < K; ++k) {
          if (b[k] == 0) continue;
          const double x = from_bf16(a[k]) * from_bf16(b[k]);
          sum += x;
          mag += fabs(x);
        }
        const double unit = 0x1p-23 * mag / denom;
        const double err = fabs(out[(size_t)p * N + n] - sum / denom);
        worst = fmax(worst, unit > 0 ? err / unit : err);
      }
    const double bound_us = ((double)(P + N) * K * 2 + (double)P * N * 4) /
                            3.35e12 * 1e6;
    printf("%s P=%d S=%d: %.2f us a call (gate 0: %.2f us), bound %.2f us "
           "(%.1f%%), error %.3f eps of sum|products| (first %d rows), "
           "checksum %.9g, same bits twice %s\n",
           name, P, S, best[0] * 1e3, best[1] * 1e3, bound_us,
           100.0 * bound_us / (best[0] * 1e3), worst, ROWS, checksum,
           same ? "yes" : "NO");
    if (P == 100 && argc > 2) {
      const int n = atoi(argv[2]);
      for (int i = 0; i < n; ++i) call(d_on);
      CHECK(cudaDeviceSynchronize());
      printf("%s: %d launches done\n", name, n);
    }
    cudaFree(dA);
    cudaFree(d_ws);
    cudaFree(d_masks);
    cudaFree(d_out);
  }
  return 0;
}

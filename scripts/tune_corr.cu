// Stand-alone timing of the port's lag correlation (kernel 5), without
// PyTorch: for work on csrc/corr.cu. Built and driven by
// scripts/tune_kernel.sh (KERNEL = corr), which passes the kernel source to
// time (the repository's, a copy edited by a sed expression, or any other
// file with the same C entry point, e.g. an older version) as VARIANT_FILE.
//
// FastSLAM-16's per-particle refine (bench_pf.py --particles 16): E [16, 9,
// 288^2], the bilinear splats of a 180-beam scan of a 9 x 6 m room (every
// 17th beam invalid) at 0.1 m, one per particle and theta, weights 1/170
// rounded to bfloat16; Sp [16, 293^2] float32 drawn from [-0.6, 1] with its
// high 5 rows and columns zero; R = C = 5. Four forms of E: "bf16" (the
// path's), "f32" (the same values in float32), "bf16_odd" (the bf16 images
// one element past a 16-byte boundary: the scalar form) and "bf16_zero"
// (every cell zero: what the stream of E alone costs). For each it
// prints the least of 5 runs of 100 launches between two CUDA events, the
// largest |error| against a float64 sum on the host and that error over
// sum|E| x max|Sp| (chip_smoke.py holds it to 1e-5), a checksum of the
// scores and whether a second launch gave the same bits. With a second
// argument N it then times N more launches of "bf16" in one run (to sample
// the clocks beside it).
#include VARIANT_FILE

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

static float from_bf16(uint16_t h) {
  const uint32_t u = (uint32_t)h << 16;
  float x;
  memcpy(&x, &u, 4);
  return x;
}

int main(int argc, char** argv) {
  const char* name = argc > 1 ? argv[1] : "?";
  const int P = 16, T = 9, H = 288, W = 288, R = 5, B = 180;
  const size_t HW = (size_t)H * W, n_e = (size_t)P * T * HW;
  const int HR = H + R, WC = W + R;
  const double a_min = -M_PI / 2, step = M_PI / (B - 1);
  // the scan of the room [5, 14] x [1, 7] from (9.1, 4.3) heading 2.2 rad
  std::vector<double> rng(B);
  int nv = 0;
  for (int b = 0; b < B; ++b) {
    const double a = a_min + step * b + 2.2;
    const double c = cos(a), s = sin(a);
    double t = 1e9;
    if (c > 0) t = fmin(t, (14.0 - 9.1) / c);
    if (c < 0) t = fmin(t, (5.0 - 9.1) / c);
    if (s > 0) t = fmin(t, (7.0 - 4.3) / s);
    if (s < 0) t = fmin(t, (1.0 - 4.3) / s);
    rng[b] = b % 17 == 5 ? -1.0 : fmin(t, 12.0);
    nv += b % 17 != 5;
  }
  // splats: each particle's prior off by a few cm, each theta 0.03 rad apart
  std::vector<float> ef(n_e, 0.0f);
  for (int p = 0; p < P; ++p) {
    const double dx = uniform(-0.05f, 0.05f), dy = uniform(-0.05f, 0.05f);
    for (int t = 0; t < T; ++t) {
      float* img = &ef[((size_t)p * T + t) * HW];
      const double th = 2.2 + (t - T / 2) * 0.03 + uniform(-0.01f, 0.01f);
      for (int b = 0; b < B; ++b) {
        if (rng[b] < 0) continue;
        const double a = a_min + step * b + th;
        const double x = (14.4 + dx + rng[b] * cos(a)) / 0.1 - 0.5;
        const double y = (14.4 + dy + rng[b] * sin(a)) / 0.1 - 0.5;
        const int r0 = (int)floor(y), c0 = (int)floor(x);
        const double fr = y - r0, fc = x - c0;
        const double w[4] = {(1 - fr) * (1 - fc), (1 - fr) * fc,
                             fr * (1 - fc), fr * fc};
        for (int k = 0; k < 4; ++k) {
          const int r = r0 + k / 2, c = c0 + k % 2;
          if (r >= 0 && r < H && c >= 0 && c < W)
            img[(size_t)r * W + c] += (float)(w[k] / nv);
        }
      }
    }
  }
  std::vector<uint16_t> eb(n_e);
  size_t nnz = 0;
  for (size_t i = 0; i < n_e; ++i) {
    eb[i] = to_bf16(ef[i]);
    ef[i] = from_bf16(eb[i]);
    nnz += ef[i] != 0.0f;
  }
  std::vector<float> sp((size_t)P * HR * WC, 0.0f);
  for (int p = 0; p < P; ++p)
    for (int r = 0; r < H; ++r)
      for (int c = 0; c < W; ++c)
        sp[((size_t)p * HR + r) * WC + c] = uniform(-0.6f, 1.0f);
  // the float64 reference from the nonzero cells, and each (p, t)'s scale
  const size_t n_out = (size_t)P * T * R * R;
  std::vector<double> ref(n_out, 0.0), scale((size_t)P * T, 0.0);
  for (int p = 0; p < P; ++p)
    for (int t = 0; t < T; ++t) {
      const float* img = &ef[((size_t)p * T + t) * HW];
      const float* s = &sp[(size_t)p * HR * WC];
      double e_abs = 0.0, s_max = 0.0;
      for (size_t i = 0; i < (size_t)HR * WC; ++i) s_max = fmax(s_max, fabs(s[i]));
      for (int h = 0; h < H; ++h)
        for (int w = 0; w < W; ++w) {
          const double e = img[(size_t)h * W + w];
          if (e == 0.0) continue;
          e_abs += fabs(e);
          for (int k = 0; k < R * R; ++k)
            ref[((size_t)p * T + t) * R * R + k] +=
                e * s[(size_t)(h + k / R) * WC + w + k % R];
        }
      scale[(size_t)p * T + t] = e_abs * s_max;
    }
  printf("%-24s E [%d, %d, %d^2]: %zu nonzero cells (%.3f%%)\n", name, P, T,
         H, nnz, 100.0 * nnz / n_e);

  char* d_e;
  float *d_sp, *d_out;
  cudaMalloc(&d_e, n_e * 4 + 64);
  cudaMalloc(&d_sp, 4 * sp.size());
  cudaMalloc(&d_out, 4 * n_out);
  cudaMemcpy(d_sp, sp.data(), 4 * sp.size(), cudaMemcpyHostToDevice);
  cudaEvent_t ea, eb_;
  cudaEventCreate(&ea);
  cudaEventCreate(&eb_);
  struct Form {
    const char* name;
    int bf16, offset, zero;  // offset: bytes past the allocation's base
  };
  const Form forms[4] = {{"bf16", 1, 0, 0}, {"f32", 0, 0, 0},
                         {"bf16_odd", 1, 2, 0}, {"bf16_zero", 1, 0, 1}};
  for (const Form& f : forms) {
    void* e = d_e + f.offset;
    if (f.zero)
      cudaMemset(e, 0, 2 * n_e);
    else if (f.bf16)
      cudaMemcpy(e, eb.data(), 2 * n_e, cudaMemcpyHostToDevice);
    else
      cudaMemcpy(e, ef.data(), 4 * n_e, cudaMemcpyHostToDevice);
    auto call = [&] {
      return slam2d_corr_scores(e, f.bf16, d_sp, d_out, P, T, H, W, R, R,
                                nullptr);
    };
    std::vector<float> out(n_out), again(n_out);
    const int err = call();
    cudaError_t run = cudaDeviceSynchronize();
    cudaMemcpy(out.data(), d_out, 4 * n_out, cudaMemcpyDeviceToHost);
    cudaMemset(d_out, 0, 4 * n_out);
    call();
    run = run ? run : cudaDeviceSynchronize();
    cudaMemcpy(again.data(), d_out, 4 * n_out, cudaMemcpyDeviceToHost);
    if (err || run) {
      printf("%s: error %d, %s\n", name, err, cudaGetErrorString(run));
      return 1;
    }
    double max_err = 0.0, max_rel = 0.0;
    unsigned long long h = 0;
    for (size_t i = 0; i < n_out; ++i) {
      const double d = fabs(out[i] - (f.zero ? 0.0 : ref[i]));
      max_err = fmax(max_err, d);
      max_rel = fmax(max_rel, d / scale[i / (R * R)]);
      uint32_t u;
      memcpy(&u, &out[i], 4);
      h += (unsigned long long)u * (i % 1021 + 1);
    }
    const bool same = memcmp(out.data(), again.data(), 4 * n_out) == 0;
    float best = 1e9f, ms;
    for (int r = 0; r < 5; ++r) {
      cudaEventRecord(ea);
      for (int i = 0; i < 100; ++i) call();
      cudaEventRecord(eb_);
      cudaEventSynchronize(eb_);
      cudaEventElapsedTime(&ms, ea, eb_);
      best = fminf(best, ms / 100);
    }
    printf("%-24s %-8s: %.4f ms  max |err| %.3g (%.3g of sum|E| max|Sp|)  "
           "checksum %llx  same bits twice %s\n",
           name, f.name, best, max_err, max_rel, h, same ? "yes" : "NO");
  }
  if (argc > 2) {
    cudaMemcpy(d_e, eb.data(), 2 * n_e, cudaMemcpyHostToDevice);
    const int more = atoi(argv[2]);
    cudaEventRecord(ea);
    for (int i = 0; i < more; ++i)
      slam2d_corr_scores(d_e, 1, d_sp, d_out, P, T, H, W, R, R, nullptr);
    cudaEventRecord(eb_);
    cudaEventSynchronize(eb_);
    float ms;
    cudaEventElapsedTime(&ms, ea, eb_);
    printf("%-24s bf16: %.4f ms a launch over %d launches\n", name, ms / more,
           more);
  }
  return 0;
}

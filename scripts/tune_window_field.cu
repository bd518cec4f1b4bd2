// Stand-alone timing of the port's window-field kernel (kernel 6), without
// PyTorch: for work on csrc/window_field.cu. Built and driven by
// scripts/tune_kernel.sh (KERNEL = window_field), which passes the
// kernel source to time (the repository's, a copy edited by a sed
// expression, or any other file with the same C entry point) as
// VARIANT_FILE.
//
// For 1000, 100 and 16 particles (bf16 512^2 maps, 288^2 windows at origins
// off every edge, 9 taps, bf16 out: FastSLAM's shapes) it prints the least
// of 5 runs of 20 launches between two CUDA events, and a checksum of the
// field: two variants that compute the same field print the same checksum.
// With a second argument N it then times N more launches in one run at 1000
// particles (seconds of load, to sample the clocks beside it).
#include VARIANT_FILE

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <vector>

__global__ void fill(__nv_bfloat16* m, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    unsigned h = (unsigned)(i * 2654435761u) ^ (unsigned)(i >> 7) * 40503u;
    h ^= h >> 15;
    h *= 2246822519u;
    h ^= h >> 13;
    m[i] = __float2bfloat16((float)(h & 0xffff) / 65535.0f * 12.0f - 6.0f);
  }
}

__global__ void checksum(const unsigned short* o, size_t n,
                         unsigned long long* out) {
  unsigned long long acc = 0;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    acc += (unsigned long long)o[i] * (i % 1021 + 1);
  atomicAdd(out, acc);
}

int main(int argc, char** argv) {
  const char* name = argc > 1 ? argv[1] : "?";
  const int H = 512, W = 512, win = 288;
  float taps[9];
  for (int i = 0; i < 9; ++i) taps[i] = expf(-0.5f * (i - 4) * (i - 4));
  for (int P : {1000, 100, 16}) {
    const size_t n = (size_t)P * H * W, n_out = (size_t)P * win * win;
    __nv_bfloat16 *maps, *out;
    int* origins;
    unsigned long long* sum;
    cudaMalloc(&maps, n * 2);
    cudaMalloc(&out, n_out * 2);
    cudaMalloc(&origins, 8 * P);
    cudaMalloc(&sum, 8);
    fill<<<1024, 256>>>(maps, n);
    std::vector<int> org(2 * P);
    srand(7);
    for (auto& o : org) o = rand() % 632 - 204;
    cudaMemcpy(origins, org.data(), 8 * P, cudaMemcpyHostToDevice);
    auto call = [&] {
      return slam2d_window_field(maps, 1, origins, out, 1, P, H, W, win, taps,
                                 9, 0.25f, -0.4f, 0.6f, nullptr, nullptr);
    };
    const int err = call();
    const cudaError_t run = cudaDeviceSynchronize();
    if (err || run) {
      printf("%s P=%d: error %d, %s\n", name, P, err, cudaGetErrorString(run));
      return 1;
    }
    cudaMemset(sum, 0, 8);
    checksum<<<256, 256>>>((const unsigned short*)out, n_out, sum);
    unsigned long long h;
    cudaMemcpy(&h, sum, 8, cudaMemcpyDeviceToHost);
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    float best = 1e9f, ms;
    for (int r = 0; r < 5; ++r) {
      cudaEventRecord(a);
      for (int i = 0; i < 20; ++i) call();
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      cudaEventElapsedTime(&ms, a, b);
      best = fminf(best, ms / 20);
    }
    printf("%-24s P=%4d: %.4f ms  checksum %llx\n", name, P, best, h);
    if (argc > 2 && P == 1000) {
      const int more = atoi(argv[2]);
      cudaEventRecord(a);
      for (int i = 0; i < more; ++i) call();
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      cudaEventElapsedTime(&ms, a, b);
      printf("%-24s P=1000: %.4f ms a launch over %d launches\n", name,
             ms / more, more);
    }
    cudaFree(maps);
    cudaFree(out);
    cudaFree(origins);
    cudaFree(sum);
  }
  return 0;
}

// Stand-alone timing of the port's apply kernel (kernel 8), without PyTorch:
// for work on csrc/shared_apply.cu. Built and driven by scripts/tune_kernel.sh
// (KERNEL = shared_apply), which passes the kernel source to time (the
// repository's, a copy edited by a sed expression, or any other file with the
// same C entry point) as VARIANT_FILE.
//
// At FastSLAM-1000's shapes (1000 bf16 512^2 maps, 16 float32 256^2 images,
// 180 beams; nine in ten anchors in a cloud around the map's middle, the rest
// anywhere, images off every edge; live marks inside each window clamped into
// the map, some cells marked twice) and at 100 particles, it prints the least
// of 5 runs of 20 launches between two CUDA events and a checksum of the maps
// after one apply: two variants that compute the same maps print the same
// checksum. With a second argument N it then times N more launches in one
// run at 1000 particles (seconds of load, to sample the clocks beside it).
#include VARIANT_FILE

#include <algorithm>
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
  const int H = 512, W = 512, win = 256, G = 16, B = 180;
  const float l_clamp = 10.0f;
  srand(11);
  auto uni = [](int lo, int hi) { return lo + rand() % (hi - lo); };
  std::vector<float> img((size_t)G * win * win);
  for (auto& v : img) v = (float)(rand() % 2001 - 1000) / 1000.0f;
  float* images;
  cudaMalloc(&images, img.size() * 4);
  cudaMemcpy(images, img.data(), img.size() * 4, cudaMemcpyHostToDevice);
  for (int P : {1000, 100}) {
    const size_t n = (size_t)P * H * W;
    std::vector<int> anc(2 * P), slot(P), er((size_t)P * B), ec((size_t)P * B);
    std::vector<float> ew((size_t)P * B);
    for (int p = 0; p < P; ++p) {
      const bool far = p % 10 == 0;
      for (int k = 0; k < 2; ++k)
        anc[2 * p + k] = far ? uni(-20, 532) : 256 + uni(-6, 7);
      slot[p] = uni(0, G);
      const int r0 = std::min(std::max(anc[2 * p] - win / 2, 0), H - win);
      const int c0 = std::min(std::max(anc[2 * p + 1] - win / 2, 0), W - win);
      for (int b = 0; b < B; ++b) {
        const size_t i = (size_t)p * B + b;
        er[i] = b % 9 == 1 ? er[i - 1] : r0 + uni(0, win);
        ec[i] = b % 9 == 1 ? ec[i - 1] : c0 + uni(0, win);
        ew[i] = b % 13 == 0 ? 0.0f : 0.85f;
      }
    }
    __nv_bfloat16* maps;
    int *anchors, *slots, *ep_r, *ep_c;
    float* ep_w;
    unsigned long long* sum;
    cudaMalloc(&maps, n * 2);
    cudaMalloc(&anchors, 8 * P);
    cudaMalloc(&slots, 4 * P);
    cudaMalloc(&ep_r, 4 * P * B);
    cudaMalloc(&ep_c, 4 * P * B);
    cudaMalloc(&ep_w, 4 * P * B);
    cudaMalloc(&sum, 8);
    cudaMemcpy(anchors, anc.data(), 8 * P, cudaMemcpyHostToDevice);
    cudaMemcpy(slots, slot.data(), 4 * P, cudaMemcpyHostToDevice);
    cudaMemcpy(ep_r, er.data(), 4 * P * B, cudaMemcpyHostToDevice);
    cudaMemcpy(ep_c, ec.data(), 4 * P * B, cudaMemcpyHostToDevice);
    cudaMemcpy(ep_w, ew.data(), 4 * P * B, cudaMemcpyHostToDevice);
    fill<<<1024, 256>>>(maps, n);
    auto call = [&] {
      return slam2d_shared_apply(maps, 1, images, 0, anchors, slots, ep_r,
                                 ep_c, ep_w, P, H, W, win, G, B, l_clamp,
                                 nullptr, nullptr);
    };
    const int err = call();
    const cudaError_t run = cudaDeviceSynchronize();
    if (err || run) {
      printf("%s P=%d: error %d, %s\n", name, P, err, cudaGetErrorString(run));
      return 1;
    }
    cudaMemset(sum, 0, 8);
    checksum<<<256, 256>>>((const unsigned short*)maps, n, sum);
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
    cudaFree(anchors);
    cudaFree(slots);
    cudaFree(ep_r);
    cudaFree(ep_c);
    cudaFree(ep_w);
    cudaFree(sum);
  }
  cudaFree(images);
  return 0;
}

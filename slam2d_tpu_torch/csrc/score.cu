// Correlative match scores over a window of (theta, drow, dcol) candidates.
//
// Replaces slam2d_tpu/ops/pallas_score.py:_score_kernel (and, on the TPU's
// frontend path, the one-hot matmul scorer ops/mxu_score.py
// score_offsets_mxu_int8). The contract is score_offsets(impl="gather")
// (match/correlative.py): for every theta t and offset (dr, dc) in
// [-R/2, R/2] x [-C/2, C/2],
//   out[t, r, c] = sum_b w_b * S[row_b + dr, col_b + dc] / max(#valid, 1)
// with each tap masked on its own when it falls outside S. The bilinear
// (fine) pass splits every beam into four taps at floor(pos) with weights
// (1-fr)(1-fc), (1-fr)fc, fr(1-fc), fr*fc; the rounded (coarse) pass uses
// one tap at rint(pos) (round half to even, as jnp.round and torch.round).
// Invalid beams weigh 0 (their positions arrive zeroed, so a NaN range never
// reaches the weights).
//
// What bounds it on the H100: the work is tiny (frontend fine pass 5x9x9
// outputs x 180 beams x 4 taps, 0.3 M reads of S) and S stays in L2, so the
// kernel is bound by latency and launch overhead, not by bytes or FLOPs.
// Design: one block per theta, one thread per (r, c) output, looping over
// the beams; the beam rows, columns and weights for the block's theta are
// staged in shared memory once, and neighbouring threads read neighbouring
// cells of S. The TPU kernel's patch bookkeeping (8-row aligned reads,
// beams dropped whole when their patch leaves the window) is a Mosaic
// artifact and is not carried over: taps are masked one by one, as in the
// gather semantics.

#include "common.cuh"

namespace {

__global__ void score_kernel(const float* __restrict__ S,
                             const float* __restrict__ pos_row,
                             const float* __restrict__ pos_col,
                             const unsigned char* __restrict__ valid,
                             float* __restrict__ out, int H, int W, int B,
                             int R, int C, int bilinear) {
  extern __shared__ float smem[];
  int* brow = reinterpret_cast<int*>(smem);
  int* bcol = brow + B;
  float* wr = reinterpret_cast<float*>(bcol + B);  // row weight of tap 0
  float* wc = wr + B;                               // col weight of tap 0
  float* vw = wc + B;                               // 1 for a valid beam
  const int t = blockIdx.x;

  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const float pr = pos_row[(size_t)t * B + b];
    const float pc = pos_col[(size_t)t * B + b];
    vw[b] = valid[b] ? 1.0f : 0.0f;
    if (bilinear) {
      const float r0 = floorf(pr);
      const float c0 = floorf(pc);
      brow[b] = (int)clampf(r0, -1e9f, 1e9f);
      bcol[b] = (int)clampf(c0, -1e9f, 1e9f);
      wr[b] = F_SUB(pr, r0);  // fr
      wc[b] = F_SUB(pc, c0);  // fc
    } else {
      brow[b] = (int)clampf(rintf(pr), -1e9f, 1e9f);
      bcol[b] = (int)clampf(rintf(pc), -1e9f, 1e9f);
    }
  }
  __syncthreads();

  const int rc = threadIdx.x;
  if (rc >= R * C) return;
  const int dr = rc / C - R / 2;
  const int dc = rc % C - C / 2;
  float acc = 0.0f;
  float n_valid = 0.0f;
  for (int b = 0; b < B; ++b) {
    const float v = vw[b];
    n_valid = F_ADD(n_valid, v);
    const int r = brow[b] + dr;
    const int c = bcol[b] + dc;
    if (!bilinear) {
      if (r >= 0 && r < H && c >= 0 && c < W)
        acc = F_ADD(acc, F_MUL(S[(long long)r * W + c], v));
      continue;
    }
    const float fr = wr[b];
    const float fc = wc[b];
    const float w0r = F_MUL(v, F_SUB(1.0f, fr));
    const float w1r = F_MUL(v, fr);
    const bool r0in = r >= 0 && r < H;
    const bool r1in = r + 1 >= 0 && r + 1 < H;
    const bool c0in = c >= 0 && c < W;
    const bool c1in = c + 1 >= 0 && c + 1 < W;
    const long long i = (long long)r * W + c;  // tap (0, 0); read in range only
    const float w0c = F_SUB(1.0f, fc);
    if (r0in && c0in) acc = F_ADD(acc, F_MUL(S[i], F_MUL(w0r, w0c)));
    if (r0in && c1in) acc = F_ADD(acc, F_MUL(S[i + 1], F_MUL(w0r, fc)));
    if (r1in && c0in) acc = F_ADD(acc, F_MUL(S[i + W], F_MUL(w1r, w0c)));
    if (r1in && c1in) acc = F_ADD(acc, F_MUL(S[i + W + 1], F_MUL(w1r, fc)));
  }
  out[(size_t)t * R * C + rc] = F_DIV(acc, fmaxf(n_valid, 1.0f));
}

}  // namespace

extern "C" int slam2d_score_offsets(const float* S, const float* pos_row,
                                    const float* pos_col,
                                    const unsigned char* valid, float* out,
                                    int H, int W, int T, int B, int R, int C,
                                    int bilinear, void* stream) {
  const int threads = ((R * C + 31) / 32) * 32;
  const size_t smem = 5 * (size_t)B * sizeof(float);
  score_kernel<<<T, threads, smem, (cudaStream_t)stream>>>(
      S, pos_row, pos_col, valid, out, H, W, B, R, C, bilinear);
  return (int)cudaGetLastError();
}

// Shared helpers of the slam2d_tpu_torch kernels.
//
// The kernels are held bit for bit against plain PyTorch and JAX code, which
// round after every float32 operation. nvcc would contract a*b + c into one
// fused multiply-add with a single rounding, so the arithmetic that decides
// a cell or a score is written with the _rn intrinsics, which it never
// contracts.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define F_ADD __fadd_rn
#define F_SUB __fsub_rn
#define F_MUL __fmul_rn
#define F_DIV __fdiv_rn

// float32(pi) and float32(2 pi), as jnp.pi and torch round them
#define PI_F 3.14159265358979323846f
#define TWO_PI_F 6.28318530717958647692f

// Python-style float modulo with a positive divisor (jnp.mod, torch.remainder)
__device__ __forceinline__ float mod_pos(float x, float y) {
  float m = fmodf(x, y);
  return (m != 0.0f && m < 0.0f) ? F_ADD(m, y) : m;
}

// jnp.clip / torch.clamp of a non-NaN value
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

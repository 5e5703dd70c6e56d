// The AdaGrad row transform of the fused step, shared by K2 (adagrad.cu)
// and K5's epilogue (complex_step.cu), so both round alike, instruction
// for instruction:
//
//   upd = -lr * g * rsqrt(acc + g*g + eps),   g2 = g*g
//
// Every operation is an explicitly rounded intrinsic in the order the
// plain PyTorch version evaluates it (ops/kernels.py
// adagrad_update_plain), so nvcc cannot contract a multiply-add into an
// FMA; rsqrt is 1/sqrt with both steps correctly rounded (the CPU's
// torch.rsqrt arithmetic).
#pragma once

#include <cuda_runtime.h>

namespace adapm {

__device__ __forceinline__ float rsqrt_rn(float x) {
  return __fdiv_rn(1.0f, __fsqrt_rn(x));
}

__device__ __forceinline__ void upd_one(float g, float a, float lr, float eps,
                                        float* u, float* g2) {
  const float gg = __fmul_rn(g, g);
  const float s = __fadd_rn(__fadd_rn(a, gg), eps);
  *u = __fmul_rn(__fmul_rn(-lr, g), rsqrt_rn(s));
  *g2 = gg;
}

}  // namespace adapm
